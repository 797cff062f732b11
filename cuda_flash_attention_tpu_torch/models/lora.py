"""LoRA: low-rank adapters for parameter-efficient fine-tuning.

Counterpart of cuda_flash_attention_tpu/models/lora.py.  An adapted weight
is a `LoRATensor` leaf of the parameter tree, taken by the same
`quant.linear.dense` every projection goes through, so adapters compose
with weight quantization (QLoRA: an int8/fp8/int4 frozen base and fp32
adapters).  The effective weight is base + (a @ b) * scale; the base is
detached in the product, so autograd never builds a base-sized gradient.
The optimizer that trains only the adapters is
models/training.make_lora_optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from cuda_flash_attention_tpu_torch.models.transformer import tree_leaves, tree_map

_DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoRATensor:
    """base (frozen; a tensor or a QuantizedTensor) + trainable adapters
    a [in, r] and b [r, out]; effective weight = base + (a @ b) * scale."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    scale: float = 1.0  # alpha / rank

    @property
    def shape(self):
        return tuple(self.base.shape)

    @property
    def ndim(self):
        return len(self.shape)


def _wrap(generator: torch.Generator, w, rank: int, alpha: float, dtype):
    d_in, d_out = w.shape
    device = w.device
    a = torch.randn((d_in, rank), generator=generator,
                    device=generator.device).to(device=device, dtype=dtype)
    a = a / torch.sqrt(torch.tensor(d_in, dtype=dtype, device=device))
    b = torch.zeros((rank, d_out), dtype=dtype, device=device)  # delta is 0
    return LoRATensor(w, a, b, scale=float(alpha) / rank)


def apply_lora(params, generator: torch.Generator, *, rank: int = 8,
               alpha: float | None = None, targets=_DEFAULT_TARGETS,
               adapter_dtype=torch.float32):
    """Wrap every target 2-D projection (top level and per layer) in a
    LoRATensor.  The adapters `a` are drawn from `generator` (N(0, 1/in));
    `b` starts at zero, so the wrapped model is exactly the base model until
    training moves the adapters.  The draws differ from the JAX package's,
    whose PRNG differs."""
    if alpha is None:
        alpha = float(rank)

    def _convert(tree):
        out = {}
        for name, leaf in sorted(tree.items()):
            if name == "layers":
                out[name] = [_convert(layer) for layer in leaf]
            elif name in targets and getattr(leaf, "ndim", 0) == 2:
                out[name] = _wrap(generator, leaf, rank, alpha, adapter_dtype)
            else:
                out[name] = leaf
        return out

    return _convert(params)


def lora_trainable_mask(params):
    """A tree like params marking only the adapter leaves a and b True
    (a LoRATensor's mask holds False for its base)."""
    return tree_map(lambda x: LoRATensor(False, True, True, scale=x.scale)
                    if isinstance(x, LoRATensor) else False, params)


def lora_adapters(params) -> list[torch.Tensor]:
    """The adapter tensors of params, [a, b] of each LoRATensor in tree
    order: what the LoRA optimizer trains."""
    return [t for x in tree_leaves(params) if isinstance(x, LoRATensor)
            for t in (x.a, x.b)]


def replace_adapters(params, adapters):
    """params with its adapters replaced, in lora_adapters' order, by
    `adapters`; every other leaf is the same object."""
    it = iter(adapters)
    return tree_map(lambda x: dataclasses.replace(x, a=next(it), b=next(it))
                    if isinstance(x, LoRATensor) else x, params)


def merge_lora(params):
    """Fold the adapters into the base weights (the serving form).  A
    QuantizedTensor base is dequantized, merged and requantized at its
    storage type (int4 group-wise at its group size)."""
    from cuda_flash_attention_tpu_torch.quant.linear import quantize_weight
    from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor

    def _merge(x):
        if not isinstance(x, LoRATensor):
            return x
        delta = (x.a.float() @ x.b.float()) * x.scale
        if isinstance(x.base, QuantizedTensor):
            merged = x.base.dequantize(torch.float32) + delta
            if x.base.bits == 4:
                return quantize_weight(merged, "int4",
                                       group_size=x.base.group_size)
            return quantize_weight(merged, x.base.values.dtype)
        return (x.base.float() + delta).to(x.base.dtype)

    return tree_map(_merge, params)
