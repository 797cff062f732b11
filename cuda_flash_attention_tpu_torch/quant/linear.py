"""Weight quantization for dense layers (int8 / fp8 / int4, W8A8) and the
`dense` dispatch every projection goes through.

Counterpart of cuda_flash_attention_tpu/quant/linear.py.  The identity used
for int8 and fp8 weights:

    x @ (W_q * scale) == (x @ W_q) * scale      (scale per output column)

so the product takes the 1-byte values cast to x's dtype and the scale goes
on the output.  These products are plain matrix products outside any
kernel of the JAX package (XLA emits them), so they go to torch.matmul
here; W8A8's int8 x int8 -> int32 product goes to torch._int_mm on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch.kernels.common import round_up
from cuda_flash_attention_tpu_torch.quant.qtensor import (
    QuantizedTensor,
    quantize,
    quantize_int4,
)


def quantize_weight(w: torch.Tensor, dtype=torch.int8,
                    group_size: int = 128) -> QuantizedTensor:
    """Per-output-channel symmetric quantization of an [in, out] weight
    (scales [1, out]); dtype "int4" selects the packed group-wise form."""
    if w.ndim != 2:
        raise ValueError(f"expected 2D weight, got {tuple(w.shape)}")
    if isinstance(dtype, str) and dtype == "int4":
        return quantize_int4(w, group_size=group_size)
    return quantize(w, dtype, axis=0)


def quantized_matmul(x: torch.Tensor, w_q: QuantizedTensor) -> torch.Tensor:
    """x @ dequant(w_q).  int8/fp8: the values cast to x's dtype, the column
    scale after the product; int4 (scales along the in axis): dequantize,
    then multiply; act_quant int8: W8A8."""
    if w_q.bits == 4:
        return x @ w_q.dequantize(x.dtype)
    if w_q.act_quant and w_q.values.dtype == torch.int8:
        return w8a8_matmul(x, w_q)
    y = x @ w_q.values.to(x.dtype)
    return y * w_q.scales.to(x.dtype)


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] x int8 [k, n] -> int32.  On the card
    torch._int_mm needs more than 16 rows and k, n multiples of 8: decode's
    few rows (one per slot) are zero-padded to a multiple of 8 of at least
    24, and the padding rows are dropped after."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    if k % 8 or b.shape[1] % 8:
        raise NotImplementedError(
            f"w8a8 on the card: in and out dims must be multiples of 8; got "
            f"{k} x {b.shape[1]}")
    m_pad = max(24, round_up(m, 8))
    if m_pad != m:
        a = F.pad(a, (0, 0, 0, m_pad - m))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m]


def quantize_activations(x: torch.Tensor):
    """W8A8's dynamic per-row activation quantization, in the JAX package's
    order (x * (127 / ax), round half to even, clip): (int8 x_q, fp32 ax)."""
    xf = x.float()
    ax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    xq = torch.round(xf * (127.0 / ax)).clamp(-127, 127).to(torch.int8)
    return xq, ax


def w8a8_matmul(x: torch.Tensor, w_q: QuantizedTensor) -> torch.Tensor:
    """int8 x int8 product of the quantized activations and the weight:
    y = (x_q @ w_q) * (ax / 127) * sw, in the JAX package's order."""
    xq, ax = quantize_activations(x)
    y = _int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q.values)
    y = y.reshape(*xq.shape[:-1], y.shape[-1])
    return (y.float() * (ax / 127.0) * w_q.scales.float()).to(x.dtype)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Dense matmul taking a plain tensor, a QuantizedTensor or a
    LoRATensor: the one dispatch point every projection of the model uses."""
    from cuda_flash_attention_tpu_torch.models.lora import LoRATensor

    if isinstance(w, LoRATensor):
        # The frozen base is detached: autograd builds no base-sized
        # gradient, the memory win LoRA exists for.
        base = w.base if isinstance(w.base, QuantizedTensor) else w.base.detach()
        y = dense(x, base)
        delta = (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
        return y + delta * torch.full((), w.scale, dtype=x.dtype, device=x.device)
    if isinstance(w, QuantizedTensor):
        return quantized_matmul(x, w)
    return x @ w.to(x.dtype)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


def quantize_transformer_params(params, dtype=torch.int8, keys=_QUANT_KEYS,
                                act_quant: bool = False):
    """Weight quantization of a transformer parameter tree: every 2-D dense
    projection becomes a QuantizedTensor; norms and the embedding stay in
    full precision.  dtype may be "int4" (packed group-wise)."""
    if act_quant and isinstance(dtype, str) and dtype == "int4":
        raise ValueError("act_quant (W8A8) requires int8 weights")

    def _convert(tree):
        out = {}
        for name, leaf in tree.items():
            if name == "layers":
                out[name] = [_convert(layer) for layer in leaf]
            elif (name in keys and isinstance(leaf, torch.Tensor)
                  and leaf.ndim == 2):
                qt = quantize_weight(leaf, dtype)
                if act_quant:
                    qt = dataclasses.replace(qt, act_quant=True)
                out[name] = qt
            else:
                out[name] = leaf
        return out

    return _convert(params)
