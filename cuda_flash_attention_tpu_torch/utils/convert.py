"""Carry a parameter tree from the JAX package into the port.

The caller turns the JAX arrays into numpy arrays (np.asarray on each leaf)
and the JAX package's QuantizedTensor / LoRATensor leaves into the port's
classes holding those numpy arrays; this module needs neither JAX nor its
package, only the tree's structure: dicts, lists, arrays of any rank (a
mixture-of-experts layer's [E, d, f] expert weights among them) and the
port's QuantizedTensor and LoRATensor, converted field by field.  With a
mesh, a rank converts only its own blocks: the slices of the JAX tree that
JAX's param_shardings places on the device at its mesh coordinate
(transformer.shard_params: the dense weights over "model", an MoE layer's
experts over "expert" and their d_ff over "model").  A pipeline's stacked
tree (JAX's stack_pipeline_params) converts to a rank's stage in the port's
per-layer form (`pipeline_params_from_numpy`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_flash_attention_tpu_torch.models.lora import LoRATensor
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor

# numpy has no fp8 of its own: ml_dtypes' fp8 arrays cross as their bytes.
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; fp32 holds every bf16 value exactly.
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype.name in _FP8:
        t = torch.from_numpy(np.array(a.view(np.uint8))).view(_FP8[a.dtype.name])
    else:
        t = torch.from_numpy(np.array(a))  # a copy: JAX's buffers are read-only
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None, *,
                      mesh=None, cfg=None):
    """The same tree with every numpy array as a torch tensor on `device`
    (cast to `dtype` when given).  Lists and tuples become
    lists.  With `mesh` (and the model's `cfg`) the tree is first cut to
    this rank's blocks, so only they are copied.  A QuantizedTensor's values and scales keep their types (fp8
    values through a uint8 view); a LoRATensor's base converts as a leaf of
    its own and its adapters like any array."""
    if mesh is not None:
        from cuda_flash_attention_tpu_torch.models.transformer import shard_params

        tree = shard_params(tree, mesh, cfg)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, values=_to_tensor(tree.values, device, None),
                                   scales=_to_tensor(tree.scales, device, None))
    if isinstance(tree, LoRATensor):
        return dataclasses.replace(tree, base=params_from_numpy(tree.base, device, dtype),
                                   a=_to_tensor(tree.a, device, dtype),
                                   b=_to_tensor(tree.b, device, dtype))
    return _to_tensor(tree, device, dtype)


def pipeline_params_from_numpy(tree, device, dtype: torch.dtype | None = None, *,
                               mesh):
    """This rank's stage of JAX's stacked pipeline tree (stack_pipeline_params'
    leaves [n_stages, layers_per_stage, ...] as numpy arrays) as the port's
    per-layer list on `device`, cut to its blocks over "model", with the
    embedding on stage 0 and the final norm and head on the last
    (models/pipeline.py shard_pipeline_params).  Only that stage is
    copied."""
    from cuda_flash_attention_tpu_torch.models.pipeline import shard_pipeline_params

    return params_from_numpy(shard_pipeline_params(tree, mesh), device, dtype)
