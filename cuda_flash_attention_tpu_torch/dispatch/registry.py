"""Kernel registry and runtime dispatch.

Counterpart of cuda_flash_attention_tpu/dispatch/registry.py: a runtime
(method, mode, precision, head_dim) tuple resolves to a callable, with the
same validation and the same exception types:
  * head_dim must be one of SUPPORTED_HEAD_DIMS.  Every CUDA kernel
    (B1-B10) takes all four on the card (kernels/common.py
    FORWARD_HEAD_DIMS; D 32 and 256 from libraries of their own), and on
    the CPU every head dim runs the plain versions;
  * the baselines (fa1, fa2-naive) and the VANILLA oracle are forward-only
    and fp32-only; fa1 and fa2-naive also refuse causal and return
    lse = None;
  * backward needs the forward artifacts o and lse.
The precision is the FA2 kernels' tile type: fp32 (None), fp16 or bf16.
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda_flash_attention_tpu_torch.dispatch.types import (
    ComputeDataType,
    ComputeType,
    ModeType,
)
from cuda_flash_attention_tpu_torch.kernels.attention import (
    fa2_backward,
    flash_attention_with_lse,
)
from cuda_flash_attention_tpu_torch.kernels.baselines import (
    fa1_attention,
    naive_fa2_attention,
)
from cuda_flash_attention_tpu_torch.ops.reference import vanilla_attention_with_lse

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)

_TILE_DTYPES = {
    ComputeDataType.FP32: None,
    ComputeDataType.FP16: torch.float16,
    ComputeDataType.BF16: torch.bfloat16,
}


def _validate(method: ComputeType, mode: ModeType, precision: ComputeDataType,
              head_dim: int) -> None:
    if head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"unsupported head_dim {head_dim}; supported: {SUPPORTED_HEAD_DIMS}"
        )
    if method != ComputeType.FLASH_ATTENTION_2:
        if mode != ModeType.FORWARD:
            raise ValueError(f"{method.value} supports only the forward pass")
        if precision != ComputeDataType.FP32:
            raise ValueError(f"{method.value} supports only fp32")


def get_kernel(method: ComputeType, mode: ModeType,
               precision: ComputeDataType, head_dim: int) -> Callable:
    """Resolve a (method, mode, precision, head_dim) tuple to a callable.

    Forward callables: f(q, k, v, *, causal=False, sm_scale=None)
      -> (O, lse | None).
    Backward callable: f(q, k, v, o, lse, do, *, causal=False, sm_scale=None)
      -> (dQ, dK, dV).
    Forward-backward: f(q, k, v, do, *, causal=False, sm_scale=None)
      -> (O, lse, dQ, dK, dV).
    """
    _validate(method, mode, precision, head_dim)
    tile_dtype = _TILE_DTYPES[precision]

    if method == ComputeType.VANILLA:
        return lambda q, k, v, **kw: vanilla_attention_with_lse(q, k, v, **kw)

    def _baseline(impl, name):
        def fn(q, k, v, *, causal=False, sm_scale=None):
            if causal:
                # The baselines have no masking path.
                raise ValueError(f"{name} baseline does not support causal")
            return impl(q, k, v, sm_scale=sm_scale), None
        return fn

    if method == ComputeType.FLASH_ATTENTION_1:
        return _baseline(fa1_attention, "fa1")
    if method == ComputeType.FLASH_ATTENTION_2_NAIVE:
        return _baseline(naive_fa2_attention, "fa2-naive")

    if mode == ModeType.FORWARD:
        return lambda q, k, v, **kw: flash_attention_with_lse(
            q, k, v, tile_dtype=tile_dtype, **kw
        )
    if mode == ModeType.BACKWARD:
        return lambda q, k, v, o, lse, do=None, **kw: fa2_backward(
            q, k, v, o, lse, do, tile_dtype=tile_dtype, **kw
        )

    def _fwd_bwd(q, k, v, do=None, **kw):
        o, lse = flash_attention_with_lse(q, k, v, tile_dtype=tile_dtype, **kw)
        dq, dk, dv = fa2_backward(q, k, v, o, lse, do, tile_dtype=tile_dtype, **kw)
        return o, lse, dq, dk, dv

    return _fwd_bwd


def run_flash_attention(
    method: ComputeType | str,
    mode: ModeType | str,
    precision: ComputeDataType | str,
    q, k, v,
    *,
    o=None, lse=None, do=None,
    causal: bool = False,
    sm_scale: float | None = None,
):
    """One-call runtime dispatch.  Returns a dict of whatever the mode
    produces: o and lse (forward), dq, dk and dv (backward), all five
    (forward_backward)."""
    if isinstance(method, str):
        method = ComputeType.parse(method)
    if isinstance(mode, str):
        mode = ModeType.parse(mode)
    if isinstance(precision, str):
        precision = ComputeDataType.parse(precision)
    fn = get_kernel(method, mode, precision, q.shape[-1])
    kw = dict(causal=causal, sm_scale=sm_scale)

    if mode == ModeType.FORWARD:
        out, lse_out = fn(q, k, v, **kw)
        return {"o": out, "lse": lse_out}
    if mode == ModeType.BACKWARD:
        if o is None or lse is None:
            raise ValueError(
                "backward mode requires forward artifacts o and lse "
                "(O.bin and logsumexp.bin of a forward run)"
            )
        dq, dk, dv = fn(q, k, v, o, lse, do, **kw)
        return {"dq": dq, "dk": dk, "dv": dv}
    o_out, lse_out, dq, dk, dv = fn(q, k, v, do, **kw)
    return {"o": o_out, "lse": lse_out, "dq": dq, "dk": dk, "dv": dv}
