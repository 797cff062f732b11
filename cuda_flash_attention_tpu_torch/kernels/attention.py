"""Public FlashAttention-2 forward API: validation, padding, dispatch.

Counterpart of the forward half of cuda_flash_attention_tpu/kernels/
attention.py.  q/k/v are [B, H, S, D]; k/v may carry fewer heads than q
(GQA, query heads ordered KV-head-major).  Sequences are zero-padded to the
block grid, the forward kernel B1 runs, and the padding is sliced off.

Two routes of the JAX API do not apply here: the small-fp32 XLA route (its
crossover was measured on a TPU; on CUDA the kernel is always taken) and the
small-shape kernel B8 (not ported; GQA prefill never takes it).  Sliding
windows, attention sinks and segment ids are not ported yet and raise.
No autograd: this slice serves, it does not train.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.kernels.common import (
    pad_to_block,
    seq_pad_quantum,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_aligned

__all__ = ["flash_attention", "flash_attention_with_lse"]

_IN_DTYPES = (torch.float32, torch.bfloat16)


def _validate_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be [batch, heads, seq, head_dim]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q and k must agree on batch/head_dim: {tuple(q.shape)} vs "
            f"{tuple(k.shape)}"
        )
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"GQA requires query heads ({q.shape[1]}) to be a multiple of "
            f"KV heads ({k.shape[1]})"
        )


def _validate_dtypes(q, k, v, tile_dtype):
    if q.dtype not in _IN_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"q/k/v must share one dtype of {_IN_DTYPES}; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if tile_dtype not in (None, torch.bfloat16):
        raise NotImplementedError(
            f"tile_dtype must be None or torch.bfloat16; got {tile_dtype}"
        )


def _check_window(window, sinks, causal, q_len, kv_len):
    """A window that covers every key distance is no window (the JAX API
    folds it away); any other window is not ported yet, and sinks need a
    window."""
    if window is not None:
        window = int(window)
        if causal and window < 1:
            raise ValueError(f"causal window must be >= 1; got {window}")
        if window < kv_len or not (causal or window >= q_len):
            raise NotImplementedError(
                "sliding-window attention is not ported yet"
            )
    if int(sinks) < 0:
        raise ValueError(f"sinks must be >= 0; got {sinks}")
    if int(sinks):
        raise ValueError("attention sinks require a sliding window")


def _forward(q, k, v, causal, sm_scale, tile_dtype, q_segment_ids,
             kv_segment_ids, window, sinks):
    _validate_shapes(q, k, v)
    _validate_dtypes(q, k, v, tile_dtype)
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError("segment ids are not ported yet")
    _check_window(window, sinks, causal, q.shape[2], k.shape[2])
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    q_len, kv_len = q.shape[2], k.shape[2]
    q_pad = pad_to_block(q, 2, seq_pad_quantum(q_len, q.dtype)).contiguous()
    k_pad = pad_to_block(k, 2, seq_pad_quantum(kv_len, k.dtype)).contiguous()
    v_pad = pad_to_block(v, 2, seq_pad_quantum(kv_len, v.dtype)).contiguous()
    o, lse = fa2_forward_aligned(q_pad, k_pad, v_pad, causal=causal,
                                 sm_scale=float(sm_scale), kv_len=kv_len,
                                 tile_dtype=tile_dtype)
    return o[:, :, :q_len], lse[:, :, :q_len]


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None, tile_dtype=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    window: int | None = None, sinks: int = 0):
    """FlashAttention-2 forward.  Returns O with q's shape and dtype.

    ``tile_dtype`` (None or torch.bfloat16) is the precision of the Q/K/V/P
    tiles inside the kernel; softmax statistics stay fp32.  None computes in
    q's dtype."""
    return _forward(q, k, v, causal, sm_scale, tile_dtype, q_segment_ids,
                    kv_segment_ids, window, sinks)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: float | None = None, tile_dtype=None,
                             q_segment_ids=None, kv_segment_ids=None,
                             window: int | None = None, sinks: int = 0):
    """FA2 forward returning (O, logsumexp [B, H, Sq] fp32)."""
    return _forward(q, k, v, causal, sm_scale, tile_dtype, q_segment_ids,
                    kv_segment_ids, window, sinks)
