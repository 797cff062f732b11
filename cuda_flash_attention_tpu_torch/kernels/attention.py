"""Public FlashAttention-2 API: validation, padding, dispatch, autograd.

Counterpart of cuda_flash_attention_tpu/kernels/attention.py.  q/k/v are
[B, H, S, D]; k/v may carry fewer heads than q (GQA, query heads ordered
KV-head-major).  Sequences are zero-padded to the block grid, the forward
kernel B1 runs, and the padding is sliced off.  `flash_attention` is
differentiable: a torch.autograd.Function takes the place of the JAX
custom_vjp (attention.py:255-348).  Its forward saves the padded (q, k, v,
o, lse); its backward gets dO zero-padded from the slice's own backward and
runs either the fused kernel B2 or the split pair B3 + B4
(kernels/fa2_backward.py), by the JAX route rule `_use_fused_bwd`.

Two routes of the JAX API do not apply here: the small-fp32 XLA route (its
crossover was measured on a TPU; on CUDA the kernel is always taken) and the
small-shape kernel B8 (not ported; GQA prefill never takes it).  Sliding
windows, attention sinks and segment ids are not ported yet and raise.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.kernels.common import (
    BlockSizes,
    cdiv,
    fit_block,
    pad_to_block,
    seq_pad_quantum,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_backward import (
    fa2_backward_dkv_aligned,
    fa2_backward_dq_aligned,
    fa2_backward_fused_aligned,
    fused_kv_tile,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_aligned

__all__ = ["BlockSizes", "flash_attention", "flash_attention_with_lse",
           "fa2_backward"]

# The JAX route rule: the fused backward B2 writes dQ as per-KV-slice fp32
# partials; above 8 slices the split pair's recompute is cheaper than the
# partials' traffic, and above 1 GiB of partials the fused route is refused
# outright.
_FUSED_BWD_MAX_KV_SLICES = 8
_FUSED_BWD_MAX_DQPART_BYTES = 1 << 30


def _use_fused_bwd(q, k, bk_dkv: int, tile_dtype=None) -> bool:
    """JAX attention.py:50-62 on padded q/k.  The slice count is the JAX
    one (KV slices of `bk_dkv` rows); the byte cap applies to the buffer
    that the port's B2 allocates, one fp32 slice of q's size per
    `fused_kv_tile` KV rows (128 with bf16 tiles, 64 in fp32), which is
    larger than the JAX buffer.  The JAX window clause is left out: windows
    are not ported and raise before this point."""
    if k.shape[2] // bk_dkv > _FUSED_BWD_MAX_KV_SLICES:
        return False
    slices = cdiv(k.shape[2], fused_kv_tile(q.dtype, tile_dtype))
    dq_part_bytes = 4 * q.shape[0] * q.shape[1] * slices * q.shape[2] * q.shape[3]
    return dq_part_bytes <= _FUSED_BWD_MAX_DQPART_BYTES


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


def _prepare(q, k, v, causal, sm_scale, tile_dtype, q_segment_ids,
             kv_segment_ids, window, sinks):
    """Validate and pad: (q, k, v padded and contiguous, sm_scale, q_len,
    kv_len)."""
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
    return q_pad, k_pad, v_pad, float(sm_scale), q_len, kv_len


def _backward(q, k, v, o, lse, do, kv_len, causal, sm_scale, block_sizes,
              tile_dtype):
    """dQ, dK, dV over padded inputs: B2, or B3 + B4 with
    D_i = rowsum(dO * O) as a plain fp32 reduction (the JAX package computes
    it in XLA outside Pallas, attention.py:327-329)."""
    do = do.contiguous()
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len,
              tile_dtype=tile_dtype)
    bk_dkv = fit_block(block_sizes.block_k_dkv, k.shape[2])
    if _use_fused_bwd(q, k, bk_dkv, tile_dtype):
        return fa2_backward_fused_aligned(q, k, v, o, do, lse, **kw)
    di = (o.float() * do.float()).sum(dim=-1)
    dq = fa2_backward_dq_aligned(q, k, v, do, lse, di, **kw)
    dk, dv = fa2_backward_dkv_aligned(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


class _FA2(torch.autograd.Function):
    """FA2 over padded q/k/v: forward B1, backward B2 or B3 + B4."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, sm_scale, block_sizes,
                tile_dtype):
        o, lse = fa2_forward_aligned(q, k, v, causal=causal, sm_scale=sm_scale,
                                     kv_len=kv_len, tile_dtype=tile_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (kv_len, causal, sm_scale, block_sizes, tile_dtype)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None,
                    block_sizes: BlockSizes | None = None, tile_dtype=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    window: int | None = None, sinks: int = 0):
    """Differentiable FlashAttention-2.  Returns O with q's shape and dtype.

    ``tile_dtype`` (None or torch.bfloat16) is the precision of the Q/K/V/P
    tiles inside the kernels; softmax statistics stay fp32.  None computes
    in q's dtype.  ``block_sizes`` (default `BlockSizes.default(causal)`)
    only picks the backward route, as the JAX rule counts its KV slices."""
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, q_segment_ids, kv_segment_ids,
        window, sinks)
    if block_sizes is None:
        block_sizes = BlockSizes.default(causal)
    o = _FA2.apply(q_pad, k_pad, v_pad, kv_len, causal, sm_scale, block_sizes,
                   tile_dtype)
    return o[:, :, :q_len]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: float | None = None, tile_dtype=None,
                             q_segment_ids=None, kv_segment_ids=None,
                             window: int | None = None, sinks: int = 0):
    """FA2 forward returning (O, logsumexp [B, H, Sq] fp32).  Not
    differentiable, as in the JAX API: use `flash_attention` for
    gradients."""
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, q_segment_ids, kv_segment_ids,
        window, sinks)
    with torch.no_grad():
        o, lse = fa2_forward_aligned(q_pad, k_pad, v_pad, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len,
                                     tile_dtype=tile_dtype)
    return o[:, :, :q_len], lse[:, :, :q_len]


def fa2_backward(q, k, v, o, lse, do=None, *, causal: bool = False,
                 sm_scale: float | None = None,
                 block_sizes: BlockSizes | None = None, tile_dtype=None,
                 window: int | None = None):
    """Standalone FA2 backward from forward artifacts (O, logsumexp
    [B, Hq, Sq]), as the JAX fa2_backward (attention.py:457-523): dO
    defaults to ones.  Returns (dQ, dK, dV)."""
    if do is None:
        do = torch.ones_like(o)
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, None, None, window, 0)
    if block_sizes is None:
        block_sizes = BlockSizes.default(causal)
    quantum = seq_pad_quantum(q_len, q.dtype)
    o_pad = pad_to_block(o, 2, quantum).contiguous()
    do_pad = pad_to_block(do, 2, quantum)
    lse_pad = pad_to_block(lse.float(), 2, quantum).contiguous()
    dq, dk, dv = _backward(q_pad, k_pad, v_pad, o_pad, lse_pad, do_pad, kv_len,
                           causal, sm_scale, block_sizes, tile_dtype)
    return dq[:, :, :q_len], dk[:, :, :kv_len], dv[:, :, :kv_len]
