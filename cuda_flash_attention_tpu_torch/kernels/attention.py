"""Public FlashAttention-2 API: validation, padding, dispatch, autograd.

Counterpart of cuda_flash_attention_tpu/kernels/attention.py.  q/k/v are
[B, H, S, D]; k/v may carry fewer heads than q (GQA, query heads ordered
KV-head-major).  Sequences are zero-padded to the block grid, a forward
kernel runs, and the padding is sliced off.  The forward is B1, or B8 where
the JAX package routes to its small-shape kernel (`_use_small_kernel`).  `flash_attention` is
differentiable: a torch.autograd.Function takes the place of the JAX
custom_vjp (attention.py:255-348).  Its forward saves the padded (q, k, v,
o, lse); its backward gets dO zero-padded from the slice's own backward and
runs either the fused kernel B2 or the split pair B3 + B4
(kernels/fa2_backward.py), by the JAX route rule `_use_fused_bwd`.

One route of the JAX API does not apply here: the small-fp32 XLA route
(its crossover was measured on a TPU; on CUDA a kernel is always taken), so
there is no `force_kernel` argument.  Sliding windows, the non-causal
recency band, attention sinks and segment ids (sequence packing) run in
every kernel of the path, forward (B1, B8) and backward (B2, B3, B4): the
route rule sends a narrow causal window without sinks to the split pair,
as JAX's does.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.kernels.common import (
    INPUT_DTYPES,
    MIN_BLOCK,
    TILE_DTYPES,
    BlockSizes,
    cdiv,
    fit_block,
    pack_segments,
    pad_to_block,
    reference_tiles,
    seq_pad_quantum,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_backward import (
    fa2_backward_dkv_aligned,
    fa2_backward_dq_aligned,
    fa2_backward_fused_aligned,
    fused_kv_tile,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import (
    fa2_forward_aligned,
    fa2_forward_small_aligned,
)

__all__ = ["BlockSizes", "flash_attention", "flash_attention_with_lse",
           "fa2_backward"]

# The JAX route rule: the fused backward B2 writes dQ as per-KV-slice fp32
# partials; above 8 slices the split pair's recompute is cheaper than the
# partials' traffic, and above 1 GiB of partials the fused route is refused
# outright.
_FUSED_BWD_MAX_KV_SLICES = 8
_FUSED_BWD_MAX_DQPART_BYTES = 1 << 30


def _use_fused_bwd(q, k, bk_dkv: int, tile_dtype=None, window=None,
                   causal: bool = False, sinks: int = 0) -> bool:
    """JAX attention.py:50-62 on padded q/k.  A narrow causal window
    without sinks (2 * window < Skv) takes the split pair, whose walks
    cover only the live span.  The slice count is the JAX one (KV slices
    of `bk_dkv` rows); the byte cap applies to the buffer that the port's
    B2 allocates, one fp32 slice of q's size per `fused_kv_tile` KV rows
    (128 with bf16/fp16 tiles, 64 at D 256 and in fp32), which is larger
    than the JAX buffer."""
    if window is not None and causal and sinks == 0 and 2 * window < k.shape[2]:
        return False
    if k.shape[2] // bk_dkv > _FUSED_BWD_MAX_KV_SLICES:
        return False
    slices = cdiv(k.shape[2], fused_kv_tile(q.dtype, tile_dtype, q.shape[3]))
    dq_part_bytes = 4 * q.shape[0] * q.shape[1] * slices * q.shape[2] * q.shape[3]
    return dq_part_bytes <= _FUSED_BWD_MAX_DQPART_BYTES



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
    if q.dtype not in INPUT_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f"q/k/v must share one dtype of {INPUT_DTYPES}; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if tile_dtype not in TILE_DTYPES:
        raise NotImplementedError(
            f"tile_dtype must be one of {TILE_DTYPES}; got {tile_dtype}"
        )


def _validate_segments(q_segment_ids, kv_segment_ids, q, k):
    """JAX attention.py:111-127, with its messages."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(
            "q_segment_ids and kv_segment_ids must be given together"
        )
    if q_segment_ids is None:
        return
    if tuple(q_segment_ids.shape) != (q.shape[0], q.shape[2]):
        raise ValueError(
            f"q_segment_ids must be [batch, q_len]="
            f"{(q.shape[0], q.shape[2])}; got {tuple(q_segment_ids.shape)}"
        )
    if tuple(kv_segment_ids.shape) != (k.shape[0], k.shape[2]):
        raise ValueError(
            f"kv_segment_ids must be [batch, kv_len]="
            f"{(k.shape[0], k.shape[2])}; got {tuple(kv_segment_ids.shape)}"
        )


def _normalize_sinks(sinks, window) -> int:
    """JAX attention.py:174-180."""
    sinks = int(sinks)
    if sinks < 0:
        raise ValueError(f"sinks must be >= 0; got {sinks}")
    if sinks and window is None:
        raise ValueError("attention sinks require a sliding window")
    return sinks if window is not None else 0


def _normalize_window(window, causal, q_len, kv_len):
    """JAX attention.py:183-208: validate the window and fold a no-op one
    away.  With causal=True it is the standard sliding window (the last
    `window` keys); with causal=False a recency band (query i keeps keys
    j > i - window, no future bound) whose offset may be <= 0 but must keep
    at least one (i, j) pair."""
    if window is None:
        return None
    window = int(window)
    if causal and window < 1:
        raise ValueError(f"causal window must be >= 1; got {window}")
    if not causal and window <= -(kv_len - 1):
        raise ValueError(
            f"band window {window} masks every key (kv_len {kv_len})"
        )
    if window >= kv_len and (causal or window >= q_len):
        return None
    return window


def _warn_small_blocks(window, block_sizes):
    """JAX attention.py:211-233: explicit blocks of <= 256 under a window of
    at least four blocks were measured slow on the TPU; the warning is kept
    so the two APIs answer the same arguments alike (the port's kernels
    keep their own tiles)."""
    if window is None or block_sizes is None:
        return
    b = min(block_sizes.block_q, block_sizes.block_k)
    if b <= 256 and window >= 4 * b:
        import warnings

        warnings.warn(
            f"window={window} with block sizes <= 256 is in the measured "
            f"slowdown regime (0.65x of global attention at W=4k); omit "
            f"block_sizes to get BlockSizes.default(window=...) "
            f"(b={max(MIN_BLOCK, min(1024, window))}-ish) instead",
            stacklevel=3,
        )


def _prepare(q, k, v, causal, sm_scale, tile_dtype, q_segment_ids,
             kv_segment_ids, window, sinks):
    """Validate and pad: (q, k, v padded and contiguous, sm_scale, q_len,
    kv_len).  The segment ids, window and sinks are validated here; the
    window is normalized by `_window_of`, the ids padded by
    `_segments_of`."""
    _validate_segments(q_segment_ids, kv_segment_ids, q, k)
    _validate_shapes(q, k, v)
    _validate_dtypes(q, k, v, tile_dtype)
    _window_of(window, sinks, causal, q, k)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    q_len, kv_len = q.shape[2], k.shape[2]
    q_pad = pad_to_block(q, 2, seq_pad_quantum(q_len, q.dtype)).contiguous()
    k_pad = pad_to_block(k, 2, seq_pad_quantum(kv_len, k.dtype)).contiguous()
    v_pad = pad_to_block(v, 2, seq_pad_quantum(kv_len, v.dtype)).contiguous()
    return q_pad, k_pad, v_pad, float(sm_scale), q_len, kv_len


def _window_of(window, sinks, causal, q, k):
    """(window, sinks) normalized as the JAX API does: a window that covers
    every key distance folds to None, and sinks need a window."""
    window = _normalize_window(window, causal, q.shape[2], k.shape[2])
    return window, _normalize_sinks(sinks, window)


def _segments_of(q_segment_ids, kv_segment_ids, q_pad, k_pad):
    """The ids padded to the padded grid, on q's device: (q_seg [B,
    Sq_pad], kv_seg [B, Skv_pad]) int32, or (None, None)."""
    segs = pack_segments(q_segment_ids, kv_segment_ids, q_pad.shape[2],
                         k_pad.shape[2])
    if segs is None:
        return None, None
    return tuple(ids.to(q_pad.device) for ids in segs)


def _use_small_kernel(q, k) -> bool:
    """JAX attention.py:273-277 on padded q/k: one whole tile per head
    (Sq = Skv <= 128) and one KV head per query head take B8, at every
    head dim."""
    return (q.shape[2] <= MIN_BLOCK and k.shape[2] == q.shape[2]
            and k.shape[1] == q.shape[1])


def _forward(q, k, v, kv_len, causal, sm_scale, tile_dtype, window=None,
             sinks=0, segs=(None, None), block_sizes=None):
    """(O, lse) over padded q/k/v by B8 or B1 (JAX attention.py:273-293).
    A dead row's lse follows the JAX forward's tiles for `block_sizes`."""
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len,
              tile_dtype=tile_dtype, window=window, sinks=sinks, q_seg=segs[0],
              kv_seg=segs[1])
    if _use_small_kernel(q, k):
        return fa2_forward_small_aligned(q, k, v, **kw)
    return fa2_forward_aligned(
        q, k, v, lse_tiles=reference_tiles(q.shape[2], k.shape[2], causal,
                                           window, block_sizes), **kw)


def _backward(q, k, v, o, lse, do, kv_len, causal, sm_scale, block_sizes,
              tile_dtype, window=None, sinks=0, segs=(None, None)):
    """dQ, dK, dV over padded inputs: B2, or B3 + B4 with
    D_i = rowsum(dO * O) as a plain fp32 reduction (the JAX package computes
    it in XLA outside Pallas, attention.py:327-329)."""
    do = do.contiguous()
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len,
              tile_dtype=tile_dtype, window=window, sinks=sinks, q_seg=segs[0],
              kv_seg=segs[1])
    bk_dkv = fit_block(block_sizes.block_k_dkv, k.shape[2])
    if _use_fused_bwd(q, k, bk_dkv, tile_dtype, window, causal, sinks):
        return fa2_backward_fused_aligned(q, k, v, o, do, lse, **kw)
    di = (o.float() * do.float()).sum(dim=-1)
    dq = fa2_backward_dq_aligned(q, k, v, do, lse, di, **kw)
    dk, dv = fa2_backward_dkv_aligned(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


class _FA2(torch.autograd.Function):
    """FA2 over padded q/k/v: forward B1 or B8, backward B2 or B3 + B4."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, sm_scale, block_sizes,
                tile_dtype, window, sinks, q_seg, kv_seg):
        segs = (q_seg, kv_seg)
        o, lse = _forward(q, k, v, kv_len, causal, sm_scale, tile_dtype,
                          window, sinks, segs, block_sizes)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (kv_len, causal, sm_scale, block_sizes, tile_dtype, window,
                    sinks, segs)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None,
                    block_sizes: BlockSizes | None = None, tile_dtype=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    window: int | None = None, sinks: int = 0):
    """Differentiable FlashAttention-2.  Returns O with q's shape and dtype.

    ``tile_dtype`` (None, torch.bfloat16 or torch.float16) is the precision
    of the Q/K/V/P tiles inside the kernels; softmax statistics stay fp32.
    None computes in q's dtype.  ``block_sizes`` (default
    `BlockSizes.default(causal, window)`) picks the backward route, as the
    JAX rule counts its KV slices, and the tiles whose walk sets a dead
    row's lse; the kernels keep their own tiles.

    ``q_segment_ids`` [B, Sq] and ``kv_segment_ids`` [B, Skv] (integers,
    given together) pack sequences: position i attends to j only when
    their ids match; give padding an id that matches no real token (its O
    rows are zeros).  ``window`` with causal=True keeps, for query i, the
    keys j <= i with i - j < window; with causal=False it is a recency band
    (j > i - window, no future bound; the offset may be <= 0).  ``sinks``
    keeps the first `sinks` keys for every query besides (StreamingLLM).
    A row that keeps no key gives O = 0 (its lse: kernels/common.py
    dead_row_lse) and no gradient."""
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, q_segment_ids, kv_segment_ids,
        window, sinks)
    window, sinks = _window_of(window, sinks, causal, q, k)
    if block_sizes is None:
        block_sizes = BlockSizes.default(causal, window=window)
    else:
        _warn_small_blocks(window, block_sizes)
    q_seg, kv_seg = _segments_of(q_segment_ids, kv_segment_ids, q_pad, k_pad)
    o = _FA2.apply(q_pad, k_pad, v_pad, kv_len, causal, sm_scale, block_sizes,
                   tile_dtype, window, sinks, q_seg, kv_seg)
    return o[:, :, :q_len]


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: float | None = None,
                             block_sizes: BlockSizes | None = None,
                             tile_dtype=None, q_segment_ids=None,
                             kv_segment_ids=None, window: int | None = None,
                             sinks: int = 0):
    """FA2 forward returning (O, logsumexp [B, H, Sq] fp32).  Not
    differentiable, as in the JAX API: use `flash_attention` for
    gradients."""
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, q_segment_ids, kv_segment_ids,
        window, sinks)
    window, sinks = _window_of(window, sinks, causal, q, k)
    if block_sizes is not None:
        _warn_small_blocks(window, block_sizes)
    segs = _segments_of(q_segment_ids, kv_segment_ids, q_pad, k_pad)
    with torch.no_grad():
        o, lse = _forward(q_pad, k_pad, v_pad, kv_len, causal, sm_scale,
                          tile_dtype, window, sinks, segs, block_sizes)
    return o[:, :, :q_len], lse[:, :, :q_len]


def fa2_backward(q, k, v, o, lse, do=None, *, causal: bool = False,
                 sm_scale: float | None = None,
                 block_sizes: BlockSizes | None = None, tile_dtype=None,
                 window: int | None = None):
    """Standalone FA2 backward from forward artifacts (O, logsumexp
    [B, Hq, Sq]), as the JAX fa2_backward (attention.py:457-523): dO
    defaults to ones; a window (no sinks) masks as the forward's and
    takes part in the route rule.  Returns (dQ, dK, dV)."""
    if do is None:
        do = torch.ones_like(o)
    q_pad, k_pad, v_pad, sm_scale, q_len, kv_len = _prepare(
        q, k, v, causal, sm_scale, tile_dtype, None, None, window, 0)
    window, _ = _window_of(window, 0, causal, q, k)
    if block_sizes is None:
        block_sizes = BlockSizes.default(causal, window=window)
    else:
        _warn_small_blocks(window, block_sizes)
    quantum = seq_pad_quantum(q_len, q.dtype)
    o_pad = pad_to_block(o, 2, quantum).contiguous()
    do_pad = pad_to_block(do, 2, quantum)
    lse_pad = pad_to_block(lse.float(), 2, quantum).contiguous()
    dq, dk, dv = _backward(q_pad, k_pad, v_pad, o_pad, lse_pad, do_pad, kv_len,
                           causal, sm_scale, block_sizes, tile_dtype, window)
    return dq[:, :, :q_len], dk[:, :, :kv_len], dv[:, :, :kv_len]
