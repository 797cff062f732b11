"""Ring attention: sequence (context) parallelism over the mesh's "ctx"
axis.

Counterpart of cuda_flash_attention_tpu/parallel/ring.py.  Each rank holds
one contiguous shard of the sequence's queries, keys and values.  K/V
shards rotate around the ctx ranks (rank r sends to r + 1 and receives
from r - 1, parallel.collectives.Exchange) while every rank runs the FA2
forward kernel (B1, or B8 where the API routes to it) on the shard in front
of it; the per-step partial results merge with the online-softmax algebra
(`_merge_partial`, a logsumexp-weighted combine).  The exchange for step
t + 1 is posted before step t's kernel and waited on after it.

Per step, with src the shard in front of this rank (idx):
  src <  idx : every key is in the past -> full attention, or under a
               global window the recency band that is left of it
               (`_band_window`, whose offset may be negative)
  src == idx : the diagonal -> the causal kernel (with the window)
  src >  idx : entirely in the future -> skipped (no kernel)
and rotations whose shard lies wholly behind the window are not made at
all (`_live_ring_steps`).

Backward (a torch.autograd.Function): attention's gradient splits exactly
by KV block once the GLOBAL logsumexp and D_i = rowsum(dO * O) are known,
so the backward runs the ring again with the backward kernels (B2, or B3 +
B4, by the port's route rule `kernels.attention._use_fused_bwd`, taken once
for the call on the local shard's shapes): dQ accumulates locally; the
dK/dV accumulators travel with their K/V block and go home in one
(axis_size - (n_steps - 1)) % axis_size-hop exchange.

`ring_attention_quantized` is the forward-only serving form: each rank
quantizes its K/V shard once (quant.qtensor.quantize_kv: int8, e4m3, e5m2
or split-half int4) and the values and scales rotate; B7 consumes them.

Every function takes this rank's local shards: q [B, Hq, S_local, D], k/v
[B, Hkv, S_local, D] (shard `idx` of the ctx axis, parallel.sharded.shard
with spec (data, model, ctx, None)), and returns this rank's shard of O.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_flash_attention_tpu_torch.kernels.attention import (
    _use_fused_bwd,
    flash_attention_with_lse,
)
from cuda_flash_attention_tpu_torch.kernels.common import (
    BlockSizes,
    fit_block,
    pad_to_block,
    seq_pad_quantum,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_backward import (
    fa2_backward_dkv_aligned,
    fa2_backward_dq_aligned,
    fa2_backward_fused_aligned,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import Exchange
from cuda_flash_attention_tpu_torch.parallel.mesh import CTX_AXIS


def _merge_partial(o_num, l_den, m_run, o_i, lse_i):
    """Accumulate one normalized partial (o_i, lse_i) into the running
    (numerator, denominator, max) triple."""
    m_new = torch.maximum(m_run, lse_i)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    w_old = torch.where(m_run == float("-inf"), 0.0, torch.exp(m_run - m_safe))
    w_new = torch.where(lse_i == float("-inf"), 0.0, torch.exp(lse_i - m_safe))
    o_num = o_num * w_old[..., None] + o_i.float() * w_new[..., None]
    l_den = l_den * w_old + w_new
    return o_num, l_den, m_new


def _live_ring_steps(axis_size: int, causal: bool, window,
                     shard_len: int) -> int:
    """Ring steps that can contribute under a sliding window.  Step t's KV
    shard sits t * shard_len positions in the past: its newest key serves
    local query 0 iff t * S < window + S - 1.  Later rotations (kernels and
    exchanges) are not made, so window + causal costs about
    ceil(window / shard_len) rotations, not axis_size - 1."""
    if not (causal and window is not None):
        return axis_size
    return min(axis_size, (window + 2 * shard_len - 2) // shard_len)


def _band_window(step: int, window, shard_len: int):
    """The LOCAL band of a past shard `step` rotations back: the global
    i - j < window with j offset by step * shard_len is the band
    i_local - j_local < window - step * shard_len (every key of a past
    shard precedes every local query, so the causal side holds by itself).
    The offset can be negative (only the shard's newest keys serve the
    oldest queries, and some queries keep none); None means the whole shard
    is in the window (full attention)."""
    if window is None:
        return None
    w_eff = window - step * shard_len
    return w_eff if w_eff < shard_len else None


def _step_kind(causal: bool, idx: int, step: int, axis_size: int) -> str:
    """"diag", "past" or "skip" (future) for the shard in front of rank
    `idx` at `step`."""
    src = (idx - step) % axis_size
    if not causal or src < idx:
        return "past"
    return "diag" if src == idx else "skip"


def _finish(o_num, l_den, m_run, dtype):
    l_safe = torch.where(l_den == 0.0, 1.0, l_den)
    o = (o_num / l_safe[..., None]).to(dtype)
    lse = torch.where(l_den == 0.0, float("-inf"), m_run + torch.log(l_safe))
    return o, lse


def _ring_forward(q, k, v, mesh, axis, causal, sm_scale, tile_dtype, window):
    """(O, lse) of this rank's queries over the whole ring."""
    n, idx, shard_len = mesh.size(axis), mesh.index(axis), k.shape[2]
    o_num = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l_den = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m_run = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                       device=q.device)
    n_steps = _live_ring_steps(n, causal, window, shard_len)
    for step in range(n_steps):
        # The next step's K/V travel while this step's kernel runs.
        nxt = Exchange([k, v], mesh, axis) if step < n_steps - 1 else None
        kind = _step_kind(causal, idx, step, n)
        if kind != "skip":
            diag = kind == "diag"
            o_i, lse_i = flash_attention_with_lse(
                q, k, v, causal=diag, sm_scale=sm_scale, tile_dtype=tile_dtype,
                window=window if diag else _band_window(step, window, shard_len))
            o_num, l_den, m_run = _merge_partial(o_num, l_den, m_run, o_i, lse_i)
        if nxt is not None:
            k, v = nxt.wait()
    return _finish(o_num, l_den, m_run, q.dtype)


def backward_route(q, k, *, tile_dtype=None, causal: bool, window) -> str:
    """"fused" (B2) or "split" (B3 + B4): the backward kernels of every step
    of a ring over local shards shaped like q and k, by the port's route
    rule on the padded shard (JAX's ring takes the fused kernel while the
    shard has at most _FUSED_BWD_MAX_KV_SLICES KV slices; the port's rule
    also sends a narrow causal window to the split pair and caps B2's dQ
    slices, ROADMAP.md's route note)."""
    q_pad = torch.empty((*q.shape[:2], _padded(q.shape[2], q.dtype), q.shape[3]),
                        dtype=q.dtype, device="meta")
    skv = _padded(k.shape[2], k.dtype)
    k_pad = torch.empty((*k.shape[:2], skv, k.shape[3]), dtype=k.dtype,
                        device="meta")
    bk_dkv = fit_block(BlockSizes.default().block_k_dkv, skv)
    fused = _use_fused_bwd(q_pad, k_pad, bk_dkv, tile_dtype, window, causal, 0)
    return "fused" if fused else "split"


def _padded(n: int, dtype) -> int:
    quantum = seq_pad_quantum(n, dtype)
    return -(-n // quantum) * quantum


def _pad(x, n):
    return pad_to_block(x, 2, seq_pad_quantum(n, x.dtype)).contiguous()


def _send_home(dk, dv, mesh, axis, n_steps):
    """The travelling dK/dV accumulators after the last step, moved to the
    rank whose K/V block they belong to: one more hop without a window, a
    single (n - n_steps + 1)-hop exchange after an early-stopped ring."""
    n = mesh.size(axis)
    return Exchange([dk, dv], mesh, axis, (n - (n_steps - 1)) % n).wait()


class _Ring(torch.autograd.Function):
    """Ring attention over local shards: forward `_ring_forward`, backward
    the ring of backward kernels (the module's note)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, sm_scale, tile_dtype, window):
        o, lse = _ring_forward(q, k, v, mesh, axis, causal, sm_scale,
                               tile_dtype, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis, causal, sm_scale, tile_dtype, window)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis, causal, sm_scale, tile_dtype, window = ctx.args
        n, idx = mesh.size(axis), mesh.index(axis)
        q_len, kv_len = q.shape[2], k.shape[2]
        q_pad, k_pad, v_pad = _pad(q, q_len), _pad(k, kv_len), _pad(v, kv_len)
        do_pad = _pad(do.to(q.dtype), q_len)
        o_pad = _pad(o, q_len)
        lse_pad = pad_to_block(lse, 2, seq_pad_quantum(q_len, q.dtype)).contiguous()
        fused = backward_route(q, k, tile_dtype=tile_dtype, causal=causal,
                               window=window) == "fused"
        di = None if fused else (o_pad.float() * do_pad.float()).sum(dim=-1)
        kw = dict(sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile_dtype)

        def grads(kk, vv, is_causal, band):
            if fused:
                return fa2_backward_fused_aligned(
                    q_pad, kk, vv, o_pad, do_pad, lse_pad, causal=is_causal,
                    window=band, **kw)
            dq_i = fa2_backward_dq_aligned(q_pad, kk, vv, do_pad, lse_pad, di,
                                           causal=is_causal, window=band, **kw)
            dk_i, dv_i = fa2_backward_dkv_aligned(
                q_pad, kk, vv, do_pad, lse_pad, di, causal=is_causal,
                window=band, **kw)
            return dq_i, dk_i, dv_i

        dq_acc = torch.zeros(q_pad.shape, dtype=torch.float32, device=q.device)
        dk_acc = torch.zeros(k_pad.shape, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        n_steps = _live_ring_steps(n, causal, window, kv_len)
        grad_in = None  # the accumulators arriving from the previous rank
        for step in range(n_steps):
            nxt = Exchange([k_pad, v_pad], mesh, axis) if step < n_steps - 1 else None
            kind = _step_kind(causal, idx, step, n)
            part = None
            if kind != "skip":
                diag = kind == "diag"
                part = grads(k_pad, v_pad, diag,
                             window if diag else _band_window(step, window, kv_len))
            if grad_in is not None:
                dk_acc, dv_acc = grad_in.wait()
            if part is not None:
                dq_acc += part[0].float()
                dk_acc += part[1].float()
                dv_acc += part[2].float()
            if nxt is not None:
                # The block's gradient travels with it.
                grad_in = Exchange([dk_acc, dv_acc], mesh, axis)
                k_pad, v_pad = nxt.wait()
        dk_acc, dv_acc = _send_home(dk_acc, dv_acc, mesh, axis, n_steps)
        dq = dq_acc[:, :, :q_len].to(q.dtype)
        dk = dk_acc[:, :, :kv_len].to(k.dtype)
        dv = dv_acc[:, :, :kv_len].to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def _normalize_window(window, causal, global_len):
    if window is None:
        return None
    if not causal:
        raise ValueError("ring sliding window requires causal=True")
    window = int(window)
    return None if window >= global_len else window


def ring_attention_local(q, k, v, *, mesh, axis_name: str = CTX_AXIS,
                         causal: bool = False, sm_scale: float | None = None,
                         tile_dtype=None, window: int | None = None):
    """Differentiable ring attention over this rank's shards along
    `axis_name` of `mesh` (the JAX function's axis_name and axis_size are
    the mesh's axis).

    ``window`` (requires causal) is the GLOBAL sliding window across the
    sharded sequence: the diagonal step runs the windowed causal kernel,
    past shards the recency band left of it, and rotations whose shard is
    wholly behind the window are skipped: O(ceil(window / shard_len))
    rotations, not axis_size."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    window = _normalize_window(window, causal, mesh.size(axis_name) * k.shape[2])
    return _Ring.apply(q, k, v, mesh, axis_name, causal, float(sm_scale),
                       tile_dtype, window)


def ring_attention(mesh, q, k, v, *, causal: bool = False,
                   sm_scale: float | None = None, tile_dtype=None,
                   window: int | None = None):
    """Sequence-parallel attention over `mesh`'s ctx axis, composable with
    data and model axes (each rank's q/k/v are its (batch, heads,
    sequence) block; the data and model axes need nothing inside
    attention).  Returns this rank's block of O.  Differentiable.
    ``window``: the global sliding window (ring_attention_local)."""
    return ring_attention_local(q, k, v, mesh=mesh, axis_name=CTX_AXIS,
                                causal=causal, sm_scale=sm_scale,
                                tile_dtype=tile_dtype, window=window)


def ring_attention_quantized(mesh, q, k, v, *, kv_dtype=None,
                             causal: bool = False,
                             sm_scale: float | None = None,
                             compute_dtype=torch.bfloat16,
                             window: int | None = None):
    """Sequence-parallel attention with QUANTIZED K/V shards rotating over
    the ctx axis (forward only; training takes `ring_attention`).  Each
    rank quantizes its K/V shard once per token (kv_dtype: torch.int8, the
    default, torch.float8_e4m3fn, torch.float8_e5m2 or "int4", split-half
    packed), then values and scales rotate while the quantized-KV kernel
    (B7, fused dequantization) consumes the shard in front of it: each
    step moves K/V's quantization ratio fewer bytes."""
    from cuda_flash_attention_tpu_torch.kernels.fa2_forward_quant import (
        flash_attention_quantized_kv_with_lse,
    )
    from cuda_flash_attention_tpu_torch.quant.qtensor import quantize_kv

    if kv_dtype is None:
        kv_dtype = torch.int8
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    n, idx = mesh.size(CTX_AXIS), mesh.index(CTX_AXIS)
    shard_len = k.shape[2]
    window = _normalize_window(window, causal, n * q.shape[2])
    k_q, v_q = quantize_kv(k, v, kv_dtype)
    o_num = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l_den = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m_run = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                       device=q.device)
    n_steps = _live_ring_steps(n, causal, window, shard_len)
    for step in range(n_steps):
        nxt = None
        if step < n_steps - 1:
            nxt = Exchange([k_q.values, k_q.scales, v_q.values, v_q.scales],
                           mesh, CTX_AXIS)
        kind = _step_kind(causal, idx, step, n)
        if kind != "skip":
            diag = kind == "diag"
            o_i, lse_i = flash_attention_quantized_kv_with_lse(
                q, k_q, v_q, causal=diag, sm_scale=float(sm_scale),
                compute_dtype=compute_dtype,
                window=window if diag else _band_window(step, window, shard_len))
            o_num, l_den, m_run = _merge_partial(o_num, l_den, m_run, o_i, lse_i)
        if nxt is not None:
            kv, ks, vv, vs = nxt.wait()
            k_q = dataclasses.replace(k_q, values=kv, scales=ks)
            v_q = dataclasses.replace(v_q, values=vv, scales=vs)
    return _finish(o_num, l_den, m_run, q.dtype)[0]
