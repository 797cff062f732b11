"""Plain PyTorch reference attention: the correctness oracles.

Counterpart of cuda_flash_attention_tpu/ops/reference.py.  Everything here
computes in fp32 with TF32 off (both `torch.backends` flags, for the
duration of each call), so on the card it is as exact as on the CPU:
  * `vanilla_attention(_with_lse)`: materialized softmax(QK^T * scale) V,
    with causal masking, sliding windows and sinks, segment ids, and the
    fully-masked-row rule (O = 0, lse = -inf); it is also the `naive`
    (VANILLA) method of the dispatch layer;
  * `vanilla_attention_chunked`: the same, Q-chunked at 512 rows, each chunk
    under torch.utils.checkpoint so that its gradient never holds S x S;
  * `reference_attention_grads`: (dQ, dK, dV) by torch.autograd through
    either, with dO = 1 by default (the row max detached: at S 32768 on an
    H100 its gradient path put 1.6e-3 of fp32 error into dK against an
    fp64 reference, scripts/longctx_grads.py of this package);
  * `sdpa_attention(_grads)`: the independent second oracle,
    torch.nn.functional.scaled_dot_product_attention under its math backend.
    It is an oracle only: no attention path of the port calls it.
The logsumexp contract is lse = log(sum_j exp(s_j - m)) + m, natural log.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def _fp32_matmuls():
    """fp32 means fp32: TF32 off for matmuls and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _attention_core(q, k, v, *, causal, sm_scale, compute_dtype,
                    q_segment_ids=None, kv_segment_ids=None, window=None,
                    sinks=0):
    """Materialized softmax(QK^T * scale) V with logsumexp, in compute_dtype
    (JAX reference.py:23-76)."""
    orig_dtype = q.dtype
    q, k, v = (t.to(compute_dtype) for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * sm_scale
    if causal or window is not None:
        q_len, kv_len = s.shape[-2], s.shape[-1]
        row = torch.arange(q_len, device=s.device)[:, None]
        col = torch.arange(kv_len, device=s.device)[None, :]
        if causal:
            s = torch.where(col <= row, s, float("-inf"))
        if window is not None:
            # Query i sees keys j with i - j < window, plus the first
            # `sinks` keys.
            keep = row - col < window
            if sinks > 0:
                keep = keep | (col < sinks)
            s = torch.where(keep, s, float("-inf"))
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        s = torch.where(seg, s, float("-inf"))
    # The row max only shifts the exponent: O and lse do not depend on it,
    # so it carries no gradient (detached).  Through autograd it would
    # route a sum that is zero only in exact arithmetic to each row's
    # argmax key, an fp32 error in dK that grows with the row's length.
    m = s.amax(dim=-1, keepdim=True).detach()
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = p @ v
    # Fully masked rows: O = 0 (the kernels' l == 0 guard), lse = -inf.
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = o / l_safe
    lse = torch.where(l[..., 0] == 0.0, float("-inf"),
                      (torch.log(l_safe) + m_safe)[..., 0])
    return o.to(orig_dtype), lse.float()


def vanilla_attention_with_lse(q, k, v, *, causal: bool = False,
                               sm_scale: float | None = None,
                               compute_dtype=torch.float32,
                               q_segment_ids=None, kv_segment_ids=None,
                               window: int | None = None, sinks: int = 0):
    """Reference attention over q [B, H, Sq, D], k/v [B, H, Skv, D]
    returning (O, logsumexp [B, H, Sq]).  ``sm_scale`` defaults to
    1/sqrt(D)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    with _fp32_matmuls():
        return _attention_core(
            q, k, v, causal=causal, sm_scale=float(sm_scale),
            compute_dtype=compute_dtype, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, window=window, sinks=sinks)


def vanilla_attention(q, k, v, **kwargs):
    """Reference attention returning only O (the arguments of
    vanilla_attention_with_lse)."""
    return vanilla_attention_with_lse(q, k, v, **kwargs)[0]


def vanilla_attention_chunked(q, k, v, *, causal: bool = False,
                              sm_scale: float | None = None, chunk: int = 512,
                              return_lse: bool = False):
    """Oracle attention for long contexts (JAX reference.py:136-193): scores
    are materialized per Q-chunk ([chunk, Skv] instead of [Sq, Skv]), each
    chunk under torch.utils.checkpoint, so that a backward through it
    recomputes the chunk's scores instead of keeping all of them.  Same
    numerics as `vanilla_attention`.  ``return_lse=True`` also returns
    logsumexp [B, H, Sq]."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    sq, kv_len = q.shape[2], k.shape[2]
    kf, vf = k.float(), v.float()

    def one_chunk(qi, row0):
        s = (qi @ kf.transpose(-1, -2)) * sm_scale
        if causal:
            row = torch.arange(row0, row0 + qi.shape[2], device=s.device)[:, None]
            col = torch.arange(kv_len, device=s.device)[None, :]
            s = torch.where(col <= row, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True).detach()  # no gradient: _attention_core
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m_safe)
        l = p.sum(dim=-1, keepdim=True)
        return (p @ vf) / l, (torch.log(l) + m_safe)[..., 0]

    outs, lses = [], []
    with _fp32_matmuls():
        for row0 in range(0, sq, chunk):
            qi = q[:, :, row0:row0 + chunk].float()
            if torch.is_grad_enabled() and any(
                    t.requires_grad for t in (q, k, v)):
                o_i, lse_i = checkpoint(one_chunk, qi, row0, use_reentrant=False)
            else:
                o_i, lse_i = one_chunk(qi, row0)
            outs.append(o_i)
            lses.append(lse_i)
    o = torch.cat(outs, dim=2).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.cat(lses, dim=2)


def reference_attention_grads(q, k, v, do=None, *, causal: bool = False,
                              sm_scale: float | None = None,
                              chunked: bool = False):
    """Oracle gradients (dQ, dK, dV) by torch.autograd through
    `vanilla_attention`, or through the Q-chunked oracle when ``chunked``,
    of the loss sum(O * dO); dO defaults to ones (loss sum(O))."""
    base = vanilla_attention_chunked if chunked else vanilla_attention
    with torch.enable_grad(), _fp32_matmuls():
        ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = base(*ts, causal=causal, sm_scale=sm_scale)
        loss = o.sum() if do is None else (o * do).sum()
        return torch.autograd.grad(loss, ts)


def sdpa_attention(q, k, v, *, causal: bool = False,
                   sm_scale: float | None = None):
    """Second-oracle forward: scaled_dot_product_attention, math backend,
    in fp32 (k/v may carry fewer heads than q)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH), _fp32_matmuls():
        o = F.scaled_dot_product_attention(
            q.float(), k.float(), v.float(), is_causal=causal, scale=sm_scale,
            enable_gqa=k.shape[1] != q.shape[1])
    return o.to(q.dtype)


def sdpa_attention_grads(q, k, v, do=None, *, causal: bool = False,
                         sm_scale: float | None = None):
    """Second-oracle gradients: torch.autograd through `sdpa_attention`."""
    with torch.enable_grad():
        ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = sdpa_attention(*ts, causal=causal, sm_scale=sm_scale)
        loss = o.sum() if do is None else (o * do).sum()
        return torch.autograd.grad(loss, ts)
