"""Baseline attention kernels of the reference suite: FA1 (B9) and untuned
FA2 (B10), with their plain PyTorch versions.

  B9  fa1_aligned        replaces cuda_flash_attention_tpu/kernels/
                         baselines.py::_fa1_aligned
  B10 naive_fa2_aligned  replaces ...::_naive_fa2_aligned
The CUDA kernels are csrc/baselines.cu; its source note says what bounds them
on the H100 and why their schedules stay as they are.  Both take head dims
32, 64, 128 and 256 (D 32 and 256 each from a library of their own,
common.kernel_library); a launch at D 32 or 256 also counts under
`fa1_d32`, `naive_fa2_d256` and so on.  Both are forward-only,
fp32-only and non-causal, like the JAX ones and the reference's (the
registry refuses the rest).  On a CPU tensor a wrapper runs its plain
version; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    FORWARD_HEAD_DIMS,
    MIN_BLOCK,
    head_dim_error,
    kernel_library,
    pad_to_block,
)

# KV rows per tile of both kernels; the plain versions walk the same tiles,
# so they round where the kernels round.
KV_TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library("baselines", head_dim))
    if lib.cfa_fa1_forward.argtypes is None:
        lib.cfa_fa1_forward.argtypes = [_P] * 6 + [_I] * 5 + [_F, _P]
        lib.cfa_naive_fa2_forward.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.cfa_fa1_forward.restype = _I
        lib.cfa_naive_fa2_forward.restype = _I
    return lib


def _check(name, q, k, v):
    """What both kernels take; raises on anything else."""
    if q.dtype != torch.float32:
        raise NotImplementedError(f"{name} kernel: fp32 only; got {q.dtype}")
    if q.shape[3] not in FORWARD_HEAD_DIMS:
        raise head_dim_error(name, q.shape[3])
    if k.shape[1] != q.shape[1] or q.shape[0] * q.shape[1] > 65535:
        raise NotImplementedError(
            f"{name} kernel: one KV head per query head and batch * heads "
            "<= 65535")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} kernel: q/k/v must be contiguous, on one "
                             "device, of one dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: inputs must be 16-byte aligned "
                             "(cp.async copies 16 bytes at a time)")


def fa1_aligned(q, k, v, *, sm_scale: float, kv_len: int):
    """B9: FA1 over q [B, H, Sq, D] and k/v [B, H, Skv, D]; keys at or past
    kv_len are masked.  Returns O like q (the running m and l are kernel
    scratch, dropped as the JAX wrapper drops them)."""
    if q.device.type == "cpu":
        return fa1_plain(q, k, v, sm_scale=sm_scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"fa1: unsupported device {q.device}")
    _check("fa1", q, k, v)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    lib = _lib(d)
    err = lib.cfa_fa1_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), b * h, sq, k.shape[2], d, kv_len, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_baselines_error_string", err, "fa1")
    launches.count("fa1", head_dim=d)
    return o


def naive_fa2_aligned(q, k, v, *, sm_scale: float, kv_len: int):
    """B10: untuned FA2 over the same inputs as fa1_aligned.  Returns O."""
    if q.device.type == "cpu":
        return naive_fa2_plain(q, k, v, sm_scale=sm_scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"naive_fa2: unsupported device {q.device}")
    _check("naive_fa2", q, k, v)
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    lib = _lib(d)
    err = lib.cfa_naive_fa2_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, sq,
        k.shape[2], d, kv_len, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_baselines_error_string", err, "naive_fa2")
    launches.count("naive_fa2", head_dim=d)
    return o


def _tiles(q, k, v, sm_scale, kv_len):
    """Per KV tile of KV_TILE rows that holds a live key: (P's logits
    S = sm_scale * Q K^T with dead keys at DEFAULT_MASK_VALUE, V tile), in
    fp32 on whole rows of Q."""
    qf, kf, vf = q.float(), k.float(), v.float()
    for k0 in range(0, kv_len, KV_TILE):
        s = (qf @ kf[:, :, k0:k0 + KV_TILE].transpose(-1, -2)) * sm_scale
        cols = torch.arange(k0, k0 + s.shape[-1], device=q.device)
        s = torch.where(cols < kv_len, s, DEFAULT_MASK_VALUE)
        yield s, vf[:, :, k0:k0 + KV_TILE]


def _update(s, v, m_prev, l_prev):
    """One tile of the running softmax (baselines.py:84-101): the new max
    and sum, and the scales of the old output and of P V."""
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    inv = torch.where(l_new == 0.0, 1.0, 1.0 / l_new)
    return m_new, l_new, l_prev * alpha * inv, inv, p @ v


def fa1_plain(q, k, v, *, sm_scale: float, kv_len: int):
    """B9's function: the FA1 update per KV tile, O renormalised and
    re-rounded to fp32 at every tile (baselines.py:84-104)."""
    rows = q.shape[:3] + (1,)
    m = torch.full(rows, float("-inf"), device=q.device)
    l = torch.zeros(rows, device=q.device)
    o = torch.zeros(q.shape, device=q.device)
    for s, vt in _tiles(q, k, v, sm_scale, kv_len):
        m, l, scale_old, scale_pv, pv = _update(s, vt, m, l)
        o = scale_old * o + scale_pv * pv
    return o.to(q.dtype)


def naive_fa2_plain(q, k, v, *, sm_scale: float, kv_len: int):
    """B10's function: FA2 with the output renormalised eagerly at every
    KV tile (baselines.py:202-222).  Written per tile, its arithmetic is
    FA1's; the two kernels differ in schedule, not in values."""
    return fa1_plain(q, k, v, sm_scale=sm_scale, kv_len=kv_len)


def _pad_and_call(aligned, q, k, v, sm_scale):
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    kv_len = k.shape[2]
    q_pad = pad_to_block(q, 2, MIN_BLOCK).contiguous()
    k_pad = pad_to_block(k, 2, MIN_BLOCK).contiguous()
    v_pad = pad_to_block(v, 2, MIN_BLOCK).contiguous()
    o = aligned(q_pad, k_pad, v_pad, sm_scale=float(sm_scale), kv_len=kv_len)
    return o[:, :, :q.shape[2]]


def fa1_attention(q, k, v, *, sm_scale: float | None = None):
    """FlashAttention-1 baseline (forward only), q/k/v [B, H, S, D]."""
    return _pad_and_call(fa1_aligned, q, k, v, sm_scale)


def naive_fa2_attention(q, k, v, *, sm_scale: float | None = None):
    """Untuned FA2 baseline (forward only, fp32 only), q/k/v [B, H, S, D]."""
    return _pad_and_call(naive_fa2_aligned, q, k, v, sm_scale)
