"""FlashAttention-2 backward: kernels B2, B3, B4 and their plain PyTorch
versions.

Replaces the Pallas TPU kernels of cuda_flash_attention_tpu/kernels/
fa2_backward.py:
  B2 fa2_backward_fused_aligned  -> dQ, dK, dV in one recompute (D_i folded in)
  B3 fa2_backward_dq_aligned     -> dQ on a Q-major grid
  B4 fa2_backward_dkv_aligned    -> dK, dV on a KV-major grid
The CUDA kernels are csrc/fa2_backward.cu; its source note says what bounds
them on the H100 and how the design answers that.  On a CPU tensor a wrapper
runs its plain version; on a CUDA tensor it launches its kernel or raises.

Inputs are sequence-padded as for the forward (fa2_forward_aligned): q, o,
do [B, Hq, Sq, D]; k, v [B, Hkv, Skv, D]; lse and di [B, Hq, Sq] fp32 (the
JAX kernels take them as [B, Hq, Sq, 1] stat columns).  Keys at or past
`kv_len` are masked.  B2 returns dQ as a sum of per-KV-tile fp32 slices
that the wrapper adds in a fixed order, so gradients are bitwise equal from
run to run on both routes; no kernel adds floats with atomics.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build
from cuda_flash_attention_tpu_torch.kernels.common import (
    KERNEL_HEAD_DIMS,
    LN2,
    LOG2E,
    TILE_DTYPES,
    build_element_mask,
    tile_code,
)

# Kernel launches since the last reset (each wrapper adds one per launch).
fused_launches = 0
dq_launches = 0
dkv_launches = 0

_SOURCE = "fa2_backward"
# Rows of the KV tile that owns one dQ slice in B2, by tile code (the CUDA
# kernel's kKvRows with bf16 or fp16 tiles, kTile32 with fp32 tiles; the
# library reports its own through cfa_fa2_backward_kv_tile and the wrapper
# checks the two agree).
_FUSED_KV_TILE = {0: 64, 1: 128, 2: 128}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    if lib.cfa_fa2_backward_fused.argtypes is None:
        lib.cfa_fa2_backward_kv_tile.argtypes = [_I]
        lib.cfa_fa2_backward_kv_tile.restype = _I
        for tile, rows in _FUSED_KV_TILE.items():
            if lib.cfa_fa2_backward_kv_tile(tile) != rows:
                raise RuntimeError("fa2_backward: the library's KV tile differs "
                                   "from _FUSED_KV_TILE")
        lib.cfa_fa2_backward_fused.argtypes = [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
        lib.cfa_fa2_backward_dkv.argtypes = [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
        lib.cfa_fa2_backward_dq.argtypes = [_P] * 7 + [_I] * 7 + [_F, _F] + [_I] * 3 + [_P]
        for fn in (lib.cfa_fa2_backward_fused, lib.cfa_fa2_backward_dkv,
                   lib.cfa_fa2_backward_dq):
            fn.restype = _I
    return lib


def fused_kv_tile(q_dtype: torch.dtype, tile_dtype) -> int:
    """KV rows per dQ slice of B2 for these input and tile types."""
    return _FUSED_KV_TILE[tile_code(q_dtype, tile_dtype)]


def _check(name, q, k, v, tile_dtype, same, stats):
    """What every kernel takes; raises on anything else.  `same` must share
    q's dtype; `stats` are fp32."""
    if q.dtype not in (torch.float32, torch.bfloat16) or tile_dtype not in TILE_DTYPES:
        raise NotImplementedError(
            f"{name} kernel: inputs fp32/bf16 and tiles None/bf16/fp16; got "
            f"{q.dtype} with tile_dtype {tile_dtype}")
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{name} kernel: head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if q.shape[0] * max(q.shape[1], k.shape[1]) > 65535:
        raise NotImplementedError(f"{name} kernel: batch * heads > 65535")
    for t in (k, v) + same:
        if t.dtype != q.dtype:
            raise ValueError(f"{name} kernel: q/k/v/o/dO must share one dtype")
    for t in (q, k, v) + same + stats:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: inputs must be contiguous, on "
                             "one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: inputs must be 16-byte aligned")


def _common_args(q, k, kv_len, sm_scale, causal, tile_dtype):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    return ((b, hq, hkv, sq, skv, d, kv_len, sm_scale * LOG2E),
            (int(causal), int(q.dtype == torch.bfloat16),
             tile_code(q.dtype, tile_dtype),
             torch.cuda.current_stream(q.device).cuda_stream))


def _stat(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"lse/di must be fp32; got {x.dtype}")
    return x.contiguous()


def fa2_backward_fused_aligned(q, k, v, o, do, lse, *, causal: bool,
                               sm_scale: float, kv_len: int, tile_dtype=None):
    """B2: (dQ like q, dK like k, dV like v) in one recompute, D_i folded in
    from O and dO."""
    if q.device.type == "cpu":
        return fa2_backward_fused_plain(q, k, v, o, do, lse, causal=causal,
                                        sm_scale=sm_scale, kv_len=kv_len,
                                        tile_dtype=tile_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_fused: unsupported device {q.device}")
    global fused_launches
    do = do.contiguous()
    lse = _stat(lse)
    _check("fa2_backward_fused", q, k, v, tile_dtype, (do, o), (lse,))
    b, hq, sq, d = q.shape
    n_slices = -(-k.shape[2] // fused_kv_tile(q.dtype, tile_dtype))
    dq_part = torch.empty((b, hq, n_slices, sq, d), device=q.device,
                          dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ints, tail = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype)
    lib = _lib()
    err = lib.cfa_fa2_backward_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(),
        *ints, *tail)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_fused")
    fused_launches += 1
    # The slices add in one fixed order (torch.sum's, no atomics), then the
    # unscaled sum takes sm_scale and q's dtype, as the JAX wrapper does.
    dq = dq_part.sum(dim=2).mul_(sm_scale).to(q.dtype)
    return dq, dk, dv


def fa2_backward_dq_aligned(q, k, v, do, lse, di, *, causal: bool,
                            sm_scale: float, kv_len: int, tile_dtype=None):
    """B3: dQ like q, from lse and the precomputed D_i = rowsum(dO * O)."""
    if q.device.type == "cpu":
        return fa2_backward_dq_plain(q, k, v, do, lse, di, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len,
                                     tile_dtype=tile_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_dq: unsupported device {q.device}")
    global dq_launches
    do = do.contiguous()
    lse, di = _stat(lse), _stat(di)
    _check("fa2_backward_dq", q, k, v, tile_dtype, (do,), (lse, di))
    dq = torch.empty_like(q)
    ints, tail = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype)
    lib = _lib()
    err = lib.cfa_fa2_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *ints, sm_scale, *tail)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_dq")
    dq_launches += 1
    return dq


def fa2_backward_dkv_aligned(q, k, v, do, lse, di, *, causal: bool,
                             sm_scale: float, kv_len: int, tile_dtype=None):
    """B4: (dK like k, dV like v); the GQA group's query heads are summed
    inside the kernel before one store."""
    if q.device.type == "cpu":
        return fa2_backward_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                      sm_scale=sm_scale, kv_len=kv_len,
                                      tile_dtype=tile_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_dkv: unsupported device {q.device}")
    global dkv_launches
    do = do.contiguous()
    lse, di = _stat(lse), _stat(di)
    _check("fa2_backward_dkv", q, k, v, tile_dtype, (do,), (lse, di))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ints, tail = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype)
    lib = _lib()
    err = lib.cfa_fa2_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ints,
        *tail)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_dkv")
    dkv_launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, do, lse, di, *, causal, sm_scale, kv_len, tile_dtype):
    """P and the unscaled dS over whole rows, with the TPU kernel's rounding
    points (fa2_backward.py::_compute_p_ds): Q is scaled by sm_scale*log2(e)
    in fp32 and rounded to the tile type, K, V and dO are cast to it, S and
    dO V^T accumulate in fp32, P = exp2(S - lse*log2(e)) is exactly 0 where
    masked, dS = P * (dO V^T - D_i) in fp32, and P and dS are rounded to the
    tile type before their products.  The tile type is `tile_dtype`, else
    q's dtype.  K and V are expanded to the query heads (GQA).

    It does not reproduce the bf16 exp2 chain that the TPU kernel uses for
    score tiles of at least 2^18 elements (fa2_backward.py:90-105: t and
    dO V^T - D_i rounded to bf16 before the exp2 and the product); at the
    JAX train blocks (512 x 1024) that chain is on, at S <= 256 it is off.
    Returns (p, ds, q_s, k, do) as fp32 tensors holding tile-type values."""
    eff = tile_dtype if tile_dtype is not None else q.dtype
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    qs = (q.float() * (sm_scale * LOG2E)).to(eff).float()
    ks = k.to(eff).float()
    vs = v.to(eff).float()
    dos = do.to(eff).float()
    t = qs @ ks.transpose(-1, -2) - (lse.float() * LOG2E)[..., None]
    dpd = dos @ vs.transpose(-1, -2) - di.float()[..., None]
    p = torch.exp2(t)
    mask = build_element_mask(q.shape[2], k.shape[2], causal=causal,
                              kv_len=kv_len, device=q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    ds = (p * dpd).to(eff).float()
    p = p.to(eff).float()
    return p, ds, qs, ks, dos


def _group_sum(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, Hq, S, D] -> [B, Hkv, S, D], summing each GQA group in fp32."""
    b, hq, s, d = x.shape
    return x.reshape(b, kv_heads, hq // kv_heads, s, d).sum(dim=2)


def _dkv(p, ds, qs, dos, k):
    dv = _group_sum(p.transpose(-1, -2) @ dos, k.shape[1])
    dk = _group_sum(ds.transpose(-1, -2) @ qs, k.shape[1]) * LN2
    return dk.to(k.dtype), dv.to(k.dtype)


def fa2_backward_fused_plain(q, k, v, o, do, lse, *, causal: bool,
                             sm_scale: float, kv_len: int, tile_dtype=None):
    """B2's function: D_i = rowsum(dO * O) in fp32, then dQ, dK, dV."""
    di = (do.float() * o.float()).sum(dim=-1)
    p, ds, qs, ks, dos = _p_ds(q, k, v, do, lse, di, causal=causal,
                               sm_scale=sm_scale, kv_len=kv_len,
                               tile_dtype=tile_dtype)
    dq = ((ds @ ks) * sm_scale).to(q.dtype)
    return (dq, *_dkv(p, ds, qs, dos, k))


def fa2_backward_dq_plain(q, k, v, do, lse, di, *, causal: bool,
                          sm_scale: float, kv_len: int, tile_dtype=None):
    """B3's function: dQ = sm_scale * (dS K)."""
    _, ds, _, ks, _ = _p_ds(q, k, v, do, lse, di, causal=causal,
                            sm_scale=sm_scale, kv_len=kv_len,
                            tile_dtype=tile_dtype)
    return ((ds @ ks) * sm_scale).to(q.dtype)


def fa2_backward_dkv_plain(q, k, v, do, lse, di, *, causal: bool,
                           sm_scale: float, kv_len: int, tile_dtype=None):
    """B4's function: dV = P^T dO and dK = ln2 * (dS^T Q_s), each summed
    over the GQA group."""
    p, ds, qs, _, dos = _p_ds(q, k, v, do, lse, di, causal=causal,
                              sm_scale=sm_scale, kv_len=kv_len,
                              tile_dtype=tile_dtype)
    return _dkv(p, ds, qs, dos, k)
