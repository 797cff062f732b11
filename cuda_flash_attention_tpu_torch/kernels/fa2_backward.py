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
`kv_len` are masked, and so, as in the forward (kernels/fa2_forward.py),
are the keys outside a sliding window or band (`window`, NO_WINDOW in the
kernels for none) and its sinks, and those of another segment (q_seg
[B, Sq], kv_seg [B, Skv] int32); a windowed launch also counts under
`<name>_window`, a segmented one under `<name>_segments`.  A masked P is
exactly 0 (selected, never multiplied: a dead row's lse is -inf or the
mask value), so a row that keeps no key gets dQ = 0 and adds nothing to
dK or dV.  B2 forms dQ from per-KV-tile fp32 slices: its main kernel
writes the slices of the Q tiles each KV tile reaches
(`fused_live_q_tiles`), and a reduce kernel adds, in KV-tile order, the
slices of the KV tiles that each row's window walks (a subset of those
written), so gradients are bitwise equal from run to run on both routes;
no kernel adds floats with atomics.  Each of the three first runs
a prologue kernel that forms Q_s, lse * log2(e) and D_i once per call (and
dO, K, V in the tile type where the inputs are not) in a workspace the
wrapper allocates: B2 folds D_i in from O and dO, B3 and B4 copy the
caller's.  `fused_prologue_plain` is its plain version.  B3 walks Q tiles
over KV tiles of `dq_kv_tile` rows (`dq_kv_tiles`); B4 walks as B2 without
writing dQ.  fp32 tiles run on the FMA units with 64-row Q and KV tiles
(`fp32=True` in the walk functions).  Every kernel takes head dims 32, 64,
128 and 256 (FORWARD_HEAD_DIMS; D 32 and 256 in libraries of their own,
common.kernel_library); at D 256 B2's and B4's blocks own 64 KV rows and
B3 walks 32-row KV tiles with bf16 or fp16 tiles, and a launch there or at
D 32 also counts under `<name>_d256` or `<name>_d32`.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.common import (
    FORWARD_HEAD_DIMS,
    LN2,
    LOG2E,
    NO_WINDOW,
    TILE_DTYPES,
    build_element_mask,
    cdiv,
    head_dim_error,
    kernel_library,
    tile_code,
    window_q_tiles,
    window_tiles,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import seg_args

_SOURCE = "fa2_backward"
# Rows of the KV tile that owns one dQ slice in B2, by tile code (the CUDA
# kernel's kKvRows with bf16 or fp16 tiles, kFmaTile with fp32 tiles), and
# with bf16 or fp16 tiles at D 256 (WideLayout::kKv); the library reports
# its own through cfa_fa2_backward_kv_tile and the wrapper checks the two
# agree.
_FUSED_KV_TILE = {0: 64, 1: 128, 2: 128}
_WIDE_KV_TILE = 64


def _kv_rows(code: int, head_dim: int) -> int:
    """B2's KV rows per block (and per dQ slice) for tile code `code`."""
    return _WIDE_KV_TILE if code and head_dim > 128 else _FUSED_KV_TILE[code]


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# The library's entry points (csrc/fa2_backward.cu): B2, B4 and B3 take the
# workspace (cfa_fa2_backward_workspace bytes) before the stream.
# Each takes the window and the sinks after its causal flag, and B2-B4
# the two segment-id pointers (0 without ids) after them.
ARGTYPES = {
    "cfa_fa2_backward_fused": [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P] * 2
                              + [_I] * 2 + [_P, _P],
    "cfa_fa2_backward_workspace": [_I] * 8,
    "cfa_fa2_backward_kv_tile": [_I, _I],
    "cfa_fa2_backward_dq_reduce": [_P, _P] + [_I] * 9 + [_F] + [_I] * 2 + [_P],
    "cfa_fa2_backward_dkv": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P] * 2
                            + [_I] * 2 + [_P, _P],
    "cfa_fa2_backward_dq": [_P] * 7 + [_I] * 7 + [_F, _F] + [_I] * 3
                           + [_P] * 2 + [_I] * 2 + [_P, _P],
}


def _lib(head_dim: int) -> ctypes.CDLL:
    """The library of csrc/fa2_backward.cu that holds `head_dim`."""
    lib = _build.load(kernel_library(_SOURCE, head_dim))
    if lib.cfa_fa2_backward_fused.argtypes is None:
        for name, argtypes in ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
        lib.cfa_fa2_backward_kv_tile.restype = _I
        for code in _FUSED_KV_TILE:
            if lib.cfa_fa2_backward_kv_tile(code, head_dim) != _kv_rows(code, head_dim):
                raise RuntimeError("fa2_backward: the library's KV tile differs "
                                   "from _kv_rows")
        lib.cfa_fa2_backward_workspace.restype = ctypes.c_longlong
        for fn in (lib.cfa_fa2_backward_fused, lib.cfa_fa2_backward_dkv,
                   lib.cfa_fa2_backward_dq, lib.cfa_fa2_backward_dq_reduce):
            fn.restype = _I
    return lib


def fused_kv_tile(q_dtype: torch.dtype, tile_dtype, head_dim: int = 64) -> int:
    """KV rows per dQ slice of B2 for these input and tile types at
    `head_dim`: 128 with bf16 or fp16 tiles (64 at D 256), 64 in fp32."""
    return _kv_rows(tile_code(q_dtype, tile_dtype), head_dim)


def fused_q_tile(head_dim: int, fp32: bool = False) -> int:
    """Q rows per step of B2's and B4's walk: with bf16 or fp16 tiles the
    CUDA kernel's BwdLayout::BQ, 128 at D 32 and 64 and 64 at D 128, and
    WideLayout::BQ, 64 at D 256; with fp32 tiles (`fp32`) 64."""
    return 64 if fp32 or head_dim >= 128 else 128


def fused_live_q_tiles(sq: int, skv: int, kv_len: int, causal: bool,
                       head_dim: int, fp32: bool = False, window=None,
                       sinks: int = 0) -> list[range]:
    """For each KV tile of B2 (or B4), 128 rows with bf16 or fp16 tiles (64
    at D 256) and 64 with fp32 tiles (`fp32`), the Q tiles (of
    `fused_q_tile` rows, over padded lengths) that its block walks and
    whose dQ slice rows it writes: under causal from the tile holding the
    KV tile's first row, to
    the last Q tile whose window reaches the KV tile (every tile for a tile
    holding a sink), none for a KV tile wholly past kv_len
    (common.window_q_tiles; csrc/hopper.cuh QWalk)."""
    bq = fused_q_tile(head_dim, fp32)
    kv_tile = _kv_rows(0 if fp32 else 1, head_dim)
    return [window_q_tiles(k0, kv_tile, cdiv(sq, bq), bq, causal=causal,
                           window=window, sinks=sinks, kv_len=kv_len)
            for k0 in range(0, skv, kv_tile)]


def reduce_kv_tiles(row: int, kv_len: int, causal: bool, tile: int,
                    window=None, sinks: int = 0) -> list[int]:
    """The dQ slices (KV tiles of `tile` rows) that B2's reduce adds for
    query row `row`, in order: those holding a key the row keeps (the
    sink tiles, then its window's tiles to the diagonal under causal, or
    to kv_len), each written by B2's walk."""
    end = min(kv_len, row + 1) if causal else kv_len
    first = row - window + 1 if window is not None else 0
    n_sink, lo, n = window_tiles(first, end, sinks if window is not None else 0,
                                 tile)
    return list(range(n_sink)) + list(range(lo, lo + n - n_sink))


def fused_dq_slice_bytes(b: int, hq: int, sq: int, skv: int, kv_len: int,
                         causal: bool, head_dim: int, window=None,
                         sinks: int = 0) -> int:
    """fp32 bytes of B2's dQ slices (bf16 or fp16 tiles) that its main
    kernel writes plus those its reduce reads back: the rows of each KV
    tile's live Q tiles, and for each row the slices of `reduce_kv_tiles`."""
    bq, kv_tile = fused_q_tile(head_dim), _kv_rows(1, head_dim)
    written = sum(min(len(t) * bq, sq - t.start * bq)
                  for t in fused_live_q_tiles(sq, skv, kv_len, causal, head_dim,
                                              window=window, sinks=sinks)
                  if len(t))
    read = sum(len(reduce_kv_tiles(r, kv_len, causal, kv_tile, window, sinks))
               for r in range(sq))
    return 4 * head_dim * b * hq * (written + read)


def dq_kv_tile(head_dim: int, fp32: bool = False) -> int:
    """KV rows per step of B3's walk: with bf16 or fp16 tiles the CUDA
    kernel's DqLayout::BN, 128 at D 64, 64 at D 32 and 128 and 32 at D 256,
    over 128-row Q tiles (DqLayout::BQ); with fp32 tiles (`fp32`) 64, over
    64-row Q tiles."""
    if fp32:
        return 64
    return {32: 64, 64: 128, 128: 64, 256: 32}[head_dim]


def dq_kv_tiles(sq: int, kv_len: int, causal: bool, head_dim: int,
                fp32: bool = False, window=None, sinks: int = 0) -> list:
    """For each Q tile of B3 (128 rows with bf16 or fp16 tiles, 64 with
    fp32 tiles), the KV tiles (of `dq_kv_tile` rows) that its block walks,
    in order: to kv_len, and under causal to the tile holding the Q tile's
    last row before sq; with a window the sink tiles, then from the tile
    holding the oldest key of the Q tile's first row (common.window_tiles;
    csrc/hopper.cuh KvWalk); none with no key."""
    bn = dq_kv_tile(head_dim, fp32)
    bq = 64 if fp32 else 128
    tiles = []
    for q0 in range(0, sq, bq):
        end = min(kv_len, sq, q0 + bq) if causal else kv_len
        if window is None:
            tiles.append(range(cdiv(max(end, 0), bn)))
            continue
        n_sink, lo, n = window_tiles(q0 - window + 1, end, sinks, bn)
        tiles.append(list(range(n_sink)) + list(range(lo, lo + n - n_sink)))
    return tiles


def _workspace(lib, q, k, in_bf16: int, tiles: int) -> torch.Tensor:
    """The prologue's workspace for B2, B3 or B4."""
    b, hq, sq, d = q.shape
    n = lib.cfa_fa2_backward_workspace(b, hq, k.shape[1], sq, k.shape[2], d,
                                       in_bf16, tiles)
    return torch.empty(n, device=q.device, dtype=torch.uint8)


def _check(name, q, k, v, tile_dtype, same, stats):
    """What every kernel takes; raises on anything else.  `same` must share
    q's dtype; `stats` are fp32."""
    if q.dtype not in (torch.float32, torch.bfloat16) or tile_dtype not in TILE_DTYPES:
        raise NotImplementedError(
            f"{name} kernel: inputs fp32/bf16 and tiles None/bf16/fp16; got "
            f"{q.dtype} with tile_dtype {tile_dtype}")
    d = q.shape[3]
    if d not in FORWARD_HEAD_DIMS:
        raise head_dim_error(name, d)
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


def _common_args(q, k, kv_len, sm_scale, causal, tile_dtype, window, sinks,
                 q_seg, kv_seg):
    """(the ints and scale before the causal flag, the causal flag, window,
    sinks, segment-id pointers, input and tile codes and stream after it,
    the tensors holding the ids)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    held, q_ids, kv_ids = seg_args(q_seg, kv_seg, b, sq, skv)
    return ((b, hq, hkv, sq, skv, d, kv_len, sm_scale * LOG2E),
            (int(causal), NO_WINDOW if window is None else int(window),
             int(sinks), q_ids, kv_ids, int(q.dtype == torch.bfloat16),
             tile_code(q.dtype, tile_dtype),
             torch.cuda.current_stream(q.device).cuda_stream), held)


def _stat(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"lse/di must be fp32; got {x.dtype}")
    return x.contiguous()


def fa2_backward_fused_aligned(q, k, v, o, do, lse, *, causal: bool,
                               sm_scale: float, kv_len: int, tile_dtype=None,
                               window=None, sinks: int = 0, q_seg=None,
                               kv_seg=None):
    """B2: (dQ like q, dK like k, dV like v) in one recompute, D_i folded in
    from O and dO."""
    mask_kw = dict(window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return fa2_backward_fused_plain(q, k, v, o, do, lse, causal=causal,
                                        sm_scale=sm_scale, kv_len=kv_len,
                                        tile_dtype=tile_dtype, **mask_kw)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_fused: unsupported device {q.device}")
    do = do.contiguous()
    lse = _stat(lse)
    _check("fa2_backward_fused", q, k, v, tile_dtype, (do, o), (lse,))
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    n_slices = -(-skv // fused_kv_tile(q.dtype, tile_dtype, d))
    dq_part = torch.empty((b, hq, n_slices, sq, d), device=q.device,
                          dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq = torch.empty_like(q)
    ints, tail, held = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype,
                                    **mask_kw)
    causal_i, window_i, sinks_i, _, _, in_bf16, tiles, stream = tail
    lib = _lib(d)
    # Q_s, D_i and lse * log2(e) (and dO, K, V in the tile type where the
    # inputs are not in it), formed once by the kernel's prologue.
    workspace = _workspace(lib, q, k, in_bf16, tiles)
    err = lib.cfa_fa2_backward_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(),
        *ints, *tail[:7], workspace.data_ptr(), stream)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_fused")
    # The slices of each row's walk add in KV-tile order (no atomics), then
    # the unscaled sum takes sm_scale and q's dtype, as the JAX wrapper does.
    err = lib.cfa_fa2_backward_dq_reduce(
        dq_part.data_ptr(), dq.data_ptr(), b, hq, sq, skv, d, kv_len, causal_i,
        window_i, sinks_i, sm_scale, in_bf16, tiles, stream)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_fused")
    launches.count("fa2_backward_fused", window, held, head_dim=d)
    return dq, dk, dv


def fa2_backward_dq_aligned(q, k, v, do, lse, di, *, causal: bool,
                            sm_scale: float, kv_len: int, tile_dtype=None,
                            window=None, sinks: int = 0, q_seg=None,
                            kv_seg=None):
    """B3: dQ like q, from lse and the precomputed D_i = rowsum(dO * O)."""
    mask_kw = dict(window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return fa2_backward_dq_plain(q, k, v, do, lse, di, causal=causal,
                                     sm_scale=sm_scale, kv_len=kv_len,
                                     tile_dtype=tile_dtype, **mask_kw)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_dq: unsupported device {q.device}")
    do = do.contiguous()
    lse, di = _stat(lse), _stat(di)
    _check("fa2_backward_dq", q, k, v, tile_dtype, (do,), (lse, di))
    dq = torch.empty_like(q)
    ints, tail, held = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype,
                                    **mask_kw)
    lib = _lib(q.shape[3])
    workspace = _workspace(lib, q, k, tail[5], tail[6])
    err = lib.cfa_fa2_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *ints, sm_scale,
        *tail[:7], workspace.data_ptr(), tail[7])
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_dq")
    launches.count("fa2_backward_dq", window, held, head_dim=q.shape[3])
    return dq


def fa2_backward_dkv_aligned(q, k, v, do, lse, di, *, causal: bool,
                             sm_scale: float, kv_len: int, tile_dtype=None,
                             window=None, sinks: int = 0, q_seg=None,
                             kv_seg=None):
    """B4: (dK like k, dV like v); the GQA group's query heads are summed
    inside the kernel before one store."""
    mask_kw = dict(window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return fa2_backward_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                      sm_scale=sm_scale, kv_len=kv_len,
                                      tile_dtype=tile_dtype, **mask_kw)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward_dkv: unsupported device {q.device}")
    do = do.contiguous()
    lse, di = _stat(lse), _stat(di)
    _check("fa2_backward_dkv", q, k, v, tile_dtype, (do,), (lse, di))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ints, tail, held = _common_args(q, k, kv_len, sm_scale, causal, tile_dtype,
                                    **mask_kw)
    lib = _lib(q.shape[3])
    workspace = _workspace(lib, q, k, tail[5], tail[6])
    err = lib.cfa_fa2_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ints,
        *tail[:7], workspace.data_ptr(), tail[7])
    _build.check(lib, "cfa_fa2_backward_error_string", err, "fa2_backward_dkv")
    launches.count("fa2_backward_dkv", window, held, head_dim=q.shape[3])
    return dk, dv


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def _p_ds(q, k, v, do, lse, di, *, causal, sm_scale, kv_len, tile_dtype,
          window=None, sinks=0, q_seg=None, kv_seg=None):
    """P and the unscaled dS over whole rows, with the TPU kernel's rounding
    points (fa2_backward.py::_compute_p_ds): Q is scaled by sm_scale*log2(e)
    in fp32 and rounded to the tile type, K, V and dO are cast to it, S and
    dO V^T accumulate in fp32, P = exp2(S - lse*log2(e)) is exactly 0 where
    masked (the kv_len tail, the causal triangle, the window and its sinks,
    other segments: common.build_element_mask), dS = P * (dO V^T - D_i) in
    fp32, and P and dS are rounded to the tile type before their products.
    The tile type is `tile_dtype`, else q's dtype.  K and V are expanded to
    the query heads (GQA).

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
                              kv_len=kv_len, device=q.device, window=window,
                              sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
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


def fused_prologue_plain(q, k, v, o, do, lse, *, sm_scale: float,
                         tile_dtype, di=None):
    """The prologue of B2, B3 and B4 (tile_dtype bf16, fp16, or fp32 for
    the FMA bodies): (Q_s, dO, K, V in the tile type, lse * log2(e), D_i).
    Q_s is Q times the fp32 value of sm_scale * log2(e), in fp32, rounded
    to the tile type; dO, K and V are rounded to it; D_i = rowsum(dO * O)
    in fp32 (B2), or, without O (o None, B3 and B4), the caller's `di` as
    it is.  These are the roundings that `_p_ds` applies, so the kernel's
    prologue moves none of them."""
    qscale = torch.tensor(sm_scale * LOG2E, dtype=torch.float32)
    q_s = (q.float() * qscale).to(tile_dtype)
    if o is not None:
        di = (do.float() * o.float()).sum(dim=-1)
    return (q_s, do.to(tile_dtype), k.to(tile_dtype), v.to(tile_dtype),
            lse.float() * LOG2E, di)


def fa2_backward_fused_plain(q, k, v, o, do, lse, *, causal: bool,
                             sm_scale: float, kv_len: int, tile_dtype=None,
                             **mask_kw):
    """B2's function: D_i = rowsum(dO * O) in fp32, then dQ, dK, dV.
    `mask_kw`: window, sinks, q_seg, kv_seg as `_p_ds` takes them."""
    di = (do.float() * o.float()).sum(dim=-1)
    p, ds, qs, ks, dos = _p_ds(q, k, v, do, lse, di, causal=causal,
                               sm_scale=sm_scale, kv_len=kv_len,
                               tile_dtype=tile_dtype, **mask_kw)
    dq = ((ds @ ks) * sm_scale).to(q.dtype)
    return (dq, *_dkv(p, ds, qs, dos, k))


def fa2_backward_dq_plain(q, k, v, do, lse, di, *, causal: bool,
                          sm_scale: float, kv_len: int, tile_dtype=None,
                          **mask_kw):
    """B3's function: dQ = sm_scale * (dS K)."""
    _, ds, _, ks, _ = _p_ds(q, k, v, do, lse, di, causal=causal,
                            sm_scale=sm_scale, kv_len=kv_len,
                            tile_dtype=tile_dtype, **mask_kw)
    return ((ds @ ks) * sm_scale).to(q.dtype)


def fa2_backward_dkv_plain(q, k, v, do, lse, di, *, causal: bool,
                           sm_scale: float, kv_len: int, tile_dtype=None,
                           **mask_kw):
    """B4's function: dV = P^T dO and dK = ln2 * (dS^T Q_s), each summed
    over the GQA group."""
    p, ds, qs, _, dos = _p_ds(q, k, v, do, lse, di, causal=causal,
                              sm_scale=sm_scale, kv_len=kv_len,
                              tile_dtype=tile_dtype, **mask_kw)
    return _dkv(p, ds, qs, dos, k)
