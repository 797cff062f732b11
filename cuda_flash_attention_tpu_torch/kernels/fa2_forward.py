"""FlashAttention-2 forward: kernels B1 and B8 and their plain PyTorch
versions.

  B1 fa2_forward_aligned        replaces cuda_flash_attention_tpu/kernels/
                                fa2_forward.py::fa2_forward_aligned
                                (csrc/fa2_forward.cu)
  B8 fa2_forward_small_aligned  replaces ...::fa2_forward_small_aligned, the
                                route for Sq = Skv <= 128 with Hq = Hkv
                                (csrc/fa2_forward_small.cu)
Each source note says what bounds its kernel on the H100 and how the design
answers that.  On a CPU tensor a wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises.  Both take a sliding window (or,
non-causal, a recency band whose offset may be <= 0), attention sinks and
segment ids (q_seg [B, Sq_pad], kv_seg [B, Skv_pad] int32, as
common.pack_segments pads them: a row keeps only the keys of its own
segment); a windowed launch also counts under `<name>_window`, a
segmented one under `<name>_segments`.  A row that keeps no key gives O =
0 and the lse of the JAX forward's tile walk (common.dead_row_lse, on the
tiles `lse_tiles`, by default those of BlockSizes.default).  Both take head
dims 32, 64, 128 and 256 (D 32 and 256 each from a library of their own,
common.kernel_library); a launch there also counts under `<name>_d32` or
`<name>_d256`.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    FORWARD_HEAD_DIMS,
    LN2,
    LOG2E,
    MIN_BLOCK,
    NO_WINDOW,
    TILE_DTYPES,
    build_element_mask,
    dead_row_lse,
    head_dim_error,
    kernel_library,
    reference_tiles,
    round_up,
    tile_code,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library("fa2_forward", head_dim))
    fn = lib.cfa_fa2_forward
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 7 + [_F] + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def _small_lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library("fa2_forward_small", head_dim))
    fn = lib.cfa_fa2_forward_small
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 5 + [_F] + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def seg_args(q_seg, kv_seg, b: int, sq: int, skv: int):
    """The kernels' segment-id pointers (0, 0 without ids): q_seg and
    kv_seg as int32 [B, round_up(S, 128)] on the card (rows past the ids
    padded; their value is irrelevant), and the tensors that hold them."""
    if q_seg is None:
        return (None, 0, 0)
    held = tuple(
        torch.nn.functional.pad(ids.to(torch.int32),
                                (0, round_up(n, MIN_BLOCK) - ids.shape[1])).contiguous()
        for ids, n in ((q_seg, sq), (kv_seg, skv)))
    for ids, n in zip(held, (sq, skv)):
        if ids.shape != (b, round_up(n, MIN_BLOCK)):
            raise ValueError(f"segment ids must be [batch, seq]; got {tuple(ids.shape)}")
    return (held, held[0].data_ptr(), held[1].data_ptr())


def _check_inputs(name, q, k, v, tile_dtype):
    """What both kernels take (every head dim of FORWARD_HEAD_DIMS);
    raises on anything else."""
    if q.dtype not in (torch.float32, torch.bfloat16) or tile_dtype not in TILE_DTYPES:
        raise NotImplementedError(
            f"{name} kernel: inputs fp32/bf16 and tiles None/bf16/fp16; got "
            f"{q.dtype} with tile_dtype {tile_dtype}"
        )
    if q.shape[3] not in FORWARD_HEAD_DIMS:
        raise head_dim_error(name, q.shape[3])
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} kernel: q/k/v must be contiguous, on one "
                             "device, of one dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: inputs must be 16-byte aligned")


def fa2_forward_aligned(q, k, v, *, causal: bool, sm_scale: float,
                        kv_len: int, tile_dtype=None, window=None,
                        sinks: int = 0, q_seg=None, kv_seg=None,
                        lse_tiles=None):
    """FA2 forward over sequence-padded q [B, Hq, Sq, D] and k/v
    [B, Hkv, Skv, D] (Hq a multiple of Hkv; query head h reads KV head
    h // (Hq // Hkv)).  Keys at or past `kv_len` are masked, with a
    window those a row keeps neither by distance (row - col < window) nor
    as a sink (col < sinks), and with segment ids those of another
    segment.  Returns (O like q, lse [B, Hq, Sq] fp32, natural log; a row
    with no key: kernels/common.py dead_row_lse on `lse_tiles`)."""
    if lse_tiles is None:
        lse_tiles = reference_tiles(q.shape[2], k.shape[2], causal, window)
    if q.device.type == "cpu":
        return fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                 kv_len=kv_len, tile_dtype=tile_dtype,
                                 window=window, sinks=sinks, q_seg=q_seg,
                                 kv_seg=kv_seg, lse_tiles=lse_tiles)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_forward: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check_inputs("fa2_forward", q, k, v, tile_dtype)
    if b * hq > 65535:
        raise NotImplementedError("fa2_forward kernel: batch * heads > 65535")
    if tile_dtype not in (None, q.dtype):
        # TMA copies K and V as bytes, so they reach it in the 16-bit tile
        # type.  The cast rounds to nearest even, as the plain version's
        # k.to(tile) does: no rounding point moves.
        k, v = k.to(tile_dtype), v.to(tile_dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    held, q_ids, kv_ids = seg_args(q_seg, kv_seg, b, sq, skv)
    lib = _lib(d)
    err = lib.cfa_fa2_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        q_ids, kv_ids, b, hq, hkv, sq, skv, d, kv_len, sm_scale * LOG2E,
        int(causal), NO_WINDOW if window is None else int(window), int(sinks),
        *lse_tiles, int(q.dtype == torch.bfloat16), tile_code(q.dtype, tile_dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_fa2_forward_error_string", err, "fa2_forward")
    launches.count("fa2_forward", window, held, d)
    return o, lse


def fa2_forward_small_aligned(q, k, v, *, causal: bool, sm_scale: float,
                              kv_len: int, tile_dtype=None, window=None,
                              sinks: int = 0, q_seg=None, kv_seg=None):
    """B8: FA2 forward over padded q/k/v [B, H, S_pad, D] with S_pad <= 128
    and one KV head per query head, every (batch, head) pair one slot that
    sees only its own keys.  Keys at or past `kv_len` are masked.  Returns
    (O like q, lse [B, H, S_pad] fp32, natural log).  Its function is B1's
    at these shapes, window, sinks and segment ids included; the kernel
    takes the whole row in one tile (so a dead row's lse is the mask value
    times ln 2)."""
    b, h, s_pad, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or s_pad > MIN_BLOCK:
        raise ValueError(
            f"fa2_forward_small: q/k/v must share one [B, H, S <= {MIN_BLOCK}, "
            f"D] shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return fa2_forward_small_plain(q, k, v, causal=causal,
                                       sm_scale=sm_scale, kv_len=kv_len,
                                       tile_dtype=tile_dtype, window=window,
                                       sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_forward_small: unsupported device {q.device}")
    _check_inputs("fa2_forward_small", q, k, v, tile_dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_pad), device=q.device, dtype=torch.float32)
    held, q_ids, kv_ids = seg_args(q_seg, kv_seg, b, s_pad, s_pad)
    lib = _small_lib(d)
    err = lib.cfa_fa2_forward_small(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        q_ids, kv_ids, b * h, h, s_pad, d, kv_len, sm_scale * LOG2E, int(causal),
        NO_WINDOW if window is None else int(window), int(sinks),
        int(q.dtype == torch.bfloat16), tile_code(q.dtype, tile_dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_fa2_forward_small_error_string", err,
                 "fa2_forward_small")
    launches.count("fa2_forward_small", window, held, d)
    return o, lse


def fa2_forward_small_plain(q, k, v, *, causal: bool, sm_scale: float,
                            kv_len: int, tile_dtype=None, window=None,
                            sinks: int = 0, q_seg=None, kv_seg=None):
    """B8's function in plain PyTorch: one exact softmax over each slot's
    whole row, with B1's rounding points (fa2_forward_plain, which takes
    the whole row at once too; at S <= 128 a dead row's lse is the mask
    value's, as B8's one tile gives it)."""
    return fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                             kv_len=kv_len, tile_dtype=tile_dtype,
                             window=window, sinks=sinks, q_seg=q_seg,
                             kv_seg=kv_seg)


def fa2_forward_plain(q, k, v, *, causal: bool, sm_scale: float,
                      kv_len: int, tile_dtype=None, window=None,
                      sinks: int = 0, q_seg=None, kv_seg=None,
                      lse_tiles=None):
    """The kernel's function in plain PyTorch, with the TPU kernel's rounding
    points: Q is scaled by sm_scale*log2(e) in fp32 and then rounded to the
    tile type; K and V are cast to it; S and the softmax are fp32 (exp2
    domain, masked scores at DEFAULT_MASK_VALUE, masked P exactly 0); P is
    rounded to the tile type before the PV product; O = PV / l with l == 0
    guarded; lse = m*ln2 + log(l).  The tile type is `tile_dtype`, else q's
    dtype.

    It takes the whole row at once rather than tile by tile, and it does not
    reproduce two bf16 details of the TPU kernel, so parity at bf16 is a
    tolerance, not bits (and fp16 tiles here are real fp16, see
    common.TILE_DTYPES):
      * the bf16 exp2 chain the TPU kernel uses for score tiles of at least
        2^18 elements (fa2_forward.py:84, 221);
      * the bf16-rounded rowsum that V-augmentation gives at D < 128
        (fa2_forward.py:66-75, 228-229): here l sums the fp32 P.
    """
    eff = tile_dtype if tile_dtype is not None else q.dtype
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    qs = (q.float() * (sm_scale * LOG2E)).to(eff).float()
    ks = k.to(eff).float()
    vs = v.to(eff).float()
    s = qs @ ks.transpose(-1, -2)
    mask = build_element_mask(q.shape[2], k.shape[2], causal=causal,
                              kv_len=kv_len, device=q.device, window=window,
                              sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    if mask is not None:
        s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(eff).float() @ vs
    o = pv * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = m * LN2 + torch.log(torch.where(l == 0.0, 1.0, l))
    if window is not None or q_seg is not None:
        # A row with no key: the lse of the JAX forward's tile walk.
        bq, bk = lse_tiles or reference_tiles(q.shape[2], k.shape[2], causal,
                                              window)
        dead = dead_row_lse(q.shape[2], k.shape[2], causal=causal,
                            window=window, sinks=sinks, block_q=bq,
                            block_k=bk, device=q.device)[:, None]
        lse = torch.where(l == 0.0, dead, lse)
    return o.to(q.dtype), lse[..., 0]
