"""FA2 forward over quantized K/V: kernel B7, its plain PyTorch version and
the public quantized-KV API.

  B7 fa2_forward_quant_aligned  replaces cuda_flash_attention_tpu/kernels/
                                fa2_forward_quant.py::fa2_forward_quant_aligned
                                (csrc/fa2_forward_quant.cu)

K and V are int8, fp8 (e4m3 / e5m2) or packed int4 (split-half, width D/2)
with one fp32 scale per (batch, head, position) row; the kernel folds the K
scale into S's columns and the V scale into P, never building a dequantized
tile.  Scales are [B, Hkv, S] contiguous here: the JAX [B, H, 1, S]
lane-major layout is a TPU layout.  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.  It takes
a sliding window (or, non-causal, a recency band whose offset may be <= 0)
and segment ids (q_seg [B, Sq_pad], kv_seg [B, Skv_pad] int32), as the JAX
kernel does, and no attention sinks, which the JAX kernel has none of; a
windowed launch also counts under `fa2_forward_quant_window`, a segmented
one under `fa2_forward_quant_segments`.  A row that keeps no key gives O =
0 and the lse of the JAX kernel's tile walk (common.dead_row_lse with
single_tile_body=False, on the tiles `lse_tiles`: the call's block_q and
block_k fitted to the padded lengths).  Head dims 32, 64, 128 and 256 (D 32
and 256 each from a library of their own, common.kernel_library; a launch
there also counts under `fa2_forward_quant_d32` or `_d256`).
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.attention import (
    _normalize_window,
    _validate_segments,
)
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    FORWARD_HEAD_DIMS,
    LN2,
    LOG2E,
    MIN_BLOCK,
    NO_WINDOW,
    build_element_mask,
    dead_row_lse,
    fit_block,
    head_dim_error,
    is_packed_int4,
    kernel_library,
    kv_storage_cast,
    pack_segments,
    pad_to_block,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import seg_args
from cuda_flash_attention_tpu_torch.quant.qtensor import (
    QuantizedTensor,
    quantize_kv,
)

__all__ = ["flash_attention_quantized_kv", "flash_attention_quantized_kv_with_lse",
           "flash_attention_int8_kv", "fa2_forward_quant_aligned",
           "fa2_forward_quant_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# B7's C entry point (csrc/fa2_forward_quant.cu cfa_fa2_forward_quant).
ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float] + [_I] * 7 + [_P]
# The JAX API's default tiles, which set a dead row's lse.
_BLOCK_Q, _BLOCK_K = 512, 1024
_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
# The kernel's storage codes (int4 is int8 storage of width D/2).
_STORAGE = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
# Rows of the plain version's score tile per step: at S 8192 x 16 heads one
# fp32 score tensor of the whole problem would take 4 GiB.
_PLAIN_ROWS = 1024


def _lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library("fa2_forward_quant", head_dim))
    fn = lib.cfa_fa2_forward_quant
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = _I
    return lib


def quant_tiles(sq_pad: int, skv_pad: int, block_q: int = _BLOCK_Q,
                block_k: int = _BLOCK_K) -> tuple[int, int]:
    """The JAX kernel's (block_q, block_k) for this call: the API's blocks
    fitted to the padded lengths.  They set a dead row's lse; the port's
    kernel keeps its own tiles."""
    return fit_block(block_q, sq_pad), fit_block(block_k, skv_pad)


def _storage_code(k_vals, head_dim: int) -> int:
    if is_packed_int4(k_vals, head_dim):
        return 3
    if k_vals.shape[-1] != head_dim or k_vals.dtype not in _STORAGE:
        raise NotImplementedError(
            f"fa2_forward_quant kernel: K/V must be int8, fp8 e4m3/e5m2 of "
            f"width head_dim or packed int4 of width head_dim // 2; got "
            f"{k_vals.dtype} of width {k_vals.shape[-1]} at head_dim {head_dim}")
    return _STORAGE[k_vals.dtype]


def fa2_forward_quant_aligned(q, k_vals, k_scales, v_vals, v_scales, *,
                              causal: bool, sm_scale: float, kv_len: int,
                              compute_dtype=torch.bfloat16, window=None,
                              q_seg=None, kv_seg=None, lse_tiles=None):
    """B7 over sequence-padded q [B, Hq, Sq, D], k/v values [B, Hkv, Skv, D]
    (or [.., D/2] packed int4) and scales [B, Hkv, Skv] fp32 (Hq a multiple
    of Hkv; query head h reads KV head h // (Hq // Hkv)).  Keys at or past
    `kv_len` are masked, with a window those a row keeps not by distance
    (row - col < window), and with segment ids those of another segment.
    Returns (O like q, lse [B, Hq, Sq] fp32, natural log; a row with no key:
    common.dead_row_lse on `lse_tiles`, by default quant_tiles')."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype} is not ported (bf16, fp32 are)")
    if lse_tiles is None:
        lse_tiles = quant_tiles(q.shape[2], k_vals.shape[2])
    if q.device.type == "cpu":
        return fa2_forward_quant_plain(
            q, k_vals, k_scales, v_vals, v_scales, causal=causal,
            sm_scale=sm_scale, kv_len=kv_len, compute_dtype=compute_dtype,
            window=window, q_seg=q_seg, kv_seg=kv_seg, lse_tiles=lse_tiles)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_forward_quant: unsupported device {q.device}")
    out = quant_launch(_lib(q.shape[3]), q, k_vals, k_scales, v_vals, v_scales, causal=causal,
                       sm_scale=sm_scale, kv_len=kv_len, compute_dtype=compute_dtype,
                       window=window, q_seg=q_seg, kv_seg=kv_seg, lse_tiles=lse_tiles)
    launches.count("fa2_forward_quant", window, q_seg, q.shape[3])
    return out


def quant_args(q, k_vals, k_scales, v_vals, v_scales, *, causal: bool,
               sm_scale: float, kv_len: int, compute_dtype, window=None,
               q_seg=None, kv_seg=None, lse_tiles=None):
    """B7's checks and allocations on CUDA tensors: (the C entry point's
    arguments by parameter name, in its order; O; lse; the id tensors the
    pointers hold).  `lse_tiles` defaults to quant_tiles'."""
    b, hq, sq, d = q.shape
    hkv, skv = k_vals.shape[1], k_vals.shape[2]
    storage = _storage_code(k_vals, d)
    if d not in FORWARD_HEAD_DIMS:
        raise head_dim_error("fa2_forward_quant", d)
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or v_vals.dtype != k_vals.dtype or v_vals.shape != k_vals.shape):
        raise NotImplementedError(
            f"fa2_forward_quant kernel: q fp32/bf16, K and V of one type and "
            f"shape; got q {q.dtype} {tuple(q.shape)}, K {k_vals.dtype} "
            f"{tuple(k_vals.shape)}, V {v_vals.dtype} {tuple(v_vals.shape)}")
    if b * hq > 65535:
        raise NotImplementedError("fa2_forward_quant kernel: batch * heads > 65535")
    tensors = (q, k_vals, k_scales, v_vals, v_scales)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fa2_forward_quant kernel: inputs must be contiguous, "
                             "16-byte aligned and on one device")
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or s.shape != (b, hkv, skv):
            raise ValueError(f"fa2_forward_quant kernel: scales must be fp32 "
                             f"[{b}, {hkv}, {skv}]; got {s.dtype} {tuple(s.shape)}")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    held, q_ids, kv_ids = seg_args(q_seg, kv_seg, b, sq, skv)
    dead_bq, dead_bk = lse_tiles or quant_tiles(sq, skv)
    values = dict(
        zip(("q", "k", "k_scales", "v", "v_scales"), (t.data_ptr() for t in tensors)),
        o=o.data_ptr(), lse=lse.data_ptr(), q_seg=q_ids, kv_seg=kv_ids, batch=b,
        hq=hq, hkv=hkv, sq=sq, skv=skv, head_dim=d, kv_len=kv_len,
        qscale=sm_scale * LOG2E, causal=int(causal),
        window=NO_WINDOW if window is None else int(window), dead_bq=dead_bq,
        dead_bk=dead_bk, q_bf16=int(q.dtype == torch.bfloat16), storage=storage,
        bf16_compute=int(compute_dtype == torch.bfloat16),
        stream=torch.cuda.current_stream(q.device).cuda_stream)
    return values, o, lse, held


def quant_launch(lib: ctypes.CDLL, q, k_vals, k_scales, v_vals, v_scales, **kw):
    """One launch of B7 from `lib` (csrc/fa2_forward_quant.cu built) on CUDA
    tensors, after quant_args' checks.  Returns (O, lse)."""
    values, o, lse, _held = quant_args(q, k_vals, k_scales, v_vals, v_scales, **kw)
    err = lib.cfa_fa2_forward_quant(*values.values())
    _build.check(lib, "cfa_fa2_forward_quant_error_string", err,
                 "fa2_forward_quant")
    return o, lse


def fa2_forward_quant_plain(q, k_vals, k_scales, v_vals, v_scales, *,
                            causal: bool, sm_scale: float, kv_len: int,
                            compute_dtype=torch.bfloat16, window=None,
                            q_seg=None, kv_seg=None, lse_tiles=None):
    """B7's function in plain PyTorch, with the TPU kernel's rounding
    points: Q scaled by sm_scale*log2(e) in fp32 and rounded to the compute
    type; K and V decoded to it (kv_storage_cast) with no scale; S fp32,
    times the K scale of its column, masked at DEFAULT_MASK_VALUE (the
    kv_len tail, causal, the window row - col < window, segment ids); exp2
    softmax in fp32 over the whole row; P * v_scale rounded to the compute
    type before P V; O = PV / l with l == 0 guarded, lse = m*ln2 + log(l),
    or for a row with no key the JAX kernel's (dead_row_lse on `lse_tiles`,
    no one-tile body).  Query rows go _PLAIN_ROWS at a time to bound the
    score tile."""
    d = q.shape[-1]
    groups = q.shape[1] // k_vals.shape[1]
    k = kv_storage_cast(k_vals, d, compute_dtype).float()
    v = kv_storage_cast(v_vals, d, compute_dtype).float()
    ks, vs = k_scales.float(), v_scales.float()
    if groups > 1:
        k, v = (t.repeat_interleave(groups, dim=1) for t in (k, v))
        ks, vs = (t.repeat_interleave(groups, dim=1) for t in (ks, vs))
    sq, skv = q.shape[2], k.shape[2]
    mask = build_element_mask(sq, skv, causal=causal, kv_len=kv_len,
                              device=q.device, window=window, q_seg=q_seg,
                              kv_seg=kv_seg)
    if mask is None:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if mask.ndim == 2:
        mask = mask[None, None]
    dead = None
    if window is not None or q_seg is not None:
        bq, bk = lse_tiles or quant_tiles(sq, skv)
        dead = dead_row_lse(sq, skv, causal=causal, window=window, sinks=0,
                            block_q=bq, block_k=bk, device=q.device,
                            single_tile_body=False)
    o_parts, lse_parts = [], []
    for r0 in range(0, sq, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, sq)
        qs = (q[:, :, r0:r1].float() * (sm_scale * LOG2E)).to(compute_dtype).float()
        s = (qs @ k.transpose(-1, -2)) * ks[:, :, None, :]
        keep = mask[:, :, r0:r1]
        s = s + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp2(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        pv = (p * vs[:, :, None, :]).to(compute_dtype).float() @ v
        o_parts.append((pv * torch.where(l == 0.0, 1.0, 1.0 / l)).to(q.dtype))
        lse = m * LN2 + torch.log(torch.where(l == 0.0, 1.0, l))
        if dead is not None:
            lse = torch.where(l == 0.0, dead[r0:r1, None], lse)
        lse_parts.append(lse[..., 0])
    return torch.cat(o_parts, dim=2), torch.cat(lse_parts, dim=2)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _validate_quant_shapes(q, k_q: QuantizedTensor, v_q: QuantizedTensor):
    """The JAX package's checks (fa2_forward_quant.py:306-339), with its
    error types: [B, H, S, D] shapes, K and V alike, batch and head_dim
    agreeing (packed int4 stores head_dim // 2), GQA divisibility and
    per-token scales [B, Hkv, Skv, 1]."""
    if q.ndim != 4 or k_q.values.ndim != 4 or v_q.values.ndim != 4:
        raise ValueError(
            f"q/k/v must be [batch, heads, seq, head_dim]; got {tuple(q.shape)}, "
            f"{tuple(k_q.values.shape)}, {tuple(v_q.values.shape)}"
        )
    if k_q.values.shape != v_q.values.shape:
        raise ValueError(
            f"k/v shape mismatch: {tuple(k_q.values.shape)} vs "
            f"{tuple(v_q.values.shape)}"
        )
    kv_dim = k_q.values.shape[3]
    packed_ok = k_q.bits == 4 and is_packed_int4(k_q.values, q.shape[3])
    if q.shape[0] != k_q.values.shape[0] or (kv_dim != q.shape[3] and not packed_ok):
        raise ValueError(
            f"q and k must agree on batch/head_dim (packed int4 KV stores "
            f"head_dim//2): {tuple(q.shape)} vs {tuple(k_q.values.shape)}"
        )
    if q.shape[1] % k_q.values.shape[1] != 0:
        raise ValueError(
            f"GQA requires query heads ({q.shape[1]}) to be a multiple of "
            f"KV heads ({k_q.values.shape[1]})"
        )
    for name, t in (("k", k_q), ("v", v_q)):
        want = (*t.values.shape[:3], 1)
        if tuple(t.scales.shape) != want:
            raise ValueError(
                f"{name} scales must be per-token {want} (quantize_kv's "
                f"axis=-1 layout); got {tuple(t.scales.shape)}"
            )


def aligned_inputs(q, k_q: QuantizedTensor, v_q: QuantizedTensor):
    """B7's arguments from the API's: (q, k values, k scales [B, Hkv, S],
    v values, v scales), each sequence zero-padded to the 128 block grid as
    the JAX API pads, contiguous."""
    def pad(t):
        return pad_to_block(t, 2, MIN_BLOCK).contiguous()

    return (pad(q), pad(k_q.values), pad(k_q.scales[..., 0].float()),
            pad(v_q.values), pad(v_q.scales[..., 0].float()))


def flash_attention_quantized_kv_with_lse(
        q, k_q: QuantizedTensor, v_q: QuantizedTensor, *, causal: bool = False,
        sm_scale: float | None = None, block_q: int = _BLOCK_Q,
        block_k: int = _BLOCK_K, compute_dtype=torch.bfloat16,
        q_segment_ids=None, kv_segment_ids=None, window: int | None = None):
    """Quantized-KV FA2 forward returning (O, logsumexp [B, H, Sq] fp32).
    q [B, Hq, Sq, D]; k_q/v_q from `quant.quantize_kv` (values [B, Hkv,
    Skv, D], or [.., D/2] for int4; scales [B, Hkv, Skv, 1]).  GQA is
    kernel-native; segment ids [B, Sq] / [B, Skv] and a sliding window (a
    recency band without causal) as the JAX API takes them.  The JAX API's
    block_q/block_k (TPU tile sizes) set only a dead row's lse: the kernel
    keeps its own tiles."""
    _validate_quant_shapes(q, k_q, v_q)
    _validate_segments(q_segment_ids, kv_segment_ids, q, k_q.values)
    window = _normalize_window(window, causal, q.shape[2], k_q.values.shape[2])
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    args = aligned_inputs(q, k_q, v_q)
    sq_pad, skv_pad = args[0].shape[2], args[1].shape[2]
    segs = pack_segments(q_segment_ids, kv_segment_ids, sq_pad, skv_pad)
    q_seg, kv_seg = (None, None) if segs is None else (t.to(q.device) for t in segs)
    with torch.no_grad():
        o, lse = fa2_forward_quant_aligned(
            *args, causal=causal, sm_scale=float(sm_scale),
            kv_len=k_q.values.shape[2], compute_dtype=compute_dtype, window=window,
            q_seg=q_seg, kv_seg=kv_seg,
            lse_tiles=quant_tiles(sq_pad, skv_pad, block_q, block_k))
    return o[:, :, :q.shape[2]], lse[:, :, :q.shape[2]]


def flash_attention_quantized_kv(q, k_q, v_q, **kwargs):
    """FA2 forward over a quantized KV cache (inference; returns O)."""
    o, _ = flash_attention_quantized_kv_with_lse(q, k_q, v_q, **kwargs)
    return o


def flash_attention_int8_kv(q, k, v, **kwargs):
    """Quantize K/V to int8 per token, then attend."""
    k_q, v_q = quantize_kv(k, v, torch.int8)
    return flash_attention_quantized_kv(q, k_q, v_q, **kwargs)
