"""Shared kernel-layer constants and helpers (padding, masking).

Counterpart of cuda_flash_attention_tpu/kernels/common.py, copied rather
than imported: the port never imports the JAX package."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

MIN_BLOCK = 128
# exp2-domain softmax constants: exp(x) = exp2(x * LOG2E).
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# A large finite negative instead of -inf keeps the online softmax NaN-free
# on rows that are masked so far.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Tile types of the attention kernels (None computes in the input's type).
# fp16 tiles are real fp16 on the card: above 65504 they overflow and P
# below 2^-14 is subnormal, where the JAX package's fp16 emulation (a
# 10-bit mantissa in fp32) does neither; in fp16's normal range they agree.
TILE_DTYPES = (None, torch.bfloat16, torch.float16)
# Input types of the attention kernels and their code in the C entry
# points' in_type argument (0 and 1 read as the in_bf16 flag they replace).
# O and the gradients come out in q's type; lse and the statistics stay
# fp32.  fp16 inputs run from a library of their own (kernel_library).
INPUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_IN_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def in_type(dtype: torch.dtype) -> int:
    """The C entry points' in_type code of an input dtype."""
    return _IN_TYPE[dtype]
# Head dims the CUDA kernels take; the plain versions take any.  Every
# kernel (B1-B10) takes all four of the registry's (FORWARD_HEAD_DIMS).
# KERNEL_HEAD_DIMS are those built into each source's own library; D 32 and
# 256 are each a library of their own (kernel_library).
FORWARD_HEAD_DIMS = (32, 64, 128, 256)
KERNEL_HEAD_DIMS = (64, 128)


def head_dim_error(name: str, head_dim: int):
    """What a wrapper raises on a CUDA tensor whose head dim no kernel
    takes (no plain-version fallback)."""
    return NotImplementedError(
        f"{name} kernel: head_dim {head_dim} not in {FORWARD_HEAD_DIMS}")


def kernel_library(name: str, head_dim: int, in_dtype=None) -> str:
    """The library of csrc/<name>.cu that holds head dim `head_dim`: D 64
    and 128 in <name> itself, D 32 and 256 each in <name>_d32 / <name>_d256
    (csrc/<name>_d<D>.cu, the same source built at that width alone, so
    that nvcc compiles the widths in parallel).  fp16 inputs (`in_dtype`)
    at every head dim in <name>_fp16in (csrc/<name>_fp16in.cu).  No library
    holds a head dim outside FORWARD_HEAD_DIMS: that raises
    head_dim_error."""
    if head_dim not in FORWARD_HEAD_DIMS:
        raise head_dim_error(name, head_dim)
    if in_dtype == torch.float16:
        return f"{name}_fp16in"
    return name if head_dim in KERNEL_HEAD_DIMS else f"{name}_d{head_dim}"


def tile_code(in_dtype: torch.dtype, tile_dtype) -> int:
    """The kernels' tile argument: 0 fp32 on the FMA units, 1 bf16 or 2
    fp16 on the tensor cores (the tile type is tile_dtype, else the input
    type)."""
    eff = in_dtype if tile_dtype is None else tile_dtype
    return {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[eff]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """The JAX API's block configuration (multiples of 128 along sequence
    dims), with its defaults and `default(causal, window)`.

    In the port it only picks the backward route: the JAX rule counts KV
    slices of `block_k_dkv` rows (kernels/attention.py `_use_fused_bwd`).
    The CUDA kernels keep their own tiles (csrc/*.cu), which suit the H100's
    shared memory and registers, not these TPU-swept sizes."""

    block_q: int = 2048
    block_k: int = 2048
    block_q_dkv: int = 512
    block_k_dkv: int = 2048
    block_q_dq: int = 512
    block_k_dq: int = 2048

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v % MIN_BLOCK != 0:
                raise ValueError(f"{f.name}={v} must be a multiple of {MIN_BLOCK}")

    @classmethod
    def default(cls, causal: bool = False,
                window: int | None = None) -> "BlockSizes":
        if window is not None:
            # The JAX rule (swept on the TPU for its compact window grids):
            # square blocks of the window's power of two, 128 to 1024.
            b = max(MIN_BLOCK, min(1024, _next_pow2_at_most(window)))
            return cls(block_q=b, block_k=b, block_q_dkv=b, block_k_dkv=b,
                       block_q_dq=b, block_k_dq=b)
        if causal:
            return cls(block_q=2048, block_k=2048, block_k_dkv=1024)
        return cls()


def _next_pow2_at_most(n: int) -> int:
    """Largest power of two <= n (1 for n < 2)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def fit_block(requested: int, padded_len: int) -> int:
    """Largest multiple of MIN_BLOCK that divides padded_len and is <=
    requested; sub-128 padded lengths use one whole-sequence block."""
    if padded_len < MIN_BLOCK:
        return padded_len
    best = MIN_BLOCK
    b = MIN_BLOCK
    while b <= min(requested, padded_len):
        if padded_len % b == 0:
            best = b
        b += MIN_BLOCK
    return best


def seq_pad_quantum(seq_len: int, dtype: torch.dtype) -> int:
    """Padding quantum for a sequence axis: the 128 block grid for sequences
    of at least one block, else the dtype's sublane tile (8/16/32 rows for
    4/2/1-byte types)."""
    if seq_len >= MIN_BLOCK:
        return MIN_BLOCK
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {4: 8, 2: 16, 1: 32}.get(itemsize, MIN_BLOCK)


def pad_to_block(x: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """Zero-pad `axis` of x up to a multiple of `block`."""
    size = x.shape[axis]
    padded = round_up(size, block)
    if padded == size:
        return x
    pads = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards.
    pads[2 * (x.ndim - 1 - axis) + 1] = padded - size
    return F.pad(x, pads)


def is_packed_int4(x: torch.Tensor, head_dim: int) -> bool:
    """Whether x holds packed int4 K/V: int8 of width head_dim // 2."""
    return x.dtype == torch.int8 and x.shape[-1] * 2 == head_dim


def kv_storage_cast(x: torch.Tensor, head_dim: int,
                    compute_dtype: torch.dtype) -> torch.Tensor:
    """A stored K/V tile in the compute type: int4 split-half pages (width
    head_dim // 2; byte j holds element j in the low nibble and element
    j + head_dim // 2 in the high one, both sign-extended) are unpacked
    first; every other storage type converts directly.

    The JAX twin (kernels/common.py:407-483) widens fp8 by integer bit
    surgery because the v5e has no fp8 convert; torch's and the card's
    native conversions are exact on every fp8 code, so none is needed."""
    if is_packed_int4(x, head_dim):
        lo = ((x & 0xF) ^ 8) - 8   # the low nibble, sign-extended
        hi = x >> 4                # arithmetic shift keeps the sign
        x = torch.cat([lo, hi], dim=-1)
    return x.to(compute_dtype)


# The kernels' "no window" (csrc: a key distance no row reaches): a window
# of None is passed as this, so the window clause of the mask never fires
# and every walk starts at column 0.
NO_WINDOW = 1 << 30


def build_element_mask(q_len: int, kv_len_pad: int, *, causal: bool,
                       kv_len: int, device, window: int | None = None,
                       sinks: int = 0, q_seg: torch.Tensor | None = None,
                       kv_seg: torch.Tensor | None = None
                       ) -> torch.Tensor | None:
    """Boolean keep-mask over a whole (padded) problem, or None when nothing
    masks: the ragged-KV tail (col < kv_len), the causal triangle (col <=
    row), the sliding window (row - col < window, or col < sinks: the
    attention sinks) and, with segment ids (q_seg [B, >= q_len], kv_seg
    [B, >= kv_len_pad] int), segment equality (q_seg[b, row] ==
    kv_seg[b, col]), and-ed together.  [q_len, kv_len_pad], or [B, 1,
    q_len, kv_len_pad] with segments.  The plain versions' form of the JAX
    build_block_mask."""
    mask = None
    cols = torch.arange(kv_len_pad, device=device)[None, :]
    if kv_len != kv_len_pad:
        mask = cols < kv_len
    rows = torch.arange(q_len, device=device)[:, None]
    if causal:
        tri = cols <= rows
        mask = tri if mask is None else mask & tri
    if window is not None:
        win = (rows - cols < window) | (cols < sinks)
        mask = win if mask is None else mask & win
    if q_seg is not None:
        seg = (q_seg[:, :q_len, None].to(device)
               == kv_seg[:, None, :kv_len_pad].to(device))[:, None]
        mask = seg if mask is None else mask & seg
    return mask


def pack_segments(q_segment_ids, kv_segment_ids, sq_pad: int, skv_pad: int):
    """Segment ids [B, Sq] and [B, Skv] padded to (q_seg [B, sq_pad],
    kv_seg [B, skv_pad]) int32, or None without ids (JAX attention.py
    _pack_segments).  The pad value is irrelevant: padded KV columns are
    masked by the kv_len tail whatever their segment, padded Q rows'
    outputs are sliced off, and their gradient contributions vanish
    because dO is zero-padded."""
    if q_segment_ids is None:
        return None
    q_seg = F.pad(q_segment_ids.to(torch.int32),
                  (0, sq_pad - q_segment_ids.shape[1]))
    kv_seg = F.pad(kv_segment_ids.to(torch.int32),
                   (0, skv_pad - kv_segment_ids.shape[1]))
    return q_seg.contiguous(), kv_seg.contiguous()


def window_tiles(first_col: int, end_col: int, sinks: int, tile: int):
    """The KV tiles of `tile` columns that a row range walks under a window
    with sinks: the sink tiles [0, cdiv(sinks, tile)), then the tiles from
    the one holding `first_col` (the oldest column the first row keeps) to
    the one holding column end_col - 1; a tile in both ranges once.
    Returns (n_sink, lo, n): walk step i < n_sink is tile i, the others
    lo + i - n_sink.  csrc/hopper.cuh KvWalk is the kernels' twin."""
    n_end = cdiv(max(end_col, 0), tile)
    n_sink = min(cdiv(sinks, tile), n_end)
    lo = max(n_sink, max(0, first_col) // tile)
    return n_sink, lo, n_sink + max(0, n_end - lo)


def window_q_tiles(k0: int, kv_rows: int, n_q: int, q_tile: int, *,
                   causal: bool, window: int | None, sinks: int,
                   kv_len: int) -> range:
    """The Q tiles (of `q_tile` rows, n_q of them) that the KV tile of rows
    [k0, k0 + kv_rows) meets with a kept pair: under causal from the tile
    holding row k0; a tile holding a sink column (k0 < sinks) to the end;
    else to the one holding row k0 + kv_rows - 1 + window - 1 (the last row
    whose window reaches the tile), none where that row is negative (a
    band); none for a KV tile past kv_len.  csrc/hopper.cuh QWalk is the
    kernels' twin (the transpose of window_tiles)."""
    if k0 >= kv_len:
        return range(0)
    lo = min(k0 // q_tile, n_q) if causal else 0
    hi = n_q
    if window is not None and k0 >= sinks:
        last = k0 + kv_rows + window - 2
        hi = min(n_q, last // q_tile + 1) if last >= 0 else 0
    return range(lo, max(lo, hi))


def reference_tiles(sq_pad: int, skv_pad: int, causal: bool, window,
                    block_sizes: "BlockSizes | None" = None) -> tuple[int, int]:
    """(block_q, block_k) of the JAX forward for this call: its BlockSizes
    (default(causal, window) unless given) fitted to the padded lengths.
    They decide which rows' lse is -inf (dead_row_lse); the port's kernels
    keep their own tiles."""
    bs = block_sizes or BlockSizes.default(causal, window=window)
    return fit_block(bs.block_q, sq_pad), fit_block(bs.block_k, skv_pad)


def dead_row_lse(q_len: int, skv_pad: int, *, causal: bool, window, sinks: int,
                 block_q: int, block_k: int, device,
                 single_tile_body: bool = True) -> torch.Tensor:
    """The lse of each row [q_len] were it to keep no key (its O is 0), as
    the JAX forward gives it on its own tiles (block_q x block_k, from
    `reference_tiles`): -inf where the row's Q tile walks no KV tile at all (a KV
    of several tiles), else the mask value times ln 2 (a tile was
    visited, every score masked).  A tile is walked when it holds a column
    at or below the Q tile's last row (causal) and, under a window, one
    that the Q tile's first row keeps or a sink.  The kernels apply the
    same rule to their dead rows (csrc/fa2_forward.cu DeadRows).  The JAX
    forward walks a KV of one tile in a body of its own that always runs
    (single_tile_body); its quantized forward has no such body, so there a
    Q tile that walks no tile is -inf whatever the KV's length
    (csrc/fa2_forward_quant.cu QuantDead)."""
    out = torch.full((q_len,), DEFAULT_MASK_VALUE, dtype=torch.float32,
                     device=device) * LN2
    if (single_tile_body and skv_pad // block_k <= 1) or window is None:
        return out
    for q0 in range(0, q_len, block_q):
        end = min(skv_pad, q0 + block_q) if causal else skv_pad
        if window_tiles(q0 - window + 1, end, sinks, block_k)[2] == 0:
            out[q0:q0 + block_q] = float("-inf")
    return out
