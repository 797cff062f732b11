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
# Head dims the CUDA attention kernels take; the plain versions take any.
KERNEL_HEAD_DIMS = (64, 128)


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
                       sinks: int = 0) -> torch.Tensor | None:
    """Boolean keep-mask [q_len, kv_len_pad] over a whole (padded) problem,
    or None when nothing masks: the ragged-KV tail (col < kv_len), the
    causal triangle (col <= row) and the sliding window (row - col <
    window, or col < sinks: the attention sinks), and-ed together.  The
    plain versions' form of the JAX build_block_mask; segments are not
    ported yet."""
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
    return mask


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


def dead_row_lse(q_len: int, kv_len: int, *, causal: bool, window, sinks: int,
                 device) -> torch.Tensor:
    """The lse of each row [q_len] were it to keep no key (its O is 0), as
    the JAX forward gives it on its 128-row tiles: -inf where the row's
    128-row Q tile walks no 128-key tile at all (a KV of several tiles), else
    the mask value times ln 2 (the tile was visited, every score masked).
    The kernels apply the same rule to their dead rows."""
    out = torch.full((q_len,), DEFAULT_MASK_VALUE, dtype=torch.float32,
                     device=device) * LN2
    if kv_len <= MIN_BLOCK or window is None:
        return out
    for q0 in range(0, q_len, MIN_BLOCK):
        end = min(kv_len, q0 + MIN_BLOCK) if causal else kv_len
        if window_tiles(q0 - window + 1, end, sinks, MIN_BLOCK)[2] == 0:
            out[q0:q0 + MIN_BLOCK] = float("-inf")
    return out
