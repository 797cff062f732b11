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


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """The JAX API's block configuration (multiples of 128 along sequence
    dims), with its defaults and `default(causal, window)`; a window raises
    until sliding windows are ported.

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
            raise NotImplementedError("sliding-window attention is not ported yet")
        if causal:
            return cls(block_q=2048, block_k=2048, block_k_dkv=1024)
        return cls()


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


def build_element_mask(q_len: int, kv_len_pad: int, *, causal: bool,
                       kv_len: int, device) -> torch.Tensor | None:
    """Boolean keep-mask [q_len, kv_len_pad] over a whole (padded) problem,
    or None when nothing masks: the ragged-KV tail (col < kv_len) and the
    causal triangle (col <= row).  The plain versions' form of
    build_block_mask; windows and segments are not ported yet."""
    mask = None
    cols = torch.arange(kv_len_pad, device=device)[None, :]
    if kv_len != kv_len_pad:
        mask = cols < kv_len
    if causal:
        rows = torch.arange(q_len, device=device)[:, None]
        tri = cols <= rows
        mask = tri if mask is None else mask & tri
    return mask
