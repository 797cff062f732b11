"""Paged KV cache: fixed-size pages, host-side page allocator, quantized
storage.

Counterpart of cuda_flash_attention_tpu/decode/kv_cache.py with the same
layout: pages [n_kv_heads, num_pages, page_size, head_dim] of int8, fp8
(e4m3 / e5m2), bf16 or fp32, or packed int4 (the string "int4": int8 pages
of width head_dim // 2, split-half: byte j holds element j in the low
nibble and element j + head_dim // 2 in the high one), with fp32 per-token
scales [n_kv_heads, num_pages, page_size] (all ones for a float cache).  A
page table [max_seqs, pages_per_seq] maps each slot's logical pages to
physical ones; page 0 is the reserved null page.

Unlike the JAX package, whose arrays are immutable, the writers here update
the cache tensors IN PLACE (indexed assignment) and return the same KVPages:
the cache is the largest state of a server and is never copied per token.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.kernels.common import is_packed_int4
from cuda_flash_attention_tpu_torch.quant.qtensor import (
    qmax_for,
    quantize_rows_int4,
)

_FLOAT_CACHE_DTYPES = (torch.float32, torch.bfloat16)
_FP8_CACHE_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
_CACHE_DTYPES = _FLOAT_CACHE_DTYPES + _FP8_CACHE_DTYPES + (torch.int8, "int4")
# The smallest normal value of each fp8 type: the writer flushes below it.
_FP8_MIN_NORMAL = {torch.float8_e4m3fn: 2.0 ** -6, torch.float8_e5m2: 2.0 ** -14}


def _resolve_cache_dtype(dtype, head_dim: int):
    """(storage dtype, stored width, packed) of a cache dtype, "int4"
    included (int8 storage of width head_dim // 2)."""
    if dtype not in _CACHE_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported (int8, int4, fp8 e4m3/e5m2, "
            "bf16 and fp32 are)"
        )
    if isinstance(dtype, str):
        if head_dim % 2:
            raise ValueError(f"int4 KV needs an even head_dim; {head_dim}")
        return torch.int8, head_dim // 2, True
    return dtype, head_dim, False


@dataclasses.dataclass(frozen=True)
class KVPages:
    """One layer's paged K/V storage."""

    k_pages: torch.Tensor   # [n_kv_heads, num_pages, page_size, head_dim]
    k_scales: torch.Tensor  # [n_kv_heads, num_pages, page_size] fp32
    v_pages: torch.Tensor
    v_scales: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[-2]


def init_kv_pages(n_kv_heads: int, num_pages: int, page_size: int,
                  head_dim: int, dtype=torch.int8, device=None) -> KVPages:
    """Zeroed pages with unit scales on `device` (None means the card)."""
    dtype, width, _ = _resolve_cache_dtype(dtype, head_dim)
    device = resolve_device(device)
    shape = (n_kv_heads, num_pages, page_size, width)
    sshape = (n_kv_heads, num_pages, page_size)
    return KVPages(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        k_scales=torch.ones(sshape, dtype=torch.float32, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_scales=torch.ones(sshape, dtype=torch.float32, device=device),
    )


def _quantize_rows(x: torch.Tensor, dtype, packed: bool = False):
    """Per-row (last-axis) symmetric quantization -> (values, scales):
    scale = max(amax, 1e-12) / qmax and values = x / scale, divided (not
    multiplied by the inverse) as the JAX writer does, so the bytes agree:
    int8 rounds half to even and clips to +-127; fp8 flushes below the fp8
    minimum normal to 0, clips to +-qmax and casts (nearest even), as the
    JAX writer does (kv_cache.py:180-191) so that its decode kernels may
    take a normal-only path; ``packed`` is int4 split-half at qmax 7.
    Float caches store x cast to the cache dtype with unit scales."""
    if packed:
        values, scales = quantize_rows_int4(x)
        return values, scales[..., 0]
    if dtype in _FLOAT_CACHE_DTYPES:
        return x.to(dtype), torch.ones(x.shape[:-1], dtype=torch.float32,
                                       device=x.device)
    qmax = qmax_for(dtype)
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scales = amax.clamp_min(1e-12) / qmax
    q = x / scales[..., None]
    if dtype == torch.int8:
        values = torch.round(q).clamp(-qmax, qmax).to(dtype)
    else:
        q = torch.where(q.abs() < _FP8_MIN_NORMAL[dtype], 0.0, q)
        values = q.clamp(-qmax, qmax).to(dtype)
    return values, scales


def _packed(pages: "KVPages", x: torch.Tensor) -> bool:
    """int4 pages store half the head dim."""
    return is_packed_int4(pages.k_pages, x.shape[-1])


def append_token_kv(pages: KVPages, k_new, v_new, page_table, positions,
                    active) -> KVPages:
    """Single-token decode append for every slot, in place.

    k_new/v_new [num_seqs, n_kv_heads, head_dim]; page_table [num_seqs,
    pages_per_seq]; positions [num_seqs] (the write position, i.e. the
    current length); active [num_seqs] bool.  Inactive slots write the
    reserved null page 0, which is never attended."""
    page_size = pages.page_size
    num_seqs = k_new.shape[0]
    page_idx = (positions // page_size).clamp(max=page_table.shape[1] - 1)
    offsets = torch.where(active, positions % page_size, 0)
    page_ids = torch.where(
        active,
        page_table[torch.arange(num_seqs, device=page_table.device), page_idx],
        0,
    )
    dtype, packed = pages.k_pages.dtype, _packed(pages, k_new)
    kq, ks = _quantize_rows(k_new, dtype, packed)  # [n, Hkv, *], [n, Hkv]
    vq, vs = _quantize_rows(v_new, dtype, packed)
    pages.k_pages[:, page_ids, offsets] = kq.transpose(0, 1)
    pages.k_scales[:, page_ids, offsets] = ks.transpose(0, 1)
    pages.v_pages[:, page_ids, offsets] = vq.transpose(0, 1)
    pages.v_scales[:, page_ids, offsets] = vs.transpose(0, 1)
    return pages


def write_prompt_kv(pages: KVPages, k_prompt, v_prompt, page_ids) -> KVPages:
    """Prefill write, in place: a whole prompt's K/V [prompt_len, n_kv_heads,
    head_dim] into this slot's pages `page_ids` [prompt_len / page_size]
    (the chunk write of one slot from position 0).  prompt_len is padded to
    a page multiple by the caller (the engine)."""
    dev = k_prompt.device
    return write_chunk_kv_paged(
        pages, k_prompt[None], v_prompt[None],
        torch.as_tensor(page_ids, device=dev)[None],
        torch.zeros(1, dtype=torch.long, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev))


def append_chunk_kv(pages: KVPages, k_chunk, v_chunk, page_table, positions,
                    active) -> KVPages:
    """Multi-token append for speculative verification chunks, in place: T
    consecutive tokens per slot (k_chunk/v_chunk [num_seqs, T, n_kv_heads,
    head_dim]) from each slot's write position `positions` on, possibly
    crossing a page boundary.  T is small (the draft length + 1), so it is
    T single-token appends."""
    for i in range(k_chunk.shape[1]):
        append_token_kv(pages, k_chunk[:, i], v_chunk[:, i], page_table,
                        positions + i, active)
    return pages


def write_chunk_kv_paged(pages: KVPages, k_chunk, v_chunk, page_table,
                         first_positions, active) -> KVPages:
    """Page-granular multi-token append for chunked (suffix) prefill, in
    place: every slot's chunk starts on a page boundary (`first_positions`)
    and spans whole pages (T a multiple of the page size), so each (slot,
    page) lands in one indexed write.  Inactive slots write the reserved
    null page 0."""
    page_size = pages.page_size
    n, t, hkv, d = k_chunk.shape
    if t % page_size:
        raise ValueError(f"chunk length {t} is not a multiple of the page size")
    npg = t // page_size
    lo = (first_positions // page_size).long()
    cols = (lo[:, None] + torch.arange(npg, device=lo.device)[None]).clamp(
        max=page_table.shape[1] - 1)  # an inactive slot's start may be anything
    ids = torch.where(active[:, None], page_table.long().gather(1, cols), 0)
    ids = ids.reshape(-1)
    dtype, packed = pages.k_pages.dtype, _packed(pages, k_chunk)
    kq, ks = _quantize_rows(k_chunk.reshape(n * t, hkv, d), dtype, packed)
    vq, vs = _quantize_rows(v_chunk.reshape(n * t, hkv, d), dtype, packed)

    def to_pages(x):  # [n*T, Hkv, D] -> [Hkv, n*npg, page_size, D]
        return x.transpose(0, 1).reshape(hkv, n * npg, page_size, -1)

    def to_scale_pages(x):  # [n*T, Hkv] -> [Hkv, n*npg, page_size]
        return x.transpose(0, 1).reshape(hkv, n * npg, page_size)

    pages.k_pages[:, ids] = to_pages(kq)
    pages.k_scales[:, ids] = to_scale_pages(ks)
    pages.v_pages[:, ids] = to_pages(vq)
    pages.v_scales[:, ids] = to_scale_pages(vs)
    return pages


class PageAllocator:
    """Host-side refcounted free-list page allocator.  Page 0 is reserved as
    the null page; ids are handed out in the same order as the JAX allocator
    (1, 2, ... first, then most recently freed first).  Plain alloc/free is
    refcount 1; `share` lets several sequences point their page tables at
    one physical page (prefix caching), which returns to the free list when
    its last user frees it."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))
        self._rc: dict[int, int] = {}
        self.num_pages = num_pages
        # Called with the page id when a page's last reference is freed (the
        # engine drops the prefix-cache entry of a dead page).
        self.on_last_free = None

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV cache out of pages: need {n}, have {len(self._free)}"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._rc[p] = 1
        return out

    def share(self, pages) -> None:
        """Add a reference to already-allocated pages (prefix reuse)."""
        for p in pages:
            if int(p) != 0:
                self._rc[int(p)] += 1

    def refcount(self, page: int) -> int:
        return self._rc.get(int(page), 0)

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p == 0:
                continue
            rc = self._rc.get(p, 1) - 1
            if rc > 0:
                self._rc[p] = rc
                continue
            self._rc.pop(p, None)
            self._free.append(p)
            if self.on_last_free is not None:
                self.on_last_free(p)
