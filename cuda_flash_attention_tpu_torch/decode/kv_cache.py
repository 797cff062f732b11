"""Paged KV cache: fixed-size pages, host-side page allocator, quantized
storage.

Counterpart of cuda_flash_attention_tpu/decode/kv_cache.py with the same
layout: pages [n_kv_heads, num_pages, page_size, head_dim] of int8, bf16 or
fp32 with fp32 per-token scales [n_kv_heads, num_pages, page_size] (all ones
for a float cache).  A page table [max_seqs, pages_per_seq] maps each slot's
logical pages to physical ones; page 0 is the reserved null page.

Unlike the JAX package, whose arrays are immutable, the writers here update
the cache tensors IN PLACE (indexed assignment) and return the same KVPages:
the cache is the largest state of a server and is never copied per token.
fp8 and int4 caches are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.quant.qtensor import qmax_for

_FLOAT_CACHE_DTYPES = (torch.float32, torch.bfloat16)
_CACHE_DTYPES = _FLOAT_CACHE_DTYPES + (torch.int8,)


def _check_cache_dtype(dtype) -> None:
    if dtype not in _CACHE_DTYPES:
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported yet (int8, bf16, fp32 are)"
        )


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
    _check_cache_dtype(dtype)
    device = resolve_device(device)
    shape = (n_kv_heads, num_pages, page_size, head_dim)
    sshape = (n_kv_heads, num_pages, page_size)
    return KVPages(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        k_scales=torch.ones(sshape, dtype=torch.float32, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_scales=torch.ones(sshape, dtype=torch.float32, device=device),
    )


def _quantize_rows(x: torch.Tensor, dtype):
    """Per-row (last-axis) symmetric quantization -> (values, scales):
    scale = max(amax, 1e-12) / qmax, values = round-half-even(x / scale)
    clipped to +-qmax.  It divides by the scale (not multiplies by its
    inverse), as the JAX writer does, so the int8 bytes agree bit for bit.
    Float caches store x cast to the cache dtype with unit scales."""
    _check_cache_dtype(dtype)
    if dtype in _FLOAT_CACHE_DTYPES:
        return x.to(dtype), torch.ones(x.shape[:-1], dtype=torch.float32,
                                       device=x.device)
    qmax = qmax_for(dtype)
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scales = amax.clamp_min(1e-12) / qmax
    q = x / scales[..., None]
    values = torch.round(q).clamp(-qmax, qmax).to(dtype)
    return values, scales


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
    dtype = pages.k_pages.dtype
    kq, ks = _quantize_rows(k_new, dtype)  # [n, Hkv, D], [n, Hkv]
    vq, vs = _quantize_rows(v_new, dtype)
    pages.k_pages[:, page_ids, offsets] = kq.transpose(0, 1)
    pages.k_scales[:, page_ids, offsets] = ks.transpose(0, 1)
    pages.v_pages[:, page_ids, offsets] = vq.transpose(0, 1)
    pages.v_scales[:, page_ids, offsets] = vs.transpose(0, 1)
    return pages


def write_prompt_kv(pages: KVPages, k_prompt, v_prompt, page_ids) -> KVPages:
    """Prefill write, in place: a whole prompt's K/V [prompt_len, n_kv_heads,
    head_dim] into this slot's pages `page_ids` [prompt_len / page_size].
    prompt_len is padded to a page multiple by the caller (the engine)."""
    page_size = pages.page_size
    s = k_prompt.shape[0]
    if s % page_size:
        raise ValueError(f"prompt length {s} is not a multiple of the page size")
    n = s // page_size
    dtype = pages.k_pages.dtype
    kq, ks = _quantize_rows(k_prompt, dtype)
    vq, vs = _quantize_rows(v_prompt, dtype)

    def to_pages(x):  # [S, Hkv, D] -> [Hkv, n, page_size, D]
        return x.transpose(0, 1).reshape(x.shape[1], n, page_size, -1)

    def to_scale_pages(x):  # [S, Hkv] -> [Hkv, n, page_size]
        return x.transpose(0, 1).reshape(x.shape[1], n, page_size)

    pages.k_pages[:, page_ids] = to_pages(kq)
    pages.k_scales[:, page_ids] = to_scale_pages(ks)
    pages.v_pages[:, page_ids] = to_pages(vq)
    pages.v_scales[:, page_ids] = to_scale_pages(vs)
    return pages


class PageAllocator:
    """Host-side free-list page allocator.  Page 0 is reserved as the null
    page; ids are handed out in the same order as the JAX allocator (1, 2,
    ... first, then most recently freed first)."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"KV cache out of pages: need {n}, have {len(self._free)}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if int(p) != 0:
                self._free.append(int(p))
