"""Paged decode attention: kernel B5 and its plain PyTorch version.

Replaces cuda_flash_attention_tpu/decode/attention.py::paged_decode_attention
(the Pallas TPU kernel).  One new query token per sequence slot attends over
that slot's pages of the (int8, bf16 or fp32) paged KV cache.  The CUDA
kernel is csrc/paged_decode.cu; its source note says what bounds it on the
H100 (bytes) and how its design answers that.  On a CPU tensor the wrapper
runs `paged_decode_attention_plain`; on a CUDA tensor it launches the kernel
or raises.  Sliding windows and sinks are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.decode.kv_cache import KVPages
from cuda_flash_attention_tpu_torch.kernels import _build
from cuda_flash_attention_tpu_torch.kernels.common import DEFAULT_MASK_VALUE

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

_SOURCE = "paged_decode"
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cfa_paged_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_attention(q, pages: KVPages, page_table, lengths, *,
                           sm_scale: float | None = None,
                           compute_dtype=torch.bfloat16,
                           window: int | None = None, sinks: int = 0):
    """Flash-decoding over the paged cache.  q [num_seqs, n_heads, D];
    page_table [num_seqs, pages_per_seq] int32; lengths [num_seqs] int32
    (0 for an inactive slot, whose output is zeros).  Returns
    [num_seqs, n_heads, D] in q's dtype.  ``compute_dtype`` (bf16 or fp32)
    is the type Q, the dequantized K/V and the scaled P take before the two
    products; the softmax is fp32."""
    if window is not None or sinks:
        raise NotImplementedError("windowed paged decode is not ported yet")
    num_seqs, n_heads, head_dim = q.shape
    n_kv_heads, num_pages, page_size, kv_dim = pages.k_pages.shape
    if n_heads % n_kv_heads or kv_dim != head_dim:
        raise ValueError(
            f"q {tuple(q.shape)} does not fit pages {tuple(pages.k_pages.shape)}"
        )
    if compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {compute_dtype} is not ported")
    if sm_scale is None:
        sm_scale = 1.0 / (head_dim ** 0.5)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pages, page_table, lengths, sm_scale=sm_scale,
            compute_dtype=compute_dtype,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    global launches
    cache_dtype = pages.k_pages.dtype
    if (cache_dtype not in _CACHE_CODES or head_dim not in _HEAD_DIMS
            or n_heads // n_kv_heads > _MAX_GROUP or page_size % 128
            or q.dtype not in _COMPUTE_DTYPES):
        raise NotImplementedError(
            f"paged_decode kernel: cache {cache_dtype}, head_dim {head_dim}, "
            f"group {n_heads // n_kv_heads}, page {page_size}, q {q.dtype} "
            f"(takes int8/bf16/fp32 caches, head_dim {_HEAD_DIMS}, group <= "
            f"{_MAX_GROUP}, page_size a multiple of 128, bf16/fp32 q)"
        )
    tensors = (q, pages.k_pages, pages.k_scales, pages.v_pages,
               pages.v_scales, page_table, lengths)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                "paged_decode kernel: inputs must be contiguous, 16-byte "
                "aligned and on one device"
            )
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_decode kernel: page_table and lengths must be int32")
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.cfa_paged_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        num_seqs, n_heads, n_kv_heads, num_pages, page_size,
        page_table.shape[1], head_dim, float(sm_scale),
        int(q.dtype == torch.bfloat16), _CACHE_CODES[cache_dtype],
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_paged_decode_error_string", err, "paged_decode")
    launches += 1
    return out


def paged_decode_attention_plain(q, pages: KVPages, page_table, lengths, *,
                                 sm_scale: float,
                                 compute_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch: gather each slot's live pages
    (dead table entries read the null page and are masked), dequantize with
    the K scale on the score columns and the V scale on P, softmax in fp32
    over the whole row at once, P * v_scale rounded to the compute dtype
    before the PV product.  lengths == 0 gives zeros."""
    n, n_heads, d = q.shape
    hkv, _, page_size, _ = pages.k_pages.shape
    group = n_heads // hkv
    pps = page_table.shape[1]
    cols = torch.arange(pps * page_size, device=q.device)
    keep = cols[None, :] < lengths[:, None].long()                 # [n, L]
    live = torch.arange(pps, device=q.device)[None, :] * page_size < lengths[:, None]
    ids = torch.where(live, page_table, 0).long()                   # [n, pps]

    def gather(x):  # [Hkv, P, page, *] -> [n, Hkv, pps * page, *]
        g = x[:, ids]                                               # [Hkv, n, pps, page, *]
        return g.transpose(0, 1).reshape(n, hkv, pps * page_size, *x.shape[3:])

    k = gather(pages.k_pages).to(compute_dtype).float()
    v = gather(pages.v_pages).to(compute_dtype).float()
    ks = gather(pages.k_scales)                                     # [n, Hkv, L]
    vs = gather(pages.v_scales)
    qf = q.reshape(n, hkv, group, d).to(compute_dtype).float()
    s = qf @ k.transpose(-1, -2)                                    # [n, Hkv, g, L]
    s = s * (ks * sm_scale)[:, :, None, :]
    mask = keep[:, None, None, :]
    s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    prob = torch.where(mask, torch.exp(s - m), 0.0)
    l = prob.sum(dim=-1, keepdim=True)
    ps = (prob * vs[:, :, None, :]).to(compute_dtype).float()
    o = (ps @ v) * torch.where(l == 0.0, 0.0, 1.0 / l)
    return o.reshape(n, n_heads, d).to(q.dtype)
