"""Paged attention over the KV cache: kernels B5 (one query per slot) and
B6 (a chunk of T queries per slot), each with its plain PyTorch version.

B5 replaces cuda_flash_attention_tpu/decode/attention.py::
paged_decode_attention and B6 its paged_chunk_attention (the Pallas TPU
kernels).  The CUDA kernels are csrc/paged_decode.cu and csrc/paged_chunk.cu;
each source note says what bounds it on the H100 and how its design answers
that.  On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Both take a sliding window and attention
sinks: a query at position pos keeps the cached columns pos - window < col
<= pos and col < sinks; its kernel walks only those columns' pages (a page
table entry behind the window is never read), and a windowed launch also
counts under `paged_decode_window` or `paged_chunk_window`.

Caches are int8, fp8 (e4m3 / e5m2), bf16, fp32 or packed int4 (int8 pages
of width head_dim // 2, split-half), at head dims 32, 64, 128 and 256 (an
fp32 cache at D 256 too: its chunks' V lands over K, and the bf16 tile
body stages 32 tokens; csrc/paged_decode.cu and paged_chunk.cu say how); D 32 and 256 come from libraries of their own
(common.kernel_library), and their launches also count under
`<name>_d32` / `<name>_d256`.  The JAX kernels decode fp8 pages with
a flush-to-zero bit path, exact on every code the writer emits because the
writer flushes below the fp8 minimum normal (kv_cache._quantize_rows); the
card's and torch's native conversions are exact on every code, so the two
agree on every page the writer produces.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cuda_flash_attention_tpu_torch.decode.kv_cache import KVPages
from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    FORWARD_HEAD_DIMS,
    NO_WINDOW,
    cdiv,
    head_dim_error,
    is_packed_int4,
    kernel_library,
    kv_storage_cast,
)

_SOURCE = "paged_decode"
_CHUNK_SOURCE = "paged_chunk"
_MAX_GROUP = 8
# The kernels' cache codes; packed int4 (int8 of width D/2) is code 5.
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_INT4_CODE = 5
_COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


# B5's C entry points (csrc/paged_decode.cu).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    "cfa_paged_decode": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 6 + [_P] * 3,
    "cfa_paged_decode_workspace_floats": [_I] * 4,
}
# B6's (csrc/paged_chunk.cu).
CHUNK_ARGTYPES = {
    "cfa_paged_chunk": [_P] * 8 + [_I] * 8 + [_F] + [_I] * 6 + [_P] * 3,
    "cfa_paged_chunk_workspace_floats": [_I] * 6,
}
# B6 takes its split-KV body where a KV head's T * group query rows are at
# most _SPLIT_ROWS, in row tiles of at most _ROW_TILE rows; above it, its
# tile bodies (csrc/paged_chunk.cu kSplitRows, kRowTile).
_SPLIT_ROWS = 64
_ROW_TILE = 16
# Blocks per SM that B5's split plan aims for: more splits shorten the
# longest block's walk, and a few resident blocks an SM overlap one's
# loads with another's arithmetic.
_BLOCKS_PER_SM = 2


def _lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library(_SOURCE, head_dim))
    if lib.cfa_paged_decode.argtypes is None:
        for name, argtypes in ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
        lib.cfa_paged_decode.restype = ctypes.c_int
        lib.cfa_paged_decode_workspace_floats.restype = ctypes.c_longlong
    return lib


def live_page_span(pages_per_seq: int, page_size: int, span: int,
                   sinks: int) -> int:
    """Pages of a slot's table that one call's rows can read under a window
    with sinks (csrc/paged_kv.cuh's twin): `span` columns (B5: the window;
    B6: window + T - 1) ending anywhere in a page touch cdiv(span - 1,
    page) + 1 pages, the sinks cdiv(sinks, page) more.  Without a window
    (span NO_WINDOW) it is the whole table."""
    pages = cdiv(span - 1, page_size) + 1 + cdiv(sinks, page_size)
    return min(pages_per_seq, pages)


def _window_args(window, sinks):
    """The kernels' (window, sinks): NO_WINDOW and 0 without a window."""
    if window is None:
        return NO_WINDOW, 0
    window = int(window)
    if window < 1:
        raise ValueError(f"window must be >= 1; got {window}")
    return window, int(sinks)


def decode_split_plan(num_seqs: int, n_kv_heads: int, pages_per_seq: int,
                      sm_count: int) -> int:
    """B5's split count, from shapes alone (never from `lengths`, whose
    values live on the card): the least count whose grid of (split, slot,
    KV head) blocks reaches _BLOCKS_PER_SM blocks an SM, capped at one page
    a split, then evened out so that no split is empty of pages.  Split s
    walks pages [s p, (s + 1) p), p = split_pages(pages_per_seq, n).  Under
    a window `pages_per_seq` is the live span (live_page_span), and a split
    walks that many pages' worth of the slot's live walk."""
    blocks = num_seqs * n_kv_heads
    want = min(pages_per_seq, max(1, -(-_BLOCKS_PER_SM * sm_count // blocks)))
    # The longest run of pages that still gives `want` splits.
    per = pages_per_seq if want == 1 else max(1, -(-pages_per_seq // (want - 1)) - 1)
    return -(-pages_per_seq // per)


def split_pages(pages_per_seq: int, n_splits: int) -> int:
    """Pages of each split but the last (the kernel's own rule)."""
    return -(-pages_per_seq // n_splits)


def chunk_body(chunk: int, group: int) -> str:
    """B6's body for T = chunk queries of `group` heads per KV head, from
    shapes alone: "split" (split-KV flash-decoding, speculation's verify)
    where the T * group rows fit _SPLIT_ROWS, else "tiles" (64-row tiles
    walking the slot's pages: chunked prefill, prefix suffixes).  Both
    take head_dim 64 and 128 alike."""
    return "split" if chunk * group <= _SPLIT_ROWS else "tiles"


def chunk_row_tiles(chunk: int, group: int) -> int:
    """Row tiles of the split body a KV head: blocks of at most _ROW_TILE
    of its T * group rows."""
    return -(-chunk * group // _ROW_TILE)


def chunk_split_plan(num_seqs: int, n_kv_heads: int, pages_per_seq: int,
                     chunk: int, group: int, sm_count: int) -> int:
    """B6's split count, from shapes alone: decode_split_plan with each
    (slot, row tile) counted as a slot; 1 for the tile bodies."""
    if chunk_body(chunk, group) != "split":
        return 1
    return decode_split_plan(num_seqs * chunk_row_tiles(chunk, group),
                             n_kv_heads, pages_per_seq, sm_count)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# B5's and B6's arrival counters, one int32 buffer per device: zeroed when
# allocated, and every call leaves the counters it used at zero again.
# Calls on one stream share them safely; two calls at once on two streams
# would not.
_counters: dict[int, torch.Tensor] = {}


def _counters_for(device: torch.device, n: int) -> torch.Tensor:
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        # At least 4096 (slots x KV heads), so that a captured call rarely
        # finds the buffer too small after its eager warm-up.
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


def _chunk_lib(head_dim: int = 64) -> ctypes.CDLL:
    lib = _build.load(kernel_library(_CHUNK_SOURCE, head_dim))
    if lib.cfa_paged_chunk.argtypes is None:
        for name, argtypes in CHUNK_ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
        lib.cfa_paged_chunk.restype = ctypes.c_int
        lib.cfa_paged_chunk_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check_kernel_inputs(what: str, q, pages: KVPages, page_table, lengths,
                         group: int):
    """Raise on what the CUDA kernels (B5, B6) do not take."""
    cache_dtype = pages.k_pages.dtype
    head_dim, page_size = q.shape[-1], pages.page_size
    if head_dim not in FORWARD_HEAD_DIMS:
        raise head_dim_error(what, head_dim)
    if (cache_dtype not in _CACHE_CODES or group > _MAX_GROUP or page_size % 128
            or q.dtype not in _COMPUTE_DTYPES):
        raise NotImplementedError(
            f"{what} kernel: cache {cache_dtype}, head_dim {head_dim}, "
            f"group {group}, page {page_size}, q {q.dtype} "
            f"(takes fp32/bf16/int8/int4/fp8 caches; group <= {_MAX_GROUP}, "
            f"page_size a multiple of 128, bf16/fp32 q)"
        )
    tensors = (q, pages.k_pages, pages.k_scales, pages.v_pages,
               pages.v_scales, page_table, lengths)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"{what} kernel: inputs must be contiguous, 16-byte aligned "
                "and on one device"
            )
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what} kernel: page_table and lengths must be int32")
    return tensors


def _cache_code(pages: KVPages, head_dim: int) -> int:
    if is_packed_int4(pages.k_pages, head_dim):
        return _INT4_CODE
    return _CACHE_CODES[pages.k_pages.dtype]


def _check_fit(q, pages: KVPages):
    """q's heads and head dim fit the pages (int4 pages store head_dim // 2
    int8 bytes)."""
    n_heads, head_dim = q.shape[-2], q.shape[-1]
    n_kv_heads, kv_dim = pages.k_pages.shape[0], pages.k_pages.shape[-1]
    if n_heads % n_kv_heads or (kv_dim != head_dim
                                and not is_packed_int4(pages.k_pages, head_dim)):
        raise ValueError(
            f"q {tuple(q.shape)} does not fit pages {tuple(pages.k_pages.shape)}"
        )


def paged_decode_attention(q, pages: KVPages, page_table, lengths, *,
                           sm_scale: float | None = None,
                           compute_dtype=torch.bfloat16,
                           window: int | None = None, sinks: int = 0):
    """Flash-decoding over the paged cache.  q [num_seqs, n_heads, D];
    page_table [num_seqs, pages_per_seq] int32; lengths [num_seqs] int32
    (0 for an inactive slot, whose output is zeros).  Returns
    [num_seqs, n_heads, D] in q's dtype.  ``compute_dtype`` (bf16 or fp32)
    is the type Q, the dequantized K/V and the scaled P take before the two
    products; the softmax is fp32.  ``window`` (>= 1) keeps the last
    `window` keys (col >= length - window), ``sinks`` the first `sinks`
    besides; table entries of pages behind the window are never read.

    On the card it is one launch that reads no value of `lengths` on the
    host (decode_split_plan), so it can be captured in a CUDA graph once
    one eager call at the same shapes has allocated the arrival counters."""
    _window_args(window, sinks)
    sinks = int(sinks) if window is not None else 0
    head_dim = q.shape[-1]
    _check_fit(q, pages)
    if compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {compute_dtype} is not ported")
    if sm_scale is None:
        sm_scale = 1.0 / (head_dim ** 0.5)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, pages, page_table, lengths, sm_scale=sm_scale,
            compute_dtype=compute_dtype, window=window, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    out = decode_launch(_lib(head_dim), q, pages, page_table, lengths,
                        sm_scale=sm_scale, compute_dtype=compute_dtype,
                        window=window, sinks=sinks)
    launches.count("paged_decode", window, head_dim=head_dim)
    return out


def decode_launch(lib: ctypes.CDLL, q, pages: KVPages, page_table, lengths, *,
                  sm_scale: float, compute_dtype, window=None, sinks: int = 0):
    """One launch of B5 from `lib` (csrc/paged_decode.cu built, or an
    earlier build of it with the same entry points) on CUDA tensors: the
    split plan (over the live span under a window), the workspace and the
    arrival counters; returns the output."""
    num_seqs, n_heads, head_dim = q.shape
    n_kv_heads, num_pages, page_size, _ = pages.k_pages.shape
    tensors = _check_kernel_inputs("paged_decode", q, pages, page_table,
                                   lengths, n_heads // n_kv_heads)
    out = torch.empty_like(q)
    pps = page_table.shape[1]
    win, sinks = _window_args(window, sinks)
    n_splits = decode_split_plan(num_seqs, n_kv_heads,
                                 live_page_span(pps, page_size, win, sinks),
                                 _sm_count(q.device.index))
    workspace = counters = None
    if n_splits > 1:
        workspace = torch.empty(
            lib.cfa_paged_decode_workspace_floats(num_seqs, n_heads, head_dim,
                                                  n_splits),
            dtype=torch.float32, device=q.device)
        counters = _counters_for(q.device, num_seqs * n_kv_heads)
    err = lib.cfa_paged_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        num_seqs, n_heads, n_kv_heads, num_pages, page_size, pps, head_dim,
        float(sm_scale), int(q.dtype == torch.bfloat16),
        _cache_code(pages, head_dim), int(compute_dtype == torch.bfloat16),
        win, sinks, n_splits, None if workspace is None else workspace.data_ptr(),
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_paged_decode_error_string", err, "paged_decode")
    return out


def paged_decode_attention_plain(q, pages: KVPages, page_table, lengths, *,
                                 sm_scale: float,
                                 compute_dtype=torch.bfloat16,
                                 window: int | None = None, sinks: int = 0):
    """The B5 kernel's function in plain PyTorch: the chunk version's with
    one query per slot."""
    return paged_chunk_attention_plain(
        q[:, None], pages, page_table, lengths, sm_scale=sm_scale,
        compute_dtype=compute_dtype, window=window, sinks=sinks)[:, 0]


def paged_chunk_attention(q, pages: KVPages, page_table, lengths, *,
                          sm_scale: float | None = None,
                          compute_dtype=torch.bfloat16,
                          window: int | None = None, sinks: int = 0):
    """Multi-query flash-decoding for speculative verification and chunked
    (suffix) prefill.  q [num_seqs, T, n_heads, D] are T consecutive new
    tokens per slot whose K/V is already in the cache (`append_chunk_kv` or
    `write_chunk_kv_paged`); lengths [num_seqs] int32 is the TOTAL length,
    the chunk included (0 for an inactive slot, whose output is zeros).
    Query t attends causally up to its own position length - T + t (and
    with a window keeps only its last `window` keys and the `sinks` first).
    Returns [num_seqs, T, n_heads, D] in q's dtype; ``compute_dtype`` as in
    paged_decode_attention.

    On the card it is one launch that reads no value of `lengths` on the
    host (chunk_launch)."""
    _window_args(window, sinks)
    sinks = int(sinks) if window is not None else 0
    num_seqs, chunk, n_heads, head_dim = q.shape
    n_kv_heads, num_pages, page_size, _ = pages.k_pages.shape
    _check_fit(q, pages)
    if compute_dtype not in _COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {compute_dtype} is not ported")
    if sm_scale is None:
        sm_scale = 1.0 / (head_dim ** 0.5)
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, pages, page_table, lengths, sm_scale=sm_scale,
            compute_dtype=compute_dtype, window=window, sinks=sinks,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_chunk_attention: unsupported device {q.device}")
    out = chunk_launch(_chunk_lib(head_dim), q, pages, page_table, lengths,
                       sm_scale=sm_scale, compute_dtype=compute_dtype,
                       window=window, sinks=sinks)
    launches.count("paged_chunk", window, head_dim=head_dim)
    if (compute_dtype == torch.float32
            and chunk_body(chunk, n_heads // n_kv_heads) == "tiles"):
        launches.count("paged_chunk_fp32_tile")
    return out


def chunk_launch(lib: ctypes.CDLL, q, pages: KVPages, page_table, lengths, *,
                 sm_scale: float, compute_dtype, window=None, sinks: int = 0):
    """One launch of B6 from `lib` (csrc/paged_chunk.cu built, or a variant
    of it with the same entry points) on CUDA tensors: the body's split
    plan, the workspace and the arrival counters (shared with B5's); reads
    no value of `lengths` on the host, so the split body can be captured in
    a CUDA graph once one eager call at the same shapes has allocated the
    counters.  Returns the output."""
    num_seqs, chunk, n_heads, head_dim = q.shape
    n_kv_heads, num_pages, page_size, _ = pages.k_pages.shape
    group = n_heads // n_kv_heads
    tensors = _check_kernel_inputs("paged_chunk", q, pages, page_table,
                                   lengths, group)
    out = torch.empty_like(q)
    pps = page_table.shape[1]
    win, sinks = _window_args(window, sinks)
    n_splits = chunk_split_plan(
        num_seqs, n_kv_heads, live_page_span(pps, page_size, win + chunk - 1, sinks),
        chunk, group, _sm_count(q.device.index))
    workspace = counters = None
    if n_splits > 1:
        workspace = torch.empty(
            lib.cfa_paged_chunk_workspace_floats(num_seqs, chunk, n_heads,
                                                 n_kv_heads, head_dim, n_splits),
            dtype=torch.float32, device=q.device)
        counters = _counters_for(q.device, num_seqs * n_kv_heads
                                 * chunk_row_tiles(chunk, group))
    err = lib.cfa_paged_chunk(
        *(t.data_ptr() for t in tensors), out.data_ptr(),
        num_seqs, chunk, n_heads, n_kv_heads, num_pages, page_size, pps,
        head_dim, float(sm_scale), int(q.dtype == torch.bfloat16),
        _cache_code(pages, head_dim), int(compute_dtype == torch.bfloat16),
        win, sinks, n_splits, None if workspace is None else workspace.data_ptr(),
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_paged_chunk_error_string", err, "paged_chunk")
    return out


def paged_chunk_attention_plain(q, pages: KVPages, page_table, lengths, *,
                                sm_scale: float,
                                compute_dtype=torch.bfloat16,
                                window: int | None = None, sinks: int = 0):
    """The B6 kernel's function in plain PyTorch: gather each slot's live
    pages (dead table entries, past the length or behind every row's
    window, read the null page and are masked), rows ordered t-major inside
    each KV head (row r is query r // group at position pos = length - T +
    r // group, which bounds its columns; a window keeps pos - window < col
    and the sinks col < sinks), the K scale on the score columns and the V
    scale on P, softmax in fp32 over the whole row at once, P * v_scale
    rounded to the compute dtype before the PV product.  Fully masked rows
    (lengths == 0) give zeros."""
    n, chunk, n_heads, d = q.shape
    hkv, _, page_size, _ = pages.k_pages.shape
    group = n_heads // hkv
    rows = chunk * group
    pps = page_table.shape[1]
    lengths = lengths.long()
    cols = torch.arange(pps * page_size, device=q.device)
    first = torch.arange(pps, device=q.device)[None, :] * page_size  # [1, pps]
    live = first < lengths[:, None]
    if window is not None:
        # The oldest column any row keeps is length - T - window + 1.
        in_win = first + page_size > (lengths - chunk - window + 1)[:, None]
        live &= in_win | (first < sinks)
    ids = torch.where(live, page_table, 0).long()                   # [n, pps]

    def gather(x):  # [Hkv, P, page, *] -> [n, Hkv, pps * page, *]
        g = x[:, ids]                                       # [Hkv, n, pps, page, *]
        return g.transpose(0, 1).reshape(n, hkv, pps * page_size, *x.shape[3:])

    k = kv_storage_cast(gather(pages.k_pages), d, compute_dtype).float()
    v = kv_storage_cast(gather(pages.v_pages), d, compute_dtype).float()
    ks = gather(pages.k_scales)                                     # [n, Hkv, L]
    vs = gather(pages.v_scales)
    qf = (q.reshape(n, chunk, hkv, group, d).transpose(1, 2)
          .reshape(n, hkv, rows, d).to(compute_dtype).float())
    pos = (lengths[:, None] - chunk
           + torch.arange(rows, device=q.device)[None, :] // group)  # [n, rows]
    keep = cols[None, None, :] <= pos[:, :, None]
    if window is not None:
        keep &= ((cols[None, None, :] > pos[:, :, None] - window)
                 | (cols[None, None, :] < sinks))
    keep = keep[:, None]                                            # [n, 1, rows, L]
    s = qf @ k.transpose(-1, -2)                                    # [n, Hkv, rows, L]
    s = s * (ks * sm_scale)[:, :, None, :]
    s = s + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    prob = torch.where(keep, torch.exp(s - m), 0.0)
    l = prob.sum(dim=-1, keepdim=True)
    ps = (prob * vs[:, :, None, :]).to(compute_dtype).float()
    o = (ps @ v) * torch.where(l == 0.0, 0.0, 1.0 / l)
    return (o.reshape(n, hkv, chunk, group, d).transpose(1, 2)
            .reshape(n, chunk, n_heads, d).to(q.dtype))
