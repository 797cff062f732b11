"""Serving on a mesh: the paged decode path with KV heads over "model" and,
under a "data" axis, slots and the page pool over "data".

Counterpart of cuda_flash_attention_tpu/decode/sharded.py.  There each
function is a shard_map island over global arrays; here every rank is its
own process (parallel/mesh.py), so each function is the island's local
body on this rank's block:
  * KV pages [n_kv_heads / tp, num_pages / dp, page_size, D]: its KV heads
    over "model" and, under "data", its private slice of the page pool
    (`shard_kv_pages` takes it from a full cache, `init_local_kv_pages`
    allocates it at the local size);
  * queries [num_seqs, n_heads / tp, D]: its query heads.  GQA groups never
    straddle ranks, because n_kv_heads % tp == 0 and query heads are
    ordered kv-head-major;
  * page table, positions, active, lengths: every slot's rows on a mesh
    without "data"; under "data" its own slots' rows, whose page ids are
    local to its slice of the pool.
No collective runs here, as none runs inside JAX's islands: the attention
path of serving needs none.  So each function is the append and the B5 or
B6 call that runs without a mesh, on this rank's block, and decode/model.py
makes those calls itself; these are the JAX API's names for them.  The
all-reduces after wo and w_down are decode/model.py's, the logits' gather
over "model" DecodeEngine's.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.decode.attention import (
    paged_chunk_attention,
    paged_decode_attention,
)
from cuda_flash_attention_tpu_torch.decode.kv_cache import (
    KVPages,
    append_chunk_kv,
    append_token_kv,
    init_kv_pages,
    write_chunk_kv_paged,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import local_slice
from cuda_flash_attention_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS


def mesh_dp(mesh, data_axis: str = DATA_AXIS) -> int:
    return mesh.size(data_axis)


def _check_heads(tp: int, n_kv_heads: int) -> None:
    if n_kv_heads % tp:
        raise ValueError(
            f"the model-axis size {tp} must divide n_kv_heads={n_kv_heads} "
            f"(KV pages are head-sharded and must stay device-local)")


def kv_pages_spec(mesh, *, model_axis: str = MODEL_AXIS,
                  data_axis: str | None = None) -> KVPages:
    """The axis that splits each dim of each KVPages field (None: not
    split), as JAX's PartitionSpecs: KV heads over the model axis; with
    `data_axis`, the page pool over data too (each data shard owns its own
    physical pages, so appends and attention stay rank-local)."""
    model = model_axis if mesh.size(model_axis) > 1 else None
    data = data_axis if data_axis and mesh.size(data_axis) > 1 else None
    return KVPages(k_pages=(model, data, None, None), k_scales=(model, data, None),
                   v_pages=(model, data, None, None), v_scales=(model, data, None))


def shard_kv_pages(mesh, pages: KVPages, *, model_axis: str = MODEL_AXIS,
                   data_axis: str | None = None) -> KVPages:
    """This rank's pages of a full cache under `kv_pages_spec` (copies,
    contiguous)."""
    _check_heads(mesh.size(model_axis), pages.k_pages.shape[0])
    spec = kv_pages_spec(mesh, model_axis=model_axis, data_axis=data_axis)

    def take(x, axes):
        for dim, axis in enumerate(axes):
            if axis is not None:
                x = local_slice(x, mesh, axis, dim)
        return x.contiguous()

    return KVPages(*(take(getattr(pages, f), getattr(spec, f))
                     for f in ("k_pages", "k_scales", "v_pages", "v_scales")))


def init_local_kv_pages(mesh, n_kv_heads: int, num_pages: int, page_size: int,
                        head_dim: int, dtype=torch.int8, *,
                        model_axis: str = MODEL_AXIS,
                        data_axis: str | None = None) -> KVPages:
    """Zeroed pages at this rank's size, on the mesh's device: the block
    `shard_kv_pages` would take from a full cache of `num_pages` pages."""
    tp = mesh.size(model_axis)
    dp = mesh.size(data_axis) if data_axis else 1
    _check_heads(tp, n_kv_heads)
    if num_pages % dp:
        raise ValueError(
            f"num_pages ({num_pages}) must divide over the data axis ({dp}): "
            f"each shard owns a private pool slice")
    return init_kv_pages(n_kv_heads // tp, num_pages // dp, page_size, head_dim,
                         dtype, device=mesh.device)


def tp_paged_decode_attention(mesh, q, pages: KVPages, page_table, lengths, *,
                              sm_scale: float | None = None,
                              compute_dtype=torch.bfloat16,
                              window: int | None = None, sinks: int = 0):
    """Head-parallel flash-decoding (B5) on this rank's heads: q [num_seqs,
    n_heads / tp, D] and its KV heads' pages; the page table and lengths
    of every slot.  No communication."""
    return paged_decode_attention(q, pages, page_table, lengths,
                                  sm_scale=sm_scale, compute_dtype=compute_dtype,
                                  window=window, sinks=sinks)


def tp_chunk_append_attend(mesh, q, k_new, v_new, pages: KVPages, page_table,
                           first_positions, active, total_lengths, *,
                           paged_write: bool = False,
                           sm_scale: float | None = None,
                           compute_dtype=torch.bfloat16,
                           window: int | None = None, sinks: int = 0):
    """Chunk append and multi-query flash-decoding (B6) on this rank's
    block (the verification and chunked-prefill twin of
    dp_tp_append_attend): q [num_seqs, T, n_heads / tp, D], k_new/v_new
    [num_seqs, T, n_kv_heads / tp, D], the rows of this rank's slots (all
    of them without "data") with page ids local to its pool slice.  The
    pages are written in place.  Returns (o [num_seqs, T, n_heads / tp, D],
    pages)."""
    write = write_chunk_kv_paged if paged_write else append_chunk_kv
    write(pages, k_new, v_new, page_table, first_positions, active)
    o = paged_chunk_attention(q, pages, page_table, total_lengths,
                              sm_scale=sm_scale, compute_dtype=compute_dtype,
                              window=window, sinks=sinks)
    return o, pages


def dp_tp_append_attend(mesh, q, k_new, v_new, pages: KVPages, page_table,
                        positions, active, lengths, *,
                        sm_scale: float | None = None,
                        compute_dtype=torch.bfloat16,
                        window: int | None = None, sinks: int = 0):
    """The decode step's KV append and paged attention (B5) on this rank's
    (data, model) block: q [slots, n_heads / tp, D] and k_new/v_new [slots,
    n_kv_heads / tp, D] of its data shard's slots, its private page pool
    (the table holds ids local to it).  The pages are written in place.
    Returns (o [slots, n_heads / tp, D], pages)."""
    append_token_kv(pages, k_new, v_new, page_table, positions, active)
    o = paged_decode_attention(q, pages, page_table, lengths, sm_scale=sm_scale,
                               compute_dtype=compute_dtype, window=window,
                               sinks=sinks)
    return o, pages
