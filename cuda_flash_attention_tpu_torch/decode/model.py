"""Decode-mode model functions: prefill (the K/V that fill the paged cache),
the single-token decode step and the chunked verify step over paged
attention.

Counterpart of cuda_flash_attention_tpu/decode/model.py in its per-layer
list form (caches are a list of KVPages, params["layers"] a list).  The
decode and verify steps append to the caches in place.  The stacked form
is not kept: JAX scans it to compile one layer body, and eager PyTorch
compiles nothing, so the engine's scan_layers runs this list form.  Each
layer attends with its own window (cfg.layer_window(i)) and, where it has
one, the config's sinks; `page_table` is one table, or a per-layer list
under the engine's hybrid window-group cache (`_table_for`).

With a mesh (JAX's mesh=: "data", "model" and "expert" axes) every
function takes this rank's block and returns its block of the logits: the
slot-indexed inputs (tokens, positions, page table, active) are the rows of
this rank's data shard (every row without "data"), the caches its pages
(decode/sharded.py), the parameters its blocks (models.transformer.
shard_params).  The projections are the tensor-parallel blocks of
training (copy_to before wq/wk/wv and w_gate/w_up, reduce_from after wo
and w_down); an MoE layer runs models/moe.py's expert-parallel form, which
gathers every slot's tokens over "data" and routes them all.  Attention runs head-local: prefill through head-parallel
attention; decode and verification are the same appends and B5/B6 calls
as without a mesh, on this rank's heads and pages, which is all that
decode/sharded.py's local bodies do.  The lm head is split by columns over
"model", so the logits are this rank's vocab columns, as
models.transformer.forward(mesh=) returns them: the caller gathers over
"model" the rows it reads (DecodeEngine gathers them before sampling,
bias, penalties and logprobs), and a prefill's [B, S, vocab] never
crosses ranks whole.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.decode.attention import (
    paged_chunk_attention,
    paged_decode_attention,
)
from cuda_flash_attention_tpu_torch.decode.kv_cache import (
    append_chunk_kv,
    append_token_kv,
    write_chunk_kv_paged,
)
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    attention_block,
    ffn_block,
    rms_norm,
    rope,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import (
    copy_to,
    reduce_from,
)
from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS
from cuda_flash_attention_tpu_torch.quant.linear import dense


def _table_for(page_table, i: int):
    """Layer i's page table (JAX decode/model.py:52-59): the engine passes
    one table for a cache of one window group, or a per-layer list under
    the hybrid cache (layers of a group share one table; local groups
    recycle pages behind their window, global ones keep the history)."""
    if isinstance(page_table, (list, tuple)):
        return page_table[i]
    return page_table


def _layer_window(cfg: TransformerConfig, i: int):
    """Layer i's (window, sinks): sinks only where the layer has a window."""
    w = cfg.layer_window(i)
    return w, (cfg.attn_sinks if w is not None else 0)


def _logits(x, params, mesh, last_only: bool = False):
    """fp32 logits of the final hidden states (of the last position only,
    with last_only); with a mesh this rank's vocab columns."""
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:, :]
    if mesh is not None:
        x = copy_to(x, mesh, MODEL_AXIS)
    return dense(x, params["lm_head"]).float()


def _qkv(h, layer, lead, cfg: TransformerConfig, mesh):
    """q, k, v [*lead, heads, D] of the normed hidden states: every head,
    or with a mesh this rank's heads (its column blocks of wq, wk, wv)."""
    if mesh is not None:
        h = copy_to(h, mesh, MODEL_AXIS)
    return tuple(dense(h, layer[w]).reshape(*lead, -1, cfg.head_dim)
                 for w in ("wq", "wk", "wv"))


def _attn_out(x, o, layer, mesh):
    """x plus the output projection of o [..., heads, D] (with a mesh, this
    rank's row block of wo, its partial sums reduced over "model")."""
    y = dense(o.flatten(-2), layer["wo"])
    if mesh is not None:
        y = reduce_from(y, mesh, MODEL_AXIS)
    return x + y


def prefill_forward(params, tokens, cfg: TransformerConfig,
                    last_only: bool = False, mesh=None):
    """Full causal forward over a prompt batch [B, S]; returns
    (logits [B, S, vocab] fp32, kv) where kv is a per-layer list of post-RoPE
    (k, v) [B, S, Hkv, D].  With last_only, only the last position's logits
    ([B, 1, vocab]).  With a mesh (the module's note) `tokens` are this
    rank's data shard's rows, k/v its KV heads [B, S, Hkv / tp, D], the
    logits its vocab columns, and attention runs head-parallel
    (gqa_flash_attention's route)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    kv_out = []
    for i, layer in enumerate(params["layers"]):
        x, kv = attention_block(x, layer, positions, cfg,
                                window=cfg.layer_window(i), mesh=mesh)
        x, _ = ffn_block(x, layer, cfg, mesh)
        kv_out.append(kv)
    return _logits(x, params, mesh, last_only), kv_out


def _decode_layer(x, layer, pages, pos2, positions, attn_lengths, page_table,
                  active, cfg: TransformerConfig, compute_dtype, window=None,
                  sinks=0, mesh=None):
    """One decode layer: append this token's K/V to `pages` (in place),
    attend over the pages, then the FFN.  With a mesh the same calls run
    on this rank's block (JAX decode/model.py:138-160 calls its sharded
    twins)."""
    n = x.shape[0]
    h = rms_norm(x, layer["attn_norm"])
    q, k, v = _qkv(h, layer, (n, 1), cfg, mesh)
    q = rope(q, pos2, *cfg.rope_args)[:, 0].to(cfg.dtype)  # [n, Hq, D]
    k = rope(k, pos2, *cfg.rope_args)[:, 0]  # [n, Hkv, D]
    append_token_kv(pages, k, v[:, 0], page_table, positions, active)
    o = paged_decode_attention(q, pages, page_table, attn_lengths,
                               compute_dtype=compute_dtype, window=window,
                               sinks=sinks)
    x = _attn_out(x, o, layer, mesh)
    x, _ = ffn_block(x, layer, cfg, mesh)
    return x


def _compute_dtype(cfg: TransformerConfig):
    return torch.float32 if cfg.attn_tile_dtype is None else torch.bfloat16


def _chunk_layer(x, layer, pages, pos_t, first_positions, total_lengths,
                 page_table, active, cfg: TransformerConfig, compute_dtype,
                 paged_write: bool, window=None, sinks=0, mesh=None):
    """One verification layer: T new tokens per slot [n, T, d_model]; their
    K/V is written to `pages` (in place), then chunked paged attention reads
    it back, each token causally bounded at its own position.
    ``paged_write`` switches the write from T per-token appends (speculative
    chunks: small T, any alignment) to one page-granular write (chunked and
    suffix prefill: page-aligned start, whole pages).  With a mesh the same
    calls run on this rank's block."""
    n, t = x.shape[:2]
    h = rms_norm(x, layer["attn_norm"])
    q, k, v = _qkv(h, layer, (n, t), cfg, mesh)
    q = rope(q, pos_t, *cfg.rope_args).to(cfg.dtype)
    k = rope(k, pos_t, *cfg.rope_args)
    write = write_chunk_kv_paged if paged_write else append_chunk_kv
    write(pages, k, v, page_table, first_positions, active)
    o = paged_chunk_attention(q, pages, page_table, total_lengths,
                              compute_dtype=compute_dtype, window=window,
                              sinks=sinks)
    x = _attn_out(x, o, layer, mesh)  # o [n, T, Hq, D]
    x, _ = ffn_block(x, layer, cfg, mesh)
    return x


def verify_step(params, chunk_tokens, first_positions, caches, page_table,
                active, cfg: TransformerConfig, *, paged_write: bool = False,
                mesh=None):
    """Speculative-decoding verification: one forward scores all T chunk
    positions while appending their K/V.  chunk_tokens [num_seqs, T] (the
    last accepted token and T-1 drafts), first_positions [num_seqs] (write
    position of the chunk's first token), caches a list of per-layer
    KVPages (updated in place), page_table [num_seqs, pages_per_seq] int32,
    active [num_seqs] bool.  Returns (logits [num_seqs, T, vocab] fp32,
    caches).  With ``paged_write=True`` (page-aligned first_positions, T a
    multiple of the page size) it is the chunked-prefill step: a prompt
    chunk or a prefix-cache suffix attends everything cached before it
    (within each layer's window).  An inactive slot has total length 0, so
    it attends nothing.  `page_table` may be a per-layer list (_table_for).
    With a mesh, this rank's block (the module's note)."""
    n, t = chunk_tokens.shape
    x = params["embed"][chunk_tokens].to(cfg.dtype)  # [n, T, d_model]
    first_positions = first_positions.long()
    pos_t = first_positions[:, None] + torch.arange(t, device=x.device)[None]
    total_lengths = torch.where(active, first_positions + t, 0).to(torch.int32)
    compute_dtype = _compute_dtype(cfg)
    for i, (layer, pages) in enumerate(zip(params["layers"], caches)):
        window, sinks = _layer_window(cfg, i)
        x = _chunk_layer(x, layer, pages, pos_t, first_positions,
                         total_lengths, _table_for(page_table, i), active, cfg,
                         compute_dtype, paged_write, window, sinks, mesh)
    return _logits(x, params, mesh), caches


def decode_step(params, tokens, positions, caches, page_table, active,
                cfg: TransformerConfig, *, mesh=None):
    """One decode step for all slots.  tokens [num_seqs] (last sampled token
    per slot), positions [num_seqs] (write position = current length),
    caches a list of per-layer KVPages (updated in place), page_table
    [num_seqs, pages_per_seq] int32, active [num_seqs] bool.  Returns
    (logits [num_seqs, vocab] fp32, caches).  `page_table` may be a
    per-layer list (_table_for).  With a mesh, this rank's block (the
    module's note)."""
    x = params["embed"][tokens].to(cfg.dtype)  # [n, d_model]
    pos2 = positions[:, None]
    attn_lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    compute_dtype = _compute_dtype(cfg)
    for i, (layer, pages) in enumerate(zip(params["layers"], caches)):
        window, sinks = _layer_window(cfg, i)
        x = _decode_layer(x, layer, pages, pos2, positions, attn_lengths,
                          _table_for(page_table, i), active, cfg, compute_dtype,
                          window, sinks, mesh)
    return _logits(x, params, mesh), caches
