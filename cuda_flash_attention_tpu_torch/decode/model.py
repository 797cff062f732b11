"""Decode-mode model functions: prefill (the K/V that fill the paged cache)
and the single-token decode step over paged attention.

Counterpart of cuda_flash_attention_tpu/decode/model.py in its per-layer
list form (caches are a list of KVPages, params["layers"] a list).  The
scanned (stacked) form, verify_step and meshes are not ported yet.  The
decode step appends to the caches in place.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.decode.attention import paged_decode_attention
from cuda_flash_attention_tpu_torch.decode.kv_cache import append_token_kv
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    attention_block,
    ffn_block,
    rms_norm,
    rope,
)
from cuda_flash_attention_tpu_torch.quant.linear import dense


def prefill_forward(params, tokens, cfg: TransformerConfig,
                    last_only: bool = False):
    """Full causal forward over a prompt batch [B, S]; returns
    (logits [B, S, vocab] fp32, kv) where kv is a per-layer list of post-RoPE
    (k, v) [B, S, Hkv, D].  With last_only, only the last position's logits
    ([B, 1, vocab])."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    kv_out = []
    for i, layer in enumerate(params["layers"]):
        x, kv = attention_block(x, layer, positions, cfg,
                                window=cfg.layer_window(i))
        x, _ = ffn_block(x, layer, cfg)
        kv_out.append(kv)
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:, :]
    return dense(x, params["lm_head"]).float(), kv_out


def _decode_layer(x, layer, pages, pos2, positions, attn_lengths, page_table,
                  active, cfg: TransformerConfig, compute_dtype):
    """One decode layer: append this token's K/V to `pages` (in place),
    attend over the pages, then the FFN."""
    n = x.shape[0]
    h = rms_norm(x, layer["attn_norm"])
    q = dense(h, layer["wq"]).reshape(n, 1, cfg.n_heads, cfg.head_dim)
    k = dense(h, layer["wk"]).reshape(n, 1, cfg.n_kv_heads, cfg.head_dim)
    v = dense(h, layer["wv"]).reshape(n, 1, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, pos2, *cfg.rope_args)[:, 0]  # [n, Hq, D]
    k = rope(k, pos2, *cfg.rope_args)[:, 0]  # [n, Hkv, D]
    append_token_kv(pages, k, v[:, 0], page_table, positions, active)
    o = paged_decode_attention(q.to(cfg.dtype), pages, page_table,
                               attn_lengths, compute_dtype=compute_dtype)
    x = x + dense(o.reshape(n, cfg.q_dim), layer["wo"])
    x, _ = ffn_block(x, layer, cfg)
    return x


def decode_step(params, tokens, positions, caches, page_table, active,
                cfg: TransformerConfig):
    """One decode step for all slots.  tokens [num_seqs] (last sampled token
    per slot), positions [num_seqs] (write position = current length),
    caches a list of per-layer KVPages (updated in place), page_table
    [num_seqs, pages_per_seq] int32, active [num_seqs] bool.  Returns
    (logits [num_seqs, vocab] fp32, caches)."""
    if cfg.attn_window is not None:
        raise NotImplementedError("windowed decode is not ported yet")
    x = params["embed"][tokens].to(cfg.dtype)  # [n, d_model]
    pos2 = positions[:, None]
    attn_lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    compute_dtype = (
        torch.float32 if cfg.attn_tile_dtype is None else torch.bfloat16
    )
    for layer, pages in zip(params["layers"], caches):
        x = _decode_layer(x, layer, pages, pos2, positions, attn_lengths,
                          page_table, active, cfg, compute_dtype)
    x = rms_norm(x, params["final_norm"])
    return dense(x, params["lm_head"]).float(), caches
