"""Port parity: the DecodeEngine with window groups against the JAX engine,
greedy, at the tiny config with fp32 weights and an fp32 cache: the hybrid
cache (window 128, global_every 2) and the streaming cache (window 128 with
16 sink tokens) give the JAX engine's tokens exactly, with chunked prefill
(whose local group holds at most chunk + window + straddle pages) and with
speculation (k 3) by a one-layer windowed draft.  Shared setup:
tests/test_torch_window_decode.py."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from cuda_flash_attention_tpu.decode import engine as jax_engine
from cuda_flash_attention_tpu_torch.decode import engine
from test_torch_window_decode import (  # noqa: F401 (fixtures)
    PAGE,
    _engines,
    _prompt,
    hybrid,
    streaming,
)


@pytest.mark.parametrize("name", ["hybrid", "streaming"])
def test_greedy_tokens_match_jax(request, name):
    """Three prompts past the window (one length bucket) on two slots, the
    third queued: every token equals the JAX engine's, one-shot and with
    chunked prefill (chunk 128), whose local group never holds more than
    chunk + window + straddle pages of a slot while a global group holds
    every prompt page; every page returns to its pool."""
    model = request.getfixturevalue(name)
    eng_j, eng_t = _engines(model)
    prompts = [_prompt(300), _prompt(280, seed=4), _prompt(260, seed=5)]
    want = [r.generated for r in eng_j.run(prompts, max_new_tokens=6)]
    assert [r.generated for r in eng_t.run(prompts, max_new_tokens=6)] == want
    _, chunked = _engines(model, prefill_chunk=128)
    peak = [0] * chunked.n_groups
    step = chunked._chunk_prefill_step

    def spy():
        step()
        for s in range(chunked.max_seqs):
            for g in range(chunked.n_groups):
                peak[g] = max(peak[g], chunked._live_page_count(s, g))

    chunked._chunk_prefill_step = spy
    assert [r.generated for r in chunked.run(prompts, max_new_tokens=6)] == want
    assert peak[0] <= 3 and chunked.stats["prefill_chunks"] >= 3, peak
    if chunked.n_groups > 1:
        assert peak[1] == 3, peak
    for eng in (eng_t, chunked):
        for a in eng._group_allocs:
            assert a.available == a.num_pages - 1


def test_windowed_speculation_matches_jax(streaming):
    """Speculation (k 3) with a one-layer windowed draft on the streaming
    config gives the JAX engine's tokens."""
    cfg_j, cfg_t, params_j, params_t = streaming
    kw = dict(spec_tokens=3)
    eng_j, eng_t = (
        jax_engine.DecodeEngine(
            params_j, cfg_j, max_seqs=2, max_seq_len=1024, page_size=PAGE,
            cache_dtype=jnp.float32, draft_params=dict(params_j, layers=params_j["layers"][:1]),
            draft_cfg=dataclasses.replace(cfg_j, n_layers=1), **kw),
        engine.DecodeEngine(
            params_t, cfg_t, max_seqs=2, max_seq_len=1024, page_size=PAGE,
            cache_dtype=torch.float32, draft_params=dict(params_t, layers=params_t["layers"][:1]),
            draft_cfg=dataclasses.replace(cfg_t, n_layers=1), device="cpu", **kw))
    prompts = [_prompt(300), _prompt(280, seed=6)]
    want = [r.generated for r in eng_j.run(prompts, max_new_tokens=8)]
    got = eng_t.run(prompts, max_new_tokens=8)
    assert [r.generated for r in got] == want
    assert eng_t.stats["spec_rounds"] > 0
    assert eng_t.allocator.available == eng_t.num_pages - 1
