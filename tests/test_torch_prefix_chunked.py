"""Port parity: chunked prefill, prefix caching and cancel in the PyTorch
DecodeEngine against the JAX package, at TransformerConfig.tiny() in fp32
with an fp32 cache (as tests/test_chunked_prefill.py and
tests/test_prefix_cache.py hold the JAX engine: the one-shot and chunked
paths run different programs, whose bf16 logits can tie differently).
Greedy tokens must equal the JAX engine's one-shot, uncached tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import DecodeEngine as JaxEngine
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
_RNG = np.random.default_rng(3)
LONG = _RNG.integers(0, 256, 300).tolist()
PREFIX = _RNG.integers(0, 200, 2 * PAGE).tolist()
A, B = PREFIX + [11, 12, 13], PREFIX + [99, 98]
LONG_SUFFIX = PREFIX[:PAGE] + _RNG.integers(0, 200, 300).tolist()


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                             attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params_j), "cpu")


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """The JAX engine's one-shot, uncached greedy tokens."""
    cfg_j, params_j, _, _ = tiny

    def run(prompts, n):
        eng = JaxEngine(params_j, cfg_j, max_seqs=2, max_seq_len=512,
                        page_size=PAGE, cache_dtype=jnp.float32)
        return [r.generated for r in eng.run(prompts, max_new_tokens=n)]
    a, b = run([A, B], 4)
    return {"long": run([LONG], 6)[0], "a": a, "b": b,
            "long_suffix": run([LONG_SUFFIX], 4)[0]}


def _engine(tiny, **kw):
    _, _, cfg, params = tiny
    return DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512,
                        page_size=PAGE, cache_dtype=torch.float32,
                        device="cpu", **kw)


def test_chunked_prefill_matches_jax_one_shot(tiny, jax_tokens):
    eng = _engine(tiny, prefill_chunk=128)
    (req,) = eng.run([LONG], max_new_tokens=6)
    assert req.done and req.generated == jax_tokens["long"]
    assert eng.stats["prefill_chunks"] >= 3  # 300 tokens in 128-token chunks
    assert eng.allocator.available == eng.num_pages - 1


def test_chunked_prefill_with_speculation_matches(tiny, jax_tokens):
    """The draft's cache mirrors every prompt chunk."""
    _, _, cfg, params = tiny
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    eng = _engine(tiny, prefill_chunk=128, spec_tokens=3, draft_cfg=draft_cfg,
                  draft_params=dict(params, layers=params["layers"][:1]))
    (req,) = eng.run([LONG], max_new_tokens=6)
    assert req.generated == jax_tokens["long"]
    assert eng.stats["prefill_chunks"] >= 3 and eng.stats["spec_rounds"] > 0
    assert eng.allocator.available == eng.num_pages - 1


def test_short_prompts_skip_chunking(tiny):
    eng = _engine(tiny, prefill_chunk=128)
    eng.run([LONG[:50]], max_new_tokens=3)
    assert eng.stats["prefill_chunks"] == 0


def test_decode_continues_during_chunked_prefill(tiny):
    """A decoding request emits a token on every step while a 400-token
    prompt is still prefilling chunk by chunk."""
    eng = _engine(tiny, prefill_chunk=128)
    short = eng.submit(LONG[:8], max_new_tokens=20)
    eng.step()
    long_req = eng.submit((LONG + LONG)[:400], max_new_tokens=4)
    assert eng.prefilling[long_req.slot]
    grew = 0
    while eng.prefilling.any():
        before = len(short.generated)
        eng.step()
        grew += len(short.generated) > before
    assert grew >= 3  # one token per chunk step, four chunks
    while not (short.done and long_req.done):
        eng.step()
    assert len(short.generated) == 20 and len(long_req.generated) == 4
    eng.step()
    assert eng.allocator.available == eng.num_pages - 1


def test_chunked_prefill_max_new_one_stops_at_prefill(tiny):
    eng = _engine(tiny, prefill_chunk=128)
    (req,) = eng.run([LONG], max_new_tokens=1)
    assert req.done and len(req.generated) == 1
    assert eng.allocator.available == eng.num_pages - 1


def test_prefill_chunk_must_be_page_aligned(tiny):
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(tiny, prefill_chunk=100)


def test_prefix_hit_shares_pages_and_matches_uncached(tiny, jax_tokens):
    eng = _engine(tiny, prefix_cache=True)
    eng.submit(A, max_new_tokens=4)
    eng.step()  # prefills A, registering its 2 full prompt pages
    avail = eng.allocator.available
    eng.submit(B, max_new_tokens=4)
    # B needed exactly one new page (its padded suffix); the two prefix
    # pages are shared, not copied.
    assert avail - eng.allocator.available == 1
    assert eng._slot_pages[1][:2] == eng._slot_pages[0][:2]
    assert all(eng.allocator.refcount(p) == 2 for p in eng._slot_pages[0][:2])
    done = []
    while len(done) < 2:
        done.extend(eng.step())
    out = {tuple(r.prompt): r.generated for r in done}
    assert out == {tuple(A): jax_tokens["a"], tuple(B): jax_tokens["b"]}


def test_prefix_pages_outlive_their_owner(tiny):
    """A retires while B, sharing A's prefix pages, still generates: the
    refcount keeps the pages; at the end every page is back and the maps
    are empty (the on_last_free hook dropped the entries)."""
    eng = _engine(tiny, prefix_cache=True)
    eng.submit(A, max_new_tokens=2)
    eng.step()
    eng.submit(B, max_new_tokens=8)
    shared = eng._slot_pages[0][:2]
    done = []
    for _ in range(16):
        done.extend(eng.step())
        if done and len(done) == 1:
            assert all(eng.allocator.refcount(p) == 1 for p in shared)
        if len(done) == 2:
            break
    assert len(done) == 2 and all(r.done for r in done)
    assert eng.allocator.available == eng.num_pages - 1
    assert eng._prefix_maps == {} and eng._page_keys == {}


def test_prefix_misses_still_register(tiny):
    eng = _engine(tiny, prefix_cache=True)
    rng = np.random.default_rng(1)
    eng.submit_many([rng.integers(0, 200, PAGE + 5).tolist() for _ in range(2)],
                    max_new_tokens=2)
    assert len(eng._prefix_maps) == 2


def test_exact_page_multiple_prompt_leaves_a_suffix(tiny):
    """A fully cached prompt of whole pages still runs its last page as
    the suffix (the first token needs a query position)."""
    eng = _engine(tiny, prefix_cache=True)
    first = eng.submit(PREFIX, max_new_tokens=2)
    assert len(eng._prefix_hits(PREFIX)) == 1
    second = eng.submit(list(PREFIX), max_new_tokens=2)
    while not (first.done and second.done):
        eng.step()
    assert first.generated == second.generated


def test_prefix_hit_with_long_suffix_routes_through_chunks(tiny, jax_tokens):
    """A hit whose uncached suffix (300 tokens) is longer than the chunk
    prefills that suffix chunk by chunk from the shared page."""
    eng = _engine(tiny, prefix_cache=True, prefill_chunk=256)
    # A one-chunk seed request holds the head page while the next admits.
    seed = eng.submit(PREFIX[:PAGE] + [7, 8], max_new_tokens=8)
    before = eng.stats["prefill_chunks"]
    req = eng.submit(LONG_SUFFIX, max_new_tokens=4)
    assert eng.prefilling[req.slot] and eng._slot_pages[req.slot][:1] == \
        eng._slot_pages[seed.slot][:1]
    while not (req.done and seed.done):
        eng.step()
    assert req.generated == jax_tokens["long_suffix"]
    assert eng.stats["prefill_chunks"] > before
    eng.step()
    assert eng.allocator.available == eng.num_pages - 1


def test_generate_n_shares_the_prompt_and_ranks(tiny):
    eng = _engine(tiny, prefix_cache=True, temperature=0.9, logprobs=True,
                  seed=4)
    reqs = eng.generate_n(A, 3, max_new_tokens=4)
    assert len(reqs) == 3 and all(len(r.generated) == 4 for r in reqs)
    totals = [sum(r.logprobs) for r in reqs]
    assert totals == sorted(totals, reverse=True)
    assert eng.allocator.available == eng.num_pages - 1
    with pytest.raises(ValueError, match="logprobs"):
        _engine(tiny).generate_n(A, 2)


def test_cancel_mid_prefill_frees_the_slot(tiny):
    """Cancelling a request between its prefill chunks stops the chunks and
    returns its pages; a running decode is unaffected; a queued request
    leaves the queue at once."""
    eng = _engine(tiny, prefill_chunk=128)
    short = eng.submit(LONG[:8], max_new_tokens=6)
    long_req = eng.submit(LONG, max_new_tokens=4)
    queued = eng.submit(LONG[:20], max_new_tokens=2)
    assert queued.slot is None
    eng.step()  # first chunk of the long prompt
    assert eng.prefilling[long_req.slot]
    chunks = eng.stats["prefill_chunks"]
    assert eng.cancel(long_req) and eng.cancel(queued)
    assert not eng.cancel(long_req)  # already finished
    finished = eng.step()
    assert long_req in finished and not eng.prefilling.any()
    assert eng.stats["prefill_chunks"] == chunks
    while not short.done:
        eng.step()
    eng.step()
    assert len(short.generated) == 6 and len(long_req.generated) == 0
    assert queued.slot is None and eng.allocator.available == eng.num_pages - 1
