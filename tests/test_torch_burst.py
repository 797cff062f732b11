"""Port parity of decode bursts (DecodeEngine(decode_burst > 1)): the port's
bursts give the JAX engine's greedy tokens at the tiny config in fp32 with an
int8 cache, mirroring the burst tests of tests/test_decode.py (:759-852).
On the CPU the burst's step runs eagerly n times; the card tests
(tests/test_torch_kernels_gpu.py) replay it as a CUDA graph.

Tokens are compared exactly; log-probabilities within 1e-5 between the
port's burst and per-token paths (the JAX test's gate) and within 1e-4
against the JAX engine (fp32, different op orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import engine as jax_engine
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import engine
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
PROMPTS = [[5, 7, 11], [2, 3]]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _jax(tiny, **kw):
    cfg_j, _, params_j, _ = tiny
    return jax_engine.DecodeEngine(params_j, cfg_j, max_seqs=2, max_seq_len=512,
                                   page_size=PAGE, cache_dtype=jnp.int8, **kw)


def _port(tiny, **kw):
    _, cfg_t, _, params_t = tiny
    return engine.DecodeEngine(params_t, cfg_t, max_seqs=2, max_seq_len=512,
                               page_size=PAGE, cache_dtype=torch.int8,
                               device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_base(tiny):
    """The JAX engine's per-token greedy run of PROMPTS[0], 8 tokens."""
    return _jax(tiny).run([PROMPTS[0]], max_new_tokens=8)[0].generated


def test_burst_decode_matches_plain_greedy(tiny):
    """decode_burst=4 gives the JAX burst engine's tokens and the port's own
    per-token tokens and logprobs, with budgets (6) not a burst multiple."""
    want = _jax(tiny, logprobs=True, decode_burst=4).run(PROMPTS, max_new_tokens=6)
    plain = _port(tiny, logprobs=True).run(PROMPTS, max_new_tokens=6)
    eng = _port(tiny, logprobs=True, decode_burst=4)
    got = eng.run(PROMPTS, max_new_tokens=6)
    for a, b, w in zip(plain, got, want):
        assert a.generated == b.generated == w.generated
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-5)
        np.testing.assert_allclose(b.logprobs, w.logprobs, atol=1e-4)
    assert eng.stats["burst_dispatches"] > 0
    assert eng.allocator.available == eng.num_pages - 1


def test_burst_decode_eos_and_stop_mid_burst(tiny, jax_base):
    """EOS or a stop sequence mid-burst truncates there, and the slot frees."""
    base = _port(tiny).run([PROMPTS[0]], max_new_tokens=8)[0].generated
    assert base == jax_base
    eos = base[2]
    eng = _port(tiny, decode_burst=4)
    r = eng.run([PROMPTS[0]], max_new_tokens=8, eos_id=eos)[0]
    assert r.generated == base[: base.index(eos) + 1]
    assert eng.allocator.available == eng.num_pages - 1
    r3 = _port(tiny, decode_burst=4).run([PROMPTS[0]], max_new_tokens=8,
                                         stop=[base[1:3]])[0]
    assert r3.generated == base[:3]


def test_burst_decode_sampled_finite_and_budgeted(tiny):
    """Sampled bursts: budgets held, logprobs finite and <= 0, the same
    seed repeats its tokens and another seed draws others."""
    kw = dict(temperature=0.8, logprobs=True, decode_burst=3)
    reqs = _port(tiny, seed=1, **kw).run(PROMPTS, max_new_tokens=5)
    for r in reqs:
        assert len(r.generated) == 5
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in r.logprobs)
    again = _port(tiny, seed=1, **kw).run(PROMPTS, max_new_tokens=5)
    assert [r.generated for r in again] == [r.generated for r in reqs]
    other = _port(tiny, seed=2, temperature=5.0, decode_burst=3).run(
        PROMPTS, max_new_tokens=5)
    hot = _port(tiny, seed=1, temperature=5.0, decode_burst=3).run(
        PROMPTS, max_new_tokens=5)
    assert [r.generated for r in other] != [r.generated for r in hot]


def test_burst_decode_penalties_on_device_match_plain(tiny):
    """Penalties replay on the device inside the burst: the JAX per-token
    engine's tokens, with burst dispatches; a penalized and a plain request
    share the same bursts."""
    pen = dict(presence_penalty=0.5, frequency_penalty=0.25)
    want = [r.generated for r in _jax(tiny).run(PROMPTS, max_new_tokens=6, **pen)]
    assert [r.generated for r in _port(tiny).run(
        PROMPTS, max_new_tokens=6, **pen)] == want
    eng = _port(tiny, decode_burst=4)
    assert [r.generated for r in eng.run(PROMPTS, max_new_tokens=6, **pen)] == want
    assert eng.stats["burst_dispatches"] > 0

    eng3 = _port(tiny, decode_burst=4)
    r1 = eng3.submit(PROMPTS[0], max_new_tokens=6, presence_penalty=0.5)
    r2 = eng3.submit(PROMPTS[1], max_new_tokens=6)
    while not (r1.done and r2.done):
        eng3.step()
    jeng = _jax(tiny)
    assert r1.generated == jeng.run([PROMPTS[0]], max_new_tokens=6,
                                    presence_penalty=0.5)[0].generated
    assert r2.generated == jeng.run([PROMPTS[1]], max_new_tokens=6)[0].generated


def test_burst_decode_interleaves_chunked_prefill(tiny):
    """While a long prompt chunks in, decoding slots advance in bursts
    capped at prefill_burst_cap; the tokens are the JAX per-token
    engine's."""
    # The JAX test's prompt runs 1..258, past the tiny vocab (256), which
    # the JAX gather clamps and the port refuses: the same length, in vocab.
    long_prompt = [1 + t % 250 for t in range(2 * PAGE + 2)]
    prompts = [PROMPTS[0], long_prompt]
    want = [r.generated for r in _jax(tiny, prefill_chunk=PAGE).run(
        prompts, max_new_tokens=6)]
    eng = _port(tiny, prefill_chunk=PAGE, decode_burst=4, prefill_burst_cap=2)
    got = eng.run(prompts, max_new_tokens=6)
    assert [r.generated for r in got] == want
    assert eng.stats["burst_dispatches"] > 0 and eng.stats["prefill_chunks"] > 0


def test_burst_decode_logit_bias_stays_fast_path(tiny, jax_base):
    """A static logit_bias holds inside bursts, the burst path runs, and the
    tokens are the JAX engine's."""
    banned = set(jax_base[:6])
    bias = {t: float("-inf") for t in banned}
    want = _jax(tiny).run([PROMPTS[0]], max_new_tokens=6, logit_bias=bias)[0]
    eng = _port(tiny, decode_burst=4)
    assert eng.run([PROMPTS[0]], max_new_tokens=6)[0].generated == jax_base[:6]
    before = eng.stats["burst_dispatches"]
    r = eng.run([PROMPTS[0]], max_new_tokens=6, logit_bias=bias)[0]
    assert not (set(r.generated) & banned)
    assert r.generated == want.generated
    assert eng.stats["burst_dispatches"] > before
    assert eng._bias is None  # the last biased request retired
