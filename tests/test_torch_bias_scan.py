"""Port parity of logit bias, repetition penalties and scanned layers in the
DecodeEngine, at the tiny config in fp32, mirroring tests/test_decode.py's
test_logit_bias_bans_and_pins_tokens (:395), test_logit_bias_under_
speculation (:417), test_frequency_penalty_blocks_repetition (:511),
test_scanned_decode_matches_loop (:583) and test_scanned_decode_with_
quantized_weights (:671).  Greedy tokens are compared exactly.  The port
runs scan_layers in the per-layer list form; the JAX engine stacks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu.decode import engine as jax_engine
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.quant import linear as jax_linear
from cuda_flash_attention_tpu_torch.decode import engine
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
PROMPT = [5, 7, 11]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j


def _engines(tiny, params_j=None, **kw):
    """The JAX engine and the port's on the same weights (int8 cache)."""
    cfg_j, cfg_t, base = tiny
    params_j = base if params_j is None else params_j
    common = dict(max_seqs=2, max_seq_len=512, page_size=PAGE)
    eng_j = jax_engine.DecodeEngine(params_j, cfg_j, cache_dtype=jnp.int8,
                                    **common, **kw)
    eng_t = engine.DecodeEngine(params_from_numpy(numpy_tree(params_j), "cpu"),
                                cfg_t, cache_dtype=torch.int8, device="cpu",
                                **common, **kw)
    return eng_j, eng_t


def _both(engines, prompts, **kw):
    eng_j, eng_t = engines
    want = [r.generated for r in eng_j.run(prompts, **kw)]
    got = [r.generated for r in eng_t.run(prompts, **kw)]
    assert got == want
    return got


def test_logit_bias_bans_and_pins_tokens(tiny):
    """-inf bans a token across prefill and decode steps; a huge bias pins
    every token; later unbiased requests are unaffected."""
    engines = _engines(tiny)
    (base,) = _both(engines, [PROMPT], max_new_tokens=6)
    banned = set(base)
    (r,) = _both(engines, [PROMPT], max_new_tokens=6,
                 logit_bias={t: float("-inf") for t in banned})
    assert not (set(r) & banned) and len(r) == 6
    (pinned,) = _both(engines, [PROMPT], max_new_tokens=4, logit_bias={42: 1e9})
    assert pinned == [42] * 4
    assert _both(engines, [PROMPT], max_new_tokens=6) == [base]
    assert engines[1]._bias is None
    with pytest.raises(ValueError, match="out of vocab"):
        engines[1].submit(PROMPT, logit_bias={256: 1.0})


def test_logit_bias_under_speculation(tiny):
    """Banned tokens stay banned through the verify path (greedy prompt
    lookup)."""
    prompt = [PROMPT * 8]
    (base,) = _both(_engines(tiny), prompt, max_new_tokens=8)
    banned = {base[0], base[1]}
    (r,) = _both(_engines(tiny, spec_tokens=3, spec_mode="prompt_lookup"), prompt,
                 max_new_tokens=8, logit_bias={t: float("-inf") for t in banned})
    assert not (set(r) & banned) and len(r) == 8


def test_frequency_penalty_blocks_repetition(tiny):
    """A huge frequency penalty forbids re-emitting a token; a zero
    presence penalty changes nothing; finite penalties give the JAX
    engine's tokens."""
    engines = _engines(tiny)
    (r,) = _both(engines, [PROMPT], max_new_tokens=12, frequency_penalty=1e9)
    assert len(set(r)) == 12
    (base,) = _both(engines, [PROMPT], max_new_tokens=6)
    assert _both(engines, [PROMPT], max_new_tokens=6, presence_penalty=0.0) == [base]
    _both(engines, [PROMPT, [2, 3]], max_new_tokens=6, presence_penalty=0.5,
          frequency_penalty=0.25)


@pytest.mark.parametrize("weights", [None, "int8", "w8a8"])
def test_scanned_decode_matches_loop(tiny, weights):
    """DecodeEngine(scan_layers=True) gives the JAX scanned engine's greedy
    tokens (quantize, then stack there), and the port's plain engine's: the
    port runs scan_layers in the list form."""
    _, cfg_t, params_j = tiny
    if weights is not None:
        params_j = jax_linear.quantize_transformer_params(
            params_j, jnp.int8, act_quant=weights == "w8a8")
    params_t = params_from_numpy(numpy_tree(params_j), "cpu")
    engines = _engines(tiny, params_j, scan_layers=True)
    assert engines[0]._scanned and isinstance(engines[1].caches, list)
    got = _both(engines, [PROMPT, [2, 3, 200, 17, 9]], max_new_tokens=5)
    plain = engine.DecodeEngine(params_t, cfg_t, max_seqs=2, max_seq_len=512,
                                cache_dtype=torch.int8, device="cpu")
    assert [r.generated for r in plain.run(
        [PROMPT, [2, 3, 200, 17, 9]], max_new_tokens=5)] == got


def test_scanned_draft_speculation_matches_jax(tiny):
    """scan_layers with a one-layer draft model (k = 3): the JAX engine
    stacks target and draft, the port runs both as lists; greedy tokens
    are equal."""
    cfg_j, cfg_t, params_j = tiny
    draft_j = jax_tf.init_params(jax.random.PRNGKey(9),
                                 dataclasses.replace(cfg_j, n_layers=1))
    common = dict(max_seqs=2, max_seq_len=512, page_size=PAGE, spec_tokens=3,
                  scan_layers=True)
    eng_j = jax_engine.DecodeEngine(
        params_j, cfg_j, cache_dtype=jnp.int8, draft_params=draft_j,
        draft_cfg=dataclasses.replace(cfg_j, n_layers=1), **common)
    eng_t = engine.DecodeEngine(
        params_from_numpy(numpy_tree(params_j), "cpu"), cfg_t,
        cache_dtype=torch.int8, device="cpu",
        draft_params=params_from_numpy(numpy_tree(draft_j), "cpu"),
        draft_cfg=dataclasses.replace(cfg_t, n_layers=1), **common)
    assert eng_j._scanned and eng_j._draft_scanned
    got = _both((eng_j, eng_t), [PROMPT, [2, 3, 200, 17, 9]], max_new_tokens=6)
    assert all(len(g) == 6 for g in got)
