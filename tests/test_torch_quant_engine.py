"""Port parity of quantized serving: the port's DecodeEngine gives the JAX
engine's greedy tokens at the tiny config (fp32) with an fp8 cache, an int4
cache, int8 W8A8 weights on an int8 cache and int4 weights, and a
prompt-lookup speculative run on an int4 cache (as tests/test_int4_kv.py:139)
runs its verify rounds over packed pages to the same tokens."""

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

# Two prompts of one prefill bucket: each JAX engine compiles once.
PROMPTS = [[5, 7, 11], [2, 3, 200, 17, 9]]
NEW_TOKENS = 5


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j


MODES = {
    "fp8_cache": (None, jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "int4_cache": (None, "int4", "int4"),
    "w8a8_int8_cache": ((jnp.int8, True), jnp.int8, torch.int8),
    "int4_weights": (("int4", False), jnp.int8, torch.int8),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_tokens_match_jax_engine(tiny, mode):
    cfg_j, cfg_t, params_j = tiny
    weights, cache_j, cache_t = MODES[mode]
    if weights is not None:
        params_j = jax_linear.quantize_transformer_params(
            params_j, weights[0], act_quant=weights[1])
    params_t = params_from_numpy(numpy_tree(params_j), "cpu")
    want = [r.generated for r in jax_engine.DecodeEngine(
        params_j, cfg_j, max_seqs=2, max_seq_len=256, page_size=128,
        cache_dtype=cache_j).run(PROMPTS, max_new_tokens=NEW_TOKENS)]
    eng = engine.DecodeEngine(params_t, cfg_t, max_seqs=2, max_seq_len=256,
                              page_size=128, cache_dtype=cache_t, device="cpu")
    got = [r.generated for r in eng.run(PROMPTS, max_new_tokens=NEW_TOKENS)]
    assert got == want
    assert eng.allocator.available == eng.num_pages - 1


def test_int4_cache_speculative_lookup(tiny):
    cfg_j, cfg_t, params_j = tiny
    prompt = [[5, 7, 11] * 6]
    kw = dict(max_seqs=1, max_seq_len=256, cache_dtype="int4", spec_tokens=2,
              spec_mode="prompt_lookup")
    want = jax_engine.DecodeEngine(params_j, cfg_j, **kw).run(
        prompt, max_new_tokens=6)[0].generated
    eng = engine.DecodeEngine(params_from_numpy(numpy_tree(params_j), "cpu"),
                              cfg_t, device="cpu", **kw)
    (req,) = eng.run(prompt, max_new_tokens=6)
    assert req.done and req.generated == want
    assert eng.stats["spec_rounds"] > 0
    assert eng.pages_per_seq > 0 and eng.caches[0].k_pages.shape[-1] == cfg_t.head_dim // 2
    assert np.all(eng.lengths == 0)
