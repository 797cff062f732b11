"""Port parity at head dim 256 end to end: a tiny hybrid model (2 layers,
window 32 on every other layer, global_every 2, q_dim 1024 beside d_model
128, fp32 weights) served by the port's DecodeEngine and by the JAX
engine on an int8 cache (the cache the card serves from; the kernels take
no fp32 cache at D 256): the greedy tokens are equal.  The kernels at D
256 (B1, B5, B6) are compared with the JAX package's in
tests/test_torch_head_dims.py, and held to their plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py phases 27-28,
which serve the Gemma-2-2B-width configuration."""

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


@pytest.fixture(scope="module")
def hybrid256():
    kw = dict(head_dim=256, attn_window=32, global_every=2)
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(), dtype=jnp.float32,
                                attn_tile_dtype=None, **kw)
    cfg_t = dataclasses.replace(
        transformer.TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None), **kw)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_hybrid_d256_engine_matches_jax(hybrid256):
    """Greedy tokens of three prompts of 40-96 tokens on two slots (the
    third queued), 8 new tokens each, with the layers' window groups, equal
    the JAX engine's on an int8 cache; every page returns to its pool."""
    cfg_j, cfg_t, params_j, params_t = hybrid256
    assert cfg_t.q_dim == 1024 != cfg_t.d_model
    args = dict(max_seqs=2, max_seq_len=256, page_size=PAGE)
    eng_j = jax_engine.DecodeEngine(params_j, cfg_j, cache_dtype=jnp.int8, **args)
    eng_t = engine.DecodeEngine(params_t, cfg_t, cache_dtype=torch.int8, device="cpu",
                                **args)
    assert eng_t._group_windows == eng_j._group_windows == [32, None]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, n).tolist() for n in (96, 40, 71)]
    want = [r.generated for r in eng_j.run(prompts, max_new_tokens=8)]
    assert [r.generated for r in eng_t.run(prompts, max_new_tokens=8)] == want
    for a in eng_t._group_allocs:
        assert a.available == a.num_pages - 1
