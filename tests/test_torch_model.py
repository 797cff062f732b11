"""Port parity: the transformer building blocks, prefill and the paged decode
step of cuda_flash_attention_tpu_torch against the JAX package's, with the
JAX parameters carried across by params_from_numpy, at
TransformerConfig.tiny() in fp32 (attn_tile_dtype=None) with an int8 KV
cache.  Logits and K/V must agree to 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu.decode import model as jax_model
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import kv_cache, model
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_params_from_numpy_keeps_the_tree(tiny):
    _, _, params_j, params_t = tiny
    assert len(params_t["layers"]) == len(params_j["layers"])
    for name, leaf in params_j["layers"][1].items():
        np.testing.assert_array_equal(params_t["layers"][1][name].numpy(),
                                      np.asarray(leaf))
    bf16 = params_from_numpy({"w": np.asarray(jnp.ones((2, 2), jnp.bfloat16) / 3)},
                             "cpu")
    assert bf16["w"].dtype == torch.bfloat16


def test_rope_frequencies_within_one_ulp_of_jax():
    """Same expression, exp(-log(theta) * arange / half) in fp32; XLA's and
    PyTorch's fp32 exp differ by at most one ulp on some of its values."""
    half = 32
    want = np.asarray(jnp.exp(
        -jnp.log(10000.0) * jnp.arange(0, half, dtype=jnp.float32) / half))
    got = torch.exp(-torch.log(torch.tensor(10000.0))
                    * torch.arange(0, half, dtype=torch.float32) / half)
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("theta,pos_scale", [(10000.0, 1.0), (500000.0, 4.0)])
def test_rope_matches_jax(theta, pos_scale):
    """A one-ulp frequency difference moves an angle by at most
    pos * 2^-23 rad, so the output may differ by |x| * max_pos * 2^-23."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    max_pos = 512
    pos = rng.integers(0, max_pos, (2, 9)).astype(np.int32)
    want = jax_tf.rope(jnp.asarray(x), jnp.asarray(pos), theta, pos_scale)
    got = transformer.rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                           theta, pos_scale)
    tol = 2 * np.abs(x).max() * max_pos * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    scale = rng.standard_normal(128).astype(np.float32)
    want = jax_tf.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    got = transformer.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_forward_matches_jax(tiny):
    cfg_j, cfg_t, params_j, params_t = tiny
    tokens = np.random.default_rng(2).integers(0, 256, (2, 40)).astype(np.int32)
    want = jax_tf.forward(params_j, jnp.asarray(tokens), cfg_j)
    got = transformer.forward(params_t, torch.from_numpy(tokens).long(), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_prefill_then_decode_steps_match_jax(tiny):
    cfg_j, cfg_t, params_j, params_t = tiny
    rng = np.random.default_rng(3)
    # Two prompts in one 128-token bucket (slot 0 ragged at 100), plus an
    # inactive third slot.
    prompt_lens = [100, 128]
    tokens = np.zeros((2, PAGE), np.int32)
    for i, n in enumerate(prompt_lens):
        tokens[i, :n] = rng.integers(0, 256, n)
    logits_j, kv_j = jax_model.prefill_forward(params_j, jnp.asarray(tokens), cfg_j)
    logits_t, kv_t = model.prefill_forward(params_t, torch.from_numpy(tokens).long(),
                                           cfg_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=TOL, rtol=0)
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=TOL, rtol=0)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=TOL, rtol=0)

    table = np.array([[1, 0], [2, 3], [0, 0]], np.int32)
    caches_j, caches_t = [], []
    for (kj, vj), (kt, vt) in zip(kv_j, kv_t):
        pj = jax_kv.init_kv_pages(cfg_j.n_kv_heads, 5, PAGE, cfg_j.head_dim, jnp.int8)
        pt = kv_cache.init_kv_pages(cfg_t.n_kv_heads, 5, PAGE, cfg_t.head_dim,
                                    torch.int8, device="cpu")
        for slot in range(2):
            ids = table[slot, :1]
            pj = jax_kv.write_prompt_kv(pj, kj[slot], vj[slot], jnp.asarray(ids))
            pt = kv_cache.write_prompt_kv(pt, kt[slot], vt[slot],
                                          torch.from_numpy(ids))
        caches_j.append(pj)
        caches_t.append(pt)

    lengths = np.array(prompt_lens + [0], np.int32)
    active = np.array([True, True, False])
    last = np.asarray(logits_j)[np.arange(2), np.array(prompt_lens) - 1]
    next_tok = np.append(last.argmax(-1), 0).astype(np.int32)
    for _ in range(3):
        lj, caches_j = jax_model.decode_step(
            params_j, jnp.asarray(next_tok), jnp.asarray(lengths), caches_j,
            jnp.asarray(table), jnp.asarray(active), cfg_j)
        lt, caches_t = model.decode_step(
            params_t, torch.from_numpy(next_tok).long(),
            torch.from_numpy(lengths).long(), caches_t,
            torch.from_numpy(table), torch.from_numpy(active), cfg_t)
        lj = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy()[:2], lj[:2], atol=TOL, rtol=0)
        next_tok = lj.argmax(-1).astype(np.int32)
        lengths = lengths + active
