"""Port parity: verify_step of cuda_flash_attention_tpu_torch against the
JAX package's, with the JAX parameters carried across by params_from_numpy,
at TransformerConfig.tiny() in fp32 (attn_tile_dtype=None) over an fp32
paged cache.  Logits and every cache tensor after each step must agree to
1e-4, as tests/test_torch_model.py holds prefill and decode."""

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
NUM_PAGES = 8
# Slots 0 and 2 active, slot 1 inactive (it must attend nothing).
TABLE = np.array([[2, 5, 7], [0, 0, 0], [3, 1, 6]], np.int32)
ACTIVE = np.array([True, False, True])


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _caches(cfg_j, cfg_t):
    shape = (cfg_j.n_kv_heads, NUM_PAGES, PAGE, cfg_j.head_dim)
    cj = [jax_kv.init_kv_pages(*shape, jnp.float32) for _ in range(cfg_j.n_layers)]
    ct = [kv_cache.init_kv_pages(*shape, torch.float32, device="cpu")
          for _ in range(cfg_t.n_layers)]
    return cj, ct


def _step(tiny, caches, tokens, first, paged_write):
    cfg_j, cfg_t, params_j, params_t = tiny
    cj, ct = caches
    lj, cj = jax_model.verify_step(
        params_j, jnp.asarray(tokens, jnp.int32), jnp.asarray(first, jnp.int32),
        cj, jnp.asarray(TABLE), jnp.asarray(ACTIVE), cfg_j,
        paged_write=paged_write)
    lt, ct_out = model.verify_step(
        params_t, torch.from_numpy(tokens).long(), torch.from_numpy(first).long(),
        ct, torch.from_numpy(TABLE), torch.from_numpy(ACTIVE), cfg_t,
        paged_write=paged_write)
    assert ct_out is ct  # the caches are updated in place
    assert lt.shape == (3, tokens.shape[1], cfg_t.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL, rtol=0)
    for pj, pt in zip(cj, ct):
        for name in ("k_pages", "k_scales", "v_pages", "v_scales"):
            # Page 0 is the null page the inactive slot writes.
            np.testing.assert_allclose(getattr(pt, name).numpy()[:, 1:],
                                       np.asarray(getattr(pj, name))[:, 1:],
                                       atol=TOL, rtol=0, err_msg=name)
    return (cj, ct), np.asarray(lj)


@pytest.mark.parametrize("paged_write", [True, False],
                         ids=["paged-write", "per-token-appends"])
def test_verify_step_matches_jax(tiny, paged_write):
    """A whole-page prefill chunk (the paged write at page-aligned starts
    0 and 128), then a 5-token speculative chunk that starts at 254 in slot
    2 (crossing into its third page).  With paged_write=False the prefill
    chunk goes through the per-token appends as well."""
    rng = np.random.default_rng(0)
    caches = _caches(tiny[0], tiny[1])
    caches, _ = _step(tiny, caches, rng.integers(0, 256, (3, PAGE)),
                      np.array([0, 0, 0]), paged_write)
    if paged_write:  # slot 2's second page, from 128
        caches, _ = _step(tiny, caches, rng.integers(0, 256, (3, PAGE)),
                          np.array([PAGE, 0, PAGE]), True)
        first = np.array([PAGE, 0, 2 * PAGE - 2])
    else:
        first = np.array([PAGE, 0, PAGE - 2])
    _step(tiny, caches, rng.integers(0, 256, (3, 5)), first, False)


def test_verify_of_one_token_equals_decode_step(tiny):
    """T = 1 verify and the decode step compute the same logits."""
    _, cfg_t, _, params_t = tiny
    rng = np.random.default_rng(1)
    _, ct = _caches(tiny[0], cfg_t)
    table, active = torch.from_numpy(TABLE), torch.from_numpy(ACTIVE)
    model.verify_step(params_t, torch.from_numpy(rng.integers(0, 256, (3, PAGE))),
                      torch.zeros(3, dtype=torch.long), ct, table, active, cfg_t,
                      paged_write=True)
    saved = [kv_cache.KVPages(*(t.clone() for t in (c.k_pages, c.k_scales,
                                                     c.v_pages, c.v_scales)))
             for c in ct]
    tok = torch.from_numpy(rng.integers(0, 256, 3))
    pos = torch.tensor([PAGE - 3, 0, 40])
    lv, _ = model.verify_step(params_t, tok[:, None], pos, ct, table, active, cfg_t)
    ld, _ = model.decode_step(params_t, tok, pos, saved, table, active, cfg_t)
    np.testing.assert_allclose(lv[:, 0].numpy(), ld.numpy(), atol=TOL, rtol=0)


def test_windowed_verify_raises(tiny):
    """Refused until sliding windows were ported: windowed verification
    (window 64 with 4 sinks on the local layers, global_every 2) now gives
    JAX's logits, and a per-layer list of tables (the hybrid cache's form)
    the same as one table."""
    cfg_j, cfg_t, params_j, params_t = tiny
    win = dict(attn_window=64, attn_sinks=4, global_every=2)
    windowed = (dataclasses.replace(cfg_j, **win), dataclasses.replace(cfg_t, **win),
                params_j, params_t)
    rng = np.random.default_rng(2)
    caches = _caches(tiny[0], cfg_t)
    caches, _ = _step(windowed, caches, rng.integers(0, 256, (3, PAGE)),
                      np.array([0, 0, 0]), True)
    tokens, first = rng.integers(0, 256, (3, 5)), np.array([PAGE, 0, 100])
    saved = [kv_cache.KVPages(*(t.clone() for t in (c.k_pages, c.k_scales,
                                                     c.v_pages, c.v_scales)))
             for c in caches[1]]
    _, want = _step(windowed, caches, tokens, first, False)
    table = torch.from_numpy(TABLE)
    got, _ = model.verify_step(params_t, torch.from_numpy(tokens).long(),
                               torch.from_numpy(first).long(), saved,
                               [table] * cfg_t.n_layers, torch.from_numpy(ACTIVE),
                               windowed[1])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
