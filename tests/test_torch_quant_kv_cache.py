"""Port parity of the fp8 and int4 paged KV caches: the three writers
(append_token_kv, append_chunk_kv, write_chunk_kv_paged, and the prompt
writer on top of the last) give the JAX package's bytes and scales, fp8's
flush below the minimum normal included; the plain B5 and B6 over fp8 and
int4 pages match the JAX kernels in interpret mode within 2e-5 (fp32
compute) and 2e-2 (bf16), the tolerances of tests/test_torch_paged_decode.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import raw
from cuda_flash_attention_tpu.decode import attention as jax_attention
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu_torch.decode import attention, kv_cache

PAGE = 128
HKV, GROUP, D = 2, 2, 64
CACHES = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
          "int4": ("int4", "int4")}
TOL = {"fp32": 2e-5, "bf16": 2e-2}
COMPUTE = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LENGTHS = [200, 0, 77, 256]  # ragged across page boundaries; slot 1 inactive
PPS = 3


# One large element per K/V row puts most of the row below the fp8 minimum
# normal after scaling (|x| < amax * min_normal / qmax: 3.5e-5 of the max
# for e4m3, 1.1e-9 for e5m2), where the writer must flush to zero.
SPIKE = {"e4m3": 1e5, "e5m2": 1e9, "int4": 1e5}


def _kv(rng, cache, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 3] *= SPIKE[cache]
    return x


def _same_pages(pt, pj):
    for name in ("k_pages", "k_scales", "v_pages", "v_scales"):
        np.testing.assert_array_equal(raw(getattr(pt, name)), raw(getattr(pj, name)))


def _setup(cache, seed=0):
    """The same cache in both packages, written through each package's own
    prompt writer from one numpy prompt per slot."""
    jdt, tdt = CACHES[cache]
    rng = np.random.default_rng(seed)
    num_pages = len(LENGTHS) * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(
        len(LENGTHS), PPS)
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    for s in range(len(LENGTHS)):
        k = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    return pj, pt, table


@pytest.mark.parametrize("cache", list(CACHES))
def test_writers_match_jax_bytes(cache):
    jdt, tdt = CACHES[cache]
    rng = np.random.default_rng(1)
    num_pages = 8
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    want_width = D // 2 if cache == "int4" else D
    assert pt.k_pages.shape == (HKV, num_pages, PAGE, want_width)
    table = np.array([[3, 5, 0], [1, 0, 0], [6, 2, 7]], np.int32)
    active = np.array([True, False, True])

    # write_chunk_kv_paged: one page per slot from page-aligned starts.
    kc, vc = _kv(rng, cache, 3, PAGE, HKV, D), _kv(rng, cache, 3, PAGE, HKV, D)
    first = np.array([0, 0, PAGE], np.int32)
    pj = jax_kv.write_chunk_kv_paged(pj, jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(table), jnp.asarray(first),
                                     jnp.asarray(active))
    kv_cache.write_chunk_kv_paged(pt, torch.from_numpy(kc), torch.from_numpy(vc),
                                  torch.from_numpy(table), torch.from_numpy(first),
                                  torch.from_numpy(active))
    _same_pages(pt, pj)

    # append_token_kv, then a 3-token append_chunk_kv crossing a page.
    pos = np.array([PAGE - 2, 0, 2 * PAGE + 1], np.int32)
    kn, vn = _kv(rng, cache, 3, HKV, D), _kv(rng, cache, 3, HKV, D)
    pj = jax_kv.append_token_kv(pj, jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(table), jnp.asarray(pos),
                                jnp.asarray(active))
    kv_cache.append_token_kv(pt, torch.from_numpy(kn), torch.from_numpy(vn),
                             torch.from_numpy(table), torch.from_numpy(pos).long(),
                             torch.from_numpy(active))
    kc, vc = _kv(rng, cache, 3, 3, HKV, D), _kv(rng, cache, 3, 3, HKV, D)
    pj = jax_kv.append_chunk_kv(pj, jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(table), jnp.asarray(pos + 1),
                                jnp.asarray(active))
    kv_cache.append_chunk_kv(pt, torch.from_numpy(kc), torch.from_numpy(vc),
                             torch.from_numpy(table), torch.from_numpy(pos + 1).long(),
                             torch.from_numpy(active))
    _same_pages(pt, pj)
    if cache != "int4":
        # The flush happened: about half the codes are exact zeros, where
        # an unflushed cast would store subnormals (none round to zero).
        assert (pt.k_pages[:, 3].float() == 0).float().mean() > 0.3


@pytest.mark.parametrize("cache,compute", [("e4m3", "fp32"), ("e5m2", "bf16"),
                                           ("int4", "fp32"), ("int4", "bf16")])
def test_plain_decode_matches_jax_kernel(cache, compute):
    pj, pt, table = _setup(cache)
    q = np.random.default_rng(2).standard_normal(
        (len(LENGTHS), HKV * GROUP, D)).astype(np.float32)
    lengths = np.array(LENGTHS, np.int32)
    jc, tc = COMPUTE[compute]
    o_j = jax_attention.paged_decode_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(lengths),
        compute_dtype=jc)
    o_t = attention.paged_decode_attention(
        torch.from_numpy(q).to(tc), pt, torch.from_numpy(table),
        torch.from_numpy(lengths), compute_dtype=tc)
    np.testing.assert_allclose(o_t.float().numpy(), raw(o_j), atol=TOL[compute], rtol=0)
    assert not o_t[1].any(), "an inactive slot (length 0) gives zeros"


@pytest.mark.parametrize("cache,compute", [("e4m3", "bf16"), ("e5m2", "fp32"),
                                           ("int4", "fp32"), ("int4", "bf16")])
def test_plain_chunk_matches_jax_kernel(cache, compute):
    pj, pt, table = _setup(cache, seed=3)
    chunk = 3
    q = np.random.default_rng(4).standard_normal(
        (len(LENGTHS), chunk, HKV * GROUP, D)).astype(np.float32)
    totals = np.array([n + chunk if n else 0 for n in LENGTHS], np.int32)
    totals = np.minimum(totals, PPS * PAGE)
    jc, tc = COMPUTE[compute]
    o_j = jax_attention.paged_chunk_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(totals),
        compute_dtype=jc)
    o_t = attention.paged_chunk_attention(
        torch.from_numpy(q).to(tc), pt, torch.from_numpy(table),
        torch.from_numpy(totals), compute_dtype=tc)
    np.testing.assert_allclose(o_t.float().numpy(), raw(o_j), atol=TOL[compute], rtol=0)


def test_packed_pages_fit_only_half_width():
    """int4 pages take head_dim // 2 int8 bytes; other widths do not fit."""
    pages = kv_cache.init_kv_pages(HKV, 3, PAGE, D, "int4", device="cpu")
    table = torch.ones(1, 2, dtype=torch.int32)
    lengths = torch.full((1,), 5, dtype=torch.int32)
    out = attention.paged_decode_attention(torch.zeros(1, 4, D), pages, table, lengths)
    assert out.shape == (1, 4, D)
    with pytest.raises(ValueError, match="does not fit"):
        attention.paged_decode_attention(torch.zeros(1, 4, 2 * D), pages, table,
                                         lengths)
    with pytest.raises(ValueError, match="even head_dim"):
        kv_cache.init_kv_pages(HKV, 3, PAGE, 63, "int4", device="cpu")
