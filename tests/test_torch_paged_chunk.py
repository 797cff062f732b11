"""Port parity: paged chunk attention (kernel B6's plain version on the CPU)
against the JAX package's paged_chunk_attention (its Pallas kernel in
interpret mode), the chunk writers append_chunk_kv and write_chunk_kv_paged
against JAX's, and the refcounted PageAllocator against JAX's.

Each package builds the same cache from the same numpy data through its own
writers.  Tolerances: 2e-5 with fp32 compute and 2e-2 with bf16 compute,
as the B5 parity test (tests/test_torch_paged_decode.py); the cache bytes
and scales must be equal to the bit.  The CUDA kernel is held to this plain
version on the card by tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import attention as jax_attention
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu_torch.decode import attention, kv_cache

PAGE = 128
HKV, GROUP, D = 2, 2, 64
# Slot 1's chunk from 126 crosses a page at T >= 3; slot 3 is inactive.
BASES = [200, 126, 77, 0]
ACTIVE = np.array([True, True, True, False])
PPS = 3


def _np(x):
    """A JAX or torch array as numpy (bf16 through fp32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _setup(jdt, tdt, chunk, seed=0):
    """The same cache in both packages: each slot's whole pages written by
    the prompt writer (positions past the base are garbage the mask must
    hide), then a T-token chunk appended from each slot's base."""
    rng = np.random.default_rng(seed)
    n = len(BASES)
    num_pages = n * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(n, PPS)
    table[~ACTIVE] = 0
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    for s in np.flatnonzero(ACTIVE):
        k = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    kc = rng.standard_normal((n, chunk, HKV, D)).astype(np.float32)
    vc = rng.standard_normal((n, chunk, HKV, D)).astype(np.float32)
    base = np.array(BASES, np.int32)
    pj = jax_kv.append_chunk_kv(pj, jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(table), jnp.asarray(base),
                                jnp.asarray(ACTIVE))
    kv_cache.append_chunk_kv(pt, torch.from_numpy(kc), torch.from_numpy(vc),
                             torch.from_numpy(table),
                             torch.from_numpy(base).long(),
                             torch.from_numpy(ACTIVE))
    q = rng.standard_normal((n, chunk, HKV * GROUP, D)).astype(np.float32)
    totals = np.where(ACTIVE, base + chunk, 0).astype(np.int32)
    return pj, pt, table, totals, q


def _assert_same_pages(pt, pj, skip_null_page=False):
    for name in ("k_pages", "k_scales", "v_pages", "v_scales"):
        got, want = _np(getattr(pt, name)), _np(getattr(pj, name))
        if skip_null_page:
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("compute,tol", [("fp32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("jdt,tdt", [(jnp.int8, torch.int8),
                                     (jnp.float32, torch.float32)],
                         ids=["int8", "fp32"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_plain_matches_jax_kernel(chunk, jdt, tdt, compute, tol):
    pj, pt, table, totals, q = _setup(jdt, tdt, chunk)
    jc = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tc = torch.float32 if compute == "fp32" else torch.bfloat16
    o_j = jax_attention.paged_chunk_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(totals),
        compute_dtype=jc)
    o_t = attention.paged_chunk_attention(
        torch.from_numpy(q).to(tc), pt, torch.from_numpy(table),
        torch.from_numpy(totals), compute_dtype=tc)
    assert o_t.shape == q.shape and o_t.dtype == tc
    np.testing.assert_allclose(o_t.float().numpy(), _np(o_j), atol=tol, rtol=0)
    assert not o_t[3].any(), "an inactive slot (length 0) gives exact zeros"


@pytest.mark.parametrize("jdt,tdt", [(jnp.int8, torch.int8),
                                     (jnp.float32, torch.float32)],
                         ids=["int8", "fp32"])
def test_chunk_of_one_equals_paged_decode(jdt, tdt):
    _, pt, table, totals, q = _setup(jdt, tdt, chunk=1, seed=1)
    args = (pt, torch.from_numpy(table), torch.from_numpy(totals))
    one = attention.paged_chunk_attention(torch.from_numpy(q), *args,
                                          compute_dtype=torch.float32)[:, 0]
    dec = attention.paged_decode_attention(torch.from_numpy(q[:, 0]), *args,
                                           compute_dtype=torch.float32)
    np.testing.assert_allclose(one.numpy(), dec.numpy(), atol=2e-5, rtol=0)


def test_dead_table_entries_are_never_read():
    _, pt, table, totals, q = _setup(jnp.int8, torch.int8, chunk=4, seed=2)
    want = attention.paged_chunk_attention(
        torch.from_numpy(q), pt, torch.from_numpy(table),
        torch.from_numpy(totals), compute_dtype=torch.float32)
    stale = table.copy()
    stale[2, 1:] = 0      # slot 2 (81 tokens) only owns its first page
    stale[0, 2] = 999999  # slot 0 (204 tokens) owns two; garbage past them
    got = attention.paged_chunk_attention(
        torch.from_numpy(q), pt, torch.from_numpy(stale),
        torch.from_numpy(totals), compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_windows_and_sinks_raise():
    """Refused until sliding windows were ported: a window (with sinks, or
    sinks without a window, which the JAX kernel ignores) now gives the
    JAX kernel's output."""
    pj, pt, table, totals, q = _setup(jnp.int8, torch.int8, chunk=2)
    for kw in (dict(window=64, sinks=4), dict(sinks=4)):
        o_j = jax_attention.paged_chunk_attention(
            jnp.asarray(q), pj, jnp.asarray(table), jnp.asarray(totals),
            compute_dtype=jnp.float32, **kw)
        o_t = attention.paged_chunk_attention(
            torch.from_numpy(q), pt, torch.from_numpy(table),
            torch.from_numpy(totals), compute_dtype=torch.float32, **kw)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5, rtol=0)


@pytest.mark.parametrize("jdt,tdt", [(jnp.int8, torch.int8),
                                     (jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)],
                         ids=["int8", "bf16", "fp32"])
def test_append_chunk_kv_matches_jax_bit_for_bit(jdt, tdt):
    """Prompt pages, then a 5-token chunk per slot (one crossing a page),
    the inactive slot writing the null page."""
    pj, pt, *_ = _setup(jdt, tdt, chunk=5, seed=3)
    _assert_same_pages(pt, pj)


@pytest.mark.parametrize("jdt,tdt", [(jnp.int8, torch.int8),
                                     (jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)],
                         ids=["int8", "bf16", "fp32"])
def test_write_chunk_kv_paged_matches_jax_bit_for_bit(jdt, tdt):
    """Two-page chunks from page-aligned starts 0 and 128; the inactive
    slot's rows go to the null page 0, whose content is then unspecified
    (several rows write there), so it is left out of the comparison."""
    rng = np.random.default_rng(4)
    num_pages = 8
    table = np.array([[3, 5, 0], [6, 1, 2], [0, 0, 0]], np.int32)
    first = np.array([0, PAGE, 0], np.int32)
    active = np.array([True, True, False])
    kc = rng.standard_normal((3, 2 * PAGE, HKV, D)).astype(np.float32)
    vc = rng.standard_normal((3, 2 * PAGE, HKV, D)).astype(np.float32)
    pj = jax_kv.write_chunk_kv_paged(
        jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(table), jnp.asarray(first),
        jnp.asarray(active))
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    out = kv_cache.write_chunk_kv_paged(
        pt, torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(table),
        torch.from_numpy(first).long(), torch.from_numpy(active))
    assert out.k_pages is pt.k_pages  # in place
    _assert_same_pages(pt, pj, skip_null_page=True)
    with pytest.raises(ValueError, match="multiple of the page size"):
        kv_cache.write_chunk_kv_paged(
            pt, torch.from_numpy(kc[:, :100]), torch.from_numpy(vc[:, :100]),
            torch.from_numpy(table), torch.from_numpy(first).long(),
            torch.from_numpy(active))


def test_page_allocator_refcounts_match_jax():
    """share / refcount / free / on_last_free, and the ids handed out, step
    for step as the JAX allocator."""
    aj, at = jax_kv.PageAllocator(10), kv_cache.PageAllocator(10)
    dead = {"jax": [], "port": []}
    aj.on_last_free = dead["jax"].append
    at.on_last_free = dead["port"].append
    for a in (aj, at):
        first = a.alloc(3)
        a.share(first[:2])
        a.share(first[:1] + [0])  # the null page is never counted
        a.free(first)             # the third page dies; the others live on
        second = a.alloc(2)       # reuses the freed page first
        a.free(first[:2])         # first[1] dies, first[0] is held once more
        a.free(second + [0])
    assert dead["port"] == dead["jax"]
    assert at.num_pages == aj.num_pages == 10
    for p in range(10):
        assert at.refcount(p) == aj.refcount(p), p
    assert at.available == aj.available
    assert at.alloc(at.available) == aj.alloc(aj.available)
