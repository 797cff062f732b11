"""Port parity: paged decode attention (kernel B5's plain version on the CPU)
against the JAX package's paged_decode_attention (its Pallas kernel in
interpret mode), on the same pages, page table, lengths and queries.
Tolerances: 2e-5 with fp32 compute (tests/test_decode.py's fp32 gate) and
2e-2 with bf16 compute.  The CUDA kernel is held to this plain version on
the card by tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import attention as jax_attention
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu_torch.decode import attention, kv_cache

PAGE = 128
HKV, GROUP, D = 2, 2, 64
LENGTHS = [200, 0, 77, 256]  # ragged across page boundaries; slot 1 inactive
PPS = 3


def _setup(jdt, tdt, seed=0):
    """The same cache contents in both packages: written through each
    package's own prompt writer from one numpy prompt per slot."""
    rng = np.random.default_rng(seed)
    num_pages = len(LENGTHS) * PPS + 1
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = perm.reshape(len(LENGTHS), PPS)
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    for s in range(len(LENGTHS)):
        k = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table[s]))
        pt = kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(table[s]))
    q = rng.standard_normal((len(LENGTHS), HKV * GROUP, D)).astype(np.float32)
    return pj, pt, table, np.array(LENGTHS, np.int32), q


@pytest.mark.parametrize("compute,tol", [("fp32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("jdt,tdt", [(jnp.int8, torch.int8),
                                     (jnp.float32, torch.float32)],
                         ids=["int8", "fp32"])
def test_plain_matches_jax_kernel(jdt, tdt, compute, tol):
    pj, pt, table, lengths, q = _setup(jdt, tdt)
    jc = jnp.float32 if compute == "fp32" else jnp.bfloat16
    tc = torch.float32 if compute == "fp32" else torch.bfloat16
    o_j = jax_attention.paged_decode_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(lengths),
        compute_dtype=jc)
    o_t = attention.paged_decode_attention(
        torch.from_numpy(q).to(tc), pt, torch.from_numpy(table),
        torch.from_numpy(lengths), compute_dtype=tc)
    assert o_t.shape == q.shape and o_t.dtype == tc
    o_j = np.asarray(o_j.astype(jnp.float32))
    np.testing.assert_allclose(o_t.float().numpy(), o_j, atol=tol, rtol=0)
    assert not o_t[1].any(), "an inactive slot (length 0) gives zeros"


def test_dead_table_entries_are_never_read():
    """Pages past a slot's length may hold anything: the output ignores
    them, whatever the table points at there."""
    _, pt, table, lengths, q = _setup(jnp.int8, torch.int8, seed=1)
    args = dict(compute_dtype=torch.float32)
    want = attention.paged_decode_attention(
        torch.from_numpy(q), pt, torch.from_numpy(table),
        torch.from_numpy(lengths), **args)
    stale = table.copy()
    stale[2, 1:] = 0      # slot 2 (length 77) only owns its first page
    stale[0, 2] = 999999  # slot 0 (length 200) owns two; a garbage id past them
    got = attention.paged_decode_attention(
        torch.from_numpy(q), pt, torch.from_numpy(stale),
        torch.from_numpy(lengths), **args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_windows_raise():
    _, pt, table, lengths, q = _setup(jnp.int8, torch.int8)
    with pytest.raises(NotImplementedError):
        attention.paged_decode_attention(
            torch.from_numpy(q), pt, torch.from_numpy(table),
            torch.from_numpy(lengths), window=64)
