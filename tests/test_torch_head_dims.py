"""Port parity at head dims 32 and 256, which B1 (the FA2 forward), B5 (paged
decode) and B6 (paged chunk attention) take besides 64 and 128.

* B1's plain version (fa2_forward_plain, behind flash_attention_with_lse)
  against the JAX API with force_kernel=True (the Pallas kernel in
  interpret mode) at tests/test_fa2_forward.py's HeadDim-32 (B2 H4 S256)
  and HeadDim-256 (B1 H2 S256) shapes, with GQA 2: full and causal, a
  window with sinks and segment ids.  Tolerances: B1's CPU
  gates (tests/test_torch_window.py), the largest |O difference| within
  2e-6 of the largest |O| in fp32 and 2e-2 with bf16 tiles, lse within
  1e-5 (2e-2) on rows that keep a key.
* B5's and B6's plain versions on int8 and int4 pages against the JAX
  kernels in interpret mode, on the pages each package's own writer made
  from the same numpy K/V: decode, and chunks of 5 (speculation's verify)
  and 64 (a tile body's row count at group 2), fp32 compute within 1e-5
  (the JAX paged tests' gate) and bf16 within 2e-2, global and windowed.
* A tiny hybrid model at head_dim 256: tests/test_torch_head_dims_engine.py.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py phases 27 and 28.  B7-B10
at these widths: tests/test_torch_head_dims_reference.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import attention as jax_paged
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu_torch.decode import attention as paged
from cuda_flash_attention_tpu_torch.decode import kv_cache
from cuda_flash_attention_tpu_torch.kernels import attention, common

# (name, B, Hq, S, D) of tests/test_fa2_forward.py:38-40, KV heads Hq / 2.
SHAPES = {32: (2, 4, 256), 256: (1, 2, 256)}
MASKS = {
    "full": dict(causal=False),
    "causal": dict(causal=True),
    "window sinks": dict(causal=True, window=48, sinks=4),
    "segments": dict(causal=True, segments=True),
}
B1_TOL = {None: (2e-6, 1e-5), "bf16": (2e-2, 2e-2)}


def _b1_inputs(d, seed=0):
    b, hq, s = SHAPES[d]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hq // 2, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hq // 2, s, d), dtype=np.float32)
    ids = np.sort(rng.integers(0, 3, (b, s)), axis=1).astype(np.int32)
    return q, k, v, ids


# Every mask in fp32 tiles, the window with sinks in bf16.
B1_CASES = [(d, mask, tile) for d in (32, 256) for mask in MASKS
            for tile in (None, "bf16") if tile is None or mask == "window sinks"]


@pytest.mark.parametrize("d,mask,tile", B1_CASES, ids=str)
def test_b1_plain_matches_jax(d, mask, tile):
    q, k, v, ids = _b1_inputs(d)
    kw = dict(MASKS[mask])
    if kw.pop("segments", False):
        kw.update(q_segment_ids=ids, kv_segment_ids=ids)
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), force_kernel=True,
        tile_dtype=None if tile is None else jnp.bfloat16, **jkw)
    o_t, lse_t = attention.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tile_dtype=None if tile is None else torch.bfloat16, **tkw)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    o_tol, lse_tol = B1_TOL[tile]
    assert o_t.shape == o_j.shape == q.shape and lse_t.shape == lse_j.shape
    assert np.abs(o_t - o_j).max() <= o_tol * np.abs(o_j).max()
    np.testing.assert_allclose(lse_t, lse_j, atol=lse_tol, rtol=0)


# --- B5 and B6 --------------------------------------------------------------

PAGE, HKV, GROUP, PPS = 128, 2, 2, 3
LENGTHS = [300, 77, 0, 256]  # slot 2 inactive
CACHES = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def _pages(d, cache, chunk, seed=0):
    """The same pages in both packages, written by each one's prompt
    writer, and queries [n, chunk, Hq, d]."""
    rng = np.random.default_rng(seed)
    n = len(LENGTHS)
    num_pages = n * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(n, PPS)
    jdt, tdt = CACHES[cache]
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, d, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, d, tdt, device="cpu")
    for s in range(n):
        k = rng.standard_normal((PPS * PAGE, HKV, d)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, d)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v), jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    q = rng.standard_normal((n, chunk, HKV * GROUP, d)).astype(np.float32)
    return pj, pt, table, np.array(LENGTHS, np.int32), q


# (kernel, T, cache, compute, window): each head dim over both caches, both
# compute types, decode and both chunk bodies' shapes, global and windowed
# (each JAX interpret-mode call costs about a second on the CPU).
PAGED = [
    ("decode", 1, "int8", "fp32", 64),
    ("chunk", 5, "int4", "fp32", None),
    ("chunk", 64, "int8", "bf16", 100),
]


@pytest.mark.parametrize("kind,chunk,cache,compute,window", PAGED, ids=str)
@pytest.mark.parametrize("d", [32, 256])
def test_paged_plain_matches_jax(d, kind, chunk, cache, compute, window):
    pj, pt, table, lengths, q = _pages(d, cache, chunk)
    jc, tc = (jnp.float32, torch.float32) if compute == "fp32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    kw = {} if window is None else dict(window=window)
    jargs = (pj, jnp.asarray(table), jnp.asarray(lengths))
    targs = (pt, torch.from_numpy(table), torch.from_numpy(lengths))
    if kind == "decode":
        want = jax_paged.paged_decode_attention(jnp.asarray(q[:, 0], jc), *jargs,
                                                compute_dtype=jc, **kw)
        got = paged.paged_decode_attention(torch.from_numpy(q[:, 0]).to(tc), *targs,
                                           compute_dtype=tc, **kw)
    else:
        want = jax_paged.paged_chunk_attention(jnp.asarray(q, jc), *jargs,
                                               compute_dtype=jc, **kw)
        got = paged.paged_chunk_attention(torch.from_numpy(q).to(tc), *targs,
                                          compute_dtype=tc, **kw)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 if compute == "fp32" else 2e-2,
                               rtol=0)
    assert not got[2].any(), "an inactive slot (length 0) gives zeros"


def test_kernel_head_dim_sets():
    """Every kernel takes the registry's four head dims; D 64 and 128 are
    each source's own library, D 32 and 256 libraries of their own.  A head
    dim outside the registry is refused by name, with no queue to name."""
    from cuda_flash_attention_tpu_torch.dispatch import SUPPORTED_HEAD_DIMS

    assert common.FORWARD_HEAD_DIMS == tuple(SUPPORTED_HEAD_DIMS)
    assert common.KERNEL_HEAD_DIMS == (64, 128)
    assert [common.kernel_library("paged_chunk", d) for d in (32, 64, 128, 256)] == [
        "paged_chunk_d32", "paged_chunk", "paged_chunk", "paged_chunk_d256"]
    err = common.head_dim_error("fa2_backward_fused", 48)
    assert isinstance(err, NotImplementedError)
    assert str(err) == "fa2_backward_fused kernel: head_dim 48 not in (32, 64, 128, 256)"
    with pytest.raises(NotImplementedError, match="fa2_forward_quant kernel: head_dim 48"):
        common.kernel_library("fa2_forward_quant", 48)


def test_phase_1_gates_every_wide_instantiation():
    """chip_smoke's phase 1 holds each D 32 and D 256 library's kernels
    (B1's four wgmma and two fp32 instantiations; B5's caches x q types x
    groups, six caches at each width; B6's three bodies likewise; B9 and B10, B8's two bodies, B7's
    two: tests/test_torch_head_dims_reference.py): clean reports pass, a
    spilled byte or a missing instantiation fails."""
    import chip_smoke

    def report(names, spill=0):
        return "\n".join(
            line for n in names for line in (
                f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'",
                f"ptxas info    : Function properties for {n}",
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
                "spill loads", "ptxas info    : Used 200 registers"))

    caches = {32: 6, 256: 6}
    want = {"fa2_forward": lambda d: 6, "paged_decode": lambda d: caches[d] * 2 * 2,
            "paged_chunk": lambda d: caches[d] * 2 * 4, "baselines": lambda d: 2,
            "fa2_forward_small": lambda d: 10, "fa2_forward_quant": lambda d: 24}
    for name, (functions, count) in chip_smoke.WIDE_FUNCTIONS.items():
        kernel, d = name.rsplit("_d", 1)
        assert count == want[kernel](int(d)), name
        names = [f"_Z{i}{functions[i % len(functions)]}Ii{i}E" for i in range(count)]
        chip_smoke.check_ptxas(report(names), name, functions, count)
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.check_ptxas(report(names[1:]) + "\n" + report(names[:1], 8),
                                   name, functions, count)
        with pytest.raises(AssertionError, match=f"only {count - 1}"):
            chip_smoke.check_ptxas(report(names[1:]), name, functions, count)


@pytest.mark.parametrize("compute", ["bf16", "fp32"])
@pytest.mark.parametrize("d,heads", [(32, (16, 8)), (256, (8, 4))])
def test_phase_28_slot_gate_catches_a_wrong_page(d, heads, compute):
    """chip_smoke phase 28's slot-by-slot gate at B5's serving lengths (up to
    6000 keys) on an int8 cache: the plain version passes it against itself
    and fails it by 5x or more when the longest slot's middle page is read
    from page 0, the phase's wrong-page control."""
    import chip_smoke

    name, chunk, lens, _ = chip_smoke.WIDE_PAGED[0]
    assert (name, chunk) == ("B5", 1)
    hq, hkv = heads
    gen = torch.Generator().manual_seed(28)
    n, pps = len(lens), -(-max(lens) // 128)
    num_pages = n * pps + 1
    table = (torch.randperm(num_pages - 1, generator=gen) + 1).reshape(n, pps).to(torch.int32)
    shape = (hkv, num_pages, 128, d)

    def codes():
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)

    def scales():
        return torch.rand(shape[:3], generator=gen) * 0.02 + 1e-3

    pages = kv_cache.KVPages(codes(), scales(), codes(), scales())
    cdt = torch.bfloat16 if compute == "bf16" else torch.float32
    q = torch.randn((n, hq, d), generator=gen).to(cdt)
    lengths = torch.tensor(lens, dtype=torch.int32)
    kw = dict(sm_scale=d ** -0.5, compute_dtype=cdt)
    o = paged.paged_decode_attention_plain(q, pages, table, lengths, **kw)
    longest = max(range(n), key=lambda i: lens[i])
    wrong = table.clone()
    wrong[longest, lens[longest] // 128 // 2] = 0
    o_w = paged.paged_decode_attention_plain(q, pages, wrong, lengths, **kw)
    tol = chip_smoke.SLOT_REL_TOL[compute]
    assert chip_smoke.slot_rel_err(torch, o, o) == 0.0
    assert chip_smoke.slot_rel_err(torch, o_w, o) > 5 * tol
