"""What the Hopper designs of B9 (FA1) and B2 (the fused FA2 backward) rest
on, held on the CPU; the CUDA kernels themselves are held to these plain
versions on the card by tests/test_torch_kernels_gpu.py.

- B9's plain version against the JAX FA1 kernel in interpret mode, at
  shapes with several 64-row KV and Q tiles, Sq != Skv and kv_len inside
  the last tile, D 64 and 128 (JAX block_k 64, the port's KV tile, so the
  two re-round O at the same tiles): 2e-6 absolute, the JAX fp32 gate.
- B2's prologue (Q_s, dO, K, V in the tile type, lse * log2(e), D_i) rounds
  where the plain backward rounds, to the bit.
- B2's live Q tiles per KV tile against the causal mask, and its dQ slice
  traffic at the train shape.
- The backward route rule gives the routes it gave before the redesign (B2
  keeps dq_part's size, so the byte cap reckons as before).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import baselines as jax_baselines
from cuda_flash_attention_tpu_torch.kernels import attention, baselines, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.common import build_element_mask
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain


# (Sq, Skv padded, kv_len, D): Sq > Skv, Sq < Skv, kv_len inside the last
# 64-row tile, Sq not a multiple of 64.
FA1_CASES = [(200, 192, 170, 64), (72, 256, 256, 128), (130, 128, 100, 64),
             (256, 128, 128, 128)]


@pytest.mark.parametrize("sq,skv,kv_len,d", FA1_CASES, ids=str)
def test_fa1_plain_matches_jax_kernel_over_several_tiles(sq, skv, kv_len, d):
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((1, 2, sq, d), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, skv, d), dtype=np.float32)
            for _ in range(2))
    scale = d ** -0.5
    want = jax_baselines._fa1_aligned(
        *(jnp.asarray(x) for x in (q, k, v)), sm_scale=scale,
        block_k=baselines.KV_TILE, kv_len=kv_len, interpret=True)
    got = baselines.fa1_aligned(*(torch.from_numpy(x) for x in (q, k, v)),
                                sm_scale=scale, kv_len=kv_len)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def _bwd_inputs(dtype, s=200, seed=3):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, s, 64), dtype=np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, s, 64), dtype=np.float32))
            .to(dtype) for _ in range(2))
    o, lse = fa2_forward_plain(q, k, v, causal=True, sm_scale=0.125, kv_len=s,
                               tile_dtype=None)
    return q, k, v, o.to(dtype), do, lse


@pytest.mark.parametrize("tile", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_b2_prologue_rounds_where_the_plain_backward_rounds(dtype, tile):
    """The prologue forms Q_s, dO, K and V in the tile type once per call;
    the plain backward forms them inside _p_ds.  They are the same to the
    bit, and feeding the prologue's tile-type K, V and dO back through the
    plain backward changes no bit of P or dS."""
    q, k, v, o, do, lse = _bwd_inputs(dtype)
    q_s, do_t, k_t, v_t, lse2, di = fa2_backward.fused_prologue_plain(
        q, k, v, o, do, lse, sm_scale=0.125, tile_dtype=tile)
    assert q_s.dtype == do_t.dtype == k_t.dtype == v_t.dtype == tile
    assert lse2.dtype == di.dtype == torch.float32
    kw = dict(causal=True, sm_scale=0.125, kv_len=200, tile_dtype=tile)
    p, ds, qs_p, ks_p, dos_p = fa2_backward._p_ds(q, k, v, do, lse, di, **kw)
    assert torch.equal(q_s.float(), qs_p)
    assert torch.equal(k_t.float().repeat_interleave(2, dim=1), ks_p)  # GQA 4/2
    assert torch.equal(do_t.float(), dos_p)
    assert torch.equal(lse2, lse.float() * fa2_backward.LOG2E)
    assert torch.equal(di, (do.float() * o.float()).sum(dim=-1))
    p2, ds2, *_ = fa2_backward._p_ds(q, k_t, v_t, do_t, lse, di, **kw)
    assert torch.equal(p2, p) and torch.equal(ds2, ds)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,kv_len,causal", [
    (2048, 2048, 2048, True), (384, 384, 300, True), (300, 128, 100, True),
    (128, 384, 384, True), (256, 256, 200, False), (112, 256, 130, True),
], ids=str)
def test_b2_live_q_tiles_follow_the_mask(sq, skv, kv_len, causal, d):
    """A Q tile is walked by a KV tile's block exactly when the element
    mask has a live (row, key) pair in the two tiles."""
    mask = build_element_mask(sq, skv, causal=causal, kv_len=kv_len, device="cpu")
    live = (torch.ones(sq, skv, dtype=torch.bool) if mask is None
            else mask.expand(sq, skv))
    bq = fa2_backward.fused_q_tile(d)
    tiles = fa2_backward.fused_live_q_tiles(sq, skv, kv_len, causal, d)
    assert len(tiles) == -(-skv // 128)
    for kt, walked in enumerate(tiles):
        for qt in range(-(-sq // bq)):
            block = live[qt * bq:(qt + 1) * bq, kt * 128:(kt + 1) * 128]
            assert (qt in walked) == bool(block.any()), (kt, qt)


def test_b2_dq_slice_bytes_at_the_train_shape():
    """B4 Hq16 S2048 D64 causal: 17,408 of the 32,768 (row, KV tile) pairs
    are live, each written once and read once: 0.57 GB against the 1.07 GB
    of writing and reading every slice."""
    b, hq, s, d = 4, 16, 2048, 64
    n_slices = s // 128
    every = 4 * d * b * hq * n_slices * s
    got = fa2_backward.fused_dq_slice_bytes(b, hq, s, s, s, True, d)
    assert got == 4 * d * b * hq * 2 * 17408 == 570_425_344
    assert got < 0.54 * 2 * every
    # Not causal every slice is live: written once and read once.
    assert fa2_backward.fused_dq_slice_bytes(b, hq, s, s, s, False, d) == 2 * every


# The routes the rule gave before the redesign, row by row of
# test_torch_fa2_backward.ROUTE_TABLE.
ROUTES = [
    ((4, 16, 2048, 64, torch.bfloat16, torch.bfloat16, 1024), True),
    ((4, 16, 2048, 64, torch.bfloat16, torch.bfloat16, 128), False),
    ((1, 4, 256, 64, torch.float32, None, 256), True),
    ((1, 4, 104, 64, torch.float32, None, 104), True),
    ((16, 16, 1024, 64, torch.bfloat16, torch.bfloat16, 1024), True),
    ((1, 16, 4096, 128, torch.bfloat16, torch.bfloat16, 512), True),
    ((1, 8, 1152, 64, torch.float32, torch.bfloat16, 128), False),
]


@pytest.mark.parametrize("row,fused", ROUTES, ids=str)
def test_use_fused_bwd_routes_as_before(row, fused):
    b, h, s, d, dtype, tile, bk = row
    q = types.SimpleNamespace(shape=(b, h, s, d), dtype=dtype)
    k = types.SimpleNamespace(shape=(b, h // 2, s, d), dtype=dtype)
    assert attention._use_fused_bwd(q, k, bk, tile) is fused
