"""What the Hopper designs of B3 (the split route's dQ) and B4 (its dK and
dV) rest on, held on the CPU; the CUDA kernels themselves are held to these
plain versions on the card by tests/test_torch_kernels_gpu.py.

- The prologue's mode without O (B3, B4): D_i is the caller's, passed
  through to the bit; Q_s, dO, K, V and lse * log2(e) are B2's.
- B3's walk (128-row Q tiles over 128-row KV tiles at D 64, 64-row at D
  128) against the element mask: a KV tile is walked exactly when it holds
  a live (row, key) pair with the Q tile.
- B3's and B4's plain versions against the JAX kernels in interpret mode at
  D 128 with Sq != Skv both ways, over several of the new tiles: fp32 1e-5
  and bf16 tiles 5e-2 of the JAX output's max (the gates of
  tests/test_torch_fa2_backward.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import fa2_backward as jax_bwd
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.common import build_element_mask
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain

TOL = {None: 1e-5, torch.bfloat16: 5e-2}


def _problem(dtype, tile, sq, skv, causal, d, hq=4, hkv=2, seed=0):
    """Padded inputs as the autograd path builds them: q, k, v, dO from
    numpy, O and lse from the plain forward, D_i = rowsum(dO * O)."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, hq, sq, d), dtype=np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, hkv, skv, d), dtype=np.float32))
            .to(dtype) for _ in range(2))
    q, k, v, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, tile, None, None, None, 0)
    o, lse = fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len, tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - sq))
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile)
    return (q, k, v, o.to(dtype), do, lse, di), kw


@pytest.mark.parametrize("tile", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_prologue_without_o_passes_the_callers_di_through(dtype, tile):
    """Without O the prologue takes D_i as the caller gives it (here not
    rowsum(dO * O), so a fold would show), and forms Q_s, dO, K, V and
    lse * log2(e) as B2's prologue does, to the bit."""
    (q, k, v, o, do, lse, _), kw = _problem(dtype, tile, 200, 200, True, 64)
    di = torch.from_numpy(np.random.default_rng(1).standard_normal(
        lse.shape, dtype=np.float32))
    got = fa2_backward.fused_prologue_plain(q, k, v, None, do, lse,
                                            sm_scale=kw["sm_scale"],
                                            tile_dtype=tile, di=di)
    with_o = fa2_backward.fused_prologue_plain(q, k, v, o, do, lse,
                                               sm_scale=kw["sm_scale"],
                                               tile_dtype=tile)
    assert got[5] is di
    for a, b in zip(got[:5], with_o[:5]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,kv_len,causal", [
    (2048, 2048, True), (384, 300, True), (300, 100, True), (128, 384, True),
    (256, 200, False), (112, 130, True),
], ids=str)
def test_b3_walk_follows_the_mask(sq, kv_len, causal, d):
    """Q tile qt walks KV tile kt exactly when the element mask has a live
    (row, key) pair in the two tiles: under causal it stops at the tile
    holding the Q tile's last row before sq, and never passes kv_len."""
    skv = -(-kv_len // 128) * 128
    mask = build_element_mask(sq, skv, causal=causal, kv_len=kv_len, device="cpu")
    live = mask.expand(sq, skv)
    bn = fa2_backward.dq_kv_tile(d)
    walks = fa2_backward.dq_kv_tiles(sq, kv_len, causal, d)
    assert len(walks) == -(-sq // 128)
    for qt, walked in enumerate(walks):
        for kt in range(-(-skv // bn)):
            block = live[qt * 128:(qt + 1) * 128, kt * bn:(kt + 1) * bn]
            assert (kt in walked) == bool(block.any()), (qt, kt)


def _jnp(t):
    return jnp.asarray(t.float().numpy())


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("sq,skv", [(300, 100), (128, 384)], ids=str)
def test_dq_and_dkv_plain_match_jax_kernels_at_d128_unequal_lengths(sq, skv, tile):
    """B3's 128-row Q tiles and 64-row KV tiles at D 128, causal with Sq >
    Skv (rows past kv_len) and Sq < Skv (keys past every row), GQA 4/2."""
    (q, k, v, _, do, lse, di), kw = _problem(torch.float32, tile, sq, skv, True,
                                             128, seed=sq + skv)
    jax_kw = dict(causal=True, sm_scale=kw["sm_scale"], kv_len=kw["kv_len"],
                  tile_dtype=None if tile is None else jnp.bfloat16, kv_groups=2,
                  block_q=min(128, q.shape[2]), block_k=min(128, k.shape[2]))
    args = (_jnp(q), _jnp(k), _jnp(v), _jnp(do), _jnp(lse)[..., None],
            _jnp(di)[..., None])
    dq = fa2_backward.fa2_backward_dq_aligned(q, k, v, do, lse, di, **kw)
    assert _rel_err(dq, jax_bwd.fa2_backward_dq_aligned(*args, **jax_kw)) <= TOL[tile]
    dk, dv = fa2_backward.fa2_backward_dkv_aligned(q, k, v, do, lse, di, **kw)
    want = jax_bwd.fa2_backward_dkv_aligned(*args, **jax_kw)
    for got, w in zip((dk, dv), want):
        assert _rel_err(got, w) <= TOL[tile]
