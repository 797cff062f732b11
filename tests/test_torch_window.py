"""Port parity: sliding windows, the non-causal recency band and attention
sinks in the FA2 forward API of cuda_flash_attention_tpu_torch against the
JAX package's, on the same numpy inputs.

On the CPU the port runs the plain versions of kernels B1 and B8
(fa2_forward_plain); the JAX side is called with force_kernel=True, so its
reference is the Pallas kernel in interpret mode (the compact window grid
and its sink slots included).  Tolerances: B1's CPU gates, the largest
|O difference| over the largest |O| within 2e-6 with fp32 tiles and 2e-2
with bf16 tiles, lse within 1e-5 (fp32) and 2e-2 (bf16) on the rows that
keep a key.  A row that keeps no key (a band whose offset is <= 0, causal
rows past kv_len + window) must give the JAX O (zeros) and lse exactly:
-inf where the JAX forward's tile (of BlockSizes.default(window=)) walks no
key tile, else the mask value times ln 2.  The CUDA kernels are held to
these plain versions on the card by tests/test_torch_kernels_gpu.py and
chip_smoke.py phases 25 and 26.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import common as jax_common
from cuda_flash_attention_tpu_torch.kernels import attention, common
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

TOL = {None: (2e-6, 1e-5), "bf16": (2e-2, 2e-2)}


def _inputs(b, hq, hkv, sq, skv, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _both(q, k, v, tile, **kw):
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), force_kernel=True,
        tile_dtype=None if tile is None else jnp.bfloat16, **kw)
    o_t, lse_t = attention.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tile_dtype=None if tile is None else torch.bfloat16, **kw)
    return (np.asarray(o_j), np.asarray(lse_j)), (o_t.numpy(), lse_t.numpy())


def _check(jax_out, port_out, tile):
    (o_j, lse_j), (o_t, lse_t) = jax_out, port_out
    o_tol, lse_tol = TOL[tile]
    assert o_t.shape == o_j.shape and lse_t.shape == lse_j.shape
    assert np.abs(o_t - o_j).max() <= o_tol * np.abs(o_j).max()
    dead = lse_j < -1e30
    np.testing.assert_array_equal(lse_t[dead], lse_j[dead])
    np.testing.assert_array_equal(o_t[dead], 0.0)
    np.testing.assert_allclose(lse_t[~dead], lse_j[~dead], atol=lse_tol, rtol=0)
    return int(dead.sum())


# (Sq, Skv, window, sinks): causal windows inside one tile and across
# several, Sq != Skv both ways (rows past kv_len + window keep no key),
# and sinks inside the first tile and past it.
CAUSAL = [
    (256, 256, 1, 0), (256, 256, 64, 0), (256, 256, 100, 0),
    (256, 256, 300, 0), (130, 200, 64, 0), (200, 130, 64, 0),
    (256, 256, 64, 4), (256, 256, 100, 130),
]


@pytest.mark.parametrize("tile", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sq,skv,window,sinks", CAUSAL, ids=str)
def test_causal_window_matches_jax(sq, skv, window, sinks, tile):
    q, k, v = _inputs(1, 4, 2, sq, skv)  # GQA 4/2
    dead = _check(*_both(q, k, v, tile, causal=True, window=window, sinks=sinks),
                  tile)
    assert dead == (4 * max(0, sq - (skv + window - 1)) if sinks == 0 else 0)


@pytest.mark.parametrize("tile", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [64, 0, -100, -200])
def test_band_matches_jax(window, tile):
    """The recency band (causal=False): row i keeps j > i - window with no
    future bound.  Offsets <= 0 leave the last rows with no key; at -200
    the second 128-row tile walks no key tile and its lse is -inf."""
    q, k, v = _inputs(1, 4, 2, 256, 256, seed=1)
    dead = _check(*_both(q, k, v, tile, causal=False, window=window), tile)
    assert dead == 4 * max(0, 1 - window)


@pytest.mark.parametrize("tile", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal,window,sinks", [(True, 32, 4), (True, 1, 0),
                                                 (False, -20, 0)])
def test_small_route_matches_jax(causal, window, sinks, tile):
    """S <= 128 with Hq = Hkv takes B8 in both packages."""
    q, k, v = _inputs(2, 2, 2, 100, 100, seed=2)
    qp = torch.zeros(2, 2, 112, 64)
    assert attention._use_small_kernel(qp, qp)
    before = LAUNCHES["fa2_forward_small"]
    _check(*_both(q, k, v, tile, causal=causal, window=window, sinks=sinks), tile)
    assert LAUNCHES["fa2_forward_small"] == before  # CPU: the plain version


def test_flash_attention_output_matches_with_lse():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 200, 200, seed=3))
    o = attention.flash_attention(q, k, v, causal=True, window=50, sinks=4)
    o_lse, _ = attention.flash_attention_with_lse(q, k, v, causal=True,
                                                  window=50, sinks=4)
    torch.testing.assert_close(o, o_lse, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 64, 100, 300, 1000, 5000])
def test_block_sizes_default_window_matches_jax(window):
    assert dataclasses.astuple(common.BlockSizes.default(True, window=window)) == \
        dataclasses.astuple(jax_common.BlockSizes.default(True, window=window))


@pytest.mark.parametrize("kw", [dict(window=64), dict(window=64, sinks=4),
                                dict(window=-10, causal=False)])
def test_windowed_backward_raises(kw):
    """The windowed gradient, refused until the backward kernels took
    windows, now gives the JAX package's: torch.autograd.grad of
    flash_attention against jax.grad within 1e-4 in fp32 (the standalone
    fa2_backward: tests/test_torch_window_backward.py)."""
    import jax

    kw = dict(dict(causal=True), **kw)
    q, k, v = _inputs(1, 2, 2, 200, 200, seed=4)
    w = np.random.default_rng(40).standard_normal(q.shape, dtype=np.float32)
    g_j = jax.grad(lambda *x: jnp.sum(jax_attention.flash_attention(
        *x, force_kernel=True, **kw) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = attention.flash_attention(*ts, **kw)
    g_t = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(window=0, causal=True), ValueError, "causal window"),
    (dict(window=-255, causal=False), ValueError, "masks every key"),
    (dict(sinks=-1, window=8, causal=True), ValueError, "sinks"),
    (dict(sinks=4, causal=True), ValueError, "sliding window"),
])
def test_invalid_windows_raise_as_jax(kw, exc, match):
    q, k, v = _inputs(1, 2, 2, 256, 256)
    with pytest.raises(exc, match=match):
        jax_attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    with pytest.raises(exc, match=match):
        attention.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)


def test_small_blocks_under_a_wide_window_warn_as_jax():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 1, 1, 640, 640, d=16))
    with pytest.warns(UserWarning, match="slowdown regime"):
        attention.flash_attention(q, k, v, causal=True, window=512,
                                  block_sizes=common.BlockSizes(128, 128))


@pytest.mark.parametrize("first,end,sinks,tile,want", [
    (-5, 300, 0, 128, (0, 0, 3)),      # no window: every tile
    (200, 300, 0, 128, (0, 1, 2)),     # from the tile holding column 200
    (200, 300, 4, 128, (1, 1, 3)),     # the sink tile, then tiles 1-2
    (300, 600, 130, 128, (2, 2, 5)),   # sink tiles 0-1, then 2-4 once
    (700, 600, 4, 128, (1, 5, 1)),     # a band past the keys: sinks only
    (0, 0, 4, 128, (0, 0, 0)),         # no key at all
])
def test_window_tiles_walk(first, end, sinks, tile, want):
    """The walk csrc/hopper.cuh KvWalk steps through (its plain twin)."""
    assert common.window_tiles(first, end, sinks, tile) == want
