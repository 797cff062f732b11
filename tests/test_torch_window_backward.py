"""Port parity: gradients with sliding windows, the non-causal recency band
and attention sinks (the backward kernels B2, B3 and B4), the route rule's
window clause and the dead rows' lse on the JAX forward's own tiles, in
cuda_flash_attention_tpu_torch against the JAX package, on the same numpy
inputs.

On the CPU the port runs the plain versions of B1 and B2-B4; the JAX side
is called with force_kernel=True, so its reference is the Pallas kernels in
interpret mode.  Gradients: torch.autograd.grad of flash_attention against
jax.grad of the JAX API, within 1e-4 absolute in fp32 (tests/test_window.py
and tests/test_sinks.py) and 2e-2 of the largest |gradient| with bf16
tiles.  A row that keeps no key must carry JAX's lse bit for bit and get
dQ = 0 exactly.  The CUDA kernels are held to these plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py phase 26.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import common as jax_common
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.kernels import attention, common
from cuda_flash_attention_tpu_torch.kernels import fa2_backward
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy


def _inputs(b, hq, hkv, sq, skv, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hq, sq, d), dtype=np.float32))


def _grads(q, k, v, w, tile=None, **kw):
    """(JAX's gradients, the port's gradients, the port's route) of
    sum(flash_attention(q, k, v) * w) in q, k and v."""
    jtile = None if tile is None else jnp.bfloat16
    ttile = None if tile is None else torch.bfloat16
    jkw = {n: (jax_common.BlockSizes(*dataclasses.astuple(x))
               if isinstance(x, common.BlockSizes) else x) for n, x in kw.items()}
    g_j = jax.grad(lambda *x: jnp.sum(jax_attention.flash_attention(
        *x, force_kernel=True, tile_dtype=jtile, **jkw) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    calls = []
    fused, split = fa2_backward.fa2_backward_fused_plain, fa2_backward.fa2_backward_dq_plain
    try:
        fa2_backward.fa2_backward_fused_plain = lambda *a, **k: calls.append("fused") or fused(*a, **k)
        fa2_backward.fa2_backward_dq_plain = lambda *a, **k: calls.append("split") or split(*a, **k)
        o = attention.flash_attention(*ts, tile_dtype=ttile, **kw)
        g_t = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    finally:
        fa2_backward.fa2_backward_fused_plain = fused
        fa2_backward.fa2_backward_dq_plain = split
    return [np.asarray(g) for g in g_j], [g.numpy() for g in g_t], calls


def _check(g_j, g_t, tile):
    for got, want in zip(g_t, g_j):
        assert got.shape == want.shape
        if tile is None:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# (Sq, window, sinks, causal, route): causal windows of 128 and 200 at S 512
# (narrow, no sinks: the split pair), sinks 32 with window 100 (the fused
# B2), a band of offset -100 whose last rows keep no key (not causal: the
# rule's window clause does not apply, the fused B2).  GQA 4/2.
CASES = [
    (512, 128, 0, True, "split"), (512, 200, 0, True, "split"),
    (512, 100, 32, True, "fused"), (256, -100, 0, False, "fused"),
]


@pytest.mark.parametrize("s,window,sinks,causal,route,tile", [
    c + (tile,) for c in CASES for tile in (None, "bf16")
    if tile is None or c[1] in (128, -100)], ids=str)
def test_windowed_grads_match_jax(s, window, sinks, causal, route, tile):
    q, k, v, w = _inputs(1, 4, 2, s, s, seed=s + abs(window))
    g_j, g_t, calls = _grads(q, k, v, w, tile, causal=causal, window=window,
                             sinks=sinks)
    _check(g_j, g_t, tile)
    assert calls == [route]


@pytest.mark.parametrize("bs,route", [(None, "fused"),
                                      (common.BlockSizes(128, 128, 128, 128, 128, 128),
                                       "split")], ids=["default", "128-row blocks"])
def test_both_routes_forced_by_block_sizes(bs, route):
    """Window 576 with 4 sinks at S 1152 (B1 H1 D32): the default blocks
    give the fused B2; 128-row blocks give nine KV slices, more than the
    fused route's eight, and the split pair (as JAX's rule)."""
    q, k, v, w = _inputs(1, 1, 1, 1152, 1152, d=32, seed=5)
    kw = dict(causal=True, window=576, sinks=4)
    if bs is not None:
        kw["block_sizes"] = bs
    g_j, g_t, calls = _grads(q, k, v, w, **kw)
    _check(g_j, g_t, None)
    assert calls == [route]


def test_standalone_fa2_backward_with_a_window_matches_jax():
    """fa2_backward(window=) from forward artifacts, as JAX's (no sinks):
    window 128 at S 512 takes the split pair in both."""
    q, k, v, w = _inputs(1, 4, 2, 512, 512, seed=8)
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=128,
        force_kernel=True)
    want = jax_attention.fa2_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j, lse_j, jnp.asarray(w),
        causal=True, window=128, interpret=True)
    got = attention.fa2_backward(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(np.asarray(o_j)),
        torch.from_numpy(np.asarray(lse_j)), torch.from_numpy(w), causal=True,
        window=128)
    _check([np.asarray(x) for x in want], [x.numpy() for x in got], None)


@pytest.mark.parametrize("tile", [None, "bf16"], ids=["fp32", "bf16"])
def test_dead_rows_on_the_reference_tiles(tile):
    """Causal, window 520, Sq 1500, Skv 700: JAX's 512-row tile from row
    1024 still walks a key tile, so its dead rows' lse is the mask value
    times ln 2 where 128-row tiles would give -inf (rows 1408-1499).  The
    port's lse equals JAX's bit for bit on every dead row; in fp32 the
    dead rows' dQ is exactly 0 and the gradients match JAX's."""
    q, k, v, w = _inputs(1, 2, 1, 1500, 700, seed=5)
    jtile = None if tile is None else jnp.bfloat16
    ttile = None if tile is None else torch.bfloat16
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=520,
        force_kernel=True, tile_dtype=jtile)
    o_t, lse_t = attention.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=520,
        tile_dtype=ttile)
    lse_j, lse_t = np.asarray(lse_j), lse_t.numpy()
    dead = lse_j < -1e30
    assert dead.sum() == 2 * (1500 - (700 + 520 - 1))
    assert np.isfinite(lse_j[dead]).all()  # the mask value, not -inf
    np.testing.assert_array_equal(lse_t[dead], lse_j[dead])
    np.testing.assert_array_equal(o_t.numpy()[dead], 0.0)
    if tile is None:  # the gradients once, in fp32
        g_j, g_t, _ = _grads(q, k, v, w, tile, causal=True, window=520)
        _check(g_j, g_t, tile)
        assert (g_t[0][dead] == 0).all()


def test_dead_row_lse_follows_block_sizes():
    """The dead rows' lse follows the tiles of the call's BlockSizes: with
    128-row blocks the same call's rows 1408-1499 read -inf in both
    packages."""
    q, k, v, _ = _inputs(1, 1, 1, 1500, 700, d=32, seed=6)
    bs = (128,) * 6
    _, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=520,
        force_kernel=True, block_sizes=jax_common.BlockSizes(*bs))
    _, lse_t = attention.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=520,
        block_sizes=common.BlockSizes(*bs))
    lse_j, lse_t = np.asarray(lse_j), lse_t.numpy()
    dead = lse_j < -1e30
    np.testing.assert_array_equal(lse_t[dead], lse_j[dead])
    assert np.isinf(lse_j[dead]).any() and np.isfinite(lse_j[dead]).any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 512, 2048])
@pytest.mark.parametrize("window,sinks", [(None, 0), (64, 0), (64, 4), (100, 0),
                                          (128, 0), (200, 0), (256, 0), (300, 2),
                                          (600, 0), (1024, 0), (-100, 0)])
def test_use_fused_bwd_matches_jax(causal, s, window, sinks):
    """The route rule, case for case, on padded shapes (B4 Hq16 Hkv8 D64,
    bf16 tiles) with the blocks of BlockSizes.default(causal, window)."""
    if causal and window is not None and window < 1:
        return
    q = torch.empty(4, 16, s, 64)
    k = torch.empty(4, 8, s, 64)
    block = common.fit_block(common.BlockSizes.default(causal, window=window)
                             .block_k_dkv, s)
    want = jax_attention._use_fused_bwd(q, k, block, window, causal, sinks)
    assert attention._use_fused_bwd(q, k, block, torch.bfloat16, window, causal,
                                    sinks) == want


@pytest.mark.parametrize("kw,want", [
    (dict(window=32, global_every=2), [32, None]),
])
def test_windowed_model_loss_and_grads_match_jax(kw, want):
    """The tiny hybrid model (window 32, every other layer global): the
    loss and every gradient leaf against JAX's loss_fn in fp32
    (tests/test_window.py:183)."""
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(), dtype=jnp.float32,
                                attn_tile_dtype=None, attn_window=kw["window"],
                                global_every=kw.get("global_every", 0),
                                attn_sinks=kw.get("sinks", 0))
    cfg_t = transformer.TransformerConfig.tiny(
        dtype=torch.float32, attn_tile_dtype=None, attn_window=kw["window"],
        global_every=kw.get("global_every", 0), attn_sinks=kw.get("sinks", 0))
    assert [cfg_t.layer_window(i) for i in range(2)] == want
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 65)).astype(np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_tf.loss_fn),
                              static_argnums=2)(params_j, jnp.asarray(tokens), cfg_j)
    loss_t, grads_t = transformer.value_and_grad(
        params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"),
        torch.from_numpy(tokens).long(), cfg_t)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    leaves_t, leaves_j = transformer.tree_leaves(grads_t), jax.tree.leaves(grads_j)
    assert len(leaves_t) == len(leaves_j)
    for g, w in zip(leaves_t, leaves_j):
        w = np.asarray(w, np.float32)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)


# (Sq, Skv, kv_len, causal, window, sinks): causal windows inside a tile and
# across several, sinks in the first tile and past it, a band whose last
# rows keep no key, Sq > Skv + window.
WALKS = [(512, 512, 512, True, 128, 0), (512, 512, 500, True, 100, 4),
         (700, 700, 700, True, 100, 130), (1024, 1024, 1024, False, -100, 0),
         (384, 256, 200, True, 64, 0), (512, 512, 512, False, 64, 3)]


def _mask(sq, skv, kv_len, causal, window, sinks):
    return common.build_element_mask(sq, skv, causal=causal, kv_len=kv_len,
                                     device="cpu", window=window,
                                     sinks=sinks).expand(sq, skv)


@pytest.mark.parametrize("fp32", [False, True], ids=["16-bit tiles", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,kv_len,causal,window,sinks", WALKS, ids=str)
def test_windowed_walks_follow_the_mask(sq, skv, kv_len, causal, window, sinks,
                                        d, fp32):
    """B2's and B4's walk (QWalk's twin) visits Q tile qt from KV tile kt,
    and B3's walk (KvWalk's twin) KV tile kt from Q tile qt, exactly when
    the two tiles hold a kept pair: the walks describe what the kernels
    walk.  B2's reduce reads, for each row, every slice that holds a key it
    keeps and only slices B2 wrote for it."""
    live = _mask(sq, skv, kv_len, causal, window, sinks)
    bq = fa2_backward.fused_q_tile(d, fp32)
    bk = fa2_backward._FUSED_KV_TILE[0 if fp32 else 1]
    kv_walks = fa2_backward.fused_live_q_tiles(sq, skv, kv_len, causal, d, fp32,
                                               window, sinks)
    for kt, walked in enumerate(kv_walks):
        for qt in range(-(-sq // bq)):
            block = live[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            assert (qt in walked) == bool(block.any()), (kt, qt)
    bn, bq3 = fa2_backward.dq_kv_tile(d, fp32), 64 if fp32 else 128
    for qt, walked in enumerate(fa2_backward.dq_kv_tiles(sq, kv_len, causal, d,
                                                         fp32, window, sinks)):
        assert list(walked) == sorted(set(walked))
        for kt in range(-(-skv // bn)):
            block = live[qt * bq3:(qt + 1) * bq3, kt * bn:(kt + 1) * bn]
            assert (kt in walked) == bool(block.any()), (qt, kt)
    for r in range(sq):
        read = fa2_backward.reduce_kv_tiles(r, kv_len, causal, bk, window, sinks)
        keeps = {c // bk for c in torch.nonzero(live[r]).flatten().tolist()}
        assert keeps <= set(read) and read == sorted(read)
        assert all(r // bq in kv_walks[kt] for kt in read)
