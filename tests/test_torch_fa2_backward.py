"""Port parity: the FA2 backward of cuda_flash_attention_tpu_torch against the
JAX package's, on the same numpy inputs.

On the CPU the port runs the plain versions of kernels B2, B3 and B4
(fa2_backward_*_plain); the JAX kernels run in interpret mode.  O and lse
come from the port's forward on the same inputs and go to both sides.
Errors are taken relative to the JAX output's own max |value|: fp32 1e-5,
bf16 tiles 5e-2 (the JAX bf16-tile grad gate, tests/test_fa2_backward.py).
GQA 4/2 throughout.  The JAX blocks stay at or below 128 rows in fp32 so
that the JAX side multiplies in native fp32 (its lane-packed emulation
starts at 256 rows, kernels/common.py:307).  The CUDA kernels are held to
these plain versions on the card by tests/test_torch_kernels_gpu.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import fa2_backward as jax_bwd
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes, fit_block
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

B, HQ, HKV, D = 1, 4, 2, 64
TOL = {None: 1e-5, torch.bfloat16: 5e-2}
SPLIT = BlockSizes(128, 128, 128, 128, 128, 128)


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _jnp(t):
    return jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())


def _jtile(tile):
    return None if tile is None else jnp.bfloat16


def _problem(s, causal, tile, seed):
    """Padded inputs as the autograd path builds them: q, k, v, dO from
    numpy, O and lse from the port's forward over the padded problem."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, HQ, s, D), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, HKV, s, D), dtype=np.float32))
            for _ in range(2))
    q, k, v, sm_scale, q_len, kv_len = attention._prepare(
        q, k, v, causal, None, tile, None, None, None, 0)
    o, lse = fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len, tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - s))
    di = (o.float() * do.float()).sum(-1)
    return types.SimpleNamespace(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di,
                                 sm_scale=sm_scale, kv_len=kv_len, causal=causal,
                                 tile=tile)


def _kw(p):
    return dict(causal=p.causal, sm_scale=p.sm_scale, kv_len=p.kv_len,
                tile_dtype=p.tile)


def _jax_kw(p, block):
    return dict(causal=p.causal, sm_scale=p.sm_scale, kv_len=p.kv_len,
                tile_dtype=_jtile(p.tile), kv_groups=HQ // HKV,
                block_q=min(block, p.q.shape[2]), block_k=min(block, p.k.shape[2]))


# (seq, causal): S 100 pads to the fp32 quantum (104, one block); S 200 pads
# to 256 (two 128-row blocks, a ragged KV tail of 56 keys).
CASES = [(100, True), (100, False), (200, True), (200, False)]


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("s,causal", CASES, ids=str)
def test_fused_plain_matches_jax_kernel(tile, s, causal):
    p = _problem(s, causal, tile, seed=s)
    got = fa2_backward.fa2_backward_fused_aligned(p.q, p.k, p.v, p.o, p.do, p.lse,
                                                  **_kw(p))
    want = jax_bwd.fa2_backward_fused_aligned(
        _jnp(p.q), _jnp(p.k), _jnp(p.v), _jnp(p.do), _jnp(p.lse)[..., None],
        None, o=_jnp(p.o), **_jax_kw(p, 128))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == p.q.shape if name == "dq" else g.shape == p.k.shape
        assert _rel_err(g.numpy(), w) <= TOL[tile], name


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("s,causal", CASES, ids=str)
def test_dq_plain_matches_jax_kernel(tile, s, causal):
    p = _problem(s, causal, tile, seed=s + 1)
    got = fa2_backward.fa2_backward_dq_aligned(p.q, p.k, p.v, p.do, p.lse, p.di,
                                               **_kw(p))
    want = jax_bwd.fa2_backward_dq_aligned(
        _jnp(p.q), _jnp(p.k), _jnp(p.v), _jnp(p.do), _jnp(p.lse)[..., None],
        _jnp(p.di)[..., None], **_jax_kw(p, 128))
    assert _rel_err(got.numpy(), want) <= TOL[tile]


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("s,causal", CASES + [(256, True), (256, False)], ids=str)
def test_dkv_plain_matches_jax_kernel(tile, s, causal):
    """At S 256 the JAX kernel runs two 128-row blocks each way, so its
    inner (group, Q block) sweep and its causal tile skip are exercised."""
    p = _problem(s, causal, tile, seed=s + 2)
    got = fa2_backward.fa2_backward_dkv_aligned(p.q, p.k, p.v, p.do, p.lse, p.di,
                                                **_kw(p))
    want = jax_bwd.fa2_backward_dkv_aligned(
        _jnp(p.q), _jnp(p.k), _jnp(p.v), _jnp(p.do), _jnp(p.lse)[..., None],
        _jnp(p.di)[..., None], **_jax_kw(p, 128))
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w) <= TOL[tile]


# (seq, causal, tile, input dtype): fp32 stays at S <= 128 (see the module
# note); bf16 tiles and bf16 inputs at S 256 and the ragged 200.
GRAD_CASES = [
    (100, True, None, torch.float32),
    (128, False, None, torch.float32),
    (256, True, torch.bfloat16, torch.float32),
    (200, False, torch.bfloat16, torch.float32),
    (256, True, None, torch.bfloat16),
]


@pytest.mark.parametrize("s,causal,tile,dtype", GRAD_CASES, ids=str)
def test_autograd_matches_jax_grad(s, causal, tile, dtype):
    rng = np.random.default_rng(s + 3)
    shapes = [(B, HQ, s, D), (B, HKV, s, D), (B, HKV, s, D)]
    qkv = [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]
    w = rng.standard_normal((B, HQ, s, D), dtype=np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jloss(q, k, v):
        o = jax_attention.flash_attention(q, k, v, causal=causal,
                                          tile_dtype=_jtile(tile),
                                          force_kernel=True)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in qkv))
    ts = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in qkv]
    o = attention.flash_attention(*ts, causal=causal, tile_dtype=tile)
    got = torch.autograd.grad((o.float() * torch.from_numpy(w)).sum(), ts)
    for g, wj, x in zip(got, want, ts):
        assert g.shape == x.shape and g.dtype == dtype
        assert _rel_err(g.float().numpy(), np.asarray(wj, np.float32)) <= \
            TOL[torch.bfloat16 if dtype == torch.bfloat16 else tile]


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_unequal_lengths_matches_jax_grad(causal):
    """Cross-length attention (q 64 rows, kv 120): causal keeps col <= row
    from the top-left corner, as the JAX kernels do."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((B, HQ, 64, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, HKV, 120, D), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((B, HQ, 64, D), dtype=np.float32)

    def jloss(q, k, v):
        o = jax_attention.flash_attention(q, k, v, causal=causal, force_kernel=True)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = attention.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    for g, wj in zip(got, want):
        assert _rel_err(g.numpy(), wj) <= TOL[None]


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_cross_lengths_over_several_tiles_match_jax_grad(causal):
    """Sq 300 over Skv 100 (rows past kv_len under causal masking, a ragged
    KV tail) through B1's forward and the backward kernels' plain
    versions, against jax.grad of the JAX kernels."""
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, HQ, 300, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, HKV, 100, D), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((B, HQ, 300, D), dtype=np.float32)

    def jloss(q, k, v):
        o = jax_attention.flash_attention(q, k, v, causal=causal, force_kernel=True)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = attention.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    for g, wj in zip(got, want):
        assert _rel_err(g.numpy(), wj) <= TOL[None]


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
def test_fa2_backward_default_do_is_ones(tile):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, HQ, 120, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, HKV, 120, D), dtype=np.float32) for _ in range(2))
    o, lse = attention.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True, tile_dtype=tile)
    got = attention.fa2_backward(*(torch.from_numpy(x) for x in (q, k, v)), o, lse,
                                 causal=True, tile_dtype=tile)
    ones = attention.fa2_backward(*(torch.from_numpy(x) for x in (q, k, v)), o, lse,
                                  torch.ones_like(o), causal=True, tile_dtype=tile)
    want = jax_attention.fa2_backward(
        *(jnp.asarray(x) for x in (q, k, v)), _jnp(o), _jnp(lse), causal=True,
        tile_dtype=_jtile(tile))
    for g, g1, w in zip(got, ones, want):
        np.testing.assert_array_equal(g.numpy(), g1.numpy())
        assert _rel_err(g.numpy(), w) <= TOL[tile]


# (batch, q heads, seq, head_dim, dtype, tile, block_k_dkv): padded shapes.
ROUTE_TABLE = [
    (4, 16, 2048, 64, torch.bfloat16, torch.bfloat16, 1024),  # base train step
    (4, 16, 2048, 64, torch.bfloat16, torch.bfloat16, 128),   # 16 slices
    (1, 4, 256, 64, torch.float32, None, 2048),
    (1, 4, 104, 64, torch.float32, None, 1024),
    (16, 16, 1024, 64, torch.bfloat16, torch.bfloat16, 1024),
    (1, 16, 4096, 128, torch.bfloat16, torch.bfloat16, 512),  # 8 slices, 1 GiB
    (1, 8, 1152, 64, torch.float32, torch.bfloat16, 128),     # 9 slices
]


@pytest.mark.parametrize("row", ROUTE_TABLE, ids=str)
def test_use_fused_bwd_matches_jax(row):
    b, h, s, d, dtype, tile, bk = row
    q = types.SimpleNamespace(shape=(b, h, s, d), dtype=dtype)
    k = types.SimpleNamespace(shape=(b, h // 2, s, d), dtype=dtype)
    from cuda_flash_attention_tpu.kernels.common import fit_block as jax_fit

    bk = jax_fit(bk, s)
    assert attention._use_fused_bwd(q, k, bk, tile) == \
        jax_attention._use_fused_bwd(q, k, bk)


@pytest.mark.parametrize("causal", [False, True])
def test_block_sizes_default_matches_jax(causal):
    from cuda_flash_attention_tpu.kernels.common import BlockSizes as JaxBlockSizes

    assert dataclasses.astuple(BlockSizes.default(causal)) == \
        dataclasses.astuple(JaxBlockSizes.default(causal))


def test_block_sizes_default_raises_on_a_window():
    """Refused until sliding windows were ported; now the JAX rule."""
    from cuda_flash_attention_tpu.kernels.common import BlockSizes as JaxBlockSizes

    assert dataclasses.astuple(BlockSizes.default(True, window=256)) == \
        dataclasses.astuple(JaxBlockSizes.default(True, window=256))


@pytest.mark.parametrize("b,s", [(16, 2048), (2, 8192)])
def test_use_fused_bwd_caps_the_ports_own_buffer(b, s):
    """Where the JAX rule takes the fused route on its 1024-row slices, the
    port's 128-row dQ slices exceed 1 GiB: the port takes the split route."""
    q = types.SimpleNamespace(shape=(b, 16, s, 64), dtype=torch.bfloat16)
    k = types.SimpleNamespace(shape=(b, 8, s, 64), dtype=torch.bfloat16)
    assert jax_attention._use_fused_bwd(q, k, 1024)
    assert not attention._use_fused_bwd(q, k, 1024, torch.bfloat16)


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
def test_fused_and_split_routes_agree(tile):
    """S 1100 pads to 1152: the default blocks give 2 KV slices (fused),
    128-row blocks give 9 (split)."""
    p = _problem(1100, True, tile, seed=11)
    assert attention._use_fused_bwd(p.q, p.k, fit_block(1024, 1152), tile)
    assert not attention._use_fused_bwd(p.q, p.k, 128, tile)
    args = (p.q, p.k, p.v, p.o, p.lse, p.do, p.kv_len, True, p.sm_scale)
    fused = attention._backward(*args, BlockSizes.default(True), tile)
    split = attention._backward(*args, SPLIT, tile)
    for f, s in zip(fused, split):
        assert _rel_err(f.numpy(), s.numpy()) <= TOL[tile]


def test_cpu_tensors_never_launch_a_kernel():
    before = (LAUNCHES["fa2_backward_fused"], LAUNCHES["fa2_backward_dq"],
              LAUNCHES["fa2_backward_dkv"])
    rng = np.random.default_rng(12)
    ts = [torch.from_numpy(rng.standard_normal((1, h, 64, D), dtype=np.float32))
          .requires_grad_(True) for h in (HQ, HKV, HKV)]
    for bs in (None, SPLIT):
        o = attention.flash_attention(*ts, causal=True, block_sizes=bs)
        torch.autograd.grad(o.sum(), ts)
    assert (LAUNCHES["fa2_backward_fused"], LAUNCHES["fa2_backward_dq"],
            LAUNCHES["fa2_backward_dkv"]) == before


def test_with_lse_is_not_differentiable():
    x = torch.zeros(1, 2, 32, D, requires_grad=True)
    o, lse = attention.flash_attention_with_lse(x, x, x, causal=True)
    assert not o.requires_grad and not lse.requires_grad
