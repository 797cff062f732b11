"""Port parity: the FA2 forward API of cuda_flash_attention_tpu_torch against
the JAX package's, on the same numpy inputs.

On the CPU the port runs the plain version of kernel B1 (fa2_forward_plain);
the JAX side is called with force_kernel=True so that its reference is the
Pallas kernel (in interpret mode here) and not the small-fp32 XLA route.
Tolerances: fp32 at the JAX fp32 gate (2e-6 on O) and 1e-5 on lse; bf16
tiles at the JAX bf16-tile gate, 2e-2 (tests/test_fa2_forward.py).
The CUDA kernel is held to this plain version on the card by
tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import common as jax_common
from cuda_flash_attention_tpu_torch.kernels import attention, common
from cuda_flash_attention_tpu_torch.kernels import fa2_forward
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

# (batch, q heads, kv heads, seq, head_dim, causal)
SHAPES = [
    (1, 2, 2, 128, 64, True),
    (1, 2, 2, 128, 64, False),
    (1, 4, 2, 100, 64, True),    # GQA 4/2, ragged S
    (2, 4, 2, 256, 64, False),
]


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, s, d), dtype=np.float32)
    return q, k, v


def _both(q, k, v, causal, tile):
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        tile_dtype=None if tile is None else jnp.bfloat16, force_kernel=True,
    )
    o_t, lse_t = attention.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, tile_dtype=tile,
    )
    return (np.asarray(o_j), np.asarray(lse_j)), (o_t.numpy(), lse_t.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fp32_matches_jax_kernel(shape):
    b, hq, hkv, s, d, causal = shape
    (o_j, lse_j), (o_t, lse_t) = _both(*_inputs(b, hq, hkv, s, d), causal, None)
    assert o_t.shape == (b, hq, s, d) and lse_t.shape == (b, hq, s)
    np.testing.assert_allclose(o_t, o_j, atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES[::2], ids=str)
def test_bf16_tiles_match_jax_kernel(shape):
    b, hq, hkv, s, d, causal = shape
    (o_j, lse_j), (o_t, lse_t) = _both(*_inputs(b, hq, hkv, s, d, seed=1),
                                       causal, torch.bfloat16)
    np.testing.assert_allclose(o_t, o_j, atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=2e-2, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_unequal_q_and_kv_lengths_match_jax_kernel(causal):
    """Cross-length attention (q 64 rows, kv 200): causal keeps col <= row
    from the top-left corner, as the JAX kernel does."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 64, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, 200, 64), dtype=np.float32)
    v = rng.standard_normal((1, 2, 200, 64), dtype=np.float32)
    (o_j, lse_j), (o_t, lse_t) = _both(q, k, v, causal, None)
    np.testing.assert_allclose(o_t, o_j, atol=2e-6, rtol=0)
    np.testing.assert_allclose(lse_t, lse_j, atol=1e-5, rtol=0)


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(300, 100), (128, 384)])
def test_cross_lengths_over_several_tiles_match_jax_kernel(sq, skv, causal, tile):
    """Sq > Skv and Sq < Skv across several 128-row tiles, with ragged
    tails on both sides (B1's 128-row Q and KV tiles meet the causal
    diagonal and the kv_len mask at these edges)."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((1, 4, sq, 64), dtype=np.float32)
    k = rng.standard_normal((1, 2, skv, 64), dtype=np.float32)
    v = rng.standard_normal((1, 2, skv, 64), dtype=np.float32)
    (o_j, lse_j), (o_t, lse_t) = _both(q, k, v, causal, tile)
    assert o_t.shape == q.shape and lse_t.shape == q.shape[:3]
    if tile is None:
        np.testing.assert_allclose(o_t, o_j, atol=2e-6, rtol=0)
        np.testing.assert_allclose(lse_t, lse_j, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(o_t, o_j, atol=2e-2, rtol=0)
        np.testing.assert_allclose(lse_t, lse_j, atol=2e-2, rtol=0)


@pytest.mark.parametrize("tile", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_kv_cast_to_the_tile_type_moves_no_rounding(tile, causal):
    """The kernel's wrapper casts fp32 K and V to the tile type before the
    launch (TMA copies bytes and cannot convert).  The plain version casts
    them at the same point, so the result is the same to the bit."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 200, 64, seed=7))
    kw = dict(causal=causal, sm_scale=0.125, kv_len=190, tile_dtype=tile)
    o_cast, lse_cast = fa2_forward.fa2_forward_plain(q, k.to(tile), v.to(tile), **kw)
    o, lse = fa2_forward.fa2_forward_plain(q, k, v, **kw)
    assert o_cast.dtype == o.dtype == torch.float32
    assert torch.equal(o_cast, o) and torch.equal(lse_cast, lse)


def test_bf16_inputs_keep_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 4, 2, 64, 64, seed=2))
    o = attention.flash_attention(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert torch.isfinite(o.float()).all()


def test_cpu_tensors_never_launch_the_kernel():
    before = LAUNCHES["fa2_forward"]
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 32, 64))
    attention.flash_attention(q, k, v, causal=True)
    assert LAUNCHES["fa2_forward"] == before


@pytest.mark.parametrize("kwargs,exc", [
    (dict(window=8, causal=True), None),
    (dict(q_segment_ids=torch.zeros(1, 32, dtype=torch.int32),
          kv_segment_ids=torch.zeros(1, 32, dtype=torch.int32)),
     NotImplementedError),
    (dict(sinks=2), ValueError),
    (dict(tile_dtype=torch.float8_e4m3fn), NotImplementedError),
])
def test_unported_options_raise(kwargs, exc):
    """Options the port refuses raise; a sliding window (exc None), refused
    until windows were ported, now gives the JAX API's output."""
    q, k, v = _inputs(1, 2, 2, 32, 64)
    if exc is None:
        o_j = jax_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), force_kernel=True,
            **kwargs)
        o_t = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kwargs)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-6, rtol=0)
        return
    with pytest.raises(exc):
        attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kwargs)


def test_covering_window_folds_away():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 32, 64))
    np.testing.assert_array_equal(
        attention.flash_attention(q, k, v, causal=True, window=32).numpy(),
        attention.flash_attention(q, k, v, causal=True).numpy(),
    )


@pytest.mark.parametrize("seq_len", [1, 31, 100, 128, 129, 300])
@pytest.mark.parametrize("np_dtype,torch_dtype", [
    (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
    (jnp.int8, torch.int8),
])
def test_seq_pad_quantum_matches_jax(seq_len, np_dtype, torch_dtype):
    assert common.seq_pad_quantum(seq_len, torch_dtype) == \
        jax_common.seq_pad_quantum(seq_len, np_dtype)


@pytest.mark.parametrize("requested,padded", [
    (2048, 128), (2048, 384), (512, 1280), (256, 96), (1024, 3072),
])
def test_fit_block_matches_jax(requested, padded):
    assert common.fit_block(requested, padded) == \
        jax_common.fit_block(requested, padded)


def test_pad_to_block_matches_jax():
    x = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    for axis in range(3):
        np.testing.assert_array_equal(
            common.pad_to_block(torch.from_numpy(x), axis, 4).numpy(),
            np.asarray(jax_common.pad_to_block(jnp.asarray(x), axis, 4)),
        )
