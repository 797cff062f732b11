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


def test_bf16_inputs_keep_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 4, 2, 64, 64, seed=2))
    o = attention.flash_attention(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert torch.isfinite(o.float()).all()


def test_cpu_tensors_never_launch_the_kernel():
    before = fa2_forward.launches
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 32, 64))
    attention.flash_attention(q, k, v, causal=True)
    assert fa2_forward.launches == before


@pytest.mark.parametrize("kwargs,exc", [
    (dict(window=8, causal=True), NotImplementedError),
    (dict(q_segment_ids=torch.zeros(1, 32, dtype=torch.int32),
          kv_segment_ids=torch.zeros(1, 32, dtype=torch.int32)),
     NotImplementedError),
    (dict(sinks=2), ValueError),
    (dict(tile_dtype=torch.float16), NotImplementedError),
])
def test_unported_options_raise(kwargs, exc):
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 32, 64))
    with pytest.raises(exc):
        attention.flash_attention(q, k, v, **kwargs)


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
