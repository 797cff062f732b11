"""B10 (naive FA2) on the CPU: its plain version against the JAX kernel in
interpret mode, at shapes with several KV and Q tiles, Sq != Skv and kv_len
inside the last tile, D 64 and 128; the CUDA kernel is held to this plain
version on the card by tests/test_torch_kernels_gpu.py.

The JAX kernel takes fixed 128-row blocks (so Sq and Skv are multiples of
128 here) and renormalises O once per 128 keys; the plain version, like the
CUDA kernel, once per 64 (baselines.KV_TILE).  The two re-round O at
different tiles, yet every case stays within the JAX fp32 gate of 2e-6
absolute (readings 1.5e-7 to 3.0e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import baselines as jax_baselines
from cuda_flash_attention_tpu_torch.kernels import baselines
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

# (Sq, Skv padded, kv_len, D): Sq < Skv, Sq > Skv, kv_len inside the last
# 64-row tile and inside the last 128-row block.
NAIVE_CASES = [(256, 384, 384, 64), (128, 256, 200, 128), (384, 128, 100, 64),
               (256, 512, 512, 128), (128, 384, 300, 64)]


@pytest.mark.parametrize("sq,skv,kv_len,d", NAIVE_CASES, ids=str)
def test_naive_fa2_plain_matches_jax_kernel_over_several_tiles(sq, skv, kv_len, d):
    rng = np.random.default_rng(sq + skv + d)
    q = rng.standard_normal((1, 2, sq, d), dtype=np.float32)
    k, v = (rng.standard_normal((1, 2, skv, d), dtype=np.float32)
            for _ in range(2))
    scale = d ** -0.5
    want = jax_baselines._naive_fa2_aligned(
        *(jnp.asarray(x) for x in (q, k, v)), sm_scale=scale, kv_len=kv_len,
        interpret=True)
    before = LAUNCHES["naive_fa2"]
    got = baselines.naive_fa2_aligned(*(torch.from_numpy(x) for x in (q, k, v)),
                                      sm_scale=scale, kv_len=kv_len)
    assert LAUNCHES["naive_fa2"] == before  # the plain version ran
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
