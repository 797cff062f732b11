"""Port parity: the small-shape FA2 forward (kernel B8) against the JAX
package's fa2_forward_small_aligned, through flash_attention_with_lse on the
same numpy inputs.

The JAX side runs with force_kernel=True, so that its small-shape Pallas
kernel (in interpret mode here) is the reference and not the small-fp32 XLA
route; the port runs B8's plain version on the CPU.  Tolerances: fp32 at
the JAX fp32 gate (2e-6 on O, 1e-5 on lse); bf16 and fp16 tiles at the JAX
reduced-tile gate, 2e-2 (tests/test_fa2_forward.py).  The CUDA kernel is
held to its plain version on the card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import common as jax_common
from cuda_flash_attention_tpu_torch.kernels import attention, common, fa2_forward
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

TILES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
         "fp16": (jnp.float16, torch.float16)}
TOL = {"fp32": (2e-6, 1e-5), "bf16": (2e-2, 2e-2), "fp16": (2e-2, 2e-2)}


def _inputs(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d), dtype=np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [32, 100, 128])
def test_small_forward_matches_jax_kernel(s, causal, precision):
    q, k, v = _inputs(2, 2, s, 64, seed=s)
    jax_tile, torch_tile = TILES[precision]
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        tile_dtype=jax_tile, force_kernel=True)
    before = LAUNCHES["fa2_forward_small"]
    o_t, lse_t = attention.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        tile_dtype=torch_tile)
    assert LAUNCHES["fa2_forward_small"] == before  # the CPU runs the plain version
    assert o_t.shape == (2, 2, s, 64) and lse_t.shape == (2, 2, s)
    tol_o, tol_lse = TOL[precision]
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=tol_o, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=tol_lse,
                               rtol=0)


def _jax_takes_small_kernel(sq, skv, hq, hkv, dtype) -> bool:
    """The condition of JAX attention.py:273-277 on the JAX package's own
    padded lengths."""
    sq_pad = -(-sq // jax_common.seq_pad_quantum(sq, dtype)) * \
        jax_common.seq_pad_quantum(sq, dtype)
    skv_pad = -(-skv // jax_common.seq_pad_quantum(skv, dtype)) * \
        jax_common.seq_pad_quantum(skv, dtype)
    return sq_pad <= jax_common.MIN_BLOCK and skv_pad == sq_pad and hkv == hq


@pytest.mark.parametrize("sq,skv,hq,hkv", [
    (32, 32, 4, 4), (100, 100, 4, 4), (128, 128, 2, 2), (129, 129, 2, 2),
    (100, 100, 4, 2), (64, 100, 2, 2), (100, 97, 2, 2), (1, 1, 2, 2),
    (256, 256, 2, 2), (120, 128, 2, 2),
])
@pytest.mark.parametrize("jax_dtype,torch_dtype", [
    (jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_route_takes_b8_exactly_where_jax_does(sq, skv, hq, hkv, jax_dtype,
                                              torch_dtype, monkeypatch):
    """Decided on padded shapes: S 100 pads to 104 in fp32 and 112 in bf16,
    S 97 to 104 / 112 as well, so (100, 97) takes B8 and (120, 128) takes
    it in bf16 only."""
    calls = []
    for name in ("fa2_forward_small_aligned", "fa2_forward_aligned"):
        real = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    q = torch.zeros(1, hq, sq, 64, dtype=torch_dtype)
    k = torch.zeros(1, hkv, skv, 64, dtype=torch_dtype)
    attention.flash_attention_with_lse(q, k, k)
    want = _jax_takes_small_kernel(sq, skv, hq, hkv, jax_dtype)
    assert calls == ["fa2_forward_small_aligned" if want else "fa2_forward_aligned"]
    assert common.seq_pad_quantum(sq, torch_dtype) == \
        jax_common.seq_pad_quantum(sq, jax_dtype)


def test_small_kernel_refuses_what_is_not_one_tile():
    x = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError):
        fa2_forward.fa2_forward_small_aligned(x, x, x, causal=False,
                                              sm_scale=0.125, kv_len=256)
