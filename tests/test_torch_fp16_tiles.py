"""Port parity with fp16 tiles: the FA2 forward (B1) and backward (B2 fused;
B3 + B4 split) of cuda_flash_attention_tpu_torch against the JAX package's
kernels with tile_dtype=float16, on the same numpy inputs.

The JAX kernels (interpret mode here) emulate fp16 tiles as a 10-bit
mantissa in fp32; the port's plain versions round to real fp16, as the CUDA
kernels do.  The two agree in fp16's normal range; above 65504 real fp16
overflows and P below 2^-14 is subnormal (common.TILE_DTYPES).  Tolerances:
forward 2e-2 (the JAX reduced-tile forward gate, tests/test_fa2_forward.py);
gradients 5e-3 (the JAX fp16-tile grad gate, tests/test_fa2_backward.py),
relative to the JAX output's max |value| (through autograd, on uniform
inputs where |dQ| is near the gate, also absolute).  GQA 4/2 throughout, so the
forward takes B1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import fa2_backward as jax_bwd
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain

B, HQ, HKV, D = 1, 4, 2, 64
FP16 = torch.float16


def _uniform(seed, s):
    rng = np.random.default_rng(seed)
    return (rng.random((B, HQ, s, D), dtype=np.float32),
            rng.random((B, HKV, s, D), dtype=np.float32),
            rng.random((B, HKV, s, D), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [256, 512])
def test_fp16_tile_forward_matches_jax_kernel(s, causal):
    rng = np.random.default_rng(s)
    q = rng.standard_normal((B, HQ, s, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, HKV, s, D), dtype=np.float32) for _ in range(2))
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        tile_dtype=jnp.float16, force_kernel=True)
    o_t, lse_t = attention.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, tile_dtype=FP16)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-2, rtol=0)


def _problem(s, causal, seed):
    """Padded inputs as the autograd path builds them, O and lse from the
    port's plain forward."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, HQ, s, D), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, HKV, s, D), dtype=np.float32))
            for _ in range(2))
    q, k, v, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, FP16, None, None, None, 0)
    o, lse = fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len, tile_dtype=FP16)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - s))
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    jax_kw = dict(kw, tile_dtype=jnp.float16, kv_groups=HQ // HKV,
                  block_q=min(128, q.shape[2]), block_k=min(128, k.shape[2]))
    arrays = {n: jnp.asarray(t.numpy()) for n, t in
              dict(q=q, k=k, v=v, o=o, do=do).items()}
    arrays["lse"] = jnp.asarray(lse.numpy())[..., None]
    arrays["di"] = jnp.asarray(di.numpy())[..., None]
    return dict(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di), kw, arrays, jax_kw


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


CASES = [(100, True), (200, False), (256, True)]


@pytest.mark.parametrize("s,causal", CASES, ids=str)
def test_fp16_tile_fused_backward_matches_jax_kernel(s, causal):
    """The fused route, B2."""
    x, kw, a, jax_kw = _problem(s, causal, seed=s)
    got = fa2_backward.fa2_backward_fused_aligned(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], tile_dtype=FP16, **kw)
    want = jax_bwd.fa2_backward_fused_aligned(
        a["q"], a["k"], a["v"], a["do"], a["lse"], None, o=a["o"], **jax_kw)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 5e-3


@pytest.mark.parametrize("s,causal", CASES, ids=str)
def test_fp16_tile_split_backward_matches_jax_kernels(s, causal):
    """The split route, B3 + B4."""
    x, kw, a, jax_kw = _problem(s, causal, seed=s + 1)
    dq = fa2_backward.fa2_backward_dq_aligned(
        x["q"], x["k"], x["v"], x["do"], x["lse"], x["di"], tile_dtype=FP16, **kw)
    dk, dv = fa2_backward.fa2_backward_dkv_aligned(
        x["q"], x["k"], x["v"], x["do"], x["lse"], x["di"], tile_dtype=FP16, **kw)
    want_dq = jax_bwd.fa2_backward_dq_aligned(
        a["q"], a["k"], a["v"], a["do"], a["lse"], a["di"], **jax_kw)
    want_dk, want_dv = jax_bwd.fa2_backward_dkv_aligned(
        a["q"], a["k"], a["v"], a["do"], a["lse"], a["di"], **jax_kw)
    for g, w in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert _rel_err(g, w) <= 5e-3


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_tile_autograd_matches_jax_grad(causal):
    """flash_attention's gradients, L = sum(O), on uniform inputs."""
    q, k, v = _uniform(7, 256)

    def loss(q, k, v):
        return jnp.sum(jax_attention.flash_attention(
            q, k, v, causal=causal, tile_dtype=jnp.float16))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(
        attention.flash_attention(*ts, causal=causal, tile_dtype=FP16).sum(), ts)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 5e-3
        assert _rel_err(g, w) <= 5e-3
