"""Port parity on 16-bit inputs: fp16 q/k/v through the port's attention API
(the forward B1 and B8, the backward B2 and B3 + B4 on both routes), the
standalone backward, the quantized-KV API (B7) on fp16 q, and the baselines
B9 and B10 on bf16 and fp16 inputs, each against the JAX package's API on
the same numpy-seeded inputs (its Pallas kernels in interpret mode).

Tolerances: forwards 2e-2 absolute (the JAX reduced-tile forward gate,
tests/test_fa2_forward.py, as tests/test_torch_fp16_tiles.py holds fp16
tiles); gradients 5e-3 of the JAX gradient's max |value| (the JAX fp16
grad gate, tests/test_fa2_backward.py:140-156).  The JAX kernels emulate
fp16 as a 10-bit mantissa in fp32 and the port rounds to real fp16; the
two agree in fp16's normal range (common.TILE_DTYPES).  Outputs and
gradients come out in the inputs' type on both sides.  The inputs are
N(0, 1) draws (weights far from flat), and the baselines and the standalone
backward each plant controls that must fail the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import baselines as jax_baselines
from cuda_flash_attention_tpu.kernels import fa2_forward_quant as jax_quant
from cuda_flash_attention_tpu_torch.kernels import attention, baselines
from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
from cuda_flash_attention_tpu_torch.kernels.common import in_type, kernel_library
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES, count, reset

FWD_ATOL = 2e-2
GRAD_REL = 5e-3


def _inputs(seed, b, hq, hkv, s, d):
    """N(0, 1) q, k, v, dO: scores of spread ~1, weights far from flat."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    return draw(b, hq, s, d), draw(b, hkv, s, d), draw(b, hkv, s, d), draw(b, hq, s, d)


def _pair(x, jdtype, tdtype):
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


def _close(got, want, atol=FWD_ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("d,hq,hkv,causal,window,sinks", [
    (32, 4, 2, True, None, 0),
    (64, 4, 2, False, None, 0),
    (128, 4, 4, True, 64, 4),
    (256, 2, 1, True, None, 0),
], ids=["d32-causal-gqa", "d64-full-gqa", "d128-window64-sinks4", "d256-causal"])
def test_forward_on_fp16_inputs_matches_jax(d, hq, hkv, causal, window, sinks):
    q, k, v, _ = _inputs(d, 1, hq, hkv, 256, d)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, jnp.float16, torch.float16)
                                    for x in (q, k, v))
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        qj, kj, vj, causal=causal, window=window, sinks=sinks)
    o_t, lse_t = attention.flash_attention_with_lse(
        qt, kt, vt, causal=causal, window=window, sinks=sinks)
    assert o_t.dtype == torch.float16 and o_j.dtype == jnp.float16
    assert lse_t.dtype == torch.float32
    _close(o_t, o_j)
    _close(lse_t, lse_j)


def test_small_path_on_fp16_inputs_matches_jax():
    """Sq = Skv <= 128 and one KV head per query head: B8's route, at the
    suite's Edge-NonPowerOf2 length (S 100 pads to 112: 16 rows for
    2-byte types)."""
    q, k, v, _ = _inputs(5, 2, 4, 4, 100, 64)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, jnp.float16, torch.float16)
                                    for x in (q, k, v))
    assert attention._use_small_kernel(*attention._prepare(
        qt, kt, vt, True, None, None, None, None, None, 0)[:2])
    o_j, lse_j = jax_attention.flash_attention_with_lse(qj, kj, vj, causal=True)
    o_t, lse_t = attention.flash_attention_with_lse(qt, kt, vt, causal=True)
    assert o_t.dtype == torch.float16 and o_t.shape == (2, 4, 100, 64)
    _close(o_t, o_j)
    _close(lse_t, lse_j)


def _grads_jax(q, k, v, do, **kw):
    def loss(q, k, v):
        o = jax_attention.flash_attention(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _grads_torch(q, k, v, do, **kw):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = attention.flash_attention(q, k, v, **kw)
    assert o.dtype == q.dtype
    return torch.autograd.grad((o.float() * do).sum(), (q, k, v))


def _grad_errs(got, want):
    """Each gradient's max error over the JAX gradient's max |value|."""
    errs = []
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and w.dtype == jnp.float16
        w = np.asarray(w, np.float32)
        errs.append(np.abs(g.float().numpy() - w).max() / np.abs(w).max())
    return errs


def _grad_close(got, want):
    errs = _grad_errs(got, want)
    assert max(errs) <= GRAD_REL, errs


@pytest.mark.parametrize("d,window", [(64, None), (64, 48), (32, None), (128, 48),
                                      (256, None)],
                         ids=["d64-fused", "d64-split", "d32-fused", "d128-split",
                              "d256-fused"])
def test_gradients_on_fp16_inputs_match_jax(d, window):
    """Both backward routes, GQA 4/2, causal: the fused kernel B2, and the
    split pair B3 + B4, which the route rule takes for a narrow causal
    window without sinks (2 * 48 < 256) on both sides."""
    q, k, v, do = _inputs(100 + d, 1, 4, 2, 256, d)
    qkv = [_pair(x, jnp.float16, torch.float16) for x in (q, k, v)]
    assert attention._use_fused_bwd(qkv[0][1], qkv[1][1], 128, None, window, True,
                                    0) == (window is None)
    want = _grads_jax(*(j for j, _ in qkv), jnp.asarray(do), causal=True, window=window)
    got = _grads_torch(*(t for _, t in qkv), torch.from_numpy(do), causal=True,
                       window=window)
    _grad_close(got, want)


def test_standalone_backward_on_fp16_inputs_matches_jax():
    """fa2_backward from forward artefacts (O and lse of each side's own
    forward, dO fp16), GQA 4/2, causal; controls that must fail the same
    tolerance: the port's backward with sm_scale 10% off, and without the
    causal mask."""
    q, k, v, do = _inputs(7, 1, 4, 2, 256, 64)
    (qj, qt), (kj, kt), (vj, vt), (dj, dt) = (_pair(x, jnp.float16, torch.float16)
                                              for x in (q, k, v, do))
    o_j, lse_j = jax_attention.flash_attention_with_lse(qj, kj, vj, causal=True)
    o_t, lse_t = attention.flash_attention_with_lse(qt, kt, vt, causal=True)
    want = jax_attention.fa2_backward(qj, kj, vj, o_j, lse_j, dj, causal=True)
    got = attention.fa2_backward(qt, kt, vt, o_t, lse_t, dt, causal=True)
    _grad_close(got, want)
    for kw in (dict(causal=True, sm_scale=1.1 / 8), dict(causal=False)):
        bad = attention.fa2_backward(qt, kt, vt, o_t, lse_t, dt, **kw)
        assert max(_grad_errs(bad, want)) > GRAD_REL, kw


@pytest.mark.parametrize("compute", ["bf16", "fp32"])
def test_int8_kv_on_fp16_q_matches_jax(compute):
    q, k, v, _ = _inputs(8, 1, 4, 2, 256, 64)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, jnp.float16, torch.float16)
                                    for x in (q, k, v))
    cj, ct = ((jnp.bfloat16, torch.bfloat16) if compute == "bf16"
              else (jnp.float32, torch.float32))
    o_j = jax_quant.flash_attention_int8_kv(qj, kj, vj, causal=True, compute_dtype=cj)
    o_t = fq.flash_attention_int8_kv(qt, kt, vt, causal=True, compute_dtype=ct)
    assert o_t.dtype == torch.float16 and o_j.dtype == jnp.float16
    _close(o_t, o_j)


@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_baselines_on_16bit_inputs_match_jax(which, dtype):
    """N(0, 1) inputs (the scores' spread is 1: the weights are far from
    flat), S 256: two of JAX's 128-key tiles, four of the port's 64-key
    tiles (FA1 re-rounds its 16-bit O at each, on both sides).  Controls
    that must fail the same tolerance: the port with the last key dropped,
    with sm_scale 10% off, and the mean of V (flat weights)."""
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float16, torch.float16))
    q, k, v, _ = _inputs(9, 1, 2, 2, 256, 64)
    pairs = [_pair(x, jdt, tdt) for x in (q, k, v)]
    o_j = getattr(jax_baselines, f"{which}_attention")(*(j for j, _ in pairs))
    port = getattr(baselines, f"{which}_attention")
    qt, kt, vt = (t for _, t in pairs)
    o_t = port(qt, kt, vt)
    assert o_t.dtype == tdt and o_j.dtype == jdt
    _close(o_t, o_j)
    want = np.asarray(o_j, np.float32)
    controls = {
        "one key short": port(qt, kt[:, :, :-1], vt[:, :, :-1]),
        "sm_scale 10% off": port(qt, kt, vt, sm_scale=1.1 / 64 ** 0.5),
        "mean of V": vt.float().mean(dim=2, keepdim=True).expand_as(vt),
    }
    for name, o_c in controls.items():
        err = np.abs(o_c.float().numpy() - want).max()
        assert err > FWD_ATOL, (name, err)


def test_fp32_baselines_round_nothing():
    """On fp32 inputs P and O are not rounded: B9's and B10's plain
    versions give one value (the fp32 path as before 16-bit inputs)."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.random((1, 2, 256, 64), dtype=np.float32))
               for _ in range(3))
    kw = dict(sm_scale=0.125, kv_len=256)
    assert torch.equal(baselines.fa1_plain(q, k, v, **kw),
                       baselines.naive_fa2_plain(q, k, v, **kw))


def test_fp16_inputs_take_their_own_library_and_count():
    """fp16 inputs run from <name>_fp16in at every head dim (in_type 2);
    fp32 and bf16 from the shipped libraries (in_type 0 and 1, as the
    in_bf16 flag they replace); a launch counts under its input tag."""
    assert [in_type(t) for t in (torch.float32, torch.bfloat16, torch.float16)] == [0, 1, 2]
    for d in (32, 64, 128, 256):
        assert kernel_library("fa2_backward", d, torch.float16) == "fa2_backward_fp16in"
    assert kernel_library("fa2_forward", 32, torch.bfloat16) == "fa2_forward_d32"
    assert kernel_library("baselines", 64, torch.float32) == "baselines"
    reset("fa1", "fa1_bf16in")
    count("fa1", head_dim=64, inputs="bf16")
    assert LAUNCHES["fa1"] == 1 and LAUNCHES["fa1_bf16in"] == 1
    reset("fa1", "fa1_bf16in")
