"""Port parity of the quantized-KV FA2 forward (B7): the port's plain
version behind its public API against the JAX kernel in interpret mode, on
the same K/V bytes (quantized by the JAX package, carried by
params_from_numpy), over int8, fp8 e4m3/e5m2 and int4 storage, bf16 and
fp32 compute, causal or not, GQA 2, a ragged S 200, D 64 and 128.
Tolerances: O within 2e-5 in fp32 compute (tests/test_quant.py:86,140) and
2e-2 in bf16; lse within 1e-5 in fp32 and 1e-3 relative in bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu.kernels import fa2_forward_quant as jax_fq
from cuda_flash_attention_tpu.quant import qtensor as jax_qt
from cuda_flash_attention_tpu_torch import flash_attention_int8_kv
from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

STORAGE = {"int8": jnp.int8, "e4m3": jnp.float8_e4m3fn,
           "e5m2": jnp.float8_e5m2, "int4": "int4"}
COMPUTE = {"bf16": (jnp.bfloat16, torch.bfloat16),
           "fp32": (jnp.float32, torch.float32)}
O_TOL = {"fp32": 2e-5, "bf16": 2e-2}
LSE_TOL = {"fp32": 1e-5, "bf16": 1e-3}  # fp32 absolute, bf16 relative


def _problem(d, s=200, hq=4, hkv=2, b=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _port_qt(qt) -> QuantizedTensor:
    return params_from_numpy(numpy_tree(qt), "cpu")


def _check(got, want, compute):
    o, lse = got
    o_want, lse_want = (np.asarray(x, np.float32) for x in want)
    assert np.abs(o.float().numpy() - o_want).max() <= O_TOL[compute]
    lse_err = np.abs(lse.numpy() - lse_want)
    if compute == "bf16":
        lse_err = lse_err / np.maximum(np.abs(lse_want), 1.0)
    assert lse_err.max() <= LSE_TOL[compute]


# Each storage type in both compute types, causal in one and not in the
# other (each JAX interpret-mode call costs about a second on the CPU).
CASES = [(st, cp, (i + j) % 2 == 0) for i, st in enumerate(STORAGE)
         for j, cp in enumerate(COMPUTE)]


@pytest.mark.parametrize("storage,compute,causal", CASES)
def test_plain_b7_matches_jax_kernel(storage, compute, causal):
    q, k, v = _problem(64)
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), STORAGE[storage])
    jdt, tdt = COMPUTE[compute]
    want = jax_fq.flash_attention_quantized_kv_with_lse(
        jnp.asarray(q), k_q, v_q, causal=causal, compute_dtype=jdt)
    got = fq.flash_attention_quantized_kv_with_lse(
        torch.from_numpy(q), _port_qt(k_q), _port_qt(v_q), causal=causal,
        compute_dtype=tdt)
    assert got[0].shape == (1, 4, 200, 64) and got[1].shape == (1, 4, 200)
    _check(got, want, compute)


@pytest.mark.parametrize("storage,compute,causal", [("int4", "bf16", True),
                                                   ("e4m3", "fp32", False)])
def test_plain_b7_matches_jax_kernel_d128(storage, compute, causal):
    q, k, v = _problem(128, s=136, seed=1)
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), STORAGE[storage])
    jdt, tdt = COMPUTE[compute]
    want = jax_fq.flash_attention_quantized_kv_with_lse(
        jnp.asarray(q), k_q, v_q, causal=causal, compute_dtype=jdt)
    got = fq.flash_attention_quantized_kv_with_lse(
        torch.from_numpy(q), _port_qt(k_q), _port_qt(v_q), causal=causal,
        compute_dtype=tdt)
    _check(got, want, compute)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_kv_api_matches_jax(dtype):
    q, k, v = _problem(64, s=130, seed=2)
    jdt, tdt = COMPUTE[dtype]
    want = jax_fq.flash_attention_int8_kv(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal=True)
    got = flash_attention_int8_kv(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=True)
    assert got.dtype == tdt
    assert np.abs(got.float().numpy() - np.asarray(want, np.float32)).max() <= O_TOL["bf16"]


def _bad_inputs(q, k_q, v_q, tq, tk, tv):
    """(JAX args, port args) pairs that _validate_quant_shapes refuses."""
    def scales_rank(t):
        return t[0], t[1][..., 0]
    return [
        ((q[:, :1], k_q, v_q), (tq[:, :1], tk, tv)),             # GQA
        ((q[0], k_q, v_q), (tq[0], tk, tv)),                      # rank
        ((q[..., :32], k_q, v_q), (tq[..., :32], tk, tv)),        # head_dim
        ((q, k_q, jax_qt.QuantizedTensor(v_q.values[:, :, :128], v_q.scales[:, :, :128])),
         (tq, tk, QuantizedTensor(tv.values[:, :, :128], tv.scales[:, :, :128]))),
        ((q, jax_qt.QuantizedTensor(*scales_rank((k_q.values, k_q.scales))), v_q),
         (tq, QuantizedTensor(*scales_rank((tk.values, tk.scales))), tv)),
    ]


def test_validation_errors_match_jax():
    q, k, v = _problem(64, s=256, seed=3)
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), jnp.int8)
    tk, tv = _port_qt(k_q), _port_qt(v_q)
    for (jargs, targs) in _bad_inputs(jnp.asarray(q), k_q, v_q,
                                     torch.from_numpy(q), tk, tv):
        with pytest.raises(ValueError) as jerr:
            jax_fq.flash_attention_quantized_kv(*jargs)
        with pytest.raises(ValueError) as terr:
            fq.flash_attention_quantized_kv(*targs)
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]
    # Segment ids and windows are taken (tests/test_torch_quant_window.py);
    # their bad forms raise as the JAX API's do: ids without their pair, a
    # causal window below 1.
    seg = np.zeros((1, 256), np.int32)
    for kw in (dict(q_segment_ids=seg), dict(causal=True, window=0)):
        with pytest.raises(ValueError) as jerr:
            jax_fq.flash_attention_quantized_kv(
                jnp.asarray(q), k_q, v_q,
                **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                   for n, x in kw.items()})
        with pytest.raises(ValueError) as terr:
            fq.flash_attention_quantized_kv(
                torch.from_numpy(q), tk, tv,
                **{n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                   for n, x in kw.items()})
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]
    with pytest.raises(NotImplementedError):
        fq.fa2_forward_quant_aligned(torch.from_numpy(q), tk.values, tk.scales[..., 0],
                                     tv.values, tv.scales[..., 0], causal=False,
                                     sm_scale=0.125, kv_len=256,
                                     compute_dtype=torch.float16)
