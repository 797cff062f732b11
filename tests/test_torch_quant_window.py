"""Port parity of B7 (the quantized-KV FA2 forward) with a sliding window and
with segment ids: the port's plain version behind its public API against
the JAX kernel in interpret mode, on the same K/V bytes (quantized by the
JAX package, carried by params_from_numpy).

The cases are the port's counterparts of tests/test_window.py:223
(`test_window_quantized_kv`: causal window 160 at S 512, blocks of 128,
fp32 compute; O within 1e-5) and tests/test_quant.py:144
(`test_quant_kernel_segments`: two segments of 128 at S 256, fp32 compute;
O within 2e-5), over int8, e4m3 and int4 storage, plus bf16 compute (O
within 2e-2), a non-causal recency band and the rows that keep no key: a
band whose offset is <= 0 and a segment with no key.  A dead row's lse is
the JAX kernel's bit for bit (-inf where its Q tile runs no KV tile, else
the mask value times ln 2; no one-tile exception) and its O is 0, as B1
gives it: the JAX quantized kernel does not zero a masked P, so its dead
row averages V (times its scale) over the columns of the KV tiles it ran,
padding included, which depends on its tiles and is not compared.  The
kernel is held to the plain version on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py phase 28."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu.kernels import fa2_forward_quant as jax_fq
from cuda_flash_attention_tpu.quant import qtensor as jax_qt
from cuda_flash_attention_tpu_torch.kernels import common
from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

STORAGE = {"int8": jnp.int8, "e4m3": jnp.float8_e4m3fn, "int4": "int4"}
COMPUTE = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _problem(s, hq=4, hkv=2, b=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _both(q, k, v, storage, compute, **kw):
    """(JAX, port) outputs (O, lse) as numpy on one quantization of K/V."""
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), STORAGE[storage])
    jdt, tdt = COMPUTE[compute]
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    want = jax_fq.flash_attention_quantized_kv_with_lse(
        jnp.asarray(q), k_q, v_q, compute_dtype=jdt, **jkw)
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    got = fq.flash_attention_quantized_kv_with_lse(
        torch.from_numpy(q), params_from_numpy(numpy_tree(k_q), "cpu"),
        params_from_numpy(numpy_tree(v_q), "cpu"), compute_dtype=tdt, **tkw)
    return ([np.asarray(x, np.float32) for x in want],
            [got[0].float().numpy(), got[1].numpy()])


def _check(want, got, o_tol, lse_tol):
    (o_j, lse_j), (o_t, lse_t) = want, got
    assert o_t.shape == o_j.shape and lse_t.shape == lse_j.shape
    dead = lse_j < -1e30
    assert np.abs(o_t - o_j)[~dead].max() <= o_tol
    np.testing.assert_array_equal(lse_t[dead], lse_j[dead])
    np.testing.assert_array_equal(o_t[dead], 0.0)
    np.testing.assert_allclose(lse_t[~dead], lse_j[~dead], atol=lse_tol, rtol=0)
    return int(dead.sum())


@pytest.mark.parametrize("storage,compute", [("int8", "fp32"), ("e4m3", "fp32"),
                                             ("int4", "bf16")])
def test_window_matches_jax(storage, compute):
    """tests/test_window.py:223's case (causal window 160, S 512, JAX blocks
    of 128): O within 1e-5 in fp32 compute, 2e-2 in bf16; a windowed launch
    counts under its own name only on the card."""
    q, k, v = _problem(512, b=1)
    want, got = _both(q, k, v, storage, compute, causal=True, window=160,
                      block_q=128, block_k=128)
    _check(want, got, 1e-5 if compute == "fp32" else 2e-2,
           1e-5 if compute == "fp32" else 2e-2)


@pytest.mark.parametrize("storage,compute", [("int8", "fp32"), ("int4", "fp32"),
                                             ("e4m3", "bf16")])
def test_segments_match_jax(storage, compute):
    """tests/test_quant.py:144's case (two segments of 128 at S 256): O
    within 2e-5 in fp32 compute, 2e-2 in bf16."""
    q, k, v = _problem(256)
    seg = np.concatenate([np.zeros((2, 128), np.int32), np.ones((2, 128), np.int32)], 1)
    want, got = _both(q, k, v, storage, compute, q_segment_ids=seg, kv_segment_ids=seg)
    _check(want, got, 2e-5 if compute == "fp32" else 2e-2,
           1e-5 if compute == "fp32" else 2e-2)


@pytest.mark.parametrize("case", ["band", "ragged window", "segments and window",
                                  "segment without keys"])
def test_dead_rows_match_jax(case):
    """Rows that keep no key give O = 0 and the JAX kernel's lse bit for
    bit: a band of offset -10 over Sq 300 > Skv 150 (JAX blocks 128: the
    last Q tile runs no KV tile, -inf; the one before runs one and masks
    it), a causal window over the same shapes (rows past kv_len + window;
    one KV tile and no one-tile body), a window with ids and rows of an id no key carries,
    and such rows without a window (its tile ran: the mask value times ln 2)."""
    rng = np.random.default_rng(3)
    if case in ("band", "ragged window"):
        q, _, _ = _problem(300, b=1)
        _, k, v = _problem(150, b=1, seed=1)
        kw = (dict(causal=False, window=-10, block_q=128, block_k=128) if case == "band"
              else dict(causal=True, window=64))
    else:
        q, k, v = _problem(256)
        ids = np.sort(rng.integers(0, 3, (2, 256)), axis=1).astype(np.int32)
        q_ids = ids.copy()
        if case == "segment without keys":
            q_ids[:, 200:] = 7
        else:
            q_ids[:, 60:90] = 5
        kw = dict(causal=True, q_segment_ids=q_ids, kv_segment_ids=ids)
        if case == "segments and window":
            kw["window"] = 48
    want, got = _both(q, k, v, "int8", "fp32", **kw)
    dead = _check(want, got, 2e-5, 1e-5)
    assert dead > 0
    if case == "band":
        assert np.isneginf(want[1]).any() and (want[1][~np.isinf(want[1])] < -1e30).any()


def test_plain_kernel_arguments():
    """fa2_forward_quant_aligned takes the window and ids on the CPU (the
    plain version), counts nothing there, and the default dead-row tiles are
    the JAX API's blocks fitted to the padded lengths."""
    assert fq.quant_tiles(256, 1152) == (256, 384)
    q, k, v = _problem(256, b=1)
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), jnp.int8)
    kq, vq = (params_from_numpy(numpy_tree(t), "cpu") for t in (k_q, v_q))
    args = fq.aligned_inputs(torch.from_numpy(q), kq, vq)
    before = dict(LAUNCHES)
    o, lse = fq.fa2_forward_quant_aligned(*args, causal=True, sm_scale=0.125,
                                          kv_len=256, compute_dtype=torch.float32,
                                          window=32)
    assert dict(LAUNCHES) == before
    o_full, _ = fq.fa2_forward_quant_aligned(*args, causal=True, sm_scale=0.125,
                                             kv_len=256, compute_dtype=torch.float32)
    # Row 0 keeps only key 0 in both; a late row differs under the window.
    torch.testing.assert_close(o[..., 0, :], o_full[..., 0, :], rtol=0, atol=0)
    assert (o[..., 200, :] - o_full[..., 200, :]).abs().max() > 1e-3
    dead = common.dead_row_lse(256, 256, causal=False, window=-300, sinks=0,
                               block_q=128, block_k=256, device="cpu",
                               single_tile_body=False)
    assert torch.isinf(dead).all()
