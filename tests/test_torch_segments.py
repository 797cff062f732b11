"""Port parity: segment ids (sequence packing and padding masks) through
flash_attention of cuda_flash_attention_tpu_torch against the JAX
package's, forward and gradients, on the same numpy inputs.

On the CPU the port runs the plain versions of B1, B8 and B2-B4; the JAX
side is called with force_kernel=True (the Pallas kernels in interpret
mode).  Tolerances as tests/test_segments.py's and test_window.py's: 1e-5
on O and 1e-4 on gradients in fp32, 2e-2 of the largest |value| with bf16
tiles.  The CUDA kernels are held to these plain versions on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py phase 26.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu_torch.kernels import attention, common


def _inputs(b, h, s, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d), dtype=np.float32)
                 for _ in range(4))


def _segments(b, s, n_seg, seed=1):
    """Contiguous random segment partition of each row (tests/test_segments.py)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), n_seg - 1, replace=False))
        out[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return out


def _both(q, k, v, w, q_seg, kv_seg, tile=None, grads=True, **kw):
    """((O, grads) of JAX, (O, grads) of the port) of sum(O * w)."""
    jtile = None if tile is None else jnp.bfloat16
    ttile = None if tile is None else torch.bfloat16

    def f_j(*x):
        return jax_attention.flash_attention(
            *x, q_segment_ids=jnp.asarray(q_seg), kv_segment_ids=jnp.asarray(kv_seg),
            force_kernel=True, tile_dtype=jtile, **kw)

    xj = [jnp.asarray(x) for x in (q, k, v)]
    o_j = f_j(*xj)
    g_j = (jax.grad(lambda *x: jnp.sum(f_j(*x) * w), argnums=(0, 1, 2))(*xj)
           if grads else ())
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o_t = attention.flash_attention(*ts, q_segment_ids=torch.from_numpy(q_seg),
                                    kv_segment_ids=torch.from_numpy(kv_seg),
                                    tile_dtype=ttile, **kw)
    g_t = (torch.autograd.grad((o_t * torch.from_numpy(w)).sum(), ts)
           if grads else ())
    return ((np.asarray(o_j), [np.asarray(g) for g in g_j]),
            (o_t.detach().numpy(), [g.numpy() for g in g_t]))


def _check(jax_out, port_out, tile=None):
    (o_j, g_j), (o_t, g_t) = jax_out, port_out
    assert not np.isnan(o_t).any()
    if tile is None:
        np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=0)
    else:
        assert np.abs(o_t - o_j).max() <= 2e-2 * np.abs(o_j).max()
    for got, want in zip(g_t, g_j):
        assert not np.isnan(got).any()
        if tile is None:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("tile", [None, "bf16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_segment_forward_and_grads_match_jax(causal, tile):
    """tests/test_segments.py:34 and :49: three segments a row, B2 H2
    S256, causal and not."""
    q, k, v, w = _inputs(2, 2, 256)
    seg = _segments(2, 256, 3)
    _check(*_both(q, k, v, w, seg, seg, tile, causal=causal), tile)


def test_segments_with_gqa_and_unequal_lengths_match_jax():
    """GQA 4/2 with Sq 200 and Skv 300 (ids of each side), not causal."""
    rng = np.random.default_rng(3)
    q, w = (rng.standard_normal((1, 4, 200, 64), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 300, 64), dtype=np.float32) for _ in range(2))
    q_seg = _segments(1, 200, 2, seed=4)
    kv_seg = _segments(1, 300, 2, seed=5)
    _check(*_both(q, k, v, w, q_seg, kv_seg))


def test_padding_rows_are_zero_and_pad_keys_get_no_gradient():
    """tests/test_segments.py:96: padding queries (id -7) and keys (id -8)
    match nothing: their O rows are 0 and the pad keys' dK and dV are
    exactly 0, as JAX gives them."""
    q, k, v, w = _inputs(1, 1, 128)
    q_seg = np.asarray([[0] * 100 + [-7] * 28], np.int32)
    kv_seg = np.asarray([[0] * 100 + [-8] * 28], np.int32)
    jax_out, port_out = _both(q, k, v, w, q_seg, kv_seg)
    _check(jax_out, port_out)
    o_t, (dq, dk, dv) = port_out
    np.testing.assert_array_equal(o_t[0, 0, 100:], 0.0)
    np.testing.assert_array_equal(dk[0, 0, 100:], 0.0)
    np.testing.assert_array_equal(dv[0, 0, 100:], 0.0)
    np.testing.assert_array_equal(dq[0, 0, 100:], 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_on_the_small_route_match_jax(causal):
    """tests/test_segments.py:122: S 64 with Hq = Hkv takes B8 in both
    packages; segments compose with the per-head slots."""
    q, k, v, w = _inputs(2, 8, 64, seed=3)
    seg = _segments(2, 64, 2)
    qp = torch.zeros(2, 8, 64, 64)
    assert attention._use_small_kernel(qp, qp)
    _check(*_both(q, k, v, w, seg, seg, causal=causal))


def test_segments_with_a_window_match_jax():
    """tests/test_window.py:116: the window applies within the causal and
    segment mask (positions are global, as in packed training with
    windowed layers)."""
    q, k, v, w = _inputs(1, 2, 384, seed=6)
    seg = (np.arange(384) >= 192).astype(np.int32)[None, :]
    _check(*_both(q, k, v, w, seg, seg, causal=True, window=100))


def test_packing_equals_separate_sequences():
    """Two documents packed into one row with segment ids give the outputs
    and gradients of the two calls run separately (tests/test_segments.py:73)."""
    q, k, v, w = _inputs(1, 2, 256, seed=2)
    seg = np.asarray([[0] * 100 + [1] * 156], np.int32)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = attention.flash_attention(*ts, causal=True, q_segment_ids=torch.from_numpy(seg),
                                  kv_segment_ids=torch.from_numpy(seg))
    g = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    for lo, hi in ((0, 100), (100, 256)):
        part = [torch.from_numpy(x[:, :, lo:hi].copy()).requires_grad_()
                for x in (q, k, v)]
        o_p = attention.flash_attention(*part, causal=True)
        g_p = torch.autograd.grad((o_p * torch.from_numpy(w[:, :, lo:hi])).sum(), part)
        torch.testing.assert_close(o[:, :, lo:hi], o_p, atol=2e-5, rtol=0)
        for a, b in zip(g, g_p):
            torch.testing.assert_close(a[:, :, lo:hi], b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(q_segment_ids=np.zeros((2, 128), np.int32)),
    dict(kv_segment_ids=np.zeros((2, 128), np.int32)),
    dict(q_segment_ids=np.zeros((2, 64), np.int32),
         kv_segment_ids=np.zeros((2, 128), np.int32)),
    dict(q_segment_ids=np.zeros((2, 128), np.int32),
         kv_segment_ids=np.zeros((1, 128), np.int32)),
], ids=["q only", "kv only", "q shape", "kv shape"])
def test_segment_validation_errors_match_jax(kw):
    q, k, v, _ = _inputs(2, 2, 128)
    with pytest.raises(ValueError) as want:
        jax_attention.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            **{n: jnp.asarray(x) for n, x in kw.items()})
    with pytest.raises(ValueError) as got:
        attention.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **{n: torch.from_numpy(x) for n, x in kw.items()})
    assert str(got.value) == str(want.value)


def test_pack_segments_pads_to_the_padded_grid():
    """The ids are padded to the padded lengths (JAX _pack_segments); the
    pad value is irrelevant, every real id is kept."""
    q_ids = torch.arange(100, dtype=torch.int64)[None].repeat(2, 1)
    kv_ids = torch.arange(300, dtype=torch.int32)[None].repeat(2, 1)
    q_seg, kv_seg = common.pack_segments(q_ids, kv_ids, 104, 384)
    assert q_seg.dtype == kv_seg.dtype == torch.int32
    assert q_seg.shape == (2, 104) and kv_seg.shape == (2, 384)
    assert torch.equal(q_seg[:, :100], q_ids.int())
    assert torch.equal(kv_seg[:, :300], kv_ids)
    assert common.pack_segments(None, None, 104, 384) is None
