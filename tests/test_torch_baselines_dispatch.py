"""Port parity: the baseline kernels B9 (FA1) and B10 (naive FA2) and the
dispatch registry of cuda_flash_attention_tpu_torch against the JAX
package's, on the same numpy inputs (uniform, as the reference harness).

On the CPU the port runs the kernels' plain versions; the JAX kernels run in
interpret mode.  Tolerances, absolute: the baselines and fp32 FA2 at the JAX
fp32 gate (2e-6 on O), fp32 gradients 1e-5; bf16 and fp16 tiles 2e-2 on O,
gradients 5e-2 (bf16) and 5e-3 (fp16) (tests/test_fa2_forward.py,
tests/test_fa2_backward.py).  With dO = 1 the gradients are differences of
nearly equal sums (|dQ| ~1e-2, smaller than the bf16 gate), so each is also
held relative to the JAX output's max |value|: 1e-4 fp32, 5e-3 fp16, 5e-2
bf16 (the card's bf16 backward gate).  Every rejected
(method, mode, precision) raises the JAX package's exception type.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu import dispatch as jax_dispatch
from cuda_flash_attention_tpu.kernels import baselines as jax_baselines
from cuda_flash_attention_tpu.ops import reference as jax_reference
from cuda_flash_attention_tpu_torch import dispatch
from cuda_flash_attention_tpu_torch.dispatch import ComputeType
from cuda_flash_attention_tpu_torch.kernels import baselines
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

SHAPE = (1, 2, 100, 64)


def _inputs(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(shape, dtype=np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [100, 256])
@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
def test_baseline_matches_jax_kernel(which, s):
    q, k, v = _inputs(s, (1, 2, s, 64))
    want = getattr(jax_baselines, f"{which}_attention")(
        *(jnp.asarray(x) for x in (q, k, v)))
    before = LAUNCHES[which]
    got = getattr(baselines, f"{which}_attention")(
        *(torch.from_numpy(x) for x in (q, k, v)))
    assert LAUNCHES[which] == before
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


METHODS = ["naive", "fa1", "fa2-naive", "fa2"]
MODES = ["forward", "backward", "forward_backward"]
PRECISIONS = ["fp32", "fp16", "bf16"]
VALID = [("fa2", m, p) for m in MODES for p in PRECISIONS] + [
    (m, "forward", "fp32") for m in ("naive", "fa1", "fa2-naive")]
REJECTED = [c for c in itertools.product(METHODS, MODES, PRECISIONS)
            if c not in VALID]
O_TOL = {"fp32": 2e-6, "fp16": 2e-2, "bf16": 2e-2}
GRAD_TOL = {"fp32": 1e-5, "fp16": 5e-3, "bf16": 5e-2}
GRAD_REL_TOL = {"fp32": 1e-4, "fp16": 5e-3, "bf16": 5e-2}


def _artifacts(q, k, v):
    """The oracle's (O, lse), handed to both sides in backward mode."""
    o, lse = jax_reference.vanilla_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.array(o), np.array(lse)


@pytest.mark.parametrize("method,mode,precision", VALID)
def test_registry_matches_jax(method, mode, precision):
    q, k, v = _inputs(1)
    extra = {}
    if mode == "backward":
        extra = dict(zip(("o", "lse"), _artifacts(q, k, v)))
    want = jax_dispatch.run_flash_attention(
        method, mode, precision, *(jnp.asarray(x) for x in (q, k, v)),
        **{n: jnp.asarray(x) for n, x in extra.items()})
    got = dispatch.run_flash_attention(
        method, mode, precision, *(torch.from_numpy(x) for x in (q, k, v)),
        **{n: torch.from_numpy(x) for n, x in extra.items()})
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if w is None:
            assert got[name] is None, name
            continue
        g, w = got[name].numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("o", "lse"):
            np.testing.assert_allclose(g, w, atol=O_TOL[precision], rtol=0)
        else:
            np.testing.assert_allclose(g, w, atol=GRAD_TOL[precision], rtol=0)
            rel = np.abs(g - w).max() / np.abs(w).max()
            assert rel <= GRAD_REL_TOL[precision], (name, rel)


@pytest.mark.parametrize("method", ["fa1", "fa2-naive"])
def test_baselines_return_no_lse(method):
    q, k, v = (torch.from_numpy(x) for x in _inputs(2))
    assert dispatch.run_flash_attention(method, "forward", "fp32", q, k, v)["lse"] is None


def _raises_like_jax(call_jax, call_torch):
    with pytest.raises(Exception) as want:
        call_jax()
    with pytest.raises(want.type):
        call_torch()


@pytest.mark.parametrize("method,mode,precision", REJECTED)
def test_rejected_combinations_raise_as_jax(method, mode, precision):
    q, k, v = _inputs(3, (1, 1, 16, 64))
    o, lse = _artifacts(q, k, v)
    _raises_like_jax(
        lambda: jax_dispatch.run_flash_attention(
            method, mode, precision, *(jnp.asarray(x) for x in (q, k, v)),
            o=jnp.asarray(o), lse=jnp.asarray(lse)),
        lambda: dispatch.run_flash_attention(
            method, mode, precision, *(torch.from_numpy(x) for x in (q, k, v)),
            o=torch.from_numpy(o), lse=torch.from_numpy(lse)))


@pytest.mark.parametrize("call", [
    # causal baselines
    dict(method="fa1", mode="forward", precision="fp32", causal=True),
    dict(method="fa2-naive", mode="forward", precision="fp32", causal=True),
    # backward without forward artifacts
    dict(method="fa2", mode="backward", precision="fp32"),
    # unknown names
    dict(method="fa3", mode="forward", precision="fp32"),
    dict(method="fa2", mode="sideways", precision="fp32"),
    dict(method="fa2", mode="forward", precision="int8"),
], ids=lambda c: "-".join(str(x) for x in c.values()))
def test_invalid_calls_raise_as_jax(call):
    q, k, v = _inputs(4, (1, 1, 16, 64))
    _raises_like_jax(
        lambda: jax_dispatch.run_flash_attention(
            q=jnp.asarray(q), k=jnp.asarray(k), v=jnp.asarray(v), **call),
        lambda: dispatch.run_flash_attention(
            q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
            **call))


@pytest.mark.parametrize("head_dim", [16, 48, 512])
def test_unsupported_head_dims_raise_as_jax(head_dim):
    q, k, v = _inputs(5, (1, 1, 16, head_dim))
    _raises_like_jax(
        lambda: jax_dispatch.run_flash_attention(
            "fa2", "forward", "fp32", *(jnp.asarray(x) for x in (q, k, v))),
        lambda: dispatch.run_flash_attention(
            "fa2", "forward", "fp32", *(torch.from_numpy(x) for x in (q, k, v))))
    assert dispatch.SUPPORTED_HEAD_DIMS == jax_dispatch.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("name", ["naive", "vanilla", "vanilla-attn", "fa1",
                                  "fa2-naive", "fa2_naive", "fa2", "FA2"])
def test_method_aliases_match_jax(name):
    """`naive` is the materialized oracle (VANILLA), not fa2-naive."""
    assert ComputeType.parse(name).value == jax_dispatch.ComputeType.parse(name).value
    assert ComputeType.parse("naive") is ComputeType.VANILLA
