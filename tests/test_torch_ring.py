"""Port parity: ring attention (parallel/ring.py) in 4 gloo ranks against the
JAX package's ring_attention on 4 virtual CPU devices, forward and
gradients: causal, non-causal and GQA (Hq 4, Hkv 2) on {ctx 4}.

The same fp32 inputs (global S 256, 64 a rank, D 64) made from a seed with
numpy go through JAX's ring (Pallas in interpret mode, jitted) and through
the port's, whose ranks are spawned by parallel.launch and run the plain
versions of B1 and B2 on their CPU blocks (_ring_parity.py).  Tolerances
are tests/test_parallel.py's: O within max |error| 2e-5 and passes(1e-3),
each gradient passes(1e-3).  The windows and the 2-D mesh are in
test_torch_ring_window.py.  One spawn for the module.
"""

import jax
import pytest

from _ring_parity import check_forward, check_gradient, run_cases

needs8 = pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                            reason="needs 8 virtual CPU devices")

# name: (mesh, Hq, Hkv, causal, window, the port's backward route)
CASES = {
    "causal": ({"ctx": 4}, 2, 2, True, None, "fused"),
    "full": ({"ctx": 4}, 2, 2, False, None, "fused"),
    "gqa": ({"ctx": 4}, 4, 2, True, None, "fused"),
}


@pytest.fixture(scope="module")
def results():
    return run_cases(CASES)


@needs8
@pytest.mark.parametrize("name", list(CASES))
def test_ring_forward_matches_jax(results, name):
    check_forward(results, name)


@needs8
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_ring_gradients_match_jax(results, name, grad):
    check_gradient(results, name, grad)


@needs8
@pytest.mark.parametrize("name", list(CASES))
def test_ring_backward_route(results, name):
    """The fused backward (B2) at 64 keys a shard, as JAX's ring takes its
    fused kernel (one KV slice)."""
    assert results[0][name]["route"] == CASES[name][5]
