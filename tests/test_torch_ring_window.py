"""Port parity: ring attention under a global sliding window and on a 2-D
mesh, in 4 gloo ranks against the JAX package's ring_attention on 4 virtual
CPU devices, forward and gradients (_ring_parity.py; fp32, global S 256, 64
a rank, D 64; tests/test_parallel.py's tolerances).

Cases: a causal window of 100 (GQA; the fourth rotation is skipped, and
the second past shard's band has offset -28, which leaves rows with no key),
a window of 20 (the first past shard's band has offset -44; the port's
route rule sends 2 * 20 < 64 to the split backward B3 + B4, where JAX's ring
takes its fused kernel), and {model 2, ctx 2} (heads over model, the
sequence over ctx).  One spawn for the module.
"""

import jax
import pytest

from _ring_parity import CTX, S, check_forward, check_gradient, run_cases
from cuda_flash_attention_tpu_torch.parallel.ring import (
    _band_window,
    _live_ring_steps,
)

needs8 = pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                            reason="needs 8 virtual CPU devices")

# name: (mesh, Hq, Hkv, causal, window, the port's backward route)
CASES = {
    "window100": ({"ctx": 4}, 4, 2, True, 100, "fused"),
    "window20": ({"ctx": 4}, 2, 2, True, 20, "split"),
    "model2_ctx2": ({"model": 2, "ctx": 2}, 4, 2, True, None, "fused"),
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
    assert results[0][name]["route"] == CASES[name][5]


@pytest.mark.parametrize("window,steps,band", [(100, 3, -28), (20, 2, -44)])
def test_window_skips_rotations_and_leaves_dead_rows(window, steps, band):
    """The windowed cases make fewer rotations than the ring has ranks,
    and the last live past shard's band has a negative offset that leaves
    some local rows with no key (i - j < band for no j < 64)."""
    shard = S // CTX
    assert _live_ring_steps(CTX, True, window, shard) == steps < CTX
    assert _band_window(steps - 1, window, shard) == band
    dead = [i for i in range(shard) if not any(i - j < band for j in range(shard))]
    assert dead and len(dead) < shard
