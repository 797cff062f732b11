"""Port parity and checks of the parallel layer's helpers: head-parallel
attention in 8 gloo ranks ({data 2, model 4}) against the JAX package's
head_parallel_attention on 8 virtual CPU devices (forward and gradients;
tests/test_parallel.py's and tests/test_window.py's cases: full attention,
and a causal window of 96), the distributed helpers as
tests/test_distributed.py checks JAX's (one process; and 4 ranks of one
host).  The launcher's failure paths and scaling_efficiency_bench are in
test_torch_launch.py.

fp32 inputs from a seed with numpy.  Tolerances: O within max |error|
2e-5 and passes(1e-3), each gradient passes(1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flash_attention_tpu.ops.metrics import compute_metrics
from cuda_flash_attention_tpu.parallel.mesh import cpu_test_mesh
from cuda_flash_attention_tpu.parallel.sharded import (
    head_parallel_attention as jax_head_parallel,
)
from cuda_flash_attention_tpu_torch.parallel import launch
from cuda_flash_attention_tpu_torch.parallel.distributed import (
    hybrid_layout,
    initialize_distributed,
    two_host_serving_mesh,
)

needs8 = pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                            reason="needs 8 virtual CPU devices")

# name: (causal, window)
CASES = {"full": (False, None), "window96": (True, 96)}


@pytest.fixture(scope="module")
def head_parallel():
    cases = {}
    for name, (causal, window) in CASES.items():
        rng = np.random.default_rng(sum(map(ord, name)))
        cases[name] = {x: rng.standard_normal((4, 8, 256, 64), np.float32)
                       for x in ("q", "k", "v", "do")}
        cases[name].update(causal=causal, window=window)
    run = launch.start("_torch_mesh_workers:head_parallel_cases", 8,
                       args=(cases,))
    mesh = cpu_test_mesh({"data": 2, "model": 4})
    want = {}
    for name, c in cases.items():
        @jax.jit
        def fwd_bwd(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: jax_head_parallel(
                mesh, q, k, v, causal=c["causal"], window=c["window"]), q, k, v)
            return (o, *vjp(do))

        out = fwd_bwd(*(jnp.asarray(c[x]) for x in ("q", "k", "v", "do")))
        want[name] = dict(zip(("o", "dq", "dk", "dv"), out))
    return run.result()[0], want


@needs8
@pytest.mark.parametrize("name", list(CASES))
def test_head_parallel_forward_matches_jax(head_parallel, name):
    got, want = head_parallel
    m = compute_metrics(got[name]["o"], np.asarray(want[name]["o"]))
    assert m.passes(1e-3) and m.max_abs_error < 2e-5, (name, m)


@needs8
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_head_parallel_gradients_match_jax(head_parallel, name, grad):
    got, want = head_parallel
    m = compute_metrics(got[name][grad], np.asarray(want[name][grad]))
    assert m.passes(1e-3), (name, grad, m)


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(device="cpu") is False


def test_hybrid_layout_single_process_fallback():
    """JAX's case: 8 devices of one process, {data 2, model 2} x DCN
    {data 2} -> a plain {data 4, model 2} mesh."""
    shape, ranks = hybrid_layout({"data": 2, "model": 2}, {"data": 2}, 1)
    assert shape == {"data": 4, "model": 2}
    np.testing.assert_array_equal(ranks, np.arange(8).reshape(4, 2))


@pytest.mark.parametrize("ici,dcn,want", [
    ({"data": 2, "model": 4}, {"data": 2}, np.arange(16).reshape(4, 4)),
    ({"data": 2, "model": 2}, {"model": 2}, np.array([[0, 1, 4, 5],
                                                       [2, 3, 6, 7]])),
])
def test_hybrid_layout_two_hosts(ici, dcn, want):
    """Across 2 hosts the DCN factor is the outer part of its axis: each
    host's ranks (0-7, 8-15; 0-3, 4-7) form the inner part."""
    shape, ranks = hybrid_layout(ici, dcn, 2)
    assert tuple(shape.values()) == want.shape
    np.testing.assert_array_equal(ranks, want)


def test_two_host_serving_mesh_bad_tp():
    with pytest.raises(ValueError):
        two_host_serving_mesh(2, device="cpu")  # one process, one rank


def test_helpers_on_four_ranks():
    out = launch.run("_torch_mesh_workers:helpers", 4)[0]
    assert out["hybrid"] == {"data": 2, "model": 2}
    assert out["serving"] == {"data": 2, "model": 2}
    assert out["bad_tp"] == "tp=3 must divide devices/host (4)"
    assert out["coords"] == (0, 0)
