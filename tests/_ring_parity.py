"""The JAX side and the shared checks of the ring attention parity files
(test_torch_ring.py, test_torch_ring_window.py): each file runs its cases
once, the port's in 4 gloo ranks (_torch_mesh_workers.ring_cases, started
first) while JAX's jitted ring runs on 4 virtual CPU devices here."""

import jax
import jax.numpy as jnp
import numpy as np

from cuda_flash_attention_tpu.ops.metrics import compute_metrics
from cuda_flash_attention_tpu.parallel import ring_attention as jax_ring
from cuda_flash_attention_tpu.parallel.mesh import cpu_test_mesh
from cuda_flash_attention_tpu_torch.parallel import launch

S, D, CTX = 256, 64, 4


def _inputs(name, hq, hkv):
    rng = np.random.default_rng(sum(map(ord, name)))
    return {"q": rng.standard_normal((1, hq, S, D), np.float32),
            "k": rng.standard_normal((1, hkv, S, D), np.float32),
            "v": rng.standard_normal((1, hkv, S, D), np.float32),
            "do": rng.standard_normal((1, hq, S, D), np.float32)}


def run_cases(table: dict):
    """(port results, JAX results) of `table`: name -> (mesh, Hq, Hkv,
    causal, window, route)."""
    cases = {name: {**_inputs(name, hq, hkv), "mesh": mesh, "causal": causal,
                    "window": window}
             for name, (mesh, hq, hkv, causal, window, _) in table.items()}
    run = launch.start("_torch_mesh_workers:ring_cases", CTX, args=(cases,))
    want = {}
    for name, c in cases.items():
        mesh = cpu_test_mesh(c["mesh"])

        @jax.jit
        def fwd_bwd(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: jax_ring(
                mesh, q, k, v, causal=c["causal"], window=c["window"]), q, k, v)
            return (o, *vjp(do))

        out = fwd_bwd(*(jnp.asarray(c[x]) for x in ("q", "k", "v", "do")))
        want[name] = dict(zip(("o", "dq", "dk", "dv"), out))
    return run.result()[0], want


def check_forward(results, name):
    """tests/test_parallel.py's forward tolerance: max |error| 2e-5 and
    passes(1e-3)."""
    got, want = results
    m = compute_metrics(got[name]["o"], np.asarray(want[name]["o"]))
    assert m.passes(1e-3) and m.max_abs_error < 2e-5, (name, m)


def check_gradient(results, name, grad):
    """tests/test_parallel.py's gradient tolerance: passes(1e-3)."""
    got, want = results
    m = compute_metrics(got[name][grad], np.asarray(want[name][grad]))
    assert m.passes(1e-3), (name, grad, m)
