"""Port parity: ring_attention_quantized (parallel/ring.py; B7's plain
version on each rank's CPU blocks) in 4 gloo ranks against the JAX
package's on 4 virtual CPU devices, int8, int4 (split-half) and e4m3 K/V,
GQA once.

fp32 inputs (global S 256, 64 a rank, D 64) from a seed with numpy; fp32
compute on both sides.  The port's output is held to JAX's within max
|error| 2e-5, and to the port's own fp32 ring (parallel.ring_attention on
the same blocks) within tests/test_longcontext.py's passes(5e-2) (int8,
e4m3), or for int4 within that file's 4-bit budget, a mean |error| below
5e-2 (test_quantized_ring_int4: 4-bit codes miss single elements by more).
One spawn for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flash_attention_tpu.ops.metrics import compute_metrics
from cuda_flash_attention_tpu.parallel import ring_attention_quantized
from cuda_flash_attention_tpu.parallel.mesh import cpu_test_mesh
from cuda_flash_attention_tpu_torch.parallel import launch

S, D, CTX = 256, 64, 4
needs8 = pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                            reason="needs 8 virtual CPU devices")

# name: (kv dtype name, Hq, Hkv, causal)
CASES = {
    "int8": ("int8", 2, 2, True),
    "int4": ("int4", 2, 2, True),
    "e4m3": ("float8_e4m3fn", 2, 2, False),
    "int8_gqa": ("int8", 8, 2, True),
}


@pytest.fixture(scope="module")
def results():
    cases = {}
    for name, (kv_dtype, hq, hkv, causal) in CASES.items():
        rng = np.random.default_rng(sum(map(ord, name)))
        cases[name] = {"q": rng.standard_normal((1, hq, S, D), np.float32),
                       "k": rng.standard_normal((1, hkv, S, D), np.float32),
                       "v": rng.standard_normal((1, hkv, S, D), np.float32),
                       "kv_dtype": kv_dtype, "causal": causal}
    run = launch.start("_torch_mesh_workers:quant_ring_cases", CTX,
                       args=(cases,))
    mesh = cpu_test_mesh({"ctx": CTX})
    want = {}
    for name, c in cases.items():
        kv_dtype = c["kv_dtype"] if c["kv_dtype"] == "int4" else getattr(
            jnp, c["kv_dtype"])
        fn = jax.jit(lambda q, k, v: ring_attention_quantized(
            mesh, q, k, v, kv_dtype=kv_dtype, causal=c["causal"],
            compute_dtype=jnp.float32))
        want[name] = np.asarray(fn(*(jnp.asarray(c[x]) for x in "qkv")))
    return run.result()[0], want


@needs8
@pytest.mark.parametrize("name", list(CASES))
def test_quantized_ring_matches_jax(results, name):
    got, want = results
    m = compute_metrics(got[name]["o"], want[name])
    assert m.ok and m.max_abs_error < 2e-5, (name, m)


@needs8
@pytest.mark.parametrize("name", list(CASES))
def test_quantized_ring_tracks_fp32_ring(results, name):
    got, _ = results
    m = compute_metrics(got[name]["o"], got[name]["fp32"])
    if CASES[name][0] == "int4":
        assert m.ok and m.mean_abs_error < 5e-2, (name, m)
    else:
        assert m.passes(5e-2), (name, m)
