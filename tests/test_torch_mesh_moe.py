"""The mixture-of-experts model on a mesh, gradient accumulation on a
mesh, and the mesh path's refusals, in gloo ranks (models/transformer.py,
models/training.py, parallel/launch.py).

tiny_moe in fp32 (the JAX init_params tree carried into the ranks by
params_from_numpy with the mesh, tokens (4, 129) from a seed with numpy)
on {data 2} (the experts replicated) and on {model 2} (each expert's d_ff
split over "model": gate and up by columns, down by rows), every rank
routing the whole batch (so the capacity couples the tokens one device's
call couples): two AdamW steps equal the unsharded steps within
tests/test_training.py's tolerances (loss rtol 2e-4, every leaf atol
1e-4).  The dense tiny model
on {data 2} with grad_accum 2 (each microbatch a slice of the global batch,
its rows split over data) equals the unsharded one-batch steps the same
way.  The refusals carry
JAX's messages: sinks on a ctx axis, an input length that the ctx axis
does not divide.
"""

import jax
import numpy as np
import pytest

from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.parallel import launch
from _mesh_training_parity import (
    assert_leaves_close,
    config,
    numpy_tree,
    tokens,
)


@pytest.fixture(scope="module")
def results():
    params = jax_tf.init_params(jax.random.PRNGKey(1), config(moe=True))
    moe = launch.start("_torch_mesh_workers:train_cases", 2,
                       args=(numpy_tree(params), tokens(),
                             {"dp2": {"data": 2}, "tp2": {"model": 2}}, True))
    refused = launch.start("_torch_mesh_workers:refusals", 2, args=(tokens(),))
    dense = jax_tf.init_params(jax.random.PRNGKey(0), config())
    accum = launch.start("_torch_mesh_workers:train_cases", 2,
                         args=(numpy_tree(dense), tokens(), {"dp2": {"data": 2}},
                               False, 2, 2))
    return moe.result()[0], refused.result()[0], accum.result()[0]


def test_grad_accum_on_data_axis_matches_unsharded(results):
    got, ref = results[2]["dp2"], results[2]["unsharded"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-4)
    assert_leaves_close(got["params"], ref["params"])


def test_moe_on_data_axis_matches_unsharded(results):
    got, ref = results[0]["dp2"], results[0]["unsharded"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-4)
    assert_leaves_close(got["params"], ref["params"])


def test_moe_on_model_axis_matches_unsharded(results):
    """The experts' d_ff split over "model" (moe_layer_shardings; the
    port refused this mesh before expert parallelism)."""
    got, ref = results[0]["tp2"], results[0]["unsharded"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-4)
    assert_leaves_close(got["params"], ref["params"])


@pytest.mark.parametrize("case,error,words", [
    ("sinks_ctx", "NotImplementedError", "attention sinks + context parallelism"),
    ("odd_ctx", "ValueError", "should be divisible by 2, but it is equal to 127"),
])
def test_mesh_refusals(results, case, error, words):
    kind, message = results[1][case]
    assert kind == error and words in message, message
