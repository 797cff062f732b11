"""Port parity: the AdamW train step on {data 2, model 2} and on {model 4}
(models/training.py with `mesh=`; models/transformer.py's data x model
path: column and row blocks over "model", the vocab-split loss; at model 4
the axis does not divide the 2 KV heads, so each rank gathers K/V and
repeats them to its query heads, as JAX's repeated-KV branch) in 4 gloo
ranks against the JAX package's make_optax_train_step(..., mesh=) on 4
virtual CPU devices and against the port's unsharded step.

TransformerConfig.tiny() in fp32 (activations and tiles), the JAX
init_params tree carried into each rank's blocks by params_from_numpy with
the mesh, tokens (4, 129) from a seed with numpy, two steps of
make_optimizer(1e-3, warmup 1, decay 10) (the first at the warmup's lr 0,
the second at lr 1e-3) (_mesh_training_parity.py).  Tolerances are
tests/test_training.py's: each step's loss within rtol 2e-4, every
parameter leaf within atol 1e-4 after the steps.  {ctx 4} is in
test_torch_mesh_training_ctx.py, the MoE model in test_torch_mesh_moe.py.
"""

import jax
import pytest

from _mesh_training_parity import (
    check_loss,
    check_params,
    check_unsharded,
    run_layouts,
)

needs8 = pytest.mark.skipif(len(jax.devices("cpu")) < 8,
                            reason="needs 8 virtual CPU devices")
LAYOUTS = {"dp2_tp2": {"data": 2, "model": 2}, "tp4": {"model": 4}}


@pytest.fixture(scope="module")
def results():
    return run_layouts(LAYOUTS, 4)


@needs8
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_loss_matches_jax(results, layout):
    check_loss(results, layout)


@needs8
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_params_match_jax(results, layout):
    check_params(results, layout)


@needs8
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_matches_unsharded(results, layout):
    check_unsharded(results, layout)
