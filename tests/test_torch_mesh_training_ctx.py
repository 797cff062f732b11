"""Port parity: the AdamW train step on {ctx 4} (ring attention over 32
tokens a rank, RoPE at each span's global positions, the loss's token mean
over ctx) in 4 gloo ranks against the JAX package's
make_optax_train_step(..., mesh=) on 4 virtual CPU devices and against the
port's unsharded step; the case and tolerances of
test_torch_mesh_training.py (_mesh_training_parity.py).
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
LAYOUTS = {"ctx4": {"ctx": 4}}


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
