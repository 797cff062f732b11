"""The shared part of the mesh train-step parity files
(test_torch_mesh_training.py, test_torch_mesh_training_ctx.py,
test_torch_mesh_moe.py): the tiny fp32 config and its JAX parameters,
tokens from a seed with numpy, the port's steps in gloo ranks
(_torch_mesh_workers.train_cases, started first) and JAX's
make_optax_train_step(..., mesh=) on virtual CPU devices (its steps
jitted together: one compile)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cuda_flash_attention_tpu.models import training as jax_training
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.parallel.mesh import cpu_test_mesh
from cuda_flash_attention_tpu_torch.parallel import launch

STEPS = 2


def tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (4, 129)).astype(np.int32)


def config(moe=False):
    make = jax_tf.TransformerConfig.tiny_moe if moe else jax_tf.TransformerConfig.tiny
    return dataclasses.replace(make(), dtype=jnp.float32, attn_tile_dtype=None)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def run_layouts(layouts: dict, ranks: int):
    """(the port's results: "unsharded" and each layout's, JAX's results
    per layout): each step's loss, and every parameter leaf after the
    steps."""
    cfg = config()
    params = jax_tf.init_params(jax.random.PRNGKey(0), cfg)
    tok = tokens()
    run = launch.start("_torch_mesh_workers:train_cases", ranks,
                       args=(numpy_tree(params), tok, layouts))
    opt = jax_training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=10)
    want = {}
    for name, shape in layouts.items():
        mesh = cpu_test_mesh(shape)
        p = jax.tree.map(jax.device_put, params, jax_tf.param_shardings(mesh, cfg))
        step = jax_training.make_optax_train_step(cfg, opt, mesh=mesh)

        @jax.jit
        def steps(state, tokens):
            losses = []
            for _ in range(STEPS):
                state, m = step(state, tokens)
                losses.append(m["loss"])
            return state, jnp.stack(losses)

        state, losses = steps(jax_training.init_train_state(p, opt),
                              jnp.asarray(tok))
        want[name] = {"loss": np.asarray(losses),
                      "params": [np.asarray(x) for x in jax.tree.leaves(state.params)]}
    return run.result()[0], want


def assert_leaves_close(got, want, atol=1e-4):
    """Every leaf (the JAX tree's order) within `atol`."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"leaf {i}")


def check_loss(results, layout):
    got, want = results
    np.testing.assert_allclose(got[layout]["loss"], want[layout]["loss"], rtol=2e-4)


def check_params(results, layout):
    got, want = results
    assert_leaves_close(got[layout]["params"], want[layout]["params"])


def check_unsharded(results, layout):
    got, ref = results[0][layout], results[0]["unsharded"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-4)
    assert_leaves_close(got["params"], ref["params"])
