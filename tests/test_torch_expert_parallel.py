"""Expert parallelism in the port (models/moe.py's moe_layer_shardings and
moe_ffn(mesh=), the model's and the train step's mesh path, DecodeEngine on
an "expert" axis) against the JAX package, on 4 gloo ranks on the CPU
(parallel/launch.py; rank bodies in tests/_torch_pp_ep_workers.py, one
spawn for the module).

The layer: tests/test_moe.py's fp32 config (d_model 32, 4 experts, d_ff
64), JAX's init_moe_layer carried across through numpy, x (2, 16, 32) from
a seed with numpy, at capacity factor 8.0 (JAX test_moe_ep_tp_mesh_parity's:
nothing drops) and 0.5 (the capacity binds), on {expert 4}, {data 2,
expert 2}, {expert 2, model 2} and {model 2}: each rank its block of x and
of the experts, the output gathered and held to JAX's unsharded moe_ffn
within atol 2e-5 and the aux loss within 1e-6 (that JAX test's bounds).
Two AdamW steps of tiny_moe (fp32) on {expert 2, model 2} against the
unsharded steps: losses and grad norms within rtol 2e-4, every leaf within
atol 1e-4 (tests/test_training.py's sharded-step tolerances).
DecodeEngine(mesh={"expert": 2, "model": 2}) on tiny_moe at capacity 0.6
(fp32, an fp32 cache): greedy tokens equal the JAX engine's without a mesh,
token for token.  Routing ties within tests/test_torch_moe.py's MARGIN are
the known divergence; these inputs have none that flip a token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flash_attention_tpu.models import moe as jax_moe
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.parallel import launch

import _torch_serving_jax
from _mesh_training_parity import assert_leaves_close, numpy_tree

LAYER_MESHES = {"expert4": {"expert": 4}, "dp2_ep2": {"data": 2, "expert": 2},
                "ep2_tp2": {"expert": 2, "model": 2}}
PAIR_MESHES = {"tp2": {"model": 2}}
CAPACITY = {"ample": 8.0, "binding": 0.5}
LAYER_CASES = [f"{m}_{c}" for m in (*LAYER_MESHES, *PAIR_MESHES) for c in CAPACITY]
# (local experts, local d_ff) each mesh gives a rank.
LOCAL = {"expert4": (1, 64), "dp2_ep2": (2, 64), "ep2_tp2": (2, 32), "tp2": (4, 32)}
PROMPTS = [[5, 17, 100, 42], [3, 9], [77] * 7, [1, 2, 3]]
NEW = 4


def _layer_cfg(cf):
    return jax_tf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, n_experts=4, dtype=jnp.float32,
        attn_tile_dtype=None, capacity_factor=cf)


def _x():
    return np.random.default_rng(7).standard_normal((2, 16, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def results():
    layer = numpy_tree(jax_moe.init_moe_layer(jax.random.PRNGKey(0), _layer_cfg(1.0)))
    x = _x()

    def cases(meshes):
        return {f"{m}_{c}": dict(mesh=shape, capacity_factor=cf, layer=layer, x=x)
                for m, shape in meshes.items() for c, cf in CAPACITY.items()}

    train_cfg = dataclasses.replace(jax_tf.TransformerConfig.tiny_moe(),
                                    dtype=jnp.float32, attn_tile_dtype=None)
    engine_cfg = _torch_serving_jax.jax_cfg("moe")
    train_params = jax.jit(jax_tf.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), train_cfg)
    engine_params = jax_tf.init_params(jax.random.PRNGKey(0), engine_cfg)
    tokens = np.random.default_rng(0).integers(0, 256, (4, 129)).astype(np.int32)
    ranks = launch.start("_torch_pp_ep_workers:expert_parallel_cases", 4, args=(
        cases(LAYER_MESHES), cases(PAIR_MESHES),
        dict(params=numpy_tree(train_params), tokens=tokens,
             mesh={"expert": 2, "model": 2}),
        dict(params=numpy_tree(engine_params), prompts=PROMPTS, new=NEW,
             mesh={"expert": 2, "model": 2})), timeout=300)
    want = {}
    for c, cf in CAPACITY.items():
        y, aux = jax.jit(lambda xx, ll, cf=cf: jax_moe.moe_ffn(xx, ll, _layer_cfg(cf)))(
            jnp.asarray(x), jax.tree.map(jnp.asarray, layer))
        want[c] = (np.asarray(y), float(aux))
    want["tokens"] = _torch_serving_jax.jax_tokens({"moe": engine_params},
                                                   {"moe": (PROMPTS, NEW)})["moe"]
    return ranks.result()[0], want


@pytest.mark.parametrize("name", LAYER_CASES)
def test_ep_layer_matches_jax_unsharded(results, name):
    got, want = results[0][name], results[1][name.rsplit("_", 1)[1]]
    np.testing.assert_allclose(got["y"], want[0], rtol=0, atol=2e-5)
    assert abs(got["aux"] - want[1]) < 1e-6
    mesh = name.rsplit("_", 1)[0]
    assert (got["local_experts"], got["local_d_ff"]) == LOCAL[mesh]


def test_binding_capacity_drops_tokens():
    """The 0.5 case's capacity binds (JAX's routing of the same inputs
    drops some (token, choice) pairs), so the layer cases cover the dump
    row on every mesh."""
    cfg = _layer_cfg(CAPACITY["binding"])
    layer = jax_moe.init_moe_layer(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(_x()).reshape(-1, 32)
    _, _, idx, _ = jax_moe._route(x, layer, cfg)
    rank = jax_moe._ranks(idx, cfg.n_experts)
    cap = jax_moe.expert_capacity(x.shape[0], 4, 2, cfg.capacity_factor)
    assert int(jnp.sum(rank >= cap)) > 0


def test_ep_tp_train_steps_match_unsharded(results):
    got = results[0]["train"]
    mesh, ref = got["mesh"], got["unsharded"]
    assert tuple(mesh["local_experts"]) == (2, 128, 128)  # 4 experts, d_ff 256
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=2e-4)
    np.testing.assert_allclose(mesh["grad_norm"], ref["grad_norm"], rtol=2e-4)
    assert_leaves_close(mesh["params"], ref["params"])


def test_ep_tp_engine_matches_jax_engine(results):
    got, want = results[0]["engine"], results[1]["tokens"]
    assert got["tokens"] == want, (got, want)
    assert got["agree"] and got["drained"]
    assert got["experts_local"] == 2
