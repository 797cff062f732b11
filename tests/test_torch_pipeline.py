"""Pipeline parallelism in the port (models/pipeline.py) against the JAX
package's, on 4 gloo ranks on the CPU (parallel/launch.py; rank bodies in
tests/_torch_pp_ep_workers.py, one spawn for the module) while JAX runs
its make_pp_* functions jitted on the root conftest's virtual CPU devices.

tests/test_pipeline.py's fp32 configs, JAX's init_params stacked by JAX's
stack_pipeline_params and carried to each rank's stage by
pipeline_params_from_numpy; tokens from a seed with numpy.  On {pipe 2}
(n_micro 2), {pipe 4} (n_micro 4), {pipe 2, model 2} (n_micro 2) and, with
homogeneous MoE stages (4 experts, every layer), on {pipe 2}: the loss
(make_pp_loss_fn, against the loss of JAX's first step, which is
make_pp_loss_fn's on the same parameters), the per-token NLL and the aux
loss (make_pipeline_nll), and two SGD-momentum steps (make_pp_train_step,
lr 1e-3): every loss
within rtol 2e-4 and every stacked leaf after the steps within atol 1e-4
(tests/test_training.py's sharded-step tolerances), the NLL within 1e-4,
the aux within 1e-6 (tests/test_moe.py's bound) and nonzero.  Then
stack_pipeline_params' shapes and every refusal, each with JAX's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.models import TransformerConfig, init_params
from cuda_flash_attention_tpu.models import pipeline as jax_pp
from cuda_flash_attention_tpu.parallel.mesh import cpu_test_mesh
from cuda_flash_attention_tpu_torch.models import pipeline
from cuda_flash_attention_tpu_torch.parallel import launch
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

import _torch_pp_ep_workers as workers


def _cfg_j(name):
    kw = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
              d_ff=128, dtype=jnp.float32, attn_tile_dtype=None)
    if name == "dense":
        return TransformerConfig(n_layers=4, **kw)
    return TransformerConfig(n_layers=2, n_experts=4, moe_every=1,
                             expert_top_k=2, **kw)


def _tokens(name):
    shape = (4, 33) if name == "dense" else (2, 33)
    return np.random.default_rng(1).integers(0, 64, shape).astype(np.int32)


def _case(cfg, mesh, n_micro):
    return dict(cfg=cfg, mesh=mesh, n_micro=n_micro)


PAIR_CASES = [{"pipe2": _case("dense", {"pipe": 2}, 2)},
              {"moe_pipe2": _case("moe", {"pipe": 2}, 2)}]
WORLD_CASES = {"pipe4": _case("dense", {"pipe": 4}, 4),
               "pipe2_tp2": _case("dense", {"pipe": 2, "model": 2}, 2)}
CASES = {**PAIR_CASES[0], **PAIR_CASES[1], **WORLD_CASES}


@pytest.fixture(scope="module")
def params():
    return {name: jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                          _cfg_j(name))
            for name in ("dense", "moe")}


def _stacked(params, case):
    pp = jax_pp.stack_pipeline_params(params[case["cfg"]], case["mesh"]["pipe"])
    return jax.tree.map(np.asarray, pp)


def _jax_case(params, case):
    """JAX's NLL, aux and two train steps of one case, jitted as one
    program (the steps scanned, so that the step compiles once); the
    first step's loss is make_pp_loss_fn's on the initial parameters."""
    cfg = _cfg_j(case["cfg"])
    mesh = cpu_test_mesh(case["mesh"])
    n, m = case["mesh"]["pipe"], case["n_micro"]
    pp = jax_pp.stack_pipeline_params(params[case["cfg"]], n)
    pp = jax.tree.map(jax.device_put, pp, jax_pp.pipeline_param_shardings(mesh, pp))
    nll_fn = jax_pp.make_pipeline_nll(cfg, mesh, n, m)
    step = jax_pp.make_pp_train_step(cfg, mesh, n, m)

    @jax.jit
    def run(pp, tokens):
        nll, aux = nll_fn(pp, tokens)
        opt = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), pp)

        def body(carry, _):
            pp, opt, loss = step(*carry, tokens)
            return (pp, opt), loss

        (pp, _), losses = jax.lax.scan(body, (pp, opt), None, length=2)
        return losses, nll, aux, pp

    losses, nll, aux, pp = run(pp, jnp.asarray(_tokens(case["cfg"])))
    return {"losses": np.asarray(losses)[[0, 0, 1]], "nll": np.asarray(nll),
            "aux": float(aux),
            "params": {"embed": np.asarray(pp["embed"]),
                       "final_norm": np.asarray(pp["final_norm"]),
                       "lm_head": np.asarray(pp["lm_head"]),
                       **{k: np.asarray(v) for k, v in pp["stages"].items()}}}


def _refusals_j(params) -> dict:
    """JAX's messages for the refusals the ranks hit."""
    dense = _cfg_j("dense")
    pipe2 = cpu_test_mesh({"pipe": 2})
    pp_tp = cpu_test_mesh({"pipe": 2, "model": 2})
    tok = jnp.asarray(_tokens("dense"))
    pp_moe = jax_pp.stack_pipeline_params(params["moe"], 2)

    def catch(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return type(e).__name__, str(e)

    return {
        "pipe_axis": catch(lambda: jax_pp.make_pipeline_nll(dense, pipe2, 4, 2)),
        "window": catch(lambda: jax_pp.make_pipeline_nll(
            dataclasses.replace(dense, attn_window=8, global_every=2), pipe2, 2, 2)),
        "tp_divides": catch(lambda: jax_pp.make_pipeline_nll(
            dataclasses.replace(dense, d_ff=127), pp_tp, 2, 2)),
        "batch": catch(lambda: jax_pp.make_pipeline_nll(dense, pipe2, 2, 3)(
            jax_pp.stack_pipeline_params(params["dense"], 2), tok)),
        "moe_tp": catch(lambda: jax_pp.make_pipeline_nll(_cfg_j("moe"), pp_tp, 2, 2)(
            pp_moe, tok[:2])),
    }


@pytest.fixture(scope="module")
def results(params):
    pair = [{k: dict(c, pp=_stacked(params, c), tokens=_tokens(c["cfg"]))
             for k, c in cases.items()} for cases in PAIR_CASES]
    world = {k: dict(c, pp=_stacked(params, c), tokens=_tokens(c["cfg"]))
             for k, c in WORLD_CASES.items()}
    refusal_args = (_stacked(params, CASES["pipe2"]),
                    _stacked(params, CASES["moe_pipe2"]), _tokens("dense"))
    ranks = launch.start("_torch_pp_ep_workers:pipeline_cases", 4,
                         args=(pair, world, refusal_args), timeout=300)
    want = {name: _jax_case(params, c) for name, c in CASES.items()}
    want["refusals"] = _refusals_j(params)
    got = ranks.result()
    return {**got[2], **got[0]}, want


@pytest.mark.parametrize("name", list(CASES))
def test_pp_loss_and_nll_match_jax(results, name):
    got, want = results[0][name], results[1][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=0, atol=1e-4)
    assert np.all(got["nll"][..., -1] == 0)  # the padded last column
    assert abs(got["aux"] - want["aux"]) < 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_pp_train_steps_match_jax(results, name):
    got, want = results[0][name], results[1][name]
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0, atol=1e-4,
                                   err_msg=k)
    assert got["losses"][2] < got["losses"][1]  # the same batch twice: it learns


def test_pp_moe_stages_carry_the_aux_loss(results):
    """The MoE stages' router aux loss is in the loss (JAX
    test_pp_moe_aux_loss_included): nonzero, and the loss is the mean NLL
    plus coef * aux / n_micro."""
    got = results[0]["moe_pipe2"]
    cfg = workers.pp_config("moe")
    assert got["aux"] > 0.0
    mean_nll = got["nll"].sum() / (got["nll"].shape[0] * got["nll"].shape[1] * 32)
    np.testing.assert_allclose(got["losses"][0],
                               mean_nll + cfg.router_aux_coef * got["aux"] / 2,
                               rtol=1e-6)
    assert got["losses"][0] - mean_nll > 1e-6


def test_stack_pipeline_params_shapes(params):
    full = params_from_numpy(jax.tree.map(np.asarray, params["dense"]), "cpu")
    pp = pipeline.stack_pipeline_params(full, 2)
    assert tuple(pp["stages"]["wq"].shape) == (2, 2, 64, 64)
    assert tuple(pp["stages"]["w_down"].shape) == (2, 2, 128, 64)
    want = jax_pp.stack_pipeline_params(params["dense"], 2)
    for k, v in want["stages"].items():
        np.testing.assert_array_equal(pp["stages"][k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("case", ["split", "homogeneous"])
def test_stack_pipeline_params_refusals(case):
    if case == "split":
        cfg_j = _cfg_j("dense")
        cfg_t = workers.pp_config("dense")
        n_stages = 3
    else:
        cfg_j = TransformerConfig.tiny_moe()
        from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig as T

        cfg_t = T.tiny_moe(dtype=torch.float32)
        n_stages = 2
    messages = []
    from cuda_flash_attention_tpu_torch.models.transformer import init_params as init_t

    for fn, p in ((jax_pp.stack_pipeline_params,
                   jax.jit(init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg_j)),
                  (pipeline.stack_pipeline_params,
                   init_t(torch.Generator().manual_seed(0), cfg_t, device="cpu"))):
        with pytest.raises(ValueError) as e:
            fn(p, n_stages)
        messages.append(str(e.value))
    assert messages[0] == messages[1], messages


@pytest.mark.parametrize("case", ["pipe_axis", "window", "tp_divides", "batch",
                                  "moe_tp"])
def test_pp_refusals_carry_jax_messages(results, case):
    got, want = results[0]["refusals"][case], results[1]["refusals"][case]
    assert want is not None and got == want, (got, want)


def test_pp_refuses_an_axis_it_would_only_repeat(results):
    kind, message = results[0]["refusals"]["other_axis"]
    assert kind == "NotImplementedError" and "a 'data' axis of size 2" in message
