"""Rank bodies of the port's pipeline- and expert-parallel tests
(tests/test_torch_pipeline.py, tests/test_torch_expert_parallel.py), run by
parallel.launch in 4 spawned gloo ranks on the CPU.  This module imports
torch, numpy and the port, never JAX: a spawned rank imports it by name.

The 4 ranks make every mesh of a test at once: the 4-rank meshes over all
of them, and 2-rank meshes as slices of a 2 x 2 rank array, so that ranks
{0, 1} and {2, 3} each form their own and can run different cases at the
same time."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cuda_flash_attention_tpu_torch.parallel.mesh import Mesh, make_device_mesh

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair_mesh(axis: str) -> Mesh:
    """{axis 2} over this rank's pair: ranks {0, 1} or {2, 3}."""
    dm = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                    mesh_dim_names=("pair", axis))
    return Mesh(dm[axis], CPU)


def _mesh(shape: dict) -> Mesh:
    """A 4-rank mesh, or a pair's for a shape of 2 ranks."""
    if int(np.prod(list(shape.values()))) == 2:
        (axis,) = [a for a, n in shape.items() if n == 2]
        return _pair_mesh(axis)
    return make_device_mesh(shape, device="cpu")


def _catch(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# Pipeline parallelism (models/pipeline.py)


def pp_config(name: str):
    """tests/test_pipeline.py's fp32 configs: "dense" (its `_cfg`, 4
    layers) and "moe" (its homogeneous-MoE model, 2 layers, 4 experts)."""
    from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig

    kw = dict(vocab_size=64, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
              d_ff=128, dtype=torch.float32, attn_tile_dtype=None)
    if name == "dense":
        return TransformerConfig(n_layers=4, **kw)
    return TransformerConfig(n_layers=2, n_experts=4, moe_every=1,
                             expert_top_k=2, **kw)


def _stacked_tree(stage, mesh, cfg) -> dict:
    """JAX's stacked tree, flat ({"embed", "final_norm", "lm_head", and each
    stage key [n_stages, L/S, ...]}), on every rank from every rank's stage
    (the inverse of shard_pipeline_params)."""
    from cuda_flash_attention_tpu_torch.models.pipeline import _stage_spec
    from cuda_flash_attention_tpu_torch.models.transformer import _split_axes
    from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather

    model = "model" if "model" in mesh.axis_names else None
    layers = stage["layers"]
    out = {}
    for k in layers[0]:
        x = torch.stack([layer[k] for layer in layers])
        for dim, axis in _split_axes(_stage_spec(k, x.ndim + 1, model)[1:], mesh):
            x = all_gather(x, mesh, axis, dim)
        out[k] = all_gather(x[None], mesh, "pipe", 0)
    ranks = dist.get_process_group_ranks(mesh.group("pipe"))
    shapes = {"embed": (cfg.vocab_size, cfg.d_model), "final_norm": (cfg.d_model,),
              "lm_head": (cfg.d_model, cfg.vocab_size)}
    for k, shape in shapes.items():
        x = stage[k].contiguous() if k in stage else torch.empty(shape)
        dist.broadcast(x, ranks[0 if k == "embed" else -1], group=mesh.group("pipe"))
        out[k] = x
    return out


def _pp_case(case: dict) -> dict:
    """The port's PP loss, NLL and aux (make_pipeline_nll), and two
    SGD-momentum steps (lr 1e-3) from JAX's stacked tree `case["pp"]` on
    case["mesh"]: the three losses (before, at the first step, at the
    second) and the stacked tree after the steps."""
    from cuda_flash_attention_tpu_torch.models import pipeline, transformer
    from cuda_flash_attention_tpu_torch.utils.convert import pipeline_params_from_numpy

    cfg = pp_config(case["cfg"])
    mesh = _mesh(case["mesh"])
    n, m = case["mesh"]["pipe"], case["n_micro"]
    stage = pipeline_params_from_numpy(case["pp"], "cpu", mesh=mesh)
    tokens = _t(case["tokens"])
    loss = pipeline.make_pp_loss_fn(cfg, mesh, n, m)(stage, tokens)
    nll, aux = pipeline.make_pipeline_nll(cfg, mesh, n, m)(stage, tokens)
    step = pipeline.make_pp_train_step(cfg, mesh, n, m)
    opt = transformer.init_opt_state(stage)
    losses = [float(loss)]
    for _ in range(2):
        stage, opt, loss = step(stage, opt, tokens)
        losses.append(float(loss))
    return {"losses": losses, "nll": nll, "aux": float(aux),
            "params": _stacked_tree(stage, mesh, cfg)}


def _pp_refusals(pp_dense, pp_moe, tokens) -> dict:
    """make_pipeline_nll's refusals on {pipe 2}, {pipe 2, model 2} and
    {pipe 2, data 2}: each error's type and message."""
    from cuda_flash_attention_tpu_torch.models import pipeline
    from cuda_flash_attention_tpu_torch.utils.convert import pipeline_params_from_numpy

    dense, moe = pp_config("dense"), pp_config("moe")
    pipe2 = _pair_mesh("pipe")
    pp_tp = make_device_mesh({"pipe": 2, "model": 2}, device="cpu")
    pp_dp = make_device_mesh({"pipe": 2, "data": 2}, device="cpu")
    tok = _t(tokens)
    stage = pipeline_params_from_numpy(pp_dense, "cpu", mesh=pipe2)
    moe_tp = pipeline_params_from_numpy(pp_moe, "cpu", mesh=pp_tp)
    return {
        "pipe_axis": _catch(lambda: pipeline.make_pipeline_nll(dense, pipe2, 4, 2)),
        "window": _catch(lambda: pipeline.make_pipeline_nll(
            dataclasses.replace(dense, attn_window=8, global_every=2), pipe2, 2, 2)),
        "tp_divides": _catch(lambda: pipeline.make_pipeline_nll(
            dataclasses.replace(dense, d_ff=127), pp_tp, 2, 2)),
        "batch": _catch(lambda: pipeline.make_pipeline_nll(dense, pipe2, 2, 3)(
            stage, tok)),
        "moe_tp": _catch(lambda: pipeline.make_pipeline_nll(moe, pp_tp, 2, 2)(
            moe_tp, tok[:2])),
        "other_axis": _catch(lambda: pipeline.make_pipeline_nll(dense, pp_dp, 2, 2)),
    }


def pipeline_cases(pair_cases: list, world_cases: dict, refusal_args) -> dict:
    """Ranks {0, 1} run pair_cases[0] and ranks {2, 3} pair_cases[1] (each
    a dict name -> case on that pair's 2-rank mesh), then all four run
    world_cases and the refusals.  Ranks 0 and 2 return their results."""
    out = {name: _pp_case(c) for name, c in pair_cases[dist.get_rank() // 2].items()}
    out.update({name: _pp_case(c) for name, c in world_cases.items()})
    out["refusals"] = _pp_refusals(*refusal_args)
    return out if dist.get_rank() % 2 == 0 else None


# ---------------------------------------------------------------------------
# Expert parallelism (models/moe.py, the mesh path of the model, the step
# and the engine)


def ep_layer_config(capacity_factor: float):
    """tests/test_moe.py's `_fp32_cfg` (d_model 32, 4 experts, d_ff 64)."""
    from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                             n_kv_heads=2, head_dim=16, d_ff=64, n_experts=4,
                             dtype=torch.float32, attn_tile_dtype=None,
                             capacity_factor=capacity_factor)


def _ep_layer(case: dict) -> dict:
    """moe_ffn(mesh=) on case["mesh"]: each rank its block of the global x
    (rows over "data") and its blocks of the layer (moe_layer_shardings);
    the output gathered, and the aux loss."""
    from cuda_flash_attention_tpu_torch.models import moe
    from cuda_flash_attention_tpu_torch.models.transformer import _split
    from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    cfg = ep_layer_config(case["capacity_factor"])
    mesh = _mesh(case["mesh"])
    specs = moe.moe_layer_shardings(mesh, cfg)
    layer = params_from_numpy({k: _split(v, specs[k], mesh)
                               for k, v in case["layer"].items()}, "cpu")
    x = _split(_t(case["x"]), ("data", None, None), mesh)
    y, aux = moe.moe_ffn(x, layer, cfg, mesh=mesh)
    return {"y": all_gather(y, mesh, "data", 0), "aux": float(aux),
            "local_experts": layer["moe_gate"].shape[0],
            "local_d_ff": layer["moe_gate"].shape[2]}


def ep_train_config():
    from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig.tiny_moe(dtype=torch.float32, attn_tile_dtype=None)


def _ep_train(params_np, tokens, shape: dict) -> dict:
    """Two AdamW steps (lr 1e-3, warmup 1, decay 10) of tiny_moe on `shape`
    and without a mesh, from the same JAX tree: each step's loss and grad
    norm, and the gathered parameters."""
    from cuda_flash_attention_tpu_torch.models import training, transformer
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    cfg = ep_train_config()
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
    tok = _t(tokens).long()

    def run(mesh):
        params = params_from_numpy(params_np, "cpu", mesh=mesh, cfg=cfg)
        state = training.init_train_state(params, opt)
        step = training.make_optax_train_step(cfg, opt, mesh=mesh)
        losses, norms = [], []
        for _ in range(2):
            state, m = step(state, tok)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        full = state.params if mesh is None else transformer.gather_params(
            state.params, mesh, cfg)
        return {"loss": losses, "grad_norm": norms,
                "params": transformer.tree_leaves(full),
                "local_experts": None if mesh is None
                else params["layers"][1]["moe_gate"].shape}

    return {"mesh": run(_mesh(shape)), "unsharded": run(None)}


def _ep_engine(params_np, prompts, new: int, shape: dict) -> dict:
    """DecodeEngine on `shape` (tiny_moe at capacity 0.6, fp32, an fp32
    cache, 4 slots): the greedy tokens, and whether every rank holds the
    same tokens and drained its allocators."""
    from cuda_flash_attention_tpu_torch.decode.engine import DecodeEngine
    from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    cfg = TransformerConfig.tiny_moe(capacity_factor=0.6, dtype=torch.float32,
                                     attn_tile_dtype=None)
    eng = DecodeEngine(params_from_numpy(params_np, "cpu"), cfg, max_seqs=4,
                       max_seq_len=512, page_size=128, cache_dtype=torch.float32,
                       mesh=_mesh(shape))
    reqs = eng.run(prompts, max_new_tokens=new)
    tokens = [r.generated for r in reqs]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, tokens)
    return {"tokens": tokens, "agree": all(t == tokens for t in every),
            "drained": all(a.available == a.num_pages - 1 for a in eng._group_allocs),
            "experts_local": eng.params["layers"][1]["moe_gate"].shape[0]}


def expert_parallel_cases(layer_cases: dict, pair_layer_cases: dict, train: dict,
                          engine: dict) -> dict | None:
    """The layer on each 4-rank mesh and, on each pair, the pair cases;
    the train steps and the engine on train["mesh"] / engine["mesh"].  Rank
    0 returns the results."""
    out = {name: _ep_layer(c) for name, c in layer_cases.items()}
    out.update({name: _ep_layer(c) for name, c in pair_layer_cases.items()})
    out["train"] = _ep_train(train["params"], train["tokens"], train["mesh"])
    out["engine"] = _ep_engine(engine["params"], engine["prompts"], engine["new"],
                               engine["mesh"])
    return out if dist.get_rank() == 0 else None
