"""Rank bodies of the port's mesh tests, run by parallel.launch in spawned
gloo ranks on the CPU.  This module imports torch, numpy and the port, never
JAX: a spawned rank imports it by name.  Each body takes global numpy
inputs, builds its meshes, runs its cases and returns the global results
(gathered over the mesh) on rank 0, None on the others."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cuda_flash_attention_tpu_torch.parallel.mesh import make_device_mesh


def _t(a):
    return torch.from_numpy(np.array(a))


def _rank0(result):
    return result if dist.get_rank() == 0 else None


def _ring_spec(mesh):
    from cuda_flash_attention_tpu_torch.parallel.sharded import qkv_partition_spec

    return qkv_partition_spec(mesh, ring=True)


def ring_cases(cases: dict) -> dict | None:
    """Ring attention forward and gradients: each case's global q, k, v and
    dO go to this rank's (data, model, ctx) blocks; O, dQ, dK and dV come
    back gathered, with the backward route the ring took."""
    from cuda_flash_attention_tpu_torch.parallel.ring import (
        backward_route,
        ring_attention,
    )
    from cuda_flash_attention_tpu_torch.parallel.sharded import gather, shard

    meshes, out = {}, {}
    for name, c in cases.items():
        key = tuple(c["mesh"].items())
        if key not in meshes:
            meshes[key] = make_device_mesh(c["mesh"], device="cpu")
        mesh = meshes[key]
        spec = _ring_spec(mesh)
        q, k, v = (shard(_t(c[x]), mesh, spec).requires_grad_(True)
                   for x in "qkv")
        o = ring_attention(mesh, q, k, v, causal=c["causal"],
                           window=c.get("window"))
        o.backward(shard(_t(c["do"]), mesh, spec))
        out[name] = {
            "o": gather(o.detach(), mesh, spec),
            "dq": gather(q.grad, mesh, spec),
            "dk": gather(k.grad, mesh, spec),
            "dv": gather(v.grad, mesh, spec),
            "route": backward_route(q, k, causal=c["causal"],
                                    window=c.get("window")),
        }
    return _rank0(out)


def quant_ring_cases(cases: dict) -> dict | None:
    """ring_attention_quantized (fp32 compute) and the fp32 ring on the same
    blocks, gathered."""
    from cuda_flash_attention_tpu_torch.parallel.ring import (
        ring_attention,
        ring_attention_quantized,
    )
    from cuda_flash_attention_tpu_torch.parallel.sharded import gather, shard

    mesh = make_device_mesh({"ctx": dist.get_world_size()}, device="cpu")
    spec = _ring_spec(mesh)
    out = {}
    for name, c in cases.items():
        q, k, v = (shard(_t(c[x]), mesh, spec) for x in "qkv")
        kv_dtype = c["kv_dtype"]
        if kv_dtype != "int4":
            kv_dtype = getattr(torch, kv_dtype)
        oq = ring_attention_quantized(mesh, q, k, v, kv_dtype=kv_dtype,
                                      causal=c["causal"],
                                      compute_dtype=torch.float32)
        with torch.no_grad():
            of = ring_attention(mesh, q, k, v, causal=c["causal"])
        out[name] = {"o": gather(oq, mesh, spec), "fp32": gather(of, mesh, spec)}
    return _rank0(out)


def head_parallel_cases(cases: dict) -> dict | None:
    """head_parallel_attention on {data 2, model 4}: forward and gradients
    of each case, gathered."""
    from cuda_flash_attention_tpu_torch.parallel.sharded import (
        gather,
        head_parallel_attention,
        qkv_partition_spec,
        shard,
        shard_qkv,
    )

    mesh = make_device_mesh({"data": 2, "model": 4}, device="cpu")
    spec = qkv_partition_spec(mesh)
    out = {}
    for name, c in cases.items():
        q, k, v = (x.requires_grad_(True)
                   for x in shard_qkv(mesh, _t(c["q"]), _t(c["k"]), _t(c["v"])))
        o = head_parallel_attention(mesh, q, k, v, causal=c["causal"],
                                    window=c.get("window"))
        o.backward(shard(_t(c["do"]), mesh, spec))
        out[name] = {x: gather(t, mesh, spec) for x, t in
                     (("o", o.detach()), ("dq", q.grad), ("dk", k.grad),
                      ("dv", v.grad))}
    return _rank0(out)


def _tiny(moe: bool = False):
    from cuda_flash_attention_tpu_torch.models import transformer

    make = (transformer.TransformerConfig.tiny_moe if moe
            else transformer.TransformerConfig.tiny)
    return make(dtype=torch.float32, attn_tile_dtype=None)


def train_cases(params_np, tokens, layouts: dict, moe: bool = False,
                steps: int = 2, grad_accum: int = 1) -> dict | None:
    """`steps` AdamW steps (lr 1e-3, warmup 1, decay 10) of the tiny model
    from the JAX tree `params_np` on each mesh layout (with `grad_accum`
    microbatches), every rank converting its own blocks (params_from_numpy
    with the mesh), beside the unsharded step (one batch): each step's loss
    and grad norm, and the gathered parameters."""
    from cuda_flash_attention_tpu_torch.models import training, transformer
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    cfg = _tiny(moe)
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                  decay_steps=10)
    tok = torch.from_numpy(np.array(tokens)).long()

    def run(mesh, accum=1):
        params = params_from_numpy(params_np, "cpu", mesh=mesh, cfg=cfg)
        state = training.init_train_state(params, opt)
        step = training.make_optax_train_step(cfg, opt, mesh=mesh,
                                              grad_accum=accum)
        losses, norms = [], []
        for _ in range(steps):
            state, m = step(state, tok)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        full = state.params if mesh is None else transformer.gather_params(
            state.params, mesh, cfg)
        return {"loss": losses, "grad_norm": norms,
                "params": transformer.tree_leaves(full)}

    out = {"unsharded": run(None)}
    for name, shape in layouts.items():
        out[name] = run(make_device_mesh(shape, device="cpu"), grad_accum)
    return _rank0(out)


def refusals(tokens) -> dict | None:
    """The mesh path's refusals on {ctx 2} (2 ranks): sinks on a ctx axis,
    an input length that does not split over ctx.  Returns each error's
    type and message."""
    from cuda_flash_attention_tpu_torch.models import transformer

    tok = torch.from_numpy(np.array(tokens)).long()
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))

    ctx2 = make_device_mesh({"ctx": 2}, device="cpu")
    cfg_sink = transformer.TransformerConfig.tiny(
        dtype=torch.float32, attn_tile_dtype=None, attn_window=16, attn_sinks=4)
    p = transformer.init_params(torch.Generator().manual_seed(0), cfg_sink,
                                device="cpu")
    catch("sinks_ctx", lambda: transformer.loss_fn(p, tok, cfg_sink, ctx2))
    catch("odd_ctx", lambda: transformer.loss_fn(p, tok[:, :-1], _tiny(), ctx2))
    return _rank0(out)


def helpers() -> dict | None:
    """make_hybrid_mesh and two_host_serving_mesh on 4 ranks of one host,
    and two_host_serving_mesh's refusal of a tp that does not divide them."""
    from cuda_flash_attention_tpu_torch.parallel.distributed import (
        make_hybrid_mesh,
        two_host_serving_mesh,
    )

    hybrid = make_hybrid_mesh({"data": 1, "model": 2}, {"data": 2}, device="cpu")
    serving = two_host_serving_mesh(2, device="cpu")
    try:
        two_host_serving_mesh(3, device="cpu")
        bad = None
    except ValueError as e:
        bad = str(e)
    return _rank0({"hybrid": hybrid.shape, "serving": serving.shape,
                   "bad_tp": bad,
                   "coords": (hybrid.index("data"), hybrid.index("model"))})


def fail_on(rank: int) -> int:
    """Raises on `rank`; the other ranks wait in a collective that the
    failed rank never joins."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def sleep_for(seconds: float) -> int:
    """Outlives a short launch timeout."""
    import time

    time.sleep(seconds)
    return dist.get_rank()
