"""Rank bodies of the port's serving-mesh tests, run by parallel.launch in 4
spawned gloo ranks on the CPU.  This module imports torch, numpy and the
port, never JAX: a spawned rank imports it by name.

The 4 ranks make every mesh of a test at once (a mesh's groups are made by
every rank of the world): {data 2, model 2} and {model 4} over all four,
and 2-rank meshes as slices of a 2 x 2 rank array, so that ranks {0, 1}
and ranks {2, 3} each form their own {model 2} or {data 2} and can run
different cases at the same time."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_device_mesh,
)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair_meshes() -> dict:
    """{model 2} and {data 2} over ranks {0, 1} and over ranks {2, 3}
    (this rank's pair), and the pair's index."""
    ranks = torch.arange(4).reshape(2, 2)
    out = {"pair": dist.get_rank() // 2}
    for axis in (MODEL_AXIS, DATA_AXIS):
        dm = DeviceMesh("cpu", ranks, mesh_dim_names=("pair", axis))
        out[axis] = Mesh(dm[axis], CPU)
    return out


# ---------------------------------------------------------------------------
# decode/sharded.py


def _pages(arrays: dict):
    from cuda_flash_attention_tpu_torch.decode.kv_cache import KVPages

    return KVPages(*(_t(arrays[f]) for f in ("k_pages", "k_scales", "v_pages",
                                               "v_scales")))


def _full_pages(pages, mesh) -> dict:
    """The full cache from every rank's pages (heads over model, the pool
    over data)."""
    return {f: all_gather(all_gather(getattr(pages, f), mesh, MODEL_AXIS, 0),
                          mesh, DATA_AXIS, 1)
            for f in ("k_pages", "k_scales", "v_pages", "v_scales")}


def sharded_cases(inputs: dict) -> dict:
    """tp_paged_decode_attention, tp_chunk_append_attend (both writes) and
    dp_tp_append_attend on {model 2}, {model 4} and {data 2, model 2}: each
    rank takes its block of the global numpy inputs (heads over model;
    under data, its slot and its half of the pool, whose table holds local
    ids; the decode function's pages and queries are not split over data,
    as JAX's specs leave them), and the outputs and written pages come back
    gathered.  Then the divisibility errors.  Rank 0 returns every
    result."""
    from cuda_flash_attention_tpu_torch.decode import sharded
    from cuda_flash_attention_tpu_torch.decode.kv_cache import init_kv_pages
    from cuda_flash_attention_tpu_torch.parallel.collectives import local_slice

    meshes = {"model2": _pair_meshes()[MODEL_AXIS],
              "model4": make_device_mesh({MODEL_AXIS: 4}, device="cpu"),
              "dp2_tp2": make_device_mesh({DATA_AXIS: 2, MODEL_AXIS: 2},
                                          device="cpu")}
    f32 = dict(compute_dtype=torch.float32)
    out = {}
    for name, mesh in meshes.items():
        data = DATA_AXIS if mesh.size(DATA_AXIS) > 1 else None
        table = inputs["local_table" if data else "global_table"]

        def rows(x):  # this rank's slots (every slot without data)
            return local_slice(_t(x), mesh, DATA_AXIS, 0)

        def heads(x, dim, x_rows=rows):
            return local_slice(x_rows(x), mesh, MODEL_AXIS, dim).contiguous()

        def gather(o, dim):
            return all_gather(all_gather(o, mesh, MODEL_AXIS, dim), mesh,
                              DATA_AXIS, 0)

        def pages():
            return sharded.shard_kv_pages(mesh, _pages(inputs["pages"]),
                                          data_axis=data)

        res = {}
        o = sharded.tp_paged_decode_attention(
            mesh, heads(inputs["q"], 1, _t),
            sharded.shard_kv_pages(mesh, _pages(inputs["pages"])),
            _t(inputs["global_table"]), _t(inputs["lengths"]), **f32)
        res["decode"] = all_gather(o, mesh, MODEL_AXIS, 1)
        for key, paged in (("chunk", False), ("chunk_paged", True)):
            c = inputs[key]
            o, pg = sharded.tp_chunk_append_attend(
                mesh, heads(c["q"], 2), heads(c["k"], 2), heads(c["v"], 2),
                pages(), rows(table), rows(c["first"]), rows(c["active"]),
                rows(c["total"]), paged_write=paged, **f32)
            res[key] = {"o": gather(o, 2), "pages": _full_pages(pg, mesh)}
        c = inputs["append"]
        o, pg = sharded.dp_tp_append_attend(
            mesh, heads(c["q"], 1), heads(c["k"], 1), heads(c["v"], 1), pages(),
            rows(table), rows(c["positions"]), rows(c["active"]),
            rows(c["lengths"]), **f32)
        res["append"] = {"o": gather(o, 1), "pages": _full_pages(pg, mesh)}
        out[name] = res

    errors = {}
    for what, fn in (
            ("heads", lambda: sharded.shard_kv_pages(
                meshes["model4"], init_kv_pages(2, 4, 128, 64, device="cpu"))),
            ("pool", lambda: sharded.init_local_kv_pages(
                meshes["dp2_tp2"], 4, 15, 128, 64, data_axis=DATA_AXIS))):
        try:
            fn()
            errors[what] = None
        except ValueError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# DecodeEngine(mesh=)


def _cfg(name: str, **kw):
    from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig

    fp32 = dict(dtype=torch.float32, attn_tile_dtype=None)
    return {"bf16": lambda: TransformerConfig.tiny(**kw),
            "fp32": lambda: dataclasses.replace(
                TransformerConfig.tiny(**fp32, **kw), n_kv_heads=4),
            "moe": lambda: TransformerConfig.tiny_moe(capacity_factor=0.6,
                                                      **fp32, **kw)}[name]()


def _host_state(eng, reqs) -> tuple:
    """Every piece of host state that must agree across ranks."""
    return ([r.generated for r in reqs], [t.tolist() for t in eng._tables],
            eng.lengths.tolist(), [a.available for a in eng._group_allocs],
            [list(a._free) for a in eng._group_allocs],
            sorted(getattr(eng, "_prefix_maps", {}).values()))


def _agree(eng, reqs, group) -> bool:
    """True when every rank of `group` holds the same host state."""
    states = [None] * dist.get_world_size(group)
    dist.all_gather_object(states, _host_state(eng, reqs), group=group)
    return all(s == states[0] for s in states)


def _serve(params, case: dict, mesh, group) -> dict:
    """One engine run of `case` on `mesh`: its greedy tokens, stats, the
    allocators drained, and the ranks' agreement.  A case with "stages"
    submits each stage's prompts one engine step after the last (a prefix
    cache's first request registers its pages before the next admits) and
    reports the refcounts of each request's first two pages as the last
    stage admits."""
    from cuda_flash_attention_tpu_torch.decode.engine import DecodeEngine
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    cfg = _cfg(case["cfg"])
    kw = dict(case.get("engine", {}))
    full = params_from_numpy(params[case["cfg"]], "cpu")
    if kw.pop("draft", False):
        kw.update(draft_params=dict(full, layers=full["layers"][:1]),
                  draft_cfg=dataclasses.replace(cfg, n_layers=1))
    eng = DecodeEngine(full, cfg, max_seq_len=512, page_size=128, mesh=mesh,
                       cache_dtype=torch.float32 if case["cfg"] != "bf16"
                       else torch.bfloat16, **kw)
    out = {}
    if "stages" in case:
        reqs = []
        for prompts in case["stages"]:
            if reqs:
                eng.step()
            reqs += eng.submit_many(prompts, max_new_tokens=case["new"])
        out["refcounts"] = [
            [eng.allocators[eng._slot_shard(r.slot)].refcount(p)
             for p in eng._slot_pages[r.slot][:2]] for r in reqs]
        while not all(r.done for r in reqs):
            eng.step()
        eng.step()
    else:
        reqs = eng.run(case["prompts"], max_new_tokens=case["new"])
    return dict(out, tokens=[r.generated for r in reqs],
                done=all(r.done for r in reqs), stats=dict(eng.stats),
                dp=eng.dp, tp=eng.tp,
                drained=all(a.available == a.num_pages - 1
                            for a in eng._group_allocs),
                agree=_agree(eng, reqs, group))


def _refusals(params, meshes) -> dict:
    """The engine's refusals on a mesh, each error's type and message."""
    from cuda_flash_attention_tpu_torch.decode.engine import DecodeEngine
    from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))

    bf16 = params_from_numpy(params["bf16"], "cpu")
    fp32 = params_from_numpy(params["fp32"], "cpu")
    kw = dict(max_seq_len=256, cache_dtype=torch.float32)
    hybrid = _cfg("bf16", attn_window=64, global_every=2)
    catch("hybrid", lambda: DecodeEngine(bf16, hybrid, mesh=meshes["model4"],
                                         max_seqs=2, **kw))
    catch("heads", lambda: DecodeEngine(bf16, _cfg("bf16"), mesh=meshes["model4"],
                                        max_seqs=2, **kw))
    catch("max_seqs", lambda: DecodeEngine(bf16, _cfg("bf16"),
                                           mesh=meshes["dp2_tp2"], max_seqs=3, **kw))
    catch("num_pages", lambda: DecodeEngine(bf16, _cfg("bf16"),
                                            mesh=meshes["dp2_tp2"], max_seqs=2,
                                            num_pages=9, **kw))
    catch("device", lambda: DecodeEngine(bf16, _cfg("bf16"), mesh=meshes["dp2_tp2"],
                                         max_seqs=2, device="cuda", **kw))
    catch("draft", lambda: DecodeEngine(
        fp32, _cfg("fp32"), mesh=meshes["model4"], max_seqs=2, spec_tokens=2,
        draft_params=dict(bf16, layers=bf16["layers"][:1]),
        draft_cfg=dataclasses.replace(_cfg("bf16"), n_layers=1), **kw))
    return out


def engine_cases(params: dict, pair_cases: list, world_cases: dict) -> dict:
    """Every engine case: ranks {0, 1} run pair_cases[0] and ranks {2, 3}
    pair_cases[1], each a dict name -> case on that pair's {model 2} or
    {data 2} (case["mesh"]); then all four ranks run world_cases on {data 2,
    model 2} or {model 4}, and the refusals.  Ranks 0 and 2 return their
    results."""
    pairs = _pair_meshes()
    world = {"dp2_tp2": make_device_mesh({DATA_AXIS: 2, MODEL_AXIS: 2},
                                         device="cpu"),
             "model4": make_device_mesh({MODEL_AXIS: 4}, device="cpu")}
    out = {}
    for name, case in pair_cases[pairs["pair"]].items():
        mesh = pairs[case["mesh"]]
        out[name] = _serve(params, case, mesh, mesh.group(case["mesh"]))
    for name, case in world_cases.items():
        out[name] = _serve(params, case, world[case["mesh"]], None)
    out["refusals"] = _refusals(params, world)
    return out if dist.get_rank() % 2 == 0 else None


def serving_cases(inputs: dict, params: dict, pair_cases: list,
                  world_cases: dict) -> dict:
    """sharded_cases, then engine_cases, in one spawn of the 4 ranks: rank
    0 returns {"sharded": ..., **its engine cases}, rank 2 its engine
    cases."""
    sharded = sharded_cases(inputs)
    out = engine_cases(params, pair_cases, world_cases)
    return dict(out, sharded=sharded) if dist.get_rank() == 0 else out
