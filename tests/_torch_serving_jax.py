"""The JAX side of tests/test_torch_mesh_engine.py: the JAX engines
without a mesh, run in the test's process, and JAX's decode/sharded.py
functions on the test's numpy inputs, run in a process of their own beside
them (tracing holds the interpreter's lock, so a thread would not overlap
the two).  This module imports JAX, numpy and the JAX package, not torch,
so that process pays no torch import.  Its XLA backend runs at
optimization level 0 (`unoptimized_xla`): about a third less CPU time for
the interpret-mode compiles, its outputs within 6e-8 of level 2's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from cuda_flash_attention_tpu.decode import DecodeEngine
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu.decode import sharded as jax_sharded
from cuda_flash_attention_tpu.models.transformer import TransformerConfig
from cuda_flash_attention_tpu.parallel.mesh import make_device_mesh

PAGE = 128
MESHES = {"model2": {"data": 1, "model": 2}, "model4": {"data": 1, "model": 4},
          "dp2_tp2": {"data": 2, "model": 2}}
FIELDS = ("k_pages", "k_scales", "v_pages", "v_scales")


def jax_cfg(name):
    fp32 = dict(dtype=jnp.float32, attn_tile_dtype=None)
    return {"bf16": TransformerConfig.tiny(),
            "fp32": dataclasses.replace(TransformerConfig.tiny(), n_kv_heads=4,
                                        **fp32),
            "moe": dataclasses.replace(TransformerConfig.tiny_moe(),
                                       capacity_factor=0.6, **fp32)}[name]


def jax_tokens(params: dict, runs: dict) -> dict:
    """Greedy tokens of the JAX engine without a mesh (4 slots, bf16 cache
    for "bf16", fp32 otherwise): runs[name] = (prompts, new tokens), on
    params[name]."""
    out = {}
    for name, (prompts, new) in runs.items():
        cache = jnp.bfloat16 if name == "bf16" else jnp.float32
        eng = DecodeEngine(params[name], jax_cfg(name),
                           max_seqs=4, max_seq_len=512, page_size=PAGE,
                           cache_dtype=cache)
        out[name] = [r.generated for r in eng.run(prompts, max_new_tokens=new)]
    return out


def unoptimized_xla():
    """Before the process's first JAX computation: XLA's backend at
    optimization level 0."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")


def jax_results(inputs) -> dict:
    """Each mesh's four calls as one jitted program (one compile a mesh)."""
    pages0 = jax_kv.KVPages(*(jnp.asarray(inputs["pages"][f]) for f in FIELDS))
    f32 = dict(compute_dtype=jnp.float32)
    arrays = jax.tree.map(jnp.asarray, {k: inputs[k] for k in (
        "q", "lengths", "global_table", "local_table", "chunk", "chunk_paged",
        "append")})
    out = {}
    for name, shape in MESHES.items():
        mesh = make_device_mesh(shape, devices=jax.devices("cpu")[:shape["data"]
                                                                 * shape["model"]])
        data = "data" if shape["data"] > 1 else None

        @jax.jit
        def calls(a, pages0):
            table = a["local_table" if data else "global_table"]

            def pages():
                return jax_sharded.shard_kv_pages(mesh, pages0, data_axis=data)

            res = {"decode": jax_sharded.tp_paged_decode_attention(
                mesh, a["q"], jax_sharded.shard_kv_pages(mesh, pages0),
                a["global_table"], a["lengths"], **f32)}
            for key, paged in (("chunk", False), ("chunk_paged", True)):
                c = a[key]
                o, pg = jax_sharded.tp_chunk_append_attend(
                    mesh, c["q"], c["k"], c["v"], pages(), table, c["first"],
                    c["active"], c["total"], paged_write=paged, **f32)
                res[key] = {"o": o, "pages": {f: getattr(pg, f) for f in FIELDS}}
            c = a["append"]
            o, pg = jax_sharded.dp_tp_append_attend(
                mesh, c["q"], c["k"], c["v"], pages(), table, c["positions"],
                c["active"], c["lengths"], **f32)
            res["append"] = {"o": o, "pages": {f: getattr(pg, f) for f in FIELDS}}
            return res

        out[name] = jax.tree.map(np.asarray, calls(arrays, pages0))
    return out
