"""Serving on a mesh in the port against the JAX package, on 4 gloo ranks on
the CPU (parallel/launch.py; rank bodies in tests/_torch_serving_workers.py,
one spawn for the module) while the JAX side runs beside them (Pallas in
interpret mode, on the root conftest's virtual CPU devices;
tests/_torch_serving_jax.py).

decode/sharded.py: tp_paged_decode_attention, tp_chunk_append_attend
(per-token and paged writes) and dp_tp_append_attend on {model 2}, {model
4} and {data 2, model 2}, each rank running the function's local body on
its block, against JAX's functions jitted on the same numpy inputs.  The
cache is tests/test_decode_sharded.py's `_build_pages` (4 KV heads, D 64,
lengths 200 and 77, int8, the same random stream) with each slot's pages
placed in its own data shard's half of the 16-page pool (global pages 1-3
and 9-10; the data shards' tables hold the local ids 1-3 and 1-2).
Outputs and written pages are held to JAX's within fp32 atol 1e-5, as the
JAX test holds the sharded decode to the unsharded one.

DecodeEngine(mesh=) against the JAX engine without a mesh: greedy tokens
equal token for token.  Ranks {0, 1} and {2, 3} each form a 2-rank mesh
and run their own cases at the same time: TP 2 ({model 2}; greedy, a burst
of 4, speculation with a 1-layer draft, chunked prefill of a 200-token
prompt in 128-token chunks) and DP 2 ({data 2}; 6 requests on 2 slots, a
prefix-cache hit inside one data shard beside a miss in the other,
tiny_moe at capacity 0.6, whose layer couples every slot's tokens).  Then
all four form {data 2, model 2} (greedy with every shard's allocator
drained; speculation with chunked prefill; tiny_moe with its experts'
d_ff split over "model") and {model 4}.  The bf16 cases
are the JAX test's (tests/test_decode_sharded.py: TransformerConfig.tiny,
a bf16 cache); the speculative, chunked and prefix cases run in fp32 with
an fp32 cache (the one-shot and chunked paths are different programs,
whose bf16 logits can tie differently), on tiny with 4 KV heads so that
{model 4} divides them.  Every case ends with every rank of its mesh
holding the same host state (page tables, lengths, free lists, tokens).
Then the refusals (JAX's, and a device other than the mesh's), and the
decode bench's tensor-parallel dry run."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.bench import decode_bench
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.parallel import launch

import _torch_serving_jax
from _torch_serving_jax import FIELDS, MESHES, PAGE, jax_cfg

_RNG = np.random.default_rng(3)
LONG = _RNG.integers(0, 256, 200).tolist()
PREFIX = _RNG.integers(0, 200, PAGE).tolist()
SHORT = [[5, 17, 100, 42], [3, 9], [77] * 7, [1, 2, 3]]
CAPACITY = [[i + 1, i + 2] for i in range(6)]
HIT = [PREFIX + [11, 12, 13], PREFIX + [99, 98], PREFIX + [5]]
# The fp32 cases' prompts: two short ones, the long one, a short one.
FP32 = SHORT[:2] + [LONG] + SHORT[3:]


def _case(cfg, prompts, new, mesh, **engine):
    return dict(cfg=cfg, prompts=prompts, new=new, mesh=mesh, engine=engine)


PAIR_CASES = [
    {"tp2": _case("bf16", SHORT[:2], 4, "model", max_seqs=2),
     "tp2_burst": _case("bf16", SHORT[:2], 6, "model", max_seqs=2, decode_burst=4),
     "tp2_spec": _case("fp32", FP32[:2], 6, "model", max_seqs=2, draft=True,
                       spec_tokens=3),
     "tp2_chunked": _case("fp32", [LONG], 4, "model", max_seqs=2,
                          prefill_chunk=128)},
    {"dp2_capacity": _case("bf16", CAPACITY, 3, "data", max_seqs=2),
     "dp2_prefix": dict(cfg="fp32", stages=[HIT[:1], HIT[1:]], new=4, mesh="data",
                        engine=dict(max_seqs=4, prefix_cache=True)),
     "dp2_moe": _case("moe", SHORT, 4, "data", max_seqs=4)},
]
WORLD_CASES = {
    "dp2_tp2": _case("bf16", SHORT, 4, "dp2_tp2", max_seqs=4),
    "dp2_tp2_spec_chunked": _case("fp32", FP32, 4, "dp2_tp2", max_seqs=4,
                                  draft=True, spec_tokens=2, prefill_chunk=128),
    "tp4": _case("fp32", FP32, 4, "model4", max_seqs=4),
    # tiny_moe's experts' d_ff split over "model" (the port refused this
    # mesh before expert parallelism).
    "dp2_tp2_moe": _case("moe", SHORT, 4, "dp2_tp2", max_seqs=4),
}


# decode/sharded.py's inputs.
HKV, D = 4, 64
LENGTHS = (200, 77)
GLOBAL_TABLE = [[1, 2, 3, 0], [9, 10, 0, 0]]
LOCAL_TABLE = [[1, 2, 3, 0], [1, 2, 0, 0]]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    pages = jax_kv.init_kv_pages(HKV, 16, PAGE, D, jnp.int8)
    for s, length in enumerate(LENGTHS):
        n = -(-length // PAGE)
        k = jnp.asarray(rng.standard_normal((n * PAGE, HKV, D)), jnp.float32)
        v = jnp.asarray(rng.standard_normal((n * PAGE, HKV, D)), jnp.float32)
        pages = jax.jit(jax_kv.write_prompt_kv)(
            pages, k, v, jnp.asarray(GLOBAL_TABLE[s][:n], jnp.int32))
    q = rng.standard_normal((2, 2 * HKV, D)).astype(np.float32)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    lengths = np.asarray(LENGTHS, np.int32)
    chunk_first = np.asarray([256, 128], np.int32)
    return {
        "pages": {f: np.asarray(getattr(pages, f)) for f in FIELDS},
        "q": q, "lengths": lengths,
        "global_table": np.asarray(GLOBAL_TABLE, np.int32),
        "local_table": np.asarray(LOCAL_TABLE, np.int32),
        # Speculative chunk (T 4, per-token appends) after each prompt.
        "chunk": dict(q=normal(2, 4, 2 * HKV, D), k=normal(2, 4, HKV, D),
                      v=normal(2, 4, HKV, D), first=lengths,
                      active=np.asarray([True, True]), total=lengths + 4),
        # Chunked-prefill chunk (T 128, paged writes) from a page boundary.
        "chunk_paged": dict(q=normal(2, PAGE, 2 * HKV, D),
                            k=normal(2, PAGE, HKV, D), v=normal(2, PAGE, HKV, D),
                            first=chunk_first, active=np.asarray([True, True]),
                            total=chunk_first + PAGE),
        # Decode append; slot 1 inactive (its write goes to its null page).
        "append": dict(q=normal(2, 2 * HKV, D), k=normal(2, HKV, D),
                       v=normal(2, HKV, D), positions=lengths,
                       active=np.asarray([True, False]),
                       lengths=np.asarray([LENGTHS[0] + 1, 0], np.int32)),
    }


@pytest.fixture(scope="module")
def results():
    inputs = _inputs()
    # JAX's sharded functions run in a process of their own beside this
    # one's JAX engines (tests/_torch_serving_jax.py).
    jax_side = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_torch_serving_jax.unoptimized_xla)
    sharded = jax_side.submit(_torch_serving_jax.jax_results, inputs)
    jax_side.shutdown(wait=False)
    params = {name: jax_tf.init_params(jax.random.PRNGKey(0), jax_cfg(name))
              for name in ("bf16", "fp32", "moe")}
    numpy_params = {k: jax.tree.map(np.asarray, p) for k, p in params.items()}
    ranks = launch.start("_torch_serving_workers:serving_cases", 4, args=(
        inputs, numpy_params, PAIR_CASES, WORLD_CASES), timeout=300)
    # The dry run's own 2 ranks work beside them (its call waits in a thread).
    with ThreadPoolExecutor(1) as pool:
        dryrun = pool.submit(decode_bench.tp_decode_dryrun,
                             transformer.TransformerConfig.tiny(), tp=2, batch=2,
                             gen_tokens=5)
        want = dict(_torch_serving_jax.jax_tokens(params, {
            "bf16": (SHORT + CAPACITY, 6), "fp32": (FP32 + HIT, 6), "moe": (SHORT, 4)}),
            sharded=sharded.result())
        got = ranks.result()
        return {**got[2], **got[0], "dryrun": dryrun.result()}, want


def _want(want, cfg, prompts, new):
    """The JAX tokens of `prompts` (each a prompt of that config's run),
    cut to `new`."""
    pool = {"bf16": SHORT + CAPACITY, "fp32": FP32 + HIT, "moe": SHORT}[cfg]
    return [want[cfg][pool.index(p)][:new] for p in prompts]


@pytest.mark.parametrize("name", [*PAIR_CASES[0], *PAIR_CASES[1], *WORLD_CASES])
def test_mesh_engine_matches_jax_engine(results, name):
    got, want = results
    case = {**PAIR_CASES[0], **PAIR_CASES[1], **WORLD_CASES}[name]
    prompts = case.get("prompts") or [p for s in case["stages"] for p in s]
    res = got[name]
    assert res["tokens"] == _want(want, case["cfg"], prompts, case["new"]), res
    assert res["done"] and res["drained"] and res["agree"], res
    assert res["stats"]["graphs"] is False  # the CPU steps eagerly
    mesh = {"model": (1, 2), "data": (2, 1), "dp2_tp2": (2, 2),
            "model4": (1, 4)}[case["mesh"]]
    assert (res["dp"], res["tp"]) == mesh
    engine = case["engine"]
    if engine.get("spec_tokens"):
        assert res["stats"]["spec_rounds"] > 0
    if engine.get("prefill_chunk"):
        assert res["stats"]["prefill_chunks"] >= 2
    if engine.get("decode_burst"):
        assert res["stats"]["burst_dispatches"] > 0


def test_prefix_hit_stays_in_its_data_shard(results):
    """A and B share slots 0 and 1 of data shard 0 (B hits A's prefix page:
    refcount 2); C lands on shard 1, whose map is empty (a miss)."""
    assert results[0]["dp2_prefix"]["refcounts"] == [[2, 1], [2, 1], [1, 1]]


@pytest.mark.parametrize("case,error,words", [
    ("hybrid", "NotImplementedError", "hybrid (multi-window-group) cache is "
                                      "single-host"),
    ("heads", "ValueError", "the 'model' mesh axis (4) must divide both "
                            "n_kv_heads (2) and n_heads (4)"),
    ("max_seqs", "ValueError", "max_seqs (3) must divide over the 'data' axis (2)"),
    ("num_pages", "ValueError", "num_pages (9) must divide over the data axis (2)"),
    ("draft", "ValueError", "the 'model' mesh axis (4) must divide the DRAFT "
                            "model's n_kv_heads (2)"),
    ("device", "ValueError", "device cuda is not the mesh's cpu"),
])
def test_mesh_engine_refusals(results, case, error, words):
    kind, message = results[0]["refusals"][case]
    assert kind == error and words in message, message


def test_tp_decode_dryrun_bench_path(results):
    """The decode bench's --tp-dryrun path (JAX
    test_tp_decode_dryrun_bench_path): the engine on {model 2} generates."""
    out = results[0]["dryrun"]
    assert out["dryrun"] and out["timed_tokens"] > 0 and out["tp"] == 2


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", ["decode", "chunk", "chunk_paged", "append"])
def test_sharded_functions_match_jax(results, mesh, case):
    got = results[0]["sharded"][mesh][case]
    want = results[1]["sharded"][mesh][case]
    if case == "decode":
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    np.testing.assert_allclose(got["o"], want["o"], atol=1e-5)
    for f in FIELDS:
        np.testing.assert_allclose(got["pages"][f], want["pages"][f], atol=1e-5,
                                   err_msg=f)


@pytest.mark.parametrize("what,words", [
    ("heads", "the model-axis size 4 must divide n_kv_heads=2 (KV pages are "
              "head-sharded and must stay device-local)"),
    ("pool", "num_pages (15) must divide over the data axis (2): each shard "
             "owns a private pool slice"),
])
def test_divisibility_errors(results, what, words):
    assert results[0]["sharded"]["errors"][what] == words
