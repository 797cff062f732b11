"""Port parity: sliding windows and attention sinks on the serving path.

Kernels B5 (paged decode) and B6 (paged chunk attention): their plain
versions on the CPU against the JAX package's Pallas kernels in interpret
mode, on the same pages written by each package's own writers, at windows
64, 128 and 300 with sinks 0, 4 and 200, over int8 and bf16 caches.
Tolerance: 1e-5 with fp32 compute (the JAX window tests' gate,
tests/test_window_decode.py) and 2e-2 with bf16 compute.  The output is
bitwise unchanged when the table entries behind every row's window are
zeroed (the engine's recycling) or name another slot's pages.

The DecodeEngine with window groups (tiny config, fp32 weights): the groups
formed and the hybrid refusals as the JAX engine's; the local group
recycles behind its window while the global group keeps its pages, the
sink page stays resident, and a rolling cache finishes in a pool smaller
than the unrecycled length.  Greedy tokens against the JAX engine are in
tests/test_torch_window_engine.py.  The CUDA kernels are held to these
plain versions on the card by tests/test_torch_kernels_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import attention as jax_attention
from cuda_flash_attention_tpu.decode import engine as jax_engine
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import attention, engine, kv_cache
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
HKV, GROUP, D = 2, 2, 64
# Lengths (B6: the total, the chunk included) across page edges; slot 3 is
# inactive.
LENGTHS = [700, 300, 77, 0, 512]
PPS = 6


def _setup(jdt, tdt, chunk, seed=0):
    """The same pages in both packages, written by each one's prompt
    writer, and queries [n, chunk, Hq, D]."""
    rng = np.random.default_rng(seed)
    n = len(LENGTHS)
    num_pages = n * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(n, PPS)
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    for s in range(n):
        k = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    q = rng.standard_normal((n, chunk, HKV * GROUP, D)).astype(np.float32)
    return pj, pt, table, np.array(LENGTHS, np.int32), q


def _run(kind, pages, table, lengths, q, compute, **kw):
    """B5 (kind "decode", q[:, 0]) or B6 through the port, as numpy."""
    tc = torch.float32 if compute == "fp32" else torch.bfloat16
    args = (pages, torch.from_numpy(table), torch.from_numpy(lengths))
    if kind == "decode":
        o = attention.paged_decode_attention(torch.from_numpy(q[:, 0]).to(tc),
                                             *args, compute_dtype=tc, **kw)
    else:
        o = attention.paged_chunk_attention(torch.from_numpy(q).to(tc), *args,
                                            compute_dtype=tc, **kw)
    return o.float().numpy()


def _run_jax(kind, pages, table, lengths, q, compute, **kw):
    jc = jnp.float32 if compute == "fp32" else jnp.bfloat16
    args = (pages, jnp.asarray(table), jnp.asarray(lengths))
    if kind == "decode":
        o = jax_attention.paged_decode_attention(jnp.asarray(q[:, 0], jc), *args,
                                                 compute_dtype=jc, **kw)
    else:
        o = jax_attention.paged_chunk_attention(jnp.asarray(q, jc), *args,
                                                compute_dtype=jc, **kw)
    return np.asarray(o.astype(jnp.float32))


def _stale(table, lengths, chunk, window, sinks, other=True):
    """The table with each entry behind every row's window (not a sink
    page) zeroed, or pointed at the next slot's page."""
    out = table.copy()
    for s, n in enumerate(lengths):
        first = max(0, int(n) - chunk - window + 1)
        for p in range(table.shape[1]):
            if p * PAGE < n and (p + 1) * PAGE <= first and p * PAGE >= sinks:
                out[s, p] = table[(s + 1) % len(table), p] if other else 0
    return out


# (kernel, T, cache, compute, window, sinks)
CASES = [
    ("decode", 1, "int8", "fp32", 64, 0),
    ("decode", 1, "int8", "fp32", 128, 4),
    ("decode", 1, "bf16", "fp32", 300, 200),
    ("decode", 1, "bf16", "bf16", 128, 4),
    ("chunk", 5, "int8", "fp32", 64, 4),
    ("chunk", 5, "bf16", "fp32", 128, 200),
    ("chunk", 5, "int8", "bf16", 300, 0),
    ("chunk", 256, "int8", "fp32", 128, 4),
]
DTYPES = {"int8": (jnp.int8, torch.int8), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("kind,chunk,cache,compute,window,sinks", CASES, ids=str)
def test_windowed_paged_matches_jax(kind, chunk, cache, compute, window, sinks):
    pj, pt, table, lengths, q = _setup(*DTYPES[cache], chunk)
    kw = dict(window=window, sinks=sinks)
    want = _run_jax(kind, pj, table, lengths, q, compute, **kw)
    got = _run(kind, pt, table, lengths, q, compute, **kw)
    np.testing.assert_allclose(got, want, atol=1e-5 if compute == "fp32" else 2e-2,
                               rtol=0)
    assert not got[3].any(), "an inactive slot (length 0) gives zeros"
    for other in (False, True):
        stale = _stale(table, lengths, chunk, window, sinks, other)
        assert (stale != table).any()
        np.testing.assert_array_equal(
            _run(kind, pt, stale, lengths, q, compute, **kw), got)


def test_split_plans_cover_the_live_span():
    """The split-KV plans count the pages a window can touch, from shapes
    alone: a 2048-token slot at window 128 spreads its two live pages over
    the splits (not 1 live split in 16)."""
    span = attention.live_page_span(16, 128, 128, 0)
    assert span == 2
    assert attention.live_page_span(16, 128, 128 + 5 - 1, 4) == 4
    assert attention.live_page_span(16, 128, attention.NO_WINDOW, 0) == 16
    n = attention.decode_split_plan(8, 8, span, 132)
    assert 1 <= n <= span
    assert attention.chunk_split_plan(8, 8, attention.live_page_span(
        16, 128, 128 + 4, 4), 5, 2, 132) >= 1


def test_windows_below_one_raise():
    _, pt, table, lengths, q = _setup(jnp.int8, torch.int8, 1)
    with pytest.raises(ValueError, match="window"):
        _run("decode", pt, table, lengths, q, "fp32", window=0)


# ---------------------------------------------------------------------------
# The DecodeEngine with window groups.
# ---------------------------------------------------------------------------


def _tiny(**kw):
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(), dtype=jnp.float32,
                                attn_tile_dtype=None, **kw)
    cfg_t = dataclasses.replace(
        transformer.TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None),
        **kw)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


HYBRID = dict(attn_window=128, global_every=2)
STREAMING = dict(attn_window=128, attn_sinks=16)


@pytest.fixture(scope="module")
def hybrid():
    return _tiny(**HYBRID)


@pytest.fixture(scope="module")
def streaming():
    return _tiny(**STREAMING)


def _prompt(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def _engines(model, **kw):
    cfg_j, cfg_t, params_j, params_t = model
    args = dict(max_seqs=2, max_seq_len=1024, page_size=PAGE)
    args.update(kw)
    return (jax_engine.DecodeEngine(params_j, cfg_j, cache_dtype=jnp.float32, **args),
            engine.DecodeEngine(params_t, cfg_t, cache_dtype=torch.float32,
                                device="cpu", **args))


def test_groups_formed_as_jax(hybrid, streaming):
    for model, groups in ((hybrid, [128, None]), (streaming, [128])):
        eng_j, eng_t = _engines(model)
        assert eng_t._group_windows == eng_j._group_windows == groups
        assert eng_t._layer_group == eng_j._layer_group
        assert eng_t.n_groups == len(eng_t._tables) == len(eng_t._group_allocs)
        assert eng_t._tables[0] is eng_t.page_table
        assert (eng_t.window, eng_t.sinks) == (eng_j.window, eng_j.sinks)


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True),
    dict(spec_tokens=2, draft=True),
])
def test_hybrid_refusals_are_jax(hybrid, kw):
    cfg_j, cfg_t, params_j, params_t = hybrid
    kw = dict(kw)
    draft = kw.pop("draft", False)
    errors = []
    for eng_cls, cfg, params in ((jax_engine.DecodeEngine, cfg_j, params_j),
                                 (engine.DecodeEngine, cfg_t, params_t)):
        extra = dict(draft_params=params, draft_cfg=cfg) if draft else {}
        with pytest.raises(NotImplementedError, match="hybrid") as err:
            eng_cls(params, cfg, max_seqs=1, max_seq_len=256, page_size=PAGE,
                    **kw, **extra, **({"device": "cpu"} if eng_cls is engine.DecodeEngine
                                      else {}))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.fixture
def one_thread():
    """One intra-op thread for an engine loop of a few hundred tiny steps.
    Each step is some 300 small ops; with torch's default of one thread a
    core in every test worker, a suite run's workers oversubscribe the
    cores and each op's thread team waits on the others (the rolling-cache
    loop: 0.64 s alone, about 60 s beside 5 busy processes, 1 s a step).
    The ops compute the same on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_local_group_recycles_global_keeps(hybrid, one_thread):
    """Mid-generation of ~650 tokens the local group's live pages stay
    within the window's bound while the global group holds every page;
    both pools drain at the end."""
    _, cfg_t, _, params_t = hybrid
    eng = engine.DecodeEngine(params_t, cfg_t, max_seqs=1, max_seq_len=1024,
                              page_size=PAGE, cache_dtype=torch.float32,
                              device="cpu")
    req = eng.submit(_prompt(300), max_new_tokens=400)
    for _ in range(350):
        eng.step()
        assert eng._live_page_count(req.slot, 0) <= 128 // PAGE + 1
    assert not req.done
    assert eng._live_page_count(req.slot, 1) >= 5
    assert eng._group_pages[0][req.slot][0] is None  # recycled, index kept
    while not req.done:
        eng.step()
    eng.step()
    for a in eng._group_allocs:
        assert a.available == a.num_pages - 1


def test_rolling_cache_bounded_and_sink_resident(streaming, one_thread):
    """A 256-token prompt and 300 new tokens need 5 pages unrecycled, but
    the pool has 4 usable: only the rolling cache finishes.  The sink page
    stays resident while the middle pages are recycled."""
    _, cfg_t, _, params_t = streaming
    eng = engine.DecodeEngine(params_t, cfg_t, max_seqs=1, max_seq_len=640,
                              page_size=PAGE, cache_dtype=torch.float32,
                              num_pages=5, device="cpu")
    req = eng.submit(_prompt(256), max_new_tokens=300)
    for _ in range(200):
        eng.step()
    pages = eng._slot_pages[req.slot]
    assert pages[0] is not None            # the sink page
    assert pages[1] is None                # recycled behind the window
    while not req.done:
        eng.step()
    eng.step()
    assert len(req.generated) == 300
    assert eng.allocator.available == eng.num_pages - 1
