"""Port parity and contract tests for the serving layer of
cuda_flash_attention_tpu_torch: the DecodeEngine gives the JAX engine's
greedy tokens at the tiny config, sampling matches the JAX warps, the
package never imports JAX, and entry points do not fall back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import engine as jax_engine
from cuda_flash_attention_tpu.decode import sampling as jax_sampling
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import engine, kv_cache, sampling
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cuda_flash_attention_tpu_torch"
PROMPTS = [[5, 7, 11], [2, 3, 200, 17, 9], list(range(40, 170))]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _port_engine(tiny, **kw):
    _, cfg_t, _, params_t = tiny
    return engine.DecodeEngine(params_t, cfg_t, max_seqs=2, max_seq_len=512,
                               page_size=128, cache_dtype=torch.int8,
                               device="cpu", **kw)


def test_greedy_tokens_match_jax_engine(tiny):
    """3 requests on 2 slots (the third queues), 6 tokens each, int8 cache."""
    cfg_j, _, params_j, _ = tiny
    eng_j = jax_engine.DecodeEngine(params_j, cfg_j, max_seqs=2,
                                    max_seq_len=512, page_size=128,
                                    cache_dtype=jnp.int8)
    want = [r.generated for r in eng_j.run(PROMPTS, max_new_tokens=6)]
    eng_t = _port_engine(tiny)
    reqs = eng_t.run(PROMPTS, max_new_tokens=6)
    assert [r.generated for r in reqs] == want
    assert all(r.done and len(r.generated) == 6 for r in reqs)
    assert eng_t.allocator.available == eng_t.num_pages - 1
    assert all(r.ttft_s is not None and r.tpot_s is not None for r in reqs)
    assert eng_t.stats["tokens"] == 18 and eng_t.stats["steps"] > 0


def test_eos_stops_a_request(tiny):
    eng = _port_engine(tiny)
    (probe,) = eng.run([PROMPTS[1]], max_new_tokens=4)
    eos = probe.generated[1]
    (req,) = _port_engine(tiny).run([PROMPTS[1]], max_new_tokens=4, eos_id=eos)
    assert req.generated == probe.generated[:2]


def test_sampled_decoding_is_seeded(tiny):
    kw = dict(temperature=0.8, top_k=20, seed=7, logprobs=True)
    a = _port_engine(tiny, **kw).run(PROMPTS[:2], max_new_tokens=5)
    b = _port_engine(tiny, **kw).run(PROMPTS[:2], max_new_tokens=5)
    assert [r.generated for r in a] == [r.generated for r in b]
    for r in a:
        assert all(0 <= t < 256 for t in r.generated)
        assert len(r.logprobs) == 5 and all(lp <= 0.0 for lp in r.logprobs)


@pytest.mark.parametrize("kwargs", [
    dict(temperature=0.7),
    dict(temperature=1.0, top_k=5),
    dict(temperature=1.3, top_p=0.6),
    dict(temperature=0.9, min_p=0.05),
    dict(temperature=1.0, top_k=7, top_p=0.8, min_p=0.01),
])
def test_warp_logits_matches_jax(kwargs):
    logits = np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32) * 3
    want = np.asarray(jax_sampling.warp_logits(jnp.asarray(logits), **kwargs))
    got = sampling.warp_logits(torch.from_numpy(logits), **kwargs).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6)


def test_greedy_sampling_and_logprob_match_jax():
    logits = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)
    logits[2, [3, 9]] = 10.0  # a tie: the first maximum wins in both
    tok_j, lp_j = jax_sampling.sample_with_logprob(jnp.asarray(logits), None)
    tok_t, lp_t = sampling.sample_with_logprob(torch.from_numpy(logits))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-6)
    np.testing.assert_array_equal(
        sampling.sample_tokens(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_sampling.sample_tokens(jnp.asarray(logits), None)))


@pytest.mark.parametrize("kwargs", [
    dict(spec_tokens=2), dict(prefix_cache=True), dict(prefill_chunk=128),
    dict(mesh=object()), dict(decode_burst=4), dict(scan_layers=True),
])
def test_unported_engine_options_raise(tiny, kwargs):
    with pytest.raises(NotImplementedError):
        _port_engine(tiny, **kwargs)


def test_windowed_config_and_penalties_raise(tiny):
    _, cfg_t, _, params_t = tiny
    with pytest.raises(NotImplementedError):
        engine.DecodeEngine(params_t, dataclasses.replace(cfg_t, attn_window=64),
                            device="cpu")
    with pytest.raises(NotImplementedError):
        _port_engine(tiny).submit([1, 2], logit_bias={3: -1.0})
    with pytest.raises(NotImplementedError):
        _port_engine(tiny).submit([1, 2], presence_penalty=0.5)


@pytest.mark.parametrize("entry", ["DecodeEngine", "init_params",
                                   "init_kv_pages"])
def test_entry_points_without_device_run_on_cuda_or_raise(tiny, entry):
    """device=None means CUDA; without a card the entry points raise instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    _, cfg_t, _, params_t = tiny
    calls = {
        "DecodeEngine": lambda: engine.DecodeEngine(params_t, cfg_t),
        "init_params": lambda: transformer.init_params(torch.Generator(), cfg_t),
        "init_kv_pages": lambda: kv_cache.init_kv_pages(2, 3, 128, 64),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_never_imports_jax():
    """Import every module of the port (and chip_smoke) in a fresh process:
    neither jax nor the JAX package may be loaded."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'cuda_flash_attention_tpu'\n"
        "             or m.startswith('cuda_flash_attention_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env,
                   timeout=120)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PORT.rglob("*.py")] + [Path("chip_smoke.py")]
), ids=str)
def test_no_jax_import_statement(path):
    """No import of jax or of the JAX package anywhere in the source, even
    inside a function."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "cuda_flash_attention_tpu"), (
                f"{path}: imports {n}")
