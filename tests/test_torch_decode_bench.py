"""Port parity of the serving and training benchmarks
(cuda_flash_attention_tpu_torch/bench/decode_bench.py, train_bench.py)
against the JAX package's: build_state gives the same page table and first
tokens, and the device loop (make_loop_fn) the same tokens after n steps,
on the same weights and prompts (the tiny config in fp32, an int8 cache);
measure_decode_throughput and measure_engine_throughput return the JAX
functions' keys (tests/test_torch_train_bench.py: the training bench and
the command lines).  Tokens and page
ids are compared exactly; int8 cache bytes within one code (the prefill's
fp32 K/V differ in the last bits between the two packages, which can move
a value across a rounding edge)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.bench import decode_bench as jax_bench
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.bench import decode_bench
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

BATCH, PROMPT, MAX_LEN, STEPS = 2, 130, 512, 3


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    return cfg_j, cfg_t


@pytest.fixture(scope="module")
def jax_state(tiny):
    cfg_j, _ = tiny
    params, caches, table, first = jax_bench.build_state(
        cfg_j, BATCH, PROMPT, MAX_LEN)
    k_pages = np.array(caches[0].k_pages)  # the loop donates the caches
    run_n = jax_bench.make_loop_fn(cfg_j, table, PROMPT,
                                   horizon=PROMPT + STEPS + 1)
    _, toks = run_n(params, caches, first, n=STEPS)
    return params, k_pages, np.asarray(table), np.asarray(first), np.asarray(toks)


@pytest.fixture
def same_inputs(monkeypatch, jax_state):
    """The port's build_state on the JAX state's weights and prompts."""
    params_np = jax.tree.map(np.asarray, jax_state[0])
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1),
                                            (BATCH, PROMPT), 0, 256))
    monkeypatch.setattr(decode_bench, "init_params",
                        lambda gen, cfg, device: params_from_numpy(params_np, device))
    monkeypatch.setattr(decode_bench, "_prompt_tokens",
                        lambda cfg, b, s, seed: torch.from_numpy(prompts).long())


@pytest.mark.parametrize("scan_layers", [False, True], ids=["list", "stacked"])
def test_build_state_and_loop_match_jax(tiny, jax_state, same_inputs, scan_layers):
    _, cfg_t = tiny
    _, k_jax, table_j, first_j, toks_j = jax_state
    params, caches, table, first = decode_bench.build_state(
        cfg_t, BATCH, PROMPT, MAX_LEN, scan_layers=scan_layers, device="cpu")
    np.testing.assert_array_equal(table.numpy(), table_j)
    np.testing.assert_array_equal(first.numpy(), first_j)
    assert isinstance(caches, list)  # scan_layers keeps the list form
    k_port = caches[0].k_pages.numpy()
    assert np.abs(k_port.astype(np.int32) - k_jax.astype(np.int32)).max() <= 1
    run_n = decode_bench.make_loop_fn(cfg_t, table, PROMPT,
                                      horizon=PROMPT + STEPS + 1)
    _, toks = run_n(params, caches, first, STEPS)
    np.testing.assert_array_equal(toks.numpy(), toks_j)
    assert run_n.history.shape == (STEPS, BATCH)
    np.testing.assert_array_equal(run_n.history[-1].numpy(), toks_j)
    # A second run from the same start repeats itself (the loop rewrites the
    # positions it attends); the full-width table gives the same tokens.
    _, again = run_n(params, caches, first, STEPS)
    assert torch.equal(again, toks)
    wide = decode_bench.make_loop_fn(cfg_t, table, PROMPT)
    assert torch.equal(wide(params, caches, first, STEPS)[1], toks)


def test_measures_return_the_jax_keys(tiny):
    cfg_j = jax_tf.TransformerConfig.tiny()
    cfg_t = transformer.TransformerConfig.tiny()
    kw = dict(batch=1, prompt_len=8)
    want = jax_bench.measure_decode_throughput(cfg_j, gen_tokens=1, repeats=1, **kw)
    got = decode_bench.measure_decode_throughput(cfg_t, gen_tokens=1, repeats=2,
                                                 device="cpu", **kw)
    assert set(want) <= set(got) and {"eager_step_ms", "host_step_ms"} <= set(got)
    assert got["repeats"] == 2 and got["timer"] == "host_clock"
    assert (got["cache_dtype"], got["weight_dtype"], got["model"]) == (
        want["cache_dtype"], want["weight_dtype"], want["model"])
    want = jax_bench.measure_engine_throughput(cfg_j, gen_tokens=3, **kw)
    got = decode_bench.measure_engine_throughput(cfg_t, gen_tokens=3,
                                                 decode_burst=2, device="cpu", **kw)
    assert set(want) <= set(got)
    assert got["burst_dispatches"] > 0 and got["graph_replays"] == 0
    assert got["tp"] == 1 and got["graphs"] is False
