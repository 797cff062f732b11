"""Port parity: the PyTorch DecodeEngine serving a mixture-of-experts model
against the JAX engine, at TransformerConfig.tiny_moe() (layer 1 MoE) in
fp32 with an fp32 cache and capacity factor 0.6, so that the capacity
binds and the rows each call carries decide which tokens drop.  Greedy
tokens must be equal, in three setups: two prompts of different lengths in
one prefill bucket; chunked prefill beside a decoding slot (JAX's chunk
step carries all max_seqs rows); 16 slots, 12 of them busy, where a decode
step's 16 tokens overflow the capacity (inactive slots carry their last
token, as the JAX step feeds them).  Speculation with an MoE model is
held to JAX's in tests/test_torch_moe_speculative.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import DecodeEngine as JaxEngine
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.models import moe, transformer
from cuda_flash_attention_tpu_torch.models.moe import moe_ffn
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy


def _init_j(key, cfg_j):
    """JAX's init_params, jitted (eager it dispatches op by op)."""
    return jax.jit(jax_tf.init_params, static_argnums=1)(key, cfg_j)


PAGE = 128
_RNG = np.random.default_rng(20)
BUCKET = [_RNG.integers(0, 256, 40).tolist(), _RNG.integers(0, 256, 90).tolist()]
CHUNKED = [_RNG.integers(0, 256, 30).tolist(), _RNG.integers(0, 256, 200).tolist()]
MANY = [_RNG.integers(0, 256, int(n)).tolist() for n in _RNG.integers(5, 60, 12)]
# (prompts, max_seqs, prefill_chunk, new tokens)
SETUPS = {"bucket": (BUCKET, 2, None, 2), "chunked": (CHUNKED, 2, 128, 2),
          "16 slots": (MANY, 16, None, 3)}


@pytest.fixture(scope="module")
def tiny_moe():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny_moe(),
                                dtype=jnp.float32, attn_tile_dtype=None,
                                capacity_factor=0.6)
    cfg = transformer.TransformerConfig.tiny_moe(dtype=torch.float32,
                                                 attn_tile_dtype=None,
                                                 capacity_factor=0.6)
    params_j = _init_j(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, params_j, cfg, params_from_numpy(
        jax.tree.map(np.asarray, params_j), "cpu")


@pytest.mark.parametrize("setup", list(SETUPS))
def test_moe_engine_greedy_tokens_match_jax(tiny_moe, setup, monkeypatch):
    cfg_j, params_j, cfg, params = tiny_moe
    prompts, max_seqs, chunk, new = SETUPS[setup]
    kw = dict(max_seqs=max_seqs, max_seq_len=256, page_size=PAGE, prefill_chunk=chunk)
    want = [r.generated for r in JaxEngine(params_j, cfg_j, cache_dtype=jnp.float32,
                                           **kw).run(prompts, max_new_tokens=new)]
    calls = []  # (tokens of the call, (token, choice) pairs dropped)

    def counted(h, layer, c):
        x = h.reshape(-1, h.shape[-1])
        _, _, idx, _ = moe._route(x, layer, c)
        cap = moe.expert_capacity(len(x), c.n_experts, c.expert_top_k, c.capacity_factor)
        calls.append((len(x), int((moe._ranks(idx, c.n_experts) >= cap).sum())))
        return moe_ffn(h, layer, c)

    monkeypatch.setattr(transformer, "moe_ffn", counted)
    eng = DecodeEngine(params, cfg, cache_dtype=torch.float32, device="cpu", **kw)
    got = eng.run(prompts, max_new_tokens=new)
    assert [r.generated for r in got] == want
    assert all(r.done for r in got)
    assert eng.allocator.available == eng.num_pages - 1
    assert any(dropped for _, dropped in calls), "the capacity never bound"
    if chunk:  # a chunk call carries max_seqs rows of 128 tokens
        assert eng.stats["prefill_chunks"] >= 2
        assert any(n == max_seqs * chunk for n, _ in calls)
    if max_seqs == 16:  # decode steps carry all 16 slots, and some drop
        assert any(n == 16 and dropped for n, dropped in calls)


def test_moe_engine_refuses_speculation_and_a_ragged_scan(tiny_moe):
    """Speculation with an MoE target is taken (its rows are JAX's:
    tests/test_torch_moe_speculative.py), and refused on a hybrid cache as
    JAX's engine refuses it; scan_layers over tiny_moe's interleave is
    refused as JAX's stack_layer_params refuses it."""
    _, _, cfg, params = tiny_moe
    eng = DecodeEngine(params, cfg, spec_tokens=2, spec_mode="prompt_lookup",
                       device="cpu")
    assert eng.spec_tokens == 2
    hybrid = dataclasses.replace(cfg, attn_window=64, global_every=2)
    with pytest.raises(NotImplementedError, match="hybrid cache"):
        DecodeEngine(params, hybrid, spec_tokens=2, spec_mode="prompt_lookup",
                     device="cpu")
    with pytest.raises(ValueError, match="homogeneous"):
        DecodeEngine(params, cfg, scan_layers=True, device="cpu")
