"""Port parity: speculative decoding with a mixture-of-experts target or
draft in the PyTorch DecodeEngine against the JAX engine, at
TransformerConfig.tiny_moe() (layer 1 MoE) in fp32 with an fp32 cache and
capacity factor 0.6, so that the capacity binds and the rows of each
propose and verify call decide which tokens drop.  Greedy tokens must be
equal in three setups: draft mode with a dense one-layer draft, draft mode
with an MoE draft, and prompt lookup at 4 slots with 1 idle (the idle row
rides along with its stale last token at length 0 and zeros for drafts,
as JAX's _spec_round feeds it).  Speculation with an MoE model is not
plain greedy decoding: the verify call routes k + 1 tokens a row
together, so the reference is the JAX engine speculating, not decoding.
A sampled round runs in both modes (the packages draw other random
numbers, so its tokens are held to the vocabulary, not to JAX's)."""

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

PAGE = 128
K = 3
_RNG = np.random.default_rng(21)
# Prompts that repeat themselves, so that prompt lookup finds drafts.
PROMPTS = [(_RNG.integers(0, 256, int(n)).tolist() * 3)[:int(m)]
           for n, m in ((9, 25), (14, 31), (6, 17), (11, 28))]
# (draft, prompts, new tokens) on 4 slots: a verify call carries 16 tokens,
# twice the least capacity (8) over 4 experts at top 2.
SETUPS = {"dense draft": ("dense", PROMPTS, 5), "moe draft": ("moe", PROMPTS, 5),
          "prompt lookup, 1 idle": (None, PROMPTS[:3], 6)}
SLOTS = 4


def _init_j(key, cfg_j):
    """JAX's init_params, jitted (eager it dispatches op by op)."""
    return jax.jit(jax_tf.init_params, static_argnums=1)(key, cfg_j)


def _pair(cfg_j, cfg, seed):
    params_j = _init_j(jax.random.PRNGKey(seed), cfg_j)
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")


@pytest.fixture(scope="module")
def models():
    fp32 = dict(dtype=torch.float32, attn_tile_dtype=None, capacity_factor=0.6)
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny_moe(), dtype=jnp.float32,
                                attn_tile_dtype=None, capacity_factor=0.6)
    cfg = transformer.TransformerConfig.tiny_moe(**fp32)
    dense_j = dataclasses.replace(cfg_j, n_layers=1, n_experts=0)
    dense = dataclasses.replace(cfg, n_layers=1, n_experts=0)
    out = {"target": (cfg_j, cfg) + _pair(cfg_j, cfg, 0),
           "dense": (dense_j, dense) + _pair(dense_j, dense, 9),
           "moe": (cfg_j, cfg) + _pair(cfg_j, cfg, 11)}
    return out


def _kw(models, draft, max_seqs, jax_side):
    kw = dict(max_seqs=max_seqs, max_seq_len=256, page_size=PAGE, spec_tokens=K)
    if draft is None:
        return dict(kw, spec_mode="prompt_lookup")
    cfg_j, cfg, params_j, params = models[draft]
    if jax_side:
        return dict(kw, draft_params=params_j, draft_cfg=cfg_j)
    return dict(kw, draft_params=params, draft_cfg=cfg)


def _counting(calls):
    """transformer.moe_ffn wrapped to record each call's rows and the
    (token, choice) pairs its capacity dropped."""
    def counted(h, layer, c):
        x = h.reshape(-1, h.shape[-1])
        _, _, idx, _ = moe._route(x, layer, c)
        cap = moe.expert_capacity(len(x), c.n_experts, c.expert_top_k, c.capacity_factor)
        calls.append((tuple(h.shape[:-1]),
                      int((moe._ranks(idx, c.n_experts) >= cap).sum())))
        return moe_ffn(h, layer, c)
    return counted


@pytest.mark.parametrize("setup", list(SETUPS))
def test_moe_speculation_greedy_tokens_match_jax(models, setup, monkeypatch):
    draft, prompts, new = SETUPS[setup]
    max_seqs = SLOTS
    cfg_j, cfg, params_j, params = models["target"]
    want = [r.generated for r in JaxEngine(
        params_j, cfg_j, cache_dtype=jnp.float32,
        **_kw(models, draft, max_seqs, True)).run(prompts, max_new_tokens=new)]
    calls = []
    monkeypatch.setattr(transformer, "moe_ffn", _counting(calls))
    eng = DecodeEngine(params, cfg, cache_dtype=torch.float32, device="cpu",
                       **_kw(models, draft, max_seqs, False))
    got = eng.run(prompts, max_new_tokens=new)
    assert [r.generated for r in got] == want
    assert all(r.done for r in got) and eng.stats["spec_rounds"] > 0
    assert eng.allocator.available == eng.num_pages - 1
    # Every verify call carries all max_seqs rows of K + 1 tokens, and the
    # capacity bound in some of them.
    verify = [dropped for shape, dropped in calls if shape == (max_seqs, K + 1)]
    assert verify and any(verify), calls
    if draft == "moe":  # the MoE draft's K + 1 steps carry every slot too
        assert sum(shape == (max_seqs,) for shape, _ in calls) >= K + 1
    if draft is None:
        assert eng.stats["spec_accepted"] > 0


@pytest.mark.parametrize("draft", ["moe", None], ids=["moe draft", "prompt lookup"])
def test_moe_speculation_sampled_runs(models, draft):
    _, cfg, _, params = models["target"]
    eng = DecodeEngine(params, cfg, cache_dtype=torch.float32, device="cpu",
                       temperature=0.8, top_k=50, seed=3, logprobs=True,
                       **_kw(models, draft, SLOTS, False))
    got = eng.run(PROMPTS[:3], max_new_tokens=5)
    assert all(r.done and len(r.generated) == 5 for r in got)
    assert all(0 <= t < cfg.vocab_size for r in got for t in r.generated)
    assert all(len(r.logprobs) == 5 and all(lp <= 0 for lp in r.logprobs) for r in got)
    assert eng.allocator.available == eng.num_pages - 1


def test_moe_hybrid_speculation_stays_refused(models):
    """As the JAX engine (decode/engine.py:212-216): a hybrid cache does
    not take speculation, MoE or not."""
    _, cfg, _, params = models["target"]
    hybrid = dataclasses.replace(cfg, attn_window=64, global_every=2)
    with pytest.raises(NotImplementedError, match="hybrid cache"):
        DecodeEngine(params, hybrid, spec_tokens=2, spec_mode="prompt_lookup",
                     device="cpu")
