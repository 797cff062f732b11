"""Port parity: speculative decoding in the PyTorch DecodeEngine against the
JAX package.  Greedy speculation (a one-layer draft model with k = 3, and
prompt lookup) must give exactly the JAX plain engine's greedy tokens, in
fp32 as tests/test_speculative.py holds the JAX engine (bf16 logits can tie
and break differently across programs).  speculative_accept is checked in
distribution: the two packages draw other random numbers, so its first
emitted token must follow the target distribution in both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import DecodeEngine as JaxEngine
from cuda_flash_attention_tpu.decode import sampling as jax_sampling
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.decode import DecodeEngine, sampling
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

PAGE = 128
PROMPTS = [[5, 17, 100, 42], [7, 3]]
LOOKUP_PROMPT = [5, 17, 100, 42] * 12


@pytest.fixture(scope="module")
def models():
    """The tiny target and a one-layer draft of other weights (a BAD draft:
    acceptance must survive frequent rejection), in both packages."""
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                             attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    draft_j = jax_tf.init_params(jax.random.PRNGKey(9),
                                 dataclasses.replace(cfg_j, n_layers=1))
    return dict(
        cfg_j=cfg_j, params_j=params_j, cfg=cfg,
        params=params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"),
        draft_cfg=dataclasses.replace(cfg, n_layers=1),
        draft=params_from_numpy(jax.tree.map(np.asarray, draft_j), "cpu"),
    )


@pytest.fixture(scope="module")
def jax_greedy(models):
    """The JAX plain engine's greedy tokens (fp32 cache)."""
    def run(prompts, n):
        eng = JaxEngine(models["params_j"], models["cfg_j"], max_seqs=2,
                        max_seq_len=512, page_size=PAGE, cache_dtype=jnp.float32)
        return [r.generated for r in eng.run(prompts, max_new_tokens=n)]
    return {"pair": run(PROMPTS, 7), "lookup": run([LOOKUP_PROMPT], 10)[0],
            "stop": run(PROMPTS[:1], 8)[0]}


def _engine(models, k=3, draft=True, **kw):
    spec = (dict(draft_params=models["draft"], draft_cfg=models["draft_cfg"])
            if draft else dict(spec_mode="prompt_lookup"))
    return DecodeEngine(models["params"], models["cfg"], max_seqs=2,
                        max_seq_len=512, page_size=PAGE,
                        cache_dtype=torch.float32, device="cpu",
                        spec_tokens=k, **spec, **kw)


def test_draft_greedy_matches_jax_plain_engine(models, jax_greedy):
    eng = _engine(models)
    reqs = eng.run(PROMPTS, max_new_tokens=7)
    assert [r.generated for r in reqs] == jax_greedy["pair"]
    assert eng.stats["spec_rounds"] > 0 and eng.stats["spec_proposed"] > 0
    assert eng.allocator.available == eng.num_pages - 1


def test_prompt_lookup_greedy_matches_jax_plain_engine(models, jax_greedy):
    eng = _engine(models, draft=False)
    (req,) = eng.run([LOOKUP_PROMPT], max_new_tokens=10)
    assert req.generated == jax_greedy["lookup"]
    assert eng.stats["spec_rounds"] > 0
    assert eng.allocator.available == eng.num_pages - 1


def test_lookup_proposals_follow_the_last_ngram(models):
    eng = _engine(models, draft=False)
    (req,) = eng.submit_many([[1, 2, 3, 4, 9, 1, 2]], max_new_tokens=4)
    req.generated.clear()  # history = the prompt alone
    proposals = eng._lookup_proposals(3)
    assert proposals[req.slot].tolist() == [3, 4, 9]


def test_perfect_draft_commits_k_plus_one_per_round(models):
    """Draft == target: every draft verifies, so each round commits k+1
    tokens (the prefill's first token counts toward the 12)."""
    k, steps = 3, 12
    eng = DecodeEngine(models["params"], models["cfg"], max_seqs=2,
                       max_seq_len=512, page_size=PAGE,
                       cache_dtype=torch.float32, device="cpu", spec_tokens=k,
                       draft_params=models["params"], draft_cfg=models["cfg"])
    (req,) = eng.run([[5, 17, 100]], max_new_tokens=steps)
    assert len(req.generated) == steps
    assert eng.acceptance_rate == 1.0
    assert eng.stats["spec_rounds"] == -(-(steps - 1) // (k + 1))


def test_exact_fit_request_is_rejected(models):
    """Rounds write up to k rejected positions past the final length, so a
    request that exactly fills max_seq_len is refused at submit."""
    eng = _engine(models)
    with pytest.raises(ValueError, match="speculative"):
        eng.submit([1] * 64, max_new_tokens=512 - 64)
    assert eng.submit([1] * 64, max_new_tokens=512 - 64 - 3).slot is not None


def test_stop_sequence_mid_chunk_truncates_the_round(models, jax_greedy):
    base = jax_greedy["stop"]
    seen = []
    eng = _engine(models)
    (req,) = eng.run(PROMPTS[:1], max_new_tokens=8, stop=[base[1:3]],
                     on_token=seen.append)
    assert req.done and req.generated == base[:3] == seen
    assert eng.allocator.available == eng.num_pages - 1


@pytest.mark.parametrize("kw", [dict(temperature=0.8),
                                dict(temperature=0.8, top_k=10),
                                dict(temperature=0.8, top_p=0.9)])
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "lookup"])
def test_sampled_speculation_generates_with_logprobs(models, kw, draft):
    eng = _engine(models, draft=draft, logprobs=True, seed=3, **kw)
    reqs = eng.run([LOOKUP_PROMPT[:8], [7, 3]], max_new_tokens=8)
    for r in reqs:
        assert r.done and len(r.generated) == len(r.logprobs) == 8
        assert all(0 <= t < 256 for t in r.generated)
        assert all(np.isfinite(lp) and lp <= 0.0 for lp in r.logprobs)
    assert eng.stats["spec_rounds"] > 0
    assert eng.allocator.available == eng.num_pages - 1


def test_sampled_perfect_draft_accepts_everything(models):
    """Draft == target under top-k warping: pd == pt, so every draft is
    accepted."""
    eng = DecodeEngine(models["params"], models["cfg"], max_seqs=1,
                       max_seq_len=512, page_size=PAGE,
                       cache_dtype=torch.float32, device="cpu", spec_tokens=3,
                       draft_params=models["params"], draft_cfg=models["cfg"],
                       temperature=0.8, top_k=4)
    eng.run([[5, 17, 100]], max_new_tokens=8)
    assert eng.acceptance_rate == 1.0


def test_speculative_accept_first_token_follows_the_target():
    """First emitted token over many trials ~ pt_0, however far the draft
    distribution is from the target, in both packages (each with its own
    random numbers)."""
    v, k, n = 5, 2, 40_000
    pt0 = np.array([0.05, 0.40, 0.25, 0.20, 0.10], np.float32)
    ptk = np.full(5, 0.20, np.float32)
    pd0 = np.array([0.50, 0.10, 0.10, 0.10, 0.20], np.float32)  # deliberately bad
    pt = np.broadcast_to(np.stack([pt0, ptk, ptk]), (n, k + 1, v)).copy()
    pd = np.broadcast_to(np.stack([pd0, ptk]), (n, k, v)).copy()
    rng = np.random.default_rng(0)
    drafts = np.stack([rng.choice(v, n, p=pd[0, i]) for i in range(k)],
                      axis=1).astype(np.int32)
    gen = torch.Generator().manual_seed(0)
    m, final = sampling.speculative_accept(
        torch.from_numpy(pt), torch.from_numpy(drafts), torch.from_numpy(pd), gen)
    assert m.dtype == final.dtype == torch.int32 and m.shape == (n,)
    m_j, final_j = jax_sampling.speculative_accept(
        jnp.asarray(pt), jnp.asarray(drafts), jnp.asarray(pd),
        jax.random.PRNGKey(0))
    for mm, ff in ((m.numpy(), final.numpy()), (np.asarray(m_j), np.asarray(final_j))):
        first = np.where(mm >= 1, drafts[:, 0], ff)
        np.testing.assert_allclose(np.bincount(first, minlength=v) / n, pt0,
                                   atol=0.02)
        # Both the acceptance and the rejection path fired.
        assert 0.05 < (mm >= 1).mean() < 0.95


def test_speculative_accept_all_accepted_draws_the_bonus_from_pt_k():
    """pd == pt accepts every draft; the bonus token then follows pt_k."""
    n, v = 20_000, 4
    ptk = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    pt = np.broadcast_to(np.stack([ptk, ptk]), (n, 2, v)).copy()
    drafts = np.zeros((n, 1), np.int64)
    gen = torch.Generator().manual_seed(1)
    m, final = sampling.speculative_accept(
        torch.from_numpy(pt), torch.from_numpy(drafts),
        torch.from_numpy(pt[:, :1].copy()), gen)
    assert (m == 1).all()
    np.testing.assert_allclose(np.bincount(final.numpy(), minlength=v) / n, ptk,
                               atol=0.02)


def test_bad_speculation_configs_raise(models):
    base = dict(max_seqs=1, max_seq_len=256, page_size=PAGE, device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        DecodeEngine(models["params"], models["cfg"], spec_tokens=2, **base)
    with pytest.raises(ValueError, match="no draft model"):
        DecodeEngine(models["params"], models["cfg"], spec_tokens=2,
                     spec_mode="prompt_lookup", draft_params=models["draft"],
                     draft_cfg=models["draft_cfg"], **base)
    with pytest.raises(ValueError, match="spec_mode"):
        DecodeEngine(models["params"], models["cfg"], spec_tokens=2,
                     spec_mode="banana", **base)
    with pytest.raises(ValueError, match="vocab"):
        DecodeEngine(models["params"], models["cfg"], spec_tokens=2,
                     draft_params=models["draft"],
                     draft_cfg=dataclasses.replace(models["draft_cfg"],
                                                   vocab_size=512), **base)


def test_acceptance_rate_is_none_without_speculation(models):
    eng = DecodeEngine(models["params"], models["cfg"], max_seqs=1,
                       max_seq_len=512, device="cpu")
    eng.run([[5, 17, 100]], max_new_tokens=4)
    assert eng.acceptance_rate is None and eng.stats["spec_rounds"] == 0
