"""Token sampling for the decode engine: greedy, temperature, top-k, top-p,
min-p, and the speculative-sampling acceptance rule.

Counterpart of cuda_flash_attention_tpu/decode/sampling.py.  Randomness
comes from an explicit torch.Generator on the logits' device; it gives other
numbers than a JAX PRNG key of the same seed, so only greedy decoding can
match the JAX engine token for token.  Categorical draws use the Gumbel-max
form, as jax.random.categorical does.
"""

from __future__ import annotations

import torch


def warp_logits(logits, *, temperature: float, top_k: int = 0,
                top_p: float = 1.0, min_p: float = 0.0):
    """Temperature, nucleus, top-k and min-p as support filtering: returns
    logits / temperature with every dropped entry at -inf, so
    softmax(warped) is the sampling distribution.  top_k keeps every token
    tied with the k-th largest logit; min_p keeps tokens whose probability
    is at least min_p * p(top token)."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1]; got {top_p} (use temperature=0 for "
            "greedy decoding)"
        )
    if not 0.0 <= min_p < 1.0:
        raise ValueError(f"min_p must be in [0, 1); got {min_p}")
    # Scalars are made on the logits' device (no host copy: a captured
    # CUDA graph may run this).
    neg_inf = logits.new_full((), float("-inf"))
    logits = logits / temperature
    if min_p > 0.0:
        cutoff = logits.amax(dim=-1, keepdim=True) + torch.log(
            torch.full((), min_p, device=logits.device))
        logits = torch.where(logits >= cutoff, logits, neg_inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens while the mass BEFORE them is < p (always >= 1 token).
        keep_mass = cum - probs < top_p
        cutoff = torch.where(keep_mass, sorted_logits,
                             logits.new_full((), float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, neg_inf)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg_inf)
    return logits


def _categorical(logits, generator: torch.Generator):
    """One draw per row from softmax(logits) by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(u.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_tokens(logits, generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0):
    """One token per row of logits [num_seqs, vocab].  temperature <= 0 is
    greedy (first maximum wins, as jnp.argmax)."""
    if temperature <= 0.0:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1]; got {top_p} (use temperature=0 "
                "for greedy decoding)"
            )
        return torch.argmax(logits, dim=-1).to(torch.int32)
    warped = warp_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p, min_p=min_p)
    return _categorical(warped, generator)


def sample_with_logprob(logits, generator: torch.Generator | None = None, *,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, min_p: float = 0.0):
    """sample_tokens plus the log-probability of each chosen token under the
    distribution it was drawn from (log_softmax of the logits for greedy,
    of the warped logits when sampling)."""
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        lp = torch.log_softmax(logits, dim=-1)
    else:
        warped = warp_logits(logits, temperature=temperature, top_k=top_k,
                             top_p=top_p, min_p=min_p)
        tok = _categorical(warped, generator)
        lp = torch.log_softmax(warped, dim=-1)
    return tok, lp.gather(-1, tok[:, None].long())[:, 0]


def speculative_accept(pt, drafts, draft_probs, generator: torch.Generator):
    """Speculative-sampling acceptance (Leviathan et al.; Chen et al.):
    accept draft d_i with probability min(1, pt_i(d_i) / pd_i(d_i)); at the
    first rejection draw from the residual normalize(max(pt - pd, 0)); if
    all k drafts survive, draw the bonus token from pt_k.  The emitted
    stream is distributed exactly as target-only sampling.

    pt [n, k+1, V] target probabilities at chunk positions 0..k; drafts
    [n, k]; draft_probs [n, k, V] the distributions the drafts were drawn
    from.  The uniforms and the final draw (Gumbel-max, as `_categorical`)
    come from `generator`.  Returns (m [n] int32, the accepted draft count;
    final [n] int32, the correction or bonus token after them)."""
    n, k = drafts.shape
    idx = drafts.long()[..., None]
    pt_d = pt[:, :k].gather(-1, idx)[..., 0]          # target prob of each draft
    pd_d = draft_probs.gather(-1, idx)[..., 0]
    u = torch.rand((n, k), generator=generator, device=pt.device)
    # accept_i <=> u < pt / pd (pd == 0 cannot occur for a drawn token; then
    # accept iff pt > 0).
    accept = u * pd_d.clamp_min(1e-38) < pt_d
    m = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # leading accepts
    # The final token's distribution: the residual at the first rejection,
    # or pt_k when all were accepted (a zero pd row at index k covers both).
    pd_pad = torch.cat([draft_probs, torch.zeros_like(pt[:, :1])], dim=1)
    rows = torch.arange(n, device=pt.device)
    pt_m, pd_m = pt[rows, m], pd_pad[rows, m]
    residual = (pt_m - pd_m).clamp_min(0.0)
    norm = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(norm > 0.0, residual, pt_m)  # pt == pd exactly
    final = _categorical(torch.log(residual.clamp_min(1e-38)), generator)
    return m.to(torch.int32), final
