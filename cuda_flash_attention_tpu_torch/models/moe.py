"""Mixture-of-experts SwiGLU feed-forward on one device: top-k routing with
static per-expert capacity (GShard / Switch).

Counterpart of cuda_flash_attention_tpu/models/moe.py without its mesh
(expert parallelism and `moe_layer_shardings` are not ported):
  * the router is a per-token fp32 softmax over E experts at full
    precision; the top-k gates are renormalised over the k chosen;
  * capacity is static: each expert takes at most C = expert_capacity(N, E,
    k, capacity_factor) of the call's N tokens.  A token's slot in expert e
    is its rank among the tokens routed to e, every first choice ranking
    before any second choice (k-major), and a (token, choice) past C is
    dropped (weight 0 on that expert);
  * tokens scatter into an [E, C, d] buffer (plus one dump row that takes
    the dropped ones and is sliced off), the experts' SwiGLU runs as three
    batched products, and each (token, choice) gathers its row back, summed
    with its gate in the activation dtype;
  * the auxiliary load-balance loss is E * sum_e f_e p_e, f_e the fraction
    of tokens whose top-1 choice is e and p_e the mean router probability.
The products are plain batched matrix products that the JAX package leaves
to XLA, outside any Pallas kernel, so they are torch.bmm here.  Nothing
reads a value on the host: a decode step that routes can be captured in a
CUDA graph.  The capacity couples every token of a call, so two calls with
other rows route differently where the capacity binds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch.kernels.common import round_up


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-expert token capacity: int(N k cf / E) + 1 in Python float
    arithmetic, rounded up to a multiple of 8 and at least 8."""
    c = int(n_tokens * top_k * capacity_factor / n_experts) + 1
    return max(round_up(c, 8), 8)


def init_moe_layer(generator: torch.Generator, cfg, device) -> dict:
    """Parameters of one MoE layer (in place of the dense SwiGLU's): the
    norm scale, the router [d, E] and the experts' gate and up [E, d, f]
    and down [E, f, d], N(0, 1/fan_in), drawn from `generator` on its own
    device and moved to `device`."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * fan_in ** -0.5).to(device=device, dtype=cfg.param_dtype)

    return {
        "mlp_norm": torch.ones(d, device=device, dtype=cfg.param_dtype),
        "router": w((d, e), d),
        "moe_gate": w((e, d, f), d),
        "moe_up": w((e, d, f), d),
        "moe_down": w((e, f, d), f),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[N] -> [N, n] by comparison (no host read, unlike a checked one_hot)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(x: torch.Tensor, layer: dict, cfg):
    """(probs [N, E], gate_vals [N, k], gate_idx [N, k], aux): the fp32
    router, its top-k renormalised, and the Switch loss on the top-1
    choice."""
    e, top_k = cfg.n_experts, cfg.expert_top_k
    logits = x.float() @ layer["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    top1 = _one_hot(gate_idx[:, 0], e, torch.float32)
    aux = e * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    return probs, gate_vals, gate_idx, aux


def _ranks(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """rank [N, k]: a (token, choice)'s order among those routed to its
    expert, the k-th choices after every (k-1)-th (only [N, E] cumsums)."""
    counts = torch.zeros(e, dtype=torch.int64, device=gate_idx.device)
    ranks = []
    for k in range(gate_idx.shape[1]):
        mask = _one_hot(gate_idx[:, k], e, torch.int64)  # [N, E]
        pos = counts[None, :] + torch.cumsum(mask, dim=0) - mask
        ranks.append(torch.sum(pos * mask, dim=1))
        counts = counts + mask.sum(dim=0)
    return torch.stack(ranks, dim=1)


def _expert_ffn(xe: torch.Tensor, layer: dict, cfg) -> torch.Tensor:
    """The experts' SwiGLU on [E, C, d] in cfg.dtype: silu(xe W_gate) *
    (xe W_up), then W_down.  Without autograd the activation is formed in
    place, so the layer holds two [E, C, f] buffers, as JAX's einsums."""
    dt = cfg.dtype
    gate = torch.bmm(xe, layer["moe_gate"].to(dt))
    up = torch.bmm(xe, layer["moe_up"].to(dt))
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        act = F.silu(gate) * up
    else:
        act = F.silu(gate, inplace=True).mul_(up)
    del up
    return torch.bmm(act, layer["moe_down"].to(dt))


def moe_ffn(h: torch.Tensor, layer: dict, cfg):
    """The MoE SwiGLU on pre-normed activations h [..., d_model], by
    scatter and gather: returns (y in h's shape and dtype, aux fp32).
    Gradients reach h through the scatter and the router through the gate
    values only."""
    e, top_k = cfg.n_experts, cfg.expert_top_k
    shape, d = h.shape, h.shape[-1]
    x = h.reshape(-1, d)
    n = x.shape[0]
    cap = expert_capacity(n, e, top_k, cfg.capacity_factor)

    _, gate_vals, gate_idx, aux = _route(x, layer, cfg)
    rank = _ranks(gate_idx, e)                        # [N, k]
    valid = rank < cap
    slot = gate_idx * cap + rank                      # [N, k] in [0, E C)
    slot_eff = torch.where(valid, slot, e * cap)      # dropped: the dump row

    # Slots are unique (ranks enumerate each expert, the k experts of a
    # token differ): the scatter writes each live row once; k-major on both
    # sides.
    x_rep = x.to(cfg.dtype).expand(top_k, n, d).reshape(top_k * n, d)
    xe = torch.zeros(e * cap + 1, d, dtype=cfg.dtype, device=x.device)
    xe = xe.index_copy(0, slot_eff.t().reshape(-1), x_rep)
    out = _expert_ffn(xe[: e * cap].reshape(e, cap, d), layer, cfg)

    rows = out.reshape(e * cap, d)[torch.where(valid, slot, 0)]  # [N, k, d]
    w = (gate_vals * valid.float()).to(cfg.dtype)
    y = torch.sum(rows * w[..., None], dim=1)
    return y.reshape(shape).to(h.dtype), aux


def moe_ffn_onehot(h: torch.Tensor, layer: dict, cfg):
    """The GShard one-hot form ([N, E, C] dispatch and combine): the oracle
    moe_ffn is tested against.  Memory grows as N E C; tests only."""
    e, top_k = cfg.n_experts, cfg.expert_top_k
    shape, d = h.shape, h.shape[-1]
    x = h.reshape(-1, d)
    n = x.shape[0]
    cap = expert_capacity(n, e, top_k, cfg.capacity_factor)

    _, gate_vals, gate_idx, aux = _route(x, layer, cfg)
    combine = torch.zeros(n, e, cap, dtype=torch.float32, device=x.device)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device)
    for k in range(top_k):
        mask = _one_hot(gate_idx[:, k], e, torch.int64)
        pos = counts[None, :] + torch.cumsum(mask, dim=0) - mask
        within = (pos < cap) & (mask > 0)
        slot = F.one_hot(pos.clamp_max(cap - 1), cap).float() * (pos < cap)[..., None]
        combine = combine + (gate_vals[:, k, None, None] * within[..., None].float()
                             * mask[..., None].float() * slot)
        counts = counts + mask.sum(dim=0)
    dispatch = (combine > 0.0).to(cfg.dtype)
    xe = torch.einsum("nec,nd->ecd", dispatch, x.to(cfg.dtype))
    out = _expert_ffn(xe, layer, cfg)
    y = torch.einsum("nec,ecd->nd", combine.to(cfg.dtype), out)
    return y.reshape(shape).to(h.dtype), aux
