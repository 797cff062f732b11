"""Mixture-of-experts SwiGLU feed-forward: top-k routing with static
per-expert capacity (GShard / Switch), on one device or over a mesh's
"expert" and "model" axes (expert parallelism, EP x TP).

Counterpart of cuda_flash_attention_tpu/models/moe.py:
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

On a mesh (`moe_ffn(mesh=)`; JAX's pjit partitions its einsums, here the
collectives are explicit, parallel/collectives.py) every rank gathers the
tokens of the whole batch over "ctx" and "data" and routes them all, so the
capacity couples the tokens one device's call couples and the routing, the
gates and the aux loss are the same computation on every rank.  The experts
are split as `moe_layer_shardings` places them: a rank scatters only the
slots of its own experts (E / ep of them, its input through `copy_to` over
"expert", so that the tokens' gradient sums the experts' parts), runs their
SwiGLU on its d_ff block under "model" (gate and up by columns, down by
rows, its partial sums reduced over "model"), and gathers every expert's
[E / ep, C, d] outputs over "expert" (`gather_replicated`: the combine that
follows is the same on every expert rank, so each rank's gradient for its
own outputs is already whole).  It keeps its own block of the output.
Where ep does not divide E, or tp does not divide d_ff, the experts are
whole on every rank of that axis, as JAX's fallback replicates them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch.kernels.common import round_up
from cuda_flash_attention_tpu_torch.parallel.collectives import (
    copy_to,
    gather_from,
    gather_replicated,
    local_slice,
    reduce_from,
)
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    CTX_AXIS,
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
)


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


def moe_layer_shardings(mesh, cfg) -> dict:
    """The axis that splits each dim of each MoE leaf (None: not split), as
    JAX's moe_layer_shardings places them: the experts' dim 0 over "expert"
    where the mesh has that axis and its size divides n_experts, their d_ff
    over "model" where that axis's size divides d_ff (gate and up by
    columns, down by rows); otherwise the experts are whole on every rank.
    The router and the norm are replicated."""
    def axis(name, n):
        ok = mesh is not None and name in mesh.axis_names and n % mesh.size(name) == 0
        return name if ok else None

    exp, tp = axis(EXPERT_AXIS, cfg.n_experts), axis(MODEL_AXIS, cfg.d_ff)
    return {"mlp_norm": (None,), "router": (None, None),
            "moe_gate": (exp, None, tp), "moe_up": (exp, None, tp),
            "moe_down": (exp, tp, None)}


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


def _expert_ffn(xe: torch.Tensor, layer: dict, cfg, mesh=None,
                tp: bool = False) -> torch.Tensor:
    """The experts' SwiGLU on [E, C, d] in cfg.dtype: silu(xe W_gate) *
    (xe W_up), then W_down.  Without autograd the activation is formed in
    place, so the layer holds two [E, C, f] buffers, as JAX's einsums.
    With `tp` the weights are this rank's d_ff blocks over "model": xe
    enters through copy_to and the partial sums are reduced."""
    dt = cfg.dtype
    if tp:
        xe = copy_to(xe, mesh, MODEL_AXIS)
    gate = torch.bmm(xe, layer["moe_gate"].to(dt))
    up = torch.bmm(xe, layer["moe_up"].to(dt))
    if torch.is_grad_enabled() and (gate.requires_grad or up.requires_grad):
        act = F.silu(gate) * up
    else:
        act = F.silu(gate, inplace=True).mul_(up)
    del up
    y = torch.bmm(act, layer["moe_down"].to(dt))
    return reduce_from(y, mesh, MODEL_AXIS) if tp else y


def moe_ffn(h: torch.Tensor, layer: dict, cfg, mesh=None):
    """The MoE SwiGLU on pre-normed activations h [..., d_model], by
    scatter and gather: returns (y in h's shape and dtype, aux fp32).
    Gradients reach h through the scatter and the router through the gate
    values only.  With a mesh, h is this rank's block (rows over "data",
    span over "ctx") and `layer` its blocks under moe_layer_shardings; y is
    its block of the output (the module's note)."""
    if mesh is None:
        return _moe(h, layer, cfg)
    full = gather_from(gather_from(h, mesh, CTX_AXIS, 1), mesh, DATA_AXIS, 0)
    y, aux = _moe(full, layer, cfg, mesh)
    return local_slice(local_slice(y, mesh, DATA_AXIS, 0), mesh, CTX_AXIS, 1), aux


def _moe(h: torch.Tensor, layer: dict, cfg, mesh=None):
    """moe_ffn on the tokens of the whole call (every rank's, on a mesh)."""
    e, top_k = cfg.n_experts, cfg.expert_top_k
    shape, d = h.shape, h.shape[-1]
    x = h.reshape(-1, d)
    n = x.shape[0]
    cap = expert_capacity(n, e, top_k, cfg.capacity_factor)
    spec = moe_layer_shardings(mesh, cfg)["moe_gate"]
    ep = 1 if spec[0] is None else mesh.size(EXPERT_AXIS)
    tp = spec[2] is not None and mesh.size(MODEL_AXIS) > 1
    e_local = e // ep
    first = 0 if ep == 1 else mesh.index(EXPERT_AXIS) * e_local

    _, gate_vals, gate_idx, aux = _route(x, layer, cfg)
    rank = _ranks(gate_idx, e)                        # [N, k]
    valid = rank < cap
    slot = gate_idx * cap + rank                      # [N, k] in [0, E C)
    # This rank's experts' slots; every other (token, choice), and the
    # dropped ones, to the dump row.
    mine = valid & (gate_idx >= first) & (gate_idx < first + e_local)
    slot_eff = torch.where(mine, slot - first * cap, e_local * cap)

    # Slots are unique (ranks enumerate each expert, the k experts of a
    # token differ): the scatter writes each live row once; k-major on both
    # sides.
    if ep > 1:
        x = copy_to(x, mesh, EXPERT_AXIS)
    x_rep = x.to(cfg.dtype).expand(top_k, n, d).reshape(top_k * n, d)
    xe = torch.zeros(e_local * cap + 1, d, dtype=cfg.dtype, device=x.device)
    xe = xe.index_copy(0, slot_eff.t().reshape(-1), x_rep)
    out = _expert_ffn(xe[: e_local * cap].reshape(e_local, cap, d), layer, cfg,
                      mesh, tp)
    if ep > 1:
        out = gather_replicated(out, mesh, EXPERT_AXIS, 0)

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
