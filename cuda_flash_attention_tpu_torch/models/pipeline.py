"""Pipeline parallelism (PP): GPipe microbatching over the "pipe" mesh axis.

Counterpart of cuda_flash_attention_tpu/models/pipeline.py.  The layers are
stacked into [n_stages, layers_per_stage, ...] leaves (stack_pipeline_params)
and each rank of the "pipe" axis holds one contiguous stage; with a "model"
axis too, the stage weights split Megatron-style (QKV, gate and up by
columns, O and down by rows) and the stage runs head-parallel (PP x TP).

JAX scans T = n_micro + n_stages - 1 ticks inside a shard_map and shifts the
activations one stage down the line with a truncated ppermute after every
tick; jax.grad turns that into the reversed-schedule backward pipeline.
PyTorch's autograd does not differentiate through a send, so the port runs
the two schedules explicitly, each rank as one stage:
  * forward ticks: on tick t a stage runs microbatch t - stage through its
    layers (transformer._apply_layer: the unsharded model's layer code, so
    windows, remat and the attention kernels come along) and sends the
    output to the next stage (collectives.Shift), keeping each microbatch's
    stage input and output;
  * backward ticks, in reverse order: the stage calls torch.autograd.backward
    on the kept output with the gradient the next stage sent (the last
    stage: the loss's), plus the router aux loss's coefficient, and sends
    its input's gradient to the stage before.
A stage computes only on its live ticks, and sends and receives only where
the neighbour is live on the matching tick; JAX computes every tick and
masks the fill and drain ticks, which gives the same values.  Stage 0
embeds the tokens and the last stage computes the final norm, the head and
the NLL, holding those weights alone (shard_pipeline_params); JAX computes
them on every stage and masks them, so their gradients are nonzero only
there and the updates are the same.  The last stage reduces each
microbatch's logits to the per-token NLL as soon as they exist, and its
head's backward runs then, so no more than one microbatch's [.., vocab]
logits is alive.  The NLL and the aux loss are summed over "pipe", so
every rank returns them, as JAX's psum replicates them.

As in JAX, PP forwards all S tokens of each row (loss_fn forwards S - 1)
and the NLL's last column is zero; MoE stages route each microbatch on its
own, their layers unsharded within the stage; the step is SGD with
momentum 0.9.
"""

from __future__ import annotations

import torch

from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    _apply_layer,
    _check_remat,
    _split,
    rms_norm,
    tree_leaves,
    tree_map,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import Shift, all_reduce
from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS, PIPE_AXIS
from cuda_flash_attention_tpu_torch.quant.linear import dense


def stack_pipeline_params(params, n_stages: int) -> dict:
    """A full parameter tree rearranged for PP: the per-layer dicts stacked
    into [n_stages, layers_per_stage, ...] leaves under "stages" (the layers
    must be homogeneous: n_experts 0 or moe_every 1, so that every layer has
    the same keys)."""
    layers = params["layers"]
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    if any(set(layer) != set(layers[0]) for layer in layers):
        raise ValueError(
            "pipeline stages need homogeneous layers (same param keys); "
            "use moe_every=1 or n_experts=0")
    per = n_layers // n_stages
    stages = {k: torch.stack([layer[k] for layer in layers]).reshape(
        n_stages, per, *layers[0][k].shape) for k in layers[0]}
    return {"embed": params["embed"], "stages": stages,
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


# Which trailing dim of a stacked stage weight the "model" axis splits
# (transformer.param_split_dims' columns and rows).
_STAGE_TP_DIM = {
    "wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1,
    "wo": -2, "w_down": -2,
}


def _stage_spec(key: str, ndim: int, model) -> tuple:
    spec = [PIPE_AXIS] + [None] * (ndim - 1)
    if model is not None and key in _STAGE_TP_DIM:
        spec[_STAGE_TP_DIM[key] + ndim] = model
    return tuple(spec)


def pipeline_param_shardings(mesh, pp_params) -> dict:
    """The axis that splits each dim of each leaf of a stacked tree (None:
    not split), as JAX's NamedShardings place them: the stage dim over
    "pipe"; with a "model" axis, the stage weights' columns or rows over it
    (PP x TP); the embedding, the final norm and the head replicated (the
    port keeps them on their one stage: shard_pipeline_params)."""
    model = MODEL_AXIS if MODEL_AXIS in mesh.axis_names else None

    def rep(x):
        return (None,) * x.ndim

    return {"embed": rep(pp_params["embed"]),
            "stages": {k: _stage_spec(k, v.ndim, model)
                       for k, v in pp_params["stages"].items()},
            "final_norm": rep(pp_params["final_norm"]),
            "lm_head": rep(pp_params["lm_head"])}


def shard_pipeline_params(pp_params, mesh) -> dict:
    """This rank's stage of a stacked tree (tensors or numpy arrays): its
    layers as the port's per-layer list, cut to its blocks over "model",
    with "embed" on stage 0 and "final_norm" and "lm_head" on the last
    stage only."""
    specs = pipeline_param_shardings(mesh, pp_params)
    me, n = mesh.index(PIPE_AXIS), mesh.size(PIPE_AXIS)
    blocks = {k: _split(v[me], specs["stages"][k][1:], mesh)
              for k, v in pp_params["stages"].items()}
    per = next(iter(blocks.values())).shape[0]
    out = {"layers": [{k: v[i] for k, v in blocks.items()} for i in range(per)]}
    if me == 0:
        out["embed"] = pp_params["embed"]
    if me == n - 1:
        out["final_norm"] = pp_params["final_norm"]
        out["lm_head"] = pp_params["lm_head"]
    return out


def _check(cfg: TransformerConfig, mesh, n_stages: int) -> None:
    """JAX's refusals of make_pipeline_nll."""
    if mesh.size(PIPE_AXIS) != n_stages:
        raise ValueError(f"mesh pipe axis {mesh.size(PIPE_AXIS)} != n_stages {n_stages}")
    if cfg.attn_window is not None and cfg.global_every > 0:
        raise NotImplementedError(
            "PP scans homogeneous stacked layers; the local/global "
            "interleave (global_every > 0) is not expressible there — "
            "use a uniform attn_window under PP")
    for axis in mesh.axis_names:
        if axis not in (PIPE_AXIS, MODEL_AXIS) and mesh.size(axis) > 1:
            raise NotImplementedError(
                f"PP runs over '{PIPE_AXIS}' and '{MODEL_AXIS}'; a '{axis}' "
                f"axis of size {mesh.size(axis)} would only repeat every stage")
    tp = mesh.size(MODEL_AXIS)
    if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp):
        raise ValueError(
            f"PP x TP needs the model-axis size {tp} to divide n_heads "
            f"({cfg.n_heads}), n_kv_heads ({cfg.n_kv_heads}) and d_ff "
            f"({cfg.d_ff})")
    _check_remat(cfg)


def _run(stage, tokens, cfg: TransformerConfig, mesh, n_micro: int,
         backward: bool):
    """The GPipe schedule on this rank's stage (the module's note): returns
    (nll [n_micro, mb, S] fp32, aux) summed over "pipe", so the same on
    every rank; with `backward`, the gradient of mean NLL + coef * aux /
    n_micro accumulates in the .grad of the stage's leaves."""
    b, s = tokens.shape
    tp = mesh.size(MODEL_AXIS)
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
    if tp > 1 and "router" in stage["layers"][0]:
        raise ValueError(
            "PP x TP supports dense stages only; MoE layers compose "
            "with EP (models/moe.py), not the model axis")
    n, me = mesh.size(PIPE_AXIS), mesh.index(PIPE_AXIS)
    layer_mesh = mesh if tp > 1 else None
    mb = b // n_micro
    micro = tokens.reshape(n_micro, mb, s)
    device = stage["layers"][0]["attn_norm"].device
    positions = torch.arange(s, device=device).expand(mb, s)
    first_layer = me * len(stage["layers"])
    aux_grad = cfg.router_aux_coef / n_micro
    nll = torch.zeros(n_micro, mb, s, dtype=torch.float32, device=device)
    aux_total = torch.zeros((), dtype=torch.float32, device=device)
    like = torch.empty(mb, s, cfg.d_model, dtype=cfg.dtype, device=device)
    kept = {}  # microbatch -> (stage input, stage output, aux, output's gradient)

    def live(t):
        return 0 <= t - me < n_micro

    buf = None
    with torch.set_grad_enabled(backward):
        for t in range(n_micro + n - 1):
            if live(t):
                m = t - me
                x = (stage["embed"][micro[m]].to(cfg.dtype) if me == 0
                     else buf.requires_grad_(backward))
                y, aux = x, 0.0
                for i, layer in enumerate(stage["layers"]):
                    y, a = _apply_layer(y, layer, positions, cfg,
                                        cfg.layer_window(first_layer + i), layer_mesh)
                    aux = aux + a
                aux_total = aux_total + aux
                g = _head(y, stage, micro[m], nll[m], n_micro, backward) \
                    if me == n - 1 else None
                kept[m] = (x, y, aux, g)
            buf = Shift([kept[t - me][1] if live(t) else like], mesh, PIPE_AXIS,
                        send=live(t), recv=live(t + 1)).wait()[0].detach()
        if backward:
            buf = None
            for t in reversed(range(n_micro + n - 1)):
                dx = like
                if live(t):
                    x, y, aux, g = kept.pop(t - me)
                    outs, grads = [y], [g if g is not None else buf]
                    if isinstance(aux, torch.Tensor) and aux.requires_grad:
                        outs.append(aux)
                        grads.append(torch.full_like(aux, aux_grad))
                    torch.autograd.backward(outs, grads)
                    dx = x.grad if me > 0 else like
                buf = Shift([dx], mesh, PIPE_AXIS, hops=-1, send=live(t),
                            recv=live(t - 1)).wait()[0]
    nll = all_reduce(nll, mesh, PIPE_AXIS)
    return nll, all_reduce(aux_total.detach(), mesh, PIPE_AXIS)


def _head(y, stage, tok, nll_out, n_micro: int, backward: bool):
    """The last stage's final norm, head and per-token NLL of one
    microbatch, written into nll_out [mb, S] (the last column stays 0).
    With `backward` the head's backward runs at once (the NLL's share of
    the loss) and the gradient of y is returned, so the logits die here."""
    mb, s = tok.shape
    h = y.detach().requires_grad_(backward)
    logits = dense(rms_norm(h, stage["final_norm"]), stage["lm_head"]).float()[:, :-1]
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, tok[:, 1:, None])[..., 0]
    nll = lse - target                                        # [mb, S - 1]
    nll_out[:, :-1] = nll.detach()
    if not backward:
        return None
    (nll.sum() / (n_micro * mb * (s - 1))).backward()
    return h.grad


def make_pipeline_nll(cfg: TransformerConfig, mesh, n_stages: int, n_micro: int):
    """Returns nll(stage_params, tokens [B, S]) -> (per-token next-token NLL
    [n_micro, B / n_micro, S] fp32 (last column zero), the MoE router aux
    loss summed over every layer and microbatch (0 for a dense model)),
    computed by the GPipe schedule over the mesh's "pipe" axis and the same
    on every rank.  `stage_params` is this rank's stage
    (shard_pipeline_params); no gradient is recorded."""
    _check(cfg, mesh, n_stages)

    def nll_fn(stage, tokens):
        return _run(stage, _tokens(stage, tokens), cfg, mesh, n_micro, backward=False)

    return nll_fn


def _tokens(stage, tokens) -> torch.Tensor:
    device = stage["layers"][0]["attn_norm"].device
    return torch.as_tensor(tokens).to(device=device, dtype=torch.long)


def _loss(nll, aux, cfg: TransformerConfig, s: int):
    """mean NLL + coef * aux / n_micro (JAX make_pp_loss_fn's form: under
    microbatching each microbatch adds its own aux, so the batch's term is
    their mean)."""
    mean_nll = nll.sum() / (nll.shape[0] * nll.shape[1] * (s - 1))
    return mean_nll + cfg.router_aux_coef * aux / nll.shape[0]


def make_pp_loss_fn(cfg: TransformerConfig, mesh, n_stages: int, n_micro: int):
    """loss(stage_params, tokens [B, S]): the mean next-token NLL over every
    microbatch plus router_aux_coef * aux / n_micro; it matches loss_fn on
    the same (unstacked) parameters and tokens [B, S]."""
    nll_fn = make_pipeline_nll(cfg, mesh, n_stages, n_micro)

    def loss(stage, tokens):
        nll, aux = nll_fn(stage, tokens)
        return _loss(nll, aux, cfg, nll.shape[-1])

    return loss


def pp_value_and_grad(stage, tokens, cfg: TransformerConfig, mesh, n_micro: int):
    """(loss, grads): the loss on every rank, and the gradient of this
    rank's stage leaves (a tree like `stage`, each in its leaf's dtype)
    from the forward and backward pipelines."""
    tokens = _tokens(stage, tokens)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(stage)]
    it = iter(leaves)
    wrt = tree_map(lambda _: next(it), stage)
    nll, aux = _run(wrt, tokens, cfg, mesh, n_micro, backward=True)
    grads = iter([p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in leaves])
    return _loss(nll, aux, cfg, tokens.shape[1]), tree_map(lambda _: next(grads), stage)


def make_pp_train_step(cfg: TransformerConfig, mesh, n_stages: int,
                       n_micro: int, learning_rate: float = 1e-3):
    """SGD-momentum train step over this rank's stage:
    step(stage_params, opt_state, tokens [B, S]) -> (stage_params,
    opt_state, loss), each tree new; opt_state is the fp32 momentum tree
    (transformer.init_opt_state of the stage), m = 0.9 m + g and p = p -
    lr m in p's dtype, as JAX's step."""
    _check(cfg, mesh, n_stages)

    def step(stage, opt_state, tokens):
        loss, grads = pp_value_and_grad(stage, tokens, cfg, mesh, n_micro)
        new_opt = tree_map(lambda m, g: 0.9 * m + g.float(), opt_state, grads)
        del grads  # not alive beside the new parameters
        new = tree_map(lambda p, m: (p - learning_rate * m).to(p.dtype), stage,
                       new_opt)
        return new, new_opt, loss

    return step
