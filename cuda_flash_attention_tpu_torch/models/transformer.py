"""GQA decoder-only transformer: config, parameters, the causal forward,
the loss and the SGD-momentum train step.

Counterpart of cuda_flash_attention_tpu/models/transformer.py: the same
parameter tree (a dict with "embed", "layers" (a list of dicts),
"final_norm" and "lm_head"; weights are [in, out] and used as x @ W), the
same RMSNorm, half-rotation RoPE and SwiGLU.  Attention runs the FA2 kernels
(forward B1; backward B2, or B3 + B4) through the differentiable
`flash_attention`.  Mixture-of-experts layers (n_experts > 0: every
moe_every-th layer's feed-forward) run models/moe.py.  Remat "full" is
torch.utils.checkpoint around each layer; "dots" the same with a selective
policy that keeps the products without batch dimensions (JAX's
checkpoint_dots_with_no_batch_dims).  value_and_grad differentiates every
floating-point array of the tree, a QuantizedTensor's scales (and fp8
values) included; integer arrays get zero gradients, as JAX's allow_int.

With a mesh (parallel/mesh.py) the same functions run this rank's part of
a data x model x context x expert-parallel step, and the collectives that GSPMD
inserts for the JAX package are explicit (parallel/collectives.py): the
projections into the heads and the feed-forward's columns take their
input through `copy_to` (identity; the gradient all-reduced over "model"),
the output and down projections' partial sums through `reduce_from`
(all-reduce over "model"; identity backward), attention goes to the ring
(ctx > 1) or to the local heads, RoPE takes the span's global positions,
an MoE layer splits its experts over "expert" and "model" (models/moe.py),
and the loss is the token mean over data x ctx.  shard_params and
gather_params move a tree between its full form and a rank's blocks.
models/pipeline.py runs the layers as stages over "pipe".
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.kernels.attention import flash_attention
from cuda_flash_attention_tpu_torch.models.moe import (
    init_moe_layer,
    moe_ffn,
    moe_layer_shardings,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_reduce_coalesced,
    copy_to,
    gather_from,
    local_slice,
    reduce_from,
)
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    CTX_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
)
from cuda_flash_attention_tpu_torch.parallel.ring import ring_attention
from cuda_flash_attention_tpu_torch.parallel.sharded import (
    head_parallel_attention,
    shard,
)
from cuda_flash_attention_tpu_torch.quant.linear import dense
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32768
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 4096
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16        # activation dtype
    param_dtype: torch.dtype = torch.float32
    attn_tile_dtype: torch.dtype | None = torch.bfloat16  # kernel tile precision
    # Mixture of experts (models/moe.py): n_experts 0 keeps every layer's
    # dense SwiGLU; n_experts > 0 replaces the feed-forward of every
    # moe_every-th layer (the odd layers at moe_every 2).
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2
    router_aux_coef: float = 0.01
    # Sliding-window attention: attn_window None keeps every layer global;
    # attn_window=W restricts each query to the last W keys, and
    # global_every > 0 keeps every global_every-th layer global.  With a
    # window, attn_sinks keeps the first keys attendable too (StreamingLLM).
    # They run in every kernel of the path, forward and backward.
    attn_window: int | None = None
    global_every: int = 0
    attn_sinks: int = 0
    # Long-context RoPE extension: "none", "linear" or "ntk".
    rope_scaling: str = "none"
    rope_scale_factor: float = 1.0
    # Rematerialization of each layer under autograd: "none" keeps every
    # activation; "full" recomputes the whole layer (the attention forward
    # included) in the backward; "dots" keeps the outputs of the products
    # without batch dimensions (every dense projection, the router) and
    # recomputes the rest (attention, norms, RoPE, SwiGLU, the experts'
    # batched products).
    remat: str = "none"

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of n_kv_heads "
                f"({self.n_kv_heads})"
            )

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i % self.moe_every == self.moe_every - 1

    @property
    def rope_args(self) -> tuple[float, float]:
        """(effective theta, position divisor) under the configured scaling."""
        if self.rope_scaling == "none" or self.rope_scale_factor == 1.0:
            return (self.rope_theta, 1.0)
        if self.rope_scaling == "linear":
            return (self.rope_theta, float(self.rope_scale_factor))
        if self.rope_scaling == "ntk":
            d = self.head_dim
            theta = self.rope_theta * self.rope_scale_factor ** (d / (d - 2))
            return (float(theta), 1.0)
        raise ValueError(f"unknown rope_scaling {self.rope_scaling!r}")

    def layer_window(self, i: int) -> int | None:
        """Sliding window for layer i, or None when the layer is global."""
        if self.attn_window is None:
            return None
        if self.global_every > 0 and i % self.global_every == self.global_every - 1:
            return None
        return self.attn_window

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Tiny config for CPU tests."""
        return cls(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, head_dim=64, d_ff=256, **kw)

    @classmethod
    def base(cls, **kw) -> "TransformerConfig":
        """~250M-parameter production-shape config."""
        return cls(vocab_size=32768, d_model=1024, n_layers=12, n_heads=16,
                   n_kv_heads=8, head_dim=64, d_ff=4096, **kw)

    @classmethod
    def tiny_moe(cls, n_experts: int = 4, **kw) -> "TransformerConfig":
        """Tiny MoE config (layer 1 is MoE) for CPU tests."""
        return cls.tiny(n_experts=n_experts, **kw)


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None) -> dict:
    """Random parameters: N(0, 1/in) projections, N(0, 1) embedding, unit
    norm scales.  Drawn from `generator` on its own device (a CPU generator
    gives the same weights for every target device) and moved to `device`
    (None means the card).  The values differ from the JAX init_params,
    whose PRNG differs."""
    gen_device = generator.device
    device = resolve_device(device)

    def normal(shape, scale=None):
        if scale is None:
            scale = shape[0] ** -0.5
        w = torch.randn(shape, generator=generator, device=gen_device) * scale
        return w.to(device=device, dtype=cfg.param_dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=cfg.param_dtype)

    layers = []
    for i in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(cfg.d_model),
            "wq": normal((cfg.d_model, cfg.q_dim)),
            "wk": normal((cfg.d_model, cfg.kv_dim)),
            "wv": normal((cfg.d_model, cfg.kv_dim)),
            "wo": normal((cfg.q_dim, cfg.d_model)),
        }
        if cfg.is_moe_layer(i):
            layer.update(init_moe_layer(generator, cfg, device))
        else:
            layer.update({
                "mlp_norm": ones(cfg.d_model),
                "w_gate": normal((cfg.d_model, cfg.d_ff)),
                "w_up": normal((cfg.d_model, cfg.d_ff)),
                "w_down": normal((cfg.d_ff, cfg.d_model)),
            })
        layers.append(layer)
    return {
        "embed": normal((cfg.vocab_size, cfg.d_model), scale=1.0),
        "layers": layers,
        "final_norm": ones(cfg.d_model),
        "lm_head": normal((cfg.d_model, cfg.vocab_size)),
    }


def rms_norm(x, scale, eps: float = 1e-6):
    """Statistics in fp32; output in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """RoPE's frequencies, computed on the CPU and kept on `device`, so that
    a step captured in a CUDA graph copies nothing from the host."""
    with torch.inference_mode(False):  # a normal tensor, wherever first made
        log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
        return torch.exp(
            -log_theta * torch.arange(0, half, dtype=torch.float32) / half
        ).to(device)


def rope(x, positions, theta: float, pos_scale: float = 1.0):
    """Half-rotation RoPE.  x: [B, S, H, D]; positions: [B, S].  The
    frequencies are exp(-log(theta) * arange / half) in fp32, the same
    expression as the JAX package (a theta ** x form differs in the last
    bits)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(float(theta), half, x.device)
    angles = (positions[..., None].float() / pos_scale) * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def gqa_flash_attention(q, k, v, *, cfg: TransformerConfig,
                        causal: bool = True, window: int | None = None,
                        mesh=None):
    """Grouped-query attention over the FA2 kernels: q [B, Hq, S, D], k/v
    [B, Hkv, S, D]; query head h reads KV head h // (Hq // Hkv) inside the
    kernel (no repeated KV).  With a mesh, q/k/v are this rank's blocks and
    the call routes as the JAX function does: a ctx axis of size > 1 to
    ring attention (the global window decomposed into a windowed diagonal
    step and recency bands, rotations behind it skipped), otherwise to
    head-parallel attention on the local heads (a mesh whose model axis
    does not divide Hkv gets repeated KV from attention_block)."""
    sinks = cfg.attn_sinks if window is not None else 0
    tile = cfg.attn_tile_dtype
    if mesh is None:
        return flash_attention(q, k, v, causal=causal, tile_dtype=tile,
                               window=window, sinks=sinks)
    if mesh.size(CTX_AXIS) > 1:
        if sinks:
            raise NotImplementedError(
                "attention sinks + context parallelism: the sink shard's "
                "position in the ring varies per device (non-static) — use "
                "a mesh without a ctx axis for sink layers")
        return ring_attention(mesh, q, k, v, causal=causal, tile_dtype=tile,
                              window=window)
    return head_parallel_attention(mesh, q, k, v, causal=causal,
                                   tile_dtype=tile, window=window, sinks=sinks)


def _kv_heads(h, w, cfg: TransformerConfig, mesh):
    """K or V [B, S, heads, D] for this rank's query heads: its own KV heads
    where the model axis divides Hkv; otherwise every KV head (the column
    blocks gathered over "model") repeated to the query heads, this rank's
    query heads kept (JAX's repeated-KV branch)."""
    b, s, _ = h.shape
    y = dense(h, w)
    tp = 1 if mesh is None else mesh.size(MODEL_AXIS)
    if cfg.n_kv_heads % tp == 0:
        return y.reshape(b, s, -1, cfg.head_dim)
    y = gather_from(y, mesh, MODEL_AXIS, 2).reshape(b, s, cfg.n_kv_heads,
                                                   cfg.head_dim)
    y = y.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)
    return local_slice(y, mesh, MODEL_AXIS, 2)


def attention_block(x, layer, positions, cfg: TransformerConfig,
                    window: int | None = None, mesh=None):
    """Residual attention sub-layer.  Returns (x, (k, v)) with k/v post-RoPE
    [B, S, Hkv, D], which is what a KV cache stores.  With a mesh the
    projections are this rank's column blocks (heads over "model"), the
    output projection its row block, and its partial sums are all-reduced
    over "model"."""
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"])
    if mesh is not None:
        h = copy_to(h, mesh, MODEL_AXIS)
    q = dense(h, layer["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = _kv_heads(h, layer["wk"], cfg, mesh)
    v = _kv_heads(h, layer["wv"], cfg, mesh)
    q = rope(q, positions, *cfg.rope_args)
    k = rope(k, positions, *cfg.rope_args)
    o = gqa_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), cfg=cfg, causal=True,
                            window=window, mesh=mesh)
    o = dense(o.transpose(1, 2).reshape(b, s, -1), layer["wo"])
    if mesh is not None:
        o = reduce_from(o, mesh, MODEL_AXIS)
    return x + o, (k, v)


def ffn_block(x, layer, cfg: TransformerConfig, mesh=None):
    """Residual FFN: dense SwiGLU, or MoE where the layer carries a router.
    Returns (x, aux): the router's load-balance loss, 0.0 for a dense
    layer.  With a mesh, gate and up are this rank's column blocks over
    "model", down its row block, and its partial sums are all-reduced; an
    MoE layer runs models/moe.py's expert-parallel form."""
    h = rms_norm(x, layer["mlp_norm"])
    if "router" in layer:
        y, aux = (moe_ffn(h, layer, cfg) if mesh is None
                  else moe_ffn(h, layer, cfg, mesh=mesh))
        return x + y, aux
    if mesh is not None:
        h = copy_to(h, mesh, MODEL_AXIS)
    gate = F.silu(dense(h, layer["w_gate"]))
    up = dense(h, layer["w_up"])
    y = dense(gate * up, layer["w_down"])
    if mesh is not None:
        y = reduce_from(y, mesh, MODEL_AXIS)
    return x + y.to(x.dtype), 0.0


def _layer(x, layer, positions, cfg: TransformerConfig, window, mesh=None):
    x, _ = attention_block(x, layer, positions, cfg, window=window, mesh=mesh)
    return ffn_block(x, layer, cfg, mesh)


# The products remat "dots" keeps: those without batch dimensions (a
# [..., d] activation times a 2-D weight goes to mm).  bmm (the experts'
# batched products), the attention kernels and everything elementwise are
# recomputed.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _apply_layer(x, layer, positions, cfg: TransformerConfig, window, mesh):
    """_layer under cfg.remat while autograd records (the pipeline's
    stages run their layers through it too)."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return checkpoint(_layer, x, layer, positions, cfg, window, mesh,
                          use_reentrant=False)
    if cfg.remat == "dots" and torch.is_grad_enabled():
        return checkpoint(_layer, x, layer, positions, cfg, window, mesh,
                          use_reentrant=False, context_fn=_dots_context)
    return _layer(x, layer, positions, cfg, window, mesh)


def _check_remat(cfg: TransformerConfig) -> None:
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _local_tokens(tokens, mesh):
    """This rank's block of global tokens [B, S]: rows over data, the span
    over ctx, with its positions (the span's first global position on)."""
    b, s = tokens.shape
    for axis, dim, n in ((DATA_AXIS, 0, b), (CTX_AXIS, 1, s)):
        if n % mesh.size(axis):
            raise ValueError(
                f"tokens {tuple(tokens.shape)} on the mesh {mesh.shape}: "
                f"the sharding over {axis!r} implies that the global size of "
                f"dimension {dim} should be divisible by {mesh.size(axis)}, "
                f"but it is equal to {n}")
    local = shard(tokens, mesh, (DATA_AXIS, CTX_AXIS))
    span = local.shape[1]
    start = mesh.index(CTX_AXIS) * span
    positions = torch.arange(start, start + span, device=tokens.device)
    return local, positions.expand(local.shape[0], span)


def _forward(params, tokens, positions, cfg: TransformerConfig, mesh):
    """(logits fp32, aux) of local tokens at `positions`; with a mesh the
    logits are this rank's vocab block."""
    _check_remat(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    aux_total = 0.0
    for i, layer in enumerate(params["layers"]):
        x, aux = _apply_layer(x, layer, positions, cfg, cfg.layer_window(i), mesh)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"])
    if mesh is not None:
        x = copy_to(x, mesh, MODEL_AXIS)
    return dense(x, params["lm_head"]).float(), aux_total


def forward(params, tokens, cfg: TransformerConfig, return_aux: bool = False,
            mesh=None):
    """Causal LM forward: tokens [B, S] int -> logits [B, S, vocab] fp32.
    With return_aux=True returns (logits, aux), aux being the summed router
    loss of the mixture-of-experts layers (0.0 for a dense model).

    With a mesh, `params` are this rank's blocks (shard_params) and
    `tokens` the global batch, the same on every rank (as a JAX program
    sees the global array); the logits returned are this rank's block of
    the global logits: its rows over "data", its span over "ctx" (RoPE at
    the span's global positions) and its vocab columns over "model"."""
    if mesh is None:
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    else:
        tokens, positions = _local_tokens(tokens, mesh)
    logits, aux = _forward(params, tokens, positions, cfg, mesh)
    return (logits, aux) if return_aux else logits


def _vocab_parallel_ce(logits, targets, mesh):
    """(logsumexp, target logit) of logits split by vocab columns over
    "model": the max and the sum of exponentials reduced over the axis, the
    target's logit from the rank that holds its column."""
    m = all_reduce(logits.detach().amax(dim=-1), mesh, MODEL_AXIS,
                   op=dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), mesh,
                         MODEL_AXIS)
    lse = m + torch.log(sumexp)
    v_local = logits.shape[-1]
    local = targets - mesh.index(MODEL_AXIS) * v_local
    mine = (local >= 0) & (local < v_local)
    picked = torch.gather(logits, -1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    return lse, reduce_from(torch.where(mine, picked, 0.0), mesh, MODEL_AXIS)


def loss_fn(params, tokens, cfg: TransformerConfig, mesh=None):
    """Next-token cross entropy (tokens [B, S + 1] serve as both input and
    target), in the fused form logsumexp(logits) - logits[target], which
    reduces straight off the logits instead of materialising log-softmax,
    plus router_aux_coef times the router loss where the model has
    experts.

    With a mesh (params this rank's blocks, tokens the global batch on
    every rank) the tokens shift before the split, each rank takes its
    block of the inputs and targets, the logsumexp and target logit reduce
    over "model" (the vocab split) and the loss is the token mean over data
    x ctx: the global loss on every rank, whose gradient on each rank is
    that of its own tokens' share (value_and_grad sums them)."""
    if mesh is None:
        logits, aux = forward(params, tokens[:, :-1], cfg, return_aux=True)
        targets = tokens[:, 1:]
        lse = torch.logsumexp(logits, dim=-1)
        target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
        loss = torch.mean(lse - target_logit)
        if cfg.n_experts:
            loss = loss + cfg.router_aux_coef * aux
        return loss
    inputs, positions = _local_tokens(tokens[:, :-1], mesh)
    targets, _ = _local_tokens(tokens[:, 1:], mesh)
    logits, aux = _forward(params, inputs, positions, cfg, mesh)
    if mesh.size(MODEL_AXIS) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        lse, target_logit = _vocab_parallel_ce(logits, targets, mesh)
    ranks = mesh.size(DATA_AXIS) * mesh.size(CTX_AXIS)
    loss = torch.mean(lse - target_logit) / ranks
    if cfg.n_experts:
        # Every rank routed the whole batch: each carries 1/ranks of it.
        loss = loss + cfg.router_aux_coef * aux / ranks
    return reduce_from(loss, mesh, DATA_AXIS, CTX_AXIS)


def param_split_dims(cfg: TransformerConfig, mesh=None) -> dict:
    """The tree of parameters with, at each leaf, the mesh axis that splits
    each of its dims (None: not split), as JAX's param_shardings places
    them: wq, wk, wv, w_gate, w_up and lm_head by columns over "model", wo
    and w_down by rows; an MoE layer's experts over "expert" and their d_ff
    over "model" where `mesh`'s sizes divide them (moe_layer_shardings);
    norms, the embedding and the router replicated."""
    col, row = (None, MODEL_AXIS), (MODEL_AXIS, None)
    attn = {"attn_norm": (None,), "wq": col, "wk": col, "wv": col, "wo": row}
    dense_mlp = {"mlp_norm": (None,), "w_gate": col, "w_up": col, "w_down": row}
    moe = moe_layer_shardings(mesh, cfg)
    layers = [{**attn, **(moe if cfg.is_moe_layer(i) else dense_mlp)}
              for i in range(cfg.n_layers)]
    return {"embed": (None, None), "layers": layers, "final_norm": (None,),
            "lm_head": col}


def _split_axes(spec, mesh) -> list:
    """(dim, axis) of each split of a leaf's spec that the mesh makes."""
    return [(dim, axis) for dim, axis in enumerate(spec)
            if axis is not None and mesh.size(axis) > 1]


def _split(x, spec, mesh):
    """This rank's block of x (a tensor or numpy array) under `spec`."""
    for dim, axis in _split_axes(spec, mesh):
        if isinstance(x, QuantizedTensor):
            raise NotImplementedError(f"quantized weights on a {axis} axis "
                                      "are not ported")
        n, size = x.shape[dim], mesh.size(axis)
        if n % size:
            raise ValueError(
                f"a weight of shape {tuple(x.shape)} split over {axis!r}: the "
                f"global size of its dimension {dim} should be divisible by "
                f"{size}, but it is equal to {n}")
        step = n // size
        lo = mesh.index(axis) * step
        x = x[(slice(None),) * dim + (slice(lo, lo + step),)]
    return x


def shard_params(params, mesh, cfg: TransformerConfig):
    """This rank's blocks of a full parameter tree under `param_split_dims`
    (copies, contiguous; numpy arrays are sliced the same way)."""
    def take(x, spec):
        y = _split(x, spec, mesh)
        return y.contiguous() if isinstance(y, torch.Tensor) and y is not x else y

    return tree_map(take, params, param_split_dims(cfg, mesh))


def gather_params(params, mesh, cfg: TransformerConfig):
    """The full parameter tree from every rank's blocks (the inverse of
    shard_params)."""
    def whole(x, spec):
        for dim, axis in _split_axes(spec, mesh):
            x = all_gather(x, mesh, axis, dim)
        return x

    return tree_map(whole, params, param_split_dims(cfg, mesh))


def tree_map(fn, tree, *rest):
    """fn over the leaves of a parameter tree (dicts, lists, tensors) and
    of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def array_map(fn, tree, *rest):
    """fn over the arrays of a parameter tree as the JAX pytree flattens
    it: a QuantizedTensor is a node of (values, scales), a LoRATensor of
    (base, a, b); the result keeps the classes and their metadata."""
    from cuda_flash_attention_tpu_torch.models.lora import LoRATensor

    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(
            tree, values=array_map(fn, tree.values, *(r.values for r in rest)),
            scales=array_map(fn, tree.scales, *(r.scales for r in rest)))
    if isinstance(tree, LoRATensor):
        return dataclasses.replace(
            tree, base=array_map(fn, tree.base, *(r.base for r in rest)),
            a=array_map(fn, tree.a, *(r.a for r in rest)),
            b=array_map(fn, tree.b, *(r.b for r in rest)))
    if isinstance(tree, dict):
        return {k: array_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [array_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def array_leaves(tree) -> list:
    out = []
    array_map(out.append, tree)
    return out


def value_and_grad(params, tokens, cfg: TransformerConfig, mesh=None):
    """(loss, grads): grads is a tree like params (array_map's), each array
    in its parameter's dtype.  Floating-point arrays are differentiated (a
    QuantizedTensor's fp32 scales, an fp8 weight's values); integer arrays
    (int8 and packed int4 values) get zeros, as JAX's allow_int gives them
    float0 tangents that the JAX step replaces with zeros.  With a mesh
    (loss_fn's) each rank's gradients are summed over data and ctx, so
    every rank holds the gradient of its own parameter blocks."""
    with torch.enable_grad():
        arrays = array_leaves(params)
        wrt = [p.detach().requires_grad_(True) for p in arrays if p.is_floating_point()]
        it = iter(wrt)
        loss = loss_fn(array_map(lambda p: next(it) if p.is_floating_point() else p,
                                 params), tokens, cfg, mesh)
        grads = torch.autograd.grad(loss, wrt)
    if mesh is not None:
        grads = all_reduce_coalesced(grads, mesh, DATA_AXIS, CTX_AXIS)
    grads = iter(grads)
    return loss.detach(), array_map(
        lambda p: next(grads) if p.is_floating_point() else torch.zeros_like(p), params)


def make_train_step(cfg: TransformerConfig, learning_rate=1e-3, mesh=None):
    """SGD-with-momentum train step (optimizer state = momentum tree):
    step(params, opt_state, tokens) -> (params, opt_state, loss), each tree
    new, as the JAX step returns them.  With a mesh, params and opt_state
    are this rank's blocks and tokens the global batch (loss_fn)."""

    def train_step(params, opt_state, tokens):
        loss, grads = value_and_grad(params, tokens, cfg, mesh)
        new_opt = tree_map(lambda m, g: 0.9 * m + g.float(), opt_state, grads)
        new_params = tree_map(lambda p, m: (p - learning_rate * m).to(p.dtype),
                              params, new_opt)
        return new_params, new_opt, loss

    return train_step


def init_opt_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
