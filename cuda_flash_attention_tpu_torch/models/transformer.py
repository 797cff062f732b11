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
Meshes are not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.kernels.attention import flash_attention
from cuda_flash_attention_tpu_torch.models.moe import init_moe_layer, moe_ffn
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
                        causal: bool = True, window: int | None = None):
    """Grouped-query attention over the FA2 forward kernel: q [B, Hq, S, D],
    k/v [B, Hkv, S, D]; query head h reads KV head h // (Hq // Hkv) inside
    the kernel (no repeated KV).  The single-device branch of the JAX
    function; meshes are not ported yet."""
    sinks = cfg.attn_sinks if window is not None else 0
    return flash_attention(q, k, v, causal=causal, tile_dtype=cfg.attn_tile_dtype,
                           window=window, sinks=sinks)


def attention_block(x, layer, positions, cfg: TransformerConfig,
                    window: int | None = None):
    """Residual attention sub-layer.  Returns (x, (k, v)) with k/v post-RoPE
    [B, S, Hkv, D], which is what a KV cache stores."""
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"])
    q = dense(h, layer["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(h, layer["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(h, layer["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, *cfg.rope_args)
    k = rope(k, positions, *cfg.rope_args)
    o = gqa_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), cfg=cfg, causal=True,
                            window=window)
    o = o.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return x + dense(o, layer["wo"]), (k, v)


def ffn_block(x, layer, cfg: TransformerConfig):
    """Residual FFN: dense SwiGLU, or MoE where the layer carries a router.
    Returns (x, aux): the router's load-balance loss, 0.0 for a dense
    layer."""
    h = rms_norm(x, layer["mlp_norm"])
    if "router" in layer:
        y, aux = moe_ffn(h, layer, cfg)
        return x + y, aux
    gate = F.silu(dense(h, layer["w_gate"]))
    up = dense(h, layer["w_up"])
    return x + dense(gate * up, layer["w_down"]).to(x.dtype), 0.0


def _layer(x, layer, positions, cfg: TransformerConfig, window):
    x, _ = attention_block(x, layer, positions, cfg, window=window)
    return ffn_block(x, layer, cfg)


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


def forward(params, tokens, cfg: TransformerConfig, return_aux: bool = False):
    """Causal LM forward: tokens [B, S] int -> logits [B, S, vocab] fp32.
    With return_aux=True returns (logits, aux), aux being the summed router
    loss of the mixture-of-experts layers (0.0 for a dense model)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    aux_total = 0.0
    for i, layer in enumerate(params["layers"]):
        window = cfg.layer_window(i)
        if cfg.remat == "full" and torch.is_grad_enabled():
            x, aux = checkpoint(_layer, x, layer, positions, cfg, window,
                                use_reentrant=False)
        elif cfg.remat == "dots" and torch.is_grad_enabled():
            x, aux = checkpoint(_layer, x, layer, positions, cfg, window,
                                use_reentrant=False, context_fn=_dots_context)
        else:
            x, aux = _layer(x, layer, positions, cfg, window)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"])
    logits = dense(x, params["lm_head"]).float()
    return (logits, aux_total) if return_aux else logits


def loss_fn(params, tokens, cfg: TransformerConfig):
    """Next-token cross entropy (tokens [B, S + 1] serve as both input and
    target), in the fused form logsumexp(logits) - logits[target], which
    reduces straight off the logits instead of materialising log-softmax,
    plus router_aux_coef times the router loss where the model has
    experts."""
    logits, aux = forward(params, tokens[:, :-1], cfg, return_aux=True)
    targets = tokens[:, 1:]
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    loss = torch.mean(lse - target_logit)
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux
    return loss


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


def value_and_grad(params, tokens, cfg: TransformerConfig):
    """(loss, grads): grads is a tree like params (array_map's), each array
    in its parameter's dtype.  Floating-point arrays are differentiated (a
    QuantizedTensor's fp32 scales, an fp8 weight's values); integer arrays
    (int8 and packed int4 values) get zeros, as JAX's allow_int gives them
    float0 tangents that the JAX step replaces with zeros."""
    with torch.enable_grad():
        arrays = array_leaves(params)
        wrt = [p.detach().requires_grad_(True) for p in arrays if p.is_floating_point()]
        it = iter(wrt)
        loss = loss_fn(array_map(lambda p: next(it) if p.is_floating_point() else p,
                                 params), tokens, cfg)
        grads = iter(torch.autograd.grad(loss, wrt))
    return loss.detach(), array_map(
        lambda p: next(grads) if p.is_floating_point() else torch.zeros_like(p), params)


def make_train_step(cfg: TransformerConfig, learning_rate=1e-3):
    """SGD-with-momentum train step (optimizer state = momentum tree):
    step(params, opt_state, tokens) -> (params, opt_state, loss), each tree
    new, as the JAX step returns them."""

    def train_step(params, opt_state, tokens):
        loss, grads = value_and_grad(params, tokens, cfg)
        new_opt = tree_map(lambda m, g: 0.9 * m + g.float(), opt_state, grads)
        new_params = tree_map(lambda p, m: (p - learning_rate * m).to(p.dtype),
                              params, new_opt)
        return new_params, new_opt, loss

    return train_step


def init_opt_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
