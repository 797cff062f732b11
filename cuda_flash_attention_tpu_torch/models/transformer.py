"""GQA decoder-only transformer: config, parameters and the causal forward.

Counterpart of cuda_flash_attention_tpu/models/transformer.py for serving:
the same parameter tree (a dict with "embed", "layers" (a list of dicts),
"final_norm" and "lm_head"; weights are [in, out] and used as x @ W), the
same RMSNorm, half-rotation RoPE and SwiGLU.  Attention runs the FA2 forward
kernel.  Mixture-of-experts layers, meshes, remat and training are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.kernels.attention import flash_attention
from cuda_flash_attention_tpu_torch.quant.linear import dense


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
    # Sliding window and attention sinks (not ported yet: the engine and the
    # attention API raise when they are set).
    attn_window: int | None = None
    global_every: int = 0
    attn_sinks: int = 0
    # Long-context RoPE extension: "none", "linear" or "ntk".
    rope_scaling: str = "none"
    rope_scale_factor: float = 1.0

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of n_kv_heads "
                f"({self.n_kv_heads})"
            )

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
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(cfg.d_model),
            "wq": normal((cfg.d_model, cfg.q_dim)),
            "wk": normal((cfg.d_model, cfg.kv_dim)),
            "wv": normal((cfg.d_model, cfg.kv_dim)),
            "wo": normal((cfg.q_dim, cfg.d_model)),
            "mlp_norm": ones(cfg.d_model),
            "w_gate": normal((cfg.d_model, cfg.d_ff)),
            "w_up": normal((cfg.d_model, cfg.d_ff)),
            "w_down": normal((cfg.d_ff, cfg.d_model)),
        })
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


def rope(x, positions, theta: float, pos_scale: float = 1.0):
    """Half-rotation RoPE.  x: [B, S, H, D]; positions: [B, S].  The
    frequencies are exp(-log(theta) * arange / half) in fp32, the same
    expression as the JAX package (a theta ** x form differs in the last
    bits)."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -log_theta * torch.arange(0, half, dtype=torch.float32) / half
    ).to(x.device)
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
    """Residual dense SwiGLU.  Returns (x, aux) with aux = 0.0, as the JAX
    function does for a dense layer."""
    if "router" in layer:
        raise NotImplementedError("mixture-of-experts layers are not ported yet")
    h = rms_norm(x, layer["mlp_norm"])
    gate = F.silu(dense(h, layer["w_gate"]))
    up = dense(h, layer["w_up"])
    return x + dense(gate * up, layer["w_down"]).to(x.dtype), 0.0


def forward(params, tokens, cfg: TransformerConfig):
    """Causal LM forward: tokens [B, S] int -> logits [B, S, vocab] fp32."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = params["embed"][tokens].to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        x, _ = attention_block(x, layer, positions, cfg, window=cfg.layer_window(i))
        x, _ = ffn_block(x, layer, cfg)
    x = rms_norm(x, params["final_norm"])
    return dense(x, params["lm_head"]).float()
