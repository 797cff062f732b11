"""Hugging Face Llama-family weight import.

Counterpart of cuda_flash_attention_tpu/utils/hf_convert.py: a
`transformers` Llama-architecture model (LlamaForCausalLM and compatibles:
the same projection names, RMSNorm, SwiGLU, rotate-half RoPE), or its
state dict, mapped onto the port's parameter tree (models/transformer.py).
What lines up exactly: HF's rotate-half RoPE with inv_freq =
theta^(-2i/d) is the port's half rotation; no biases; head-major
projections; GQA query head h reads KV head h // group.  HF's nn.Linear
stores [out, in] and the port [in, out], so every projection is
transposed.  What the port does not express: RMSNorm's eps is 1e-6 in both
packages, so a checkpoint with another rms_norm_eps (Llama 3's 1e-5)
converts, but normalises with 1e-6.

The tensors are converted on their own device, in cfg.param_dtype, with no
copy through the host: a state dict on the card converts on the card.
`transformers` is never imported here; any object with LlamaConfig's
attribute names serves as a config.
"""

from __future__ import annotations

from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig


def config_from_hf(hf_config, **overrides) -> TransformerConfig:
    """TransformerConfig from a LlamaConfig-compatible object."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    base = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        head_dim=head_dim,
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
    )
    base.update(overrides)
    return TransformerConfig(**base)


def params_from_hf(model_or_state_dict, cfg: TransformerConfig) -> dict:
    """The port's parameter tree from a Llama-architecture model (or its
    state dict of torch tensors).  Projections are transposed to [in, out]
    and made contiguous; every leaf is a new tensor in cfg.param_dtype on
    the source tensor's device.  Without lm_head.weight (tied embeddings)
    the head is the embedding transposed."""
    sd = model_or_state_dict
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    dtype = cfg.param_dtype

    def proj(name):
        return sd[name].detach().to(dtype).t().contiguous()

    def vec(name):
        return sd[name].detach().to(dtype, copy=True)

    layers = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        layers.append({
            "attn_norm": vec(pre + "input_layernorm.weight"),
            "wq": proj(pre + "self_attn.q_proj.weight"),
            "wk": proj(pre + "self_attn.k_proj.weight"),
            "wv": proj(pre + "self_attn.v_proj.weight"),
            "wo": proj(pre + "self_attn.o_proj.weight"),
            "mlp_norm": vec(pre + "post_attention_layernorm.weight"),
            "w_gate": proj(pre + "mlp.gate_proj.weight"),
            "w_up": proj(pre + "mlp.up_proj.weight"),
            "w_down": proj(pre + "mlp.down_proj.weight"),
        })
    embed = vec("model.embed_tokens.weight")
    if "lm_head.weight" in sd:
        lm_head = proj("lm_head.weight")
    else:  # tied embeddings
        lm_head = embed.t().contiguous()
    return {"embed": embed, "layers": layers,
            "final_norm": vec("model.norm.weight"), "lm_head": lm_head}


def load_llama(model, **config_overrides):
    """(params, cfg) from a transformers Llama model in one call;
    ``config_overrides`` turn on what the checkpoint does not encode
    (dtype, attn_window, rope_scaling, remat, ...)."""
    cfg = config_from_hf(model.config, **config_overrides)
    return params_from_hf(model, cfg), cfg
