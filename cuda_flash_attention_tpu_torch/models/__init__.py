from cuda_flash_attention_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    ffn_block,
    forward,
    gqa_flash_attention,
    init_params,
    rms_norm,
    rope,
)
