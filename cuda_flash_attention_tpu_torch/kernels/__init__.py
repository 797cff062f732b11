from cuda_flash_attention_tpu_torch.kernels.attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
)
