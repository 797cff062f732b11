from cuda_flash_attention_tpu_torch.ops.reference import (  # noqa: F401
    vanilla_attention,
    vanilla_attention_with_lse,
    reference_attention_grads,
)
from cuda_flash_attention_tpu_torch.ops.metrics import compute_metrics  # noqa: F401
