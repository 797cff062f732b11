from cuda_flash_attention_tpu_torch.dispatch.types import (  # noqa: F401
    ComputeDataType,
    ComputeType,
    ModeType,
)
from cuda_flash_attention_tpu_torch.dispatch.registry import (  # noqa: F401
    SUPPORTED_HEAD_DIMS,
    get_kernel,
    run_flash_attention,
)
