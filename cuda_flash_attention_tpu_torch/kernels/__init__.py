# fa2_backward (the standalone backward) is not re-exported here: the name
# is also this package's submodule of the backward kernels.
from cuda_flash_attention_tpu_torch.kernels.attention import (  # noqa: F401
    BlockSizes,
    flash_attention,
    flash_attention_with_lse,
)
