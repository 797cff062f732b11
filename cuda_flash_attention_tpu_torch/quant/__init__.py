from cuda_flash_attention_tpu_torch.quant.linear import dense  # noqa: F401
from cuda_flash_attention_tpu_torch.quant.qtensor import qmax_for  # noqa: F401
