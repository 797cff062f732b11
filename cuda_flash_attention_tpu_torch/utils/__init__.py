from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy  # noqa: F401
