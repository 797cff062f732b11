"""Probe scripts of the port (python -m cuda_flash_attention_tpu_torch.scripts.<name>)."""
