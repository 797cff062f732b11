"""Runnable examples of the port: `python -m
cuda_flash_attention_tpu_torch.examples.serve` (continuous batching over a
paged int8 KV cache) and `... .examples.finetune_lora` (4-bit QLoRA).  Both
run on the card; `--device cpu` runs the kernels' plain versions."""
