"""4-bit QLoRA fine-tuning example: int4 base weights and trained rank-8
adapters, then merged back for serving without adapters (the port's
counterpart of the repository's examples/finetune_lora.py).

    python -m cuda_flash_attention_tpu_torch.examples.finetune_lora               # the card
    python -m cuda_flash_attention_tpu_torch.examples.finetune_lora --device cpu  # plain versions
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cuda_flash_attention_tpu_torch.models import (
    TransformerConfig,
    apply_lora,
    init_params,
    init_train_state,
    make_lora_optimizer,
    make_optax_train_step,
    make_optimizer,
    merge_lora,
)
from cuda_flash_attention_tpu_torch.quant import quantize_transformer_params

CFG = TransformerConfig(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, head_dim=32, d_ff=256)


def finetune(cfg, params, tokens, steps: int = 5, log=print):
    """`steps` AdamW steps of the LoRA optimizer, which gives every frozen
    leaf a zero update, so only the adapters train; returns the losses and
    the merged tree (int4 base, adapters folded in)."""
    opt = make_lora_optimizer(
        make_optimizer(learning_rate=1e-3, warmup_steps=1, decay_steps=50), params)
    state = init_train_state(params, opt)
    step = make_optax_train_step(cfg, opt)
    losses = []
    for i in range(steps):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        log(f"step {i}: loss {losses[-1]:.4f}")
    return losses, merge_lora(state.params)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    base = init_params(torch.Generator().manual_seed(0), CFG, device=args.device)
    # A 4-bit base (group-wise packed int4) with rank-8 adapters.
    params = apply_lora(quantize_transformer_params(base, "int4"),
                        torch.Generator().manual_seed(1), rank=8)
    tokens = np.random.default_rng(0).integers(0, CFG.vocab_size, (4, 65))
    losses, served = finetune(CFG, params, tokens)
    wq = served["layers"][0]["wq"]
    print("merged wq is", type(wq).__name__, f"bits={wq.bits}")
    return losses, served


if __name__ == "__main__":
    main()
