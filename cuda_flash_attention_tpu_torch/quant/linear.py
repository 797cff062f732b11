"""Dense projections.

Counterpart of cuda_flash_attention_tpu/quant/linear.py: `dense` for plain
weights.  Quantized (QuantizedTensor) and LoRA weights are not ported yet."""

from __future__ import annotations

import torch


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain [in, out] weight, computed in x's dtype."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"dense: only plain weight tensors are ported; got {type(w).__name__}"
        )
    return x @ w.to(x.dtype)
