"""Quantization constants shared by the KV cache.

Counterpart of cuda_flash_attention_tpu/quant/qtensor.py (qmax_for only;
QuantizedTensor and weight quantization are not ported yet)."""

from __future__ import annotations

import torch

# Largest-magnitude finite value per storage dtype.
_QMAX = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}


def qmax_for(dtype: torch.dtype) -> float:
    if dtype not in _QMAX:
        raise ValueError(
            f"unsupported quantization dtype {dtype}; supported: {list(_QMAX)}"
        )
    return _QMAX[dtype]
