"""Quantization layer: int8/fp8/int4 tensors, weight quantization for dense
layers, W8A8.  Counterpart of cuda_flash_attention_tpu/quant, exporting the
same names."""

from cuda_flash_attention_tpu_torch.quant.qtensor import (
    QuantizedTensor,
    dequantize,
    pack_int4,
    qmax_for,
    quantize,
    quantize_int4,
    quantize_kv,
    supported_quant_dtypes,
    unpack_int4,
)
from cuda_flash_attention_tpu_torch.quant.linear import (
    dense,
    quantize_transformer_params,
    quantize_weight,
    quantized_matmul,
)

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "quantize_kv",
    "quantize_int4",
    "pack_int4",
    "unpack_int4",
    "supported_quant_dtypes",
    "quantize_weight",
    "quantized_matmul",
    "dense",
    "quantize_transformer_params",
    "qmax_for",
]
