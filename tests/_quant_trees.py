"""Helpers of the port's quantization parity tests: JAX QuantizedTensor and
LoRATensor trees as the port's classes holding numpy arrays (what
utils.convert.params_from_numpy takes), and arrays as comparable numpy."""

import numpy as np
import torch

from cuda_flash_attention_tpu.models.lora import LoRATensor as JaxLoRA
from cuda_flash_attention_tpu.quant.qtensor import QuantizedTensor as JaxQT
from cuda_flash_attention_tpu_torch.models.lora import LoRATensor
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor


def numpy_tree(tree):
    """A JAX parameter tree with numpy leaves and the port's classes."""
    if isinstance(tree, JaxQT):
        return QuantizedTensor(np.asarray(tree.values), np.asarray(tree.scales),
                               act_quant=tree.act_quant, bits=tree.bits,
                               group_size=tree.group_size)
    if isinstance(tree, JaxLoRA):
        return LoRATensor(numpy_tree(tree.base), np.asarray(tree.a),
                          np.asarray(tree.b), scale=tree.scale)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    return np.asarray(tree)


def raw(x) -> np.ndarray:
    """A JAX or torch array as numpy, fp8 as its bytes, bf16 as fp32."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return x.view(torch.uint8).numpy()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    if x.dtype.name.startswith("float8"):
        return x.view(np.uint8)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same_qt(got: QuantizedTensor, want: JaxQT):
    """Bytes, scales and metadata equal."""
    assert (got.bits, got.group_size, got.act_quant) == (
        want.bits, want.group_size, want.act_quant)
    assert str(got.values.dtype).split(".")[-1] == np.asarray(want.values).dtype.name
    np.testing.assert_array_equal(raw(got.values), raw(want.values))
    np.testing.assert_array_equal(raw(got.scales), raw(want.scales))
