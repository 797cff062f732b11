"""PyTorch/CUDA port of the FlashAttention-2 framework for NVIDIA Hopper.

A package beside the JAX one (cuda_flash_attention_tpu), which stays the
reference: the same module layout and names, idiomatic PyTorch inside, and
every Pallas TPU kernel on a ported path rewritten by hand in CUDA C++ for
sm_90a (csrc/), built with nvcc at first use and bound with ctypes.  Entry
points run on the CUDA card unless the caller asks for the CPU, where each
kernel's plain PyTorch version runs instead.

Ported so far: the serving path (prefill through the FA2 forward kernel,
int8 paged-KV decode through the paged decode kernel, the continuous-
batching DecodeEngine), the training path (the FA2 backward kernels
behind a differentiable flash_attention, the loss, the SGD-momentum and
AdamW train steps) and the reference contract (the dispatch registry, the
CLI, the accuracy and benchmark harness, the small-shape FA2 forward and
the FA1 / naive-FA2 baseline kernels), and the quantized path (the
quantized-KV FA2 forward, fp8 and int4 paged caches, int8/fp8/int4 and W8A8
weights, LoRA), and training on a device mesh over torch.distributed
(parallel/: ring attention, head-parallel attention, data x model x
context-parallel train steps).  This package imports torch and numpy,
never jax.
"""

__version__ = "0.1.0"

from cuda_flash_attention_tpu_torch._device import resolve_device  # noqa: F401
from cuda_flash_attention_tpu_torch.kernels.attention import (  # noqa: F401
    BlockSizes,
    fa2_backward,
    flash_attention,
    flash_attention_with_lse,
)
from cuda_flash_attention_tpu_torch.kernels.fa2_forward_quant import (  # noqa: F401
    flash_attention_int8_kv,
    flash_attention_quantized_kv,
    flash_attention_quantized_kv_with_lse,
)
