"""PyTorch/CUDA port of the FlashAttention-2 framework for NVIDIA Hopper.

A package beside the JAX one (cuda_flash_attention_tpu), which stays the
reference: the same module layout and names, idiomatic PyTorch inside, and
every Pallas TPU kernel on a ported path rewritten by hand in CUDA C++ for
sm_90a (csrc/), built with nvcc at first use and bound with ctypes.  Entry
points run on the CUDA card unless the caller asks for the CPU, where each
kernel's plain PyTorch version runs instead.

Ported so far: the serving path (prefill through the FA2 forward kernel,
int8 paged-KV decode through the paged decode kernel, the continuous-
batching DecodeEngine).  This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from cuda_flash_attention_tpu_torch._device import resolve_device  # noqa: F401
from cuda_flash_attention_tpu_torch.kernels.attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
)
