"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU; nothing
falls back to the CPU on its own.  On the CPU every kernel wrapper runs its
plain PyTorch version (that is what the parity tests use)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means "cuda".  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
