"""Accuracy and performance metric accounting.

Counterpart of cuda_flash_attention_tpu/ops/metrics.py, copied rather than
imported, with the reference harness's FLOP and bandwidth conventions:

  forward flops   = 4 * B * H * S_q * S_kv * D
  backward flops  = 2.5x forward; forward + backward = 3.5x forward
  bandwidth bytes = B*H*S*D * 4 tensors * itemsize

`compute_metrics` takes numpy arrays or torch tensors; tensors are compared
on their own device in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Metrics:
    max_abs_error: float
    mean_abs_error: float
    mse: float
    max_rel_error: float
    has_nan: bool
    has_inf: bool

    @property
    def ok(self) -> bool:
        return not (self.has_nan or self.has_inf)

    def passes(self, tolerance: float) -> bool:
        # Pass criterion: max_abs_error < tol AND no NaN/Inf.
        return self.ok and self.max_abs_error < tolerance


def compute_metrics(result, reference, eps: float = 1e-8) -> Metrics:
    if isinstance(result, torch.Tensor) or isinstance(reference, torch.Tensor):
        result = torch.as_tensor(result).to(torch.float64)
        reference = torch.as_tensor(reference, device=result.device).to(torch.float64)
        if result.numel() == 0:
            return Metrics(0.0, 0.0, 0.0, 0.0, False, False)
        diff = (result - reference).abs()
        return Metrics(
            max_abs_error=diff.max().item(),
            mean_abs_error=diff.mean().item(),
            mse=(diff ** 2).mean().item(),
            max_rel_error=(diff / (reference.abs() + eps)).max().item(),
            has_nan=bool(torch.isnan(result).any()),
            has_inf=bool(torch.isinf(result).any()),
        )
    result = np.asarray(result, dtype=np.float64)
    reference = np.asarray(reference, dtype=np.float64)
    diff = np.abs(result - reference)
    return Metrics(
        max_abs_error=float(diff.max()) if diff.size else 0.0,
        mean_abs_error=float(diff.mean()) if diff.size else 0.0,
        mse=float((diff**2).mean()) if diff.size else 0.0,
        max_rel_error=float((diff / (np.abs(reference) + eps)).max()) if diff.size else 0.0,
        has_nan=bool(np.isnan(result).any()),
        has_inf=bool(np.isinf(result).any()),
    )


def attention_flops(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
    *, mode: str = "forward", causal: bool = False,
) -> float:
    """FLOP count, reference convention (4*B*H*S^2*D fwd; bwd = 2.5x fwd)."""
    fwd = 4.0 * batch * heads * q_len * kv_len * head_dim
    if causal:
        fwd /= 2.0
    if mode == "forward":
        return fwd
    if mode == "backward":
        return 2.5 * fwd
    if mode in ("both", "forward_backward"):
        return 3.5 * fwd
    raise ValueError(f"unknown mode {mode!r}")


def attention_io_bytes(
    batch: int, heads: int, q_len: int, kv_len: int, head_dim: int,
    *, itemsize: int = 4,
) -> float:
    """Bandwidth accounting: Q, K, V, O only, 4 tensors."""
    q_bytes = batch * heads * q_len * head_dim * itemsize
    kv_bytes = batch * heads * kv_len * head_dim * itemsize
    return float(2 * q_bytes + 2 * kv_bytes)  # Q + O + K + V

