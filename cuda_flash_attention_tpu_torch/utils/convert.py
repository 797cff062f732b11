"""Carry a parameter tree from the JAX package into the port.

The caller turns the JAX arrays into numpy arrays (np.asarray on each leaf);
this module needs neither JAX nor its package, only the tree's structure:
dicts, lists and arrays."""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; fp32 holds every bf16 value exactly.
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a copy: JAX's buffers are read-only
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """The same tree with every numpy array as a torch tensor on `device`
    (cast to `dtype` when given).  Lists and tuples become lists."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _to_tensor(tree, device, dtype)
