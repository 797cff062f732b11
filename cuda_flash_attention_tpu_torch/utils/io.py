"""Binary tensor file I/O and shape-from-dirname parsing.

Counterpart of cuda_flash_attention_tpu/utils/io.py, copied rather than
imported: raw little-endian float32 blobs with no header, and the data
directory's basename encoding the shape as ``B{B}_H{H}_S{S}_D{D}``.  A data
directory written by one package loads in the other byte for byte.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

_CONFIG_RE = re.compile(r"B(\d+)_H(\d+)_S(\d+)_D(\d+)$")


def parse_config_string(path: str) -> tuple[int, int, int, int]:
    """Parse (B, H, S, D) from a data dir path's basename."""
    base = os.path.basename(os.path.normpath(path))
    m = _CONFIG_RE.match(base)
    if not m:
        raise ValueError(
            f"data dir basename {base!r} does not match B<B>_H<H>_S<S>_D<D>"
        )
    return tuple(int(g) for g in m.groups())  # type: ignore[return-value]


def data_dir_name(batch: int, heads: int, seq: int, head_dim: int) -> str:
    return f"B{batch}_H{heads}_S{seq}_D{head_dim}"


def load_binary_file(path: str, shape=None, dtype=np.float32) -> np.ndarray:
    """Raw float32 blob -> ndarray."""
    arr = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))
    if shape is not None:
        expected = int(np.prod(shape))
        if arr.size != expected:
            raise ValueError(
                f"{path}: expected {expected} elements for shape {shape}, "
                f"got {arr.size}"
            )
        arr = arr.reshape(shape)
    return arr


def save_binary_file(path: str, arr) -> None:
    """ndarray or tensor (any device) -> raw little-endian float32 blob."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    np.asarray(arr, dtype="<f4").tofile(path)


def file_exists(path: str) -> bool:
    return os.path.isfile(path)
