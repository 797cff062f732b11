"""Training checkpoints: the train state (parameters, optimizer state, step)
saved to a directory and restored, and the reference CLI's forward
artifacts (O.bin, logsumexp.bin).

Counterpart of cuda_flash_attention_tpu/utils/checkpoint.py.  The JAX
package writes orbax checkpoints, which need JAX to read; this module writes
its own format, `torch.save` of the state as plain containers (dicts,
lists, tensors, numbers), read back with `torch.load(weights_only=True)`.
So neither package reads the other's checkpoints: carry parameters across
with utils.convert.params_from_numpy instead.  A QuantizedTensor or
LoRATensor is stored field by field, and the optimizer's and train loop's
named tuples by name, and each comes back as its class.  A save commits
atomically: the state is written under a temporary directory beside the
checkpoint and moved into place with os.replace, so a reader sees the old
checkpoint or the new one, never part of one.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.models.lora import LoRATensor
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor
from cuda_flash_attention_tpu_torch.utils.io import save_binary_file

_STATE = "state.pt"
_CLASSES = {"QuantizedTensor": QuantizedTensor, "LoRATensor": LoRATensor}


def _named_tuples() -> dict:
    from cuda_flash_attention_tpu_torch.models.training import AdamWState, TrainState

    return {"AdamWState": AdamWState, "TrainState": TrainState}


def _encode(x):
    """x as plain containers that weights_only loading accepts."""
    if isinstance(x, (QuantizedTensor, LoRATensor)):
        return {"__class__": type(x).__name__,
                "fields": {f.name: _encode(getattr(x, f.name))
                           for f in dataclasses.fields(x)}}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"__class__": type(x).__name__, "items": [_encode(v) for v in x]}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach()
    return x


def _decode(x):
    if isinstance(x, dict) and "__class__" in x:
        name = x["__class__"]
        if name in _CLASSES:
            return _CLASSES[name](**{k: _decode(v) for k, v in x["fields"].items()})
        return _named_tuples()[name](*(_decode(v) for v in x["items"]))
    if isinstance(x, dict):
        return {k: _decode(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_decode(v) for v in x]
    return x


def _onto(x, like):
    """x's tensors on the devices and in the dtypes of like's, which has
    x's structure (its classes field by field)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype) if isinstance(
            like, torch.Tensor) else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _onto(getattr(x, f.name), getattr(like, f.name))
            for f in dataclasses.fields(x) if isinstance(
                getattr(x, f.name), (torch.Tensor, QuantizedTensor, LoRATensor))})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_onto(a, b) for a, b in zip(x, like)))
    if isinstance(x, dict):
        return {k: _onto(v, like[k]) for k, v in x.items()}
    if isinstance(x, list):
        return [_onto(a, b) for a, b in zip(x, like)]
    return x


def save_checkpoint(path: str, params, opt_state=None, step: int = 0) -> str:
    """Save {"params", "step"[, "opt_state"]} to the directory `path`,
    atomically, replacing a checkpoint there; returns the absolute path."""
    path = os.path.abspath(path)
    state = {"params": _encode(params), "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = _encode(opt_state)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(state, os.path.join(tmp, _STATE))
        if os.path.isdir(path):
            os.replace(os.path.join(tmp, _STATE), os.path.join(path, _STATE))
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path


def restore_checkpoint(path: str, like=None, device=None):
    """The saved state: {"params", "step"[, "opt_state"]}, its tensors on
    `device` (None means the card, as train_loop's; "cpu" the CPU), or with
    `like` (a tree of that structure, e.g. {"params": params, "opt_state":
    opt_state, "step": 0}) on like's devices and in like's dtypes, leaf by
    leaf."""
    where = "cpu" if like is not None else resolve_device(device)
    raw = torch.load(os.path.join(os.path.abspath(path), _STATE),
                     map_location=where, weights_only=True)
    state = _decode(raw)
    return state if like is None else _onto(state, like)


def save_for_backward(path_dir: str, o, lse) -> None:
    """The reference CLI's artifacts of a forward (O.bin and logsumexp.bin,
    raw fp32; utils/io.py's codec), read back by the backward."""
    os.makedirs(path_dir, exist_ok=True)
    save_binary_file(os.path.join(path_dir, "O.bin"),
                     np.asarray(torch.as_tensor(o).detach().float().cpu()))
    save_binary_file(os.path.join(path_dir, "logsumexp.bin"),
                     np.asarray(torch.as_tensor(lse).detach().float().cpu()))
