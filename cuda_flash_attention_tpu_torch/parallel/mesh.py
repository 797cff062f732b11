"""Device meshes over torch.distributed: the axis names and one process
group per axis.

Counterpart of cuda_flash_attention_tpu/parallel/mesh.py.  A JAX Mesh
arranges devices that one program addresses; here every rank is one process
on one device, and a Mesh arranges the ranks of the default process group
(torch.distributed.device_mesh), row-major over the axes in the order given:

  axis        split                         used for
  ----        -----                         --------
  "data"      batch dim                     DP
  "model"     heads / d_ff / vocab          TP (attention runs head-local)
  "ctx"       sequence dim of Q, K and V    SP / ring attention
  "expert"    MoE expert dim                EP (models/moe.py)
  "pipe"      layer-stage dim               PP (models/pipeline.py)

The process group must exist before a mesh is made:
`parallel.distributed.initialize_distributed`, or `parallel.launch` (which
spawns ranks on one host), or torch.distributed.init_process_group.  The
counterpart of JAX's `cpu_test_mesh` is `parallel.launch`: gloo ranks on the
CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from cuda_flash_attention_tpu_torch._device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
CTX_AXIS = "ctx"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"


class Mesh:
    """The named axes of a DeviceMesh, this rank's coordinate on each, one
    process group per axis, and the device this rank computes on.  `shape`
    maps each axis to its size, as a JAX Mesh's does; an axis the mesh does
    not name has size 1 and coordinate 0 (`size`, `index`)."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {name: device_mesh.size(i)
                      for i, name in enumerate(self.axis_names)}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        if axis not in self.shape:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        on `axis`."""
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _check_group(n: int, what) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "make a mesh after the process group: initialize_distributed(), "
            "parallel.launch, or torch.distributed.init_process_group")
    if n != dist.get_world_size():
        raise ValueError(f"mesh {what} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")


def make_device_mesh(mesh_shape: dict[str, int] | None = None, *,
                     device=None) -> Mesh:
    """A Mesh over every rank of the default process group.  `mesh_shape`
    maps axis name -> size, e.g. {"data": 2, "model": 4}, sizes whose
    product is the world size (axes of size 1 are fine); the default puts
    every rank on "data".  `device` is where this rank computes (None means
    the card: cuda:LOCAL_RANK mod the device count, as
    torch.distributed.device_mesh picks it)."""
    device = resolve_device(device)
    if mesh_shape is None:
        if not dist.is_initialized():
            _check_group(1, None)
        mesh_shape = {DATA_AXIS: dist.get_world_size()}
    n = 1
    for size in mesh_shape.values():
        n *= size
    _check_group(n, mesh_shape)
    device = _rank_device(device)
    dm = init_device_mesh(device.type, tuple(mesh_shape.values()),
                          mesh_dim_names=tuple(mesh_shape))
    return Mesh(dm, device)


def mesh_from_ranks(ranks, names, *, device=None) -> Mesh:
    """A Mesh whose rank array is `ranks` (an integer array of the world's
    ranks shaped like the axes `names`): the layouts that are not row-major
    over the ranks, as distributed.make_hybrid_mesh builds."""
    device = resolve_device(device)
    ranks = torch.as_tensor(ranks, dtype=torch.int64)
    _check_group(ranks.numel(), dict(zip(names, ranks.shape)))
    device = _rank_device(device)
    dm = DeviceMesh(device.type, ranks, mesh_dim_names=tuple(names))
    return Mesh(dm, device)


def _rank_device(device: torch.device) -> torch.device:
    """The card of this rank (cuda:LOCAL_RANK mod the device count unless
    `device` names one), made current before the mesh's groups exist."""
    if device.type != "cuda":
        return device
    if device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device
