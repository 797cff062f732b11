"""Data- and tensor-parallel attention over a mesh.

Counterpart of cuda_flash_attention_tpu/parallel/sharded.py.  Head (tensor)
parallelism: the Q/K/V heads split over the "model" axis, the batch over
"data"; each rank runs the FA2 kernels on its local heads with no
communication inside attention (the output projection's all-reduce comes
after, models/transformer.py).  Where the JAX package places global arrays
with a PartitionSpec and shard_map hands each device its block, the port's
ranks hold their blocks: `shard` slices a global tensor to this rank's
block, `gather` puts the blocks back together (for tests and checks).
"""

from __future__ import annotations

from cuda_flash_attention_tpu_torch.kernels.attention import flash_attention
from cuda_flash_attention_tpu_torch.parallel.collectives import (
    all_gather,
    local_slice,
)
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    CTX_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
)


def qkv_partition_spec(mesh, *, ring: bool = False) -> tuple:
    """The axis that splits each dim of a [B, H, S, D] tensor (None: not
    split): batch over "data", heads over "model", and with `ring` the
    sequence over "ctx" (ring attention), each only where the mesh has that
    axis."""
    def axis(name):
        return name if name in mesh.axis_names else None

    return (axis(DATA_AXIS), axis(MODEL_AXIS), axis(CTX_AXIS) if ring else None,
            None)


def shard(x, mesh, spec):
    """This rank's block of the global tensor x under `spec` (one axis
    name or None per dim)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = local_slice(x, mesh, axis, dim)
    return x.contiguous()


def gather(x, mesh, spec):
    """The global tensor from every rank's block (the inverse of `shard`;
    every rank gets all of it)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = all_gather(x, mesh, axis, dim)
    return x


def shard_qkv(mesh, q, k, v):
    """This rank's blocks of global q/k/v: batch over data, heads over
    model."""
    spec = qkv_partition_spec(mesh)
    return tuple(shard(x, mesh, spec) for x in (q, k, v))


def head_parallel_attention(mesh, q, k, v, *, causal: bool = False,
                            sm_scale: float | None = None, tile_dtype=None,
                            window: int | None = None, sinks: int = 0):
    """FA2 on this rank's (batch over data, heads over model) blocks of q,
    k and v: returns this rank's block of O.  Differentiable: the local
    autograd is the gradient of the rank's block, and no collective runs.
    The sequence is not split, so a sliding window and its sinks pass
    straight through to the kernels.  A mesh with a ctx axis of size > 1
    belongs to ring attention (parallel/ring.py)."""
    if mesh.size(CTX_AXIS) > 1:
        raise ValueError("head_parallel_attention: the mesh splits the "
                         "sequence over ctx; use ring_attention")
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           tile_dtype=tile_dtype, window=window, sinks=sinks)
