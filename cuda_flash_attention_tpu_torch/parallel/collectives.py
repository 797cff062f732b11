"""The collectives of the mesh paths, plain and differentiable.

In the JAX package XLA inserts these (GSPMD's all-reduces, shard_map's
ppermute); in the port they are explicit torch.distributed calls over one
axis group of a parallel.mesh.Mesh:

  all_reduce / all_gather       plain, no autograd
  all_reduce_coalesced          the sums of many tensors through one fp32
                                buffer (one collective an axis: a gradient
                                tree's)
  copy_to(x, mesh, axis)        identity forward, all-reduce of the
                                gradient backward (the tensor-parallel
                                region's entry)
  reduce_from(x, mesh, *axes)   all-reduce forward, identity backward (the
                                row-split product's partial sums; a loss's
                                sum over ranks)
  gather_from(x, mesh, axis, d) all-gather along dim d forward, the sum of
                                every rank's gradient for this rank's slice
                                backward (each rank's consumer differs)
  gather_replicated(x, mesh,    all-gather along dim d forward, this rank's
                    axis, d)    own gradient for its slice backward (every
                                rank of the axis runs the same consumer:
                                the expert outputs of models/moe.py)
  Exchange                      a posted point-to-point rotation around an
                                axis (ring attention's K/V and dK/dV), waited
                                on later
  Shift                         a posted truncated shift along an axis (the
                                pipeline's stage-to-stage transfers: rank i
                                to i + hops, no wrap)

Sums run in fp32 (a 16-bit tensor is widened for the reduction and
narrowed after).  Gathers and rotations move 16-bit and 8-bit tensors as
their bytes (a uint8 view), which every backend takes.
Under the gloo backend a point-to-point message must lie in host memory
(gloo's send and recv do not take CUDA tensors), so `Exchange` copies a CUDA
tensor (`Exchange`, `Shift`) to pinned host memory before the send and the
received one back to the card after the wait; that is transport only, and under NCCL CUDA
tensors go directly.  gloo's all-reduce and all-gather take CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_BYTES = (torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x, or for a 16-bit or 8-bit float its bytes (the last dim times the
    element size): gloo's and NCCL's collectives take no int16, and a byte
    view keeps each element's bytes together along any dim."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _BYTES else x


def all_reduce(x: torch.Tensor, mesh, *axes: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or `op`) of x over the ranks of `axes` (a new tensor in
    x's dtype; x itself where every axis has size 1)."""
    axes = [a for a in axes if mesh.size(a) > 1]
    if not axes:
        return x
    y = x.float().clone() if x.dtype != torch.float64 else x.clone()
    for axis in axes:
        dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y.to(x.dtype)


def all_reduce_coalesced(tensors, mesh, *axes: str) -> list:
    """The sums over `axes` of every tensor (each in its own dtype), through
    one flat fp32 buffer: one collective an axis, not one a tensor.  The
    tensors themselves where every axis has size 1."""
    tensors = list(tensors)
    axes = [a for a in axes if mesh.size(a) > 1]
    if not axes or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    for axis in axes:
        dist.all_reduce(flat, group=mesh.group(axis))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The rank-ordered concatenation along `dim` of x over `axis`."""
    n = mesh.size(axis)
    if n == 1:
        return x
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).view(x.dtype)


def local_slice(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's even slice of x along `dim` over `axis`."""
    n = mesh.size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"evenly over {axis!r} of size {n}")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * step, step)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, *axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.mesh, ctx.axis)
        return local_slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None, None, None


def copy_to(x, mesh, axis: str):
    """Identity; the gradient is summed over `axis` (each rank of the
    tensor-parallel region contributes the part its shard of the weights
    gives)."""
    return x if mesh.size(axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, *axes: str):
    """The sum of x over `axes`; its gradient passes unchanged."""
    if all(mesh.size(a) == 1 for a in axes):
        return x
    return _ReduceFrom.apply(x, mesh, axes)


def gather_from(x, mesh, axis: str, dim: int):
    """The concatenation of every rank's x along `dim`; the gradient of this
    rank's slice is the sum of every rank's gradient for it."""
    return x if mesh.size(axis) == 1 else _GatherFrom.apply(x, mesh, axis, dim)


def gather_replicated(x, mesh, axis: str, dim: int):
    """The concatenation of every rank's x along `dim`, for a consumer that
    every rank of `axis` computes alike (so each already holds the whole
    gradient): the gradient of this rank's slice is its own, not summed
    (gather_from's sum would count the one consumer once a rank)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axis, dim)


class Exchange:
    """Send each tensor `hops` ranks forward around `axis` and receive the
    tensors of the rank `hops` behind, posted at construction;
    `wait()` returns the received tensors (each like the one sent).  Under
    gloo a CUDA tensor crosses through pinned host memory (the module's
    note)."""

    def __init__(self, tensors, mesh, axis: str, hops: int = 1):
        self.tensors = list(tensors)
        n = mesh.size(axis)
        self.works, self.received = [], None
        if n == 1 or hops % n == 0:
            return
        group = mesh.group(axis)
        ranks = dist.get_process_group_ranks(group)
        me = ranks.index(dist.get_rank())
        dst, src = ranks[(me + hops) % n], ranks[(me - hops) % n]
        host = dist.get_backend(group) == "gloo"
        ops, self.received = [], []
        for tag, t in enumerate(self.tensors):
            w = _wire(t)
            if host and w.is_cuda:
                w = _pinned_copy(w)
            recv = torch.empty(w.shape, dtype=w.dtype, device=w.device,
                               pin_memory=w.device.type == "cpu" and t.is_cuda)
            self.received.append(recv)
            ops.append(dist.P2POp(dist.isend, w, dst, group, tag))
            ops.append(dist.P2POp(dist.irecv, recv, src, group, tag))
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> list:
        if self.received is None:
            return self.tensors
        for w in self.works:
            w.wait()
        out = []
        for t, r in zip(self.tensors, self.received):
            r = r.view(t.dtype)
            out.append(r.to(t.device, non_blocking=True) if t.is_cuda else r)
        return out


class Shift:
    """Send each tensor `hops` ranks along `axis` (rank i to i + hops) and
    receive the tensors of the rank `hops` behind, posted at construction,
    without wrapping: the last `hops` ranks send nothing and the first
    receive nothing (JAX's truncated ppermute; `hops` -1 runs it back, as
    the backward pipeline does).  `send` / `recv` False leave a rank's side
    out (a pipeline stage idle on a tick).  `wait()` returns the received
    tensors, each like the one given, and zeros where nothing was received.
    Under gloo a CUDA tensor crosses through pinned host memory (the
    module's note)."""

    def __init__(self, tensors, mesh, axis: str, hops: int = 1, *,
                 send: bool = True, recv: bool = True):
        self.tensors = list(tensors)
        n = mesh.size(axis)
        group = mesh.group(axis) if n > 1 else None
        me = mesh.index(axis)
        send = send and 0 <= me + hops < n
        self.recv = recv and 0 <= me - hops < n
        self.works, self.received = [], []
        if not (send or self.recv):
            return
        ranks = dist.get_process_group_ranks(group)
        host = dist.get_backend(group) == "gloo"
        ops = []
        for tag, t in enumerate(self.tensors):
            w = _wire(t)
            if host and w.is_cuda:
                w = _pinned_copy(w)
            if send:
                ops.append(dist.P2POp(dist.isend, w, ranks[me + hops], group, tag))
            if self.recv:
                r = torch.empty(w.shape, dtype=w.dtype, device=w.device,
                                pin_memory=w.device.type == "cpu" and t.is_cuda)
                self.received.append(r)
                ops.append(dist.P2POp(dist.irecv, r, ranks[me - hops], group, tag))
        self.ops = ops  # the staged send buffers live until the wait
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        if not self.recv:
            return [torch.zeros_like(t) for t in self.tensors]
        return [r.view(t.dtype).to(t.device, non_blocking=True) if t.is_cuda
                else r.view(t.dtype) for t, r in zip(self.tensors, self.received)]


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h
