"""Multi-process set-up: the process group, meshes laid out across hosts,
and the scaling benchmark's three layouts.

Counterpart of cuda_flash_attention_tpu/parallel/distributed.py.

  * `initialize_distributed` joins this process to the group from the
    JAX function's variables (COORDINATOR_ADDRESS, NUM_PROCESSES,
    PROCESS_ID) or torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
    NCCL on the card and gloo when the caller asks for the CPU; with
    nothing configured it does nothing, so scripts call it unconditionally.
  * `make_hybrid_mesh` lays the ranks out host-major: an axis in both
    shapes gets size ici * dcn with the host (DCN) factor outermost, so the
    inner axes' collectives stay inside a host.  On one host the DCN
    factors simply multiply into a plain mesh.
  * `scaling_efficiency_bench` runs the train step on DP, DP x TP and pure
    SP layouts over N spawned ranks (parallel/launch.py).

The host count is WORLD_SIZE / LOCAL_WORLD_SIZE as torchrun sets them, and
one host otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    CTX_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_device_mesh,
    mesh_from_ranks,
)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None) -> bool:
    """Join the default process group for a multi-process run.

    The arguments default from COORDINATOR_ADDRESS ("host:port"),
    NUM_PROCESSES and PROCESS_ID, then from torchrun's MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE and RANK.  The backend is NCCL for the card
    (each process on cuda:LOCAL_RANK, else cuda:rank mod the device count)
    and gloo for device="cpu".  Returns True when the group exists (now or
    already), False when nothing is configured: a single-process run, and
    then a no-op."""
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        n = env.get("NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if n is None else int(n)
    if process_id is None:
        r = env.get("PROCESS_ID", env.get("RANK"))
        process_id = None if r is None else int(r)
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" not in env:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: a coordinator is set but "
                         "the process count or this process's id is not")
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init_method = (f"tcp://{coordinator_address}" if coordinator_address
                   else "env://")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def _n_hosts() -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return max(world // max(local, 1), 1)


def hybrid_layout(ici_shape: dict[str, int], dcn_shape: dict[str, int] | None,
                  n_hosts: int) -> tuple[dict[str, int], np.ndarray]:
    """(mesh shape, rank array) of make_hybrid_mesh: ranks numbered
    host-major (host h holds ranks h * per_host ...), each axis of size
    ici * dcn with its DCN factor outermost.  With one host, or no DCN
    factor above 1, the plain row-major layout of the combined shape."""
    dcn_shape = dict(dcn_shape or {})
    ici_shape = dict(ici_shape)
    for axis in dcn_shape:
        ici_shape.setdefault(axis, 1)
    names = tuple(ici_shape)
    combined = {a: ici_shape[a] * dcn_shape.get(a, 1) for a in names}
    total = int(np.prod(list(combined.values())))
    if n_hosts == 1 or all(v == 1 for v in dcn_shape.values()):
        return combined, np.arange(total).reshape(tuple(combined.values()))
    dcn = [dcn_shape.get(a, 1) for a in names]
    ici = [ici_shape[a] for a in names]
    if int(np.prod(dcn)) != n_hosts:
        raise ValueError(f"DCN shape {dcn_shape} needs {int(np.prod(dcn))} "
                         f"hosts, the run has {n_hosts}")
    ranks = np.arange(total).reshape(dcn + ici)
    k = len(names)
    # (dcn_0..dcn_k, ici_0..ici_k) -> (dcn_0, ici_0, dcn_1, ici_1, ...)
    order = [i for pair in zip(range(k), range(k, 2 * k)) for i in pair]
    return combined, ranks.transpose(order).reshape(tuple(combined.values()))


def make_hybrid_mesh(ici_shape: dict[str, int],
                     dcn_shape: dict[str, int] | None = None, *,
                     device=None) -> Mesh:
    """A mesh whose `dcn_shape` axes cross hosts and whose `ici_shape`
    axes stay inside each host (hybrid_layout).  Example, 2 hosts of 8
    ranks: make_hybrid_mesh({"data": 2, "model": 4}, {"data": 2}) ->
    {"data": 4, "model": 4}, the outer data factor the host."""
    combined, ranks = hybrid_layout(ici_shape, dcn_shape, _n_hosts())
    if ranks.size == dist.get_world_size() and np.array_equal(
            ranks.reshape(-1), np.arange(ranks.size)):
        return make_device_mesh(combined, device=device)
    return mesh_from_ranks(ranks, tuple(combined), device=device)


def two_host_serving_mesh(tp: int, *, device=None) -> Mesh:
    """Data parallel across hosts, tensor parallel inside each: the layout
    of the serving configuration, which DecodeEngine(mesh=) serves."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_hosts = _n_hosts()
    per_host = world // n_hosts
    if per_host % tp:
        raise ValueError(f"tp={tp} must divide devices/host ({per_host})")
    return make_hybrid_mesh({DATA_AXIS: per_host // tp, MODEL_AXIS: tp},
                            {DATA_AXIS: n_hosts}, device=device)


# ---------------------------------------------------------------------------
# Scaling-efficiency benchmark.
# ---------------------------------------------------------------------------


def _layouts(n: int) -> dict[str, dict[str, int]]:
    return {f"dp{n}": {DATA_AXIS: n},
            f"dp{n // 2}_tp2": {DATA_AXIS: n // 2, MODEL_AXIS: 2},
            f"ctx{n}": {CTX_AXIS: n}}


def scaling_rank(device: str, batch: int, seq: int, steps: int, cfg) -> dict:
    """One rank of scaling_efficiency_bench: the SGD-momentum train step
    (transformer.make_train_step) on each layout, timed after one warm-up
    step."""
    import time

    from cuda_flash_attention_tpu_torch.models.transformer import (
        init_opt_state,
        init_params,
        make_train_step,
        shard_params,
    )

    device = resolve_device(device)
    n = dist.get_world_size()
    results = {}
    for name, shape in _layouts(n).items():
        mesh = make_device_mesh(shape, device=device)
        params = shard_params(
            init_params(torch.Generator().manual_seed(0), cfg, device=mesh.device),
            mesh, cfg)
        opt_state = init_opt_state(params)
        tokens = torch.ones((batch, seq + 1), dtype=torch.long, device=mesh.device)
        train_step = make_train_step(cfg, mesh=mesh)
        params, opt_state, loss = train_step(params, opt_state, tokens)  # warm
        _sync(mesh.device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            params, opt_state, loss = train_step(params, opt_state, tokens)
        _sync(mesh.device)
        dt = (time.perf_counter() - t0) / steps
        results[name] = {"tokens_per_sec": batch * seq / dt,
                         "step_ms": dt * 1e3,
                         "loss_finite": bool(torch.isfinite(loss))}
    return results


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_efficiency_bench(n_devices: int = 4, *, device=None,
                             batch: int = 8, seq: int = 512, steps: int = 2,
                             cfg=None) -> dict:
    """Train-step tokens/sec under three layouts of `n_devices` ranks:
    pure DP {data: N}, DP x TP {data: N/2, model: 2} and pure SP {ctx: N}
    (ring attention), each rank a process spawned by parallel/launch.py
    (gloo; every rank on the card, or on the CPU with device="cpu").  The
    batch is at least N, so it splits over "data".

    On the CPU the times are those of emulated ranks on shared cores and
    say nothing of scaling: only the proof bits are kept (loss_finite,
    virtual_cpu), as the JAX function keeps them on its virtual fabric.  On
    one card the N ranks share it, so tokens/s are those of N ranks on one
    device (`ranks_per_device`), not multi-GPU scaling; `vs_dp` compares
    the layouts."""
    from cuda_flash_attention_tpu_torch.models.transformer import (
        TransformerConfig,
    )
    from cuda_flash_attention_tpu_torch.parallel import launch

    device = resolve_device(device)
    cfg = cfg or TransformerConfig.tiny()
    batch = max(batch, n_devices)
    out = launch.run(
        "cuda_flash_attention_tpu_torch.parallel.distributed:scaling_rank",
        n_devices, args=(device.type, batch, seq, steps, cfg), timeout=600)
    results = out[0]
    for r in results.values():
        if device.type == "cpu":
            r.pop("tokens_per_sec")
            r.pop("step_ms")
            r["virtual_cpu"] = True
    if device.type == "cuda":
        base = results[f"dp{n_devices}"]["tokens_per_sec"]
        for r in results.values():
            r["ranks_per_device"] = n_devices // max(torch.cuda.device_count(), 1)
            r["vs_dp"] = r["tokens_per_sec"] / base if base else None
    return results
