"""Per-kernel device time and roofline/MFU accounting on the card.

Counterpart of cuda_flash_attention_tpu/utils/profiling.py:47-196.
`profile_ops` runs a function under `torch.profiler` (CUPTI tracing) and
sums each CUDA kernel's own device time by kernel name, so a step that
launches many kernels is broken down into them; host clocks and launch
latency never enter.  `trace` is the same window with what the table
leaves out: the host ops and the device time each launched, the op that
launched each kernel, and the host clock over the window.  On the CPU
(`device="cpu"`) the same functions sum the CPU ops' own times instead,
which is what the tests run; a CPU time is never a device time.  On the
card a window in which the profiler recorded no device time raises: it
never reports 0.

Roofline: `roofline_time` is the larger of the tensor-core time (FLOPs
over the dense bf16/fp16 peak times `derate`), the HBM time and the
exp-unit time, under the JAX function's keys ("mxu" names the tensor
cores, "vpu" the exp units).  The port's fp32 bodies run on the FMA units
at 67 TFLOP/s, so they pass ``derate=FP32_DERATE`` (67 / 989).  JAX's
`mxu_derate` is left out: it models the v5e's 128-wide systolic array,
which a contraction of 64 fills half of; Hopper's wgmma (m64nNk16, N up to
256) steps the contraction 16 at a time and is not underfilled at D 64,
so the rule has no counterpart.  `mfu` is the measured FLOP/s over the
peak, beside the derated share.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    name: str
    bf16_tflops: float
    hbm_gbps: float
    exp_per_s: float


# NVIDIA H100 SXM5 data sheet at its 700 W limit: 989 TFLOP/s dense bf16
# and fp16 on the tensor cores, 3,350 GB/s of HBM3.  exp: the SFU's ex2
# (MUFU.EX2) throughput on compute capability 9.0, 16 results a clock an SM
# (CUDA C++ Programming Guide, "Arithmetic Instructions", throughput
# table), times 132 SMs times 1.83 GHz, the clock at which the 989 TFLOP/s
# figure is reached (528 tensor cores x 1,024 dense bf16 FLOPs a clock).
_H100 = (989.0, 3350.0, 16 * 132 * 1.83e9)
_CHIP_PEAKS = {"h100": _H100}
# The fp32 FMA bodies' peak (67 TFLOP/s) as a derate of the bf16 peak.
FP32_DERATE = 67.0 / 989.0


def chip_peaks(device=None) -> ChipPeaks:
    """The card's peaks, matched on `torch.cuda.get_device_name`.  A CPU
    device, a machine without CUDA or a card not in the table gets the
    H100's numbers under the name "unknown", as placeholders."""
    dev = torch.device("cuda" if device is None else device)
    name = ""
    if dev.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(dev)
    for frag, (tf, bw, ex) in _CHIP_PEAKS.items():
        if frag in name.lower():
            return ChipPeaks(name, tf, bw, ex)
    return ChipPeaks("unknown", *_H100)


@dataclasses.dataclass
class OpTime:
    name: str
    count: int
    total_ms: float

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@dataclasses.dataclass
class Trace:
    """One profiled window of `iters` calls.  `kernels`: each CUDA kernel's
    own device time (on the CPU: each CPU op's own time), descending.
    `ops`: each host op with the device time of what it launched, children
    included (on the CPU: its CPU time, children included), descending;
    runtime calls (cudaLaunchKernel, cudaGraphLaunch) are among them with
    their counts.  `sources`: kernel name -> the ops that launched it (the
    outermost op or range and the innermost op, "train_step.update >
    aten::mul"), by device time (empty on the CPU).  `wall_ms`: host
    clock over the window, synchronised."""
    kernels: list[OpTime]
    ops: list[OpTime]
    sources: dict[str, list[tuple[str, float]]]
    wall_ms: float
    iters: int
    device: str

    @property
    def busy_ms(self) -> float:
        """Device (on the CPU: op) time of all kernels, per call."""
        return sum(k.total_ms for k in self.kernels) / self.iters

    def top(self, n: int = 10) -> list[tuple[str, float, str]]:
        """The n kernels with the most time: (name, ms per call, the op
        that launched most of it, or "" when none was recorded)."""
        return [(k.name, k.total_ms / self.iters,
                 self.sources[k.name][0][0] if self.sources.get(k.name) else "")
                for k in self.kernels[:n]]


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel...)."""
    return name.startswith(("cuda", "cu")) and not name.startswith("cutlass")


def kernel_sources(events) -> dict[str, list[tuple[str, float]]]:
    """For each kernel name, the op chains that launched it with their
    device ms, most first.  `events` are the profiler's FunctionEvents: a
    runtime launch call carries its kernels (`.kernels`, linked by CUPTI's
    correlation id), and its `cpu_parent` chain the ops around it; the
    chain names the outermost op or range on that thread and the innermost
    op ("train_step.update > aten::mul")."""
    acc: dict[str, collections.Counter] = collections.defaultdict(collections.Counter)
    for e in events:
        kernels = getattr(e, "kernels", None)
        if not kernels:
            continue
        names, p = [], e
        while p is not None:
            if not _is_runtime(p.name):
                names.append(p.name)
            p = p.cpu_parent
        op = " > ".join(names[:0:-1][:1] + names[:1]) or "(no op)"
        for k in kernels:
            acc[k.name][op] += k.duration / 1e3
    return {name: c.most_common() for name, c in acc.items()}


def trace(fn, *args, iters: int = 4, warmup: int = 2, device=None) -> Trace:
    """Run `fn(*args)` `warmup` times, then `iters` times under
    torch.profiler; the window is synchronised at both ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    host = [e for e in averages if e.device_type == DeviceType.CPU]
    if on_card:
        # A record_function range also shows on the device as a user
        # annotation spanning its kernels: not a kernel of its own.
        kernels = [OpTime(e.key, e.count, e.self_device_time_total / 1e3)
                   for e in averages if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        if not sum(k.total_ms for k in kernels) > 0:
            raise RuntimeError(
                "profile: torch.profiler recorded no device time on the card; "
                "time with CUDA events instead")
        ops = [OpTime(e.key, e.count, e.device_time_total / 1e3) for e in host]
        sources = kernel_sources(prof.events())
    else:
        kernels = [OpTime(e.key, e.count, e.self_cpu_time_total / 1e3) for e in host]
        ops = [OpTime(e.key, e.count, e.cpu_time_total / 1e3) for e in host]
        sources = {}
    return Trace(sorted(kernels, key=lambda o: -o.total_ms),
                 sorted(ops, key=lambda o: -o.total_ms), sources, wall_ms,
                 iters, str(dev))


def profile_ops(fn, *args, iters: int = 4, warmup: int = 2,
                device=None) -> list[OpTime]:
    """Per-kernel device times of `iters` calls of `fn(*args)`, summed by
    kernel name, descending total (on the CPU: per CPU op)."""
    return trace(fn, *args, iters=iters, warmup=warmup, device=device).kernels


_COPIES = re.compile(r"(?i)memcpy|memset|^aten::copy_$")


def kernel_device_time(fn, *args, match: str | None = None, iters: int = 4,
                       exclude_copies: bool = True, device=None) -> float:
    """Mean device seconds a call, summed over the profiled kernels.
    `match` (a regex) keeps only the kernels whose name matches; without
    it every kernel counts but memcpy and memset (on the CPU: aten::copy_),
    unless `exclude_copies` is False."""
    total_ms = 0.0
    for op in profile_ops(fn, *args, iters=iters, device=device):
        if match is not None and not re.search(match, op.name):
            continue
        if match is None and exclude_copies and _COPIES.search(op.name):
            continue
        total_ms += op.total_ms
    return total_ms / 1e3 / iters


def roofline_time(flops: float, hbm_bytes: float, *, transcendentals: float = 0.0,
                  derate: float = 1.0, peaks: ChipPeaks | None = None) -> dict:
    """Speed-of-light seconds of a kernel: the largest of the tensor-core
    time (FLOPs over the bf16 peak times `derate`; FP32_DERATE for the fp32
    FMA bodies), the HBM time and the exp units' time (they run beside the
    tensor cores, so they bound it from below rather than add)."""
    p = peaks or chip_peaks()
    t_mxu = flops / (p.bf16_tflops * 1e12 * derate)
    t_hbm = hbm_bytes / (p.hbm_gbps * 1e9)
    t_vpu = transcendentals / p.exp_per_s
    return {
        "t_ideal_s": max(t_mxu, t_hbm, t_vpu),
        "t_mxu_s": t_mxu,
        "t_hbm_s": t_hbm,
        "t_vpu_s": t_vpu,
        "bound": max((("mxu", t_mxu), ("hbm", t_hbm), ("vpu", t_vpu)),
                     key=lambda kv: kv[1])[0],
    }


def mfu(flops: float, seconds: float, *, derate: float = 1.0,
        peaks: ChipPeaks | None = None) -> dict:
    """Measured FLOP/s over the bf16 peak, and over the derated peak."""
    p = peaks or chip_peaks()
    tflops = flops / seconds / 1e12
    return {
        "tflops": tflops,
        "mfu": tflops / p.bf16_tflops,
        "mfu_derated": tflops / (p.bf16_tflops * derate),
        "peak_tflops": p.bf16_tflops,
        "chip": p.name,
    }
