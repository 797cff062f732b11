"""Decode steps as captured CUDA graphs.

Counterpart of the JAX engine's compiled device programs: the per-token
step is one jitted program (cuda_flash_attention_tpu/decode/engine.py:
702-732), and a decode burst is n chained decode-and-sample steps in one
program with one readback (`_device_burst`, :734-820).  On the card the
counterpart of one program is a CUDA graph: a step function over
persistent device buffers is captured once and replayed.  The step reads
a device step index and advances it, so one capture serves a burst of any
length, as the JAX body compiles once whatever n is.  On the CPU the same
step function runs eagerly n times; on the card it is captured or the call
raises: nothing falls back to eager launches.  A step whose owner asks for
eager runs (`eager=True`: a serving mesh under gloo, whose collectives
cross host memory and cannot be captured) runs eagerly on the card too.

Launch counts.  The kernel wrappers count launches on the host
(kernels/launches.py), so a replay adds nothing to them by itself.  A
capture records what the step's wrappers added while it was captured
(those launches were recorded, not run, so they are taken back), and
every replay adds that record again: the counts read after a run of
replays are the launches that ran.
"""

from __future__ import annotations

import gc

import torch

from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES


class StepGraph:
    """One step function over persistent buffers.  On the card: captured
    once as a CUDA graph, after `warmup` (one eager call that must leave
    the buffers as it found them) has built the kernels and allocated their
    lazy state at the captured shapes, then replayed; `generator`, when
    given, is registered with the graph (CUDAGraph.register_generator_state)
    so that each replay draws the next numbers of its stream.  `pool` is a
    graph memory pool several graphs of one owner may share (their replays
    never overlap).  On the CPU, or with `eager`: the step runs eagerly."""

    def __init__(self, step, device: torch.device, *, warmup,
                 generator: torch.Generator | None = None, pool=None,
                 eager: bool = False):
        self.step = step
        self.eager = eager
        self.device = device
        self.warmup = warmup
        self.generator = generator
        self.pool = pool
        self.graph = None
        self.launch_delta: dict[str, int] = {}
        self.replays = 0

    def capture(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.warmup()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = LAUNCHES.copy()
        # The collector is held off during the capture: garbage in reference
        # cycles (a dropped engine and its graphs) collected inside it would
        # destroy graphs there, which invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.step()
        finally:
            if collecting:
                gc.enable()
        # The captured launches were recorded, not run: take them back; each
        # replay adds them.
        self.launch_delta = LAUNCHES - before
        LAUNCHES.subtract(self.launch_delta)
        self.graph = graph

    def run(self, n: int) -> None:
        """The step n times: n replays on the card, n eager calls on the
        CPU."""
        if self.device.type == "cpu" or self.eager:
            for _ in range(n):
                self.step()
            return
        if self.device.type != "cuda":
            raise ValueError(f"StepGraph: unsupported device {self.device}")
        if self.graph is None:
            self.capture()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        for name, d in self.launch_delta.items():
            LAUNCHES[name] += d * n
