"""The launcher (parallel/launch.py) and scaling_efficiency_bench on gloo
ranks: a rank that raises ends the run with its traceback, a run past its
time raises TimeoutError (both guard the test suite's clock: nothing
hangs), and the benchmark's three layouts (DP, DP x TP, SP) execute the
train step on 4 ranks, keeping only the proof bits on the CPU as the JAX
function does on its virtual fabric (tests/test_distributed.py)."""

import time

import pytest

from cuda_flash_attention_tpu_torch.parallel import launch
from cuda_flash_attention_tpu_torch.parallel.distributed import (
    scaling_efficiency_bench,
)


def test_scaling_bench_layouts_execute():
    out = scaling_efficiency_bench(4, device="cpu", batch=4, seq=128, steps=1)
    assert set(out) == {"dp4", "dp2_tp2", "ctx4"}
    for r in out.values():
        # CPU ranks: the proof bits only (no times posing as scaling).
        assert r["loss_finite"] and r["virtual_cpu"]
        assert "tokens_per_sec" not in r


def test_launcher_raises_when_a_rank_fails():
    """A rank that raises ends the run at once with its traceback, while
    its peer waits in a barrier the failed rank never joins."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.run("_torch_mesh_workers:fail_on", 2, args=(1,), timeout=60)
    assert time.monotonic() - t0 < 60


def test_launcher_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.run("_torch_mesh_workers:sleep_for", 2, args=(60,), timeout=3)
    assert time.monotonic() - t0 < 30
