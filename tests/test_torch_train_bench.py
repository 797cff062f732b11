"""The port's training benchmark (bench/train_bench.py) returns the JAX
function's keys, and both benchmarks' command lines run on the CPU with
`--device cpu` and print their JSON line (no device number: "platform":
"cpu")."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cuda_flash_attention_tpu.bench import train_bench as jax_train
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.bench import train_bench
from cuda_flash_attention_tpu_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]


def test_train_measure_returns_the_jax_keys():
    cfg_j = jax_tf.TransformerConfig.tiny()
    cfg_t = transformer.TransformerConfig.tiny()
    want = jax_train.measure_train_throughput(cfg_j, 1, 128, iters=1)
    got = train_bench.measure_train_throughput(cfg_t, 1, 128, iters=1, repeats=2,
                                               device="cpu")
    assert set(want) <= set(got) and np.isfinite(got["loss"])
    assert (got["batch"], got["seq"]) == (want["batch"], want["seq"])
    assert got["repeats"] == 2 and got["timer"] == "host_clock"
    assert got["step_ms_min"] <= round(got["step_ms"], 4) <= got["step_ms_max"]


@pytest.mark.parametrize("args", [
    ["decode_bench", "--gen", "2", "--batch", "2", "--repeats", "1"],
    ["decode_bench", "--gen", "2", "--batch", "2", "--engine", "--burst", "2",
     "--device-ratio", "--repeats", "1", "--prefill-chunk", "128"],
    ["train_bench", "--tiny", "--batch", "1", "--seq", "128", "--repeats", "2"],
], ids=["device_loop", "engine", "train"])
def test_cli_runs_on_the_cpu(args):
    out = subprocess.run(
        [sys.executable, "-m", f"cuda_flash_attention_tpu_torch.bench.{args[0]}",
         *args[1:], "--device", "cpu"],
        cwd=ROOT, check=True, capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    if "--device-ratio" in args:
        assert res["engine_overhead_x"] > 0 and res["burst_dispatches"] > 0
