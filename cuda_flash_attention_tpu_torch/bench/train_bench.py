"""Training throughput benchmark: train-step tokens/s on the card.

Counterpart of cuda_flash_attention_tpu/bench/train_bench.py: chained AdamW
train steps (`models/training.make_optax_train_step`; the state threads
through) on one batch, timed at two chain lengths and differenced (the
slope cancels a run's fixed cost), with CUDA events on the card and the
host clock beside them.  On the CPU only the host clock exists: its numbers
are not device numbers ("platform": "cpu").

Usage (on the card; add `--device cpu` for the CPU):
    python -m cuda_flash_attention_tpu_torch.bench.train_bench --batch 2 --seq 2048
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.bench.decode_bench import _timed
from cuda_flash_attention_tpu_torch.models.training import (
    init_train_state,
    make_optax_train_step,
    make_optimizer,
)
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)


def measure_train_throughput(cfg: TransformerConfig, batch: int, seq: int,
                             iters: int = 8, repeats: int = 1,
                             device=None) -> dict:
    """The median of `repeats` slopes, each one pair of chains of `iters`
    and 5 x `iters` AdamW steps, after one untimed chain of `iters` (the
    JAX function warms up both lengths to compile them; eager PyTorch
    compiles nothing).  The JAX function's keys (its one slope at the
    default repeats=1), plus the min/max spread as measure_decode_throughput
    gives it and `host_step_ms` (the median slope on the host clock)."""
    device = resolve_device(device)
    opt = make_optimizer(decay_steps=10_000)
    state = init_train_state(
        init_params(torch.Generator(device=device).manual_seed(0), cfg,
                    device=device), opt)
    step = make_optax_train_step(cfg, opt)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(1)).to(device)
    carry = {"state": state, "loss": None}

    def run_n(n: int):
        for _ in range(n):
            carry["state"], metrics = step(carry["state"], tokens)
            carry["loss"] = metrics["loss"]

    n_lo, n_hi = iters, iters * 5
    run_n(n_lo)
    slopes, host = [], []
    for _ in range(max(repeats, 1)):
        d_lo, h_lo = _timed(lambda: run_n(n_lo), device)
        d_hi, h_hi = _timed(lambda: run_n(n_hi), device)
        slopes.append(max(d_hi - d_lo, 1e-9) / (n_hi - n_lo))
        host.append(max(h_hi - h_lo, 1e-9) / (n_hi - n_lo))
    step_s = statistics.median(slopes)
    return {
        "train_tokens_per_sec_per_chip": batch * seq / step_s,
        "step_ms": step_s * 1e3,
        "batch": batch,
        "seq": seq,
        "loss": float(carry["loss"]),
        "step_ms_min": round(min(slopes) * 1e3, 4),
        "step_ms_max": round(max(slopes) * 1e3, 4),
        "repeats": len(slopes),
        "host_step_ms": statistics.median(host) * 1e3,
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--repeats", type=int, default=1,
                   help="slopes taken; the median is reported with min/max")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (TransformerConfig.tiny() if args.tiny else TransformerConfig(
        vocab_size=2048, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=1536))
    out = measure_train_throughput(cfg, args.batch, args.seq,
                                   repeats=args.repeats, device=device)
    out["platform"] = "gpu" if device.type == "cuda" else "cpu"
    out["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
