"""Accuracy and benchmark harness of the reference suite.

Counterpart of cuda_flash_attention_tpu/bench/harness.py:
  * pass/fail oracle: the plain fp32 reference attention (ops/reference.py),
    Q-chunked above 1 GiB of scores (Stress-1 in fp32 has 2 GiB);
  * second oracle: scaled_dot_product_attention under its math backend,
    gated at the same tolerance, skipped above 1 GiB of scores;
  * gradient oracle: torch.autograd through the reference with L = sum(O);
  * gates: max_abs_error < tolerance and no NaN/Inf; stop on the first
    failure by default;
  * backward mode feeds the kernel backward from the ORACLE's forward
    artifacts, both mode from the kernel's own (O, logsumexp);
  * inputs: seeded uniform draws from a torch.Generator on the harness's
    device.
Times come from CUDA events (utils/timing.device_benchmark) and exist only
on the card: on the CPU every time column is NaN.  The CSV has the
reference's exact columns (TestResult.as_row) and is written with the
standard csv module.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import time

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.bench.configs import TestConfig
from cuda_flash_attention_tpu_torch.dispatch import run_flash_attention
from cuda_flash_attention_tpu_torch.ops.metrics import (
    attention_flops,
    attention_io_bytes,
    compute_metrics,
)
from cuda_flash_attention_tpu_torch.ops.reference import (
    reference_attention_grads,
    sdpa_attention,
    sdpa_attention_grads,
    vanilla_attention,
    vanilla_attention_chunked,
    vanilla_attention_with_lse,
)
from cuda_flash_attention_tpu_torch.utils.timing import device_benchmark

# Above this score-matrix footprint the oracle runs Q-chunked.
_ORACLE_CHUNK_BYTES = 1 << 30
_NAN = float("nan")


@dataclasses.dataclass
class TestResult:
    config: TestConfig
    test_type: str  # "forward" | "backward" | "both"
    passed: bool
    max_abs_error: float = _NAN
    mean_abs_error: float = _NAN
    mse: float = _NAN
    max_rel_error: float = _NAN
    # Error against the independent second oracle (SDPA, math backend),
    # gated at the same tolerance.
    max_abs_error_sdpa: float = _NAN
    kernel_time_ms: float = _NAN
    oracle_time_ms: float = _NAN
    speedup: float = _NAN
    tflops: float = _NAN
    bandwidth_gbps: float = _NAN
    error_message: str = ""

    def as_row(self) -> dict:
        """CSV row with the reference's exact column schema.  TorchTime_ms
        carries the oracle (vanilla reference attention) time."""
        c = self.config
        return {
            "Test": c.name,
            "Kernel": c.kernel_type.upper(),
            "Type": self.test_type.upper()[:3],
            "Batch": c.batch_size,
            "Heads": c.num_heads,
            "SeqLen": c.seq_len,
            "HeadDim": c.head_dim,
            "Status": "PASS" if self.passed else "FAIL",
            "MaxError": self.max_abs_error,
            "MaxErrorSDPA": self.max_abs_error_sdpa,
            "MeanError": self.mean_abs_error,
            "MSE": self.mse,
            "MaxRelError": self.max_rel_error,
            "KernelTime_ms": self.kernel_time_ms,
            "TorchTime_ms": self.oracle_time_ms,
            "Speedup": self.speedup,
            "TFLOPS": self.tflops,
            "Bandwidth_GBps": self.bandwidth_gbps,
            "ErrorMessage": self.error_message,
        }


def _score_bytes(cfg: TestConfig) -> int:
    return 4 * cfg.batch_size * cfg.num_heads * cfg.seq_len ** 2


def _flat(*tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


class Harness:
    def __init__(self, tolerance: float = 1e-3, stop_on_failure: bool = True,
                 warmup: int = 1, iters: int = 10, time_oracle: bool = True,
                 verbose: bool = True, device="cuda"):
        self.tolerance = tolerance
        self.stop_on_failure = stop_on_failure
        self.warmup = warmup
        self.iters = iters
        self.time_oracle = time_oracle
        self.verbose = verbose
        self.device = resolve_device(device)
        self.results: list[TestResult] = []

    def _make_qkv(self, cfg: TestConfig):
        """Seeded uniform Q/K/V in fp32 on the harness's device."""
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        shape = (cfg.batch_size, cfg.num_heads, cfg.seq_len, cfg.head_dim)
        return tuple(torch.rand(shape, generator=gen, device=self.device)
                     for _ in range(3))

    def _time(self, fn, *args, oracle: bool = False) -> float:
        """Seconds per call on the card; NaN on the CPU (no device time)."""
        if self.device.type != "cuda" or (oracle and not self.time_oracle):
            return _NAN
        return device_benchmark(fn, *args, warmup=self.warmup, iters=self.iters)

    def _rates(self, cfg: TestConfig, mode: str, t: float) -> dict:
        flops = attention_flops(cfg.batch_size, cfg.num_heads, cfg.seq_len,
                                cfg.seq_len, cfg.head_dim, mode=mode)
        nbytes = attention_io_bytes(cfg.batch_size, cfg.num_heads, cfg.seq_len,
                                    cfg.seq_len, cfg.head_dim)
        return dict(kernel_time_ms=1e3 * t, tflops=flops / t / 1e12,
                    bandwidth_gbps=nbytes / t / 1e9)

    # -- single-config runs --------------------------------------------------

    def run_forward(self, cfg: TestConfig) -> TestResult:
        q, k, v = self._make_qkv(cfg)
        big = _score_bytes(cfg) > _ORACLE_CHUNK_BYTES
        oracle = vanilla_attention_chunked if big else vanilla_attention

        def fn(q, k, v):
            return run_flash_attention(cfg.kernel_type, "forward",
                                       cfg.precision, q, k, v)["o"]

        o = fn(q, k, v)
        m = compute_metrics(o, oracle(q, k, v))
        err_sdpa, sdpa_ok = _NAN, True
        if not big:
            m2 = compute_metrics(o, sdpa_attention(q, k, v))
            err_sdpa, sdpa_ok = m2.max_abs_error, m2.passes(cfg.tolerance)
        del o
        t = self._time(fn, q, k, v)
        t_oracle = self._time(oracle, q, k, v, oracle=True)
        return TestResult(
            config=cfg, test_type="forward",
            passed=m.passes(cfg.tolerance) and sdpa_ok,
            max_abs_error=m.max_abs_error, mean_abs_error=m.mean_abs_error,
            mse=m.mse, max_rel_error=m.max_rel_error,
            max_abs_error_sdpa=err_sdpa, oracle_time_ms=1e3 * t_oracle,
            speedup=t_oracle / t, **self._rates(cfg, "forward", t),
        )

    def run_backward(self, cfg: TestConfig) -> TestResult:
        """Backward only: the forward artifacts come from the ORACLE, not
        the kernel."""
        q, k, v = self._make_qkv(cfg)
        big = _score_bytes(cfg) > _ORACLE_CHUNK_BYTES
        if big:
            o_ref, lse_ref = vanilla_attention_chunked(q, k, v, return_lse=True)
        else:
            o_ref, lse_ref = vanilla_attention_with_lse(q, k, v)

        def fn(q, k, v, o, lse):
            g = run_flash_attention(cfg.kernel_type, "backward", cfg.precision,
                                    q, k, v, o=o, lse=lse)
            return g["dq"], g["dk"], g["dv"]

        got = _flat(*fn(q, k, v, o_ref, lse_ref))
        m = compute_metrics(got, _flat(*reference_attention_grads(
            q, k, v, chunked=big)))
        # The SDPA comparator would materialize the S^2 buffer.
        m2 = m if big else compute_metrics(got, _flat(*sdpa_attention_grads(q, k, v)))
        del got
        t = self._time(fn, q, k, v, o_ref, lse_ref)
        t_oracle = self._time(
            lambda q, k, v: reference_attention_grads(q, k, v, chunked=big),
            q, k, v, oracle=True)
        return TestResult(
            config=cfg, test_type="backward",
            passed=m.passes(cfg.tolerance) and m2.passes(cfg.tolerance),
            max_abs_error=m.max_abs_error, mean_abs_error=m.mean_abs_error,
            mse=m.mse, max_rel_error=m.max_rel_error,
            max_abs_error_sdpa=m2.max_abs_error, oracle_time_ms=1e3 * t_oracle,
            speedup=t_oracle / t, **self._rates(cfg, "backward", t),
        )

    def run_both(self, cfg: TestConfig) -> TestResult:
        """Both: the kernel forward's (O, logsumexp) feed the kernel
        backward, the save-for-backward contract."""
        q, k, v = self._make_qkv(cfg)

        def fn(q, k, v):
            return run_flash_attention(cfg.kernel_type, "forward_backward",
                                       cfg.precision, q, k, v)

        out = fn(q, k, v)
        big = _score_bytes(cfg) > _ORACLE_CHUNK_BYTES
        o_ref = vanilla_attention_chunked(q, k, v) if big else vanilla_attention(q, k, v)
        got = _flat(out["dq"], out["dk"], out["dv"])
        m_fwd = compute_metrics(out["o"], o_ref)
        m_bwd = compute_metrics(got, _flat(*reference_attention_grads(
            q, k, v, chunked=big)))
        if big:
            m2, m2b = m_fwd, m_bwd  # SDPA would materialize the S^2 buffer
        else:
            m2 = compute_metrics(out["o"], sdpa_attention(q, k, v))
            m2b = compute_metrics(got, _flat(*sdpa_attention_grads(q, k, v)))
        del out, got
        passed = all(x.passes(cfg.tolerance) for x in (m_fwd, m_bwd, m2, m2b))
        t = self._time(fn, q, k, v)
        return TestResult(
            config=cfg, test_type="both", passed=passed,
            max_abs_error=max(m_fwd.max_abs_error, m_bwd.max_abs_error),
            mean_abs_error=m_bwd.mean_abs_error, mse=m_bwd.mse,
            max_rel_error=m_bwd.max_rel_error,
            max_abs_error_sdpa=max(m2.max_abs_error, m2b.max_abs_error),
            **self._rates(cfg, "both", t),  # 3.5x the forward's FLOPs
        )

    # -- suite runner ---------------------------------------------------------

    def run(self, configs: list[TestConfig]) -> list[TestResult]:
        """Run each config in turn; an exception becomes a FAIL row with its
        message, as in the reference."""
        runners = {"forward": self.run_forward, "backward": self.run_backward,
                   "both": self.run_both}
        for i, cfg in enumerate(configs):
            t0 = time.time()
            try:
                result = runners[cfg.test_mode](cfg)
            except Exception as e:  # noqa: BLE001 — a FAIL row, as the reference
                result = TestResult(config=cfg, test_type=cfg.test_mode,
                                    passed=False,
                                    error_message=f"{type(e).__name__}: {e}")
            self.results.append(result)
            if self.verbose:
                status = "PASS" if result.passed else "FAIL"
                print(
                    f"[{i + 1}/{len(configs)}] {cfg.name:22s} {cfg.kernel_type:12s} "
                    f"{cfg.test_mode:8s} {status}  "
                    f"err={result.max_abs_error:.2e}  "
                    f"t={result.kernel_time_ms:.3f}ms  "
                    f"({time.time() - t0:.1f}s)"
                    + (f"  !! {result.error_message}" if result.error_message else ""),
                    flush=True,
                )
            if not result.passed and self.stop_on_failure:
                print(f"Stopping on first failure: {cfg.name}")
                break
        return self.results

    # -- reporting ------------------------------------------------------------

    def summary(self) -> str:
        """A plain-text summary grid and per-kernel averages."""
        rows = [r.as_row() for r in self.results]
        if not rows:
            return "(no results)"
        cols = ["Test", "Kernel", "Type", "Status", "MaxError",
                "KernelTime_ms", "Speedup", "TFLOPS", "Bandwidth_GBps"]
        table = "\n".join([",".join(cols)]
                          + [",".join(str(r[c]) for c in cols) for r in rows])
        by_kernel: dict[str, list] = {}
        for r in rows:
            by_kernel.setdefault(r["Kernel"], []).append(r)
        lines = [table, "", "Per-kernel averages:"]

        def mean(rs, key):
            xs = [r[key] for r in rs if math.isfinite(r[key])]
            return sum(xs) / len(xs) if xs else _NAN

        for kern, rs in by_kernel.items():
            lines.append(
                f"  {kern:14s} mean time {mean(rs, 'KernelTime_ms'):8.3f} ms | "
                f"mean TFLOPS {mean(rs, 'TFLOPS'):6.2f} | "
                f"mean speedup {mean(rs, 'Speedup'):7.2f}x | "
                f"mean BW {mean(rs, 'Bandwidth_GBps'):7.2f} GB/s | "
                f"{sum(r['Status'] == 'PASS' for r in rs)}/{len(rs)} pass"
            )
        return "\n".join(lines)

    def save_csv(self, path: str) -> None:
        rows = [r.as_row() for r in self.results]
        fields = list(TestResult(TestConfig("", 1, 1, 1, 1), "forward",
                                 False).as_row())
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=fields)
            writer.writeheader()
            writer.writerows(rows)
