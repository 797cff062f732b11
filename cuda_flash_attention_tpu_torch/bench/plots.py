"""Plots of the harness's results: a 2x2 comparison grid (kernel time,
speedup against the oracle, TFLOP/s, bandwidth for each kernel and config)
and the log2 sequence-length scaling curves.

Counterpart of cuda_flash_attention_tpu/bench/plots.py (the same figures,
file names and `prefix`).  It takes the harness's row dicts
(`TestResult.as_row()`), not a pandas DataFrame, and imports matplotlib
only when it draws: the card's machine has neither package, so the harness
draws there nothing and says so (bench/__main__.py).  `comparison_series`
and `seqlen_series` are the data each figure plots.
"""

from __future__ import annotations

import math
import os

# (column, axis label, log scale) of the comparison grid's four panels.
METRICS = (
    ("KernelTime_ms", "Kernel time (ms)", True),
    ("Speedup", "Speedup vs oracle", False),
    ("TFLOPS", "TFLOPS", False),
    ("Bandwidth_GBps", "Bandwidth (GB/s)", False),
)


def _passed(rows) -> list[dict]:
    return [r for r in rows if r["Status"] == "PASS"]


def comparison_series(rows) -> tuple[list[str], dict]:
    """(the tests in first-seen order, {column: {kernel: [(test index,
    value), ...]}}) of the PASS rows: what each panel's bars show (a
    kernel's first row of each test, as the JAX plot takes it; a value
    that was not measured, NaN, draws no bar)."""
    ok = _passed(rows)
    tests = list(dict.fromkeys(r["Test"] for r in ok))
    kernels = list(dict.fromkeys(r["Kernel"] for r in ok))
    series = {}
    for col, _, _ in METRICS:
        series[col] = {}
        for kern in kernels:
            first = {}
            for r in ok:
                if r["Kernel"] == kern:
                    first.setdefault(r["Test"], float(r[col]))
            series[col][kern] = [(i, first[t]) for i, t in enumerate(tests)
                                 if t in first and math.isfinite(first[t])]
    return tests, series


def seqlen_series(rows) -> dict:
    """{kernel: (seq lens, kernel ms, TFLOP/s)} of the PASS SeqLen-* rows,
    sorted by sequence length: the scaling curves."""
    seq = [r for r in _passed(rows) if str(r["Test"]).startswith("SeqLen-")]
    out = {}
    for kern in dict.fromkeys(r["Kernel"] for r in seq):
        sub = sorted((r for r in seq if r["Kernel"] == kern), key=lambda r: r["SeqLen"])
        out[kern] = ([r["SeqLen"] for r in sub], [float(r["KernelTime_ms"]) for r in sub],
                     [float(r["TFLOPS"]) for r in sub])
    return out


def generate_plots(rows, output_dir: str, prefix: str = "") -> list[str]:
    """Draw the comparison grid (`<prefix>kernel_comparison.png`) and, when
    there are SeqLen-* rows, the scaling curves (`<prefix>seqlen_scaling.png`)
    into output_dir; returns the files written (none without a PASS row).
    `prefix` keeps the modes' sets apart (e.g. "backward_")."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    written = []
    tests, series = comparison_series(rows)
    if not tests:
        return written

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    for ax, (col, label, logy) in zip(axes.flat, METRICS):
        kernels = list(series[col])
        width = 0.8 / max(len(kernels), 1)
        for j, kern in enumerate(kernels):
            points = series[col][kern]
            ax.bar([i + j * width for i, _ in points], [v for _, v in points],
                   width=width, label=kern)
        ax.set_xticks(range(len(tests)))
        ax.set_xticklabels(tests, rotation=45, ha="right", fontsize=7)
        ax.set_ylabel(label)
        if logy:
            ax.set_yscale("log")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
    fig.suptitle("Kernel comparison (H100)")
    fig.tight_layout()
    path = os.path.join(output_dir, f"{prefix}kernel_comparison.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    written.append(path)

    curves = seqlen_series(rows)
    if curves:
        fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
        for kern, (lens, ms, tflops) in curves.items():
            axes[0].plot(lens, ms, "o-", label=kern)
            axes[1].plot(lens, tflops, "o-", label=kern)
        for ax, ylab in zip(axes, ["Kernel time (ms)", "TFLOPS"]):
            ax.set_xscale("log", base=2)
            ax.set_xlabel("sequence length")
            ax.set_ylabel(ylab)
            ax.legend(fontsize=8)
            ax.grid(alpha=0.3)
        axes[0].set_yscale("log")
        fig.suptitle("Sequence-length scaling (H100)")
        fig.tight_layout()
        path = os.path.join(output_dir, f"{prefix}seqlen_scaling.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written
