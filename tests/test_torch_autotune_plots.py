"""bench/autotune.py and bench/plots.py of the port on the CPU.

Autotune: its candidates (the tile shapes the Hopper bodies compile, the
shipped one first, --blocks' filter, B2/B4's fixed 64-KV-row refusal),
the variant libraries' keys and file names (B4's built without B2), the
compiler's and ptxas's refusals as failed rows, a launch error as a row or,
strict, an exception, and a sweep's JSON rows and winners on a fake timer
(on CPU tensors every candidate runs the plain version: one function, no
difference).  Plots: generate_plots on
the harness's rows writes the files the JAX package's writes from a
DataFrame of the same rows, and its plotted series are the rows' values.
"""

import json
import math

import pandas as pd
import pytest
import torch

from cuda_flash_attention_tpu.bench import plots as jax_plots
from cuda_flash_attention_tpu_torch.bench import __main__ as bench_main
from cuda_flash_attention_tpu_torch.bench import autotune, configs, harness, plots
from cuda_flash_attention_tpu_torch.kernels import _build

BF16 = torch.bfloat16


@pytest.mark.parametrize("kernel,d,want", [
    ("fwd", 64, [(128, 128, 3), (128, 64, 2), (128, 64, 3), (128, 128, 2)]),
    ("fwd", 256, [(128, 64, 2), (128, 64, 3), (128, 128, 2), (128, 128, 3)]),
    ("fused", 64, [(128, 128, 2), (128, 64, 2), (64, 128, 2)]),
    ("fused", 128, [(64, 128, 2), (64, 64, 2), (128, 128, 2)]),
    ("dkv", 128, [(64, 128, 2), (64, 64, 2), (128, 128, 2)]),
    ("fused", 256, [(64, 64, 2)]),
    ("dq", 64, [(128, 128, 3), (128, 64, 2), (128, 64, 3), (128, 128, 2)]),
    ("dq", 256, [(128, 32, 3), (128, 32, 2), (128, 64, 2), (128, 64, 3)]),
])
def test_candidates_are_the_bodies_tiles_shipped_first(kernel, d, want):
    cands = autotune.candidates(kernel, d, BF16)
    assert [(c.block_q, c.block_k, c.stages) for c in cands] == want
    assert cands[0].default and cands[0].key() is None
    assert not any(c.default for c in cands[1:])
    for c in cands[1:]:
        if c.refused:  # B2/B4's 64 KV rows: no library to build
            assert c.key() is None and c.block_k == 64
            continue
        defines = dict(c.defines)
        assert defines["CFA_HEAD_DIM"] == d and defines["CFA_BF16_INPUTS_ONLY"] == 1


def test_fp32_tiles_are_one_fixed_row_and_blocks_filter_the_rest():
    for kernel in autotune.KERNELS:
        (c,) = autotune.candidates(kernel, 64, None)
        assert (c.block_q, c.block_k, c.stages, c.default) == (64, 64, None, True)
    cands = autotune.candidates("fwd", 64, BF16, blocks=(128,))
    assert [(c.block_k, c.stages) for c in cands] == [(128, 3), (128, 2)]


def test_b2_b4_64_kv_rows_are_one_fixed_refused_row():
    """kKvRows is 128 in every B2/B4 body below D 256 (the two consumers'
    64 rows each): 64 KV rows is one failed row, built by no variant; the
    shared-memory refusals come from the layouts' own static_asserts."""
    for kernel in ("fused", "dkv"):
        for d in (32, 64, 128):
            cands = autotune.candidates(kernel, d, BF16)
            (fixed,) = [c for c in cands if c.refused]
            assert fixed.block_k == 64 and "kKvRows" in fixed.refused
            assert fixed.key() is None and fixed.key() not in autotune.variant_keys(cands)
            assert all(c.block_k == 128 for c in cands if not c.refused)
            assert not any(c.refused for c in autotune.candidates(kernel, d, BF16,
                                                                  blocks=(128,)))
    src = (_build.CSRC_DIR / "fa2_backward.cu").read_text()
    assert "CFA_BWD_KV_ROWS" not in src and "constexpr int kKvRows = 128;" in src
    for name, layouts in (("fa2_forward.cu", 1), ("fa2_backward.cu", 4)):
        text = (_build.CSRC_DIR / name).read_text()
        assert text.count('static_assert(kSmem <= 232448, "one block must fit the SM') \
            >= layouts, name


def test_b4_variants_are_built_without_b2():
    """B4's variants leave B2 out (CFA_BWD_DKV_ONLY): B2's dS^T buffers
    would refuse a B4 shape that fits (128 Q rows a step at D 128)."""
    for d in (64, 128):
        fused = [c for c in autotune.candidates("fused", d, BF16) if c.key()]
        dkv = [c for c in autotune.candidates("dkv", d, BF16) if c.key()]
        assert [(c.block_q, c.block_k) for c in fused] == [(c.block_q, c.block_k) for c in dkv]
        for f, k in zip(fused, dkv):
            assert dict(k.defines) == dict(f.defines, CFA_BWD_DKV_ONLY=1)
        assert "bwd_dkv_only1" in _build.library_path(dkv[0].key()).name
    src = (_build.CSRC_DIR / "fa2_backward.cu").read_text()
    guard = src[src.index("#ifdef CFA_BWD_DKV_ONLY"):]
    assert guard.index("cudaErrorInvalidValue") < guard.index(
        "launch_kv_wgmma<Tin, Tt, D, true>") < guard.index("#endif")


def test_variant_keys_name_their_defines_and_hash_them():
    c = autotune.candidates("fwd", 64, BF16)[1]
    key = c.key()
    assert key == ("fa2_forward[CFA_BF16_INPUTS_ONLY=1,CFA_FWD_STAGES=2,"
                   "CFA_FWD_TILE_N=64,CFA_HEAD_DIM=64]")
    assert _build.split_key(key) == ("fa2_forward", {
        "CFA_BF16_INPUTS_ONLY": "1", "CFA_FWD_STAGES": "2", "CFA_FWD_TILE_N": "64",
        "CFA_HEAD_DIM": "64"})
    path = _build.library_path(key)
    assert path.name.startswith("fa2_forward-bf16_inputs_only1-fwd_stages2-fwd_tile_n64"
                                "-head_dim64-")
    assert path != _build.library_path("fa2_forward")
    assert _build.split_key("fa2_forward") == ("fa2_forward", {})
    # B2 and B4 each their own variant library per shape, once each.
    fused = {c.key() for c in autotune.candidates("fused", 64, BF16)[1:]} - {None}
    dkv = {c.key() for c in autotune.candidates("dkv", 64, BF16)[1:]} - {None}
    assert len(fused) == len(dkv) == 1 and not fused & dkv
    assert len(autotune.variant_keys(autotune.candidates("fused", 64, BF16) * 2
                                     + autotune.candidates("dkv", 64, BF16))) == 2


_PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fa2_fwd_wgmmaI13__nv_bfloat16S0_Li64EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115fa2_fwd_wgmmaI13__nv_bfloat16S0_Li64EEEvv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112bwd_dq_wgmmaIfLi64EEEvv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_refusals_are_failed_rows_with_reasons():
    assert "8 bytes spill stores" in autotune.ptxas_faults(_PTXAS, "fwd")
    assert autotune.ptxas_faults(_PTXAS, "dq") is None
    log = ("fa2_backward.cu(1191): error: static assertion failed with \"one block "
           "must fit the SM's 227 KB\"\n1 error detected")
    assert autotune.compile_error(log).startswith("nvcc: fa2_backward.cu(1191): error")
    cands = autotune.candidates("fwd", 64, BF16)
    reasons = autotune.reasons_of(cands, {cands[1].key(): _PTXAS},
                                  {cands[2].key(): log})
    assert set(reasons) == {cands[1].key(), cands[2].key()}


def test_a_variant_built_before_keeps_its_ptxas_refusal(tmp_path, monkeypatch):
    """A build writes its compiler log beside the library (here with a
    stand-in for nvcc), and a later process reads the ptxas fault from it:
    a variant that another process built is refused as the builder would
    have refused it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    f"touch \"$2\"\ncat <<'LOG'\n{_PTXAS}LOG\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    cands = autotune.candidates("fwd", 64, BF16)
    key = cands[1].key()
    assert _build.build_log(key) is None
    logs = _build.build(key)
    assert "8 bytes spill stores" in logs[key] and _build.library_path(key).exists()
    assert _build.build_log(key) == logs[key]
    assert _build.build(key) == {}  # built: no new log
    reasons = autotune.reasons_of(cands, {}, {})
    assert set(reasons) == {key} and "8 bytes spill stores" in reasons[key]


def test_sweep_rows_and_winners_on_a_fake_timer(capsys):
    """On CPU tensors: every candidate a row (JSON, sorted fastest first),
    a refused variant and the fixed 64-KV-row row last with their reasons
    and ms inf, the shipped tiles' output the reference (max_abs_diff 0 for
    one function)."""
    cands = autotune.candidates("fused", 64, BF16)  # shipped, 64 KV rows, a variant
    refused = {cands[2].key(): "nvcc: static assertion failed"}
    times = iter([3.0, 1.0])
    rows = autotune.sweep("fused", b=1, h=2, s=256, d=64, tile=BF16, causal=True,
                          device="cpu", timer=lambda fn, iters: next(times),
                          reasons={})
    assert [r["ms"] for r in rows] == [1.0, 3.0, math.inf]
    assert rows[-1]["error"] == cands[1].refused and rows[-1]["block_k"] == 64
    ok = [r for r in rows if "error" not in r]
    assert all(r["max_abs_diff"] == 0.0 and r["tile"] == "bf16" for r in ok)
    assert {(r["block_q"], r["block_k"]) for r in rows} == {
        (c.block_q, c.block_k) for c in cands}
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(printed) == len(rows)
    best = rows[0]
    assert autotune.winners_line(best, "bf16").startswith(
        f"## BEST fused S=256 tile=bf16 causal=True: bq={best['block_q']}")
    flops = 4 * 2 * 256 * 256 * 64 / 2 * 2.5
    assert best["tflops"] == pytest.approx(flops / best["ms"] / 1e9)
    rows_refused = autotune.sweep("fused", b=1, h=2, s=256, d=64, tile=BF16,
                                  device="cpu", timer=lambda fn, iters: 1.0,
                                  reasons=refused)
    assert [r.get("error") for r in rows_refused] == [
        None, cands[1].refused, refused[cands[2].key()]]


def test_sweep_rows_of_the_fp32_body_and_a_reference():
    rows = autotune.sweep("fwd", b=1, h=2, s=128, d=64, tile=None, device="cpu",
                          timer=lambda fn, iters: 1.0,
                          reference=lambda q, k, v, do, stats, common: torch.zeros(1))
    (row,) = rows
    assert (row["block_q"], row["block_k"], row["stages"], row["tile"]) == (64, 64, None,
                                                                            "fp32")
    assert row["max_abs_diff"] > 0 and row["rel_diff"] == math.inf


def test_a_launch_error_is_a_row_or_with_strict_raises():
    """A variant that built but whose launch raises: a failed row with the
    exception, or, strict (chip_smoke's phase 35), the exception itself;
    a refused build stays a row either way."""
    cands = autotune.candidates("fwd", 64, BF16)
    reasons = {cands[3].key(): "nvcc: error: static assertion failed"}
    calls = iter(range(10))

    def timer(fn, iters):
        if next(calls) == 1:
            raise RuntimeError("fa2_forward: too many resources requested")
        return 1.0

    rows = autotune.sweep("fwd", b=1, h=2, s=128, d=64, tile=BF16, device="cpu",
                          timer=timer, reasons=reasons)
    errors = [r["error"] for r in rows if "error" in r]
    assert errors == ["RuntimeError: fa2_forward: too many resources requested",
                      reasons[cands[3].key()]]
    calls = iter(range(10))
    with pytest.raises(RuntimeError, match="too many resources"):
        autotune.sweep("fwd", b=1, h=2, s=128, d=64, tile=BF16, device="cpu",
                       timer=timer, reasons=reasons, strict=True)
    rows = autotune.sweep("fwd", b=1, h=2, s=128, d=64, tile=BF16, device="cpu",
                          timer=lambda fn, iters: 1.0, reasons=reasons, strict=True)
    assert [r["error"] for r in rows if "error" in r] == [reasons[cands[3].key()]]


def test_main_needs_the_card():
    with pytest.raises(SystemExit, match="card"):
        autotune.main(["--kernels", "fwd"])


def _rows():
    """Harness rows: two forward configs of three kernels and a seqlen
    sweep, one FAIL row (dropped by both plots)."""
    out = []
    for i, (name, s) in enumerate([("Small-1", 128), ("Large-2", 1024),
                                   ("SeqLen-S256-FA2", 256), ("SeqLen-S128-FA2", 128),
                                   ("SeqLen-S128-FA2-NAIVE", 128)]):
        for j, kernel in enumerate(["fa2", "fa2-naive", "vanilla-attn"]):
            cfg = configs.TestConfig(name, 1, 2, s, 64, kernel_type=kernel)
            r = harness.TestResult(cfg, "forward", passed=(i, j) != (1, 2),
                                   kernel_time_ms=1.0 + i + 0.1 * j, speedup=2.0 + j,
                                   tflops=10.0 * (i + 1) + j, bandwidth_gbps=100.0 + i)
            out.append(r.as_row())
    return out


def test_plots_write_the_jax_files_and_plot_the_rows(tmp_path):
    rows = _rows()
    got = plots.generate_plots(rows, str(tmp_path / "port"), prefix="backward_")
    want = jax_plots.generate_plots(pd.DataFrame(rows), str(tmp_path / "jax"),
                                    prefix="backward_")
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == [
        "backward_kernel_comparison.png", "backward_seqlen_scaling.png"]
    tests, series = plots.comparison_series(rows)
    ok = [r for r in rows if r["Status"] == "PASS"]
    assert tests == list(dict.fromkeys(r["Test"] for r in ok))
    for col, _, _ in plots.METRICS:
        for kern, points in series[col].items():
            assert [(tests[i], v) for i, v in points] == [
                (r["Test"], r[col]) for r in ok if r["Kernel"] == kern]
    curves = plots.seqlen_series(rows)
    fa2 = sorted((r for r in ok if r["Test"].startswith("SeqLen-") and r["Kernel"] == "FA2"),
                 key=lambda r: r["SeqLen"])
    assert curves["FA2"] == ([r["SeqLen"] for r in fa2], [r["KernelTime_ms"] for r in fa2],
                             [r["TFLOPS"] for r in fa2])


def test_no_pass_row_draws_nothing(tmp_path):
    rows = [dict(r, Status="FAIL") for r in _rows()]
    assert plots.generate_plots(rows, str(tmp_path)) == []


def test_save_plots_says_why_without_matplotlib(monkeypatch, capsys, tmp_path):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert bench_main.save_plots(_rows(), str(tmp_path), "") == []
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["Plots not drawn: matplotlib does not import "
                   "(No module named 'matplotlib')"]


def test_save_results_on_the_cpu_writes_the_csv_and_no_plot(tmp_path, capsys):
    """A CPU run takes no device times: the CSV is written, and one line
    says that no plot was drawn."""
    with pytest.raises(SystemExit) as done:
        bench_main.main(["--device", "cpu", "--configs", "Small-1", "--save-results",
                         "--output-dir", str(tmp_path), "--no-oracle-timing"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "Plots not drawn: a CPU run takes no device times" in out
    assert (tmp_path / "experiment_results.csv").exists()
    assert not list(tmp_path.glob("*.png"))


def test_unmeasured_values_draw_no_bar(tmp_path):
    rows = [dict(r, Speedup=float("nan")) if r["Kernel"] == "FA2" else r for r in _rows()]
    _, series = plots.comparison_series(rows)
    assert series["Speedup"]["FA2"] == [] and series["Speedup"]["FA2-NAIVE"]
    assert len(plots.generate_plots(rows, str(tmp_path))) == 2
