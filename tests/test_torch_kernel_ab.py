"""The case lists of scripts/kernel_ab.py (B2, B9, B10 and B1's fp32 body
against an earlier build of their sources): each B2 case pads as the API
pads and matches a row that chip_smoke.py holds and times, each B9 and B10
case is one of the reference suite's configs in chip_smoke.py, each B1 fp32
case one of chip_smoke's B1 shapes in fp32, the FLOPs and bounds count
what the script says, and each kernel's current wrapper takes its problem
as the script calls it.  CPU only: no kernel runs here."""

import pytest
import torch

import chip_smoke
from cuda_flash_attention_tpu_torch.scripts import b1_ab, kernel_ab


@pytest.mark.parametrize("case", kernel_ab.B2_CASES, ids=lambda c: c["name"])
def test_b2_cases_pad_as_the_api_does(case):
    small = dict(case, b=1, hq=case["hq"] // case["hkv"], hkv=1, s=min(case["s"], 200))
    (q, k, v, o, do, lse), kw, raw = kernel_ab.b2_problem(
        small, torch.Generator().manual_seed(0))
    assert q.shape[2] >= small["s"] and q.shape[2] % 16 == 0
    assert kw["kv_len"] == small["s"] and k.shape == v.shape
    assert o.shape == q.shape == do.shape and lse.shape == q.shape[:3]
    assert q.dtype == b1_ab.dtype_of(case["dtype"])
    assert kw["tile_dtype"] == b1_ab.dtype_of(case["tile"])
    assert [t.shape[2] for t in raw] == [small["s"]] * 4


def test_b2_cases_are_chip_smokes_rows():
    """The train shape at D 64 and 128 and the ragged S1000 (phase 7, bf16),
    the fp16 tiles on fp32 inputs at the train shape and Stress-1 (phase
    16)."""
    names = {c["name"]: c for c in kernel_ab.B2_CASES}
    train = names["train"]
    assert (train["b"], train["hq"], train["hkv"], train["s"], train["d"],
            train["causal"]) == (4, 16, 8, 2048, 64, True)
    assert names["train D128"]["d"] == 128
    assert (names["ragged S1000"]["b"], names["ragged S1000"]["s"]) == (2, 1000)
    stress = names["Stress-1 fp16 tiles"]
    assert (stress["b"], stress["hq"], stress["s"]) == chip_smoke.SUITE["Stress-1"]
    assert not stress["causal"] and stress["hkv"] == stress["hq"]
    for name in ("train fp16 tiles", "Stress-1 fp16 tiles"):
        assert (names[name]["dtype"], names[name]["tile"]) == ("fp32", "fp16")


def test_b9_cases_are_the_suites_configs():
    for case in kernel_ab.B9_CASES:
        assert (case["b"], case["hq"], case["s"]) == chip_smoke.SUITE[case["name"]]
        assert (case["d"], case["causal"], case["dtype"], case["tile"]) == \
            (64, False, "fp32", None)
        (q, k, v), kw, _ = kernel_ab.b9_problem(
            dict(case, b=1, hq=1, hkv=1, s=64), torch.Generator().manual_seed(0))
        assert kw == dict(sm_scale=0.125, kv_len=64)


def test_flops_and_bounds():
    """B2 does five S x S x D products per attending pair, B9 two; at the
    train shape and Stress-1 both are bound by operations."""
    train = kernel_ab.B2_CASES[0]
    pairs = 2048 * 2049 // 2
    assert kernel_ab.flops("b2", train) == 5 * 2 * 4 * 16 * pairs * 64
    raw = [torch.empty(4, 16, 2048, 64, dtype=torch.bfloat16),
           torch.empty(4, 8, 2048, 64, dtype=torch.bfloat16)]
    ms, by = kernel_ab.bound("b2", train, raw)
    assert by == "operations" and ms == pytest.approx(
        kernel_ab.flops("b2", train) / 989e12 * 1e3)
    stress = kernel_ab.B9_CASES[-1]
    assert kernel_ab.flops("b9", stress) == 4 * 8 * 16 * 2048 * 2048 * 64
    raw = [torch.empty(8, 16, 2048, 64)] * 3
    ms, by = kernel_ab.bound("b9", stress, raw)
    assert by == "operations" and ms == pytest.approx(2.0512, rel=1e-3)


def test_b10_cases_are_the_suites_configs_and_stress_1_at_d128():
    *suite, d128 = kernel_ab.B10_CASES
    assert suite == kernel_ab.B9_CASES
    assert d128 == dict(kernel_ab.B9_CASES[-1], name="Stress-1 D128", d=128)
    (q, k, v), kw, _ = kernel_ab.problem(
        "b10", dict(d128, b=1, hq=1, hkv=1, s=64), torch.Generator().manual_seed(0))
    assert q.shape == (1, 1, 64, 128) and kw == dict(sm_scale=128 ** -0.5, kv_len=64)


def test_b1_fp32_cases_are_chip_smokes_shapes():
    """Stress-1 as phase 16 runs it (not causal, Hq = Hkv), b1_ab's fp32
    row of phase 2, and the train shape in fp32 at D 64 and 128; all with
    fp32 inputs on the FMA body (no tile type)."""
    names = {c["name"]: c for c in kernel_ab.B1_FP32_CASES}
    assert list(names) == ["Stress-1", "fp32 B1 S512", "train fp32", "train D128 fp32"]
    for c in names.values():
        assert (c["dtype"], c["tile"]) == ("fp32", None) and c["sq"] == c["skv"] == c["s"]
    stress = names["Stress-1"]
    assert (stress["b"], stress["hq"], stress["s"]) == chip_smoke.SUITE["Stress-1"]
    assert stress["hkv"] == stress["hq"] and not stress["causal"] and stress["d"] == 64
    b1 = {c["name"]: c for c in b1_ab.CASES}
    assert dict(names["fp32 B1 S512"], s=None) == dict(b1["fp32 B1 S512"], s=None)
    for name, d in (("train fp32", 64), ("train D128 fp32", 128)):
        c = names[name]
        assert (c["b"], c["hq"], c["hkv"], c["s"], c["d"], c["causal"]) == \
            (4, 16, 8, 2048, d, True)


def test_b1_fp32_problem_pads_as_the_api_does():
    case = dict(kernel_ab.B1_FP32_CASES[2], b=1, hq=4, hkv=2, sq=100, skv=100, s=100)
    (q, k, v), kw, raw = kernel_ab.problem("b1-fp32", case, torch.Generator().manual_seed(0))
    assert q.dtype == torch.float32 and q.shape[2] == k.shape[2] >= 100
    assert k.shape == v.shape and k.shape[1] == 2 and raw == (q, k, v)
    assert kw == dict(causal=True, sm_scale=0.125, kv_len=100, tile_dtype=None)


def test_b10_and_b1_fp32_flops_and_bounds():
    """Two S x S x D products per attending pair; Stress-1 is bound by fp32
    operations at 2.051 ms for both; the causal train shape counts the
    pairs on and below the diagonal, and B1's bytes count lse."""
    stress = kernel_ab.B10_CASES[2]
    assert kernel_ab.flops("b10", stress) == 4 * 8 * 16 * 2048 * 2048 * 64
    raw = [torch.empty(8, 16, 2048, 64)] * 3
    for kernel, case in (("b10", stress), ("b1-fp32", kernel_ab.B1_FP32_CASES[0])):
        ms, by = kernel_ab.bound(kernel, case, raw)
        assert by == "operations" and ms == pytest.approx(2.0512, rel=1e-3)
    train = kernel_ab.B1_FP32_CASES[2]
    assert kernel_ab.flops("b1-fp32", train) == 4 * 4 * 16 * (2048 * 2049 // 2) * 64
    raw = [torch.empty(4, 16, 2048, 64), torch.empty(4, 8, 2048, 64)]
    ms, by = kernel_ab.bound("b1-fp32", train, raw)
    assert by == "operations" and ms == pytest.approx(
        kernel_ab.flops("b1-fp32", train) / 67e12 * 1e3)
    small = dict(kernel_ab.B1_FP32_CASES[0], b=1, hq=1, hkv=1, s=64)
    raw = [torch.empty(1, 1, 64, 64)] * 3
    ms, by = kernel_ab.bound("b1-fp32", small, raw)
    moved = 2 * 64 * 64 * 4 + 2 * 64 * 64 * 4 + 64 * 4  # q, o; k, v; lse
    assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)


@pytest.mark.parametrize("kernel", list(kernel_ab.CASES))
def test_current_wrapper_takes_the_problem_as_kernel_ab_calls_it(kernel):
    """Each kernel's current wrapper, called as kernel_ab calls it, takes
    the problem's inputs and keywords (on CPU tensors its plain version
    runs) and returns a tuple whose first output has q's shape."""
    case = kernel_ab.CASES[kernel][0]
    groups = case["hq"] // case.get("hkv", case["hq"])
    small = dict(case, b=1, hq=groups, hkv=1, s=64, sq=64, skv=64)
    x, kw, raw = kernel_ab.problem(kernel, small, torch.Generator().manual_seed(0))
    _, current = kernel_ab.calls(kernel)
    out = current(*x, **kw)
    assert isinstance(out, tuple) and out[0].shape == x[0].shape
    assert torch.isfinite(out[0]).all() and raw[0].shape[2] == 64
