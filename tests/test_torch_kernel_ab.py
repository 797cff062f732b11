"""The case lists of scripts/kernel_ab.py (B2 and B9 against an earlier
build of their sources): each B2 case pads as the API pads and matches a row
that chip_smoke.py holds and times, each B9 case is one of the reference
suite's configs in chip_smoke.py, and the FLOPs and bounds count what the
script says.  CPU only: no kernel runs here."""

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
