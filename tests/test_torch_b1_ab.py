"""The B1 case list that chip_smoke.py's phase 2 and scripts/b1_ab.py share:
each case pads as the API pads, reaches the edge of B1's 128-row tiles that
it names, and counts the FLOPs of the pairs that attend.  CPU only: no
kernel runs here."""

import pytest
import torch

from cuda_flash_attention_tpu_torch.kernels.common import build_element_mask
from cuda_flash_attention_tpu_torch.scripts import b1_ab


@pytest.mark.parametrize("sq,kv_len,causal", [
    (128, 128, True), (300, 100, True), (128, 384, True), (1000, 1000, False),
    (16, 16, True), (300, 100, False),
])
def test_attended_pairs_counts_the_mask(sq, kv_len, causal):
    pad = -(-kv_len // 16) * 16
    mask = build_element_mask(sq, pad, causal=causal, kv_len=kv_len, device="cpu")
    want = sq * pad if mask is None else int(mask.expand(sq, pad).sum())
    assert b1_ab.attended_pairs(sq, kv_len, causal) == want


@pytest.mark.parametrize("case", b1_ab.CASES + [b1_ab.STRESS1_FP16, b1_ab.X_SHAPE],
                         ids=lambda c: c["name"])
def test_cases_pad_as_the_api_does(case):
    small = dict(case, b=1, hq=case["hq"] // case["hkv"], hkv=1)
    q, k, v, kw, flops = b1_ab.problem(small, torch.Generator().manual_seed(0))
    assert q.shape[2] >= case["sq"] and k.shape[2] >= case["skv"]
    assert kw["kv_len"] == case["skv"] and v.shape == k.shape
    assert q.dtype == b1_ab.dtype_of(case["dtype"])
    assert flops == 4 * small["hq"] * case["d"] * b1_ab.attended_pairs(
        case["sq"], case["skv"], case["causal"])


def test_cases_reach_the_tile_edges():
    """The rows phase 2 holds B1 to: Sq > Skv and Sq < Skv, sequences
    shorter than one 128-row box, kv_len inside the last box, GQA 16/2,
    D 128 and fp16 tiles on bf16 inputs."""
    names = {c["name"]: c for c in b1_ab.CASES}
    assert names["Sq300 Skv100"]["sq"] > names["Sq300 Skv100"]["skv"]
    assert names["Sq128 Skv384"]["sq"] < names["Sq128 Skv384"]["skv"]
    assert names["S16"]["skv"] < 128 and names["S112"]["skv"] < 128
    assert names["kv_len 1000 of 1024"]["skv"] % 128 != 0
    assert names["GQA 16/2"]["hq"] // names["GQA 16/2"]["hkv"] == 8
    assert names["train D128"]["d"] == 128
    assert (names["train fp16 tiles"]["dtype"], names["train fp16 tiles"]["tile"]) \
        == ("bf16", "fp16")


@pytest.mark.parametrize("name", ["device_benchmark", "queued_device_benchmark"])
def test_device_timers_refuse_a_machine_without_a_card(name):
    """b1_ab's and chip_smoke's timers time the card: without one they
    raise rather than time the CPU."""
    from cuda_flash_attention_tpu_torch.utils import timing

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        getattr(timing, name)(lambda: None)
