"""The case lists of scripts/kernel_ab.py (B2, B3, B4, the pair B3 + B4
and their fp32 bodies, B9, B10, B1's fp32 body, B8 and B5 against an
earlier build of their sources): each
B2 case pads as the API pads and matches a row that chip_smoke.py holds and
times, the split cases add the shapes the route rule sends to the pair,
each B9 and B10 case is one of the reference suite's configs in
chip_smoke.py, each B1 fp32 case one of chip_smoke's B1 shapes in fp32, the
fp32 backward cases are fp32_bwd's and chip_smoke's shapes with fp32_bwd's
bounds, the B8 cases are phase 16's rows padded as the API pads, the B5
cases hold phase 3's shape, the B6 cases phase 12's, the B7 cases phase
19's and the X cases the probe's, with chip_smoke's bounds (attention_bound, paged_bound), the FLOPs
and bounds count what the script says, each kernel's current wrapper takes
its problem as the script calls it, and the parent wrappers of B2, B3 and
B4 call the C entry points with the arguments their argtypes declare, as do
B5's, B6's, B7's, B8's and X's (a fake library stands in for the build);
the head-dim 32 and 256 cases hold phase 29's and 30's shapes and build a
parent at each head dim.  CPU only: no kernel runs here."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes, seq_pad_quantum
from cuda_flash_attention_tpu_torch.scripts import b1_ab, fp32_bwd, kernel_ab


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
    first = x[1] if kernel_ab.backward_of(kernel) == "b4" else x[0]  # B4's: dK
    assert isinstance(out, tuple) and out[0].shape == first.shape
    # raw[0] is q: [B, H, S, D] (S 64; B7's padded to the 128 block grid),
    # or B5's [n, Hq, D] and B6's [n, T, Hq, D] (the case's D).
    base = kernel_ab.backward_of(kernel)
    want = 128 if base == "b7" else case["d"] if base in ("b5", "b6") else 64
    assert torch.isfinite(out[0]).all() and raw[0].shape[-1 if base == "b6" else 2] == want


@pytest.mark.parametrize("case", kernel_ab.SPLIT_CASES, ids=lambda c: c["name"])
def test_split_cases_pad_as_the_api_does(case):
    """B3's and B4's problem is B2's with D_i = rowsum(dO * O) in fp32 in
    place of O; the pair takes B2's."""
    small = dict(case, b=1, hq=case["hq"] // case["hkv"], hkv=1, s=min(case["s"], 200))
    gen = torch.Generator().manual_seed(0)
    (q, k, v, do, lse, di), kw, raw = kernel_ab.problem("b3", small, gen)
    o = kernel_ab.problem("b2", small, torch.Generator().manual_seed(0))[0][3]
    assert torch.equal(di, (o.float() * do.float()).sum(-1))
    assert di.dtype == lse.dtype == torch.float32 and di.shape == q.shape[:3]
    assert q.dtype == b1_ab.dtype_of(case["dtype"])
    assert kw["tile_dtype"] == b1_ab.dtype_of(case["tile"])
    assert [t.shape[2] for t in raw] == [small["s"]] * 4


def test_split_cases_are_b2s_rows_and_the_split_routes_shapes():
    """B2's five rows, phase 11's B16 S2048 and the long-context B1 Hq16
    S8192; the last two are the shapes that the route rule sends to the
    pair at the default blocks (their dQ slices pass 1 GiB)."""
    names = {c["name"]: c for c in kernel_ab.SPLIT_CASES}
    assert all(names[c["name"]] == c for c in kernel_ab.B2_CASES)
    assert list(names) == ["train", "train D128", "ragged S1000", "B16 S2048",
                           "train fp16 tiles", "Stress-1 fp16 tiles", "long B1 S8192"]
    for name, b, s in (("B16 S2048", 16, 2048), ("long B1 S8192", 1, 8192)):
        c = names[name]
        assert (c["b"], c["hq"], c["hkv"], c["s"], c["d"], c["causal"],
                c["dtype"], c["tile"]) == (b, 16, 8, s, 64, True, "bf16", "bf16")
        q = types.SimpleNamespace(shape=(b, 16, s, 64), dtype=torch.bfloat16)
        k = types.SimpleNamespace(shape=(b, 8, s, 64), dtype=torch.bfloat16)
        bk = BlockSizes.default(True).block_k_dkv
        assert not attention._use_fused_bwd(q, k, min(bk, s), torch.bfloat16)
    assert kernel_ab.CASES["b3"] is kernel_ab.CASES["b4"] is kernel_ab.CASES["b3-b4"]


def test_split_flops_and_bounds():
    """B3 does three S x S x D products per attending pair, B4 four; the
    pair is bounded by the function's own five and bytes, as B2; at the
    train shape all are bound by operations, and only the pair has a
    library call."""
    train = kernel_ab.SPLIT_CASES[0]
    pairs = 2048 * 2049 // 2
    unit = 2 * 4 * 16 * pairs * 64
    raw = [torch.empty(4, 16, 2048, 64, dtype=torch.bfloat16),
           torch.empty(4, 8, 2048, 64, dtype=torch.bfloat16)]
    for kernel, n in (("b3", 3), ("b4", 4), ("b3-b4", 5)):
        assert kernel_ab.flops(kernel, train) == n * unit
        ms, by = kernel_ab.bound(kernel, train, raw)
        assert by == "operations" and ms == pytest.approx(n * unit / 989e12 * 1e3)
    assert kernel_ab.bound("b3-b4", train, raw) == kernel_ab.bound("b2", train, raw)
    # Bytes at a small shape: B3 reads q, k, v, dO, lse, D_i and writes
    # dQ; B4 writes dK and dV instead; the pair moves B2's.
    small = dict(train, b=1, hq=2, hkv=1, s=64)
    raw = [torch.empty(1, 2, 64, 64, dtype=torch.bfloat16),
           torch.empty(1, 1, 64, 64, dtype=torch.bfloat16)]
    qb, kvb, stat = 2 * 64 * 64 * 2, 2 * 64 * 64 * 2, 2 * 64 * 4
    for kernel, moved in (("b3", 3 * qb + kvb + 2 * stat),
                          ("b4", 2 * qb + 2 * kvb + 2 * stat),
                          ("b3-b4", 4 * qb + 2 * kvb + stat)):
        ms, by = kernel_ab.bound(kernel, small, raw)
        assert by == "bytes" and ms == pytest.approx(moved / 3.35e12 * 1e3)
    for kernel in ("b3", "b4"):
        assert kernel_ab.library_call(kernel, train, raw, {}) is None


def test_pair_runs_the_split_branch_of_attention_backward():
    """kernel_ab's current b3-b4 call gives, bit for bit, what
    attention._backward gives on the split route (plain versions on CPU
    tensors), from the same inputs."""
    case = dict(kernel_ab.SPLIT_CASES[0], b=1, hq=4, hkv=2, s=200)
    (q, k, v, o, do, lse), kw, _ = kernel_ab.problem(
        "b3-b4", case, torch.Generator().manual_seed(3))
    _, pair = kernel_ab.calls("b3-b4")
    got = pair(q, k, v, o, do, lse, **kw)
    split = BlockSizes(128, 128, 128, 128, 128, 128)
    want = attention._backward(q, k, v, o, lse, do, kw["kv_len"], kw["causal"],
                               kw["sm_scale"], split, kw["tile_dtype"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


_C_TYPES = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


def _c_signature(name: str, source: str = "fa2_backward.cu") -> list[str]:
    """The ctypes names of an extern "C" function's parameters in
    csrc/<source>."""
    src = (Path(fa2_backward.__file__).parent.parent / "csrc" / source).read_text()
    params = re.search(rf"\b{name}\(([^)]*)\)\s*{{", src).group(1)
    out = []
    for p in params.split(","):
        p = p.replace("const ", "").split()
        out.append(_C_TYPES["void*" if "*" in "".join(p) else p[0]])
    return out


@pytest.mark.parametrize("name", list(fa2_backward.ARGTYPES))
def test_wrapper_argtypes_match_the_c_entry_points(name):
    assert [t.__name__ for t in fa2_backward.ARGTYPES[name]] == _c_signature(name)


class _Entry:
    """One entry point of _FakeLib: records its arguments, returns 0."""

    argtypes = restype = None

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _FakeLib:
    """Stands in for a built fa2_backward library: records each call.  Of
    kind "current" it exports every current entry point (with
    cfa_fa2_backward_masks), of kind "workspace" those of 193d270 to
    2e67868 (a workspace, no masks), of kind "no workspace" only B3's and B4's as they
    were before they took a workspace (eb3d034)."""

    def __init__(self, kind):
        self.calls = []
        names = (list(fa2_backward.ARGTYPES) if kind != "no workspace" else
                 ["cfa_fa2_backward_dq", "cfa_fa2_backward_dkv"])
        if kind == "current":
            names.append("cfa_fa2_backward_masks")
        for name in names:
            setattr(self, name, _Entry(name, self.calls))


@pytest.mark.parametrize("kind", ["no workspace", "workspace", "current"])
def test_parent_split_wrappers_call_as_their_argtypes_declare(monkeypatch, kind):
    """build_parent gives B3's and B4's entry points the parent's own
    argtypes: without cfa_fa2_backward_workspace eb3d034's (no workspace),
    with it 193d270-2e67868's (kernel_ab.WORKSPACE_ARGTYPES), with
    cfa_fa2_backward_masks too the current wrappers' (fa2_backward.ARGTYPES);
    the parent wrappers then pass exactly that many arguments, the
    workspace and the masks where the source takes them."""
    lib = _FakeLib(kind)
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("b3-b4", "unused.cu") is lib
    for name in ("cfa_fa2_backward_dq", "cfa_fa2_backward_dkv"):
        argtypes = getattr(lib, name).argtypes
        if kind == "current":
            assert argtypes == fa2_backward.ARGTYPES[name]
        elif kind == "workspace":
            assert argtypes == kernel_ab.WORKSPACE_ARGTYPES[name]
        else:  # eb3d034's: no workspace pointer before the stream
            assert len(argtypes) == 20
            assert argtypes == kernel_ab.WORKSPACE_ARGTYPES[name][:-2] + [fa2_backward._P]
    cases = kernel_ab.MASKED_CASES if kind == "current" else kernel_ab.SPLIT_CASES
    case = dict(cases[-1 if kind == "current" else 0], b=1, hq=2, hkv=1, s=64)
    x, kw, _ = kernel_ab.problem("b3-b4", case, torch.Generator().manual_seed(0))
    out = kernel_ab.parent_pair(lib, *x, **kw)
    assert [t.shape for t in out] == [x[0].shape, x[1].shape, x[2].shape]
    calls = [(n, a) for n, a in lib.calls if n != "cfa_fa2_backward_workspace"]
    assert [n for n, _ in calls] == ["cfa_fa2_backward_dq", "cfa_fa2_backward_dkv"]
    for name, args in lib.calls:
        assert len(args) == len(getattr(lib, name).argtypes), name


FP32_KERNELS = ("b2-fp32", "b3-fp32", "b4-fp32", "b3-b4-fp32")


def test_fp32_bwd_cases_are_fp32_bwds_and_chip_smokes_shapes():
    """The harness's fp32 routes (fp32_bwd.SHAPES: Large-2, Stress-1; D 64,
    not causal, Hq = Hkv), phase 7's fp32 B1 S512 (b1_ab's, GQA 16/8,
    causal) and the train shape in fp32 at D 64 and 128; fp32 inputs on
    the FMA bodies (no tile type) for all four fp32 kernels."""
    cases = kernel_ab.FP32_BWD_CASES
    assert [c["name"] for c in cases] == ["Large-2", "Stress-1", "fp32 B1 S512",
                                          "train fp32", "train D128 fp32"]
    for kernel in FP32_KERNELS:
        assert kernel_ab.CASES[kernel] is cases
    for c in cases:
        assert (c["dtype"], c["tile"]) == ("fp32", None)
    for c in cases[:2]:
        assert (c["b"], c["hq"], c["s"]) == fp32_bwd.SHAPES[c["name"]] == \
            chip_smoke.SUITE[c["name"]]
        assert c["hkv"] == c["hq"] and c["d"] == 64 and not c["causal"]
    b1 = next(c for c in b1_ab.CASES if c["name"] == "fp32 B1 S512")
    s512 = cases[2]
    assert (s512["b"], s512["hq"], s512["hkv"], s512["s"], s512["d"], s512["causal"]) \
        == (b1["b"], b1["hq"], b1["hkv"], b1["sq"], b1["d"], b1["causal"]) \
        == (1, 16, 8, 512, 64, True)
    for c, d in zip(cases[3:], (64, 128)):
        assert (c["b"], c["hq"], c["hkv"], c["s"], c["d"], c["causal"]) == \
            (4, 16, 8, 2048, d, True)


@pytest.mark.parametrize("case", kernel_ab.FP32_BWD_CASES, ids=lambda c: c["name"])
@pytest.mark.parametrize("kernel", FP32_KERNELS)
def test_fp32_bwd_cases_pad_as_the_api_does(kernel, case):
    """Each fp32 kernel takes its tile-type form's problem in fp32 with no
    tile type: B3's and B4's with D_i = rowsum(dO * O), B2's and the
    pair's with O; padded as the API pads."""
    small = dict(case, b=1, hq=case["hq"] // case["hkv"], hkv=1, s=min(case["s"], 100))
    x, kw, raw = kernel_ab.problem(kernel, small, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in x)
    assert kw["tile_dtype"] is None and kw["kv_len"] == small["s"]
    pad = seq_pad_quantum(small["s"], torch.float32)
    assert x[0].shape[2] == x[1].shape[2] == -(-small["s"] // pad) * pad
    assert len(x) == 6 and x[-1].shape == x[0].shape[:3]  # lse or D_i
    assert [t.shape[2] for t in raw] == [small["s"]] * 4


def test_fp32_bwd_flops_and_bounds_are_fp32_bwds():
    """At Large-2 and Stress-1 each fp32 kernel's FLOPs and bound are
    fp32_bwd's (B2 five products a pair, B3 three, B4 four; all bound by
    fp32 operations at 67 TFLOP/s); the pair is bounded as B2; only B2 and
    the pair have a library call."""
    names = {"b2-fp32": "fa2_backward_fused", "b3-fp32": "fa2_backward_dq",
             "b4-fp32": "fa2_backward_dkv"}
    for case in kernel_ab.FP32_BWD_CASES[:2]:
        b, h, s = fp32_bwd.SHAPES[case["name"]]
        raw = [torch.empty(b, h, s, 64)] * 4
        for kernel, name in names.items():
            n = fp32_bwd._MATMULS[name]
            assert kernel_ab.flops(kernel, case) == n * 2 * b * h * s * s * 64
            ms, by = kernel_ab.bound(kernel, case, raw)
            want_ms, want_by = fp32_bwd.bound(name, b, h, s)
            assert by == want_by == "operations" and ms == pytest.approx(want_ms)
        assert kernel_ab.bound("b3-b4-fp32", case, raw) == kernel_ab.bound("b2-fp32", case, raw)
        for kernel in ("b3-fp32", "b4-fp32"):
            assert kernel_ab.library_call(kernel, case, raw, {}) is None


@pytest.mark.parametrize("kind", ["workspace", "current"])
def test_parent_b2_with_a_workspace_runs_its_dq_reduce(monkeypatch, kind):
    """A parent B2 source exporting cfa_fa2_backward_workspace is called as
    the wrapper of its interface calls it: the workspace's size, the kernel
    with a workspace pointer (and, current, the window, sinks and ids),
    then the ordered dQ reduce, each with exactly the arguments its
    argtypes declare."""
    lib = _FakeLib(kind)
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("b2-fp32", "unused.cu") is lib
    case = dict(kernel_ab.FP32_BWD_CASES[0], b=1, hq=2, hkv=1, s=64)
    if kind == "current":
        case = dict(case, causal=True, window=16, sinks=4)
    x, kw, _ = kernel_ab.problem("b2-fp32", case, torch.Generator().manual_seed(0))
    out = kernel_ab.parent_b2(lib, *x, **kw)
    assert [t.shape for t in out] == [x[0].shape, x[1].shape, x[2].shape]
    assert [n for n, _ in lib.calls] == ["cfa_fa2_backward_workspace",
                                         "cfa_fa2_backward_fused",
                                         "cfa_fa2_backward_dq_reduce"]
    want = fa2_backward.ARGTYPES if kind == "current" else kernel_ab.WORKSPACE_ARGTYPES
    for name, args in lib.calls:
        assert len(args) == len(getattr(lib, name).argtypes) == len(want[name]), name
    if kind == "current":  # the window and sinks follow the causal flag
        fused = dict(lib.calls)["cfa_fa2_backward_fused"]
        assert fused[17:20] == (1, 16, 4)


def test_wide_cases_are_chip_smokes_phase_29_and_30_shapes():
    """The head-dim 32 and 256 forms of B2, B3, B4 and the pair share one
    case list: phase 29's causal shapes (D 32 at the train shape, D 256 at
    phase 28's B1 Hq8 Hkv4 S4096) in bf16 and in fp16 tiles on fp32
    inputs, and phase 30's Gemma-2 call; problems, bounds and wrappers are
    the unmasked kernels'."""
    cases = kernel_ab.WIDE_BWD_CASES
    assert all(kernel_ab.CASES[k] is cases
               for k in ("b2-wide", "b3-wide", "b4-wide", "b3-b4-wide"))
    assert {c["d"] for c in cases} == set(kernel_ab.WIDE_HEAD_DIMS) == {32, 256}
    b, hq, hkv, s = chip_smoke.WIDE_B1_SHAPES[256]
    assert any((c["b"], c["hq"], c["hkv"], c["s"], c["d"]) == (b, hq, hkv, s, 256)
               for c in cases)
    b, hq, hkv, s = chip_smoke.WIDE_B1_SHAPES[32]
    assert any((c["b"], c["hq"], c["hkv"], c["s"], c["d"]) == (b, hq, hkv, s, 32)
               for c in cases)
    g = chip_smoke.GEMMA2_2B
    assert any((c["hq"], c["hkv"], c["s"], c["d"]) ==
               (g["n_heads"], g["n_kv_heads"], 2048, g["head_dim"]) for c in cases)
    assert all(c["causal"] for c in cases)
    for wide in ("b2-wide", "b3-wide", "b4-wide", "b3-b4-wide"):
        base = wide[:-5]
        assert kernel_ab.backward_of(wide) == base
        assert kernel_ab.flops(wide, cases[2]) == kernel_ab.flops(base, cases[2])


def test_wide_parents_are_built_at_each_head_dim(monkeypatch, tmp_path):
    """A wide parent is its source built once a head dim through a source
    beside it that defines CFA_HEAD_DIMS and includes it (named with the
    parent's digest); the parent wrapper takes the library of q's head
    dim."""
    parent = tmp_path / "fa2_backward.cu"
    parent.write_text("// a parent\n")
    built = {}

    def compile_source(path, stem):
        built[stem] = Path(path).read_text()
        return _FakeLib("current")

    monkeypatch.setattr(b1_ab, "compile_source", compile_source)
    libs = kernel_ab.build_parent("b3-b4-wide", str(parent))
    assert sorted(libs) == [32, 256]
    for d in (32, 256):
        text = built[f"fa2_backward_d{d}_parent"]
        assert f"#define CFA_HEAD_DIMS(X) X({d})" in text
        assert '#include "fa2_backward.cu"' in text
    seen = []
    monkeypatch.setattr(kernel_ab, "parent_b2", lambda lib, q, *a, **k: seen.append(lib))
    parent_fn, _ = kernel_ab.calls("b2-wide")
    parent_fn(libs, torch.empty(1, 1, 1, 256))
    parent_fn(libs, torch.empty(1, 1, 1, 32))
    assert seen == [libs[256], libs[32]]


def test_masked_cases_are_chip_smokes_phase_26_rows():
    """The train shape (B4 Hq16 Hkv8 S2048 causal bf16) with window 128
    (the hybrid's local layers), window 512 and 4 sinks (streaming's), window
    128 at D 128, and 4 packed documents a row; each masked kernel's case
    list, problem, bound and wrappers are its unmasked kernel's."""
    cases = kernel_ab.MASKED_CASES
    assert [(c.get("window"), c.get("sinks", 0), c.get("segments", 0), c["d"])
            for c in cases] == [(128, 0, 0, 64), (512, 4, 0, 64), (128, 0, 0, 128),
                                (None, 0, 4, 64)]
    for c in cases:
        assert (c["b"], c["hq"], c["hkv"], c["s"], c["causal"], c["tile"]) == \
            (4, 16, 8, 2048, True, "bf16")
    for kernel in ("b2", "b3", "b4", "b3-b4"):
        assert kernel_ab.CASES[f"{kernel}-masked"] is cases
        assert kernel_ab.backward_of(f"{kernel}-masked") == kernel


@pytest.mark.parametrize("case", [
    dict(b=2, s=256, causal=True, window=32, sinks=4),
    dict(b=2, s=256, causal=True, segments=3),
    dict(b=1, s=300, causal=False, window=-20),
], ids=str)
def test_masked_pairs_count_the_mask(case):
    """The bound's FLOPs count the (query, key) pairs the mask keeps: the
    window's kept columns row by row, or each document's causal triangle."""
    case = dict(case, hq=2, d=64)
    s = case["s"]
    if case.get("segments"):
        ids = kernel_ab.packed_ids(case["b"], s, case["segments"]).numpy()
        want = sum(int(n) * (int(n) + 1) // 2 for row in ids
                   for n in np.bincount(row))
    else:
        w, sinks = case["window"], case.get("sinks", 0)
        want = case["b"] * sum(chip_smoke.kept_cols(i, s, case["causal"], w, sinks)
                               for i in range(s))
    assert kernel_ab.masked_pairs(case) == want
    assert kernel_ab.flops("b2-masked", case) == 5 * 2 * 2 * want * 64


def test_b8_cases_are_chip_smokes_phase_16_rows():
    """The suite's Small-1, Edge-NonPowerOf2 and Edge-SmallSeq (fp32
    inputs, D 64, Hq = Hkv) in fp32, bf16 and fp16 tiles, causal and not:
    phase 16's 18 rows."""
    cases = kernel_ab.B8_CASES
    assert len(cases) == 18 == len({c["name"] for c in cases})
    assert {(c["config"], c["tile"], c["causal"]) for c in cases} == {
        (cfg, tile, causal) for cfg in ("Small-1", "Edge-NonPowerOf2", "Edge-SmallSeq")
        for tile in (None, "bf16", "fp16") for causal in (False, True)}
    for c in cases:
        assert (c["b"], c["hq"], c["s"]) == chip_smoke.SUITE[c["config"]]
        assert c["hkv"] == c["hq"] and c["d"] == 64 and c["dtype"] == "fp32"


@pytest.mark.parametrize("case", kernel_ab.B8_CASES[::5], ids=lambda c: c["name"])
def test_b8_problem_pads_as_the_api_does_and_takes_b8(case):
    """B8's inputs are padded as attention._prepare pads them (the route
    takes B8), SDPA's are the raw ones in the tile type."""
    small = dict(case, b=1, hq=2, hkv=2)
    (q, k, v), kw, raw = kernel_ab.problem("b8", small, torch.Generator().manual_seed(0))
    assert q.shape == k.shape == v.shape == (1, 2, kernel_ab.b8_padded(case), 64)
    assert attention._use_small_kernel(q, k) and q.dtype == torch.float32
    assert kw["kv_len"] == case["s"] and kw["causal"] == case["causal"]
    assert kw["tile_dtype"] == b1_ab.dtype_of(case["tile"])
    assert [t.shape[2] for t in raw] == [case["s"]] * 3
    assert raw[0].dtype == (b1_ab.dtype_of(case["tile"]) or torch.float32)


def test_b5_cases_hold_phase_3s_shape_and_servings_lengths():
    """Phase 3's four rows (8 slots, Hq16 Hkv8 D64, 16 pages of 128 tokens,
    its ragged lengths with an inactive slot), phase 20's fp8 and int4
    rows, serving's lengths (phase 5's first 8 prompts at their 64th new
    token) and the long D128 case."""
    names = {c["name"]: c for c in kernel_ab.B5_CASES}
    assert len(names) == len(kernel_ab.B5_CASES) == 12
    p3 = [names[f"phase 3 {cache} {compute}"] for cache, compute in (
        ("int8", "bf16"), ("bf16", "bf16"), ("int8", "fp32"), ("bf16", "fp32"))]
    for c in p3 + [names[f"phase 20 {cache} {compute}"] for cache in
                   ("e4m3", "e5m2", "int4") for compute in ("bf16", "fp32")]:
        assert (c["hq"], c["hkv"], c["d"], c["pps"]) == (16, 8, 64, 16)
        assert c["lengths"] == [2048, 1, 129, 0, 777, 1500, 128, 2000]
    prompts = chip_smoke.serving_mix(np, types.SimpleNamespace(vocab_size=32768))
    assert names["serving"]["lengths"] == [len(p) + 64 for p in prompts[:8]]
    long = names["long D128"]
    assert (long["d"], long["pps"], long["lengths"]) == (128, 64, [8192] * 8)


@pytest.mark.parametrize("case", kernel_ab.B8_CASES, ids=lambda c: c["name"])
def test_b8_flops_and_bounds_are_chip_smokes(case):
    s_pad = kernel_ab.b8_padded(case)
    q = torch.empty(case["b"], case["hq"], s_pad, 64)
    lse = torch.empty(case["b"], case["hq"], s_pad)
    kind = case["tile"] or "fp32"
    ms, by, n = chip_smoke.attention_bound(case["b"], case["hq"], case["s"], 64,
                                           case["causal"], kind, q, q, q, q, lse)
    assert kernel_ab.flops("b8", case) == n
    got_ms, got_by = kernel_ab.bound("b8", case, None)
    assert got_by == by and got_ms == pytest.approx(ms)


@pytest.mark.parametrize("case", kernel_ab.B5_CASES, ids=lambda c: c["name"])
def test_b5_flops_and_bounds_are_chip_smokes(case):
    cdt = b1_ab.dtype_of(case["compute"])
    q = torch.empty(len(case["lengths"]), case["hq"], case["d"], dtype=cdt)
    elem = {"int4": 0.5, "bf16": 2, "fp32": 4}.get(case["cache"], 1)
    ms, by, n, _ = chip_smoke.paged_bound(case["lengths"], 1, case["hq"], case["hkv"],
                                          case["d"], elem, q, q, case["compute"])
    assert kernel_ab.flops("b5", case) == n
    got_ms, got_by = kernel_ab.bound("b5", case, None)
    assert got_by == by == "bytes" and got_ms == pytest.approx(ms)
    assert kernel_ab.library_call("b5", case, None, {}) is None


class _RecordingLib:
    """Stands in for a built library exporting `names`: records each call
    and returns 0."""

    def __init__(self, *names):
        self.calls = []
        for name in names:
            setattr(self, name, _Entry(name, self.calls))


@pytest.mark.parametrize("workspace", [False, True], ids=["a0d875a", "split-KV"])
def test_parent_b5_calls_as_its_argtypes_declare(monkeypatch, workspace):
    """build_parent gives B5's entry point the parent's argtypes: a0d875a's
    (no split count, workspace or counters) or, for a source exporting
    cfa_paged_decode_workspace_floats, the current wrapper's; parent_b5
    passes exactly that many arguments."""
    names = ["cfa_paged_decode"] + (["cfa_paged_decode_workspace_floats"]
                                    if workspace else [])
    lib = _RecordingLib(*names)
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("b5", "unused.cu") is lib
    if workspace:
        from cuda_flash_attention_tpu_torch.decode import attention as dec_attn

        monkeypatch.setattr(dec_attn, "_sm_count", lambda index: 132)
        monkeypatch.setattr(dec_attn, "_counters_for",
                            lambda device, n: torch.zeros(n, dtype=torch.int32))
        lib.cfa_paged_decode_workspace_floats = lambda *a: 16
        lib.cfa_paged_decode.argtypes = dec_attn.ARGTYPES["cfa_paged_decode"]
    case = dict(kernel_ab.B5_CASES[0], hq=2, hkv=1, pps=2, lengths=[200, 0])
    x, kw, _ = kernel_ab.problem("b5", case, torch.Generator().manual_seed(0))
    (out,) = kernel_ab.parent_b5(lib, *x, **kw)
    assert out.shape == x[0].shape
    (name, args), = lib.calls
    assert len(args) == len(lib.cfa_paged_decode.argtypes) == (25 if workspace else 20)


# 7af2811's cfa_fa2_forward_small, before windows and segment ids.
_B8_BEFORE_WINDOWS = ("int cfa_fa2_forward_small(const void* q, const void* k, const void* v,"
            " void* o, void* lse, int n_slots, int s_pad, int head_dim,"
            " int kv_len, float qscale, int causal, int in_bf16, int tiles,"
            " void* stream) {")


def _parent_b8_call(monkeypatch, path):
    lib = _RecordingLib("cfa_fa2_forward_small")
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("b8", str(path)) is lib
    case = dict(kernel_ab.B8_CASES[0], b=1, hq=2, hkv=2)
    x, kw, _ = kernel_ab.problem("b8", case, torch.Generator().manual_seed(0))
    o, lse = kernel_ab.parent_b8(lib, *x, **kw)
    assert o.shape == x[0].shape and lse.shape == x[0].shape[:3]
    (name, args), = lib.calls
    return lib, args


def test_parent_b8_calls_as_its_argtypes_declare(monkeypatch, tmp_path):
    """The parent's parameter list is read from its source: 7af2811's
    takes 14 arguments."""
    (tmp_path / "fa2_forward_small.cu").write_text(_B8_BEFORE_WINDOWS)
    lib, args = _parent_b8_call(monkeypatch, tmp_path / "fa2_forward_small.cu")
    assert len(args) == len(lib.cfa_fa2_forward_small.argtypes) == 14


def test_parent_b8_takes_the_current_entry_point(monkeypatch):
    """The current source's entry point (segment ids, heads, window and
    sinks besides 7af2811's) is called with its 19 arguments, no ids and no
    window."""
    path = Path(__file__).resolve().parents[1] / \
        "cuda_flash_attention_tpu_torch/csrc/fa2_forward_small.cu"
    lib, args = _parent_b8_call(monkeypatch, path)
    assert len(args) == len(lib.cfa_fa2_forward_small.argtypes) == 19
    assert args[5:7] == (None, None) and args[14:16] == (1 << 30, 0)


def test_b6_cases_hold_phase_12s_shapes():
    """Phase 12's five rows (8 slots, T 5, Hq16 Hkv8 D64, 16 pages of 128
    tokens, chip_smoke's speculation lengths; T 512 at its prefill
    lengths), phase 20's fp8 and int4 rows, T 1, 2 and 8 at phase 12's
    lengths, the one-page suffix, group 8 at D 128 and the long case."""
    names = {c["name"]: c for c in kernel_ab.B6_CASES}
    assert len(names) == len(kernel_ab.B6_CASES) == 16
    assert kernel_ab.SPEC_LENGTHS == chip_smoke.B6_SPEC_LENGTHS
    assert kernel_ab.PREFILL_LENGTHS == chip_smoke.B6_PREFILL_LENGTHS
    rows = [(c["T"], c["cache"], c["compute"]) for name, c in names.items()
            if name.startswith("phase 12")]
    assert rows == [(5, "int8", "bf16"), (5, "int8", "fp32"), (5, "bf16", "bf16"),
                    (512, "int8", "bf16"), (512, "int8", "fp32")]
    for name, c in names.items():
        if name.startswith("phase"):
            assert (c["hq"], c["hkv"], c["d"], c["pps"]) == (16, 8, 64, 16)
            assert c["lengths"] == (chip_smoke.B6_SPEC_LENGTHS if c["T"] == 5
                                    else chip_smoke.B6_PREFILL_LENGTHS)
    assert [names[f"spec T{t}"]["T"] for t in (1, 2, 8)] == [1, 2, 8]
    assert names["suffix T128"]["T"] == 128
    g8 = names["group 8 D128"]
    assert (g8["hq"] // g8["hkv"], g8["d"], g8["T"]) == (8, 128, 5)
    long = names["long 8 x 8192"]
    assert (long["lengths"], long["pps"], long["T"]) == ([8192] * 8, 64, 5)


@pytest.mark.parametrize("case", kernel_ab.B6_CASES, ids=lambda c: c["name"])
def test_b6_flops_and_bounds_are_chip_smokes(case):
    cdt = b1_ab.dtype_of(case["compute"])
    q = torch.empty(len(case["lengths"]), case["T"], case["hq"], case["d"], dtype=cdt)
    elem = {"int4": 0.5, "bf16": 2, "fp32": 4}.get(case["cache"], 1)
    ms, by, n, _ = chip_smoke.paged_bound(case["lengths"], case["T"], case["hq"],
                                          case["hkv"], case["d"], elem, q, q,
                                          case["compute"])
    assert kernel_ab.flops("b6", case) == n
    got_ms, got_by = kernel_ab.bound("b6", case, None)
    assert got_by == by and got_ms == pytest.approx(ms)
    assert kernel_ab.library_call("b6", case, None, {}) is None


def test_paged_bound_counts_each_rows_columns():
    """Row t of a slot of total length L attends max(0, L - T + t + 1)
    columns: T 8 on a slot of 5 tokens has rows 3-7 at columns 1-5."""
    q = torch.empty(1, 8, 1, 64)
    _, _, n, _ = chip_smoke.paged_bound([5], 8, 1, 1, 64, 1, q, q, "bf16")
    assert n == 4 * 64 * (1 + 2 + 3 + 4 + 5)
    _, _, n, _ = chip_smoke.paged_bound([130, 0], 5, 2, 1, 64, 1, q, q, "bf16")
    assert n == 4 * 64 * 2 * sum(126 + t for t in range(5))


def test_x_cases_are_the_probes_shape():
    from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5

    assert [c["variant"] for c in kernel_ab.X_CASES] == list(r5.VARIANTS)
    for c in kernel_ab.X_CASES:
        assert (c["b"], c["hq"], c["s"], c["d"], c["causal"]) == (
            r5.B, r5.H, r5.S, r5.D, False)


@pytest.mark.parametrize("case", kernel_ab.X_CASES, ids=lambda c: c["name"])
def test_x_flops_and_bounds_are_chip_smokes(case):
    q = torch.empty(case["b"], case["hq"], case["s"], case["d"], dtype=torch.bfloat16)
    lse = torch.empty(case["b"], case["hq"], case["s"], 1)
    ms, by, n = chip_smoke.attention_bound(case["b"], case["hq"], case["s"], case["d"],
                                           False, "bf16", q, q, q, q, lse)
    assert kernel_ab.flops("x", case) == n
    got_ms, got_by = kernel_ab.bound("x", case, (q, q, q))
    assert got_by == by == "operations" and got_ms == pytest.approx(ms)


@pytest.mark.parametrize("workspace", [False, True], ids=["7af2811", "split-KV"])
def test_parent_b6_calls_as_its_argtypes_declare(monkeypatch, workspace):
    """build_parent gives B6's entry point the parent's argtypes: 7af2811's
    (no split count, workspace or counters) or, for a source exporting
    cfa_paged_chunk_workspace_floats, the current wrapper's; parent_b6
    passes exactly that many arguments."""
    from cuda_flash_attention_tpu_torch.decode import attention as dec_attn

    names = ["cfa_paged_chunk"] + (["cfa_paged_chunk_workspace_floats"]
                                   if workspace else [])
    lib = _RecordingLib(*names)
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("b6", "unused.cu") is lib
    if workspace:
        monkeypatch.setattr(dec_attn, "_sm_count", lambda index: 132)
        monkeypatch.setattr(dec_attn, "_counters_for",
                            lambda device, n: torch.zeros(n, dtype=torch.int32))
        lib.cfa_paged_chunk_workspace_floats = lambda *a: 16
        lib.cfa_paged_chunk.argtypes = dec_attn.CHUNK_ARGTYPES["cfa_paged_chunk"]
    case = dict(kernel_ab.B6_CASES[0], hq=2, hkv=1, pps=2, lengths=[200, 0])
    x, kw, _ = kernel_ab.problem("b6", case, torch.Generator().manual_seed(0))
    (out,) = kernel_ab.parent_b6(lib, *x, **kw)
    assert out.shape == x[0].shape
    (name, args), = lib.calls
    assert len(args) == len(lib.cfa_paged_chunk.argtypes) == (26 if workspace else 21)
    if workspace:  # two splits of one page: a workspace and the counters
        # (after the window and sinks the entry point takes)
        assert list(args[20:22]) == [dec_attn.NO_WINDOW, 0]
        assert args[22] == 2 and args[23] is not None and args[24] is not None


def test_parent_x_calls_as_its_argtypes_declare(monkeypatch):
    lib = _RecordingLib("cfa_r5_d128_fwd")
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent("x", "unused.cu") is lib
    case = dict(kernel_ab.X_CASES[1], b=1, hq=2, hkv=2, s=128)
    x, kw, _ = kernel_ab.problem("x", case, torch.Generator().manual_seed(0))
    o, lse = kernel_ab.parent_x(lib, *x, **kw)
    assert o.shape == x[0].shape and lse.shape == (*x[0].shape[:3], 1)
    (name, args), = lib.calls
    assert len(args) == len(lib.cfa_r5_d128_fwd.argtypes) == 10
    assert args[-2] == 1  # v1_mxu_ones


def test_b7_cases_are_phase_19s_rows():
    """Phase 19's timed rows (the base shape B4 Hq16 Hkv8 S2048 D64 causal
    and the long one B1 S8192) for each storage, the base shape at D 128
    (int8) and phase 19's ragged check shape (B2 S1000), in bf16 compute;
    the base shape in fp32 compute for int8 and e4m3, and int8 at D 128."""
    names = {c["name"]: c for c in kernel_ab.B7_CASES}
    assert len(names) == len(kernel_ab.B7_CASES) == 10
    assert kernel_ab.B7_STORAGES == chip_smoke.STORAGES
    for st in chip_smoke.STORAGES:
        assert (names[f"base {st}"]["b"], names[f"base {st}"]["s"]) == (4, 2048)
        assert (names[f"long {st}"]["b"], names[f"long {st}"]["s"]) == (1, 8192)
    assert names["base D128 int8"]["d"] == 128
    assert (names["ragged S1000 int8"]["b"], names["ragged S1000 int8"]["s"]) == (2, 1000)
    for c in kernel_ab.B7_CASES + kernel_ab.B7_FP32_CASES:
        assert (c["hq"], c["hkv"], c["causal"]) == (16, 8, True)
    assert all(c["tile"] == "bf16" for c in kernel_ab.B7_CASES)
    assert [(c["storage"], c["dtype"], c["tile"], c["s"], c["d"])
            for c in kernel_ab.B7_FP32_CASES] == [("int8", "fp32", None, 2048, 64),
                                                   ("e4m3", "fp32", None, 2048, 64),
                                                   ("int8", "fp32", None, 2048, 128)]


@pytest.mark.parametrize("kernel,case", [("b7", c) for c in kernel_ab.B7_CASES]
                         + [("b7-fp32", c) for c in kernel_ab.B7_FP32_CASES],
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_b7_flops_and_bounds_are_chip_smokes(kernel, case):
    """kernel_ab's B7 FLOPs and bound are chip_smoke.attention_bound's on
    the padded inputs, O and lse (a small copy of the case: the same S, one
    KV head); no single PyTorch call computes B7's function."""
    small = dict(case, b=1, hq=2, hkv=1)
    x, kw, raw = kernel_ab.problem(kernel, small, torch.Generator().manual_seed(0))
    assert x[0].shape[2] == -(-small["s"] // 128) * 128 and kw["kv_len"] == small["s"]
    assert kw["compute_dtype"] == (torch.float32 if kernel == "b7-fp32" else torch.bfloat16)
    o = torch.empty_like(x[0])
    lse = torch.empty(x[0].shape[:3])
    ms, by, n = chip_smoke.attention_bound(1, 2, small["s"], small["d"], True,
                                           small["tile"] or small["dtype"], *x, o, lse)
    assert kernel_ab.flops(kernel, small) == n
    got_ms, got_by = kernel_ab.bound(kernel, small, raw)
    assert got_by == by and got_ms == pytest.approx(ms)
    assert kernel_ab.library_call(kernel, small, raw, kw) is None


def test_b7_argtypes_match_the_c_entry_point():
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq

    assert [t.__name__ for t in fq.ARGTYPES] == _c_signature(
        "cfa_fa2_forward_quant", "fa2_forward_quant.cu")


def test_b7_masks_argtypes_match_the_c_entry_point(monkeypatch):
    """quant_args names the entry point's parameters in its order (window,
    segment ids and the dead-row tiles among them), which is how the
    current wrapper and a parent's both call it."""
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq

    path = Path(fq.__file__).parent.parent / "csrc" / "fa2_forward_quant.cu"
    params = b1_ab.entry_params(path.read_text(), "cfa_fa2_forward_quant")
    assert [t for _, t in params] == fq.ARGTYPES
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    case = dict(kernel_ab.B7_CASES[0], b=1, hq=2, hkv=1, s=200)
    x, kw, _ = kernel_ab.problem("b7", case, torch.Generator().manual_seed(0))
    values, *_ = fq.quant_args(*x, **kw)
    assert list(values) == [n for n, _ in params]
    assert {"q_seg", "kv_seg", "window", "dead_bq", "dead_bk"} <= set(values)


# 3c5d3e4's cfa_fa2_forward_quant, before windows and segment ids.
_B7_BEFORE_MASKS = ("int cfa_fa2_forward_quant(const void* q, const void* k,"
                    " const void* k_scales, const void* v, const void* v_scales,"
                    " void* o, void* lse, int batch, int hq, int hkv, int sq,"
                    " int skv, int head_dim, int kv_len, float qscale, int causal,"
                    " int q_bf16, int storage, int bf16_compute, void* stream) {")


@pytest.mark.parametrize("kernel", ["b7", "b7-fp32"])
@pytest.mark.parametrize("source", ["before masks", "current"])
def test_parent_b7_calls_as_its_argtypes_declare(monkeypatch, tmp_path, kernel, source):
    """build_parent types a parent's cfa_fa2_forward_quant by the parameter
    list in its source; parent_b7 passes exactly those arguments (20 before
    windows and ids, 25 now with no ids and no window) and returns (O,
    lse)."""
    if source == "current":
        path = Path(__file__).resolve().parents[1] / \
            "cuda_flash_attention_tpu_torch/csrc/fa2_forward_quant.cu"
    else:
        path = tmp_path / "fa2_forward_quant.cu"
        path.write_text(_B7_BEFORE_MASKS)
    lib = _RecordingLib("cfa_fa2_forward_quant")
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent(kernel, str(path)) is lib
    case = dict(kernel_ab.CASES[kernel][0], b=1, hq=2, hkv=1, s=200)
    x, kw, _ = kernel_ab.problem(kernel, case, torch.Generator().manual_seed(0))
    parent, _ = kernel_ab.calls(kernel)
    o, lse = parent(lib, *x, **kw)
    assert o.shape == x[0].shape and lse.shape == x[0].shape[:3]
    (name, args), = lib.calls
    values = dict(zip(lib.b7_params, args))
    assert len(args) == len(lib.cfa_fa2_forward_quant.argtypes) == \
        (20 if source == "before masks" else 25)
    # storage 0 (int8); bf16 compute for b7, fp32 for b7-fp32
    assert values["storage"] == 0 and values["bf16_compute"] == int(kernel == "b7")
    if source == "current":
        assert (values["q_seg"], values["kv_seg"], values["window"]) == (0, 0, 1 << 30)


def test_b7_to_b10_wide_cases_are_chip_smokes_phase_31_shapes():
    """The head-dim 32 and 256 forms of B7-B10 (b7-wide, b8-wide, b9-wide,
    b10-wide): B9 and B10 at phase 31's baseline shapes, B8 at phase 16's
    rows at each width, B7 at phase 31's causal shapes (each storage in
    bf16, int8 in fp32); problems, bounds and wrappers are the D 64 and 128
    kernels'."""
    for wide, base in (("b7-wide", "b7"), ("b8-wide", "b8"), ("b9-wide", "b9"),
                       ("b10-wide", "b10")):
        assert kernel_ab.backward_of(wide) == base
        assert {c["d"] for c in kernel_ab.CASES[wide]} == set(kernel_ab.WIDE_HEAD_DIMS)
    assert [(c["b"], c["hq"], c["s"], c["d"]) for c in kernel_ab.B9_WIDE_CASES] == [
        (*chip_smoke.WIDE_BASELINE_SHAPES[d], d) for d in (32, 256)]
    assert kernel_ab.CASES["b10-wide"] == kernel_ab.B9_WIDE_CASES
    assert len(kernel_ab.B8_WIDE_CASES) == 2 * len(kernel_ab.B8_CASES)
    b7 = kernel_ab.B7_WIDE_CASES
    for d, shape in chip_smoke.WIDE_B7_SHAPES.items():
        rows = [c for c in b7 if c["d"] == d]
        assert all((c["b"], c["hq"], c["hkv"], c["s"]) == shape and c["causal"]
                   for c in rows)
        assert sorted(c["storage"] for c in rows if c["dtype"] == "bf16") == sorted(
            kernel_ab.B7_STORAGES)
        assert [c["storage"] for c in rows if c["dtype"] == "fp32"] == ["int8"]
    case = kernel_ab.B9_WIDE_CASES[0]
    assert kernel_ab.flops("b9-wide", case) == kernel_ab.flops("b9", case)
    raw = [torch.empty(case["b"], case["hq"], case["s"], case["d"]) for _ in range(3)]
    assert kernel_ab.bound("b10-wide", case, raw) == kernel_ab.bound("b10", case, raw)
    case = kernel_ab.B8_WIDE_CASES[-1]
    assert kernel_ab.bound("b8-wide", case, None) == kernel_ab.bound("b8", case, None)


@pytest.mark.parametrize("kernel,source", [("b7-wide", "fa2_forward_quant.cu"),
                                           ("b8-wide", "fa2_forward_small.cu")])
def test_b7_b8_wide_parents_are_typed_by_the_source_they_build(monkeypatch, tmp_path,
                                                                kernel, source):
    """A wide parent of B7 or B8 takes the entry point's parameter list from
    the source its wide_source includes, at each head dim."""
    csrc = Path(__file__).resolve().parents[1] / "cuda_flash_attention_tpu_torch/csrc"
    parent = tmp_path / source
    parent.write_text((csrc / source).read_text())
    entry = "cfa_fa2_forward_quant" if kernel == "b7-wide" else "cfa_fa2_forward_small"
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: _RecordingLib(entry))
    libs = kernel_ab.build_parent(kernel, str(parent))
    assert sorted(libs) == [32, 256]
    params = [n for n, _ in b1_ab.entry_params((csrc / source).read_text(), entry)]
    for lib in libs.values():
        assert (lib.b7_params if kernel == "b7-wide" else lib.b8_params) == params


def test_b5_b6_wide_cases_are_chip_smokes_phase_28_shapes():
    """b5-wide and b6-wide: phase 28's heads at D 32 (Hq16 Hkv8) and 256
    (Hq8 Hkv4), B5 on phase 3's lengths, B6 at T 5 and 512 on phase 12's;
    int8, int4 (B5) and bf16 caches in bf16 and fp32 compute; no fp32
    cache (an older parent, 5cf8bdd's, refuses it at D 256); the problems,
    bounds and FLOPs are b5's and b6's."""
    for wide, base in (("b5-wide", "b5"), ("b6-wide", "b6")):
        cases = kernel_ab.CASES[wide]
        assert kernel_ab.backward_of(wide) == base
        assert {c["d"] for c in cases} == set(kernel_ab.WIDE_HEAD_DIMS)
        assert "fp32" not in {c["cache"] for c in cases}
        for c in cases:
            assert (c["hq"], c["hkv"]) == {32: (16, 8), 256: (8, 4)}[c["d"]]
            assert kernel_ab.flops(wide, c) == kernel_ab.flops(base, c)
            assert kernel_ab.bound(wide, c, None) == kernel_ab.bound(base, c, None)
            assert kernel_ab.shape_of(wide, c) == kernel_ab.shape_of(base, c)
    assert {c["T"] for c in kernel_ab.B6_WIDE_CASES} == {5, 512}
    assert len(kernel_ab.B5_WIDE_CASES) == 12 and len(kernel_ab.B6_WIDE_CASES) == 16


@pytest.mark.parametrize("name", ["cfa_fa1_forward", "cfa_naive_fa2_forward"])
def test_baseline_argtypes_match_the_c_entry_points(name):
    """B9's and B10's wrappers type their entry points as csrc/baselines.cu
    declares them (the input type code before the stream)."""
    from cuda_flash_attention_tpu_torch.kernels import baselines

    assert [t.__name__ for t in baselines.ARGTYPES[name]] == _c_signature(
        name, "baselines.cu")


# 7d0d66c's baselines entry points (up to ab11413): fp32 only, no input type.
_BASELINES_FP32 = (
    "int cfa_fa1_forward(const void* q, const void* k, const void* v, void* o,"
    " void* m, void* l, int bh, int sq, int skv, int head_dim, int kv_len,"
    " float sm_scale, void* stream) {\n"
    "int cfa_naive_fa2_forward(const void* q, const void* k, const void* v, void* o,"
    " int bh, int sq, int skv, int head_dim, int kv_len, float sm_scale,"
    " void* stream) {\n")


@pytest.mark.parametrize("kernel", ["b9", "b10"])
@pytest.mark.parametrize("source", ["fp32 only", "current"])
def test_parent_baselines_call_as_their_argtypes_declare(monkeypatch, tmp_path, kernel,
                                                         source):
    """build_parent types a parent's B9 and B10 entry points by the
    parameter lists in its source: an earlier one (fp32 only) takes no
    input type and is called without one, the current one with q's."""
    if source == "current":
        path = Path(__file__).resolve().parents[1] / \
            "cuda_flash_attention_tpu_torch/csrc/baselines.cu"
    else:
        path = tmp_path / "baselines.cu"
        path.write_text(_BASELINES_FP32)
    lib = _RecordingLib("cfa_fa1_forward", "cfa_naive_fa2_forward")
    monkeypatch.setattr(b1_ab, "compile_source", lambda path, stem: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    assert kernel_ab.build_parent(kernel, str(path)) is lib
    x, kw, _ = kernel_ab.problem(kernel, dict(kernel_ab.CASES[kernel][0], b=1, h=2, s=128),
                                 torch.Generator().manual_seed(0))
    parent, _ = kernel_ab.calls(kernel)
    (o,) = parent(lib, *x, **kw)
    assert o.shape == x[0].shape
    (name, args), = lib.calls
    assert len(args) == len(getattr(lib, name).argtypes) == (
        {"b9": 13, "b10": 11}[kernel] + (source == "current"))
    if source == "current":
        assert args[-2] == 0  # fp32 inputs: in_type 0
