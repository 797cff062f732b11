"""Kernel B2 (the fused FA2 backward, csrc/fa2_backward.cu), B9 (FA1) or
B10 (naive FA2, both csrc/baselines.cu), or B1's fp32 body (csrc/
fa2_forward.cu, tile code 0) against an earlier build of its source, timed
in turns on one card.

    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b2 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b9 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b10 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b1-fp32 --parent PATH

PATH is an earlier fa2_backward.cu (b2), baselines.cu (b9, b10) or
fa2_forward.cu (b1-fp32) with the same C entry point:
cfa_fa2_backward_fused without a workspace (its wrapper summed every dQ
slice with torch), cfa_fa1_forward, cfa_naive_fa2_forward or
cfa_fa2_forward (e.g. `git show
<commit>:cuda_flash_attention_tpu_torch/csrc/baselines.cu >
build/parent/baselines.cu`; the headers it includes are looked up beside
it first, then in csrc/).  It is built with the package's nvcc flags into
build/kernels/ and called through a copy of its own wrapper; the current
kernel through its wrapper (fa2_backward_fused_aligned: prologue, main
kernel and dQ reduce; fa1_aligned; naive_fa2_aligned;
fa2_forward_aligned).  At each of the kernel's shapes (B2_CASES: phase
7's train rows at D 64 and 128 and the ragged S1000, phase 16's fp16
tiles; B9_CASES: phase 16's Small-2, Large-2 and Stress-1; B10_CASES:
those and Stress-1 at D 128; B1_FP32_CASES: Stress-1 non-causal, b1_ab's
fp32 B1 S512, the train shape in fp32 at D 64 and 128) it prints one JSON
line with b1_ab's two times, each read in the order parent, current,
current, parent (`ms`, CUDA events over back-to-back calls; `device_ms`,
the calls queued behind a sleep kernel), TFLOP/s, the bound, one PyTorch
call computing the same function (PyTorch's flash backward in the tile
type for B2; fp32 SDPA for the forwards, K/V expanded to the query heads
and the causal flag set for B1), the largest difference between the two
builds' outputs and each wrapper's host time per call.  The card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch.kernels import _build, attention, baselines
from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
from cuda_flash_attention_tpu_torch.kernels.common import LOG2E, tile_code
from cuda_flash_attention_tpu_torch.scripts import b1_ab

# chip_smoke.py's B2 rows (phase 7 bf16 rows, the D 128 train row, phase
# 16's fp16 tiles on fp32 inputs) and B9 rows (phase 16, fp32, D 64).
_TRAIN = dict(b=4, hq=16, hkv=8, s=2048, d=64, causal=True, dtype="bf16",
              tile="bf16")
B2_CASES = [
    dict(_TRAIN, name="train"),
    dict(_TRAIN, name="train D128", d=128),
    dict(_TRAIN, name="ragged S1000", b=2, s=1000),
    dict(_TRAIN, name="train fp16 tiles", dtype="fp32", tile="fp16"),
    dict(_TRAIN, name="Stress-1 fp16 tiles", b=8, hkv=16, causal=False,
         dtype="fp32", tile="fp16"),
]
B9_CASES = [
    dict(name=name, b=b, hq=h, hkv=h, s=s, d=64, causal=False, dtype="fp32",
         tile=None)
    for name, (b, h, s) in (("Small-2", (2, 4, 256)), ("Large-2", (4, 12, 1024)),
                            ("Stress-1", (8, 16, 2048)))
]
# B10: phase 16's rows and Stress-1 at D 128.
B10_CASES = B9_CASES + [dict(B9_CASES[-1], name="Stress-1 D128", d=128)]
# B1's fp32 body (b1_ab's case format, Sq = Skv = s): the suite's Stress-1
# (phase 16, not causal), b1_ab's fp32 B1 S512 (phase 2, causal, GQA 16/8),
# and the train shape (B4 Hq16 Hkv8 S2048 causal) in fp32 at D 64 and 128.
_B1_FP32 = dict(dtype="fp32", tile=None)
B1_FP32_CASES = [dict(c, s=c["sq"]) for c in (
    dict(_B1_FP32, name="Stress-1", b=8, hq=16, hkv=16, sq=2048, skv=2048, d=64,
         causal=False),
    next(c for c in b1_ab.CASES if c["name"] == "fp32 B1 S512"),
    dict(next(c for c in b1_ab.CASES if c["name"] == "train"), **_B1_FP32,
         name="train fp32"),
    dict(next(c for c in b1_ab.CASES if c["name"] == "train D128"), **_B1_FP32,
         name="train D128 fp32"),
)]
CASES = {"b2": B2_CASES, "b9": B9_CASES, "b10": B10_CASES,
         "b1-fp32": B1_FP32_CASES}
# Matmuls of S x S x D per attending (query, key) pair and head.
_MATMULS = {"b2": 5, "b9": 2, "b10": 2, "b1-fp32": 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def b2_problem(case, gen):
    """The case's padded inputs on gen's device as chip_smoke's bwd_problem
    builds them: q, k, v, dO random, O and lse from B1; B2's keyword
    arguments; the raw (unpadded) q, k, v, dO."""
    dt, tile = b1_ab.dtype_of(case["dtype"]), b1_ab.dtype_of(case["tile"])
    b, s, d = case["b"], case["s"], case["d"]
    q, do = (torch.randn(b, case["hq"], s, d, generator=gen, device=gen.device)
             .to(dt) for _ in range(2))
    k, v = (torch.randn(b, case["hkv"], s, d, generator=gen, device=gen.device)
            .to(dt) for _ in range(2))
    raw = (q, k, v, do)
    q, k, v, scale, _, kv_len = attention._prepare(
        q, k, v, case["causal"], None, tile, None, None, None, 0)
    o, lse = fa2.fa2_forward_aligned(q, k, v, causal=case["causal"],
                                     sm_scale=scale, kv_len=kv_len,
                                     tile_dtype=tile)
    do = F.pad(do, (0, 0, 0, q.shape[2] - s)).contiguous()
    kw = dict(causal=case["causal"], sm_scale=scale, kv_len=kv_len,
              tile_dtype=tile)
    return (q, k, v, o, do, lse), kw, raw


def b9_problem(case, gen):
    """B9's or B10's inputs: q, k, v [B, H, S, D] fp32, sm_scale 1/sqrt(D)."""
    q, k, v = (torch.randn(case["b"], case["hq"], case["s"], case["d"],
                           generator=gen, device=gen.device) for _ in range(3))
    return (q, k, v), dict(sm_scale=case["d"] ** -0.5, kv_len=case["s"]), (q, k, v)


def b1_fp32_problem(case, gen):
    """b1_ab's padded q, k, v and keyword arguments (fp32, tile code 0)."""
    q, k, v, kw, _ = b1_ab.problem(case, gen)
    return (q, k, v), kw, (q, k, v)


def problem(kernel: str, case, gen):
    """(the kernel's inputs, its keyword arguments, the raw q, k, v[, dO])."""
    return {"b2": b2_problem, "b9": b9_problem, "b10": b9_problem,
            "b1-fp32": b1_fp32_problem}[kernel](case, gen)


def flops(kernel: str, case) -> int:
    pairs = b1_ab.attended_pairs(case["s"], case["s"], case["causal"])
    return _MATMULS[kernel] * 2 * case["b"] * case["hq"] * pairs * case["d"]


def bound(kernel: str, case, raw) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): each input read once and each output
    written once (B2: q, k, v, O, dO, lse in, dQ, dK, dV out; B9, B10: q, k,
    v in, O out; B1: q, k, v in, O and lse out), or the FLOPs at the tile
    type's peak."""
    q, k = raw[0], raw[1]
    qb = q.numel() * q.element_size()
    kvb = 2 * k.numel() * k.element_size()
    stat = case["b"] * case["hq"] * case["s"] * 4
    moved = {"b2": 4 * qb + 2 * kvb + stat, "b1-fp32": 2 * qb + kvb + stat}.get(
        kernel, 2 * qb + kvb)
    t_bytes = moved / b1_ab.HBM_BYTES_PER_S
    t_ops = flops(kernel, case) / b1_ab.PEAK_FLOPS[case["tile"] or case["dtype"]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def library_call(kernel: str, case, raw, kw):
    """One PyTorch call computing the same function: the aten flash backward
    (fed by its own forward) in the tile type for B2, with K/V expanded to
    the query heads; fp32 SDPA for B9 and B10, and for B1 on the keys
    before kv_len, K/V expanded to the query heads, causal as the case."""
    if kernel in ("b9", "b10"):
        q, k, v = raw
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=kw["sm_scale"])
    if kernel == "b1-fp32":
        q, k, v = raw
        groups, n = q.shape[1] // k.shape[1], kw["kv_len"]
        k, v = (t[:, :, :n].repeat_interleave(groups, dim=1) for t in (k, v))
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kw["causal"], scale=kw["sm_scale"])
    tile = b1_ab.dtype_of(case["tile"])
    q, k, v, do = (t.to(tile) for t in raw)
    groups = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(groups, dim=1) for t in (k, v))
    out = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, case["causal"], False, scale=kw["sm_scale"])
    o, lse, cq, ck, mq, mk, seed, offset = out[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, case["causal"], seed, offset,
        scale=kw["sm_scale"])


def build_parent(kernel: str, path: str) -> ctypes.CDLL:
    if kernel == "b1-fp32":
        return b1_ab.build_parent(path)
    lib = b1_ab.compile_source(path, f"{kernel}_parent")
    if kernel == "b2":
        lib.cfa_fa2_backward_fused.argtypes = [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
        lib.cfa_fa2_backward_fused.restype = _I
    else:
        lib.cfa_fa1_forward.argtypes = [_P] * 6 + [_I] * 5 + [_F, _P]
        lib.cfa_fa1_forward.restype = _I
        lib.cfa_naive_fa2_forward.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.cfa_naive_fa2_forward.restype = _I
    return lib


def parent_b2(lib, q, k, v, o, do, lse, *, causal, sm_scale, kv_len, tile_dtype):
    """The parent's wrapper: every dQ slice written by the kernel and summed
    by torch."""
    b, hq, sq, d = q.shape
    n_slices = -(-k.shape[2] // bwd.fused_kv_tile(q.dtype, tile_dtype))
    dq_part = torch.empty((b, hq, n_slices, sq, d), device=q.device,
                          dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.cfa_fa2_backward_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], d, kv_len, sm_scale * LOG2E, int(causal),
        int(q.dtype == torch.bfloat16), tile_code(q.dtype, tile_dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "parent fa2_backward_fused")
    return dq_part.sum(dim=2).mul_(sm_scale).to(q.dtype), dk, dv


def parent_b9(lib, q, k, v, *, sm_scale, kv_len):
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    m = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    err = lib.cfa_fa1_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), b * h, sq, k.shape[2], d, kv_len, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_baselines_error_string", err, "parent fa1")
    return (o,)


def parent_b10(lib, q, k, v, *, sm_scale, kv_len):
    b, h, sq, d = q.shape
    o = torch.empty_like(q)
    err = lib.cfa_naive_fa2_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, sq,
        k.shape[2], d, kv_len, sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_baselines_error_string", err, "parent naive_fa2")
    return (o,)


def calls(kernel: str):
    """(the parent's wrapper, taking the library first; the current one),
    each returning a tuple of outputs."""
    return {
        "b2": (parent_b2, bwd.fa2_backward_fused_aligned),
        "b9": (parent_b9, lambda *a, **k: (baselines.fa1_aligned(*a, **k),)),
        "b10": (parent_b10, lambda *a, **k: (baselines.naive_fa2_aligned(*a, **k),)),
        "b1-fp32": (b1_ab.parent_forward, fa2.fa2_forward_aligned),
    }[kernel]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=tuple(CASES))
    ap.add_argument("--parent", required=True,
                    help="an earlier csrc/fa2_backward.cu (b2), csrc/baselines.cu "
                    "(b9, b10) or csrc/fa2_forward.cu (b1-fp32)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(b1_ab.card_line(), flush=True)
    lib = build_parent(args.kernel, args.parent)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    parent, current = calls(args.kernel)
    for case in CASES[args.kernel]:
        x, kw, raw = problem(args.kernel, case, gen)

        def old():
            return parent(lib, *x, **kw)

        def new():
            return current(*x, **kw)

        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(old(), new()))
        order = (old, new, new, old)
        turns = [b1_ab.time_ms(fn) for fn in order]
        device_turns = [b1_ab.device_ms(fn) for fn in order]
        parent_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        parent_dev = (device_turns[0] + device_turns[3]) / 2
        new_dev = (device_turns[1] + device_turns[2]) / 2
        n_flops = flops(args.kernel, case)
        bound_ms, bound_by = bound(args.kernel, case, raw)
        row = dict(kernel=args.kernel, case=case["name"], B=case["b"],
                   Hq=case["hq"], Hkv=case["hkv"], S=case["s"], D=case["d"],
                   causal=case["causal"], inputs=case["dtype"],
                   tiles=case["tile"], turns_ms=turns,
                   device_turns_ms=device_turns, parent_ms=parent_ms,
                   ms=new_ms, speedup=parent_ms / new_ms,
                   parent_device_ms=parent_dev, device_ms=new_dev,
                   device_speedup=parent_dev / new_dev,
                   parent_tflops=n_flops / parent_dev / 1e9,
                   tflops=n_flops / new_dev / 1e9, bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_ms=b1_ab.time_ms(library_call(args.kernel, case, raw, kw)),
                   max_abs_diff=diff, parent_host_us=b1_ab.host_us(old),
                   host_us=b1_ab.host_us(new))
        rows.append(row)
        print(f"{args.kernel.upper()} A/B", json.dumps(row), flush=True)
        del x, raw
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
