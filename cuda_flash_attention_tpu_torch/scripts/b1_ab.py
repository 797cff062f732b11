"""Kernel B1 (csrc/fa2_forward.cu) against an earlier build of its source,
timed in turns on one card.

    python -m cuda_flash_attention_tpu_torch.scripts.b1_ab --parent PATH

PATH is an earlier fa2_forward.cu (cfa_fa2_forward); its parameter list is
read from the source (before windows none; then window and sinks; then
segment ids and the dead rows' tiles too; the input flag in_bf16 became
the input type code in_type, whose 0 and 1 it reads alike), and the call
passes no window,
sinks or ids; K and V go in the input type, or in the tile type to a
source that loads them by TMA (the wgmma design on), as the current
wrapper casts them (e.g. `git show <commit>:cuda_flash_attention_tpu_torch/
csrc/fa2_forward.cu > build/parent/fa2_forward.cu`).  It is built with the
package's nvcc flags into build/kernels/ and called through a copy of its
own wrapper; the current kernel is called through `fa2_forward_aligned`,
whose K/V casts to the tile type are part of its time.  At every 16-bit-tile
shape of chip_smoke.py's B1 phases (CASES: phase_b1's rows, phase 16's fp16
tiles at Stress-1, phase 23's B4 H8 S2048 D128) it prints one JSON line:
two times, each read four times in the order parent, current, current,
parent, with each kernel's means; TFLOP/s, the bound, SDPA's time on the
same inputs, the largest |O_parent - O_current|, and each wrapper's host
time per call.  The two times: `ms`, CUDA events over back-to-back calls
as chip_smoke's `time_ms` (at small shapes this is the host's call rate),
and `device_ms`, the same calls queued behind a sleep kernel so that only
the card's time is counted (chip_smoke's `queued_ms`).  The card's name
and power limit come first.  Only the 16-bit-tile body is timed here;
kernel_ab's `--kernel b1-fp32` times the fp32 FMA body (tile code 0)
against its parent with this script's build_parent and parent_forward.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch.kernels import _build, attention
from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
from cuda_flash_attention_tpu_torch.kernels.common import (
    LOG2E,
    NO_WINDOW,
    in_type,
    reference_tiles,
    tile_code,
)
from cuda_flash_attention_tpu_torch.utils.timing import (
    device_benchmark,
    queued_device_benchmark,
)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}

# B1's shapes in chip_smoke.py.  Lengths are before padding (attention's
# _prepare pads them as the API does; kv_len is the unpadded Skv).  Serving
# and training use Hq 16, Hkv 8, D 64, causal.
_BASE = dict(hq=16, hkv=8, d=64, causal=True, dtype="bf16", tile="bf16")
CASES = (
    [dict(_BASE, name=f"B{b} S{s}", b=b, sq=s, skv=s)
     for b in (1, 8) for s in (128, 512, 1024)]
    + [
        # The serving run's largest prefill bucket and the train forward.
        dict(_BASE, name="B4 S1536", b=4, sq=1536, skv=1536),
        dict(_BASE, name="train", b=4, sq=2048, skv=2048),
        dict(_BASE, name="fp32 B1 S512", b=1, sq=512, skv=512, dtype="fp32",
             tile=None),
        dict(_BASE, name="train D128", b=4, sq=2048, skv=2048, d=128),
        dict(_BASE, name="train fp16 tiles", b=4, sq=2048, skv=2048,
             tile="fp16"),
        dict(_BASE, name="Sq300 Skv100", b=4, sq=300, skv=100),
        dict(_BASE, name="Sq128 Skv384", b=4, sq=128, skv=384),
        dict(_BASE, name="S16", b=8, sq=16, skv=16),
        dict(_BASE, name="S112", b=8, sq=112, skv=112),
        dict(_BASE, name="kv_len 1000 of 1024", b=4, sq=1000, skv=1000,
             causal=False),
        dict(_BASE, name="GQA 16/2", b=4, hkv=2, sq=2048, skv=2048),
    ]
)
# phase 16's fp16 tiles of B1 (Stress-1, fp32 inputs, sm_scale 1/8) and
# phase 23's shape (X's, bf16, non-causal).
STRESS1_FP16 = dict(name="Stress-1 fp16 tiles", b=8, hq=16, hkv=16, sq=2048,
                    skv=2048, d=64, causal=False, dtype="fp32", tile="fp16")
X_SHAPE = dict(name="B4 H8 S2048 D128", b=4, hq=8, hkv=8, sq=2048, skv=2048,
               d=128, causal=False, dtype="bf16", tile="bf16")


def dtype_of(name):
    return {None: None, "bf16": torch.bfloat16, "fp16": torch.float16,
            "fp32": torch.float32}[name]


def attended_pairs(sq: int, kv_len: int, causal: bool) -> int:
    """(query, key) pairs that attend over the unpadded rows: rows past
    kv_len see kv_len keys under causal (top-left) masking."""
    if not causal:
        return sq * kv_len
    n = min(sq, kv_len)
    return n * (n + 1) // 2 + (sq - n) * kv_len


def problem(case, gen):
    """The case's padded q, k, v on gen's device, B1's keyword arguments
    and its FLOPs (4 D per attending pair)."""
    dt, tile = dtype_of(case["dtype"]), dtype_of(case["tile"])
    b, d = case["b"], case["d"]
    q = torch.randn(b, case["hq"], case["sq"], d, generator=gen,
                    device=gen.device).to(dt)
    k, v = (torch.randn(b, case["hkv"], case["skv"], d, generator=gen,
                        device=gen.device).to(dt) for _ in range(2))
    q, k, v, scale, q_len, kv_len = attention._prepare(
        q, k, v, case["causal"], None, tile, None, None, None, 0)
    kw = dict(causal=case["causal"], sm_scale=scale, kv_len=kv_len,
              tile_dtype=tile)
    flops = 4 * b * case["hq"] * attended_pairs(q_len, kv_len, case["causal"]) * d
    return q, k, v, kw, flops


def bound(case, flops, *tensors):
    """(ms, "bytes" or "operations"): each tensor moved once, or the FLOPs
    at the tile type's peak."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[case["tile"] or case["dtype"]]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def sdpa_call(q, k, v, kw):
    """One PyTorch call that computes the same function on the same inputs:
    SDPA (top-left causal) on the keys before kv_len, in the tile type."""
    tile = kw["tile_dtype"] or q.dtype
    n = kw["kv_len"]
    args = [t.to(tile) for t in (q, k[:, :, :n], v[:, :, :n])]
    return lambda: F.scaled_dot_product_attention(
        *args, is_causal=kw["causal"], scale=kw["sm_scale"],
        enable_gqa=q.shape[1] != k.shape[1])


def time_ms(fn) -> float:
    """chip_smoke's `time_ms`: CUDA events over 20 back-to-back calls."""
    return device_benchmark(fn, iters=20, warmup=3) * 1e3


def device_ms(fn) -> float:
    """chip_smoke's `queued_ms`: the card's own time per call."""
    return queued_device_benchmark(fn, iters=20) * 1e3


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of fn while a sleep kernel holds the stream, so
    that no call waits for the card: the wrapper's own cost."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def compile_source(path: str, stem: str) -> ctypes.CDLL:
    """PATH compiled with the package's flags into build/kernels/<stem>-*.so
    and loaded.  The headers it includes are found beside it first (put an
    earlier commit's headers there with its source), then in csrc/."""
    src = open(path, "rb").read()
    digest = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"{stem}-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                        "-o", str(out), path], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def entry_params(source: str, name: str) -> list[tuple[str, type]]:
    """(name, ctypes type) of each parameter of the C entry point `name` in
    a source's text: pointers as c_void_p, int and float as themselves."""
    params = re.search(rf"\b{name}\(([^)]*)\)\s*{{", source).group(1)
    out = []
    for p in params.split(","):
        words = p.replace("const ", "").replace("*", " * ").split()
        kind = (ctypes.c_void_p if "*" in words else
                {"int": ctypes.c_int, "float": ctypes.c_float}[words[0]])
        out.append((words[-1], kind))
    return out


def build_parent(path: str) -> ctypes.CDLL:
    """PATH compiled with the package's flags into build/kernels/, its
    cfa_fa2_forward typed by the parameter list in its source."""
    lib = compile_source(path, "b1_parent")
    source = Path(path).read_text()
    params = entry_params(source, "cfa_fa2_forward")
    lib.cfa_fa2_forward.argtypes = [t for _, t in params]
    lib.cfa_fa2_forward.restype = ctypes.c_int
    lib.b1_params = [n for n, _ in params]
    # From the wgmma redesign on, K and V reach the kernel by TMA, in the
    # tile type (the wrapper casts them, as the current one does).
    lib.b1_kv_in_tile = "tma_load_3d" in source
    return lib


def parent_forward(lib, q, k, v, *, causal, sm_scale, kv_len, tile_dtype):
    """The parent's wrapper: the same checks and allocations, K and V passed
    in the input type (in the tile type to a source that loads them by
    TMA); no window, sinks or segment ids."""
    b, hq, sq, d = q.shape
    fa2._check_inputs("fa2_forward", q, k, v, tile_dtype)
    if getattr(lib, "b1_kv_in_tile", False) and tile_dtype not in (None, q.dtype):
        k, v = k.to(tile_dtype), v.to(tile_dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    dead_bq, dead_bk = reference_tiles(sq, k.shape[2], causal, None)
    values = dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr(), q_seg=None, kv_seg=None, batch=b, hq=hq,
        hkv=k.shape[1], sq=sq, skv=k.shape[2], head_dim=d, kv_len=kv_len,
        qscale=sm_scale * LOG2E, causal=int(causal), window=NO_WINDOW, sinks=0,
        dead_bq=dead_bq, dead_bk=dead_bk, in_type=in_type(q.dtype),
        in_bf16=int(q.dtype == torch.bfloat16), tiles=tile_code(q.dtype, tile_dtype),
        stream=torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.cfa_fa2_forward(*(values[n] for n in lib.b1_params))
    _build.check(lib, "cfa_fa2_forward_error_string", err, "parent fa2_forward")
    return o, lse


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier csrc/fa2_forward.cu (K/V in the input type)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("b1_ab: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    lib = build_parent(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case in [c for c in CASES if c["tile"]] + [STRESS1_FP16, X_SHAPE]:
        q, k, v, kw, flops = problem(case, gen)

        def old():
            return parent_forward(lib, q, k, v, **kw)

        def new():
            return fa2.fa2_forward_aligned(q, k, v, **kw)

        o_old, (o_new, lse_new) = old()[0], new()
        diff = (o_old.float() - o_new.float()).abs().max().item()
        del o_old
        order = (old, new, new, old)
        turns = [time_ms(fn) for fn in order]
        device_turns = [device_ms(fn) for fn in order]
        parent_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        parent_dev = (device_turns[0] + device_turns[3]) / 2
        new_dev = (device_turns[1] + device_turns[2]) / 2
        bound_ms, bound_by = bound(case, flops, q, k, v, o_new, lse_new)
        row = dict(case=case["name"], B=case["b"], Hq=case["hq"],
                   Hkv=case["hkv"], Sq=case["sq"], Skv=case["skv"],
                   D=case["d"], causal=case["causal"], inputs=case["dtype"],
                   tiles=case["tile"], turns_ms=turns,
                   device_turns_ms=device_turns, parent_ms=parent_ms, ms=new_ms,
                   speedup=parent_ms / new_ms, parent_device_ms=parent_dev,
                   device_ms=new_dev, device_speedup=parent_dev / new_dev,
                   parent_tflops=flops / parent_dev / 1e9,
                   tflops=flops / new_dev / 1e9, bound_ms=bound_ms,
                   bound_by=bound_by,
                   sdpa_ms=time_ms(sdpa_call(q, k, v, kw)),
                   max_abs_diff=diff,
                   parent_host_us=host_us(old), host_us=host_us(new))
        rows.append(row)
        print("B1 A/B", json.dumps(row), flush=True)
        del q, k, v, o_new, lse_new
    return rows


if __name__ == "__main__":
    main()
