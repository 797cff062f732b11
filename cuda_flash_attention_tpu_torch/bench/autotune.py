"""Tile autotuner for the CUDA kernels of the FA2 family (B1, B2, B3, B4).

Counterpart of cuda_flash_attention_tpu/bench/autotune.py, with its flags:

    python -m cuda_flash_attention_tpu_torch.bench.autotune \
        --kernels fwd,fused,dq,dkv --seq 2048 --tile bf16,fp16,fp32 --causal both

The JAX tool sweeps `BlockSizes`, the TPU kernels' sequence tiles.  The
port's kernels keep their own tile constants in csrc/ (BlockSizes only
picks the backward route there), so this tool sweeps those, over the shapes
the Hopper bodies already compile at some head dim; no new code path is
invented.  JAX's block_q / block_k map onto them, and the ring's stages are
a column of their own:

  fwd (B1, csrc/fa2_forward.cu Layout<D>)   block_q 128 (a block's Q rows),
      block_k = kTileN in {64, 128}, stages = kStages in {2, 3};
  fused, dkv (B2, B4, BwdLayout<D>)         block_k = kKvRows 128 (a
      block's KV rows: the two consumers own 64 each, wgmma's M; 64 is a
      failed row that no build can lift), block_q = BQ in {64, 128} (Q rows
      a step), 2 stages; at D 256 the wide body's fixed 64 x 64 (one row);
  dq (B3, DqLayout<D>)                      block_q 128, block_k = BN in
      {64, 128} ({32, 64} at D 256), stages = kStages in {2, 3}.

With fp32 tiles the FMA bodies keep 64 x 64 (kBlockM / kBlockN): one fixed
row per kernel.  Each other candidate is a library of its own
(`_build.variant`: the source built at that head dim with the constants as
-D definitions and bf16 inputs alone; B4's without B2, whose larger layout
would refuse shapes that B4 fits), which the wrappers load in place of the
shipped one while it is timed (`_build.substitute`).  A candidate whose
source refuses it (the layouts' static_asserts: the block's 227 KB of
shared memory) or whose ptxas report (kept beside the library, whichever
process built it: `_build.build_log`) shows a spill or a wgmma
serialisation is a failed row with its reason, as the JAX tool records
Mosaic's rejections.  Each candidate is timed by device time (CUDA
events, utils/timing.device_benchmark), and its output is held against the
shipped tiles' (`max_abs_diff`).

Output: one JSON line per candidate plus a winners table; `--json PATH`
appends the rows.  The inputs are the JAX tool's: N(0, 1) draws, fp32 for
fp32 tiles and bf16 otherwise, H query and KV heads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re

import torch

from cuda_flash_attention_tpu_torch.kernels import _build
from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
from cuda_flash_attention_tpu_torch.kernels.common import kernel_library
from cuda_flash_attention_tpu_torch.ops.metrics import attention_flops
from cuda_flash_attention_tpu_torch.utils.timing import device_benchmark

KERNELS = ("fwd", "fused", "dq", "dkv")
TILE = {"fp32": None, "bf16": torch.bfloat16, "fp16": torch.float16}
_TILE_NAME = {t: n for n, t in TILE.items()}
_SOURCE = {"fwd": "fa2_forward", "fused": "fa2_backward", "dq": "fa2_backward",
           "dkv": "fa2_backward"}
# The kernels whose ptxas report decides a variant (mangled-name patterns:
# B2 is the KV-major kernel with DQ, B4 without).
_PTXAS = {"fwd": (r"fa2_fwd_wgmma",), "fused": (r"bwd_fused_wgmma\w*Lb1E",),
          "dkv": (r"bwd_fused_wgmma\w*Lb0E",), "dq": (r"bwd_dq_wgmma",)}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One tile shape of one kernel at head dim `d`: `block_q` and
    `block_k` in the JAX tool's sense (see the module note), the ring's
    `stages` (None for the fp32 bodies' fixed row), whether these are the
    shipped constants, the -D definitions of its variant library (none for
    the shipped), and why no build can run it (`refused`), if none can."""

    kernel: str
    d: int
    block_q: int
    block_k: int
    stages: int | None
    default: bool
    defines: tuple = ()
    refused: str | None = None

    def key(self) -> str | None:
        """The variant library's key, or None for the shipped library."""
        if not self.defines:
            return None
        return _build.variant(_SOURCE[self.kernel], **dict(self.defines))


def default_tiles(kernel: str, d: int) -> tuple[int, int, int]:
    """(block_q, block_k, stages) of the shipped 16-bit-tile body at head
    dim d (csrc/fa2_forward.cu Layout, csrc/fa2_backward.cu BwdLayout,
    WideLayout and DqLayout)."""
    if kernel == "fwd":
        return 128, 64 if d > 128 else 128, 2 if d > 64 else 3
    if kernel in ("fused", "dkv"):
        if d > 128:
            return 64, 64, 2
        return (64 if d == 128 else 128), 128, 2
    if kernel == "dq":
        return 128, {32: 64, 64: 128, 128: 64, 256: 32}[d], 3
    raise ValueError(f"unknown kernel {kernel!r}")


def candidates(kernel: str, d: int, tile, blocks=(32, 64, 128)) -> list[Candidate]:
    """Every tile shape of `kernel` at head dim d for tile type `tile`
    (None: the fp32 body's fixed 64 x 64 row), the shipped one first; the
    others' KV and Q rows restricted to `blocks`."""
    if tile is None:
        return [Candidate(kernel, d, 64, 64, None, True)]
    dq, dk, ds = default_tiles(kernel, d)
    out = [Candidate(kernel, d, dq, dk, ds, True)]
    extra = {}
    if kernel == "fwd":
        shapes = [(128, n, s) for n in (64, 128) for s in (2, 3)]
        names = ("CFA_FWD_TILE_N", None, "CFA_FWD_STAGES")
    elif kernel == "dq":
        shapes = [(128, n, s) for n in ((32, 64) if d > 128 else (64, 128))
                  for s in (2, 3)]
        names = ("CFA_DQ_KV_ROWS", None, "CFA_DQ_STAGES")
    elif d > 128:  # B2 / B4 at D 256: the wide body's fixed tiles
        return out
    else:
        shapes = [(bq, 128, 2) for bq in (64, 128)]
        names = (None, "CFA_BWD_Q_ROWS", None)
        if kernel == "dkv":
            extra["CFA_BWD_DKV_ONLY"] = 1
        if 64 in blocks:  # one fixed row: no build takes 64 KV rows
            out.append(Candidate(kernel, d, dq, 64, 2, False, refused=(
                "source: 128 KV rows a block (kKvRows, csrc/fa2_backward.cu): "
                "the two consumers own 64 each (wgmma's M)")))
    for bq, bk, st in shapes:
        if (bq, bk, st) == (dq, dk, ds):
            continue
        if (names[0] and bk not in blocks) or (names[1] and bq not in blocks):
            continue
        defines = {"CFA_HEAD_DIM": d, "CFA_BF16_INPUTS_ONLY": 1, **extra}
        for name, value in zip(names, (bk, bq, st)):
            if name:
                defines[name] = value
        out.append(Candidate(kernel, d, bq, bk, st, False, tuple(sorted(defines.items()))))
    return out


def ptxas_faults(log: str, kernel: str) -> str | None:
    """The first spill or wgmma-serialisation note that ptxas reports for
    `kernel`'s entry functions in a build log, or None."""
    current = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
        named = re.search(r"function '?(_Z\w+)", line)
        fn = named.group(1) if named else current
        if fn is None or not any(re.search(p, fn) for p in _PTXAS[kernel]):
            continue
        spill = re.search(r"(\d+) bytes spill (?:stores|loads)", line)
        if spill and int(spill.group(1)):
            return f"ptxas: {line.strip()} ({fn[-40:]})"
        if "C75" in line or "serializ" in line:
            return f"ptxas: {line.strip()}"
    return None


def compile_error(log: str) -> str:
    """The first error line of a failed nvcc log (a static_assert's
    message, for a shape the source refuses)."""
    for line in log.splitlines():
        if "error" in line:
            return "nvcc: " + line.strip()
    return "nvcc: " + (log.strip().splitlines() or ["failed"])[-1]


def variant_keys(cands) -> list[str]:
    """The variant libraries that the candidates need, once each."""
    return list(dict.fromkeys(c.key() for c in cands if c.key()))


def reasons_of(cands, logs: dict, failures: dict) -> dict[str, str]:
    """Why each failed variant of `cands` failed, by key: the compile
    error of those in `failures` (nvcc's logs of the keys that did not
    build), the ptxas fault of the others (their logs from `logs`, the new
    builds', or else the log kept beside a library built before)."""
    reasons = {key: compile_error(log) for key, log in failures.items()}
    for c in cands:
        key = c.key()
        if key is None or key in failures:
            continue
        log = logs[key] if key in logs else _build.build_log(key)
        fault = ptxas_faults(log or "", c.kernel)
        if fault:
            reasons.setdefault(key, fault)
    return reasons


def build_variants(cands) -> dict[str, str]:
    """Build every candidate's variant library in one parallel nvcc run;
    returns the failure reason of each key that failed (a compile error or
    a ptxas fault)."""
    failures: dict[str, str] = {}
    logs = _build.build(*variant_keys(cands), failures=failures)
    return reasons_of(cands, logs, failures)


def make_inputs(b: int, h: int, s: int, d: int, tile, device, kv_heads=None):
    """The JAX tool's inputs: N(0, 1) q, k, v, dO, fp32 for fp32 tiles and
    bf16 otherwise, seeded; K and V with `kv_heads` heads (default h)."""
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = torch.float32 if tile is None else torch.bfloat16
    hk = kv_heads or h
    return tuple(torch.randn(b, n, s, d, generator=gen, device=device).to(dtype)
                 for n in (h, hk, hk, h))


def _call(kernel, q, k, v, do, stats, common):
    """One launch of `kernel` on the problem (the backward's forward
    artefacts in `stats`: O, lse, D_i); returns its first output."""
    if kernel == "fwd":
        return fa2.fa2_forward_aligned(q, k, v, **common)[0]
    o, lse, di = stats
    if kernel == "fused":
        return bwd.fa2_backward_fused_aligned(q, k, v, o, do, lse, **common)[0]
    if kernel == "dq":
        return bwd.fa2_backward_dq_aligned(q, k, v, do, lse, di, **common)
    return bwd.fa2_backward_dkv_aligned(q, k, v, do, lse, di, **common)[0]


def device_ms(fn, iters: int) -> float:
    return device_benchmark(fn, iters=iters, warmup=1) * 1e3


def sweep(kernel: str, *, b: int = 8, h: int = 16, s: int = 2048, d: int = 64,
          tile=torch.bfloat16, causal: bool = False, blocks=(32, 64, 128),
          iters: int = 4, timer=device_ms, device="cuda",
          reasons: dict | None = None, kv_heads=None, reference=None,
          strict: bool = False) -> list[dict]:
    """Time every candidate tile shape of one kernel; returns rows sorted
    fastest first (failed rows last, ms inf, with their `error`).  On a
    CUDA device the variants are built first (unless `reasons` gives the
    failures of a build already run) and each runs from its own library;
    on the CPU the wrappers run their plain versions (one function for
    every candidate), timed by `timer`.  Each output (O, or dQ, or dK) is
    held against `reference(q, k, v, do, stats, common)`'s where that is
    given, else against the shipped tiles': `max_abs_diff` and
    `rel_diff` (of the reference's max |value|).  A launch that raises is a
    failed row, or with `strict` raises: only a refused build is then a
    row."""
    if s % 128:
        raise ValueError(f"autotune: S {s} must be a multiple of 128")
    sm = 1.0 / d ** 0.5
    cuda = torch.device(device).type == "cuda"
    q, k, v, do = make_inputs(b, h, s, d, tile, device, kv_heads)
    common = dict(causal=causal, sm_scale=sm, kv_len=s, tile_dtype=tile)
    stats = None
    if kernel != "fwd":
        o, lse = fa2.fa2_forward_aligned(q, k, v, **common)
        stats = (o, lse, (o.float() * do.float()).sum(dim=-1))
    if reference is not None:
        reference = reference(q, k, v, do, stats, common)
    flops = attention_flops(b, h, s, s, d, mode="forward" if kernel == "fwd"
                            else "backward", causal=causal)
    cands = candidates(kernel, d, tile, blocks)
    if cuda and reasons is None:
        reasons = build_variants(cands)
    reasons = reasons or {}
    library = kernel_library(_SOURCE[kernel], d, q.dtype)
    rows = []
    for c in cands:
        row = {"kernel": kernel, "tile": _TILE_NAME[tile],
               "causal": causal, "B": b, "H": h, "S": s, "D": d,
               "block_q": c.block_q, "block_k": c.block_k, "stages": c.stages,
               "default": c.default}
        error = c.refused or reasons.get(c.key())
        if error:
            rows.append(dict(row, ms=float("inf"), error=error))
            print(json.dumps(rows[-1]), flush=True)
            continue

        def fn():
            return _call(kernel, q, k, v, do, stats, common)

        try:
            if cuda and c.key():
                with _build.substitute(library, c.key()):
                    out, t = fn(), timer(fn, iters)
            else:
                out, t = fn(), timer(fn, iters)
        except RuntimeError as e:  # a launch the card refused
            if strict:
                raise
            rows.append(dict(row, ms=float("inf"), error=f"{type(e).__name__}: {e}"))
            print(json.dumps(rows[-1]), flush=True)
            continue
        if reference is None:
            reference = out
        diff = (out.float() - reference.float()).abs().max().item()
        scale = reference.float().abs().max().item()
        rows.append(dict(row, ms=t, tflops=flops / t / 1e9, max_abs_diff=diff,
                         rel_diff=diff / scale if scale else math.inf))
        print(json.dumps(rows[-1]), flush=True)
    rows.sort(key=lambda r: r["ms"])
    return rows


def winners_line(best: dict, tile_name: str) -> str:
    return (f"## BEST {best['kernel']} S={best['S']} tile={tile_name} "
            f"causal={best['causal']}: bq={best['block_q']} bk={best['block_k']} "
            f"stages={best['stages']} {best['ms']:.4f} ms "
            f"({best.get('tflops', 0):.1f} TF){' (shipped)' if best['default'] else ''}")


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kernels", default="fwd,fused",
                   help="comma list of fwd,fused,dq,dkv")
    p.add_argument("--seq", default="2048", help="comma list of S values")
    p.add_argument("--tile", default="bf16", help="comma list of fp32,bf16,fp16")
    p.add_argument("--causal", default="both", choices=["true", "false", "both"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--blocks", default="32,64,128",
                   help="KV and Q rows a candidate may take (the shipped "
                        "tiles are always timed)")
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--json", default=None, help="append rows to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("autotune: times the CUDA kernels on the card; none is "
                         "available")
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        p.error(f"--kernels takes {','.join(KERNELS)}")
    causals = {"true": [True], "false": [False], "both": [False, True]}[args.causal]
    blocks = tuple(int(x) for x in args.blocks.split(","))
    d = args.head_dim
    # Every variant of the sweep in one parallel build first.
    every = [c for kern in kernels for t in args.tile.split(",")
             for c in candidates(kern, d, TILE[t], blocks)]
    reasons = build_variants(every)
    all_rows, winners = [], []
    for s in (int(x) for x in args.seq.split(",")):
        # The JAX tool's rule: shrink the batch as S grows past Stress-1's.
        b = max(1, args.batch * 2048 * 2048 // (s * s)) if s > 2048 else args.batch
        for tile_name in args.tile.split(","):
            for causal in causals:
                for kern in kernels:
                    rows = sweep(kern, b=b, h=args.heads, s=s, d=d,
                                 tile=TILE[tile_name], causal=causal,
                                 blocks=blocks, iters=args.iters, reasons=reasons)
                    all_rows.extend(rows)
                    winners.append(rows[0])
                    print(winners_line(rows[0], tile_name), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            for r in all_rows:
                f.write(json.dumps(r) + "\n")
    print("\n=== winners ===")
    for w in winners:
        print(json.dumps(w))
    return all_rows


if __name__ == "__main__":
    main()
