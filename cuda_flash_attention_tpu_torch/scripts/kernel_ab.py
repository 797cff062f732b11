"""Kernel B2 (the fused FA2 backward), B3 (its dQ), B4 (its dK and dV) or
the split pair B3 + B4 (all csrc/fa2_backward.cu; with bf16 or fp16 tiles,
or their fp32 bodies, tile code 0, as `-fp32`), B9 (FA1) or B10 (naive
FA2, both csrc/baselines.cu), B1's fp32 body (csrc/fa2_forward.cu, tile
code 0), B8 (the small-shape FA2 forward, csrc/fa2_forward_small.cu), B5
(paged decode, csrc/paged_decode.cu), B6 (paged chunk attention,
csrc/paged_chunk.cu), B7 (the quantized-KV FA2 forward,
csrc/fa2_forward_quant.cu, bf16 compute as `b7`, fp32 compute as `b7-fp32`)
or X (the D=128 rowsum probe, csrc/r5_d128_fwd.cu) against an earlier build
of its source, timed in turns on one card.

    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b2 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b3 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b4 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b3-b4 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b3-b4-fp32 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b2-masked --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b9 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b10 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b1-fp32 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b8 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b5 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b6 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b7 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel b7-fp32 --parent PATH
    python -m cuda_flash_attention_tpu_torch.scripts.kernel_ab --kernel x --parent PATH

PATH is an earlier fa2_backward.cu (b2, b3, b4, b3-b4 and their -fp32
and -masked forms), baselines.cu (b9, b10), fa2_forward.cu (b1-fp32),
fa2_forward_small.cu (b8), paged_decode.cu (b5), paged_chunk.cu (b6),
fa2_forward_quant.cu (b7, b7-fp32) or r5_d128_fwd.cu (x) with the same C
entry point: cfa_fa2_forward_small; cfa_r5_d128_fwd; cfa_fa2_forward_quant
(typed by its source's parameter list, with fa2_forward_quant.quant_args' checks);
cfa_paged_decode or cfa_paged_chunk with or without a
split count, workspace and counters (a source exporting
cfa_paged_decode_workspace_floats or cfa_paged_chunk_workspace_floats is
launched as the current wrapper launches it); cfa_fa2_backward_fused,
cfa_fa2_backward_dq and
cfa_fa2_backward_dkv with or without a workspace (a source that exports
cfa_fa2_backward_workspace is called with one, B2 with its dQ reduce, as
the wrappers of its interface call it; without it, B2's wrapper summed
every dQ slice with torch; a source that also exports
cfa_fa2_backward_masks, such as a variant of the current one, takes the
window, the sinks and segment ids as the current wrappers pass them); cfa_fa1_forward,
cfa_naive_fa2_forward or cfa_fa2_forward (e.g. `git show <commit>:cuda_flash_attention_tpu_torch/csrc/baselines.cu >
build/parent/baselines.cu`; the headers it includes are looked up beside
it first, then in csrc/).  It is built with the package's nvcc flags into
build/kernels/ and called through a copy of its own wrapper; the current
kernel through its wrapper (fa2_backward_fused_aligned: prologue, main
kernel and dQ reduce; fa2_backward_dq_aligned and fa2_backward_dkv_aligned:
prologue and kernel; b3-b4 runs attention._backward's split branch, the
D_i reduction, B3, then B4; fa1_aligned; naive_fa2_aligned;
fa2_forward_aligned).  At each of the kernel's shapes (B2_CASES: phase
7's train rows at D 64 and 128 and the ragged S1000, phase 16's fp16
tiles; SPLIT_CASES: those, phase 11's B16 S2048 and the long-context
split case B1 Hq16 S8192; B9_CASES: phase 16's Small-2, Large-2 and
Stress-1; B10_CASES: those and Stress-1 at D 128; B1_FP32_CASES: Stress-1
non-causal, b1_ab's fp32 B1 S512, the train shape in fp32 at D 64 and
128; FP32_BWD_CASES, for the fp32 bodies of B2, B3, B4 and the pair:
fp32_bwd's Large-2 and Stress-1, phase 7's fp32 B1 S512 and the fp32
train shape at D 64 and 128; MASKED_CASES, for B2, B3, B4 and the pair as
b2-masked, b3-masked, b4-masked and b3-b4-masked: chip_smoke phase 26's
train-shape rows, window 128 (the hybrid's local layers), window 512
with 4 sinks (streaming's layers), window 128 at D 128 and 4 packed
documents a row; a parent without cfa_fa2_backward_masks runs the same
call without its window, sinks and ids, and its line then says
`parent_function: "global"` and gives no output difference;
WIDE_BWD_CASES, for B2, B3, B4 and the pair at head dims 32 and 256 as
b2-wide, b3-wide, b4-wide and b3-b4-wide: chip_smoke phase 29's causal
shapes (D 32 at the train shape, D 256 at B1 Hq8 Hkv4 S4096) in bf16 and
in fp16 tiles on fp32 inputs and phase 30's Gemma-2 call (B1 Hq8 Hkv4
S2048 D256), the parent built at each case's head dim by a source beside
it that includes it with CFA_HEAD_DIMS (`wide_source`); B8_CASES: phase 16's 18 rows; B5_CASES:
phase 3's rows, phase 20's fp8 and int4 rows, serving's decode lengths
and a long D128 case; B6_CASES: phase 12's five rows, phase 20's fp8 and
int4 rows, T 1, 2 and 8 at phase 12's lengths, a one-page suffix (T
128), group 8 at D 128 and a long case; B7_CASES: phase 19's timed rows,
the base shape (B4 Hq16 Hkv8 S2048 D64 causal) and the long one (B1
S8192) for each storage, the base shape at D 128 (int8) and a ragged
S1000 row (B2, phase 19's check shape); B7_FP32_CASES: the base shape in
fp32 compute, int8 and e4m3, and int8 at D 128; X_CASES: the probe's shape once
per variant; at head dims 32 and 256, built as the -wide forms of the
backward are: B9_WIDE_CASES and B10_WIDE_CASES (b9-wide, b10-wide):
chip_smoke phase 31's B8 H16 S2048 D32 and B1 H8 S4096 D256;
B8_WIDE_CASES (b8-wide): B8_CASES at D 32 and 256; B7_WIDE_CASES
(b7-wide): phase 31's causal rows, D 32 at B4 Hq16 Hkv8 S2048 and D 256 at
B1 Hq8 Hkv4 S4096, each storage in bf16 compute and int8 in fp32);
B5_WIDE_CASES and B6_WIDE_CASES (b5-wide, b6-wide): phase 28's paged
shapes on int8, int4 (B5) and bf16 caches in bf16 and fp32 compute) it
prints one JSON line with b1_ab's two
times, each read in the order parent, current, current, parent (`ms`,
CUDA events over back-to-back calls; `device_ms`, the calls queued behind
a sleep kernel), TFLOP/s, the bound, one PyTorch call computing the same
function (PyTorch's flash backward in the tile type for B2 and the pair,
SDPA's memory-efficient backward for their fp32 bodies, none for B3 or B4
alone, B5 or B6; fp32 SDPA for the forwards, K/V expanded to the query
heads and the causal flag set for B1; SDPA in the tile type for B8 and X),
timed back to back (`library_ms`) and queued (`library_device_ms`), the
largest difference between the two builds' outputs and each wrapper's
host time per call; X's lines add B1 on the same inputs and the two-pass
floor (1.5x the operations bound: X computes Q K^T twice); B7's lines
add B1 and SDPA on the dequantized K/V in the compute type (yardsticks,
not B7's function: B7 rounds Q and P * v_scale, never the dequantized K/V).
The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch import quant
from cuda_flash_attention_tpu_torch.decode import attention as dec_attn
from cuda_flash_attention_tpu_torch.decode import kv_cache
from cuda_flash_attention_tpu_torch.kernels import _build, attention, baselines
from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
from cuda_flash_attention_tpu_torch.kernels.common import (
    LOG2E,
    NO_WINDOW,
    build_element_mask,
    kv_storage_cast,
    seq_pad_quantum,
    tile_code,
)
from cuda_flash_attention_tpu_torch.scripts import b1_ab, fp32_bwd
from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5

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
# B3, B4 and the pair: B2's rows, phase 11's split-route train shape (B16
# S2048) and the long-context shape that the route rule sends to the pair
# (B1 Hq16 Hkv8 S8192: 2 GiB of dQ slices).
SPLIT_CASES = B2_CASES[:3] + [dict(_TRAIN, name="B16 S2048", b=16)] + B2_CASES[3:] + [
    dict(_TRAIN, name="long B1 S8192", b=1, s=8192)]
# B2, B3, B4 and the pair with a window, sinks or segment ids: chip_smoke
# phase 26 (a)'s and (b)'s train-shape rows (B4 Hq16 Hkv8 S2048 causal
# bf16).
MASKED_CASES = [
    dict(_TRAIN, name="train w128", window=128),
    dict(_TRAIN, name="train w512 s4", window=512, sinks=4),
    dict(_TRAIN, name="train D128 w128", d=128, window=128),
    dict(_TRAIN, name="train 4 documents", segments=4),
]
# B2, B3, B4 and the pair at head dims 32 and 256 (b2-wide, b3-wide,
# b4-wide, b3-b4-wide): chip_smoke phase 29's causal shapes (D 32 at the
# train shape, D 256 at B1 Hq8 Hkv4 S4096) in bf16 and in fp16 tiles on fp32
# inputs, and phase 30's Gemma-2 training call (B1 Hq8 Hkv4 S2048 D256).
WIDE_BWD_CASES = [
    dict(_TRAIN, name="D32 train", d=32),
    dict(_TRAIN, name="D32 train fp16 tiles", d=32, dtype="fp32", tile="fp16"),
    dict(_TRAIN, name="D256 B1 S4096", b=1, hq=8, hkv=4, s=4096, d=256),
    dict(_TRAIN, name="D256 B1 S4096 fp16 tiles", b=1, hq=8, hkv=4, s=4096, d=256,
         dtype="fp32", tile="fp16"),
    dict(_TRAIN, name="D256 Gemma-2 train", b=1, hq=8, hkv=4, s=2048, d=256),
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
# The fp32 bodies of B2, B3, B4 and the pair (fp32 inputs, tile code 0):
# fp32_bwd's shapes (the harness's fp32 `fa2 both` rows: D 64, not causal,
# Hq = Hkv), phase 7's fp32 B1 S512 (GQA 16/8, causal) and the train shape
# in fp32 at D 64 and 128.
_FP32 = dict(dtype="fp32", tile=None)
FP32_BWD_CASES = [
    dict(_FP32, name=name, b=b, hq=h, hkv=h, s=s, d=64, causal=False)
    for name, (b, h, s) in fp32_bwd.SHAPES.items()
] + [
    dict(_TRAIN, **_FP32, name="fp32 B1 S512", b=1, s=512),
    dict(_TRAIN, **_FP32, name="train fp32"),
    dict(_TRAIN, **_FP32, name="train D128 fp32", d=128),
]
# B8: chip_smoke's phase-16 rows, the reference suite's configs that take
# B8 (fp32 inputs at D 64) in fp32, bf16 and fp16 tiles, causal and not.
B8_CONFIGS = {"Small-1": (1, 1, 128), "Edge-NonPowerOf2": (8, 16, 100),
              "Edge-SmallSeq": (8, 16, 32)}
B8_CASES = [
    dict(name=f"{config} {kind}{' causal' if causal else ''}", config=config,
         b=b, hq=h, hkv=h, s=s, d=64, causal=causal, dtype="fp32",
         tile=None if kind == "fp32" else kind)
    for config, (b, h, s) in B8_CONFIGS.items()
    for kind in ("fp32", "bf16", "fp16") for causal in (False, True)
]
# B5: phase 3's rows (8 slots, Hq16 Hkv8 D64, 128-token pages, 16 a slot;
# int8 and bf16 caches with bf16 and fp32 compute), phase 20's fp8 and int4
# rows at that shape, serving's decode lengths (phase 5's first 8 prompts,
# the 8 slots' first residents, each at its 64th new token) and a long
# context (8 slots of 8192 tokens at D 128, 64 pages a slot).
PHASE3_LENGTHS = [2048, 1, 129, 0, 777, 1500, 128, 2000]
# Phase 12's (and phase 20's) B6 lengths: chip_smoke.B6_SPEC_LENGTHS and
# B6_PREFILL_LENGTHS.
SPEC_LENGTHS = [2048, 5, 133, 0, 777, 1500, 128, 2000]
PREFILL_LENGTHS = [512, 1024, 1536, 2048]
SERVING_LENGTHS = [int(n) + 64
                   for n in np.random.default_rng(4).integers(64, 1501, 12)[:8]]
_B5 = dict(hq=16, hkv=8, d=64, pps=16, lengths=PHASE3_LENGTHS)
B5_CASES = (
    [dict(_B5, name=f"phase 3 {cache} {compute}", cache=cache, compute=compute)
     for cache, compute in (("int8", "bf16"), ("bf16", "bf16"), ("int8", "fp32"),
                            ("bf16", "fp32"))]
    + [dict(_B5, name=f"phase 20 {cache} {compute}", cache=cache, compute=compute)
       for cache in ("e4m3", "e5m2", "int4") for compute in ("bf16", "fp32")]
    + [dict(_B5, name="serving", lengths=SERVING_LENGTHS, cache="int8",
            compute="bf16"),
       dict(_B5, name="long D128", d=128, pps=64, lengths=[8192] * 8,
            cache="int8", compute="bf16")]
)
# B6: phase 12's five rows (8 slots, T 5, Hq16 Hkv8 D64, 16 pages of 128
# tokens a slot: int8 cache with bf16 and fp32 compute, bf16 cache; T 512
# at 4 slots of 512-2048 tokens, int8 with bf16 and fp32 compute), phase
# 20's fp8 and int4 rows (bf16 compute), T 1, 2 and 8 at phase 12's
# lengths, a one-page prefix suffix (T 128 at the prefill lengths), group 8
# at D 128 (Hkv 2, T 5) and a long case (8 slots of 8192 tokens, T 5).
_B6 = dict(hq=16, hkv=8, d=64, pps=16, T=5, lengths=SPEC_LENGTHS, cache="int8",
           compute="bf16")
_B6_PREFILL = dict(_B6, T=512, lengths=PREFILL_LENGTHS)
B6_CASES = (
    [dict(_B6, name="phase 12 spec int8 bf16"),
     dict(_B6, name="phase 12 spec int8 fp32", compute="fp32"),
     dict(_B6, name="phase 12 spec bf16 bf16", cache="bf16"),
     dict(_B6_PREFILL, name="phase 12 prefill int8 bf16"),
     dict(_B6_PREFILL, name="phase 12 prefill int8 fp32", compute="fp32")]
    + [dict(_B6, name=f"phase 20 spec {cache}", cache=cache)
       for cache in ("e4m3", "e5m2", "int4")]
    + [dict(_B6_PREFILL, name=f"phase 20 prefill {cache}", cache=cache)
       for cache in ("e4m3", "int4")]
    + [dict(_B6, name=f"spec T{t}", T=t) for t in (1, 2, 8)]
    + [dict(_B6_PREFILL, name="suffix T128", T=128),
       dict(_B6, name="group 8 D128", hkv=2, d=128),
       dict(_B6, name="long 8 x 8192", pps=64, lengths=[8192] * 8)]
)
# B7: phase 19's timed rows (the base model's attention shape B4 Hq16 Hkv8
# S2048 D64 causal, and B1 S8192) for each storage in bf16 compute, the base
# shape at D 128 (int8) and phase 19's ragged check shape (B2 S1000); in
# fp32 compute the base shape, int8 and e4m3, and int8 at D 128 (where the
# stored-width ring drops to one stage to keep two blocks an SM).
B7_STORAGES = ("int8", "e4m3", "e5m2", "int4")
_B7 = dict(b=4, hq=16, hkv=8, s=2048, d=64, causal=True, dtype="bf16",
           tile="bf16", storage="int8")
B7_CASES = (
    [dict(_B7, name=f"base {st}", storage=st) for st in B7_STORAGES]
    + [dict(_B7, name=f"long {st}", b=1, s=8192, storage=st) for st in B7_STORAGES]
    + [dict(_B7, name="base D128 int8", d=128),
       dict(_B7, name="ragged S1000 int8", b=2, s=1000)]
)
B7_FP32_CASES = [dict(_B7, name=f"base fp32 {st}", storage=st, dtype="fp32", tile=None)
                 for st in ("int8", "e4m3")] + [
    dict(_B7, name="base D128 fp32 int8", d=128, dtype="fp32", tile=None)]
# B7-B10 at head dims 32 and 256 (b7-wide, b8-wide, b9-wide, b10-wide):
# chip_smoke phase 31's shapes.
_WIDE_BASELINE = {32: (8, 16, 2048), 256: (1, 8, 4096)}
B9_WIDE_CASES = [dict(B9_CASES[0], name=f"D{d} B{b} H{h} S{s}", b=b, hq=h, hkv=h, s=s,
                      d=d) for d, (b, h, s) in _WIDE_BASELINE.items()]
B10_WIDE_CASES = B9_WIDE_CASES
B8_WIDE_CASES = [dict(c, name=f"D{d} {c['name']}", d=d) for d in (32, 256)
                 for c in B8_CASES]
B7_WIDE_CASES = [dict(_B7, name=f"D{d} {st}", b=b, hq=hq, hkv=hkv, s=s, d=d, storage=st)
                 for d, (b, hq, hkv, s) in ((32, (4, 16, 8, 2048)), (256, (1, 8, 4, 4096)))
                 for st in B7_STORAGES] + [
    dict(_B7, name=f"D{d} fp32 int8", b=b, hq=hq, hkv=hkv, s=s, d=d, dtype="fp32",
         tile=None) for d, (b, hq, hkv, s) in ((32, (4, 16, 8, 2048)),
                                               (256, (1, 8, 4, 4096)))]
# B5 and B6 at head dims 32 and 256 (b5-wide, b6-wide): chip_smoke phase
# 28's shapes (B4 Hq16 Hkv8 at D 32, Hq8 Hkv4 at D 256; phase 3's lengths,
# T 5 and T 512 at phase 12's) on int8, int4 and bf16 caches, bf16 and fp32
# compute.  No fp32 cache: an older parent (5cf8bdd's) refuses it at D 256.
_WIDE_PAGED_HEADS = {32: (16, 8), 256: (8, 4)}
B5_WIDE_CASES = [dict(_B5, name=f"D{d} {cache} {compute}", d=d, hq=hq, hkv=hkv,
                      cache=cache, compute=compute)
                 for d, (hq, hkv) in _WIDE_PAGED_HEADS.items()
                 for cache in ("int8", "int4", "bf16") for compute in ("bf16", "fp32")]
B6_WIDE_CASES = [dict(base, name=f"D{d} T{base['T']} {cache} {compute}", d=d, hq=hq,
                      hkv=hkv, cache=cache, compute=compute)
                 for d, (hq, hkv) in _WIDE_PAGED_HEADS.items()
                 for base in (_B6, _B6_PREFILL)
                 for cache in ("int8", "bf16") for compute in ("bf16", "fp32")]
# X: the probe's shape (B4 H8 S2048 D128 bf16, not causal), once per variant.
X_CASES = [dict(name=variant, variant=variant, b=r5.B, hq=r5.H, hkv=r5.H, s=r5.S,
                d=r5.D, causal=False, dtype="bf16", tile="bf16")
           for variant in r5.VARIANTS]
CASES = {"b2": B2_CASES, "b3": SPLIT_CASES, "b4": SPLIT_CASES,
         "b3-b4": SPLIT_CASES, "b2-masked": MASKED_CASES,
         "b3-masked": MASKED_CASES, "b4-masked": MASKED_CASES,
         "b3-b4-masked": MASKED_CASES, "b2-wide": WIDE_BWD_CASES,
         "b3-wide": WIDE_BWD_CASES, "b4-wide": WIDE_BWD_CASES,
         "b3-b4-wide": WIDE_BWD_CASES, "b9": B9_CASES, "b10": B10_CASES,
         "b1-fp32": B1_FP32_CASES, "b2-fp32": FP32_BWD_CASES,
         "b3-fp32": FP32_BWD_CASES, "b4-fp32": FP32_BWD_CASES,
         "b3-b4-fp32": FP32_BWD_CASES, "b8": B8_CASES, "b5": B5_CASES,
         "b6": B6_CASES, "b7": B7_CASES, "b7-fp32": B7_FP32_CASES, "x": X_CASES,
         "b7-wide": B7_WIDE_CASES, "b8-wide": B8_WIDE_CASES, "b9-wide": B9_WIDE_CASES,
         "b10-wide": B10_WIDE_CASES, "b5-wide": B5_WIDE_CASES,
         "b6-wide": B6_WIDE_CASES}
# Matmuls of S x S x D per attending (query, key) pair and head: B3
# recomputes S and dP for dS K, B4 for P^T dO and dS^T Q_s; the pair is
# bounded by the function's own five, as B2.
_MATMULS = {"b2": 5, "b3": 3, "b4": 4, "b3-b4": 5, "b9": 2, "b10": 2,
            "b1-fp32": 2, "b8": 2, "b7": 2, "x": 2}
# The fp32 bodies' names, each with the kernel whose problem, bound and
# parent wrapper it shares (the backward's; B7's, whose compute type is the
# case's).
_FP32_BODIES = {"b2-fp32": "b2", "b3-fp32": "b3", "b4-fp32": "b4",
                "b3-b4-fp32": "b3-b4"}
_MASKED = {"b2-masked": "b2", "b3-masked": "b3", "b4-masked": "b4",
           "b3-b4-masked": "b3-b4"}
# The head-dim 32 and 256 forms: the parent is built at each case's head
# dim (wide_source).
_WIDE = {"b2-wide": "b2", "b3-wide": "b3", "b4-wide": "b4", "b3-b4-wide": "b3-b4",
         "b7-wide": "b7", "b8-wide": "b8", "b9-wide": "b9", "b10-wide": "b10",
         "b5-wide": "b5", "b6-wide": "b6"}
WIDE_HEAD_DIMS = (32, 256)
_SAME_PROBLEM = {**_FP32_BODIES, **_MASKED, **_WIDE, "b7-fp32": "b7"}


def backward_of(kernel: str) -> str:
    """The kernel whose problem, bound and wrappers `kernel` takes:
    b2-fp32's is b2's, b7-fp32's b7's, and so on; any other kernel's its
    own."""
    return _SAME_PROBLEM.get(kernel, kernel)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The backward's entry points with a workspace and without a window, sinks
# or segment ids (193d270 to 2e67868).
WORKSPACE_ARGTYPES = {
    "cfa_fa2_backward_fused": [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P, _P],
    "cfa_fa2_backward_workspace": [_I] * 8,
    "cfa_fa2_backward_dq_reduce": [_P, _P] + [_I] * 7 + [_F] + [_I] * 2 + [_P],
    "cfa_fa2_backward_dkv": [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P, _P],
    "cfa_fa2_backward_dq": [_P] * 7 + [_I] * 7 + [_F, _F] + [_I] * 3 + [_P, _P],
}


def packed_ids(b: int, s: int, n_docs: int, seed: int = 0) -> torch.Tensor:
    """[b, s] int32 ids of n_docs contiguous documents a row, cut at seeded
    random points (chip_smoke phase 26's packing)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), n_docs - 1, replace=False))
        ids[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return torch.from_numpy(ids)


def b2_problem(case, gen):
    """The case's padded inputs on gen's device as chip_smoke's bwd_problem
    builds them: q, k, v, dO random, O and lse from B1; B2's keyword
    arguments (with the case's window, sinks and packed segment ids); the
    raw (unpadded) q, k, v, dO."""
    dt, tile = b1_ab.dtype_of(case["dtype"]), b1_ab.dtype_of(case["tile"])
    b, s, d = case["b"], case["s"], case["d"]
    q, do = (torch.randn(b, case["hq"], s, d, generator=gen, device=gen.device)
             .to(dt) for _ in range(2))
    k, v = (torch.randn(b, case["hkv"], s, d, generator=gen, device=gen.device)
            .to(dt) for _ in range(2))
    raw = (q, k, v, do)
    ids = (packed_ids(b, s, case["segments"]).to(gen.device)
           if case.get("segments") else None)
    window, sinks = attention._window_of(case.get("window"), case.get("sinks", 0),
                                         case["causal"], q, k)
    q, k, v, scale, _, kv_len = attention._prepare(
        q, k, v, case["causal"], None, tile, ids, ids, window, sinks)
    q_seg, kv_seg = attention._segments_of(ids, ids, q, k)
    kw = dict(causal=case["causal"], sm_scale=scale, kv_len=kv_len,
              tile_dtype=tile)
    if window is not None or ids is not None:
        kw.update(window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = fa2.fa2_forward_aligned(q, k, v, **kw)
    do = F.pad(do, (0, 0, 0, q.shape[2] - s)).contiguous()
    return (q, k, v, o, do, lse), kw, raw


def masked_pairs(case) -> int:
    """(query, key) pairs that attend under the case's causal flag, window,
    sinks and segment ids, over the unpadded rows, summed over the batch."""
    ids = (packed_ids(case["b"], case["s"], case["segments"])
           if case.get("segments") else None)
    mask = build_element_mask(case["s"], case["s"], causal=case["causal"],
                              kv_len=case["s"], device="cpu",
                              window=case.get("window"), sinks=case.get("sinks", 0),
                              q_seg=ids, kv_seg=ids)
    return int(mask.expand(case["b"], 1, case["s"], case["s"]).sum())


def split_problem(case, gen):
    """B3's or B4's inputs: b2_problem's with D_i = rowsum(dO * O) in fp32
    in place of O, as attention._backward hands them over."""
    (q, k, v, o, do, lse), kw, raw = b2_problem(case, gen)
    di = (o.float() * do.float()).sum(dim=-1)
    return (q, k, v, do, lse, di), kw, raw


def b9_problem(case, gen):
    """B9's or B10's inputs: q, k, v [B, H, S, D] fp32, sm_scale 1/sqrt(D)."""
    q, k, v = (torch.randn(case["b"], case["hq"], case["s"], case["d"],
                           generator=gen, device=gen.device) for _ in range(3))
    return (q, k, v), dict(sm_scale=case["d"] ** -0.5, kv_len=case["s"]), (q, k, v)


def b1_fp32_problem(case, gen):
    """b1_ab's padded q, k, v and keyword arguments (fp32, tile code 0)."""
    q, k, v, kw, _ = b1_ab.problem(case, gen)
    return (q, k, v), kw, (q, k, v)


def b8_problem(case, gen):
    """phase 16's B8 inputs: q, k, v [B, H, S, 64] fp32 padded as the API
    pads them (attention._prepare), B8's keyword arguments and the raw q, k,
    v in SDPA's input type (the tile type, else fp32)."""
    tile = b1_ab.dtype_of(case["tile"])
    raw = [torch.randn(case["b"], case["hq"], case["s"], case["d"], generator=gen,
                       device=gen.device) for _ in range(3)]
    q, k, v, scale, _, kv_len = attention._prepare(
        *raw, case["causal"], None, tile, None, None, None, 0)
    if not attention._use_small_kernel(q, k):
        raise AssertionError(f"B8 {case['name']}: the route does not take B8")
    kw = dict(causal=case["causal"], sm_scale=scale, kv_len=kv_len, tile_dtype=tile)
    return (q, k, v), kw, tuple(t.to(tile or torch.float32) for t in raw)


def b5_pages(case, gen, num_pages):
    """A paged cache [Hkv, num_pages, 128, D] of the case's storage: int8
    codes with small scales and bf16 values with unit scales (phase 3's),
    fp8 and int4 pages by the cache's own quantizer (phase 20's)."""
    shape = (case["hkv"], num_pages, 128, case["d"])
    cache = case["cache"]
    if cache in ("int8", "bf16"):
        def pages_of():
            if cache == "int8":
                return torch.randint(-127, 128, shape, generator=gen,
                                     device=gen.device, dtype=torch.int8)
            return torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)

        def scales_of():
            if cache == "int8":
                return torch.rand(shape[:3], generator=gen, device=gen.device) * 0.02 + 1e-3
            return torch.ones(shape[:3], device=gen.device)
        return kv_cache.KVPages(pages_of(), scales_of(), pages_of(), scales_of())
    storage = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
               "int4": "int4"}[cache]
    dtype, _, packed = kv_cache._resolve_cache_dtype(storage, case["d"])

    def pair():
        return kv_cache._quantize_rows(
            torch.randn(shape, generator=gen, device=gen.device), dtype, packed)

    (kp, ks), (vp, vs) = pair(), pair()
    return kv_cache.KVPages(kp, ks, vp, vs)


def b5_problem(case, gen):
    """B5's inputs at the case's shape: q [n, Hq, D] in the compute type,
    the pages, a shuffled page table [n, pps] (page 0 is the null page) and
    the lengths; B5's keyword arguments; and q, whose size the bound
    counts."""
    n, pps = len(case["lengths"]), case["pps"]
    num_pages = n * pps + 1
    pages = b5_pages(case, gen, num_pages)
    table = (torch.randperm(num_pages - 1, generator=gen, device=gen.device) + 1
             ).reshape(n, pps).to(torch.int32).contiguous()
    lengths = torch.tensor(case["lengths"], dtype=torch.int32, device=gen.device)
    cdt = b1_ab.dtype_of(case["compute"])
    q = torch.randn(n, case["hq"], case["d"], generator=gen, device=gen.device).to(cdt)
    kw = dict(sm_scale=case["d"] ** -0.5, compute_dtype=cdt)
    return (q, pages, table, lengths), kw, (q,)


def b6_problem(case, gen):
    """B6's inputs at the case's shape: q [n, T, Hq, D] in the compute
    type, b5_problem's pages, page table and lengths; B6's keyword
    arguments; and q, whose size the bound counts."""
    (_, pages, table, lengths), kw, _ = b5_problem(case, gen)
    q = torch.randn(len(case["lengths"]), case["T"], case["hq"], case["d"],
                    generator=gen, device=gen.device).to(kw["compute_dtype"])
    return (q, pages, table, lengths), kw, (q,)


def x_problem(case, gen):
    """X's inputs: bf16 q, k, v [B, H, S, 128] (r5_d128_fwd.main's), the
    variant as keyword argument, and q, k, v."""
    q, k, v = (torch.randn(case["b"], case["hq"], case["s"], case["d"], generator=gen,
                           device=gen.device).to(torch.bfloat16) for _ in range(3))
    return (q, k, v), dict(variant=case["variant"]), (q, k, v)


def b7_problem(case, gen):
    """Phase 19's B7 inputs (chip_smoke.quant_problem): q in the compute
    type, K/V quantized per token to the case's storage, each sequence
    padded to the 128 block grid as the public API pads; B7's keyword
    arguments; and the padded inputs, whose sizes the bound counts."""
    cdt = b1_ab.dtype_of(case["tile"] or case["dtype"])
    b, hq, hkv, s, d = (case[k] for k in ("b", "hq", "hkv", "s", "d"))
    q = torch.randn(b, hq, s, d, generator=gen, device=gen.device).to(cdt)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device=gen.device)
            for _ in range(2))
    storage = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
               "e5m2": torch.float8_e5m2}.get(case["storage"], case["storage"])
    x = fq.aligned_inputs(q, *quant.quantize_kv(k, v, storage))
    kw = dict(causal=case["causal"], sm_scale=d ** -0.5, kv_len=s, compute_dtype=cdt)
    return x, kw, x


def problem(kernel: str, case, gen):
    """(the kernel's inputs, its keyword arguments, the raw q, k, v[, dO])."""
    return {"b2": b2_problem, "b3": split_problem, "b4": split_problem,
            "b3-b4": b2_problem, "b9": b9_problem, "b10": b9_problem,
            "b1-fp32": b1_fp32_problem, "b8": b8_problem,
            "b5": b5_problem, "b6": b6_problem, "b7": b7_problem,
            "x": x_problem}[backward_of(kernel)](case, gen)


def attended_columns(lengths, chunk: int) -> int:
    """(row, column) pairs of a paged call: row t of a slot of total length
    L attends max(0, L - T + t + 1) columns (chip_smoke.paged_bound)."""
    return sum(max(0, n - chunk + t + 1) for n in lengths for t in range(chunk))


def flops(kernel: str, case) -> int:
    if backward_of(kernel) in ("b5", "b6"):  # 4 D FLOPs per (query head, attended column)
        return 4 * case["d"] * case["hq"] * attended_columns(case["lengths"],
                                                             case.get("T", 1))
    if kernel in _MASKED:
        return _MATMULS[backward_of(kernel)] * 2 * case["hq"] * masked_pairs(case) * case["d"]
    pairs = b1_ab.attended_pairs(case["s"], case["s"], case["causal"])
    return _MATMULS[backward_of(kernel)] * 2 * case["b"] * case["hq"] * pairs * case["d"]


def b8_padded(case) -> int:
    """B8's padded sequence length at the case's S (attention._prepare)."""
    quantum = seq_pad_quantum(case["s"], torch.float32)
    return -(-case["s"] // quantum) * quantum


def paged_bytes(case) -> int:
    """chip_smoke.paged_bound's bytes (B5 at chunk 1, B6 at T): each live
    token's K and V row and scale once (int4 at half a byte an element), q
    and the output, the live page ids and the lengths."""
    lengths, d = case["lengths"], case["d"]
    elem = {"int4": 0.5, "bf16": 2, "fp32": 4}.get(case["cache"], 1)
    qb = (len(lengths) * case.get("T", 1) * case["hq"] * d
          * (2 if case["compute"] == "bf16" else 4))
    live_pages = sum(-(-n // 128) for n in lengths)
    return (2 * sum(lengths) * case["hkv"] * (d * elem + 4) + 2 * qb
            + live_pages * 4 + 4 * len(lengths))


def bound(kernel: str, case, raw) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): each input read once and each output
    written once (B2 and the pair: q, k, v, O, dO, lse in, dQ, dK, dV out;
    B3: q, k, v, dO, lse, D_i in, dQ out; B4: the same in, dK, dV out; B9,
    B10: q, k, v in, O out; B1 and X: q, k, v in, O and lse out; B5 and
    B6: paged_bytes; B7: q, K/V in their stored width and their scales in,
    O and lse out, all padded as the API pads), or the FLOPs at the compute
    type's peak."""
    if backward_of(kernel) in ("b5", "b6"):
        moved = paged_bytes(case)
        peak = b1_ab.PEAK_FLOPS[case["compute"]]
    elif backward_of(kernel) == "b7":  # chip_smoke.attention_bound's tensors
        q = raw[0]
        moved = (2 * q.numel() * q.element_size() + sum(t.numel() * t.element_size()
                                                        for t in raw[1:])
                 + q[..., 0].numel() * 4)
        peak = b1_ab.PEAK_FLOPS[case["tile"] or case["dtype"]]
    elif backward_of(kernel) == "b8":  # padded q, k, v, O in fp32 and lse, as chip_smoke
        cells = case["b"] * case["hq"] * b8_padded(case)
        moved = 4 * cells * case["d"] * 4 + cells * 4
        peak = b1_ab.PEAK_FLOPS[case["tile"] or case["dtype"]]
    else:
        q, k = raw[0], raw[1]
        qb = q.numel() * q.element_size()
        kvb = 2 * k.numel() * k.element_size()
        stat = case["b"] * case["hq"] * case["s"] * 4
        moved = {"b2": 4 * qb + 2 * kvb + stat, "b3-b4": 4 * qb + 2 * kvb + stat,
                 "b3": 3 * qb + kvb + 2 * stat, "b4": 2 * qb + 2 * kvb + 2 * stat,
                 "b1-fp32": 2 * qb + kvb + stat,
                 "x": 2 * qb + kvb + stat}.get(backward_of(kernel), 2 * qb + kvb)
        peak = b1_ab.PEAK_FLOPS[case["tile"] or case["dtype"]]
    t_bytes = moved / b1_ab.HBM_BYTES_PER_S
    t_ops = flops(kernel, case) / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def library_call(kernel: str, case, raw, kw):
    """One PyTorch call computing the same function: the aten flash backward
    (fed by its own forward) in the tile type for B2 and the pair B3 + B4,
    with K/V expanded to the query heads, and for their fp32 bodies SDPA's
    memory-efficient fp32 backward (fp32_bwd.efficient_backward) so; none
    for B3 or B4 alone (dQ, or dK and dV, without the rest), B5, B6 or B7; fp32
    SDPA for B9 and B10, and for B1 on the keys before kv_len, K/V expanded
    to the query heads, causal as the case; bf16 SDPA for X (its yardstick:
    X's P is JAX's bf16 exp chain, not SDPA's)."""
    if backward_of(kernel) in ("b3", "b4", "b5", "b6", "b7"):
        return None
    if kernel in _MASKED:  # SDPA's backward with the mask as its bias
        q, k, v, do = raw
        groups = q.shape[1] // k.shape[1]
        k, v = (t.repeat_interleave(groups, dim=1) for t in (k, v))
        ids = (packed_ids(case["b"], case["s"], case["segments"]).to(q.device)
               if case.get("segments") else None)
        mask = build_element_mask(case["s"], case["s"], causal=case["causal"],
                                  kv_len=case["s"], device=q.device,
                                  window=kw.get("window"), sinks=kw.get("sinks", 0),
                                  q_seg=ids, kv_seg=ids)
        return fp32_bwd.masked_backward(q, k, v, do, kw["sm_scale"], mask)
    if backward_of(kernel) == "b8":  # SDPA on the raw inputs in the tile type
        return lambda: F.scaled_dot_product_attention(
            *raw, is_causal=case["causal"], scale=kw["sm_scale"])
    if kernel == "x":
        return lambda: F.scaled_dot_product_attention(*raw, scale=case["d"] ** -0.5)
    if backward_of(kernel) in ("b9", "b10"):
        q, k, v = raw
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=kw["sm_scale"])
    if kernel == "b1-fp32":
        q, k, v = raw
        groups, n = q.shape[1] // k.shape[1], kw["kv_len"]
        k, v = (t[:, :, :n].repeat_interleave(groups, dim=1) for t in (k, v))
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kw["causal"], scale=kw["sm_scale"])
    q, k, v, do = raw
    groups = q.shape[1] // k.shape[1]
    if kernel in _FP32_BODIES:
        k, v = (t.repeat_interleave(groups, dim=1) for t in (k, v))
        return fp32_bwd.efficient_backward(q, k, v, do, kw["sm_scale"], case["causal"])
    tile = b1_ab.dtype_of(case["tile"])
    q, k, v, do = (t.to(tile) for t in raw)
    k, v = (t.repeat_interleave(groups, dim=1) for t in (k, v))
    out = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, case["causal"], False, scale=kw["sm_scale"])
    o, lse, cq, ck, mq, mk, seed, offset = out[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, case["causal"], seed, offset,
        scale=kw["sm_scale"])


def wide_source(path: str, head_dim: int) -> str:
    """A source beside PATH that builds it at one head dim (as
    csrc/fa2_backward_d32.cu builds csrc/fa2_backward.cu), named with the
    head dim and PATH's digest, so that an edited parent is rebuilt.  A
    parent that ignores CFA_HEAD_DIMS (B1-B6 before PR 17's widths, B7-B10
    before PR 19's) launches nothing at those widths: its calls fail."""
    src = Path(path)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = src.with_name(f"{src.stem}_d{head_dim}.cu")
    out.write_text(f"// {src.name} ({digest}) at head dim {head_dim}.\n"
                   f"#define CFA_HEAD_DIMS(X) X({head_dim})\n#include \"{src.name}\"\n")
    return str(out)


def source_text(path: str) -> str:
    """PATH's text, or for a wide_source the text of the source it builds."""
    text = Path(path).read_text()
    included = re.search(r'#include "(\w+\.cu)"', text)
    return Path(path).with_name(included.group(1)).read_text() if included else text


def build_parent(kernel: str, path: str):
    """The parent's library, typed as its wrapper calls it; for the
    head-dim 32 and 256 forms ({kernel}-wide) one library a head dim."""
    if kernel in _WIDE:
        return {d: build_parent(backward_of(kernel), wide_source(path, d))
                for d in WIDE_HEAD_DIMS}
    kernel = backward_of(kernel)
    if kernel == "b1-fp32":
        return b1_ab.build_parent(path)
    lib = b1_ab.compile_source(path, f"{Path(path).stem}_parent")
    if kernel == "b8":  # typed by the parameter list in its source
        params = b1_ab.entry_params(source_text(path), "cfa_fa2_forward_small")
        lib.cfa_fa2_forward_small.argtypes = [t for _, t in params]
        lib.cfa_fa2_forward_small.restype = _I
        lib.b8_params = [n for n, _ in params]
        return lib
    if kernel == "x":
        lib.cfa_r5_d128_fwd.argtypes = r5.ARGTYPES
        lib.cfa_r5_d128_fwd.restype = _I
        return lib
    if kernel == "b7":  # typed by the parameter list in its source
        params = b1_ab.entry_params(source_text(path), "cfa_fa2_forward_quant")
        lib.cfa_fa2_forward_quant.argtypes = [t for _, t in params]
        lib.cfa_fa2_forward_quant.restype = _I
        lib.b7_params = [n for n, _ in params]
        return lib
    if kernel == "b6":
        if hasattr(lib, "cfa_paged_chunk_workspace_floats"):
            for name, argtypes in dec_attn.CHUNK_ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
            lib.cfa_paged_chunk_workspace_floats.restype = ctypes.c_longlong
        else:  # 7af2811's: one block per (64-row tile, slot, KV head)
            lib.cfa_paged_chunk.argtypes = [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3 + [_P]
        lib.cfa_paged_chunk.restype = _I
        return lib
    if kernel == "b5":
        if hasattr(lib, "cfa_paged_decode_workspace_floats"):
            for name, argtypes in dec_attn.ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
            lib.cfa_paged_decode_workspace_floats.restype = ctypes.c_longlong
        else:  # one block per (slot, KV head), no workspace
            lib.cfa_paged_decode.argtypes = [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
        lib.cfa_paged_decode.restype = _I
        return lib
    if kernel in ("b2", "b3", "b4", "b3-b4"):
        if hasattr(lib, "cfa_fa2_backward_workspace"):
            masks = hasattr(lib, "cfa_fa2_backward_masks")
            for name, argtypes in (bwd.ARGTYPES if masks
                                   else WORKSPACE_ARGTYPES).items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = _I
            lib.cfa_fa2_backward_workspace.restype = ctypes.c_longlong
        elif kernel == "b2":
            lib.cfa_fa2_backward_fused.argtypes = [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
            lib.cfa_fa2_backward_fused.restype = _I
        else:
            lib.cfa_fa2_backward_dq.argtypes = [_P] * 7 + [_I] * 7 + [_F, _F] + [_I] * 3 + [_P]
            lib.cfa_fa2_backward_dkv.argtypes = [_P] * 8 + [_I] * 7 + [_F] + [_I] * 3 + [_P]
            lib.cfa_fa2_backward_dq.restype = _I
            lib.cfa_fa2_backward_dkv.restype = _I
    else:
        lib.cfa_fa1_forward.argtypes = [_P] * 6 + [_I] * 5 + [_F, _P]
        lib.cfa_fa1_forward.restype = _I
        lib.cfa_naive_fa2_forward.argtypes = [_P] * 4 + [_I] * 5 + [_F, _P]
        lib.cfa_naive_fa2_forward.restype = _I
    return lib


def takes_masks(lib) -> bool:
    """Whether a parent backward source takes the window, the sinks and
    segment ids (it exports cfa_fa2_backward_masks)."""
    return hasattr(lib, "cfa_fa2_backward_masks")


def _masks(lib, q, k, window, sinks, q_seg, kv_seg):
    """(the mask arguments after the causal flag of B2, B3 or B4, those of
    the reduce, the tensors holding the ids) for a parent that takes them;
    nothing for one that does not (it computes the call without them)."""
    if not takes_masks(lib):
        return (), (), None
    held, q_ids, kv_ids = fa2.seg_args(q_seg, kv_seg, q.shape[0], q.shape[2],
                                       k.shape[2])
    win = NO_WINDOW if window is None else int(window)
    return (win, int(sinks), q_ids, kv_ids), (win, int(sinks)), held


def parent_b2(lib, q, k, v, o, do, lse, *, causal, sm_scale, kv_len, tile_dtype,
              window=None, sinks=0, q_seg=None, kv_seg=None):
    """The parent's wrapper: with a workspace (a source exporting
    cfa_fa2_backward_workspace) the kernel writes the live dQ slices and
    its reduce adds them, as the wrappers of its interface call them (with
    the window, sinks and ids where it takes them); without one the kernel
    writes every slice and torch sums them."""
    masks, reduce_masks, held = _masks(lib, q, k, window, sinks, q_seg, kv_seg)
    b, hq, sq, d = q.shape
    in_bf16, tiles = int(q.dtype == torch.bfloat16), tile_code(q.dtype, tile_dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_slices = -(-k.shape[2] // bwd.fused_kv_tile(q.dtype, tile_dtype, d))
    dq_part = torch.empty((b, hq, n_slices, sq, d), device=q.device,
                          dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    tail = [stream]
    reduce = hasattr(lib, "cfa_fa2_backward_workspace")
    if reduce:
        n = lib.cfa_fa2_backward_workspace(b, hq, k.shape[1], sq, k.shape[2], d,
                                           in_bf16, tiles)
        workspace = torch.empty(n, device=q.device, dtype=torch.uint8)
        tail.insert(0, workspace.data_ptr())
    err = lib.cfa_fa2_backward_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_part.data_ptr(), b, hq,
        k.shape[1], sq, k.shape[2], d, kv_len, sm_scale * LOG2E, int(causal),
        *masks, in_bf16, tiles, *tail)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "parent fa2_backward_fused")
    if not reduce:
        return dq_part.sum(dim=2).mul_(sm_scale).to(q.dtype), dk, dv
    dq = torch.empty_like(q)
    err = lib.cfa_fa2_backward_dq_reduce(
        dq_part.data_ptr(), dq.data_ptr(), b, hq, sq, k.shape[2], d, kv_len,
        int(causal), *reduce_masks, sm_scale, in_bf16, tiles, stream)
    _build.check(lib, "cfa_fa2_backward_error_string", err, "parent dq_reduce")
    del held
    return dq, dk, dv


def _parent_split(lib, name, q, k, tensors, outs, scales, *, causal, kv_len,
                  tile_dtype, window=None, sinks=0, q_seg=None, kv_seg=None):
    """The parent's B3 or B4 entry point `name` on `tensors` (q, k, v, dO,
    lse, D_i) into `outs`, with the workspace where its source takes one
    (and the window, sinks and ids where it takes them)."""
    masks, _, held = _masks(lib, q, k, window, sinks, q_seg, kv_seg)
    b, hq, sq, d = q.shape
    in_bf16, tiles = int(q.dtype == torch.bfloat16), tile_code(q.dtype, tile_dtype)
    tail = [torch.cuda.current_stream(q.device).cuda_stream]
    if hasattr(lib, "cfa_fa2_backward_workspace"):
        n = lib.cfa_fa2_backward_workspace(b, hq, k.shape[1], sq, k.shape[2], d,
                                           in_bf16, tiles)
        workspace = torch.empty(n, device=q.device, dtype=torch.uint8)
        tail.insert(0, workspace.data_ptr())
    err = getattr(lib, name)(
        *(t.data_ptr() for t in tensors + outs), b, hq, k.shape[1], sq,
        k.shape[2], d, kv_len, *scales, int(causal), *masks, in_bf16, tiles,
        *tail)
    _build.check(lib, "cfa_fa2_backward_error_string", err, f"parent {name}")
    del held
    return outs


def parent_b3(lib, q, k, v, do, lse, di, *, sm_scale, **kw):
    return _parent_split(lib, "cfa_fa2_backward_dq", q, k, (q, k, v, do, lse, di),
                         (torch.empty_like(q),), (sm_scale * LOG2E, sm_scale), **kw)


def parent_b4(lib, q, k, v, do, lse, di, *, sm_scale, **kw):
    return _parent_split(lib, "cfa_fa2_backward_dkv", q, k, (q, k, v, do, lse, di),
                         (torch.empty_like(k), torch.empty_like(v)),
                         (sm_scale * LOG2E,), **kw)


def split_pair(b3, b4):
    """attention._backward's split branch over B2's inputs with the given
    B3 and B4 calls: D_i = rowsum(dO * O) in fp32, then B3, then B4;
    returns (dQ, dK, dV)."""
    def pair(q, k, v, o, do, lse, **kw):
        di = (o.float() * do.float()).sum(dim=-1)
        return (*b3(q, k, v, do, lse, di, **kw), *b4(q, k, v, do, lse, di, **kw))
    return pair


def parent_pair(lib, *args, **kw):
    return split_pair(functools.partial(parent_b3, lib),
                      functools.partial(parent_b4, lib))(*args, **kw)


def current_b3(*args, **kw):
    return (bwd.fa2_backward_dq_aligned(*args, **kw),)


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


def parent_b8(lib, q, k, v, *, causal, sm_scale, kv_len, tile_dtype):
    """The parent's wrapper: fa2_forward_small_aligned's checks and
    allocations, its C entry point called with the parameters its source
    declares (before windows; with window and sinks; now with ids and
    heads too); no window, sinks or ids."""
    b, h, s_pad, d = q.shape
    fa2._check_inputs("fa2_forward_small", q, k, v, tile_dtype)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_pad), device=q.device, dtype=torch.float32)
    values = dict(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
        lse=lse.data_ptr(), q_seg=None, kv_seg=None, n_slots=b * h, heads=h,
        s_pad=s_pad, head_dim=d, kv_len=kv_len, qscale=sm_scale * LOG2E,
        causal=int(causal), window=NO_WINDOW, sinks=0,
        in_bf16=int(q.dtype == torch.bfloat16), tiles=tile_code(q.dtype, tile_dtype),
        stream=torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.cfa_fa2_forward_small(*(values[n] for n in lib.b8_params))
    _build.check(lib, "cfa_fa2_forward_small_error_string", err,
                 "parent fa2_forward_small")
    return o, lse


def parent_b5(lib, q, pages, table, lengths, *, sm_scale, compute_dtype):
    """The parent's wrapper: a source exporting
    cfa_paged_decode_workspace_floats (a variant of the split-KV kernel
    whose entry point takes window and sinks, as the current one does) is
    launched as the current wrapper launches it; an earlier one takes no
    split count, workspace or counters."""
    if hasattr(lib, "cfa_paged_decode_workspace_floats"):
        return (dec_attn.decode_launch(lib, q, pages, table, lengths,
                                       sm_scale=sm_scale,
                                       compute_dtype=compute_dtype),)
    n, hq, d = q.shape
    hkv, num_pages, page, _ = pages.k_pages.shape
    tensors = dec_attn._check_kernel_inputs("paged_decode", q, pages, table,
                                            lengths, hq // hkv)
    out = torch.empty_like(q)
    err = lib.cfa_paged_decode(
        *(t.data_ptr() for t in tensors), out.data_ptr(), n, hq, hkv, num_pages,
        page, table.shape[1], d, float(sm_scale), int(q.dtype == torch.bfloat16),
        dec_attn._cache_code(pages, d), int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_paged_decode_error_string", err, "parent paged_decode")
    return (out,)


def parent_b6(lib, q, pages, table, lengths, *, sm_scale, compute_dtype):
    """The parent's wrapper: a source exporting
    cfa_paged_chunk_workspace_floats (a variant of the current kernel whose
    entry point takes window and sinks) is launched as the current wrapper
    launches it; an earlier one takes no split count, workspace or
    counters."""
    if hasattr(lib, "cfa_paged_chunk_workspace_floats"):
        return (dec_attn.chunk_launch(lib, q, pages, table, lengths,
                                      sm_scale=sm_scale,
                                      compute_dtype=compute_dtype),)
    n, chunk, hq, d = q.shape
    hkv, num_pages, page, _ = pages.k_pages.shape
    tensors = dec_attn._check_kernel_inputs("paged_chunk", q, pages, table,
                                            lengths, hq // hkv)
    out = torch.empty_like(q)
    err = lib.cfa_paged_chunk(
        *(t.data_ptr() for t in tensors), out.data_ptr(), n, chunk, hq, hkv,
        num_pages, page, table.shape[1], d, float(sm_scale),
        int(q.dtype == torch.bfloat16), dec_attn._cache_code(pages, d),
        int(compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_paged_chunk_error_string", err, "parent paged_chunk")
    return (out,)


def parent_b7(lib, *x, **kw):
    """The parent's wrapper: the current checks and allocations
    (fa2_forward_quant.quant_args), its C entry point called with the
    parameters its source declares (before windows and segment ids: no
    q_seg, kv_seg, window or dead-row tiles); no window or ids."""
    values, o, lse, _held = fq.quant_args(*x, **kw)
    err = lib.cfa_fa2_forward_quant(*(values[n] for n in lib.b7_params))
    _build.check(lib, "cfa_fa2_forward_quant_error_string", err,
                 "parent fa2_forward_quant")
    return o, lse


def parent_x(lib, q, k, v, *, variant):
    return r5.launch(lib, q, k, v, variant)


def calls(kernel: str):
    """(the parent's wrapper, taking the library first; the current one),
    each returning a tuple of outputs.  The head-dim 32 and 256 forms pick
    the parent's library of q's head dim."""
    if kernel in _WIDE:
        parent, current = calls(backward_of(kernel))
        return (lambda libs, q, *x, **kw: parent(libs[q.shape[-1]], q, *x, **kw),
                current)
    return {
        "b2": (parent_b2, bwd.fa2_backward_fused_aligned),
        "b3": (parent_b3, current_b3),
        "b4": (parent_b4, bwd.fa2_backward_dkv_aligned),
        "b3-b4": (parent_pair, split_pair(current_b3, bwd.fa2_backward_dkv_aligned)),
        "b9": (parent_b9, lambda *a, **k: (baselines.fa1_aligned(*a, **k),)),
        "b10": (parent_b10, lambda *a, **k: (baselines.naive_fa2_aligned(*a, **k),)),
        "b1-fp32": (b1_ab.parent_forward, fa2.fa2_forward_aligned),
        "b8": (parent_b8, fa2.fa2_forward_small_aligned),
        "b5": (parent_b5, lambda *a, **k: (dec_attn.paged_decode_attention(*a, **k),)),
        "b6": (parent_b6, lambda *a, **k: (dec_attn.paged_chunk_attention(*a, **k),)),
        "b7": (parent_b7, fq.fa2_forward_quant_aligned),
        "x": (parent_x, r5.fwd),
    }[backward_of(kernel)]


def shape_of(kernel: str, case) -> dict:
    """The case's shape as its JSON line reports it."""
    if backward_of(kernel) in ("b5", "b6"):
        return dict(slots=len(case["lengths"]), T=case.get("T", 1), Hq=case["hq"],
                    Hkv=case["hkv"], D=case["d"], pages_per_seq=case["pps"],
                    lengths=case["lengths"], cache=case["cache"],
                    compute=case["compute"])
    if kernel == "x":
        return dict(B=case["b"], H=case["hq"], S=case["s"], D=case["d"],
                    variant=case["variant"])
    shape = dict(B=case["b"], Hq=case["hq"], Hkv=case["hkv"], S=case["s"],
                 D=case["d"], causal=case["causal"], inputs=case["dtype"],
                 tiles=case["tile"])
    if backward_of(kernel) == "b7":
        shape["storage"] = case["storage"]
    return shape


def x_extras(case, raw, bound_ms: float) -> dict:
    """X's line adds B1 (one pass, non-causal, bf16 tiles) on the same
    inputs, back to back and queued, and the two-pass floor: X computes
    Q K^T twice, 1.5x the products of one pass."""
    q, k, v = raw
    kw = dict(causal=False, sm_scale=case["d"] ** -0.5, kv_len=case["s"],
              tile_dtype=torch.bfloat16)

    def b1():
        return fa2.fa2_forward_aligned(q, k, v, **kw)

    return dict(b1_ms=b1_ab.time_ms(b1), b1_device_ms=b1_ab.device_ms(b1),
                two_pass_floor_ms=1.5 * bound_ms)


def b7_extras(case, x, kw) -> dict:
    """B7's line adds B1 and SDPA on the dequantized K/V (values times
    scales, in the compute type), back to back and queued: yardsticks of
    the stored-width read, not B7's function."""
    q, kv, ks, vv, vs = x
    cdt, s, d = kw["compute_dtype"], case["s"], case["d"]
    kd, vd = ((kv_storage_cast(t, d, torch.float32) * sc[..., None]).to(cdt)
              for t, sc in ((kv, ks), (vv, vs)))
    b1_kw = dict(causal=case["causal"], sm_scale=kw["sm_scale"], kv_len=s,
                 tile_dtype=None if cdt == torch.float32 else cdt)

    def b1():
        return fa2.fa2_forward_aligned(q, kd, vd, **b1_kw)

    qs, ks_, vs_ = q[:, :, :s], kd[:, :, :s], vd[:, :, :s]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks_, vs_, is_causal=case["causal"],
                                              scale=kw["sm_scale"], enable_gqa=True)

    return dict(b1_dequant_ms=b1_ab.time_ms(b1), b1_dequant_device_ms=b1_ab.device_ms(b1),
                sdpa_dequant_ms=b1_ab.time_ms(sdpa),
                sdpa_dequant_device_ms=b1_ab.device_ms(sdpa))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=tuple(CASES))
    ap.add_argument("--parent", required=True,
                    help="an earlier csrc/fa2_backward.cu (b2, b3, b4, b3-b4 and "
                    "their -fp32 and -masked forms), csrc/baselines.cu (b9, b10), "
                    "csrc/fa2_forward.cu (b1-fp32), csrc/fa2_forward_small.cu "
                    "(b8), csrc/paged_decode.cu (b5), csrc/paged_chunk.cu (b6), "
                    "csrc/fa2_forward_quant.cu (b7, b7-fp32) or "
                    "csrc/r5_d128_fwd.cu (x)")
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

        # A parent without the masks computes the call without them: its
        # outputs are another function's.
        same_function = args.kernel not in _MASKED or takes_masks(lib)
        diff = (max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(old(), new())) if same_function else None)
        order = (old, new, new, old)
        turns = [b1_ab.time_ms(fn) for fn in order]
        device_turns = [b1_ab.device_ms(fn) for fn in order]
        parent_ms, new_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        parent_dev = (device_turns[0] + device_turns[3]) / 2
        new_dev = (device_turns[1] + device_turns[2]) / 2
        n_flops = flops(args.kernel, case)
        library = library_call(args.kernel, case, raw, kw)
        bound_ms, bound_by = bound(args.kernel, case, raw)
        row = dict(kernel=args.kernel, case=case["name"],
                   **shape_of(args.kernel, case), turns_ms=turns,
                   device_turns_ms=device_turns, parent_ms=parent_ms,
                   ms=new_ms, speedup=parent_ms / new_ms,
                   parent_device_ms=parent_dev, device_ms=new_dev,
                   device_speedup=parent_dev / new_dev,
                   parent_tflops=n_flops / parent_dev / 1e9,
                   tflops=n_flops / new_dev / 1e9, bound_ms=bound_ms,
                   bound_by=bound_by,
                   library_ms=None if library is None else b1_ab.time_ms(library),
                   library_device_ms=(None if library is None
                                      else b1_ab.device_ms(library)),
                   max_abs_diff=diff, parent_host_us=b1_ab.host_us(old),
                   host_us=b1_ab.host_us(new))
        if args.kernel in _MASKED:
            row.update(window=kw.get("window"), sinks=kw.get("sinks", 0),
                       segments=case.get("segments", 0),
                       parent_function="same" if same_function else "global")
        if args.kernel == "x":
            row.update(x_extras(case, raw, bound_ms))
        elif backward_of(args.kernel) == "b7":
            row.update(b7_extras(case, x, kw))
        rows.append(row)
        print(f"{args.kernel.upper()} A/B", json.dumps(row), flush=True)
        del x, raw
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
