#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuda_flash_attention_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. setup: the card's name and power limit; the eight CUDA sources built
     from cuda_flash_attention_tpu_torch/csrc/ with nvcc (sm_90a), all at
     once; ptxas's registers, spills and wgmma notes for every
     instantiation of the backward's bf16/fp16-tile kernels (B2's
     prologue, main kernel and dQ reduce; B3's kernel; B4's, the main
     kernel without its dQ phase) and of the fp32 FMA block's (B10, B1's
     fp32 body, B8's fp32 body, the backward's `bwd_kv_fp32` (B4, and
     B2's with FUSED), `bwd_dq_fp32` (B3) and their fp32 prologue, at D 64
     and 128), of B5's split-KV kernel (48: six caches x two q types x
     D 64 and 128 x groups of at most 2 and 8), of B6's split-KV body (48:
     the same with fp32 compute on the FMA units and bf16 compute on the
     tensor cores), bf16 tile body (24) and fp32 tile body (24), of B7's
     wgmma and fp32 bodies (32: four storages x two q types x D 64 and 128
     each) and of X's five variants, failing on a spilled byte, a wgmma
     serialisation note or a missing instantiation;
  2. kernel B1 (FA2 forward) against its plain PyTorch version at the
     serving prefill shapes (the serving run's largest, B4 S1536, included)
     and at the train shape (B4 S2048), and at the edges of its 128-row
     wgmma tiles (scripts/b1_ab.py CASES: D 128, fp16 tiles on bf16
     inputs, Sq != Skv, S 16 and 112, kv_len inside the last box, GQA
     16/2), with its time, TFLOP/s, its bound and SDPA's time;
  3. kernel B5 (paged decode) against its plain version on int8 and bf16
     caches, each with bf16 and fp32 compute, ragged lengths and an
     inactive slot, device time (back-to-back time beside it) and bound;
  4. end to end at the base model's width in fp32: prefill logits and four
     greedy decode steps through DecodeEngine on the card (kernels) and on
     the CPU (plain versions), with the same seeded weights;
  5. serving: DecodeEngine.run at TransformerConfig.base() with an int8
     cache answers 12 requests of 64 tokens, with both kernels' launch counts;
  6. where a decode step's time goes at batch 8: host-clock step time and
     device busy time from one torch.profiler window, the top kernels and
     B5's time and share of the busy time;
  7. kernels B2, B3, B4 (FA2 backward) against their plain versions at the
     train shape (B4 Hq16 Hkv8 S2048 D64 causal bf16) and at D 128, fp32 at
     B1 S512 and a ragged S1000, B3 and B4 also at B16 S2048 (the
     split-route training shape); their fp32 bodies at the harness's fp32
     routes (B2 at Large-2, B3 and B4 at Stress-1) and B3 and B4 at the
     fp32 train shape; with times, bounds and the backward of PyTorch's
     flash attention (SDPA's memory-efficient backward in fp32); then
     torch.autograd.grad of flash_attention on both routes (fused B2;
     split B3 + B4, forced by 128-row BlockSizes) against the plain
     versions, and bitwise-equal gradients from two runs of each;
  8. one AdamW train step at the base width in fp32 on the card (kernels)
     and on the CPU (plain versions) from the same seeded weights;
  9. training TransformerConfig.base() (bf16) at B4 S2048: 2 warm-up and 3
     timed steps on one batch, tokens/s over the timed steps, mean and
     median step time, peak memory, the loss
     at each step, model FLOPs and their share of the bf16 peak, launches
     (the fused route); one more step with remat="full";
 10. where a train step's time goes at B4 S2048: one torch.profiler window;
 11. training at B16 S2048, where the port's dQ slices would pass 1 GiB
     and the step takes the split route (B3 + B4): two steps, launches;
 12. kernel B6 (paged chunk attention) against its plain version at the
     speculation shape (8 slots, T 5, ragged lengths to 2048, an inactive
     slot; int8 and bf16 caches, bf16 and fp32 compute) and the chunked-
     prefill shape (T 512, total lengths 512-2048), time and bound; T = 1
     against B5;
 13. fp32 at base width: verify_step logits on the card against the CPU;
     speculative greedy (k 3, a one-layer draft), a prefix-cache hit and
     chunked prefill (chunk 512, a 1300-token prompt) each give exactly
     the card's plain greedy tokens; B6's fp32 tile body's launches over
     the phase (the kernel line's `fp32_tile`);
 14. speculative serving at TransformerConfig.base() with an int8 cache:
     phase 5's 12 requests (24 new tokens each) with k 4, a one-layer draft
     and prompt lookup:
     tokens/s, acceptance, rounds, B1/B5/B6 launches, and where a round's
     time goes (one profiled window, as phase 6, with B6's time and share
     of a round's busy time);
 15. prefix caching: 16 requests sharing a 1024-token system prompt, TTFT
     of the hits against an uncached engine, shared pages, launches; then
     chunked prefill (chunk 512) on phase 5's mix: decode tokens emitted
     while prompts prefill;
 16. kernel B8 (small-shape FA2 forward) against its plain version at the
     reference suite's Small-1, Edge-NonPowerOf2 and Edge-SmallSeq in fp32,
     bf16 and fp16 tiles, causal and not, timed beside B1, the plain
     version and SDPA on the same inputs (device time: the launches queued
     behind a sleep kernel so that host gaps drop out); B9 (FA1), B10
     (naive FA2) and B1's fp32 body at Small-2, Large-2 and Stress-1 in
     fp32 beside fp32 SDPA; fp16 tiles of B1 at Stress-1 and of B2, B3, B4
     at Stress-1 and the train shape.
     Every fp16 check holds fp16 to its own gate and the bf16
     instantiation on the same inputs, as a control, beyond it;
 17. the CLI end to end on a Stress-1 data directory: fa2 forward,
     backward and forward_backward in fp32, fp16 and bf16, fa1, fa2-naive
     and naive forward, fa2 on an Edge-NonPowerOf2 directory (B8), one run
     in a subprocess; every written .bin against the fp32 oracle (fp16
     files by the fp16 gates, the bf16 run's files the control);
 18. the harness: the forward experiment (10 configs x fa2-naive, vanilla,
     fa2), fa1 forward and fa2 both, fp32 at tolerance 1e-3, every row
     printed; a FAIL row raises.  Every kernel of this path (B1, B2, B3,
     B4, B8, B9, B10) must launch in phases 17-18; B8's, B9's and B10's
     launches in the kernel line come from there;
 19. kernel B7 (FA2 forward over quantized K/V) against its plain version
     over int8, e4m3, e5m2 and int4 storage x bf16/fp32 compute x causal at
     B2 Hq16 Hkv8 S1000 D64 and D128; timed at B4 Hq16 Hkv8 S2048 D64 and
     B1 S8192 (causal bf16) beside B1 and SDPA on the dequantized bf16 K/V
     (yardsticks, not the same function), and in fp32 compute (int8) at
     the base shape beside B1's fp32 body on the dequantized fp32 K/V; the
     public quantized-KV API at both bf16 shapes, whose launches are B7's in
     the kernel line;
 20. B5 and B6 on e4m3, e5m2 and int4 pages at phases 3's and 12's shapes
     against their plain versions, times (back-to-back and device) and
     bounds (int4 at 0.5 byte);
 21. quantized serving at TransformerConfig.base(): phase 5's 12 requests
     on an int8 cache (the control), an e4m3 cache, an int4 cache, int8
     W8A8 weights and int4 weights (int8 caches), and chunked prefill 512
     on the int4 cache: tokens/s, mean step, TTFT, B1/B5/B6 launches; a
     profiled window of int4-weight decode steps; fp32 card-vs-CPU parity
     of an int4 cache with int4 weights at base width;
 22. QLoRA: two LoRA AdamW steps at base width, B4 S2048, on an int4 base
     (finite loss, base bytes unchanged, adapters moved, merge_lora logits
     within the int4 requantization budget);
 23. X (the D=128 rowsum probe) through its entry point at B4 H8 S2048
     D128 bf16 (five variants beside B1 and SDPA), each variant against
     its plain version;
 24. the serving and training benchmarks (bench/decode_bench.py,
     bench/train_bench.py) at TransformerConfig.base(): the decode device
     loop at batch 16, prompt 128 (a CUDA graph of one step: step_ms by
     CUDA events, eager_step_ms, their ratio); greedy tokens of the
     burst-8 engine, the burst-1 engine and an eager decode_step loop,
     which must be bitwise equal; the engine at bursts 1 and 8 with
     engine_overhead_x; phase 5's 12 requests at bursts 1 and 8 (the same
     tokens, graph replays, bursts, launches; burst 8 profiled as phase
     6, whose burst-1 launches and idle share it prints beside); train
     tokens/s at B4 S2048 (the median of two slopes between chains of 2
     and 10 AdamW steps, with their min/max);
 25. sliding windows and attention sinks on the serving path: B1 (bf16
     tiles and fp32) at B4 Hq16 Hkv8 S1536 D64, window 128 with and
     without 4 sinks, at B1 S8192 window 1024 beside its global causal time
     on the same inputs, and on a non-causal band of offset -100 (rows with
     no key: lse bit for bit); B8 at Edge-NonPowerOf2, window 32 with 4
     sinks; B5 at phase 3's shapes and B6 at phase 12's T 5 and T 512,
     window 128 with 4 sinks, their outputs bitwise unchanged when the
     table entries behind the window name another slot's pages.  Each
     against its plain version, an off-by-one window as a control that must
     fail the gate, times beside the live-work bound and (B1, B8) SDPA with
     the band as a boolean mask.  Then the hybrid configuration (window 128
     on every other layer, GPT-OSS's pattern) at base width on an int8
     cache, phase 5's mix with four prompts of 1024-1536 tokens, chunked
     prefill 512: tokens/s, TPOT, TTFT, each window group's peak live pages,
     no decoding slot's local group above 2 pages after any step, windowed
     launches of B1, B5 and B6; and the streaming configuration (window 512,
     4 sinks, every layer) in fp32 at base width, card against CPU, greedy
     tokens bitwise equal for engine decode, speculation (k 3, a one-layer
     windowed draft) and chunked prefill (chunk 512, a 1300-token prompt),
     the sink page resident to the end;
 26. training with windows, sinks and packed segments: (a) B2, B3 and B4
     with a window against their plain versions at the train shape (B4
     Hq16 Hkv8 S2048 D64 bf16; window 128, the hybrid's local layers;
     window 512 with 4 sinks, streaming's; window 128 at D 128), fp32 tiles
     at B1 S512 (window 128, 4 sinks), a band of offset -100 at B2 S1024
     (rows with no key) and the reference tiles' dead rows (window 520, Sq
     1500, Skv 700: B1's lse on them bit for bit, their dQ exactly 0); (b)
     the same with segment ids (4 documents a row at the train shape, 3 at
     B1 S512 in fp32), B8 with 2 segments at Edge-NonPowerOf2, a padded
     batch through the API on both routes (O, dQ, dK and dV exactly 0 on
     the pads), and packing two documents against running each alone.
     Each row: the forward B1 on the same inputs checked and timed first
     (beside SDPA with the mask as a boolean attn_mask), device time beside
     the same call's global time, the bound over the kept pairs, the plain
     version and SDPA's memory-efficient backward with the mask as its
     bias; an off-by-one window or ids shifted by one token as
     the control, enforced in fp32 (printed in bf16); (c) the hybrid and
     streaming base configurations train 5 AdamW steps each at B4 S2048:
     finite falling loss, step time, tokens/s, peak memory, windowed
     launches (hybrid: B3 and B4, B2 on the global layers; streaming: B2
     only); (d) one fp32 AdamW step of each (hybrid window 64, streaming
     window 96 with 4 sinks) on tokens (2, 257), card against CPU, as
     phase 8.
Serving's decode steps run as CUDA graphs (decode/graphs.py); each
wrapper's launch count adds what a capture recorded at every replay.
The line before the last is the kernel JSON (eleven kernels; B1, B5, B6 and
B8 each with its windowed row and windowed launches under "window", B2, B3
and B4 with phase 26's windowed and segmented rows under "window" and
"segments", B8 with its segmented row; B1-B4 and B8 with
"launches_window" and "launches_segments"; B1's segmented row under
"segments"); the
last line is the JSON contract line {"ok": true, "device": {...}}.
It imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}  # tensor cores; FMA
B1_TOL = {"bf16": 2e-2, "fp32": 2e-6}  # fp16 tiles: FP16_REL_TOL
LSE_REL_TOL = 1e-3
B5_TOL = {"bf16": 2e-2, "fp32": 2e-5}
B6_TOL = B5_TOL
E2E_LOGIT_TOL = 1e-3
# Backward kernels: error relative to the plain output's own max |value|
# (bf16: the JAX bf16-tile grad gate, tests/test_fa2_backward.py).
BWD_TOL = {"bf16": 5e-2, "fp32": 2e-5}  # fp16: FP16_REL_TOL
TRAIN_LOSS_TOL = 1e-4   # card vs CPU, relative
TRAIN_GRAD_NORM_TOL = 1e-4  # card vs CPU, relative
TRAIN_GRAD_TOL = 1e-3   # card vs CPU, of each leaf's own max |g|
# Matmuls of S x S x D per query head in each backward kernel.
BWD_MATMULS = {"fa2_backward_fused": 5, "fa2_backward_dq": 3,
               "fa2_backward_dkv": 4}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# The backward's kernels with bf16 or fp16 tiles, by patterns of the names
# they carry in ptxas's mangled entry names, and their instantiations (two
# input types x two tile types x D 64 and 128; the reduce two output
# types): B2's main kernel (DQ true, Lb1E), the prologue of B2-B4 with
# 16-bit tiles (its fp32 instantiations, IffL, are the fp32 block's) and
# B2's dQ reduce; B3's kernel; B4's, the main kernel with DQ false (Lb0E).  And the fp32 FMA block's
# kernels by source, with their instantiations: B10 (D 64 and 128), B1's
# fp32 body and B8's (D 64 and 128, with and without segment ids); the backward's
# bwd_kv_fp32 (D 64 and 128 x FUSED),
# bwd_dq_fp32 and the fp32 prologue (D 64 and 128 each).
BWD_FUNCTIONS = {"B2": ((r"bwd_fused_wgmma\w*Lb1E", r"bwd_prologueI(?!ffL)", "dq_reduce"), 18),
                 "B3": (("bwd_dq_wgmma",), 8),
                 "B4": ((r"bwd_fused_wgmma\w*Lb0E",), 8)}
FP32_FUNCTIONS = {"baselines": (("naive_fa2_fp32",), 2),
                  "fa2_forward": (("fa2_fwd_fp32",), 4),
                  "fa2_forward_small": (("small_fp32",), 4),
                  "fa2_backward": (("bwd_kv_fp32", "bwd_dq_fp32", "bwd_prologueIffL"), 8)}
# B5's split-KV kernel: 6 cache types x 2 q types x D 64 and 128 x groups
# of at most 2 and 8.
B5_FUNCTIONS = (("paged_decode_kernel",), 48)
# B6's split-KV body (6 cache types x 2 q types x D 64 and 128 x fp32
# compute on the FMA units and bf16 compute on the tensor cores), its bf16
# tile body (6 x 2 x 2) and its fp32 tile body on the FMA block (6 x 2 x 2);
# X's five variants.
B6_FUNCTIONS = (("paged_chunk_split", "paged_chunk_mma", "paged_chunk_fp32"), 96)
X_FUNCTIONS = (("r5_fwd",), 5)
# B7's bodies: wgmma fed by converter warps (bf16 compute) and the FMA block
# over the stored-width ring (fp32 compute), each 4 storages x 2 q types x
# D 64 and 128.
B7_FUNCTIONS = (("fa2_fwd_quant_wgmma", "fa2_fwd_quant_fp32"), 32)


def ptxas_by_function(text: str) -> dict:
    """ptxas -v lines grouped by the entry function they describe (its
    mangled name); a note that names a function goes to that function."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
        named = re.search(r"function '?(_Z\w+)", line)
        key = named.group(1) if named else current
        if key is not None:
            out.setdefault(key, []).append(line.strip())
    return out


def ptxas_log(_build, name: str) -> str:
    """The compiler's report for csrc/<name>.cu when its library was built
    before this run (the build step reports new builds only): the source
    compiled once more, with the package's flags, into build/kernels/."""
    out = _build.BUILD_DIR / f"{name}-ptxas-report.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(_build.CSRC_DIR / f"{name}.cu")],
                          check=True, capture_output=True, text=True)
    out.unlink()
    return proc.stdout + proc.stderr


def check_ptxas(text: str, label: str, functions, at_least: int) -> None:
    """Print the registers, spills and wgmma notes of each instantiation of
    `functions` (patterns of mangled names) in `text`, and fail on a spilled
    byte or a serialisation note (C7514 and kin: ordinary code touching a
    wgmma's registers before its wait), or if fewer than `at_least`
    instantiations are reported."""
    found = 0
    for fn, lines in ptxas_by_function(text).items():
        kind = next((k for k in functions if re.search(k, fn)), None)
        if kind is None:
            continue
        found += 1
        spills = [int(n) for line in lines
                  for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line)]
        notes = [line for line in lines if "C75" in line or "serializ" in line]
        regs = next((line.split("Used")[1].split(",")[0].strip()
                     for line in lines if "Used" in line), "?")
        log(f"  ptxas {label} {kind} {fn[-48:]}: {regs}, spill bytes {sum(spills)}, "
            f"wgmma notes {len(notes)}")
        for note in notes:
            log(f"    {note}")
        if sum(spills) or notes:
            raise AssertionError(f"ptxas: {label}'s {fn} spills or serialises wgmma")
    if found < at_least:
        raise AssertionError(f"ptxas: only {found} {label} entry functions reported")


def phase_b1(torch, fa2, b1_ab):
    """FA2 forward kernel vs its plain version at b1_ab.CASES: the prefill
    shapes, the train shape (D 64 and 128, bf16 and fp16 tiles) and the
    edges of its 128-row tiles (Sq != Skv, short S, kv_len inside the last
    box, GQA 16/2)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case in b1_ab.CASES:
        q, k, v, kw, flops = b1_ab.problem(case, gen)
        kind = case["tile"] or case["dtype"]
        tol = B1_TOL["fp32" if kind == "fp32" else "bf16"]
        o_k, lse_k = fa2.fa2_forward_aligned(q, k, v, **kw)
        o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max().item()
        if not (err <= tol and lse_err <= LSE_REL_TOL):
            raise AssertionError(
                f"B1 {case['name']}: max_abs_err {err} (tol {tol}), "
                f"lse rel err {lse_err} (tol {LSE_REL_TOL})"
            )
        ms = time_ms(lambda: fa2.fa2_forward_aligned(q, k, v, **kw))
        plain_ms = time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw), iters=5)
        lib_ms = time_ms(b1_ab.sdpa_call(q, k, v, kw))
        bound_ms, bound_by = b1_ab.bound(case, flops, q, k, v, o_k, lse_k)
        row = dict(case=case["name"], kind=kind, inputs=case["dtype"],
                   B=case["b"], Hq=case["hq"], Hkv=case["hkv"], Sq=case["sq"],
                   Skv=case["skv"], D=case["d"], causal=case["causal"],
                   max_abs_err=err, lse_rel_err=lse_err, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, tflops=flops / ms / 1e9)
        rows.append(row)
        log("B1", json.dumps(row))
        del q, k, v, o_k, lse_k, o_p, lse_p
    return rows


def phase_b5(torch, dec_attn, kv_cache):
    """Paged decode kernel vs its plain version on int8 and bf16 caches."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n, hq, hkv, d, page, pps = 8, 16, 8, 64, 128, 16
    num_pages = n * pps + 1
    lengths = torch.tensor([2048, 1, 129, 0, 777, 1500, 128, 2000],
                           dtype=torch.int32, device="cuda")
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    page_table = perm.reshape(n, pps).to(torch.int32).contiguous()
    rows = []
    for cache, compute in (("int8", "bf16"), ("bf16", "bf16"), ("int8", "fp32"),
                           ("bf16", "fp32")):
        pages = random_pages(torch, kv_cache, gen, cache, (hkv, num_pages, page, d))
        cdt = torch.bfloat16 if compute == "bf16" else torch.float32
        q = torch.randn(n, hq, d, generator=gen, device="cuda").to(cdt)
        scale = d ** -0.5
        o_k = dec_attn.paged_decode_attention(q, pages, page_table, lengths,
                                              sm_scale=scale, compute_dtype=cdt)
        o_p = dec_attn.paged_decode_attention_plain(
            q, pages, page_table, lengths, sm_scale=scale, compute_dtype=cdt)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        if not err <= B5_TOL[compute]:
            raise AssertionError(
                f"B5 {cache} cache, {compute} compute: max_abs_err {err} "
                f"(tol {B5_TOL[compute]})")
        if o_k[3].abs().max().item() != 0.0:
            raise AssertionError("B5: the inactive slot's output is not zero")
        def kernel():
            return dec_attn.paged_decode_attention(
                q, pages, page_table, lengths, sm_scale=scale, compute_dtype=cdt)

        b2b_ms = time_ms(kernel)
        ms = queued_ms(torch, kernel)
        plain_ms = time_ms(lambda: dec_attn.paged_decode_attention_plain(
            q, pages, page_table, lengths, sm_scale=scale, compute_dtype=cdt),
            iters=5)
        bound_ms, bound_by, _, moved = paged_bound(
            lengths.tolist(), 1, hq, hkv, d, pages.k_pages.element_size(), q,
            o_k, compute)
        # ms is the card's time (calls queued behind a sleep kernel);
        # b2b_ms back-to-back calls, which at these sizes time the host.
        row = dict(cache=cache, compute=compute, n=n, max_len=2048,
                   max_abs_err=err, ms=ms, b2b_ms=b2b_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   gbps=moved / ms / 1e6)
        rows.append(row)
        log("B5", json.dumps(row))
    return rows


def phase_e2e(torch, np, transformer, decode):
    """Base width in fp32: CUDA (kernels) against CPU (plain versions)."""
    cfg = transformer.TransformerConfig.base(dtype=torch.float32,
                                             attn_tile_dtype=None)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 128).tolist()
    tokens = torch.tensor([prompt])
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: [{n: w.to(dev) for n, w in layer.items()} for layer in v]
             if k == "layers" else v.to(dev) for k, v in params.items()}
        with torch.inference_mode():
            logits, _ = decode.prefill_forward(p, tokens.to(dev), cfg)
        eng = decode.DecodeEngine(params, cfg, max_seqs=2, max_seq_len=256,
                                  device=dev)
        (req,) = eng.run([prompt], max_new_tokens=5)
        out[dev] = (logits.cpu(), req.generated)
    diff = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    log(f"e2e fp32 base: prefill logits max |cuda - cpu| {diff:.3e}; greedy "
        f"cuda {out['cuda'][1]} cpu {out['cpu'][1]}")
    if not diff <= E2E_LOGIT_TOL:
        raise AssertionError(f"e2e: prefill logits differ by {diff} (tol {E2E_LOGIT_TOL})")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError("e2e: greedy tokens differ between cuda and cpu")
    return diff


def phase_serving(torch, np, transformer, decode):
    """TransformerConfig.base() with an int8 cache serves 12 requests."""
    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                              page_size=128, cache_dtype=torch.int8)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1501, 12)]
    new_tokens = 64
    torch.cuda.synchronize()
    reset_counts(SERVING_KERNELS)
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(SERVING_KERNELS)
    check_served("serving", reqs, eng, launches, ("fa2_forward", "paged_decode"),
                 cfg.vocab_size, new_tokens)
    with torch.inference_mode():
        logits, _ = decode.prefill_forward(
            eng.params, torch.tensor([prompts[0]], device="cuda"), cfg,
            last_only=True)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("serving: non-finite logits")
    total = sum(len(r.generated) for r in reqs)
    res = dict(requests=len(reqs), tokens=total, seconds=elapsed,
               tokens_per_s=total / elapsed,
               decode_step_ms_mean=elapsed / eng.stats["steps"] * 1e3,
               tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
               steps=eng.stats["steps"],
               ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
               prompt_lens=[len(p) for p in prompts], launches=launches)
    log("serving", json.dumps(res))
    return res, eng


SERVING_KERNELS = ("fa2_forward", "paged_decode", "paged_chunk")
TRAIN_KERNELS = ("fa2_forward", "fa2_backward_fused", "fa2_backward_dq",
                 "fa2_backward_dkv")


def launch_counts():
    """The kernel wrappers' launch counts (kernels/launches.py)."""
    from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES
    return LAUNCHES


def reset_counts(names) -> None:
    from cuda_flash_attention_tpu_torch.kernels.launches import reset
    reset(*names)


def read_counts(names) -> dict:
    counts = launch_counts()
    return {name: counts[name] for name in names}



def phase_profile(torch, np, eng, label="profile", new_tokens=40):
    """Where a decode step's time goes: eight running requests, ten steps
    (speculative rounds, for a speculative engine; bursts, for a bursting
    one: `new_tokens` keeps them busy through the window) under
    torch.profiler, timed on the host clock over the same window (so the
    step time includes the profiler's own host overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1501, eng.max_seqs)]
    reqs = eng.submit_many(prompts, max_new_tokens=new_tokens)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    tokens0 = eng.stats["tokens"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
    if not busy_ms > 0:
        raise AssertionError("profile: no device time recorded")
    # The host's launch calls: kernels launched one by one, and graph
    # replays (each one launch of a whole captured step).
    host_calls = {e.key: e.count / 10 for e in events
                  if e.device_type != DeviceType.CUDA
                  and ("LaunchKernel" in e.key or "GraphLaunch" in e.key)}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # B5's and B6's kernels (csrc/paged_decode.cu, csrc/paged_chunk.cu) and
    # their shares of the busy time.
    b5_ms, b6_ms = (sum(e.self_device_time_total for e in kernels if name in e.key)
                    / 10 / 1e3 for name in ("paged_decode_kernel", "paged_chunk_"))
    res = dict(
        batch=len(reqs), decode_step_ms=step_ms,
        tokens_per_step=(eng.stats["tokens"] - tokens0) / 10,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        kernel_launches_per_step=sum(e.count for e in kernels) / 10,
        host_launch_calls_per_step=sum(host_calls.values()),
        host_launch_calls=host_calls,
        b5_ms_per_step=b5_ms, b5_share_of_busy=b5_ms / busy_ms,
        b6_ms_per_step=b6_ms, b6_share_of_busy=b6_ms / busy_ms,
        top_kernels_ms_per_step={e.key[:48]: e.self_device_time_total / 1e4
                                 for e in top})
    log(label, json.dumps(res))
    return res


def causal_pairs(sq: int, kv_len: int, causal: bool) -> int:
    """(query, key) pairs that attend: rows past kv_len see kv_len keys."""
    if not causal:
        return sq * kv_len
    n = min(sq, kv_len)
    return n * (n + 1) // 2 + (sq - n) * kv_len


def library_backward_ms(torch, fp32_bwd, q, k, v, do, scale, causal=True):
    """The backward of PyTorch's flash attention on the same inputs (K/V
    expanded to Hq): the aten flash backward op fed by its own forward, in
    bf16 or fp16; in fp32 (which that op does not take) SDPA's
    memory-efficient backward, fed by its own forward."""
    groups = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(groups, dim=1)
    ve = v.repeat_interleave(groups, dim=1)
    if q.dtype in (torch.bfloat16, torch.float16):
        out = torch.ops.aten._scaled_dot_product_flash_attention(
            q, ke, ve, 0.0, causal, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, offset = out[:8]
        ms = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, ke, ve, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset,
            scale=scale))
        return ms, "aten._scaled_dot_product_flash_attention_backward"
    ms = time_ms(fp32_bwd.efficient_backward(q, ke, ve, do, scale, causal))
    return ms, "aten._scaled_dot_product_efficient_attention_backward"


def bwd_problem(torch, attention, fa2, gen, dtype, b, s, hq=16, hkv=8,
                causal=True, tile="same", d=64):
    """Padded inputs on the card (the train shape by default): q, k, v, dO
    random, O and lse from kernel B1, D_i = rowsum(dO * O).  The tile type
    is `tile`, by default bf16 for bf16 inputs and None for fp32."""
    if tile == "same":
        tile = torch.bfloat16 if dtype == torch.bfloat16 else None
    q, do = (torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    raw = (q, k, v, do)
    q, k, v, scale, q_len, kv_len = attention._prepare(
        q, k, v, causal, None, tile, None, None, None, 0)
    o, lse = fa2.fa2_forward_aligned(q, k, v, causal=causal, sm_scale=scale,
                                     kv_len=kv_len, tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - s)).contiguous()
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=scale, kv_len=kv_len, tile_dtype=tile)
    return dict(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di), kw, raw


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, kind, dtype, b, s,
             names, **problem):
    """B2, B3 and B4 (those of `names`) against their plain versions on one
    problem (bwd_problem's), each timed beside its bound, the plain version
    and the library backward.  `kind` is the tile type's name."""
    x, kw, raw = bwd_problem(torch, attention, fa2, gen, dtype, b, s, **problem)
    q, k, v, o, do, lse, di = (x[n] for n in ("q", "k", "v", "o", "do", "lse", "di"))

    def by_batch(fn, chunk=4):
        """The plain version over batch slices of `chunk` (its whole-row
        score tensors take 1 GiB each at B4 S2048), joined on batch."""
        outs = [fn(slice(lo, lo + chunk)) for lo in range(0, b, chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    calls = {
        "fa2_backward_fused": (
            lambda: bwd.fa2_backward_fused_aligned(q, k, v, o, do, lse, **kw),
            lambda: by_batch(lambda i: bwd.fa2_backward_fused_plain(
                q[i], k[i], v[i], o[i], do[i], lse[i], **kw))),
        "fa2_backward_dq": (
            lambda: (bwd.fa2_backward_dq_aligned(q, k, v, do, lse, di, **kw),),
            lambda: by_batch(lambda i: (bwd.fa2_backward_dq_plain(
                q[i], k[i], v[i], do[i], lse[i], di[i], **kw),))),
        "fa2_backward_dkv": (
            lambda: bwd.fa2_backward_dkv_aligned(q, k, v, do, lse, di, **kw),
            lambda: by_batch(lambda i: bwd.fa2_backward_dkv_plain(
                q[i], k[i], v[i], do[i], lse[i], di[i], **kw))),
    }
    # The library runs in the tile type (fp32 where the tiles are fp32).
    lib_dtype = kw["tile_dtype"] or raw[0].dtype
    lib_ms, lib_how = library_backward_ms(
        torch, fp32_bwd, *(t.to(lib_dtype) for t in raw), kw["sm_scale"],
        kw["causal"])
    pairs = causal_pairs(s, s, kw["causal"])
    hq, d = q.shape[1], q.shape[3]
    # Bytes each kernel must move: q-sized tensors (q, o, dO, dQ), K and
    # V (or dK and dV), and the fp32 row statistics (lse, D_i).
    io = {"q": nbytes(raw[0]), "kv": nbytes(raw[1], raw[2]),
          "stat": b * hq * s * 4}
    moved = {
        "fa2_backward_fused": 4 * io["q"] + 2 * io["kv"] + io["stat"],
        "fa2_backward_dq": 3 * io["q"] + io["kv"] + 2 * io["stat"],
        "fa2_backward_dkv": 2 * io["q"] + 2 * io["kv"] + 2 * io["stat"],
    }
    rows = []
    for name in names:
        kernel, plain = calls[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        if kind == "fp16":
            kw["tile_dtype"] = torch.bfloat16
            control = [rel_err(g, w) for g, w in zip(kernel(), want)]
            kw["tile_dtype"] = torch.float16
            for i, (err, c) in enumerate(zip(errs, control)):
                fp16_gate(f"{name} output {i} B{b} S{s}", err, c,
                          FP16_REL_TOL["bwd"])
        elif not max(errs) <= BWD_TOL[kind]:
            raise AssertionError(f"{name} {kind} B{b} S{s}: relative errors "
                                 f"{errs} (tol {BWD_TOL[kind]})")
        del got, want
        ms = time_ms(kernel, iters=10)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        flops = BWD_MATMULS[name] * 2 * b * hq * pairs * d
        t_bytes = moved[name] / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[kind]
        row = dict(kernel=name, kind=kind, inputs=str(dtype)[6:], B=b, Hq=hq,
                   Hkv=k.shape[1], S=s, D=d, causal=kw["causal"], rel_err=max(errs),
                   max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library=lib_how,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log("bwd", json.dumps(row))
    return rows


def phase_bwd(torch, fp32_bwd, attention, fa2, bwd):
    """B2, B3 and B4 against their plain versions at the train shape (B4
    Hq16 Hkv8 S2048 causal bf16) at D 64 and 128, fp32 at B1 S512, a ragged
    S1000, and B3 and B4 at B16 S2048 (the split-route training shape).
    Their fp32 bodies where the harness's fp32 `fa2 both` rows run them
    (fp32_bwd.SHAPES, D 64, not causal: the fused B2 at Large-2, the split
    B3 + B4 at Stress-1), and B3 and B4 at the train shape in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    every = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")
    rows = []
    for kind, b, s, names in (("bf16", 4, 2048, every), ("fp32", 1, 512, every),
                              ("bf16", 2, 1000, every),
                              ("bf16", 16, 2048, every[1:])):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        rows += bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, kind, dtype,
                         b, s, names)
    # The train shape at D 128: the wider dK and dV accumulators take B2's
    # 64-row Q tiles.
    rows += bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, "bf16",
                     torch.bfloat16, 4, 2048, every, d=128)
    for config, names in (("Large-2", every[:1]), ("Stress-1", every[1:])):
        b, h, s = fp32_bwd.SHAPES[config]
        rows += [dict(r, config=config) for r in bwd_rows(
            torch, fp32_bwd, attention, fa2, bwd, gen, "fp32", torch.float32, b,
            s, names, hq=h, hkv=h, causal=False)]
    rows += bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, "fp32",
                     torch.float32, 4, 2048, every[1:])
    return rows


def phase_autograd(torch, attention, bwd, BlockSizes):
    """torch.autograd.grad of flash_attention at the train shape on both
    routes, against the plain backward on the same O and lse, and
    bitwise-equal gradients from two runs of each route."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(4, 16, 2048, 64, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(4, 8, 2048, 64, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(causal=True, tile_dtype=torch.bfloat16)
    o, lse = attention.flash_attention_with_lse(q, k, v, **kw)
    want = bwd.fa2_backward_fused_plain(q, k, v, o, do, lse, causal=True,
                                        sm_scale=0.125, kv_len=2048,
                                        tile_dtype=torch.bfloat16)
    split = BlockSizes(128, 128, 128, 128, 128, 128)
    res = {}
    for route, bs in (("fused", None), ("split", split)):
        runs = []
        names = TRAIN_KERNELS[1:]
        before = read_counts(names)
        for _ in range(2):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = attention.flash_attention(*ts, block_sizes=bs, **kw)
            runs.append(torch.autograd.grad(out, ts, do))
        torch.cuda.synchronize()
        after = read_counts(names)
        moved = tuple(after[n] - before[n] for n in names)
        if moved != ((2, 0, 0) if route == "fused" else (0, 2, 2)):
            raise AssertionError(f"autograd {route}: launches {moved}")
        errs = [rel_err(g, w) for g, w in zip(runs[0], want)]
        if not max(errs) <= BWD_TOL["bf16"]:
            raise AssertionError(f"autograd {route}: relative errors {errs}")
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        if not bitwise:
            raise AssertionError(f"autograd {route}: two runs differ")
        res[route] = dict(rel_errs=errs, bitwise_equal=bitwise, launches=moved)
    log("autograd", json.dumps(res))
    return res


def tree_rel_err(torch, tree_leaves, a, b) -> float:
    """Largest per-leaf error, each relative to the leaf's own max |value|."""
    return max(((x.float().cpu() - y.float().cpu()).abs().max()
                / y.float().abs().max().clamp_min(1e-30)).item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_train_parity(torch, np, transformer, training, label="base",
                       tokens_shape=(2, 129), **cfg_kw):
    """One AdamW step at the base width in fp32: card (kernels) against CPU
    (plain versions).  The first Adam moment is (1 - b1) times the clipped
    gradient, so it holds each gradient leaf to the tolerance; the global
    gradient norm, taken before clipping, is held on its own.  cfg_kw: the
    configuration's window, global_every and sinks (phase 26 (d))."""
    cfg = transformer.TransformerConfig.base(dtype=torch.float32,
                                             attn_tile_dtype=None, **cfg_kw)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, tokens_shape)
    out = {}
    for dev in ("cuda", "cpu"):
        p = transformer.tree_map(lambda w: w.to(dev), params)
        opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=4)
        step = training.make_optax_train_step(cfg, opt)
        out[dev] = step(training.init_train_state(p, opt), tokens)
    (s_g, m_g), (s_c, m_c) = out["cuda"], out["cpu"]
    loss_err = abs(m_g["loss"].item() - m_c["loss"].item()) / abs(m_c["loss"].item())
    grad_err = tree_rel_err(torch, transformer.tree_leaves, s_g.opt_state.mu,
                            s_c.opt_state.mu)
    norm_g, norm_c = m_g["grad_norm"].item(), m_c["grad_norm"].item()
    norm_err = abs(norm_g - norm_c) / norm_c
    res = dict(loss_cuda=m_g["loss"].item(), loss_cpu=m_c["loss"].item(),
               loss_rel_err=loss_err, grad_rel_err_max=grad_err,
               grad_norm_cuda=norm_g, grad_norm_cpu=norm_c,
               grad_norm_rel_err=norm_err)
    log(f"train parity fp32 {label}", json.dumps(res))
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and norm_err <= TRAIN_GRAD_NORM_TOL):
        raise AssertionError(f"train parity: {res}")
    return res


def matmul_params(cfg) -> int:
    per_layer = (2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + 3 * cfg.d_model * cfg.d_ff)
    return cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size


def model_flops(cfg, b: int, s: int) -> int:
    """6 * matmul params * tokens plus attention: three times the causal
    forward's two S x S x D products per layer (no recompute counted)."""
    attn = 3 * 4 * b * cfg.n_heads * causal_pairs(s, s, True) * cfg.head_dim
    return 6 * matmul_params(cfg) * b * s + cfg.n_layers * attn


def phase_train(torch, np, transformer, training, dataclasses):
    """TransformerConfig.base() trains on one batch of B4 S2048."""
    cfg = transformer.TransformerConfig.base()
    b, s = 4, 2048
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (b, s + 1))
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                  decay_steps=100)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    losses, times = [], []
    torch.cuda.synchronize()
    reset_counts(TRAIN_KERNELS)
    for i in range(5):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_counts(TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss not finite and falling: {losses}")
    if not (launches["fa2_forward"] and launches["fa2_backward_fused"]):
        raise AssertionError(f"train: a kernel of the path never ran: {launches}")
    timed = times[2:]
    mean_s = sum(timed) / len(timed)
    flops = model_flops(cfg, b, s)
    res = dict(batch=b, seq=s, steps=len(losses), losses=losses,
               step_ms_mean=mean_s * 1e3,
               step_ms_median=statistics.median(timed) * 1e3,
               step_ms=[t * 1e3 for t in times],
               tokens_per_s=b * s / mean_s,
               max_memory_allocated_gib=peak / 2 ** 30,
               model_flops_per_step=flops,
               mfu_bf16_peak=flops / mean_s / PEAK_FLOPS["bf16"],
               launches=launches)
    log("train", json.dumps(res))

    cfg_remat = dataclasses.replace(cfg, remat="full")
    step_remat = training.make_optax_train_step(cfg_remat, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(TRAIN_KERNELS)
    t0 = time.perf_counter()
    _, m = step_remat(state, tokens)
    remat = dict(loss=m["loss"].item(), step_ms=(time.perf_counter() - t0) * 1e3,
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=read_counts(TRAIN_KERNELS))
    log("train remat=full", json.dumps(remat))
    if remat["launches"]["fa2_forward"] != 2 * cfg.n_layers:
        raise AssertionError(f"remat: B1 launches {remat['launches']}")
    return res, remat, (state, step, tokens)


def phase_train_split(torch, np, transformer, training):
    """At B16 S2048 the port's dQ slices would take 2 GiB: the step takes
    the split route, B3 + B4."""
    cfg = transformer.TransformerConfig.base()
    b, s = 16, 2048
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, device="cuda")
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (b, s + 1))
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                  decay_steps=100)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(TRAIN_KERNELS)
    losses, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = read_counts(TRAIN_KERNELS)
    res = dict(batch=b, seq=s, losses=losses, step_ms=[t * 1e3 for t in times],
               tokens_per_s=b * s / times[-1],
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    log("train split", json.dumps(res))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train split: non-finite loss {losses}")
    if launches["fa2_backward_fused"] or not (
            launches["fa2_backward_dq"] and launches["fa2_backward_dkv"]):
        raise AssertionError(f"train split: wrong route: {launches}")
    return res


def phase_train_profile(torch, state, step, tokens):
    """Where a train step's time goes at B4 S2048: one step under
    torch.profiler, timed on the host clock over the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, tokens)
        m["loss"].item()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms > 0:
        raise AssertionError("train profile: no device time recorded")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    by_kind = {"attention (this port's kernels)": 0.0, "matmul (cuBLAS)": 0.0,
               "other (elementwise, reductions, copies)": 0.0}
    for e in kernels:
        if any(n in e.key for n in ("fa2_fwd_", "bwd_kv_", "bwd_dq_",
                                    "bwd_fused_wgmma", "bwd_prologue",
                                    "dq_reduce")):
            kind = "attention (this port's kernels)"
        elif any(n in e.key for n in ("nvjet", "gemm", "cutlass")):
            kind = "matmul (cuBLAS)"
        else:
            kind = "other (elementwise, reductions, copies)"
        by_kind[kind] += e.self_device_time_total / 1e3
    res = dict(step_ms=step_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / step_ms,
               kernel_launches=sum(e.count for e in kernels),
               device_ms_by_kind=by_kind,
               top_kernels_ms={e.key[:48]: e.self_device_time_total / 1e3
                               for e in top})
    log("train profile", json.dumps(res))
    return res


def random_pages(torch, kv_cache, gen, cache, shape):
    """A paged cache of random contents: int8 codes with small scales, or
    bf16/fp32 values with unit scales."""
    if cache == "int8":
        def pages_of():
            return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                 dtype=torch.int8)

        def scales_of():
            return torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 1e-3
    else:
        dtype = torch.bfloat16 if cache == "bf16" else torch.float32

        def pages_of():
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def scales_of():
            return torch.ones(shape[:3], device="cuda")
    return kv_cache.KVPages(pages_of(), scales_of(), pages_of(), scales_of())


def paged_bound(lengths, chunk, hq, hkv, d, elem, q, out, kind):
    """The least time of one paged attention call (B5 at chunk 1, B6): each
    cached token's K and V row and scale once (not the dead rows of a last
    page), q, out, the live page ids and the lengths; 4 * D FLOPs per
    (query head, row, attended column), row t of a slot of total length L
    attending max(0, L - T + t + 1) columns.  Returns (ms, what bounds it,
    FLOPs, bytes)."""
    tokens = sum(lengths)
    live_pages = sum(-(-n // 128) for n in lengths)
    moved = (2 * tokens * hkv * (d * elem + 4) + nbytes(q, out) + live_pages * 4
             + 4 * len(lengths))
    cols = sum(max(0, n - chunk + t + 1) for n in lengths for t in range(chunk))
    flops = 4 * d * hq * cols
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            flops, moved)


# B6's speculation shape (8 slots, T 5, ragged total lengths to 2048, an
# inactive slot) and chunked-prefill shape (T 512, 4 slots), phases 12 and 20.
B6_SPEC_LENGTHS = [2048, 5, 133, 0, 777, 1500, 128, 2000]
B6_PREFILL_LENGTHS = [512, 1024, 1536, 2048]


def phase_b6(torch, dec_attn, kv_cache):
    """Paged chunk kernel vs its plain version at the speculation and the
    chunked-prefill shapes, and T = 1 against B5."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    hq, hkv, d, page = 16, 8, 64, 128
    cases = [("spec", 5, B6_SPEC_LENGTHS, cache, compute)
             for cache, compute in (("int8", "bf16"), ("int8", "fp32"),
                                    ("bf16", "bf16"))]
    cases += [("prefill", 512, B6_PREFILL_LENGTHS, "int8", compute)
              for compute in ("bf16", "fp32")]
    rows = []
    for shape_name, chunk, lens, cache, compute in cases:
        n, pps = len(lens), 2048 // page
        num_pages = n * pps + 1
        pages = random_pages(torch, kv_cache, gen, cache, (hkv, num_pages, page, d))
        table = (torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
                 ).reshape(n, pps).to(torch.int32).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cdt = torch.bfloat16 if compute == "bf16" else torch.float32
        q = torch.randn(n, chunk, hq, d, generator=gen, device="cuda").to(cdt)
        scale = d ** -0.5

        def kernel():
            return dec_attn.paged_chunk_attention(q, pages, table, lengths,
                                                  sm_scale=scale, compute_dtype=cdt)

        def plain():
            return dec_attn.paged_chunk_attention_plain(
                q, pages, table, lengths, sm_scale=scale, compute_dtype=cdt)

        o_k, o_p = kernel(), plain()
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        if not err <= B6_TOL[compute]:
            raise AssertionError(f"B6 {shape_name} {cache} cache, {compute} compute: "
                                 f"max_abs_err {err} (tol {B6_TOL[compute]})")
        if 0 in lens and o_k[lens.index(0)].abs().max().item() != 0.0:
            raise AssertionError("B6: the inactive slot's output is not zero")
        ms = time_ms(kernel)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        bound_ms, bound_by, flops, _ = paged_bound(
            lens, chunk, hq, hkv, d, pages.k_pages.element_size(), q, o_k,
            compute)
        row = dict(shape=shape_name, T=chunk, n=n, lengths=lens, cache=cache,
                   compute=compute, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log("B6", json.dumps(row))
        del o_k, o_p, pages
    # T = 1: B6 and B5 compute one function.
    lens = [2048, 1, 129, 0, 777, 1500, 128, 2000]
    pages = random_pages(torch, kv_cache, gen, "int8", (hkv, 8 * 16 + 1, page, d))
    table = torch.arange(1, 8 * 16 + 1, dtype=torch.int32, device="cuda").reshape(8, 16)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = torch.randn(8, hq, d, generator=gen, device="cuda")
    for cdt, tol in ((torch.float32, B6_TOL["fp32"]), (torch.bfloat16, B6_TOL["bf16"])):
        one = dec_attn.paged_chunk_attention(q[:, None], pages, table, lengths,
                                              compute_dtype=cdt)[:, 0]
        dec = dec_attn.paged_decode_attention(q, pages, table, lengths,
                                              compute_dtype=cdt)
        err = (one - dec).abs().max().item()
        log(f"B6 T=1 vs B5 ({cdt}): max_abs_err {err:.3e}")
        if not err <= tol:
            raise AssertionError(f"B6 T=1 differs from B5 by {err} (tol {tol})")
    return rows


def draft_of(params):
    """The draft model of the repo's convention: the target's first layer
    with the target's embed, final_norm and lm_head."""
    return dict(params, layers=params["layers"][:1])


def phase_spec_parity(torch, np, transformer, decode, dataclasses):
    """fp32 at base width: verify_step on the card against the CPU, then
    speculative greedy, a prefix-cache hit and chunked prefill each against
    the card's plain greedy tokens.  The path's chunks of more than 64 rows
    run B6's fp32 tile body: its launches are counted over the phase."""
    reset_counts(["paged_chunk_fp32_tile"])
    cfg = transformer.TransformerConfig.base(dtype=torch.float32,
                                             attn_tile_dtype=None)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    rng = np.random.default_rng(12)
    # verify_step: a 256-token paged chunk per slot, then 5-token chunks
    # from 254 (crossing a page) and 100.
    calls = [(rng.integers(0, cfg.vocab_size, (2, 256)), [0, 0], True),
             (rng.integers(0, cfg.vocab_size, (2, 5)), [254, 100], False)]
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = transformer.tree_map(lambda w: w.to(dev), params)
        caches = [decode.init_kv_pages(cfg.n_kv_heads, 7, 128, cfg.head_dim,
                                       torch.float32, device=dev)
                  for _ in range(cfg.n_layers)]
        logits[dev] = []
        with torch.inference_mode():
            for tokens, first, paged in calls:
                out, _ = decode.verify_step(
                    p, torch.tensor(tokens, device=dev),
                    torch.tensor(first, device=dev),
                    caches, torch.tensor(table, device=dev),
                    torch.ones(2, dtype=torch.bool, device=dev), cfg,
                    paged_write=paged)
                logits[dev].append(out.cpu())
        del p, caches
    diff = max((a - b).abs().max().item()
               for a, b in zip(logits["cuda"], logits["cpu"]))
    log(f"verify_step fp32 base: logits max |cuda - cpu| {diff:.3e}")
    if not diff <= E2E_LOGIT_TOL:
        raise AssertionError(
            f"verify_step: logits differ by {diff} (tol {E2E_LOGIT_TOL})")

    params = transformer.tree_map(lambda w: w.to("cuda"), params)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    short = [prefix + rng.integers(0, cfg.vocab_size, 20).tolist(),
             prefix + rng.integers(0, cfg.vocab_size, 30).tolist()]
    long = rng.integers(0, cfg.vocab_size, 1300).tolist()
    n_new = 16

    def run(prompts, **kw):
        eng = decode.DecodeEngine(params, cfg, max_seqs=2, max_seq_len=2048,
                                  cache_dtype=torch.float32, **kw)
        first = eng.submit(prompts[0], max_new_tokens=n_new)
        rest = eng.run(prompts[1:], max_new_tokens=n_new)
        while not first.done:
            eng.step()
        eng.step()
        if eng.allocator.available != eng.num_pages - 1:
            raise AssertionError(f"spec parity {kw}: pages leaked")
        return [r.generated for r in [first] + rest], eng

    prompts = short + [long]
    plain, _ = run(prompts)
    res = {"verify_logit_diff": diff}
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    for name, kw in (("speculative", dict(spec_tokens=3, draft_params=draft_of(params),
                                          draft_cfg=draft_cfg)),
                     ("prefix_cache", dict(prefix_cache=True)),
                     ("chunked_prefill", dict(prefill_chunk=512))):
        got, eng = run(prompts, **kw)
        res[name] = dict(equal=got == plain, stats=eng.stats)
        if got != plain:
            raise AssertionError(
                f"{name}: greedy tokens differ from plain: {got} vs {plain}")
    res["fp32_tile_launches"] = launch_counts()["paged_chunk_fp32_tile"]
    if not (res["chunked_prefill"]["stats"]["prefill_chunks"] >= 3
            and res["speculative"]["stats"]["spec_rounds"] > 0
            and res["fp32_tile_launches"] > 0):
        raise AssertionError(f"spec parity: a path did not run: {res}")
    log("spec parity fp32 base", json.dumps(res))
    return res


def serving_mix(np, cfg, seed=4):
    """Phase 5's 12 prompts of 64-1500 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(64, 1501, 12)]


def check_served(name, reqs, eng, launches, need, vocab, new_tokens=None):
    """Every request done with in-vocab tokens (new_tokens of them, where
    given), no page leaked, and each kernel of `need` launched."""
    for r in reqs:
        if not (r.done and r.generated and all(0 <= t < vocab for t in r.generated)
                and new_tokens in (None, len(r.generated))):
            raise AssertionError(f"{name}: request {r.uid} incomplete: {r}")
    if eng.allocator.available != eng.num_pages - 1:
        raise AssertionError(f"{name}: pages leaked")
    if not all(launches[k] for k in need):
        raise AssertionError(f"{name}: a kernel of the path never ran: {launches}")


def phase_spec_serving(torch, np, transformer, decode, dataclasses):
    """Speculative serving at base width, int8 cache: phase 5's 12 requests
    with k = 4, by a one-layer draft and by prompt lookup."""
    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = serving_mix(np, cfg)
    new_tokens = 24
    out = {}
    for mode in ("draft", "prompt_lookup"):
        kw = (dict(draft_params=draft_of(params),
                   draft_cfg=dataclasses.replace(cfg, n_layers=1))
              if mode == "draft" else dict(spec_mode="prompt_lookup"))
        eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                                  cache_dtype=torch.int8, spec_tokens=4, **kw)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        check_served(f"spec {mode}", reqs, eng, launches,
                     ("fa2_forward", "paged_chunk")
                     + (("paged_decode",) if mode == "draft" else ()), cfg.vocab_size)
        total = sum(len(r.generated) for r in reqs)
        out[mode] = dict(
            requests=len(reqs), tokens=total, seconds=elapsed,
            tokens_per_s=total / elapsed, acceptance_rate=eng.acceptance_rate,
            rounds=eng.stats["spec_rounds"],
            rounds_per_token=eng.stats["spec_rounds"] / total,
            round_ms_mean=elapsed / eng.stats["spec_rounds"] * 1e3,
            ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
            launches=launches)
        log(f"spec serving {mode}", json.dumps(out[mode]))
        if mode == "draft":
            phase_profile(torch, np, eng, "spec profile (draft, k 4)")
        del eng
    return out


def phase_prefix_chunked(torch, np, transformer, decode):
    """Prefix caching on a shared 1024-token system prompt, against an
    uncached engine; then chunked prefill on phase 5's mix."""
    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab_size, 1024).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 257, 16)]
    res = {}
    for name, kw in (("uncached", {}), ("prefix_cache", dict(prefix_cache=True))):
        eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                                  cache_dtype=torch.int8, **kw)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        # The first request outlives the others, so its prompt pages stay
        # cached for all 15 that follow (three waves on 7 slots).
        holder = eng.submit(prompts[0], max_new_tokens=100)
        avail = eng.allocator.available
        reqs = eng.submit_many(prompts[1:], max_new_tokens=32)
        admitted = [r for r in reqs if r.slot is not None]
        shared = [eng.allocator.refcount(p) for p in eng._slot_pages[holder.slot][:8]]
        new_pages = (avail - eng.allocator.available) / len(admitted)
        while not all(r.done for r in [holder] + reqs):
            eng.step()
        eng.step()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        check_served(name, [holder] + reqs, eng, launches,
                     ("fa2_forward", "paged_decode")
                     + (("paged_chunk",) if kw else ()), cfg.vocab_size)
        if kw and not (eng._prefix_maps == {} and min(shared) == len(admitted) + 1):
            raise AssertionError(f"prefix cache: shared refcounts {shared}, maps "
                                 f"{len(eng._prefix_maps)}")
        res[name] = dict(
            seconds=elapsed,
            ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
            ttft_ms_median_first_wave=statistics.median(
                r.ttft_s for r in admitted) * 1e3,
            new_pages_per_admission=new_pages, system_page_refcounts=shared,
            launches=launches)
        log(f"prefix {name}", json.dumps(res[name]))
        del eng

    prompts = serving_mix(np, cfg)
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                              cache_dtype=torch.int8, prefill_chunk=512)
    torch.cuda.synchronize()
    reset_counts(SERVING_KERNELS)
    t0 = time.perf_counter()
    reqs = eng.submit_many(prompts, max_new_tokens=64)
    during, chunk_steps = 0, 0
    while not all(r.done for r in reqs):
        running = [eng._slot_req[s] for s in np.flatnonzero(eng.active)]
        before = sum(len(r.generated) for r in running)
        chunking = bool(eng.prefilling.any())
        eng.step()
        if chunking:
            chunk_steps += 1
            during += sum(len(r.generated) for r in running) - before
    eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(SERVING_KERNELS)
    check_served("chunked prefill", reqs, eng, launches,
                 ("paged_chunk", "paged_decode"), cfg.vocab_size)
    if not during:
        raise AssertionError("chunked prefill: no decode token during a prefill chunk")
    total = sum(len(r.generated) for r in reqs)
    res["chunked_prefill"] = dict(
        requests=len(reqs), tokens=total, seconds=elapsed,
        tokens_per_s=total / elapsed, prefill_chunks=eng.stats["prefill_chunks"],
        steps_with_chunks=chunk_steps, decode_tokens_during_prefill=during,
        ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
        launches=launches)
    log("chunked prefill", json.dumps(res["chunked_prefill"]))
    return res


# The reference suite's configs on this path: (batch, heads, seq) at head
# dim 64 (bench/configs.py).
SUITE = {"Small-1": (1, 1, 128), "Small-2": (2, 4, 256), "Large-2": (4, 12, 1024),
         "Edge-NonPowerOf2": (8, 16, 100), "Edge-SmallSeq": (8, 16, 32),
         "Stress-1": (8, 16, 2048)}
BASELINE_TOL = 1e-5  # B9/B10 vs plain: FA1 re-rounds O at every KV tile
B1_FP32_LSE_TOL = 1e-5  # B1's fp32 body vs plain, relative (the JAX fp32 gate)
# Phase 17 gates against the fp32 oracle, absolute (bf16 gradients:
# relative to the oracle's max |value|, as BWD_TOL; fp16 files: relative,
# FP16_REL_TOL, besides the absolute O gate).  The fp32 forward gate
# is the JAX one (2e-6, set at S <= 512) grown as sqrt(S / 512): the fp32
# kernels sum P V sequentially over S keys, whose rounding grows as
# sqrt(S); at Stress-1 (S 2048) that is 4e-6.
CLI_O_TOL = {"fp16": 2e-2, "bf16": 2e-2}
CLI_GRAD_TOL = {"fp32": 1e-3}
# fp16 tiles are gated by fp16's own readings, each error relative to the
# reference output's max |value|: well above the fp16 kernel's error and
# below what the bf16 instantiation gives on the same inputs, which is held
# as the control that must fail the gate.  A kernel that ran bf16 where
# fp16 was asked, or lost part of a tile, fails it.  Readings on one H100
# (fp16 / bf16, against the plain fp16 version): B8 <= 8.9e-5 / >= 2.6e-3,
# B1 at Stress-1 1.3e-4 / 7.5e-3, B2-B4 at Stress-1 <= 1.6e-4 / >= 6.0e-3.
FP16_REL_TOL = {"B1": 1e-3, "B8": 5e-4, "bwd": 1e-3}
# The CLI's fp16 files against the fp32 oracle, per file (fp16 / bf16 run:
# O 4.8e-5 / 3.1e-4, dQ 8.9e-3 / 4.8e-2, dK 3.8e-4 / 2.8e-3, dV 1.4e-4 /
# 1.3e-3).  With dO = 1 on uniform inputs dQ is a small difference of
# nearly equal sums, so its relative error is 20-60x dK's and dV's.
CLI_FP16_REL_TOL = {"O.bin": 1.2e-4, "dQ.bin": 2e-2, "dK.bin": 1e-3, "dV.bin": 4e-4}


def cli_o_tol(precision: str, s: int) -> float:
    if precision == "fp32":
        return 2e-6 * max(1.0, s / 512) ** 0.5
    return CLI_O_TOL[precision]


def fp16_gate(label: str, err: float, control_err: float, tol: float) -> None:
    """fp16 tiles' relative error `err` within `tol`, and the bf16 control's
    `control_err` on the same inputs beyond it."""
    log("fp16 gate", json.dumps(dict(label=label, rel_err=err,
                                     bf16_control_rel_err=control_err, tol=tol)))
    if not err <= tol:
        raise AssertionError(f"{label}: fp16 relative error {err} (tol {tol})")
    if not control_err > tol:
        raise AssertionError(f"{label}: the bf16 control's relative error "
                             f"{control_err} passes the fp16 gate {tol}")


def tile_of(torch, kind):
    return {"fp32": None, "bf16": torch.bfloat16, "fp16": torch.float16}[kind]


def attention_bound(b, h, s, d, causal, kind, *tensors):
    """(ms, what bounds it, FLOPs) of one attention forward: 4 * D FLOPs per
    attending (query, key) pair, each tensor moved once."""
    flops = 4 * b * h * causal_pairs(s, s, causal) * d
    t_bytes = nbytes(*tensors) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            flops)


def queued_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time per call of fn with the host's launch gaps taken
    out (utils.timing.queued_device_benchmark).  At microsecond sizes
    `time_ms` measures the host's launch rate instead."""
    from cuda_flash_attention_tpu_torch.utils.timing import queued_device_benchmark

    return queued_device_benchmark(fn, iters=iters) * 1e3


def phase_b8(torch, F, attention, fa2):
    """B8 against its plain version at the suite's small configs, in fp32,
    bf16 and fp16 tiles, causal and not, timed beside B1 on the same padded
    inputs, the plain version and SDPA in the tile type."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for name in ("Small-1", "Edge-NonPowerOf2", "Edge-SmallSeq"):
        b, h, s = SUITE[name]
        raw = [torch.randn(b, h, s, 64, generator=gen, device="cuda")
               for _ in range(3)]
        for kind in ("fp32", "bf16", "fp16"):
            tile = tile_of(torch, kind)
            lib_in = [t.to(tile or torch.float32) for t in raw]
            for causal in (False, True):
                q, k, v, scale, _, kv_len = attention._prepare(
                    *raw, causal, None, tile, None, None, None, 0)
                if not attention._use_small_kernel(q, k):
                    raise AssertionError(f"B8 {name}: the route does not take B8")
                kw = dict(causal=causal, sm_scale=scale, kv_len=kv_len,
                          tile_dtype=tile)
                o_k, lse_k = fa2.fa2_forward_small_aligned(q, k, v, **kw)
                o_p, lse_p = fa2.fa2_forward_small_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (o_k - o_p).abs().max().item()
                lse_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max().item()
                if kind == "fp16":
                    o_c, _ = fa2.fa2_forward_small_aligned(
                        q, k, v, **dict(kw, tile_dtype=torch.bfloat16))
                    fp16_gate(f"B8 {name} causal={causal}", rel_err(o_k, o_p),
                              rel_err(o_c, o_p), FP16_REL_TOL["B8"])
                    ok = lse_err <= LSE_REL_TOL
                else:
                    ok = err <= B1_TOL[kind] and lse_err <= LSE_REL_TOL
                if not ok:
                    raise AssertionError(
                        f"B8 {name} {kind} causal={causal}: max_abs_err {err} "
                        f"(tol {B1_TOL.get(kind)}), lse rel err {lse_err}")
                bound_ms, bound_by, flops = attention_bound(
                    b, h, s, 64, causal, kind, q, k, v, o_k, lse_k)
                # Device times with the host's launch gaps taken out: at
                # these sizes back-to-back events time the host.
                row = dict(
                    config=name, kind=kind, causal=causal, B=b, H=h, S=s,
                    S_pad=q.shape[2], max_abs_err=err, lse_rel_err=lse_err,
                    ms=queued_ms(torch, lambda: fa2.fa2_forward_small_aligned(
                        q, k, v, **kw)),
                    b1_ms=queued_ms(torch, lambda: fa2.fa2_forward_aligned(
                        q, k, v, **kw)),
                    plain_ms=queued_ms(torch, lambda: fa2.fa2_forward_small_plain(
                        q, k, v, **kw)),
                    library_ms=queued_ms(torch, lambda: F.scaled_dot_product_attention(
                        *lib_in, is_causal=causal, scale=scale)),
                    bound_ms=bound_ms, bound_by=bound_by)
                rows.append(row)
                log("B8", json.dumps(row))
    return rows


def phase_baselines(torch, F, base, fa2):
    """B9, B10 and B1's fp32 body (fa2_forward_aligned, tile code 0) against
    their plain versions at Small-2, Large-2 and Stress-1 in fp32, with
    SDPA's fp32 time on the same inputs: the suite's three fp32 forwards
    and the library call in one table."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for name in ("Small-2", "Large-2", "Stress-1"):
        b, h, s = SUITE[name]
        q, k, v = (torch.randn(b, h, s, 64, generator=gen, device="cuda")
                   for _ in range(3))
        kw = dict(sm_scale=64 ** -0.5, kv_len=s)
        fa2_kw = dict(kw, causal=False, tile_dtype=None)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=kw["sm_scale"]))
        for which, kernel, plain in (
                ("fa1", base.fa1_aligned, base.fa1_plain),
                ("naive_fa2", base.naive_fa2_aligned, base.naive_fa2_plain),
                ("fa2_fp32", lambda *a, **_: fa2.fa2_forward_aligned(*a, **fa2_kw),
                 lambda *a, **_: fa2.fa2_forward_plain(*a, **fa2_kw))):
            out_k, out_p = kernel(q, k, v, **kw), plain(q, k, v, **kw)
            torch.cuda.synchronize()
            o_k, o_p = (x[0] if isinstance(x, tuple) else x for x in (out_k, out_p))
            err = (o_k - o_p).abs().max().item()
            row = dict(kernel=which, config=name, B=b, H=h, S=s, max_abs_err=err)
            if which == "fa2_fp32":
                row["lse_rel_err"] = ((out_k[1] - out_p[1]).abs()
                                      / out_p[1].abs().clamp_min(1.0)).max().item()
                ok = err <= B1_TOL["fp32"] and row["lse_rel_err"] <= B1_FP32_LSE_TOL
            else:
                ok = err <= BASELINE_TOL
            if not ok:
                raise AssertionError(f"{which} {name}: {json.dumps(row)} (tol "
                                     f"{BASELINE_TOL}; B1 {B1_TOL['fp32']}, lse "
                                     f"{B1_FP32_LSE_TOL})")
            ms = time_ms(lambda: kernel(q, k, v, **kw), iters=10)
            bound_ms, bound_by, flops = attention_bound(b, h, s, 64, False, "fp32",
                                                        q, k, v, o_k)
            row.update(ms=ms, plain_ms=time_ms(lambda: plain(q, k, v, **kw),
                                               iters=3, warmup=1),
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log("baseline", json.dumps(row))
            del out_k, out_p, o_k, o_p
    return rows


def phase_fp16_tiles(torch, F, fp32_bwd, attention, fa2, bwd):
    """fp16 tiles: B1 against its plain version at Stress-1 (not causal),
    and B2, B3, B4 at Stress-1 and at the train shape (causal), all on fp32
    inputs: bf16 inputs give bf16 outputs, whose rounding hides the tile
    type from the fp16 gate."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    b, h, s = SUITE["Stress-1"]
    q, k, v = (torch.randn(b, h, s, 64, generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(causal=False, sm_scale=0.125, kv_len=s, tile_dtype=torch.float16)
    o_k, lse_k = fa2.fa2_forward_aligned(q, k, v, **kw)
    o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (o_k - o_p).abs().max().item()
    lse_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max().item()
    o_c, _ = fa2.fa2_forward_aligned(q, k, v, **dict(kw, tile_dtype=torch.bfloat16))
    fp16_gate("B1 Stress-1", rel_err(o_k, o_p), rel_err(o_c, o_p), FP16_REL_TOL["B1"])
    del o_c
    if not lse_err <= LSE_REL_TOL:
        raise AssertionError(f"B1 fp16 tiles Stress-1: lse rel err {lse_err}")
    lib_in = [t.half() for t in (q, k, v)]
    bound_ms, bound_by, flops = attention_bound(b, h, s, 64, False, "fp16",
                                                q, k, v, o_k, lse_k)
    ms = time_ms(lambda: fa2.fa2_forward_aligned(q, k, v, **kw))
    b1 = dict(kernel="fa2_forward", kind="fp16", config="Stress-1",
              max_abs_err=err, lse_rel_err=lse_err, ms=ms,
              plain_ms=time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw), iters=3),
              library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                  *lib_in, scale=0.125)),
              bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9)
    log("B1 fp16", json.dumps(b1))
    del q, k, v, o_k, o_p, lib_in
    every = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")
    rows = bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, "fp16",
                    torch.float32, b, s, every, hq=h, hkv=h, causal=False,
                    tile=torch.float16)
    rows += bwd_rows(torch, fp32_bwd, attention, fa2, bwd, gen, "fp16",
                     torch.float32, 4, 2048, every, tile=torch.float16)
    return b1, rows


def phase_cli(torch, np, cli, io, reference, build_dir):
    """The CLI end to end on a numpy-seeded Stress-1 data directory: fa2 in
    every mode and precision, fa1, fa2-naive and naive forward in fp32, fa2
    forward on an Edge-NonPowerOf2 directory (B8); one run as
    `python -m cuda_flash_attention_tpu_torch.cli` in a subprocess.  Every
    written file is held to the fp32 oracle."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(build_dir, exist_ok=True)
    checked = []
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        def data_dir(tag, arrays):
            path = os.path.join(tmp, tag, io.data_dir_name(*arrays[0].shape))
            os.makedirs(path)
            for n, a in zip("QKV", arrays):
                io.save_binary_file(os.path.join(path, f"{n}.bin"), a)
            return path

        def oracle(arrays, chunked):
            q, k, v = (torch.from_numpy(a).cuda() for a in arrays)
            if chunked:
                o, lse = reference.vanilla_attention_chunked(q, k, v, return_lse=True)
            else:
                o, lse = reference.vanilla_attention_with_lse(q, k, v)
            dq, dk, dv = reference.reference_attention_grads(q, k, v, chunked=chunked)
            return {"O.bin": o, "logsumexp.bin": lse, "dQ.bin": dq, "dK.bin": dk,
                    "dV.bin": dv}

        rel = {}  # (precision, mode, file) -> error relative to the oracle's max

        def check(path, ref, names, precision, how, mode=None):
            for name in names:
                want = ref[name]
                got = torch.from_numpy(io.load_binary_file(
                    os.path.join(path, name), tuple(want.shape))).cuda()
                err = (got - want).abs().max().item()
                rel[(precision, mode, name)] = err / want.abs().max().item()
                if name == "logsumexp.bin":
                    tol = 1e-5 if precision == "fp32" else LSE_REL_TOL * want.abs().max().item()
                elif name == "O.bin":
                    tol = cli_o_tol(precision, want.shape[2])
                elif precision == "bf16":
                    tol = BWD_TOL["bf16"] * want.abs().max().item()
                elif precision == "fp16":  # relative, by fp16_gate below
                    continue
                else:
                    tol = CLI_GRAD_TOL[precision]
                checked.append(dict(run=how, file=name, max_abs_err=err, tol=tol))
                if not err <= tol:
                    raise AssertionError(f"cli {how}: {name} max_abs_err {err} "
                                         f"(tol {tol})")

        rng = np.random.default_rng(17)
        stress = [rng.random((8, 16, 2048, 64), dtype=np.float32) for _ in range(3)]
        ref = oracle(stress, chunked=True)
        outputs = {"forward": ("O.bin", "logsumexp.bin"),
                   "backward": ("dQ.bin", "dK.bin", "dV.bin"),
                   "forward_backward": ("O.bin", "logsumexp.bin", "dQ.bin",
                                        "dK.bin", "dV.bin")}
        for precision in ("fp32", "fp16", "bf16"):
            path = data_dir(precision, stress)
            for mode in ("forward", "backward", "forward_backward"):
                argv = ["fa2", mode, precision, path]
                if (precision, mode) == ("fp32", "forward"):
                    proc = subprocess.run(
                        [sys.executable, "-m", "cuda_flash_attention_tpu_torch.cli",
                         *argv], cwd=root, capture_output=True, text=True,
                        timeout=600, env=dict(os.environ, PYTHONPATH=root))
                    if proc.returncode != 0:
                        raise AssertionError(f"cli subprocess: {proc.returncode}\n"
                                             f"{proc.stdout}\n{proc.stderr}")
                    log("cli subprocess:", proc.stdout.strip().splitlines()[-1])
                elif cli.main(argv) != 0:
                    raise AssertionError(f"cli {argv}: non-zero exit")
                check(path, ref, outputs[mode], precision, f"fa2 {mode} {precision}",
                      mode)
        # fp16 files against fp16's own gates, the bf16 run's same file as
        # the control.
        for (precision, mode, name), err in rel.items():
            if precision == "fp16" and name != "logsumexp.bin":
                fp16_gate(f"cli fa2 {mode} {name}", err, rel[("bf16", mode, name)],
                          CLI_FP16_REL_TOL[name])
        for method in ("fa1", "fa2-naive", "naive"):
            path = data_dir(method, stress)
            if cli.main([method, "forward", "fp32", path]) != 0:
                raise AssertionError(f"cli {method}: non-zero exit")
            names = ("O.bin", "logsumexp.bin") if method == "naive" else ("O.bin",)
            if os.path.exists(os.path.join(path, "logsumexp.bin")) != (method == "naive"):
                raise AssertionError(f"cli {method}: logsumexp.bin written wrongly")
            check(path, ref, names, "fp32", f"{method} forward fp32")
        del ref
        edge = [rng.random((8, 16, 100, 64), dtype=np.float32) for _ in range(3)]
        path = data_dir("edge", edge)
        if cli.main(["fa2", "forward", "fp32", path]) != 0:
            raise AssertionError("cli edge: non-zero exit")
        check(path, oracle(edge, chunked=False), outputs["forward"], "fp32",
              "fa2 forward fp32 Edge-NonPowerOf2")
    worst = max(checked, key=lambda c: c["max_abs_err"] / c["tol"])
    log("cli", json.dumps(dict(files_checked=len(checked), worst=worst)))
    return checked


def phase_harness(harness, configs):
    """The reference suite through the harness on the card: the forward
    experiment (10 configs x fa2-naive, vanilla, fa2), fa1 forward and fa2
    both, fp32 at tolerance 1e-3.  Any FAIL row raises."""
    cfgs = (configs.create_experiment_configs("forward")
            + configs.create_test_configs("forward", "fa1")
            + configs.create_test_configs("both", "fa2"))
    h = harness.Harness(tolerance=1e-3, iters=5, warmup=1, device="cuda")
    results = h.run(cfgs)
    header = list(results[0].as_row())
    log("harness csv:", ",".join(header))
    for r in results:
        log("harness csv:", ",".join(str(x) for x in r.as_row().values()))
    log(h.summary())
    failed = [r.as_row() for r in results if not r.passed]
    if failed or len(results) != len(cfgs):
        raise AssertionError(f"harness: {len(failed)} FAIL rows of {len(results)} "
                             f"run ({len(cfgs)} configs): {failed[:1]}")
    return results


# ---------------------------------------------------------------------------
# Phases 19-23: the quantized path.
# ---------------------------------------------------------------------------

B7_FP32_TOL = 2e-5
STORAGES = ("int8", "e4m3", "e5m2", "int4")
# B7's and X's bf16 outputs against their plain versions, element by element:
# |o_k - o_p| <= BF16_RTOL * |o_p| + BF16_ATOL.  The two round to bf16 fp32
# values that differ only in summation order, so they land one bf16 step (at
# most 2^-7 of the value) apart.  The absolute term covers values near zero,
# where a P rounded to the other side of a bf16 step moves a sum that cancels:
# about 3x the largest reading on the card (H100; chip_smoke and the card
# tests): B7 1.5e-3, from causal rows of a few keys with |P V| terms near 1
# (non-causal 6.8e-4); X 1.6e-4.  The control that must fail it: the plain version with one 8-key
# n-tile of V zeroed (readings 0.25 and 0.11).
BF16_RTOL = 2.0 ** -7
BF16_ATOL = {"B7": 4e-3, "X": 5e-4}
# X's lse against its plain version: the largest error, and the mean over
# rows.  v3 rounds l to bf16: sums that differ in their last fp32 bits round
# to neighbouring bf16 values in a few rows, one step is log(1 + 2^-7) =
# 7.8e-3; the mean stays at fp32 noise.  The control that must fail the mean
# gate: v3's kernel lse against v0's plain lse (l not rounded).
X_LSE_TOL = {"v3_bf16_sum": 8e-3}
X_LSE_MAX_TOL = 2e-4
X_LSE_MEAN_TOL = 1e-4
# merge_lora's int4 requantization budget on logits (tests/test_quant.py:317).
QLORA_MERGE_TOL = 0.6
# merge_lora on the weights: every merged weight within half its own int4
# step of base + delta (fp32 slack on top).
QLORA_STEP_TOL = 0.5 + 1e-3


def bf16_excess(o_k, o_p) -> float:
    """The least BF16_ATOL under which o_k passes the bf16 gate against o_p."""
    o_k, o_p = o_k.float(), o_p.float()
    return ((o_k - o_p).abs() - BF16_RTOL * o_p.abs()).clamp_min(0).max().item()


def zero_ntile(v, axis):
    """v with one 8-key n-tile (keys 8-15 along `axis`) zeroed: the controls'
    fault, a kernel that skips one n-tile of P V."""
    v = v.clone()
    v.narrow(axis, 8, 8).zero_()
    return v


def storage_dtype(torch, name):
    """A storage name as the port's dtype argument ("int4" stays a string)."""
    return {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
            "e5m2": torch.float8_e5m2}.get(name, name)


def quant_problem(torch, quant, fq, gen, storage, b, hq, hkv, s, d, q_dtype):
    """Seeded q and quantized K/V on the card: (API args, B7's aligned args,
    bf16 dequantized K/V for the yardsticks)."""
    q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(q_dtype)
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") for _ in range(2))
    k_q, v_q = quant.quantize_kv(k, v, storage_dtype(torch, storage))
    deq = [t.dequantize(torch.bfloat16) for t in (k_q, v_q)]
    return (q, k_q, v_q), fq.aligned_inputs(q, k_q, v_q), deq


def phase_b7(torch, F, quant, fq, fa2):
    """B7 against its plain version over every storage x {bf16, fp32} x
    causal at B2 Hq16 Hkv8 S1000 D64 and D128; timed at the base model's
    attention shape (B4 Hq16 Hkv8 S2048 D64 causal bf16) and at long
    context (B1 S8192) beside B1 and SDPA on the dequantized bf16 K/V (not
    the same function: yardsticks of the 1-byte read); then the public API
    at both timed shapes, whose launches are the path's."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    checks = []
    for d in (64, 128):
        for storage in STORAGES:
            for kind in ("bf16", "fp32"):
                cdt = torch.bfloat16 if kind == "bf16" else torch.float32
                _, args, _ = quant_problem(torch, quant, fq, gen, storage, 2, 16, 8,
                                           1000, d, cdt)
                for causal in (True, False):
                    kw = dict(causal=causal, sm_scale=d ** -0.5, kv_len=1000,
                              compute_dtype=cdt)
                    o_k, lse_k = fq.fa2_forward_quant_aligned(*args, **kw)
                    o_p, lse_p = fq.fa2_forward_quant_plain(*args, **kw)
                    torch.cuda.synchronize()
                    o_k, o_p = o_k[:, :, :1000], o_p[:, :, :1000]
                    err = (o_k.float() - o_p.float()).abs().max().item()
                    excess = bf16_excess(o_k, o_p)
                    lse_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0)
                               )[:, :, :1000].max().item()
                    checks.append(dict(d=d, storage=storage, kind=kind, causal=causal,
                                       max_abs_err=err, bf16_excess=excess,
                                       lse_rel_err=lse_err))
                    ok = (excess <= BF16_ATOL["B7"] if kind == "bf16"
                          else err <= B7_FP32_TOL)
                    if not (ok and lse_err <= LSE_REL_TOL):
                        raise AssertionError(f"B7 {checks[-1]} (bf16 atol {BF16_ATOL['B7']}, "
                                             f"fp32 tol {B7_FP32_TOL})")
    log("B7 checks", json.dumps(dict(
        n=len(checks),
        worst_bf16=max(c["max_abs_err"] for c in checks if c["kind"] == "bf16"),
        worst_bf16_excess=max(c["bf16_excess"] for c in checks if c["kind"] == "bf16"),
        worst_bf16_excess_noncausal=max(c["bf16_excess"] for c in checks
                                        if c["kind"] == "bf16" and not c["causal"]),
        worst_fp32=max(c["max_abs_err"] for c in checks if c["kind"] == "fp32"))))

    rows, api_inputs = [], []
    for shape, (b, s) in (("base", (4, 2048)), ("long", (1, 8192))):
        for storage in STORAGES:
            api, args, (kd, vd) = quant_problem(torch, quant, fq, gen, storage, b, 16,
                                                8, s, 64, torch.bfloat16)
            kw = dict(causal=True, sm_scale=0.125, kv_len=s, compute_dtype=torch.bfloat16)
            o_k, lse_k = fq.fa2_forward_quant_aligned(*args, **kw)
            o_p, lse_p = fq.fa2_forward_quant_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (o_k.float() - o_p.float()).abs().max().item()
            excess = bf16_excess(o_k, o_p)
            if not excess <= BF16_ATOL["B7"]:
                raise AssertionError(f"B7 {shape} {storage}: max_abs_err {err}, "
                                     f"bf16 excess {excess} (atol {BF16_ATOL['B7']})")
            del o_p, lse_p
            b1_kw = dict(causal=True, sm_scale=0.125, kv_len=s, tile_dtype=torch.bfloat16)
            # Each tensor moved once: q, the 1-byte (int4: half-byte) K/V and
            # their scales, O and lse.
            bound_ms, bound_by, _ = attention_bound(b, 16, s, 64, True, "bf16",
                                                    *args, o_k, lse_k)
            row = dict(
                shape=shape, B=b, S=s, storage=storage, max_abs_err=err,
                bf16_excess=excess, ms=time_ms(lambda: fq.fa2_forward_quant_aligned(*args, **kw)),
                plain_ms=time_ms(lambda: fq.fa2_forward_quant_plain(*args, **kw),
                                 iters=2 if shape == "base" else 1, warmup=1),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                b1_dequant_ms=time_ms(lambda: fa2.fa2_forward_aligned(
                    args[0], kd, vd, **b1_kw)),
                sdpa_dequant_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    args[0], kd, vd, is_causal=True, scale=0.125, enable_gqa=True)))
            row["tflops"] = 4 * b * 16 * causal_pairs(s, s, True) * 64 / row["ms"] / 1e9
            rows.append(row)
            log("B7", json.dumps(row))
            api_inputs.append((api, o_k))
            del kd, vd
    # fp32 compute at the base shape (int8 K/V), beside B1's fp32 body on the
    # dequantized fp32 K/V (a yardstick, not the same function).
    api, args, _ = quant_problem(torch, quant, fq, gen, "int8", 4, 16, 8, 2048, 64,
                                 torch.float32)
    kw = dict(causal=True, sm_scale=0.125, kv_len=2048, compute_dtype=torch.float32)
    o_k, lse_k = fq.fa2_forward_quant_aligned(*args, **kw)
    o_p, _ = fq.fa2_forward_quant_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (o_k - o_p).abs().max().item()
    if not err <= B7_FP32_TOL:
        raise AssertionError(f"B7 fp32 base int8: max_abs_err {err} (tol {B7_FP32_TOL})")
    kd, vd = (t.dequantize(torch.float32) for t in api[1:])
    bound_ms, bound_by, _ = attention_bound(4, 16, 2048, 64, True, "fp32", *args, o_k, lse_k)
    fp32_row = dict(
        shape="base", B=4, S=2048, storage="int8", compute="fp32", max_abs_err=err,
        ms=time_ms(lambda: fq.fa2_forward_quant_aligned(*args, **kw)),
        plain_ms=time_ms(lambda: fq.fa2_forward_quant_plain(*args, **kw), iters=1,
                         warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        b1_fp32_dequant_ms=time_ms(lambda: fa2.fa2_forward_aligned(
            args[0], kd, vd, causal=True, sm_scale=0.125, kv_len=2048, tile_dtype=None)))
    log("B7 fp32", json.dumps(fp32_row))
    del o_k, o_p, kd, vd, args, api

    # The public API on the timed inputs: its launches are the path's.
    reset_counts(["fa2_forward_quant"])
    for (q, k_q, v_q), o_k in api_inputs:
        o = fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True)
        if not torch.equal(o, o_k[:, :, :q.shape[2]]):
            raise AssertionError("B7: the public API differs from the aligned kernel")
    api_launches = launch_counts()["fa2_forward_quant"]
    log(f"B7 public API: {api_launches} launches over {len(api_inputs)} calls")
    if api_launches != len(api_inputs):
        raise AssertionError(f"B7 public API launched {api_launches} times")

    # The control: the plain version with one 8-key n-tile of V zeroed
    # (non-causal, int8, D64, bf16) must fail the bf16 gate.
    _, args, _ = quant_problem(torch, quant, fq, gen, "int8", 2, 16, 8, 1000, 64,
                               torch.bfloat16)
    kw = dict(causal=False, sm_scale=0.125, kv_len=1000, compute_dtype=torch.bfloat16)
    o_p, _ = fq.fa2_forward_quant_plain(*args, **kw)
    o_c, _ = fq.fa2_forward_quant_plain(*args[:3], zero_ntile(args[3], 2), args[4], **kw)
    control = bf16_excess(o_c, o_p)
    log("B7 bf16 gate control", json.dumps(dict(control_excess=control,
                                                atol=BF16_ATOL["B7"])))
    if not control > BF16_ATOL["B7"]:
        raise AssertionError(f"B7: the control passed the bf16 gate ({control})")
    return checks, rows, fp32_row, api_launches


def quant_pages(torch, kv_cache, gen, cache, shape):
    """A paged cache [Hkv, P, page, D] written by the cache's own quantizer
    from random rows: fp8 codes flushed below the minimum normal, int4
    packed split-half."""
    dtype, _, packed = kv_cache._resolve_cache_dtype(storage_dtype(torch, cache),
                                                     shape[-1])

    def pair():
        return kv_cache._quantize_rows(
            torch.randn(shape, generator=gen, device="cuda"), dtype, packed)

    (kp, ks), (vp, vs) = pair(), pair()
    return kv_cache.KVPages(kp, ks, vp, vs)


def phase_paged_quant(torch, dec_attn, kv_cache):
    """B5 and B6 against their plain versions on e4m3, e5m2 and int4 pages
    at phase 3's and phase 12's shapes, with times and bounds (int4 pages
    counted at half a byte per element)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    hq, hkv, d, page = 16, 8, 64, 128
    cases = [("B5", 1, [2048, 1, 129, 0, 777, 1500, 128, 2000], c)
             for c in ("bf16", "fp32")]
    cases += [("B6 spec", 5, B6_SPEC_LENGTHS, c) for c in ("bf16", "fp32")]
    cases += [("B6 prefill", 512, B6_PREFILL_LENGTHS, "bf16")]
    rows = []
    for cache in ("e4m3", "e5m2", "int4"):
        elem = 0.5 if cache == "int4" else 1
        for name, chunk, lens, compute in cases:
            n, pps = len(lens), 2048 // page
            num_pages = n * pps + 1
            pages = quant_pages(torch, kv_cache, gen, cache, (hkv, num_pages, page, d))
            table = (torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
                     ).reshape(n, pps).to(torch.int32).contiguous()
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            cdt = torch.bfloat16 if compute == "bf16" else torch.float32
            if name == "B5":
                q = torch.randn(n, hq, d, generator=gen, device="cuda").to(cdt)
                kernel, plain = (dec_attn.paged_decode_attention,
                                 dec_attn.paged_decode_attention_plain)
            else:
                q = torch.randn(n, chunk, hq, d, generator=gen, device="cuda").to(cdt)
                kernel, plain = (dec_attn.paged_chunk_attention,
                                 dec_attn.paged_chunk_attention_plain)
            kw = dict(sm_scale=d ** -0.5, compute_dtype=cdt)
            o_k = kernel(q, pages, table, lengths, **kw)
            o_p = plain(q, pages, table, lengths, **kw)
            torch.cuda.synchronize()
            err = (o_k.float() - o_p.float()).abs().max().item()
            if not err <= B5_TOL[compute]:
                raise AssertionError(f"{name} {cache} {compute}: max_abs_err {err}")
            if 0 in lens and o_k[lens.index(0)].abs().max().item() != 0.0:
                raise AssertionError(f"{name} {cache}: the inactive slot is not zero")
            bound_ms, bound_by, flops, moved = paged_bound(
                lens, chunk, hq, hkv, d, elem, q, o_k, compute)
            row = dict(kernel=name, cache=cache, compute=compute, T=chunk, lengths=lens,
                       max_abs_err=err, ms=time_ms(lambda: kernel(q, pages, table,
                                                                  lengths, **kw)),
                       device_ms=queued_ms(torch, lambda: kernel(q, pages, table,
                                                                 lengths, **kw)),
                       plain_ms=time_ms(lambda: plain(q, pages, table, lengths, **kw),
                                        iters=3, warmup=1),
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            row["gbps"] = moved / row["ms"] / 1e6
            rows.append(row)
            log("paged quant", json.dumps(row))
            del pages, o_k, o_p
    return rows


def phase_quant_serving(torch, np, transformer, decode, quant):
    """TransformerConfig.base() serving phase 5's 12 requests (seed 4, 8
    slots, 64 greedy tokens) on an int8 cache (the control), (a) an e4m3
    cache, (b) an int4 cache, (c) int8 W8A8 weights on an int8 cache, (d)
    int4 weights on an int8 cache, and chunked prefill 512 on the int4
    cache, with one profiled window of decode steps for (d); then fp32 at
    base width, the card against the CPU for (b) + (d) together."""
    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = serving_mix(np, cfg)
    w8a8 = quant.quantize_transformer_params(params, torch.int8, act_quant=True)
    w4 = quant.quantize_transformer_params(params, "int4")
    # The int8 cache first: phase 5's engine again, the control that the
    # other modes are compared with inside this phase.
    modes = [("int8 cache (control)", params, torch.int8, {}),
             ("e4m3 cache", params, torch.float8_e4m3fn, {}),
             ("int4 cache", params, "int4", {}),
             ("w8a8 weights, int8 cache", w8a8, torch.int8, {}),
             ("int4 weights, int8 cache", w4, torch.int8, {}),
             ("int4 cache, chunked prefill 512", params, "int4",
              dict(prefill_chunk=512))]
    res = {}
    for name, p, cache, kw in modes:
        eng = decode.DecodeEngine(p, cfg, max_seqs=8, max_seq_len=2048,
                                  cache_dtype=cache, **kw)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        need = (("paged_chunk", "paged_decode") if kw
                else ("fa2_forward", "paged_decode"))
        check_served(f"quant serving {name}", reqs, eng, launches, need,
                     cfg.vocab_size, 64)
        total = sum(len(r.generated) for r in reqs)
        res[name] = dict(requests=len(reqs), tokens=total, seconds=elapsed,
                         tokens_per_s=total / elapsed,
                         decode_step_ms_mean=elapsed / eng.stats["steps"] * 1e3,
                         steps=eng.stats["steps"],
                         ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
                         prefill_chunks=eng.stats["prefill_chunks"], launches=launches)
        log("quant serving", name, json.dumps(res[name]))
        if name.startswith("int4 weights"):
            res[name]["profile"] = phase_profile(torch, np, eng,
                                                 "quant profile (int4 weights)")
        del eng
    del params, w8a8, w4
    torch.cuda.empty_cache()

    # (b) + (d) in fp32 at base width: the card against the CPU.
    cfg32 = transformer.TransformerConfig.base(dtype=torch.float32, attn_tile_dtype=None)
    w4 = quant.quantize_transformer_params(transformer.init_params(
        torch.Generator().manual_seed(0), cfg32, device="cpu"), "int4")
    prompt = np.random.default_rng(3).integers(0, cfg32.vocab_size, 128).tolist()
    out = {}
    for dev in ("cuda", "cpu"):
        eng = decode.DecodeEngine(w4, cfg32, max_seqs=2, max_seq_len=256,
                                  cache_dtype="int4", device=dev)
        with torch.inference_mode():
            logits, _ = decode.prefill_forward(eng.params, torch.tensor([prompt], device=dev),
                                               cfg32)
        (req,) = eng.run([prompt], max_new_tokens=5)
        out[dev] = (logits.cpu(), req.generated)
    diff = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    res["parity_int4_cache_int4_weights_fp32"] = dict(
        prefill_logit_diff=diff, greedy_cuda=out["cuda"][1], greedy_cpu=out["cpu"][1])
    log("quant serving parity", json.dumps(res["parity_int4_cache_int4_weights_fp32"]))
    if not diff <= E2E_LOGIT_TOL or out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"quant serving parity: logits {diff}, tokens "
                             f"{out['cuda'][1]} vs {out['cpu'][1]}")
    return res


def merge_steps(torch, transformer, lora, params):
    """(merge_lora(params), the largest distance of a merged weight from
    base + delta, and of the base alone from it, each in units of the
    merged weight's own int4 step, over every adapted weight)."""
    merged = lora.merge_lora(params)
    worst = {"merged": 0.0, "base_alone": 0.0}

    def one(x, m):
        if not isinstance(x, lora.LoRATensor):
            return
        base = x.base.dequantize(torch.float32)
        delta = (x.a.float() @ x.b.float()) * x.scale
        step = m.scales.expand(-1, m.group_size, -1).reshape(base.shape)
        worst["merged"] = max(worst["merged"], (
            (m.dequantize(torch.float32) - base - delta).abs() / step).max().item())
        worst["base_alone"] = max(worst["base_alone"],
                                  (delta.abs() / step).max().item())

    transformer.tree_map(one, params, merged)
    return merged, worst


def phase_qlora(torch, np, transformer, training, lora, quant):
    """Two LoRA AdamW steps at base width, B4 S2048, on an int4 base: the
    loss finite, the base bytes unchanged, the adapters moved, merge_lora's
    logits within the int4 requantization budget of the unmerged ones.
    After two steps the delta is far below half an int4 step, so neither
    the logits nor the merged codes can show it; merge_lora is also held, on
    the weights, to base + delta within half a step, both for the trained
    adapters and for b drawn at N(0, 0.5^2), whose delta spans several
    steps: there a merge that dropped the delta would miss by more."""
    cfg = transformer.TransformerConfig.base()
    b, s = 4, 2048
    base = quant.quantize_transformer_params(transformer.init_params(
        torch.Generator(device="cuda").manual_seed(2), cfg, device="cuda"), "int4")
    lp = lora.apply_lora(base, torch.Generator(device="cuda").manual_seed(3), rank=8)
    def lora_leaves(params):
        return [x for x in transformer.tree_leaves(params)
                if isinstance(x, lora.LoRATensor)]

    before = [x.base.values.clone() for x in lora_leaves(lp)]
    opt = training.make_lora_optimizer(training.make_optimizer(
        learning_rate=1e-3, warmup_steps=1, decay_steps=100), lp)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(lp, opt)
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (b, s + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(TRAIN_KERNELS)
    losses, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = read_counts(TRAIN_KERNELS)
    after = lora_leaves(state.params)
    same_base = all(torch.equal(x0, x.base.values) for x0, x in zip(before, after))
    moved = sum(bool(x.b.any()) for x in after)
    with torch.no_grad():
        probe = torch.as_tensor(tokens[:1, :256], device="cuda")
        logits = transformer.forward(state.params, probe, cfg)
        merged_params, trained_steps = merge_steps(torch, transformer, lora,
                                                   state.params)
        merged = transformer.forward(merged_params, probe, cfg)
        del merged_params
        gen = torch.Generator(device="cuda").manual_seed(4)
        big = lora.replace_adapters(state.params, [
            t if i % 2 == 0 else 0.5 * torch.randn(t.shape, generator=gen, device="cuda")
            for i, t in enumerate(lora.lora_adapters(state.params))])
        _, big_steps = merge_steps(torch, transformer, lora, big)
        del big
    merge_diff = (logits - merged).abs().max().item()
    res = dict(batch=b, seq=s, rank=8, losses=losses, step_ms=[t * 1e3 for t in times],
               tokens_per_s=b * s / times[-1],
               adapter_params=sum(t.numel() for t in lora.lora_adapters(state.params)),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               base_unchanged=same_base, adapters_moved=moved, adapters=len(after),
               merge_logit_diff=merge_diff,
               merge_steps={"trained": trained_steps, "large_b": big_steps},
               launches=launches)
    log("qlora", json.dumps(res))
    if not (all(np.isfinite(losses)) and same_base and moved == len(after)
            and merge_diff <= QLORA_MERGE_TOL
            and trained_steps["merged"] <= QLORA_STEP_TOL
            and big_steps["merged"] <= QLORA_STEP_TOL
            and big_steps["base_alone"] > QLORA_STEP_TOL):
        raise AssertionError(f"qlora: {res}")
    if not (launches["fa2_forward"] and launches["fa2_backward_fused"]):
        raise AssertionError(f"qlora: a kernel of the path never ran: {launches}")
    return res


def phase_x(torch, r5):
    """X's entry point at B4 H8 S2048 D128 bf16 (its launches are the
    path's), then each variant against its plain version on the same
    inputs, with bounds and plain times."""
    reset_counts(["r5_d128_fwd"])
    rows = r5.main([])
    launches = launch_counts()["r5_d128_fwd"]
    if launches < len(r5.VARIANTS):
        raise AssertionError(f"X: {launches} launches in its entry point")
    gen = torch.Generator(device="cuda").manual_seed(0)  # main's inputs
    q, k, v = (torch.randn(r5.B, r5.H, r5.S, r5.D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    b1, sdpa = (next(r for r in rows if r["variant"] == n) for n in ("B1", "SDPA"))
    out, lse_v3 = [], None
    for row in rows[:len(r5.VARIANTS)]:
        name = row["variant"]
        o_k, lse_k = r5.fwd(q, k, v, name)
        o_p, lse_p = r5.fwd_plain(q, k, v, name)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        excess = bf16_excess(o_k, o_p)
        lse_d = (lse_k - lse_p).abs()
        lse_err, lse_mean = lse_d.max().item(), lse_d.mean().item()
        tol = X_LSE_TOL.get(name, X_LSE_MAX_TOL)
        bound_ms, bound_by, _ = attention_bound(r5.B, r5.H, r5.S, r5.D, False, "bf16",
                                                q, k, v, o_k, lse_k)
        if not (excess <= BF16_ATOL["X"] and lse_err <= tol and lse_mean <= X_LSE_MEAN_TOL):
            raise AssertionError(f"X {name}: max_abs_err {err}, bf16 excess {excess}, "
                                 f"lse err {lse_err}, mean {lse_mean}")
        if name == "v3_bf16_sum":
            lse_v3 = lse_k
        out.append(dict(variant=name, ms=row["ms"], tflops=row["tflops"],
                        err_vs_b1=row["err"], max_abs_err=err, bf16_excess=excess,
                        lse_err=lse_err, lse_mean_err=lse_mean,
                        plain_ms=time_ms(lambda: r5.fwd_plain(q, k, v, name),
                                         iters=2, warmup=1),
                        b1_ms=b1["ms"], library_ms=sdpa["ms"], bound_ms=bound_ms,
                        bound_by=bound_by))
        log("X", json.dumps(out[-1]))
        del o_k, o_p

    # The controls: v0's plain version with one 8-key n-tile of V zeroed
    # must fail the bf16 gate, and v3's kernel lse against v0's plain lse
    # (l not rounded to bf16) must fail the mean lse gate.
    o_p, lse_p = r5.fwd_plain(q, k, v, "v0_current")
    o_c, _ = r5.fwd_plain(q, k, zero_ntile(v, 2), "v0_current")
    control = dict(o_excess=bf16_excess(o_c, o_p),
                   v3_lse_mean_vs_v0=(lse_v3 - lse_p).abs().mean().item())
    log("X gate controls", json.dumps(control))
    if not (control["o_excess"] > BF16_ATOL["X"]
            and control["v3_lse_mean_vs_v0"] > X_LSE_MEAN_TOL):
        raise AssertionError(f"X: a control passed its gate: {control}")
    return out, launches


def phase_bench(torch, np, transformer, decode, decode_bench, train_bench,
                serve_profile, label_profile):
    """The serving and training benchmarks at TransformerConfig.base(): the
    decode device loop (a CUDA graph of one step against eager launches),
    greedy tokens of the burst-8 engine, the burst-1 engine and an eager
    decode_step loop (bitwise equal), the engine at bursts 1 and 8 with
    engine_overhead_x and on phase 5's 12 requests, and the train step."""
    cfg = transformer.TransformerConfig.base()
    b, p, gen = 16, 128, 32
    out = {}
    reset_counts(SERVING_KERNELS)
    loop = decode_bench.measure_decode_throughput(cfg, batch=b, prompt_len=p,
                                                  gen_tokens=gen, repeats=3)
    loop["eager_over_graph"] = loop["eager_step_ms"] / loop["step_ms"]
    loop["launches"] = read_counts(SERVING_KERNELS)
    out["device_loop"] = loop
    log("bench device loop", json.dumps(loop))
    if not all(loop["launches"][k] for k in ("fa2_forward", "paged_decode")):
        raise AssertionError(f"bench: a kernel of the loop never ran: {loop}")

    # Greedy tokens three ways on the same 16 prompts and weights: the
    # engine at bursts 1 and 8 (graphs) and an eager decode_step loop from
    # the engine's first tokens, at the engine's table width (16 pages).
    max_len = 2048
    params, caches, table, first = decode_bench.build_state(cfg, b, p, max_len)
    prompts = decode_bench._prompt_tokens(cfg, b, p, 0).tolist()
    toks = {}
    for burst in (1, 8):
        eng = decode.DecodeEngine(params, cfg, max_seqs=b, max_seq_len=max_len,
                                  decode_burst=burst)
        reqs = eng.run(prompts, max_new_tokens=gen + 1)
        toks[burst] = [r.generated for r in reqs]
        if not eng.graph_replays or (burst > 1
                                     and not eng.stats.get("burst_dispatches")):
            raise AssertionError(f"bench: burst {burst} ran no graph replay or "
                                 f"burst: {eng.stats}, {eng.graph_replays}")
    eager = decode_bench.make_loop_fn(cfg, table, p, graph=False)
    eager(params, caches, torch.tensor([t[0] for t in toks[1]], device="cuda"), gen)
    toks["eager"] = [[t[0]] + col for t, col in zip(
        toks[1], eager.history.T.tolist())]
    same = toks[8] == toks[1] == toks["eager"]
    out["greedy_bitwise_equal"] = same
    log(f"bench greedy tokens: burst 8 == burst 1 == eager loop: {same}")
    if not same:
        raise AssertionError("bench: greedy tokens differ between burst 8, "
                             "burst 1 and the eager loop")
    del params, caches, eng

    for burst in (1, 8):
        reset_counts(SERVING_KERNELS)
        e = decode_bench.measure_engine_throughput(cfg, batch=b, prompt_len=p,
                                                   gen_tokens=gen,
                                                   decode_burst=burst)
        e["engine_overhead_x"] = e["engine_ms_per_token_step"] / loop["step_ms"]
        e["launches"] = read_counts(SERVING_KERNELS)
        out[f"engine_burst{burst}"] = e
        log(f"bench engine burst {burst}", json.dumps(e))

    # Phase 5's 12 requests at bursts 1 and 8: the same tokens.
    served = {}
    for burst in (1, 8):
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                                  decode_burst=burst)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        reqs = eng.run(serving_mix(np, cfg), max_new_tokens=64)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        check_served(f"bench serving burst {burst}", reqs, eng, launches,
                     ("fa2_forward", "paged_decode"), cfg.vocab_size, 64)
        total = sum(len(r.generated) for r in reqs)
        served[burst] = [r.generated for r in reqs]
        out[f"serving_burst{burst}"] = dict(
            tokens=total, seconds=elapsed, tokens_per_s=total / elapsed,
            steps=eng.stats["steps"],
            burst_dispatches=eng.stats.get("burst_dispatches", 0),
            graph_replays=eng.graph_replays,
            ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
            tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
            launches=launches)
        log(f"bench serving burst {burst}", json.dumps(out[f"serving_burst{burst}"]))
        if burst == 8:
            out["profile_burst8"] = phase_profile(torch, np, eng,
                                                  "bench profile (burst 8)",
                                                  new_tokens=8 * 13 + 1)
        del eng, params
    if served[1] != served[8]:
        raise AssertionError("bench: phase 5's requests differ between bursts 1 and 8")
    out["profile_burst1"] = {k: serve_profile[k] for k in (
        "decode_step_ms", "tokens_per_step", "device_busy_ms_per_step",
        "device_idle_share", "kernel_launches_per_step",
        "host_launch_calls_per_step")}
    log(label_profile, json.dumps(out["profile_burst1"]))

    torch.cuda.empty_cache()
    reset_counts(TRAIN_KERNELS)
    train = train_bench.measure_train_throughput(cfg, 4, 2048, iters=2, repeats=2)
    train["launches"] = read_counts(TRAIN_KERNELS)
    out["train"] = train
    log("bench train", json.dumps(train))
    log(f"bench train tokens/s {train['train_tokens_per_sec_per_chip']:.1f} "
        f"(step {train['step_ms']:.2f} ms, {train['repeats']} slopes "
        f"{train['step_ms_min']:.2f}-{train['step_ms_max']:.2f} ms)")
    if not (np.isfinite(train["loss"]) and train["launches"]["fa2_forward"]
            and train["launches"]["fa2_backward_fused"]):
        raise AssertionError(f"bench train: {train}")
    return out


# Phase 25: sliding windows and attention sinks on the serving path.
# B1 cases: (name, B, Hq, Hkv, S, causal, window, sinks), each in bf16
# tiles and fp32; the band's offset <= 0 leaves rows with no key.
WINDOW_B1_CASES = (
    ("B4 S1536 w128 s4", 4, 16, 8, 1536, True, 128, 4),
    ("B4 S1536 w128", 4, 16, 8, 1536, True, 128, 0),
    ("B1 S8192 w1024", 1, 16, 8, 8192, True, 1024, 0),
    ("B2 S1024 band -100", 2, 16, 8, 1024, False, -100, 0),
)
# The serving configurations' windows: the hybrid's 128 and the streaming
# recipe's sinks (4) at phase 3's and phase 12's shapes.
WINDOW, SINKS = 128, 4


def kept_cols(pos: int, kv_len: int, causal: bool, window: int, sinks: int) -> int:
    """Keys a row at `pos` keeps among kv_len: (pos - window, pos] (to the
    end without causal masking) and the sinks [0, sinks)."""
    hi = min(pos, kv_len - 1) if causal else kv_len - 1
    lo = max(0, pos - window + 1)
    return max(0, hi - lo + 1) + min(max(0, min(sinks, hi + 1)), lo)


def window_pairs(sq: int, kv_len: int, causal: bool, window: int, sinks: int) -> int:
    return sum(kept_cols(i, kv_len, causal, window, sinks) for i in range(sq))


def lse_gate(torch, lse_k, lse_p):
    """(relative error on the rows that keep a key, whether the rows that
    keep none carry the plain version's lse bit for bit)."""
    dead = lse_p < -1e30
    live_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0))[~dead]
    err = live_err.max().item() if live_err.numel() else 0.0
    return err, bool(torch.equal(lse_k[dead], lse_p[dead]))


def band_mask(torch, attention_common, q, k, kw):
    """SDPA's boolean mask (True keeps) for B1's or B8's keyword arguments."""
    return attention_common.build_element_mask(
        q.shape[2], k.shape[2], causal=kw["causal"], kv_len=kw["kv_len"],
        device=q.device, window=kw["window"], sinks=kw["sinks"])


def phase_window_forward(torch, F, attention, fa2, common):
    """B1 and B8 with windows and sinks against their plain versions, an
    off-by-one window as the control (it must fail the gate), times beside
    SDPA with the band as an explicit boolean mask and, at S8192, B1's
    global causal time on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = []

    def check(label, kernel_fn, plain_fn, kw, kind, q, k, v, control=False):
        o_k, lse_k = kernel_fn(q, k, v, **kw)
        o_p, lse_p = plain_fn(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)
        tol = B1_TOL[kind]
        if not (err <= tol and lse_err <= LSE_REL_TOL and dead_equal):
            raise AssertionError(f"{label}: max_abs_err {err} (tol {tol}), lse rel "
                                 f"err {lse_err}, dead rows equal {dead_equal}")
        control_err = None
        if control:
            o_c, _ = plain_fn(q, k, v, **dict(kw, window=kw["window"] + 1))
            control_err = (o_k.float() - o_c.float()).abs().max().item()
            if control_err <= tol:
                raise AssertionError(f"{label}: an off-by-one window passes the "
                                     f"gate ({control_err} <= {tol})")
        return o_k, lse_k, err, lse_err, control_err

    for name, b, hq, hkv, s, causal, window, sinks in WINDOW_B1_CASES:
        for kind in ("bf16", "fp32"):
            tile = None if kind == "fp32" else torch.bfloat16
            dt = torch.float32 if kind == "fp32" else torch.bfloat16
            q = torch.randn(b, hq, s, 64, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(b, hkv, s, 64, generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            q, k, v, scale, _, kv_len = attention._prepare(
                q, k, v, causal, None, tile, None, None, window, sinks)
            kw = dict(causal=causal, sm_scale=scale, kv_len=kv_len, tile_dtype=tile,
                      window=window, sinks=sinks)
            o_k, lse_k, err, lse_err, control_err = check(
                f"B1 {name} {kind}", fa2.fa2_forward_aligned, fa2.fa2_forward_plain,
                kw, kind, q, k, v, control=kind == "fp32" and name == WINDOW_B1_CASES[0][0])
            mask = band_mask(torch, common, q, k, kw)
            lib_in = [t.to(tile or torch.float32) for t in (q, k, v)]
            flops = 4 * b * hq * window_pairs(s, kv_len, causal, window, sinks) * 64
            moved = nbytes(q, k, v, o_k, lse_k)
            t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
            ms = time_ms(lambda: fa2.fa2_forward_aligned(q, k, v, **kw))
            row = dict(kernel="fa2_forward", case=name, kind=kind, B=b, Hq=hq, Hkv=hkv,
                       S=s, causal=causal, window=window, sinks=sinks,
                       max_abs_err=err, lse_rel_err=lse_err,
                       control_max_abs_err=control_err, ms=ms,
                       plain_ms=time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw),
                                        iters=2, warmup=1),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                           *lib_in, attn_mask=mask, scale=scale,
                           enable_gqa=hq != hkv), iters=5, warmup=1),
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes > t_ops else "operations",
                       tflops=flops / ms / 1e9)
            if s == 8192:
                gkw = dict(kw, window=None, sinks=0)
                row["global_causal_ms"] = time_ms(
                    lambda: fa2.fa2_forward_aligned(q, k, v, **gkw))
            rows.append(row)
            log("window B1", json.dumps(row))
            del q, k, v, o_k, lse_k, mask, lib_in

    # B8 at Edge-NonPowerOf2, window 32 with sinks 4.
    b, h, s = SUITE["Edge-NonPowerOf2"]
    raw = [torch.randn(b, h, s, 64, generator=gen, device="cuda") for _ in range(3)]
    for kind in ("fp32", "bf16"):
        tile = None if kind == "fp32" else torch.bfloat16
        q, k, v, scale, _, kv_len = attention._prepare(
            *raw, True, None, tile, None, None, 32, SINKS)
        if not attention._use_small_kernel(q, k):
            raise AssertionError("window B8: the route does not take B8")
        kw = dict(causal=True, sm_scale=scale, kv_len=kv_len, tile_dtype=tile,
                  window=32, sinks=SINKS)
        o_k, lse_k, err, lse_err, control_err = check(
            f"B8 Edge-NonPowerOf2 {kind}", fa2.fa2_forward_small_aligned,
            fa2.fa2_forward_small_plain, kw, kind, q, k, v, control=kind == "fp32")
        mask = band_mask(torch, common, q, k, kw)
        lib_in = [t.to(tile or torch.float32) for t in (q, k, v)]
        flops = 4 * b * h * window_pairs(s, kv_len, True, 32, SINKS) * 64
        moved = nbytes(q, k, v, o_k, lse_k)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
        row = dict(kernel="fa2_forward_small", case="Edge-NonPowerOf2", kind=kind,
                   B=b, H=h, S=s, causal=True, window=32, sinks=SINKS,
                   max_abs_err=err, lse_rel_err=lse_err,
                   control_max_abs_err=control_err,
                   ms=queued_ms(torch, lambda: fa2.fa2_forward_small_aligned(
                       q, k, v, **kw)),
                   plain_ms=queued_ms(torch, lambda: fa2.fa2_forward_small_plain(
                       q, k, v, **kw)),
                   library_ms=queued_ms(torch, lambda: F.scaled_dot_product_attention(
                       *lib_in, attn_mask=mask, scale=scale)),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations")
        rows.append(row)
        log("window B8", json.dumps(row))
    # B8's windowed launches on its main path, the public API.
    reset_counts(WINDOW_KERNELS)
    attention.flash_attention_with_lse(*raw, causal=True, window=32, sinks=SINKS)
    torch.cuda.synchronize()
    return rows, read_counts(WINDOW_KERNELS)["fa2_forward_small_window"]


def window_paged_bound(lengths, chunk, window, sinks, hq, hkv, d, elem, q, out,
                       kind, page=128):
    """paged_bound under a window: only the tokens some row keeps (the
    union of the rows' windows and the sinks) and their live pages move;
    4 * D FLOPs per (query head, row, kept column)."""
    tokens = flops = live_pages = 0
    for n in lengths:
        if n == 0:
            continue
        first = max(0, n - chunk - window + 1)
        s = min(sinks, n)
        tokens += (n - first) + min(s, first)
        live_pages += sum(1 for p in range(-(-n // page))
                          if (p + 1) * page > first or p * page < sinks)
        for t in range(chunk):
            pos = n - chunk + t
            if pos >= 0:
                flops += 4 * d * hq * kept_cols(pos, n, True, window, sinks)
    moved = (2 * tokens * hkv * (d * elem + 4) + nbytes(q, out) + live_pages * 4
             + 4 * len(lengths))
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations",
            flops, moved)


def stale_table(torch, table, lengths, chunk, window, sinks, page=128):
    """The table with every entry behind all rows' windows (and not a sink
    page) pointed at the next slot's page of the same index: pages the
    engine would have recycled to another slot."""
    out = table.clone()
    n = table.shape[0]
    for s, length in enumerate(lengths):
        first = max(0, length - chunk - window + 1)
        for p in range(table.shape[1]):
            if p * page < length and (p + 1) * page <= first and p * page >= sinks:
                out[s, p] = table[(s + 1) % n, p]
    return out


def phase_window_paged(torch, dec_attn, kv_cache):
    """B5 at phase 3's shapes and B6 at phase 12's T 5 and T 512 shapes,
    window 128 with sinks 4, against their plain versions; an off-by-one
    window as the control; the outputs bitwise unchanged when the entries
    behind the window name another slot's pages."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    hq, hkv, d, page, pps = 16, 8, 64, 128, 16
    cases = [("B5", 1, [2048, 1, 129, 0, 777, 1500, 128, 2000], cache, compute)
             for cache, compute in (("int8", "bf16"), ("int8", "fp32"), ("bf16", "bf16"))]
    cases += [("B6 T5", 5, B6_SPEC_LENGTHS, "int8", compute) for compute in ("bf16", "fp32")]
    cases += [("B6 T512", 512, B6_PREFILL_LENGTHS, "int8", compute)
              for compute in ("bf16", "fp32")]
    rows = []
    for name, chunk, lens, cache, compute in cases:
        n = len(lens)
        num_pages = n * pps + 1
        pages = random_pages(torch, kv_cache, gen, cache, (hkv, num_pages, page, d))
        table = (torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
                 ).reshape(n, pps).to(torch.int32).contiguous()
        stale = stale_table(torch, table, lens, chunk, WINDOW, SINKS).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cdt = torch.bfloat16 if compute == "bf16" else torch.float32
        scale = d ** -0.5
        if chunk == 1:
            q = torch.randn(n, hq, d, generator=gen, device="cuda").to(cdt)
            kernel_fn, plain_fn = (dec_attn.paged_decode_attention,
                                   dec_attn.paged_decode_attention_plain)
        else:
            q = torch.randn(n, chunk, hq, d, generator=gen, device="cuda").to(cdt)
            kernel_fn, plain_fn = (dec_attn.paged_chunk_attention,
                                   dec_attn.paged_chunk_attention_plain)
        kw = dict(sm_scale=scale, compute_dtype=cdt, window=WINDOW, sinks=SINKS)
        o_k = kernel_fn(q, pages, table, lengths, **kw)
        o_stale = kernel_fn(q, pages, stale, lengths, **kw)
        o_p = plain_fn(q, pages, table, lengths, **kw)
        o_c = plain_fn(q, pages, table, lengths, **dict(kw, window=WINDOW + 1))
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        control_err = (o_k.float() - o_c.float()).abs().max().item()
        tol = B5_TOL[compute]
        if not err <= tol:
            raise AssertionError(f"window {name} {cache} {compute}: max_abs_err {err} "
                                 f"(tol {tol})")
        if not torch.equal(o_k, o_stale):
            raise AssertionError(f"window {name}: an entry behind the window was read")
        if compute == "fp32" and control_err <= tol:
            raise AssertionError(f"window {name}: an off-by-one window passes the "
                                 f"gate ({control_err} <= {tol})")

        def kernel():
            return kernel_fn(q, pages, table, lengths, **kw)

        bound_ms, bound_by, flops, moved = window_paged_bound(
            lens, chunk, WINDOW, SINKS, hq, hkv, d, pages.k_pages.element_size(),
            q, o_k, compute)
        ms = queued_ms(torch, kernel)
        row = dict(kernel="paged_decode" if chunk == 1 else "paged_chunk", case=name,
                   T=chunk, lengths=lens, cache=cache, compute=compute,
                   window=WINDOW, sinks=SINKS, max_abs_err=err,
                   control_max_abs_err=control_err, stale_bitwise_equal=True,
                   ms=ms, b2b_ms=time_ms(kernel),
                   plain_ms=time_ms(lambda: plain_fn(q, pages, table, lengths, **kw),
                                    iters=2, warmup=1),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   gbps=moved / ms / 1e6, global_ms=queued_ms(
                       torch, lambda: kernel_fn(q, pages, table, lengths,
                                                sm_scale=scale, compute_dtype=cdt)))
        rows.append(row)
        log("window paged", json.dumps(row))
        del pages, o_k, o_stale, o_p, o_c
    return rows


WINDOW_KERNELS = ("fa2_forward_window", "fa2_forward_small_window",
                  "paged_decode_window", "paged_chunk_window")


def phase_window_serving(torch, np, transformer, decode, dataclasses):
    """The hybrid configuration (GPT-OSS's layer pattern: window 128 on every
    other layer, global_every 2) at base width on an int8 cache: phase 5's
    12 requests, four of them lengthened to 1024-1536 tokens, chunked
    prefill 512.  After every step no decoding slot's local group holds
    more than 2 pages (JAX's live bound in _worst_pages_for at window 128,
    page 128); each group's peak live pages; B1's, B5's and B6's windowed
    launches must be > 0."""
    cfg = dataclasses.replace(transformer.TransformerConfig.base(),
                              attn_window=WINDOW, global_every=2)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = serving_mix(np, cfg)
    rng = np.random.default_rng(25)
    for i, n in zip((0, 3, 6, 9), rng.integers(1024, 1537, 4)):
        prompts[i] = rng.integers(0, cfg.vocab_size, int(n)).tolist()
    new_tokens = 64
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                              page_size=128, cache_dtype=torch.int8,
                              prefill_chunk=512)
    bound = eng._worst_pages_for(1, 1 << 20)[0]
    peak_total, peak_slot = [0, 0], [0, 0]
    torch.cuda.synchronize()
    reset_counts(SERVING_KERNELS + WINDOW_KERNELS)
    t0 = time.perf_counter()
    reqs = eng.submit_many(prompts, max_new_tokens=new_tokens)
    while any(not r.done for r in reqs) or eng._pending:
        eng.step()
        for g in range(eng.n_groups):
            live = [eng._live_page_count(s, g) for s in range(eng.max_seqs)]
            peak_total[g] = max(peak_total[g], sum(live))
            peak_slot[g] = max(peak_slot[g], max(live))
            if g == 0 and any(live[s] > bound for s in np.flatnonzero(eng.active)):
                raise AssertionError(f"hybrid: a decoding slot's local group holds "
                                     f"{live} pages (bound {bound})")
    eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(SERVING_KERNELS + WINDOW_KERNELS)
    check_served("hybrid", reqs, eng, launches,
                 ("fa2_forward_window", "paged_decode_window", "paged_chunk_window"),
                 cfg.vocab_size, new_tokens)
    for a in eng._group_allocs:
        if a.available != eng.num_pages - 1:
            raise AssertionError("hybrid: a group's pages leaked")
    total = sum(len(r.generated) for r in reqs)
    res = dict(config="hybrid w128 global_every 2", requests=len(reqs),
               tokens=total, seconds=elapsed, tokens_per_s=total / elapsed,
               tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
               ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
               steps=eng.stats["steps"], prefill_chunks=eng.stats["prefill_chunks"],
               local_bound_pages=bound, peak_live_pages_local=peak_total[0],
               peak_live_pages_global=peak_total[1],
               peak_slot_pages_local=peak_slot[0], peak_slot_pages_global=peak_slot[1],
               prompt_lens=[len(p) for p in prompts], launches=launches)
    log("window hybrid serving", json.dumps(res))
    return res


def phase_window_streaming(torch, np, transformer, decode, dataclasses):
    """The streaming configuration (StreamingLLM: window 512 with 4 sink
    tokens on every layer) at base width in fp32, card against CPU, greedy
    tokens bitwise equal: engine decode, speculation (k 3, a one-layer
    windowed draft) and chunked prefill (chunk 512, a 1300-token prompt).
    The sink page must still be resident when each request ends."""
    cfg = dataclasses.replace(
        transformer.TransformerConfig.base(dtype=torch.float32, attn_tile_dtype=None),
        attn_window=512, attn_sinks=SINKS)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    rng = np.random.default_rng(27)
    short = rng.integers(0, cfg.vocab_size, 900).tolist()
    long = rng.integers(0, cfg.vocab_size, 1300).tolist()
    n_new = 12
    modes = {"decode": ([short], {}),
             "speculative": ([short], dict(spec_tokens=3, draft=True)),
             "chunked_prefill": ([long], dict(prefill_chunk=512))}
    out = {}
    for dev in ("cuda", "cpu"):
        p = transformer.tree_map(lambda w: w.to(dev), params)
        for mode, (prompts, kw) in modes.items():
            kw = dict(kw)
            if kw.pop("draft", False):
                kw.update(draft_params=draft_of(p),
                          draft_cfg=dataclasses.replace(cfg, n_layers=1))
            eng = decode.DecodeEngine(p, cfg, max_seqs=1, max_seq_len=2048,
                                      cache_dtype=torch.float32, device=dev, **kw)
            (req,) = eng.submit_many(prompts, max_new_tokens=n_new)
            sink_resident = True
            while not req.done:
                eng.step()
                pages = eng._slot_pages[0]
                sink_resident &= bool(pages) and pages[0] is not None
            recycled = sum(1 for x in eng._slot_pages[0] if x is None)
            eng.step()
            if not sink_resident or recycled == 0:
                raise AssertionError(f"streaming {mode} ({dev}): sink page resident "
                                     f"{sink_resident}, recycled pages {recycled}")
            out.setdefault(mode, {})[dev] = dict(tokens=req.generated,
                                                 recycled_pages=recycled,
                                                 stats=dict(eng.stats))
        del p
    for mode, r in out.items():
        r["equal"] = r["cuda"]["tokens"] == r["cpu"]["tokens"]
        if not r["equal"]:
            raise AssertionError(f"streaming {mode}: card tokens {r['cuda']['tokens']} "
                                 f"vs CPU {r['cpu']['tokens']}")
    log("window streaming fp32 base (card vs CPU)", json.dumps(
        {m: dict(equal=r["equal"], tokens=r["cuda"]["tokens"],
                 recycled_pages=r["cuda"]["recycled_pages"]) for m, r in out.items()}))
    return {m: r["equal"] for m, r in out.items()}


# Phase 26: training with windows, sinks and packed segments.  The
# backward rows (a): (name, B, Hq, Hkv, Sq, Skv, D, causal, window, sinks,
# tile kind); the train shape carries the hybrid's local-layer call (window
# 128, no sinks: the split pair), streaming's (window 512 with 4 sinks: the
# fused B2) and window 128 at D 128; the fp32 tiles at B1 S512; a band of
# offset -100 whose last rows keep no key; the reference tiles' dead rows
# (window 520, Sq 1500, Skv 700).
WINDOW_BWD_CASES = (
    ("train w128", 4, 16, 8, 2048, 2048, 64, True, 128, 0, "bf16"),
    ("train w512 s4", 4, 16, 8, 2048, 2048, 64, True, 512, 4, "bf16"),
    ("train D128 w128", 4, 16, 8, 2048, 2048, 128, True, 128, 0, "bf16"),
    ("fp32 B1 S512 w128 s4", 1, 16, 8, 512, 512, 64, True, 128, 4, "fp32"),
    ("band -100 B2 S1024", 2, 16, 8, 1024, 1024, 64, False, -100, 0, "bf16"),
    ("dead rows w520 Sq1500 Skv700", 1, 16, 8, 1500, 700, 64, True, 520, 0, "fp32"),
)
# The segmented rows (b): 4 documents a row at the train shape (bf16), 3 at
# B1 S512 in fp32.
SEGMENT_BWD_CASES = (
    ("train 4 documents", 4, 16, 8, 2048, 2048, 64, True, None, 0, "bf16", 4),
    ("fp32 B1 S512 3 documents", 1, 16, 8, 512, 512, 64, True, None, 0, "fp32", 3),
)
BWD_NAMES = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")
MASKED_KERNELS = tuple(f"{n}{tag}" for n in ("fa2_forward", "fa2_forward_small")
                       + BWD_NAMES for tag in ("", "_window", "_segments"))


def masked_problem(torch, F, common, attention, fa2, gen, kind, b, hq, hkv, sq,
                   skv, d, causal, window, sinks, ids=None):
    """Padded inputs on the card (random q, k, v, dO; O and lse from kernel
    B1, checked against its plain version on the way: the rows that keep a
    key by LSE_REL_TOL, the rows that keep none bit for bit), the
    wrappers' keyword arguments with the window, sinks and padded ids, the
    raw inputs, and B1's row: device time beside the same call's global
    time, the plain version's, SDPA with the mask as a boolean attn_mask and
    the bound over the kept pairs.  ids: (q ids, kv ids) [B, S] or None."""
    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    tile = tile_of(torch, kind)
    q, do = (torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    raw = (q, k, v, do)
    q_ids, kv_ids = ids if ids is not None else (None, None)
    window, sinks = attention._window_of(window, sinks, causal, q, k)
    q, k, v, scale, _, kv_len = attention._prepare(q, k, v, causal, None, tile,
                                                   q_ids, kv_ids, window, sinks)
    q_seg, kv_seg = attention._segments_of(q_ids, kv_ids, q, k)
    kw = dict(causal=causal, sm_scale=scale, kv_len=kv_len, tile_dtype=tile,
              window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = fa2.fa2_forward_aligned(q, k, v, **kw)
    o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
    fwd_err = (o.float() - o_p.float()).abs().max().item()
    lse_err, dead_equal = lse_gate(torch, lse, lse_p)
    if not (fwd_err <= B1_TOL[kind] and lse_err <= LSE_REL_TOL and dead_equal):
        raise AssertionError(f"masked B1 forward: max_abs_err {fwd_err}, lse rel "
                             f"err {lse_err}, dead rows equal {dead_equal}")
    del o_p, lse_p
    mask = common.build_element_mask(
        q.shape[2], k.shape[2], causal=causal, kv_len=kv_len, device="cuda",
        window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    lib_in = [t.to(tile or torch.float32) for t in (q, k, v)]
    flops = 4 * hq * masked_pairs(torch, common, kw, b, sq, skv) * d
    t_bytes = nbytes(q, k, v, o, lse) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    fwd_row = dict(
        fwd_ms=queued_ms(torch, lambda: fa2.fa2_forward_aligned(q, k, v, **kw),
                         iters=10),
        fwd_global_ms=queued_ms(torch, lambda: fa2.fa2_forward_aligned(
            q, k, v, **dict(kw, window=None, sinks=0, q_seg=None, kv_seg=None)),
            iters=10),
        fwd_plain_ms=time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw), iters=2,
                             warmup=1),
        fwd_library_ms=queued_ms(torch, lambda: F.scaled_dot_product_attention(
            *lib_in, attn_mask=mask, scale=scale, enable_gqa=hq != hkv), iters=5),
        fwd_bound_ms=max(t_bytes, t_ops) * 1e3,
        fwd_bound_by="bytes" if t_bytes > t_ops else "operations")
    del mask, lib_in
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - sq)).contiguous()
    di = (o.float() * do.float()).sum(-1)
    x = dict(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di)
    return x, kw, raw, dict(fwd_max_abs_err=fwd_err, fwd_lse_rel_err=lse_err,
                            dead_rows=int((lse < -1e30).sum().item()), **fwd_row)


def masked_pairs(torch, common, kw, b, sq, skv) -> int:
    """(query, key) pairs the call keeps over the unpadded rows, summed over
    the batch (the element mask of the plain versions)."""
    mask = common.build_element_mask(
        sq, skv, causal=kw["causal"], kv_len=kw["kv_len"], device="cuda",
        window=kw["window"], sinks=kw["sinks"],
        q_seg=None if kw["q_seg"] is None else kw["q_seg"][:, :sq],
        kv_seg=None if kw["kv_seg"] is None else kw["kv_seg"][:, :skv])
    if mask is None:
        return b * sq * skv
    return int(mask.expand(b, 1, sq, skv).sum().item())


def masked_bwd_rows(torch, fp32_bwd, common, bwd, x, kw, raw, kind, label,
                    control=None):
    """B2, B3 and B4 with a window, sinks or segment ids against their plain
    versions on one problem: the gate (BWD_TOL of each output's max), dQ of
    every row that keeps no key exactly 0, device time beside the same
    call's global time (no window, sinks or ids) on the same inputs, the
    bound over the kept pairs, the plain version's time and SDPA's masked
    backward (the mask as its bias; the function of B2 and of the pair).
    control: keyword arguments (a window one narrower, ids shifted by one
    token) whose plain outputs the kernel must miss by more than the gate;
    enforced in fp32, printed in bf16.  (A wider window would revive rows
    whose lse says they keep no key, and the control would read NaN.)"""
    q, k, v, o, do, lse, di = (x[n] for n in ("q", "k", "v", "o", "do", "lse", "di"))
    b, hq, sq, d = raw[0].shape
    skv = raw[1].shape[2]

    def by_batch(fn, chunk=2):
        outs = [fn(slice(lo, lo + chunk)) for lo in range(0, q.shape[0], chunk)]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def sliced(kw_, i):
        out = dict(kw_)
        for n in ("q_seg", "kv_seg"):
            if out[n] is not None:
                out[n] = out[n][i]
        return out

    def calls(kw_):
        return {
            "fa2_backward_fused": (
                lambda: bwd.fa2_backward_fused_aligned(q, k, v, o, do, lse, **kw_),
                lambda: by_batch(lambda i: bwd.fa2_backward_fused_plain(
                    q[i], k[i], v[i], o[i], do[i], lse[i], **sliced(kw_, i)))),
            "fa2_backward_dq": (
                lambda: (bwd.fa2_backward_dq_aligned(q, k, v, do, lse, di, **kw_),),
                lambda: by_batch(lambda i: (bwd.fa2_backward_dq_plain(
                    q[i], k[i], v[i], do[i], lse[i], di[i], **sliced(kw_, i)),))),
            "fa2_backward_dkv": (
                lambda: bwd.fa2_backward_dkv_aligned(q, k, v, do, lse, di, **kw_),
                lambda: by_batch(lambda i: bwd.fa2_backward_dkv_plain(
                    q[i], k[i], v[i], do[i], lse[i], di[i], **sliced(kw_, i)))),
        }

    masked, unmasked = calls(kw), calls(dict(kw, window=None, sinks=0, q_seg=None,
                                             kv_seg=None))
    ctrl = calls(dict(kw, **control)) if control else None
    lib_dtype = kw["tile_dtype"] or raw[0].dtype
    groups = hq // raw[1].shape[1]
    lq, lk, lv, ldo = (t.to(lib_dtype) for t in raw)
    lk, lv = (t.repeat_interleave(groups, dim=1) for t in (lk, lv))
    mask = common.build_element_mask(
        sq, skv, causal=kw["causal"], kv_len=skv, device="cuda",
        window=kw["window"], sinks=kw["sinks"],
        q_seg=None if kw["q_seg"] is None else kw["q_seg"][:, :sq],
        kv_seg=None if kw["kv_seg"] is None else kw["kv_seg"][:, :skv])
    lib_ms = queued_ms(torch, fp32_bwd.masked_backward(lq, lk, lv, ldo,
                                                       kw["sm_scale"], mask),
                       iters=5)
    del lq, lk, lv, ldo, mask
    pairs = masked_pairs(torch, common, kw, b, sq, skv)
    io = {"q": nbytes(raw[0]), "kv": nbytes(raw[1], raw[2]), "stat": b * hq * sq * 4}
    moved = {
        "fa2_backward_fused": 4 * io["q"] + 2 * io["kv"] + io["stat"],
        "fa2_backward_dq": 3 * io["q"] + io["kv"] + 2 * io["stat"],
        "fa2_backward_dkv": 2 * io["q"] + 2 * io["kv"] + 2 * io["stat"],
    }
    dead = lse[:, :, :sq] < -1e30
    rows = []
    for name in BWD_NAMES:
        kernel, plain = masked[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        abs_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(got, want))
        if not max(errs) <= BWD_TOL[kind]:
            raise AssertionError(f"{name} {label}: relative errors {errs} "
                                 f"(tol {BWD_TOL[kind]})")
        if name != "fa2_backward_dkv" and dead.any():
            if not bool((got[0][:, :, :sq][dead] == 0).all()):
                raise AssertionError(f"{name} {label}: a dead row's dQ is not 0")
        control_err = None
        if ctrl is not None:
            control_err = max(rel_err(g, w) for g, w in zip(got, ctrl[name][1]()))
            if kind == "fp32" and not control_err > BWD_TOL[kind]:
                raise AssertionError(f"{name} {label}: the control passes the gate "
                                     f"({control_err} <= {BWD_TOL[kind]})")
        del got, want
        ms = queued_ms(torch, kernel, iters=10)
        flops = BWD_MATMULS[name] * 2 * hq * pairs * d
        t_bytes, t_ops = moved[name] / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
        row = dict(kernel=name, case=label, kind=kind, B=b, Hq=hq, Hkv=raw[1].shape[1],
                   Sq=sq, Skv=skv, D=d, causal=kw["causal"], window=kw["window"],
                   sinks=kw["sinks"], segments=kw["q_seg"] is not None,
                   rel_err=max(errs), max_abs_err=abs_err,
                   control_rel_err=control_err, ms=ms,
                   global_ms=queued_ms(torch, unmasked[name][0], iters=10),
                   plain_ms=time_ms(plain, iters=2, warmup=1),
                   library_ms=lib_ms, library="SDPA memory-efficient backward, mask as bias",
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   kept_pairs=pairs, tflops=flops / ms / 1e9)
        rows.append(row)
        log("masked bwd", json.dumps(row))
    return rows


def phase_masked_kernels(torch, np, F, fp32_bwd, kernel_ab, attention, common,
                         fa2, bwd):
    """Phase 26 (a) and (b): the windowed and segmented B2, B3 and B4 rows
    (WINDOW_BWD_CASES, SEGMENT_BWD_CASES) with their controls; B8 with 2
    segments at Edge-NonPowerOf2 in fp32 and bf16 against its plain version
    (ids shifted by one token the control); a padded batch through the
    API on both routes (O, dK and dV exactly 0 on the pads); packing two
    documents against running each alone (ids shifted by one token must
    fail).  Returns (rows, the API's segmented launches)."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows, checks = [], {}
    for (label, b, hq, hkv, sq, skv, d, causal, window, sinks,
         kind) in WINDOW_BWD_CASES:
        x, kw, raw, fwd = masked_problem(torch, F, common, attention, fa2, gen,
                                         kind, b, hq, hkv, sq, skv, d, causal,
                                         window, sinks)
        rows += [dict(r, **fwd) for r in masked_bwd_rows(
            torch, fp32_bwd, common, bwd, x, kw, raw, kind, label,
            control=dict(window=kw["window"] - 1))]
        del x, raw
        torch.cuda.empty_cache()
    for (label, b, hq, hkv, sq, skv, d, causal, window, sinks, kind,
         n_docs) in SEGMENT_BWD_CASES:
        ids = kernel_ab.packed_ids(b, sq, n_docs, seed=sq).cuda()
        x, kw, raw, fwd = masked_problem(torch, F, common, attention, fa2, gen,
                                         kind, b, hq, hkv, sq, skv, d, causal,
                                         window, sinks, ids=(ids, ids))
        shifted = torch.roll(kw["q_seg"], 1, dims=1)
        rows += [dict(r, **fwd) for r in masked_bwd_rows(
            torch, fp32_bwd, common, bwd, x, kw, raw, kind, label,
            control=dict(q_seg=shifted, kv_seg=torch.roll(kw["kv_seg"], 1, dims=1)))]
        del x, raw
        torch.cuda.empty_cache()

    # B8 with 2 segments a slot row at Edge-NonPowerOf2.
    bb, h, s = SUITE["Edge-NonPowerOf2"]
    raw8 = [torch.randn(bb, h, s, 64, generator=gen, device="cuda") for _ in range(3)]
    ids8 = kernel_ab.packed_ids(bb, s, 2, seed=8).cuda()
    for kind in ("fp32", "bf16"):
        tile = tile_of(torch, kind)
        q, k, v, scale, _, kv_len = attention._prepare(*raw8, True, None, tile, ids8,
                                                       ids8, None, 0)
        if not attention._use_small_kernel(q, k):
            raise AssertionError("segmented B8: the route does not take B8")
        q_seg, kv_seg = attention._segments_of(ids8, ids8, q, k)
        kw = dict(causal=True, sm_scale=scale, kv_len=kv_len, tile_dtype=tile,
                  q_seg=q_seg, kv_seg=kv_seg)
        o_k, lse_k = fa2.fa2_forward_small_aligned(q, k, v, **kw)
        o_p, lse_p = fa2.fa2_forward_small_plain(q, k, v, **kw)
        o_c, _ = fa2.fa2_forward_small_plain(
            q, k, v, **dict(kw, q_seg=torch.roll(q_seg, 1, 1),
                            kv_seg=torch.roll(kv_seg, 1, 1)))
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)
        control_err = (o_k.float() - o_c.float()).abs().max().item()
        if not (err <= B1_TOL[kind] and lse_err <= LSE_REL_TOL and dead_equal
                and control_err > B1_TOL[kind]):
            raise AssertionError(f"segmented B8 {kind}: max_abs_err {err}, lse "
                                 f"{lse_err}, control {control_err}")
        lib_in = [t.to(tile or torch.float32) for t in (q, k, v)]
        mask = common.build_element_mask(q.shape[2], k.shape[2], causal=True,
                                         kv_len=kv_len, device="cuda",
                                         q_seg=q_seg, kv_seg=kv_seg)
        cells = bb * h * s
        flops = 4 * h * int(mask[:, :, :s, :s].expand(bb, 1, s, s).sum().item()) * 64
        t_bytes = nbytes(q, k, v, o_k, lse_k) / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[kind]
        row = dict(kernel="fa2_forward_small", case="Edge-NonPowerOf2 2 documents",
                   kind=kind, B=bb, H=h, S=s, max_abs_err=err, lse_rel_err=lse_err,
                   control_max_abs_err=control_err,
                   ms=queued_ms(torch, lambda: fa2.fa2_forward_small_aligned(q, k, v, **kw)),
                   plain_ms=queued_ms(torch, lambda: fa2.fa2_forward_small_plain(
                       q, k, v, **kw)),
                   library_ms=queued_ms(torch, lambda: F.scaled_dot_product_attention(
                       *lib_in, attn_mask=mask, scale=scale)),
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations", cells=cells)
        rows.append(row)
        log("segmented B8", json.dumps(row))

    # The API on the packed path: a padded batch on both routes, and packing
    # against each document alone.  Its segmented launches are the kernel
    # line's.
    reset_counts(MASKED_KERNELS)
    split = common.BlockSizes(*(128,) * 6)
    # 1280 padded rows: ten 128-row KV slices, so the 128-row blocks take
    # the split pair (more than the fused route's eight).
    real, pad = 1100, 180
    q_ids = torch.tensor([[0] * real + [-7] * pad] * 2, dtype=torch.int32, device="cuda")
    kv_ids = torch.tensor([[0] * real + [-8] * pad] * 2, dtype=torch.int32, device="cuda")
    base = [torch.randn(2, h_, real + pad, 64, generator=gen, device="cuda")
            .to(torch.bfloat16) for h_ in (16, 8, 8)]
    wgt = torch.randn(2, 16, real + pad, 64, generator=gen, device="cuda")
    for route, bs in (("fused", None), ("split", split)):
        ts = [t.clone().requires_grad_(True) for t in base]
        o = attention.flash_attention(*ts, causal=True, q_segment_ids=q_ids,
                                      kv_segment_ids=kv_ids,
                                      tile_dtype=torch.bfloat16, block_sizes=bs)
        dq, dk, dv = torch.autograd.grad((o.float() * wgt).sum(), ts)
        zero = all(bool((t[:, :, real:] == 0).all()) for t in (o, dk, dv, dq))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (o, dq, dk, dv))
        checks[f"padded batch {route}"] = dict(pads_zero=zero, finite=finite)
        if not (zero and finite):
            raise AssertionError(f"padded batch {route}: {checks}")
    # Packing: 2 rows of 2048 tokens, documents of 700 and 1348.
    s_p, cut = 2048, 700
    ids = torch.tensor([[0] * cut + [1] * (s_p - cut)] * 2, dtype=torch.int32,
                       device="cuda")
    pk = [torch.randn(2, h_, s_p, 64, generator=gen, device="cuda").to(torch.bfloat16)
          for h_ in (16, 8, 8)]
    wp = torch.randn(2, 16, s_p, 64, generator=gen, device="cuda")

    def grads(x, w_, q_seg=None, kv_seg=None):
        ts = [t.clone().requires_grad_(True) for t in x]
        o = attention.flash_attention(*ts, causal=True, q_segment_ids=q_seg,
                                      kv_segment_ids=kv_seg, tile_dtype=torch.bfloat16)
        return (o, *torch.autograd.grad((o.float() * w_).sum(), ts))

    packed = grads(pk, wp, ids, ids)
    alone = [grads([t[:, :, lo:hi] for t in pk], wp[:, :, lo:hi])
             for lo, hi in ((0, cut), (cut, s_p))]
    joined = [torch.cat(parts, dim=2) for parts in zip(*alone)]
    errs = [rel_err(a, b) for a, b in zip(packed, joined)]
    shifted = torch.roll(ids, 1, dims=1)
    control = [rel_err(a, b) for a, b in zip(grads(pk, wp, shifted, shifted), joined)]
    gates = [B1_TOL["bf16"]] + [BWD_TOL["bf16"]] * 3
    checks["packing"] = dict(rel_errs=errs, control_rel_errs=control)
    if not all(e <= g for e, g in zip(errs, gates)) or all(
            c <= g for c, g in zip(control, gates)):
        raise AssertionError(f"packing vs each document alone: {checks['packing']}")
    # B8's segmented launches on the API, as phase 25 counts its windowed ones.
    attention.flash_attention_with_lse(*raw8, causal=True, q_segment_ids=ids8,
                                       kv_segment_ids=ids8)
    torch.cuda.synchronize()
    launches = read_counts(MASKED_KERNELS)
    log("phase 26 checks", json.dumps(checks), "launches", json.dumps(launches))
    return rows, checks, launches


def phase_window_train(torch, np, transformer, training, dataclasses):
    """Phase 26 (c): the hybrid (window 128, global_every 2: GPT-OSS's
    pattern) and streaming (window 512, 4 sinks on every layer) base
    configurations train 5 AdamW steps each on one batch of B4 S2048 bf16:
    a finite, falling loss; step time (median of the last 3), tokens/s,
    peak memory; launches (hybrid: B3 and B4 windowed, B2 on the global
    layers; streaming: B2 windowed, no split launch)."""
    b, s = 4, 2048
    tokens = np.random.default_rng(26).integers(0, 32768, (b, s + 1))
    out = {}
    for name, kw in (("hybrid", dict(attn_window=128, global_every=2)),
                     ("streaming", dict(attn_window=512, attn_sinks=4))):
        cfg = dataclasses.replace(transformer.TransformerConfig.base(), **kw)
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=100)
        step = training.make_optax_train_step(cfg, opt)
        state = training.init_train_state(params, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(MASKED_KERNELS)
        losses, times = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            state, metrics = step(state, tokens)
            losses.append(metrics["loss"].item())
            times.append(time.perf_counter() - t0)
        launches = read_counts(MASKED_KERNELS)
        median = statistics.median(times[-3:])
        res = dict(config=name, batch=b, seq=s, losses=losses,
                   step_ms=[t * 1e3 for t in times], step_ms_median=median * 1e3,
                   tokens_per_s=b * s / median,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={n: c for n, c in launches.items() if c})
        log("window train", json.dumps(res))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"window train {name}: loss not finite and falling")
        if name == "hybrid":
            ok = (launches["fa2_backward_dq_window"] and launches["fa2_backward_dkv_window"]
                  and launches["fa2_backward_fused"] > launches["fa2_backward_fused_window"])
        else:
            ok = (launches["fa2_backward_fused_window"] and not launches["fa2_backward_dq"]
                  and not launches["fa2_backward_dkv"])
        if not ok:
            raise AssertionError(f"window train {name}: launches {launches}")
        out[name] = res
        del state, step, params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    import cuda_flash_attention_tpu_torch.decode as decode
    from cuda_flash_attention_tpu_torch.decode import attention as dec_attn
    from cuda_flash_attention_tpu_torch.decode import kv_cache
    from cuda_flash_attention_tpu_torch import cli
    from cuda_flash_attention_tpu_torch.bench import (
        configs,
        decode_bench,
        harness,
        train_bench,
    )
    from cuda_flash_attention_tpu_torch.kernels import _build, attention, common
    from cuda_flash_attention_tpu_torch.kernels import baselines as base
    from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
    from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
    from cuda_flash_attention_tpu_torch import quant
    from cuda_flash_attention_tpu_torch.models import lora, training, transformer
    from cuda_flash_attention_tpu_torch.ops import reference
    from cuda_flash_attention_tpu_torch.scripts import b1_ab, fp32_bwd, kernel_ab
    from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5
    from cuda_flash_attention_tpu_torch.utils import io

    # fp32 means fp32: no TF32 in the plain versions' matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build_logs = _build.build("fa2_forward", "paged_decode", "fa2_backward",
                              "paged_chunk", "fa2_forward_small", "baselines",
                              "fa2_forward_quant", "r5_d128_fwd")
    log(f"phase 1: built {sorted(build_logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "Performance")):
                log(f"  ptxas {name}: {line.strip()}")
    bwd_log = build_logs.get("fa2_backward") or ptxas_log(_build, "fa2_backward")
    for label, (functions, count) in BWD_FUNCTIONS.items():
        check_ptxas(bwd_log, label, functions, count)
    for name, (functions, count) in FP32_FUNCTIONS.items():
        text = bwd_log if name == "fa2_backward" else (
            build_logs.get(name) or ptxas_log(_build, name))
        check_ptxas(text, "fp32 block", functions, count)
    check_ptxas(build_logs.get("paged_decode") or ptxas_log(_build, "paged_decode"),
                "B5", *B5_FUNCTIONS)
    check_ptxas(build_logs.get("paged_chunk") or ptxas_log(_build, "paged_chunk"),
                "B6", *B6_FUNCTIONS)
    check_ptxas(build_logs.get("r5_d128_fwd") or ptxas_log(_build, "r5_d128_fwd"),
                "X", *X_FUNCTIONS)
    check_ptxas(build_logs.get("fa2_forward_quant")
                or ptxas_log(_build, "fa2_forward_quant"), "B7", *B7_FUNCTIONS)

    t0 = time.perf_counter()
    b1 = phase_b1(torch, fa2, b1_ab)
    log(f"phase 2: B1 ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b5 = phase_b5(torch, dec_attn, kv_cache)
    log(f"phase 3: B5 ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e2e = phase_e2e(torch, np, transformer, decode)
    log(f"phase 4: e2e parity ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve, eng = phase_serving(torch, np, transformer, decode)
    log(f"phase 5: serving ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_profile = phase_profile(torch, np, eng)
    log(f"phase 6: profile ok in {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bwd_rows = phase_bwd(torch, fp32_bwd, attention, fa2, bwd)
    autograd = phase_autograd(torch, attention, bwd, BlockSizes)
    log(f"phase 7: B2/B3/B4 and autograd ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity = phase_train_parity(torch, np, transformer, training)
    log(f"phase 8: train parity ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train, remat, (state, step, tokens) = phase_train(
        torch, np, transformer, training, dataclasses)
    log(f"phase 9: training ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_profile(torch, state, step, tokens)
    del state, step
    torch.cuda.empty_cache()
    log(f"phase 10: train profile ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split = phase_train_split(torch, np, transformer, training)
    log(f"phase 11: split-route training ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b6 = phase_b6(torch, dec_attn, kv_cache)
    log(f"phase 12: B6 ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spec_parity = phase_spec_parity(torch, np, transformer, decode, dataclasses)
    log(f"phase 13: speculative, prefix and chunked parity ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = phase_spec_serving(torch, np, transformer, decode, dataclasses)
    log(f"phase 14: speculative serving ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix = phase_prefix_chunked(torch, np, transformer, decode)
    log(f"phase 15: prefix caching and chunked prefill ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b8 = phase_b8(torch, F, attention, fa2)
    baseline_rows = phase_baselines(torch, F, base, fa2)
    b1_fp16, bwd_fp16 = phase_fp16_tiles(torch, F, fp32_bwd, attention, fa2, bwd)
    log(f"phase 16: B8, B9, B10, B1 fp32 and fp16 tiles ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # Every kernel's launches on the reference-contract path: the CLI (this
    # process's runs) and the harness.  B1 runs fa2 at S > 128, B2 bf16/fp16
    # backward at Stress-1, B3 + B4 fp32 backward there (split route).
    contract_kernels = TRAIN_KERNELS + ("fa2_forward_small", "fa1", "naive_fa2")
    reset_counts(contract_kernels)
    t0 = time.perf_counter()
    phase_cli(torch, np, cli, io, reference, str(_build.BUILD_DIR.parent))
    log(f"phase 17: CLI ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_harness(harness, configs)
    contract_launches = read_counts(contract_kernels)
    log(f"phase 18: harness ok in {time.perf_counter() - t0:.1f} s; launches "
        f"in phases 17-18: {json.dumps(contract_launches)}")
    if not all(contract_launches.values()):
        raise AssertionError(f"phases 17-18: a kernel never ran: {contract_launches}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b7_checks, b7, b7_fp32, b7_launches = phase_b7(torch, F, quant, fq, fa2)
    log(f"phase 19: B7 ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paged_quant = phase_paged_quant(torch, dec_attn, kv_cache)
    log(f"phase 20: B5/B6 on fp8 and int4 pages ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quant_serve = phase_quant_serving(torch, np, transformer, decode, quant)
    log(f"phase 21: quantized serving ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qlora = phase_qlora(torch, np, transformer, training, lora, quant)
    log(f"phase 22: QLoRA ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x_rows, x_launches = phase_x(torch, r5)
    log(f"phase 23: X ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = phase_bench(torch, np, transformer, decode, decode_bench, train_bench,
                        serve_profile, "bench profile (burst 1, phase 6)")
    log(f"phase 24: serving and training benchmarks ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    win_fwd, b8_window_launches = phase_window_forward(torch, F, attention, fa2,
                                                       common)
    win_paged = phase_window_paged(torch, dec_attn, kv_cache)
    hybrid = phase_window_serving(torch, np, transformer, decode, dataclasses)
    torch.cuda.empty_cache()
    streaming = phase_window_streaming(torch, np, transformer, decode, dataclasses)
    log(f"phase 25: windows and sinks ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    masked_rows, masked_checks, masked_launches = phase_masked_kernels(
        torch, np, F, fp32_bwd, kernel_ab, attention, common, fa2, bwd)
    torch.cuda.empty_cache()
    window_train = phase_window_train(torch, np, transformer, training, dataclasses)
    window_parity = {
        name: phase_train_parity(torch, np, transformer, training, label=name,
                                 tokens_shape=(2, 257), **kw)
        for name, kw in (("hybrid w64", dict(attn_window=64, global_every=2)),
                         ("streaming w96 s4", dict(attn_window=96, attn_sinks=4)))}
    log(f"phase 26: windowed and packed training ok in "
        f"{time.perf_counter() - t0:.1f} s")

    # Representative shapes for the kernel line: the serving phase's largest
    # prefill (B4 S1536 bf16) and the int8 cache with bf16 compute.
    r1 = next(r for r in b1 if r["case"] == "B4 S1536")
    r1_train = next(r for r in b1 if r["case"] == "train")
    log("B1 serving (B4 S1536) and training (B4 S2048) shapes:",
        json.dumps({"S1536": r1, "S2048": r1_train}))
    r5 = next(r for r in b5 if (r["cache"], r["compute"]) == ("int8", "bf16"))
    kernels = [
        dict(name="fa2_forward", route="cuda",
             source="cuda_flash_attention_tpu_torch/csrc/fa2_forward.cu",
             replaces="cuda_flash_attention_tpu/kernels/fa2_forward.py:613",
             launches=serve["launches"]["fa2_forward"],
             max_abs_err=max(r["max_abs_err"] for r in b1 if r["kind"] != "fp32"),
             ms=r1["ms"], plain_ms=r1["plain_ms"], bound_ms=r1["bound_ms"],
             bound_by=r1["bound_by"], library_ms=r1["library_ms"]),
        dict(name="paged_decode", route="cuda",
             source="cuda_flash_attention_tpu_torch/csrc/paged_decode.cu",
             replaces="cuda_flash_attention_tpu/decode/attention.py:161",
             launches=serve["launches"]["paged_decode"],
             max_abs_err=max(r["max_abs_err"] for r in b5 if r["compute"] == "bf16"),
             ms=r5["ms"], b2b_ms=r5["b2b_ms"], plain_ms=r5["plain_ms"],
             bound_ms=r5["bound_ms"], bound_by=r5["bound_by"], library_ms=None),
    ]
    # Backward rows at the train shape (B4 S2048 bf16), where the fused and
    # split routes are compared; phase 7 also holds B3 and B4 at B16 S2048.
    # B2's launches come from the base training run (its route); B3's and
    # B4's from the B16 run, which takes the split route.  The flash
    # backward computes B2's function, and the pair B3 + B4's: B3's and
    # B4's rows carry it as the pair's yardstick (`library_of`).
    for name, replaces, launches in (
            ("fa2_backward_fused", 529, train["launches"]["fa2_backward_fused"]),
            ("fa2_backward_dq", 675, split["launches"]["fa2_backward_dq"]),
            ("fa2_backward_dkv", 386, split["launches"]["fa2_backward_dkv"])):
        r = next(r for r in bwd_rows if (r["kernel"], r["kind"], r["B"], r["S"],
                                         r["D"]) == (name, "bf16", 4, 2048, 64))
        kernels.append(dict(
            name=name, route="cuda",
            source="cuda_flash_attention_tpu_torch/csrc/fa2_backward.cu",
            replaces=f"cuda_flash_attention_tpu/kernels/fa2_backward.py:{replaces}",
            launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in bwd_rows
                            if x["kernel"] == name and x["kind"] == "bf16"),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name != "fa2_backward_fused":
            kernels[-1]["library_of"] = "fa2_backward_dq + fa2_backward_dkv"
        # The fp32 body on the harness's route (B2 at Large-2, B3 and B4 at
        # Stress-1), beside SDPA's memory-efficient backward.
        r = next(r for r in bwd_rows if r["kernel"] == name and "config" in r)
        kernels[-1]["fp32"] = {k: r[k] for k in (
            "config", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
    # B6 at the speculation shape (int8 cache, bf16 compute); its launches
    # from the speculative, prefix-cache and chunked-prefill runs.
    r6 = next(r for r in b6 if (r["shape"], r["cache"], r["compute"])
              == ("spec", "int8", "bf16"))
    r6_prefill = next(r for r in b6
                      if (r["shape"], r["compute"]) == ("prefill", "bf16"))
    r6_fp32 = next(r for r in b6 if (r["shape"], r["compute"]) == ("prefill", "fp32"))
    log("B6 speculation (T5) and chunked-prefill (T512) shapes:",
        json.dumps({"T5": r6, "T512": r6_prefill}))
    kernels.append(dict(
        name="paged_chunk", route="cuda",
        source="cuda_flash_attention_tpu_torch/csrc/paged_chunk.cu",
        replaces="cuda_flash_attention_tpu/decode/attention.py:365",
        launches=sum(run["launches"]["paged_chunk"] for run in (
            spec["draft"], spec["prompt_lookup"], prefix["prefix_cache"],
            prefix["chunked_prefill"])),
        max_abs_err=max(r["max_abs_err"] for r in b6 if r["compute"] == "bf16"),
        ms=r6["ms"], plain_ms=r6["plain_ms"], bound_ms=r6["bound_ms"],
        bound_by=r6["bound_by"], library_ms=None,
        fp32_tile={"T": 512, "launches": spec_parity["fp32_tile_launches"],
                   **{k: r6_fp32[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "max_abs_err")}}))
    # B8 at the suite's Edge-NonPowerOf2 config in fp32 (the harness's
    # precision), beside B1 on the same inputs; B9 and B10 at Stress-1.
    r8 = next(r for r in b8 if (r["config"], r["kind"], r["causal"])
              == ("Edge-NonPowerOf2", "fp32", False))
    log("B8 against B1 on the same padded inputs (device ms):", json.dumps(
        [{k: r[k] for k in ("config", "kind", "causal", "ms", "b1_ms")}
         for r in b8]))
    kernels.append(dict(
        name="fa2_forward_small", route="cuda",
        source="cuda_flash_attention_tpu_torch/csrc/fa2_forward_small.cu",
        replaces="cuda_flash_attention_tpu/kernels/fa2_forward.py:510",
        launches=contract_launches["fa2_forward_small"],
        max_abs_err=max(r["max_abs_err"] for r in b8 if r["kind"] == "fp32"),
        ms=r8["ms"], b1_ms=r8["b1_ms"], plain_ms=r8["plain_ms"],
        bound_ms=r8["bound_ms"], bound_by=r8["bound_by"],
        library_ms=r8["library_ms"]))
    for name, line in (("fa1", 110), ("naive_fa2", 230)):
        r = next(r for r in baseline_rows
                 if (r["kernel"], r["config"]) == (name, "Stress-1"))
        kernels.append(dict(
            name=name, route="cuda",
            source="cuda_flash_attention_tpu_torch/csrc/baselines.cu",
            replaces=f"cuda_flash_attention_tpu/kernels/baselines.py:{line}",
            launches=contract_launches[name],
            max_abs_err=max(x["max_abs_err"] for x in baseline_rows
                            if x["kernel"] == name),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    # B7 at the base model's attention shape (int8 K/V, bf16); its launches
    # from the public API's run.  X's v0 (the shipped rowsum) with every
    # variant's time beside it.
    r7 = next(r for r in b7 if (r["shape"], r["storage"]) == ("base", "int8"))
    log("B7 timed rows (base B4 S2048, long B1 S8192):", json.dumps(b7))
    kernels.append(dict(
        name="fa2_forward_quant", route="cuda",
        source="cuda_flash_attention_tpu_torch/csrc/fa2_forward_quant.cu",
        replaces="cuda_flash_attention_tpu/kernels/fa2_forward_quant.py:163",
        launches=b7_launches,
        max_abs_err=max(c["max_abs_err"] for c in b7_checks if c["kind"] == "bf16"),
        ms=r7["ms"], plain_ms=r7["plain_ms"], bound_ms=r7["bound_ms"],
        bound_by=r7["bound_by"], library_ms=None,
        b1_dequant_ms=r7["b1_dequant_ms"], sdpa_dequant_ms=r7["sdpa_dequant_ms"],
        fp32={k: b7_fp32[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                      "b1_fp32_dequant_ms")}))
    rx = x_rows[0]
    kernels.append(dict(
        name="r5_d128_fwd", route="cuda",
        source="cuda_flash_attention_tpu_torch/csrc/r5_d128_fwd.cu",
        replaces="scripts/r5_d128_fwd.py:105", launches=x_launches,
        max_abs_err=max(r["max_abs_err"] for r in x_rows),
        ms=rx["ms"], plain_ms=rx["plain_ms"], bound_ms=rx["bound_ms"],
        bound_by=rx["bound_by"], library_ms=rx["library_ms"], b1_ms=rx["b1_ms"],
        variants_ms={r["variant"]: r["ms"] for r in x_rows}))
    # B1, B5 and B2 on the benchmarks' paths (phase 24: the device loop,
    # the engines, phase 5's requests at bursts 1 and 8, the train chain).
    bench_launches = {"fa2_forward": 0, "paged_decode": 0, "fa2_backward_fused": 0}
    for run in bench.values():
        for name, n in (run.get("launches", {}) if isinstance(run, dict) else {}).items():
            if name in bench_launches:
                bench_launches[name] += n
    for k in kernels:
        if k["name"] in bench_launches:
            k["launches_bench"] = bench_launches[k["name"]]
    # B5 and B6 also ran the quantized serving path (phase 21).
    for k in kernels:
        if k["name"] in ("fa2_forward", "paged_decode", "paged_chunk"):
            k["launches_quant_serving"] = sum(
                r["launches"][k["name"]] for n, r in quant_serve.items()
                if "launches" in r)
    # Phase 25: each windowed kernel's row (window 128 with sinks 4 where
    # the kernel serves: B1 at the hybrid's largest prefill, B5 and B6 at
    # the int8 / bf16-compute rows, B8 at Edge-NonPowerOf2 fp32) and its
    # windowed launches on the main path (the hybrid serving run; B8's the
    # public API's).
    def window_row(rows, **match):
        r = next(r for r in rows if all(r[k] == v for k, v in match.items()))
        return {k: r[k] for k in ("case", "kind" if "kind" in r else "compute",
                                  "window", "sinks", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "max_abs_err",
                                  "control_max_abs_err")}
    window_of = {
        "fa2_forward": dict(window_row(win_fwd, case="B4 S1536 w128 s4", kind="bf16"),
                            launches=hybrid["launches"]["fa2_forward_window"]),
        "fa2_forward_small": dict(window_row(win_fwd, kernel="fa2_forward_small",
                                             kind="fp32"),
                                  launches=b8_window_launches),
        "paged_decode": dict(window_row(win_paged, case="B5", cache="int8",
                                        compute="bf16"),
                             launches=hybrid["launches"]["paged_decode_window"]),
        "paged_chunk": dict(window_row(win_paged, case="B6 T5", compute="bf16"),
                            launches=hybrid["launches"]["paged_chunk_window"],
                            T512=window_row(win_paged, case="B6 T512",
                                            compute="bf16")),
    }
    for k in kernels:
        if k["name"] in window_of:
            k["window"] = window_of[k["name"]]
    # Phase 26: the backward kernels' windowed rows (B2 at streaming's call,
    # B3 and B4 at the hybrid's local-layer call) and segmented rows (4
    # documents at the train shape), B8's segmented row; launches with a
    # window on the windowed training runs (c), with segment ids on the
    # packed path's API calls (b).
    def masked_row(kernel, case):
        r = next(r for r in masked_rows if (r["kernel"], r["case"]) == (kernel, case))
        return {k: r[k] for k in ("case", "kind", "window", "sinks", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms", "max_abs_err")
                if k in r} | {k: r[k] for k in ("global_ms", "control_rel_err",
                                                "control_max_abs_err") if k in r}
    train_window = {n: sum(run["launches"].get(f"{n}_window", 0)
                           for run in window_train.values())
                    for n in ("fa2_forward",) + BWD_NAMES}
    for k in kernels:
        n = k["name"]
        if n in BWD_NAMES:
            k["window"] = dict(masked_row(n, "train w512 s4" if n == BWD_NAMES[0]
                                          else "train w128"),
                               launches=train_window[n])
            k["segments"] = dict(masked_row(n, "train 4 documents"),
                                 launches=masked_launches[f"{n}_segments"])
        if n == "fa2_forward_small":
            k["segments"] = dict(masked_row(n, "Edge-NonPowerOf2 2 documents"),
                                 launches=masked_launches[f"{n}_segments"])
        if n == "fa2_forward":  # B1's row of phase 26's segmented train shape
            r = next(r for r in masked_rows if r["case"] == "train 4 documents")
            k["segments"] = dict(
                case=r["case"], kind=r["kind"], ms=r["fwd_ms"],
                global_ms=r["fwd_global_ms"], plain_ms=r["fwd_plain_ms"],
                bound_ms=r["fwd_bound_ms"], bound_by=r["fwd_bound_by"],
                library_ms=r["fwd_library_ms"], max_abs_err=r["fwd_max_abs_err"],
                launches=masked_launches[f"{n}_segments"])
        if n in ("fa2_forward", "fa2_forward_small") + BWD_NAMES:
            k["launches_window"] = (train_window[n] if n in train_window
                                    else b8_window_launches)
            k["launches_segments"] = masked_launches[f"{n}_segments"]
    if not all(k["launches_segments"] and k["launches_window"] for k in kernels
               if "launches_segments" in k):
        raise AssertionError("phase 26: a windowed or segmented kernel never ran "
                             "on its path")
    if not all(w["launches"] for w in window_of.values()):
        raise AssertionError(f"phase 25: a windowed kernel never ran on its path: "
                             f"{ {n: w['launches'] for n, w in window_of.items()} }")
    log("fp16 tiles:", json.dumps({"B1 Stress-1": b1_fp16, "B2-B4": [
        {k: r[k] for k in ("kernel", "inputs", "B", "S", "causal", "ms",
                           "bound_ms", "library_ms", "rel_err")} for r in bwd_fp16]}))
    log(json.dumps({"e2e_logit_diff": e2e, "train_parity": parity,
                    "autograd": autograd, "remat": remat,
                    "spec_parity": spec_parity, "qlora": qlora,
                    "window_streaming_equal": streaming,
                    "window_train_parity": window_parity,
                    "window_train": {n: {k: r[k] for k in (
                        "losses", "step_ms_median", "tokens_per_s",
                        "max_memory_allocated_gib")} for n, r in window_train.items()},
                    "bench": {k: bench[k] for k in ("greedy_bitwise_equal",)},
                    "paged_quant_rows": len(paged_quant)}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
