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
     tensor cores) and bf16 tile body (24) and of X's five variants,
     failing on a spilled byte, a wgmma serialisation note or a missing
     instantiation;
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
  9. training TransformerConfig.base() (bf16) at B4 S2048: 2 warm-up and 5
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
     the card's plain greedy tokens;
 14. speculative serving at TransformerConfig.base() with an int8 cache:
     phase 5's 12 requests with k 4, a one-layer draft and prompt lookup:
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
     (yardsticks, not the same function); the public quantized-KV API at
     both shapes, whose launches are B7's in the kernel line;
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
     its plain version.
The line before the last is the kernel JSON (eleven kernels); the last line
is the JSON contract line {"ok": true, "device": {...}}.
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
# kernels by source, with their instantiations: B10, B1's fp32 body (D 64
# and 128 each); the backward's bwd_kv_fp32 (D 64 and 128 x FUSED),
# bwd_dq_fp32 and the fp32 prologue (D 64 and 128 each).
BWD_FUNCTIONS = {"B2": ((r"bwd_fused_wgmma\w*Lb1E", r"bwd_prologueI(?!ffL)", "dq_reduce"), 18),
                 "B3": (("bwd_dq_wgmma",), 8),
                 "B4": ((r"bwd_fused_wgmma\w*Lb0E",), 8)}
FP32_FUNCTIONS = {"baselines": (("naive_fa2_fp32",), 2),
                  "fa2_forward": (("fa2_fwd_fp32",), 2),
                  "fa2_forward_small": (("small_fp32",), 2),
                  "fa2_backward": (("bwd_kv_fp32", "bwd_dq_fp32", "bwd_prologueIffL"), 8)}
# B5's split-KV kernel: 6 cache types x 2 q types x D 64 and 128 x groups
# of at most 2 and 8.
B5_FUNCTIONS = (("paged_decode_kernel",), 48)
# B6's split-KV body (6 cache types x 2 q types x D 64 and 128 x fp32
# compute on the FMA units and bf16 compute on the tensor cores) and its
# bf16 tile body (6 x 2 x 2); X's five variants.
B6_FUNCTIONS = (("paged_chunk_split", "paged_chunk_mma"), 72)
X_FUNCTIONS = (("r5_fwd",), 5)


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


def phase_serving(torch, np, transformer, decode, fa2, dec_attn):
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
    reset_serving_launches(fa2, dec_attn)
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_serving_launches(fa2, dec_attn)
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


def reset_serving_launches(fa2, dec_attn):
    fa2.launches = dec_attn.launches = dec_attn.chunk_launches = 0


def read_serving_launches(fa2, dec_attn) -> dict:
    return {"fa2_forward": fa2.launches, "paged_decode": dec_attn.launches,
            "paged_chunk": dec_attn.chunk_launches}


def phase_profile(torch, np, eng, label="profile"):
    """Where a decode step's time goes: eight running requests, ten steps
    (speculative rounds, for a speculative engine) under torch.profiler,
    timed on the host clock over the same window (so the step time includes
    the profiler's own host overhead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1501, eng.max_seqs)]
    reqs = eng.submit_many(prompts, max_new_tokens=40)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 10 * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 10 / 1e3
    if not busy_ms > 0:
        raise AssertionError("profile: no device time recorded")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # B5's and B6's kernels (csrc/paged_decode.cu, csrc/paged_chunk.cu) and
    # their shares of the busy time.
    b5_ms, b6_ms = (sum(e.self_device_time_total for e in kernels if name in e.key)
                    / 10 / 1e3 for name in ("paged_decode_kernel", "paged_chunk_"))
    res = dict(
        batch=len(reqs), decode_step_ms=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        kernel_launches_per_step=sum(e.count for e in kernels) / 10,
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
        before = (bwd.fused_launches, bwd.dq_launches, bwd.dkv_launches)
        for _ in range(2):
            ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = attention.flash_attention(*ts, block_sizes=bs, **kw)
            runs.append(torch.autograd.grad(out, ts, do))
        torch.cuda.synchronize()
        moved = (bwd.fused_launches - before[0], bwd.dq_launches - before[1],
                 bwd.dkv_launches - before[2])
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


def phase_train_parity(torch, np, transformer, training):
    """One AdamW step at the base width in fp32: card (kernels) against CPU
    (plain versions).  The first Adam moment is (1 - b1) times the clipped
    gradient, so it holds each gradient leaf to the tolerance; the global
    gradient norm, taken before clipping, is held on its own."""
    cfg = transformer.TransformerConfig.base(dtype=torch.float32,
                                             attn_tile_dtype=None)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 129))
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
    log("train parity fp32 base", json.dumps(res))
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


def reset_launches(fa2, bwd):
    fa2.launches = 0
    bwd.fused_launches = bwd.dq_launches = bwd.dkv_launches = 0


def read_launches(fa2, bwd) -> dict:
    return {"fa2_forward": fa2.launches, "fa2_backward_fused": bwd.fused_launches,
            "fa2_backward_dq": bwd.dq_launches, "fa2_backward_dkv": bwd.dkv_launches}


def phase_train(torch, np, transformer, training, fa2, bwd, dataclasses):
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
    reset_launches(fa2, bwd)
    for i in range(7):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_launches(fa2, bwd)
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
    reset_launches(fa2, bwd)
    t0 = time.perf_counter()
    _, m = step_remat(state, tokens)
    remat = dict(loss=m["loss"].item(), step_ms=(time.perf_counter() - t0) * 1e3,
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=read_launches(fa2, bwd))
    log("train remat=full", json.dumps(remat))
    if remat["launches"]["fa2_forward"] != 2 * cfg.n_layers:
        raise AssertionError(f"remat: B1 launches {remat['launches']}")
    return res, remat, (state, step, tokens)


def phase_train_split(torch, np, transformer, training, fa2, bwd):
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
    reset_launches(fa2, bwd)
    losses, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = read_launches(fa2, bwd)
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
    the card's plain greedy tokens."""
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
    if not (res["chunked_prefill"]["stats"]["prefill_chunks"] >= 3
            and res["speculative"]["stats"]["spec_rounds"] > 0):
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


def phase_spec_serving(torch, np, transformer, decode, fa2, dec_attn, dataclasses):
    """Speculative serving at base width, int8 cache: phase 5's 12 requests
    with k = 4, by a one-layer draft and by prompt lookup."""
    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = serving_mix(np, cfg)
    new_tokens = 64
    out = {}
    for mode in ("draft", "prompt_lookup"):
        kw = (dict(draft_params=draft_of(params),
                   draft_cfg=dataclasses.replace(cfg, n_layers=1))
              if mode == "draft" else dict(spec_mode="prompt_lookup"))
        eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                                  cache_dtype=torch.int8, spec_tokens=4, **kw)
        torch.cuda.synchronize()
        reset_serving_launches(fa2, dec_attn)
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_serving_launches(fa2, dec_attn)
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


def phase_prefix_chunked(torch, np, transformer, decode, fa2, dec_attn):
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
        reset_serving_launches(fa2, dec_attn)
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
        launches = read_serving_launches(fa2, dec_attn)
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
    reset_serving_launches(fa2, dec_attn)
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
    launches = read_serving_launches(fa2, dec_attn)
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
                                 iters=2, warmup=1),
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
    # The public API on the timed inputs: its launches are the path's.
    fq.launches = 0
    for (q, k_q, v_q), o_k in api_inputs:
        o = fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True)
        if not torch.equal(o, o_k[:, :, :q.shape[2]]):
            raise AssertionError("B7: the public API differs from the aligned kernel")
    api_launches = fq.launches
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
    return checks, rows, api_launches


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


def phase_quant_serving(torch, np, transformer, decode, quant, fa2, dec_attn):
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
        reset_serving_launches(fa2, dec_attn)
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_serving_launches(fa2, dec_attn)
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


def phase_qlora(torch, np, transformer, training, lora, quant, fa2, bwd):
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
    reset_launches(fa2, bwd)
    losses, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = read_launches(fa2, bwd)
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
    r5.launches = 0
    rows = r5.main([])
    launches = r5.launches
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
    from cuda_flash_attention_tpu_torch.bench import configs, harness
    from cuda_flash_attention_tpu_torch.kernels import _build, attention
    from cuda_flash_attention_tpu_torch.kernels import baselines as base
    from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
    from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
    from cuda_flash_attention_tpu_torch import quant
    from cuda_flash_attention_tpu_torch.models import lora, training, transformer
    from cuda_flash_attention_tpu_torch.ops import reference
    from cuda_flash_attention_tpu_torch.scripts import b1_ab, fp32_bwd
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
    serve, eng = phase_serving(torch, np, transformer, decode, fa2, dec_attn)
    log(f"phase 5: serving ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_profile(torch, np, eng)
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
        torch, np, transformer, training, fa2, bwd, dataclasses)
    log(f"phase 9: training ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_train_profile(torch, state, step, tokens)
    del state, step
    torch.cuda.empty_cache()
    log(f"phase 10: train profile ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split = phase_train_split(torch, np, transformer, training, fa2, bwd)
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
    spec = phase_spec_serving(torch, np, transformer, decode, fa2, dec_attn,
                              dataclasses)
    log(f"phase 14: speculative serving ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prefix = phase_prefix_chunked(torch, np, transformer, decode, fa2, dec_attn)
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
    fa2.launches = fa2.small_launches = 0
    bwd.fused_launches = bwd.dq_launches = bwd.dkv_launches = 0
    base.fa1_launches = base.naive_fa2_launches = 0
    t0 = time.perf_counter()
    phase_cli(torch, np, cli, io, reference, str(_build.BUILD_DIR.parent))
    log(f"phase 17: CLI ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_harness(harness, configs)
    contract_launches = {"fa2_forward": fa2.launches,
                         "fa2_forward_small": fa2.small_launches,
                         "fa2_backward_fused": bwd.fused_launches,
                         "fa2_backward_dq": bwd.dq_launches,
                         "fa2_backward_dkv": bwd.dkv_launches,
                         "fa1": base.fa1_launches,
                         "naive_fa2": base.naive_fa2_launches}
    log(f"phase 18: harness ok in {time.perf_counter() - t0:.1f} s; launches "
        f"in phases 17-18: {json.dumps(contract_launches)}")
    if not all(contract_launches.values()):
        raise AssertionError(f"phases 17-18: a kernel never ran: {contract_launches}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b7_checks, b7, b7_launches = phase_b7(torch, F, quant, fq, fa2)
    log(f"phase 19: B7 ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paged_quant = phase_paged_quant(torch, dec_attn, kv_cache)
    log(f"phase 20: B5/B6 on fp8 and int4 pages ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    quant_serve = phase_quant_serving(torch, np, transformer, decode, quant, fa2,
                                      dec_attn)
    log(f"phase 21: quantized serving ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    qlora = phase_qlora(torch, np, transformer, training, lora, quant, fa2, bwd)
    log(f"phase 22: QLoRA ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x_rows, x_launches = phase_x(torch, r5)
    log(f"phase 23: X ok in {time.perf_counter() - t0:.1f} s")

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
        bound_by=r6["bound_by"], library_ms=None))
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
        b1_dequant_ms=r7["b1_dequant_ms"], sdpa_dequant_ms=r7["sdpa_dequant_ms"]))
    rx = x_rows[0]
    kernels.append(dict(
        name="r5_d128_fwd", route="cuda",
        source="cuda_flash_attention_tpu_torch/csrc/r5_d128_fwd.cu",
        replaces="scripts/r5_d128_fwd.py:105", launches=x_launches,
        max_abs_err=max(r["max_abs_err"] for r in x_rows),
        ms=rx["ms"], plain_ms=rx["plain_ms"], bound_ms=rx["bound_ms"],
        bound_by=rx["bound_by"], library_ms=rx["library_ms"], b1_ms=rx["b1_ms"],
        variants_ms={r["variant"]: r["ms"] for r in x_rows}))
    # B5 and B6 also ran the quantized serving path (phase 21).
    for k in kernels:
        if k["name"] in ("fa2_forward", "paged_decode", "paged_chunk"):
            k["launches_quant_serving"] = sum(
                r["launches"][k["name"]] for n, r in quant_serve.items()
                if "launches" in r)
    log("fp16 tiles:", json.dumps({"B1 Stress-1": b1_fp16, "B2-B4": [
        {k: r[k] for k in ("kernel", "inputs", "B", "S", "causal", "ms",
                           "bound_ms", "library_ms", "rel_err")} for r in bwd_fp16]}))
    log(json.dumps({"e2e_logit_diff": e2e, "train_parity": parity,
                    "autograd": autograd, "remat": remat,
                    "spec_parity": spec_parity, "qlora": qlora,
                    "paged_quant_rows": len(paged_quant)}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
