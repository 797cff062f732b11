#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuda_flash_attention_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. setup: the card's name and power limit; the three CUDA sources built
     from cuda_flash_attention_tpu_torch/csrc/ with nvcc (sm_90a), all at
     once;
  2. kernel B1 (FA2 forward) against its plain PyTorch version at the
     serving prefill shapes (the serving run's largest, B4 S1536, included)
     and at the train shape (B4 S2048), with its time, its bound and SDPA's
     time;
  3. kernel B5 (paged decode) against its plain version on int8 and bf16
     caches, each with bf16 and fp32 compute, ragged lengths and an
     inactive slot, time and bound;
  4. end to end at the base model's width in fp32: prefill logits and four
     greedy decode steps through DecodeEngine on the card (kernels) and on
     the CPU (plain versions), with the same seeded weights;
  5. serving: DecodeEngine.run at TransformerConfig.base() with an int8
     cache answers 12 requests of 64 tokens, with both kernels' launch counts;
  6. where a decode step's time goes at batch 8: host-clock step time and
     device busy time from one torch.profiler window, the top kernels;
  7. kernels B2, B3, B4 (FA2 backward) against their plain versions at the
     train shape (B4 Hq16 Hkv8 S2048 D64 causal bf16), fp32 at B1 S512 and
     a ragged S1000, B3 and B4 also at B16 S2048 (the split-route training
     shape), with times, bounds and the backward of PyTorch's flash
     attention; then torch.autograd.grad of flash_attention on both routes
     (fused B2; split B3 + B4, forced by 128-row BlockSizes) against the
     plain versions, and bitwise-equal gradients from two runs of each;
  8. one AdamW train step at the base width in fp32 on the card (kernels)
     and on the CPU (plain versions) from the same seeded weights;
  9. training TransformerConfig.base() (bf16) at B4 S2048: 2 warm-up and 5
     timed steps on one batch, tokens/s over the timed steps, mean and
     median step time, peak memory, the loss
     at each step, model FLOPs and their share of the bf16 peak, launches
     (the fused route); one more step with remat="full";
 10. where a train step's time goes at B4 S2048: one torch.profiler window;
 11. training at B16 S2048, where the port's dQ slices would pass 1 GiB
     and the step takes the split route (B3 + B4): two steps, launches.
The last line is the JSON contract line {"ok": true, "device": {...}}.
It imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # tensor-core bf16; fp32 FMA units
B1_TOL = {"bf16": 2e-2, "fp32": 2e-6}
LSE_REL_TOL = 1e-3
B5_TOL = {"bf16": 2e-2, "fp32": 2e-5}
E2E_LOGIT_TOL = 1e-3
# Backward kernels: error relative to the plain output's own max |value|
# (bf16: the JAX bf16-tile grad gate, tests/test_fa2_backward.py).
BWD_TOL = {"bf16": 5e-2, "fp32": 2e-5}
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


def phase_b1(torch, F, fa2):
    """FA2 forward kernel vs its plain version at the prefill shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    hq, hkv, d = 16, 8, 64
    cases = [("bf16", b, s) for b in (1, 8) for s in (128, 512, 1024)]
    # The serving phase's largest prefill: its four longest prompts
    # (1415-1466 tokens) share one length bucket.
    cases.append(("bf16", 4, 1536))
    # The training forward (phase 9): B4 S2048, 12 launches a step.
    cases.append(("bf16", 4, 2048))
    cases.append(("fp32", 1, 512))
    rows = []
    for kind, b, s in cases:
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        tile = torch.bfloat16 if kind == "bf16" else None
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
        scale = d ** -0.5
        kw = dict(causal=True, sm_scale=scale, kv_len=s, tile_dtype=tile)
        o_k, lse_k = fa2.fa2_forward_aligned(q, k, v, **kw)
        o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max().item()
        if not (err <= B1_TOL[kind] and lse_err <= LSE_REL_TOL):
            raise AssertionError(
                f"B1 {kind} B{b} S{s}: max_abs_err {err} (tol {B1_TOL[kind]}), "
                f"lse rel err {lse_err} (tol {LSE_REL_TOL})"
            )
        ms = time_ms(lambda: fa2.fa2_forward_aligned(q, k, v, **kw))
        plain_ms = time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw), iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True))
        pairs = s * (s + 1) // 2  # causal (row, col) pairs per head
        flops = 4 * b * hq * pairs * d
        moved = nbytes(q, k, v, o_k, lse_k)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
        row = dict(kind=kind, B=b, S=s, max_abs_err=err, lse_rel_err=lse_err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations",
                   tflops=flops / ms / 1e9)
        rows.append(row)
        log("B1", json.dumps(row))
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
        shape = (hkv, num_pages, page, d)
        if cache == "int8":
            def pages_of():
                return torch.randint(-127, 128, shape, generator=gen,
                                     device="cuda", dtype=torch.int8)

            def scales_of():
                return torch.rand(shape[:3], generator=gen, device="cuda") * 0.02 + 1e-3
        else:
            def pages_of():
                return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

            def scales_of():
                return torch.ones(shape[:3], device="cuda")
        pages = kv_cache.KVPages(pages_of(), scales_of(), pages_of(), scales_of())
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
        ms = time_ms(lambda: dec_attn.paged_decode_attention(
            q, pages, page_table, lengths, sm_scale=scale, compute_dtype=cdt))
        plain_ms = time_ms(lambda: dec_attn.paged_decode_attention_plain(
            q, pages, page_table, lengths, sm_scale=scale, compute_dtype=cdt),
            iters=5)
        # The function needs each cached token's K and V row and scale once
        # (not the dead rows of a last page), plus q, out, the live page ids
        # and the lengths.
        tokens = int(lengths.sum().item())
        live_pages = int(((lengths.long() + page - 1) // page).sum().item())
        elem = pages.k_pages.element_size()
        moved = (2 * tokens * hkv * (d * elem + 4)
                 + nbytes(q, o_k) + live_pages * 4 + nbytes(lengths))
        flops = 4 * tokens * hq * d
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS["bf16" if compute == "bf16" else "fp32"]
        row = dict(cache=cache, compute=compute, n=n, max_len=2048,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes > t_ops else "operations",
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
    fa2.launches = 0
    dec_attn.launches = 0
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"fa2_forward": fa2.launches, "paged_decode": dec_attn.launches}
    for r in reqs:
        if not (r.done and len(r.generated) == new_tokens
                and all(0 <= t < cfg.vocab_size for t in r.generated)):
            raise AssertionError(f"serving: request {r.uid} incomplete: {r}")
    if eng.allocator.available != eng.num_pages - 1:
        raise AssertionError("serving: pages leaked")
    if not all(launches.values()):
        raise AssertionError(f"serving: a kernel of the path never ran: {launches}")
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


def phase_profile(torch, np, eng):
    """Where a decode step's time goes: eight running requests, ten steps
    under torch.profiler, timed on the host clock over the same window (so
    the step time includes the profiler's own host overhead)."""
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
    res = dict(
        batch=len(reqs), decode_step_ms=step_ms,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        kernel_launches_per_step=sum(e.count for e in kernels) / 10,
        top_kernels_ms_per_step={e.key[:48]: e.self_device_time_total / 1e4
                                 for e in top})
    log("profile", json.dumps(res))
    return res


def causal_pairs(sq: int, kv_len: int, causal: bool) -> int:
    """(query, key) pairs that attend: rows past kv_len see kv_len keys."""
    if not causal:
        return sq * kv_len
    n = min(sq, kv_len)
    return n * (n + 1) // 2 + (sq - n) * kv_len


def library_backward_ms(torch, F, q, k, v, do, scale):
    """The backward of PyTorch's flash attention on the same inputs (K/V
    expanded to Hq): the aten flash backward op fed by its own forward, in
    bf16; in fp32 (which that op does not take) SDPA forward+backward
    through autograd minus SDPA forward."""
    groups = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(groups, dim=1)
    ve = v.repeat_interleave(groups, dim=1)
    if q.dtype == torch.bfloat16:
        out = torch.ops.aten._scaled_dot_product_flash_attention(
            q, ke, ve, 0.0, True, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, offset = out[:8]
        ms = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, ke, ve, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset,
            scale=scale))
        return ms, "aten._scaled_dot_product_flash_attention_backward"
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, ke, ve))

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), do)

    return time_ms(fwd_bwd) - time_ms(fwd), "SDPA fwd+bwd minus fwd (autograd)"


def bwd_problem(torch, attention, fa2, gen, dtype, b, s):
    """Padded train-shape inputs on the card: q, k, v, dO random, O and lse
    from kernel B1, D_i = rowsum(dO * O)."""
    hq, hkv, d = 16, 8, 64
    tile = torch.bfloat16 if dtype == torch.bfloat16 else None
    q, do = (torch.randn(b, hq, s, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    raw = (q, k, v, do)
    q, k, v, scale, q_len, kv_len = attention._prepare(
        q, k, v, True, None, tile, None, None, None, 0)
    o, lse = fa2.fa2_forward_aligned(q, k, v, causal=True, sm_scale=scale,
                                     kv_len=kv_len, tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - s)).contiguous()
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=True, sm_scale=scale, kv_len=kv_len, tile_dtype=tile)
    return dict(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di), kw, raw


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_bwd(torch, F, attention, fa2, bwd):
    """B2, B3 and B4 against their plain versions, each timed beside its
    bound, the plain version and the library backward."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    every = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")
    rows = []
    # B16 S2048 is the split-route training shape (phase 11): B3 and B4 only.
    for kind, b, s, names in (("bf16", 4, 2048, every), ("fp32", 1, 512, every),
                              ("bf16", 2, 1000, every),
                              ("bf16", 16, 2048, every[1:])):
        dtype = torch.bfloat16 if kind == "bf16" else torch.float32
        x, kw, raw = bwd_problem(torch, attention, fa2, gen, dtype, b, s)
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
        lib_ms, lib_how = library_backward_ms(torch, F, *raw[:3], raw[3],
                                              kw["sm_scale"])
        pairs = causal_pairs(s, s, True)
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
        for name in names:
            kernel, plain = calls[name]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
            if not max(errs) <= BWD_TOL[kind]:
                raise AssertionError(f"{name} {kind} B{b} S{s}: relative errors "
                                     f"{errs} (tol {BWD_TOL[kind]})")
            del got, want
            ms = time_ms(kernel, iters=10)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            flops = BWD_MATMULS[name] * 2 * b * hq * pairs * d
            t_bytes = moved[name] / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[kind]
            row = dict(kernel=name, kind=kind, B=b, S=s, rel_err=max(errs),
                       max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library=lib_how,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes > t_ops else "operations",
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log("bwd", json.dumps(row))
        del x, raw
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
        if any(n in e.key for n in ("fa2_fwd_", "bwd_kv_", "bwd_dq_")):
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
    from cuda_flash_attention_tpu_torch.kernels import _build, attention
    from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
    from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes
    from cuda_flash_attention_tpu_torch.models import training, transformer

    # fp32 means fp32: no TF32 in the plain versions' matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    build_logs = _build.build("fa2_forward", "paged_decode", "fa2_backward")
    log(f"phase 1: built {sorted(build_logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    b1 = phase_b1(torch, F, fa2)
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
    bwd_rows = phase_bwd(torch, F, attention, fa2, bwd)
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

    # Representative shapes for the kernel line: the serving phase's largest
    # prefill (B4 S1536 bf16) and the int8 cache with bf16 compute.
    r1 = next(r for r in b1 if (r["kind"], r["B"], r["S"]) == ("bf16", 4, 1536))
    r1_train = next(r for r in b1 if (r["kind"], r["B"], r["S"]) == ("bf16", 4, 2048))
    log("B1 serving (B4 S1536) and training (B4 S2048) shapes:",
        json.dumps({"S1536": r1, "S2048": r1_train}))
    r5 = next(r for r in b5 if (r["cache"], r["compute"]) == ("int8", "bf16"))
    kernels = [
        dict(name="fa2_forward", route="cuda",
             source="cuda_flash_attention_tpu_torch/csrc/fa2_forward.cu",
             replaces="cuda_flash_attention_tpu/kernels/fa2_forward.py:613",
             launches=serve["launches"]["fa2_forward"],
             max_abs_err=max(r["max_abs_err"] for r in b1 if r["kind"] == "bf16"),
             ms=r1["ms"], plain_ms=r1["plain_ms"], bound_ms=r1["bound_ms"],
             bound_by=r1["bound_by"], library_ms=r1["library_ms"]),
        dict(name="paged_decode", route="cuda",
             source="cuda_flash_attention_tpu_torch/csrc/paged_decode.cu",
             replaces="cuda_flash_attention_tpu/decode/attention.py:161",
             launches=serve["launches"]["paged_decode"],
             max_abs_err=max(r["max_abs_err"] for r in b5 if r["compute"] == "bf16"),
             ms=r5["ms"], plain_ms=r5["plain_ms"], bound_ms=r5["bound_ms"],
             bound_by=r5["bound_by"], library_ms=None),
    ]
    # Backward rows at the train shape (B4 S2048 bf16), where the fused and
    # split routes are compared; phase 7 also holds B3 and B4 at B16 S2048.
    # B2's launches come from the base training run (its route); B3's and
    # B4's from the B16 run, which takes the split route.
    for name, replaces, launches in (
            ("fa2_backward_fused", 529, train["launches"]["fa2_backward_fused"]),
            ("fa2_backward_dq", 675, split["launches"]["fa2_backward_dq"]),
            ("fa2_backward_dkv", 386, split["launches"]["fa2_backward_dkv"])):
        r = next(r for r in bwd_rows if (r["kernel"], r["kind"], r["B"], r["S"])
                 == (name, "bf16", 4, 2048))
        kernels.append(dict(
            name=name, route="cuda",
            source="cuda_flash_attention_tpu_torch/csrc/fa2_backward.cu",
            replaces=f"cuda_flash_attention_tpu/kernels/fa2_backward.py:{replaces}",
            launches=launches,
            max_abs_err=max(x["max_abs_err"] for x in bwd_rows
                            if x["kernel"] == name and x["kind"] == "bf16"),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    log(json.dumps({"e2e_logit_diff": e2e, "train_parity": parity,
                    "autograd": autograd, "remat": remat}))
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
