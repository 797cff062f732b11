"""Decode throughput benchmark: steady-state tokens/s over the paged
quantized KV cache, on the card.

Counterpart of cuda_flash_attention_tpu/bench/decode_bench.py.  The device
loop chains `decode_step` and greedy sampling, each step consuming the
previous step's token, from a prefilled batch; it is timed at two loop
lengths and differenced (the slope cancels the fixed cost of a run).  On
the card the loop is one CUDA graph of one step replayed n times
(decode/graphs.py), timed with CUDA events around the replays, with the
host clock beside them; `eager_step_ms` is the same loop launched eagerly,
so the two give the device cost and the host's launch cost of a step.  On
the CPU the loop runs eagerly and only the host clock exists: its numbers
are not device numbers ("platform": "cpu").

`measure_engine_throughput` is the end-to-end DecodeEngine number (host
scheduler included); `--device-ratio` divides its per-token-step time by
the device loop's step to give `engine_overhead_x`.  With `mesh=` every
rank of the mesh calls it and times its own run of the sharded engine.
`--tp-dryrun TP` (`tp_decode_dryrun`) runs that engine on a {model TP}
mesh of TP gloo ranks on the CPU: it shows that the tensor-parallel
serving path runs end to end; its times are CPU times of one host.

Usage (on the card; add `--device cpu` for the CPU):
    python -m cuda_flash_attention_tpu_torch.bench.decode_bench \\
        --batch 16 --prompt-len 128 --gen 64
    python -m cuda_flash_attention_tpu_torch.bench.decode_bench --config base \\
        --engine --burst 8 --device-ratio
    python -m cuda_flash_attention_tpu_torch.bench.decode_bench --tp-dryrun 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.decode.graphs import StepGraph
from cuda_flash_attention_tpu_torch.decode.kv_cache import (
    PageAllocator,
    init_kv_pages,
    write_prompt_kv,
)
from cuda_flash_attention_tpu_torch.decode.model import decode_step, prefill_forward
from cuda_flash_attention_tpu_torch.kernels.common import cdiv
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)


def _prompt_tokens(cfg: TransformerConfig, batch: int, prompt_len: int,
                   seed: int) -> torch.Tensor:
    """The benchmark's random prompts [batch, prompt_len] (CPU, from seed+1)."""
    gen = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen)


def build_state(cfg: TransformerConfig, batch: int, prompt_len: int,
                max_len: int, page_size: int = 128, cache_dtype=torch.int8,
                seed: int = 0, weight_dtype=None, act_quant: bool = False,
                scan_layers: bool = False, device=None):
    """Prefill `batch` random prompts into a paged cache sized for max_len;
    returns (params, caches, page_table [batch, pages_per_seq] int32 on the
    device, first greedy tokens [batch]).

    Weights come from `seed` (on the device's generator), prompts from
    seed + 1.  ``weight_dtype`` (torch.int8, torch.float8_e4m3fn or "int4")
    quantizes the dense projections, ``act_quant`` marks int8 weights for
    W8A8; ``scan_layers`` is accepted and keeps the per-layer list form,
    as the engine does (the JAX scan cuts compile time; eager PyTorch
    compiles nothing).  Each slot preallocates its whole horizon of pages."""
    device = resolve_device(device)
    params = init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                         device=device)
    if weight_dtype is not None:
        from cuda_flash_attention_tpu_torch.quant.linear import (
            quantize_transformer_params,
        )

        params = quantize_transformer_params(params, weight_dtype,
                                             act_quant=act_quant)
    pages_per_seq = cdiv(max_len, page_size)
    num_pages = batch * pages_per_seq + 1
    alloc = PageAllocator(num_pages)
    page_table = np.zeros((batch, pages_per_seq), np.int32)
    caches = [init_kv_pages(cfg.n_kv_heads, num_pages, page_size,
                            cfg.head_dim, cache_dtype, device=device)
              for _ in range(cfg.n_layers)]
    tokens = _prompt_tokens(cfg, batch, prompt_len, seed).to(device)
    n_prompt_pages = cdiv(prompt_len, page_size)
    pad = n_prompt_pages * page_size - prompt_len
    with torch.inference_mode():
        logits, kv = prefill_forward(params, tokens, cfg, last_only=True)
        for s in range(batch):
            ids = alloc.alloc(pages_per_seq)  # preallocate the whole horizon
            page_table[s, :] = ids
            ids_prompt = torch.tensor(ids[:n_prompt_pages], device=device)
            for li, (k_all, v_all) in enumerate(kv):
                write_prompt_kv(caches[li], F.pad(k_all[s], (0, 0, 0, 0, 0, pad)),
                                F.pad(v_all[s], (0, 0, 0, 0, 0, pad)),
                                ids_prompt)
        first = torch.argmax(logits[:, -1, :], dim=-1)
    return params, caches, torch.from_numpy(page_table).to(device), first


def make_loop_fn(cfg: TransformerConfig, page_table, start_len: int,
                 horizon: int | None = None, page_size: int = 128,
                 graph: bool = True):
    """Returns run_n(params, caches, tokens, n) -> (caches, tokens): n
    chained greedy decode steps from position start_len, each step's token
    feeding the next; `run_n.history` holds the last run's tokens [n,
    batch].

    ``horizon`` (the most tokens the loop will hold) slices the page table
    to the live span, as the JAX loop does (there each dead page cost the
    TPU kernel's grid ~0.9 us; B5 visits live pages only, but its split
    plan reads the table width).  On the card the loop is a CUDA graph of
    one step (captured at the first run on new params or caches, then
    replayed n times), or with ``graph=False`` eager launches
    (eager_step_ms); on the CPU it runs eagerly."""
    if horizon is not None:
        live = min(cdiv(int(horizon), int(page_size)), page_table.shape[1])
        page_table = page_table[:, :live].contiguous()
    device = page_table.device
    use_graph = graph and device.type == "cuda"
    batch = page_table.shape[0]
    capacity = page_table.shape[1] * page_size - start_len  # steps the table holds
    state: dict = {}

    def step():
        positions = state["i"].expand(batch) + start_len
        logits, _ = decode_step(state["params"], state["tokens"], positions,
                                state["caches"], page_table, state["active"], cfg)
        nxt = torch.argmax(logits, dim=-1)
        state["history"].index_copy_(0, state["i"], nxt[None])
        state["tokens"].copy_(nxt)
        state["i"].add_(1)

    def warmup():
        # One eager step writes the K/V the first replay writes again.
        tokens = state["tokens"].clone()
        step()
        state["tokens"].copy_(tokens)
        state["i"].zero_()

    def run_n(params, caches, tokens, n: int):
        if n > capacity:
            raise ValueError(f"{n} steps from {start_len} overrun the page table")
        with torch.inference_mode():
            if state.get("key") != (id(params), id(caches)):
                state.update(
                    key=(id(params), id(caches)), params=params, caches=caches,
                    tokens=torch.zeros(batch, dtype=torch.long, device=device),
                    i=torch.zeros(1, dtype=torch.long, device=device),
                    active=torch.ones(batch, dtype=torch.bool, device=device),
                    history=torch.zeros(capacity, batch, dtype=torch.long,
                                        device=device),
                    graph=StepGraph(step, device, warmup=warmup) if use_graph else None)
            state["tokens"].copy_(tokens)
            state["i"].zero_()
            if state["graph"] is not None:
                state["graph"].run(n)
            else:
                for _ in range(n):
                    step()
            run_n.history = state["history"][:n].clone()
            return caches, state["tokens"].clone()

    run_n.history = None
    return run_n


def _timed(fn, device: torch.device) -> tuple[float, float]:
    """(device seconds, host seconds) of fn(): CUDA events around it on the
    card; on the CPU the host clock is the only clock (both the same)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        return host, host
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    host = time.perf_counter() - t0
    return start.elapsed_time(end) / 1e3, host


def _slopes(run_n, params, caches, first, n_lo: int, n_hi: int, repeats: int,
            device: torch.device):
    """`repeats` (device, host) slopes, seconds per step: each one lo/hi
    run pair, after one untimed run of n_lo (the capture, on the card)."""
    run_n(params, caches, first, n_lo)
    dev, host = [], []
    for _ in range(max(repeats, 1)):
        d_lo, h_lo = _timed(lambda: run_n(params, caches, first, n_lo), device)
        d_hi, h_hi = _timed(lambda: run_n(params, caches, first, n_hi), device)
        dev.append(max(d_hi - d_lo, 1e-9) / (n_hi - n_lo))
        host.append(max(h_hi - h_lo, 1e-9) / (n_hi - n_lo))
    return dev, host


def _dtype_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch.")


def measure_decode_throughput(cfg: TransformerConfig, batch: int = 16,
                              prompt_len: int = 128, gen_tokens: int = 64,
                              page_size: int = 128, cache_dtype=torch.int8,
                              weight_dtype=None, act_quant: bool = False,
                              repeats: int = 5, device=None) -> dict:
    """The median of `repeats` slopes (each one lo/hi loop pair, lo =
    gen_tokens steps, hi = 5x) with the min/max spread: the JAX function's
    keys, plus `eager_step_ms` (the same loop without the graph, its median
    slope) and `host_step_ms` (the graph loop's slope on the host clock)."""
    device = resolve_device(device)
    max_len = cdiv(prompt_len, page_size) * page_size + gen_tokens * 6 + page_size
    params, caches, page_table, first = build_state(
        cfg, batch, prompt_len, max_len, page_size, cache_dtype,
        weight_dtype=weight_dtype, act_quant=act_quant, device=device)
    n_lo, n_hi = gen_tokens, gen_tokens * 5
    loop = dict(horizon=prompt_len + n_hi + 1, page_size=page_size)
    slopes, host = _slopes(make_loop_fn(cfg, page_table, prompt_len, **loop),
                           params, caches, first, n_lo, n_hi, repeats, device)
    eager, _ = _slopes(make_loop_fn(cfg, page_table, prompt_len, graph=False,
                                    **loop),
                       params, caches, first, n_lo, n_hi, repeats, device)
    step_s = float(np.median(slopes))
    return {
        "tokens_per_sec_per_chip": batch / step_s,
        "step_ms": step_s * 1e3,
        "step_ms_min": round(min(slopes) * 1e3, 4),
        "step_ms_max": round(max(slopes) * 1e3, 4),
        "repeats": len(slopes),
        "batch": batch,
        "prompt_len": prompt_len,
        "cache_dtype": _dtype_name(cache_dtype),
        "weight_dtype": ("w8a8" if act_quant
                         else _dtype_name(weight_dtype) if weight_dtype is not None
                         else "bf16"),
        "model": dataclass_summary(cfg),
        "eager_step_ms": float(np.median(eager)) * 1e3,
        "host_step_ms": float(np.median(host)) * 1e3,
        "timer": "cuda_events" if device.type == "cuda" else "host_clock",
    }


def dataclass_summary(cfg: TransformerConfig) -> str:
    return (f"L{cfg.n_layers}_d{cfg.d_model}_h{cfg.n_heads}"
            f"kv{cfg.n_kv_heads}_ff{cfg.d_ff}")


def measure_engine_throughput(cfg: TransformerConfig, batch: int = 16,
                              prompt_len: int = 128, gen_tokens: int = 64,
                              cache_dtype=torch.int8, mesh=None,
                              spec_tokens: int = 0, draft_layers: int = 1,
                              spec_mode: str = "draft",
                              prefill_chunk: int | None = None,
                              decode_burst: int = 1, device=None) -> dict:
    """End-to-end DecodeEngine tokens/s, host scheduler included (admission,
    page allocation, retire, one readback per engine step): `batch` random
    prompts of prompt_len tokens, gen_tokens each, timed from after the
    first decode step (the graph's capture) to the last.  The draft of
    `spec_tokens` is the target's first `draft_layers` layers.  The JAX
    function's keys ("tp" is the mesh's rank count, as JAX counts its
    devices), plus `burst_dispatches`, `graph_replays` and `graphs`.  With
    a mesh, every rank calls this with the same arguments (the engine takes
    the full weights and keeps its blocks) and runs on the mesh's device."""
    from cuda_flash_attention_tpu_torch.decode.engine import DecodeEngine

    device = resolve_device(device) if mesh is None else mesh.device
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    max_len = prompt_len + gen_tokens + 1 + spec_tokens
    spec_kw = {}
    if spec_tokens and spec_mode == "prompt_lookup":
        spec_kw = dict(spec_tokens=spec_tokens, spec_mode="prompt_lookup")
    elif spec_tokens:
        spec_kw = dict(
            draft_params={"embed": params["embed"],
                          "layers": params["layers"][:draft_layers],
                          "final_norm": params["final_norm"],
                          "lm_head": params["lm_head"]},
            draft_cfg=dataclasses.replace(cfg, n_layers=draft_layers),
            spec_tokens=spec_tokens)
    eng = DecodeEngine(params, cfg, max_seqs=batch, max_seq_len=max_len,
                       cache_dtype=cache_dtype, prefill_chunk=prefill_chunk,
                       decode_burst=decode_burst, device=device, mesh=mesh,
                       **spec_kw)
    del params, spec_kw
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len)).tolist()
    reqs = eng.submit_many(prompts, max_new_tokens=gen_tokens)
    eng.step()  # the first decode step captures the graph
    tokens_before = sum(len(r.generated) for r in reqs)
    t0 = time.perf_counter()
    steps = 0
    while eng.active.any():
        eng.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timed_tokens = sum(len(r.generated) for r in reqs) - tokens_before
    # One token step advances every active sequence by one token.
    token_steps = max(timed_tokens / max(batch, 1), 1e-9)
    return {
        "engine_tokens_per_sec": timed_tokens / dt,
        "engine_step_ms": dt / max(steps, 1) * 1e3,
        "engine_ms_per_token_step": dt / token_steps * 1e3,
        "decode_burst": decode_burst,
        "steps": steps,
        "timed_tokens": timed_tokens,
        "cache_dtype": _dtype_name(cache_dtype),
        "tp": 1 if mesh is None else int(np.prod(list(mesh.shape.values()))),
        "spec_tokens": spec_tokens,
        "spec_mode": spec_mode if spec_tokens else None,
        "spec_acceptance": eng.acceptance_rate,
        "prefill_chunk": prefill_chunk,
        "prefill_chunks_run": eng.stats["prefill_chunks"],
        "burst_dispatches": eng.stats.get("burst_dispatches", 0),
        "graph_replays": eng.graph_replays,
        "graphs": eng.stats["graphs"],
    }


def _dryrun_rank(cfg: TransformerConfig, tp: int, batch: int,
                 gen_tokens: int) -> dict:
    """One rank of tp_decode_dryrun."""
    from cuda_flash_attention_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        make_device_mesh,
    )

    mesh = make_device_mesh({MODEL_AXIS: tp}, device="cpu")
    return measure_engine_throughput(cfg, batch=batch, prompt_len=128,
                                     gen_tokens=gen_tokens,
                                     cache_dtype=torch.int8, mesh=mesh)


def tp_decode_dryrun(cfg: TransformerConfig, tp: int = 2, batch: int = 4,
                     gen_tokens: int = 4) -> dict:
    """Tensor-parallel serving dry run (JAX bench/decode_bench.py:315-336):
    the engine with KV pages and heads split over a {model tp} mesh of tp
    gloo ranks on the CPU (parallel.launch; JAX uses tp virtual CPU
    devices) runs a short generation.  Returns rank 0's
    measure_engine_throughput dict with `dryrun` True: it proves that the
    path runs, and its times are the CPU's."""
    from cuda_flash_attention_tpu_torch.parallel import launch

    out = launch.run("cuda_flash_attention_tpu_torch.bench.decode_bench:_dryrun_rank",
                     tp, args=(cfg, tp, batch, gen_tokens))[0]
    out["dryrun"] = True
    return out


def _cache_dtype(args):
    return "int4" if args.cache_dtype == "int4" else getattr(torch, args.cache_dtype)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--gen", type=int, default=64)
    p.add_argument("--cache-dtype", default="int8",
                   choices=["int4", "int8", "float8_e4m3fn", "bfloat16",
                            "float32"])
    p.add_argument("--page-size", type=int, default=128,
                   help="KV page size in tokens")
    p.add_argument("--flagship", action="store_true",
                   help="use the flagship config instead of the bench default")
    p.add_argument("--config", choices=["tiny", "flagship", "base"], default=None,
                   help="model config (base = the 254M production shape)")
    p.add_argument("--weight-dtype", default=None,
                   choices=["int8", "float8_e4m3fn", "int4"],
                   help="weight-only quantization of the dense projections "
                        "(int4 = packed group-wise)")
    p.add_argument("--w8a8", action="store_true",
                   help="with --weight-dtype int8: quantize activations too")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="with --engine: speculative decoding, K draft tokens "
                        "per round (draft = first --draft-layers layers)")
    p.add_argument("--draft-layers", type=int, default=1)
    p.add_argument("--spec-mode", default="draft",
                   choices=["draft", "prompt_lookup"])
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="with --engine: chunked prefill")
    p.add_argument("--engine", action="store_true",
                   help="measure end-to-end engine throughput (host scheduler "
                        "included) instead of the device loop")
    p.add_argument("--burst", type=int, default=1,
                   help="with --engine: decode_burst (chained steps per "
                        "engine step, one readback per burst)")
    p.add_argument("--device-ratio", action="store_true",
                   help="with --engine: also run the device loop on the same "
                        "config and emit engine_ms_per_token_step / step_ms")
    p.add_argument("--tp-dryrun", type=int, default=0, metavar="TP",
                   help="tensor-parallel serving dry run on TP gloo ranks on "
                        "the CPU")
    p.add_argument("--repeats", type=int, default=5,
                   help="device-loop slopes; the median is reported with the "
                        "min/max spread")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    # The dry run's ranks are gloo ranks on the CPU whatever --device says.
    device = torch.device("cpu") if args.tp_dryrun else resolve_device(args.device)

    name = args.config or ("flagship" if args.flagship else "tiny")
    cfg = {
        "tiny": TransformerConfig.tiny,
        "base": TransformerConfig.base,
        "flagship": lambda: TransformerConfig(
            vocab_size=2048, d_model=512, n_layers=4, n_kv_heads=4, n_heads=8,
            head_dim=64, d_ff=1536),
    }[name]()
    weight_dtype = ("int4" if args.weight_dtype == "int4"
                    else getattr(torch, args.weight_dtype) if args.weight_dtype
                    else None)
    if args.tp_dryrun:
        out = tp_decode_dryrun(cfg, tp=args.tp_dryrun, batch=args.batch)
    elif args.engine:
        out = measure_engine_throughput(
            cfg, batch=args.batch, prompt_len=args.prompt_len,
            gen_tokens=args.gen, cache_dtype=_cache_dtype(args),
            spec_tokens=args.spec, draft_layers=args.draft_layers,
            spec_mode=args.spec_mode, prefill_chunk=args.prefill_chunk,
            decode_burst=args.burst, device=device)
        if args.device_ratio:
            dev = measure_decode_throughput(
                cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen_tokens=args.gen, cache_dtype=_cache_dtype(args),
                repeats=args.repeats, device=device)
            out["device_step_ms"] = dev["step_ms"]
            out["engine_overhead_x"] = (out["engine_ms_per_token_step"]
                                        / max(dev["step_ms"], 1e-9))
    else:
        out = measure_decode_throughput(
            cfg, batch=args.batch, prompt_len=args.prompt_len,
            gen_tokens=args.gen, cache_dtype=_cache_dtype(args),
            weight_dtype=weight_dtype, act_quant=args.w8a8,
            page_size=args.page_size, repeats=args.repeats, device=device)
        out["page_size"] = args.page_size
    out["platform"] = "gpu" if device.type == "cuda" else "cpu"
    out["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
