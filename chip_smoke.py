#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cuda_flash_attention_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. setup: the card's name and power limit; the eight CUDA sources and
     the D 32 and D 256 libraries of B1-B10 (csrc/*_d32.cu, *_d256.cu:
     BUILD_ORDER) built from cuda_flash_attention_tpu_torch/csrc/ with nvcc
     (sm_90a), all at once, each source's compile seconds printed; ptxas's registers, spills and wgmma notes for every
     instantiation of the backward's bf16/fp16-tile kernels (B2's
     prologue, main kernel and dQ reduce; B3's kernel; B4's, the main
     kernel without its dQ phase) and of the fp32 FMA block's (B10, B9, B1's
     fp32 body, B8's fp32 body, the backward's `bwd_kv_fp32` (B4, and
     B2's with FUSED), `bwd_dq_fp32` (B3) and their fp32 prologue, at D 64
     and 128), of B5's split-KV kernel (48: six caches x two q types x
     D 64 and 128 x groups of at most 2 and 8), of B6's split-KV body (48:
     the same with fp32 compute on the FMA units and bf16 compute on the
     tensor cores), bf16 tile body (24) and fp32 tile body (24), of B7's
     wgmma and fp32 bodies (48: four storages x two q types x D 64 and 128
     each, its FMA body with and without segment ids), of every D 32 and D
     256 instantiation (B1's wgmma and fp32 bodies, B5, B6's three bodies,
     the backward's, csrc/fa2_backward_d32.cu and _d256.cu: 22 kernels
     each; B9 and B10, B8's two bodies and B7's two: WIDE_FUNCTIONS) and
     of X's five variants, failing on a
     spilled byte, a wgmma serialisation note or a missing instantiation;
  2. kernel B1 (FA2 forward) against its plain PyTorch version at the
     serving prefill shapes (the serving run's largest, B4 S1536, included)
     and at the train shape (B4 S2048), and at the edges of its 128-row
     wgmma tiles (scripts/b1_ab.py CASES: D 128, fp16 tiles on bf16
     inputs, Sq != Skv, S 16 and 112, kv_len inside the last box, GQA
     16/2), with its time, TFLOP/s, its bound and SDPA's time;
  3. kernel B5 (paged decode) against its plain version on int8 and bf16
     caches, each with bf16 and fp32 compute, ragged lengths and an
     inactive slot, device time (back-to-back time beside it) and bound;
  4. end to end at the base model's width in fp32 (1 layer): prefill
     logits and four greedy decode steps through DecodeEngine on the card
     (kernels) and on the CPU (plain versions), with the same seeded
     weights;
  5. serving: DecodeEngine.run at TransformerConfig.base() with an int8
     cache answers 12 requests of 64 tokens, with both kernels' launch counts;
  6. where a decode step's time goes at batch 8: host-clock step time and
     device busy time from one torch.profiler window of three steps, the
     top kernels and B5's time and share of the busy time;
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
  8. one AdamW train step at the base width in fp32 (1 layer) on the card
     (kernels) and on the CPU (plain versions) from the same seeded
     weights, tokens (1, 129);
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
 13. fp32 at base width (2 layers): verify_step logits on the card against
     the CPU;
     speculative greedy (k 3, a one-layer draft), a prefix-cache hit and
     chunked prefill (chunk 512, a 1300-token prompt) each give exactly
     the card's plain greedy tokens; B6's fp32 tile body's launches over
     the phase (the kernel line's `fp32_tile`);
 14. speculative serving at TransformerConfig.base() with an int8 cache:
     phase 5's 12 requests (4 new tokens each) with k 4, a one-layer draft
     and prompt lookup:
     tokens/s, acceptance, rounds, B1/B5/B6 launches, and where a round's
     time goes (one profiled window of three rounds, as phase 6, with B6's
     time and share of a round's busy time);
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
     (6 new tokens each) on an int8 cache (the control), an e4m3 cache, an int4 cache, int8
     W8A8 weights and int4 weights (int8 caches), and chunked prefill 512
     on the int4 cache: tokens/s, mean step, TTFT, B1/B5/B6 launches; a
     profiled window of int4-weight decode steps; fp32 card-vs-CPU parity
     of an int4 cache with int4 weights at base width (1 layer);
 22. QLoRA: two LoRA AdamW steps at base width, B4 S2048, on an int4 base
     (finite loss, base bytes unchanged, adapters moved, merge_lora logits
     within the int4 requantization budget);
 23. X (the D=128 rowsum probe) through its entry point at B4 H8 S2048
     D128 bf16 (five variants beside B1 and SDPA), each variant against
     its plain version;
 24. the serving and training benchmarks (bench/decode_bench.py,
     bench/train_bench.py) at TransformerConfig.base(): the decode device
     loop at batch 16, prompt 128, 16 new tokens (a CUDA graph of one step: step_ms by
     CUDA events, eager_step_ms, their ratio); greedy tokens of the
     burst-8 engine, the burst-1 engine and an eager decode_step loop,
     which must be bitwise equal; the engine at bursts 1 and 8 with
     engine_overhead_x; phase 5's 12 requests at bursts 1 and 8 (the same
     tokens, graph replays, bursts, launches, 6 new tokens each; burst
     8 profiled as phase 6, whose burst-1 launches and idle share it prints
     beside); train
     tokens/s at B4 S2048 (one slope between chains of 2 and 10 AdamW
     steps);
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
     prefill 512, 8 new tokens each: tokens/s, TPOT, TTFT, each window
     group's peak live pages,
     no decoding slot's local group above 2 pages after any step, windowed
     launches of B1, B5 and B6; and the streaming configuration (window 512,
     4 sinks, every layer) in fp32 at base width (2 layers), card against
     CPU, greedy
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
     streaming base configurations train 3 AdamW steps each at B4 S2048:
     finite falling loss, step time, tokens/s, peak memory, windowed
     launches (hybrid: B3 and B4, B2 on the global layers; streaming: B2
     only); (d) one fp32 AdamW step of each (hybrid window 64 at 2
     layers, a local and a global one; streaming window 96 with 4 sinks at
     1) on tokens (1, 129), card against CPU, as phase 8.
 27. a Gemma-2-2B-width hybrid model at head_dim 256 (google/gemma-2-2b's
     published widths: d_model 2304, 8/4 heads of 256, d_ff 9216, vocab
     256000, a 4096-token window on every other layer, 26 layers, bf16
     weights random from a seed; SwiGLU for GeGLU, no soft-capping, no
     post-norms, no embedding scale) served on an int8 cache, 8 slots,
     CUDA-graph decode: 12 requests (8 of 64-1500 tokens, 4 of 4500-6000),
     chunked prefill 512, 8 greedy tokens each: tokens/s, TPOT, TTFT, each
     window group's peak live pages (the local group within its live bound
     after every step), B1's, B5's and B6's launches at D 256, windowed and
     global; the same widths at 2 layers in fp32, card against CPU, greedy
     tokens equal on an int8 cache and on an fp32 cache (chunked prefill
     128, so that B5 and B6 read fp32 pages at D 256); speculation and
     prefix caching refused on the hybrid cache;
 28. B1 at D 32 (B4 Hq16 Hkv8 S2048) and D 256 (B1 Hq8 Hkv4 S4096) in bf16
     tiles, fp16 tiles and fp32 under causal masking, window 128 with 4
     sinks, a band of offset -100 and 4 documents a row; B5 and B6 (T 5,
     T 512 in bf16 and fp32 compute) at D 32 and 256 on int8, int4, e4m3
     and bf16 caches, and at D 256 on an fp32 cache (every body; B5 and the
     split body in fp32 compute too, held to 2e-5); B7 with window 160 and with 2 segments at B4 Hq16
     Hkv8 S2048 D64 (int8, int4, e4m3; bf16 and fp32 compute) and its
     windowed and segmented launches on the public API.  Each against its
     plain version with a control that must fail the gate (the mask one
     key off; the paged lengths one key short; the bf16 instantiation for
     fp16 tiles), device time beside the bound (kept pairs) and, for B1,
     SDPA;
 29. B2, B3 and B4 at D 32 (B4 Hq16 Hkv8 S2048) and D 256 (B1 Hq8 Hkv4
     S4096) under phase 28's four masks, in bf16 tiles, fp16 tiles on fp32
     inputs and fp32, against the plain backward within BWD_TOL (fp16:
     FP16_REL_TOL), each with a control that must fail its gate (fp32 the
     mask one key off, bf16 one 64-key tile off, fp16 the bf16
     instantiation), device time beside the kept-pair bound, the plain
     versions' times and SDPA's backward (flash under causal masking with
     16-bit tiles, else memory-efficient with the mask as its bias);
 30. the Gemma-2-2B widths (phase 27's, 26 layers, bf16 weights and tiles)
     train 3 AdamW steps on one seeded batch of B1 S2048 (every layer
     global: the 4096 window covers it): a finite, falling loss, step ms,
     tokens/s, peak memory, the bf16-peak share, B1's and B2's D 256
     launches, one profiled step as phase 10's; one more step with 128-row
     BlockSizes takes the split pair
     (B3's and B4's D 256 launches); one fp32 AdamW step of the same
     attention widths at 2 layers (vocab 4096, tokens (1, 257)), card
     against CPU, as phase 8.
 31. B7, B8, B9 and B10 at D 32 and 256 and the path that needs them: B9
     and B10 at B8 H16 S2048 D32 (Stress-1 at the reference's head dim) and
     B1 H8 S4096 D256 in fp32; B8 at Small-1, Edge-NonPowerOf2 and
     Edge-SmallSeq in fp32, bf16 and fp16 tiles, full, causal, window 24
     with 2 sinks and 2 segments (the route taking B8 at every width); B7
     at D 32 (B4 Hq16 Hkv8 S2048) and D 256 (B1 Hq8 Hkv4 S4096, Gemma-2-2B's
     attention width) over int8, e4m3, e5m2 and int4 in bf16 and fp32
     compute, causal, window 160 and 2 segments; each against its plain
     version with a control that must fail the gate, device time beside
     the bound, the plain version and SDPA (B7: B1 and SDPA on the
     dequantized bf16 K/V); the public quantized-KV API at both widths over
     the four storages (B7's D 32 and D 256 launches); then the reference
     contract: the CLI on a B8_H16_S2048_D32 directory (fa2 in every mode
     and precision, fa1, fa2-naive and naive forward, an Edge-NonPowerOf2
     D 32 directory taking B8) and on a B1_H8_S4096_D256 one (fa2
     forward_backward fp32, fa1, fa2-naive, an Edge-NonPowerOf2 D 256
     directory taking B8), every file against the fp32 oracle, and the
     harness's forward experiment and fa1 rows re-made at D 32 (every row
     PASS); B8's, B9's and B10's D 32 and D 256 launches come from there;
 32. mixture of experts at Mixtral-8x7B's widths (MIXTRAL_8X7B: d_model
     4096, 32/8 heads of 128, d_ff 14336, vocab 32000, rope 1e6, 8 experts,
     top 2, every layer MoE, aux 0.02; capacity factor 4.0 = E / k, so no
     token drops; random bf16 weights drawn on the card; what the JAX block
     cannot express printed as MIXTRAL_NOT_EXPRESSED): (a) 8 layers served
     on an int8 cache, 8 slots, CUDA-graph decode, chunked prefill 512,
     phase 5's 12 prompts, 24 greedy tokens each (B1, B5, B6 launched, no
     page leaked, tokens in the vocabulary; tokens/s, TPOT, TTFT, peak
     memory, a profiled graph decode step and the MoE ops' share of an
     eager one); (b) 2 layers trained 4 AdamW steps (lr 1e-4) at B1 S2048:
     falling loss, the router loss, step time, tokens/s, peak memory,
     bf16-peak share of the routed work, backward launches; (c) 1 layer in
     fp32 at capacity factor 1.0, card against CPU on one prefill_forward
     of (1, 129) tokens: logits within E2E_LOGIT_TOL, routing equal but
     under a 1e-6 top-k margin, dropped pairs counted; (d) base width B4
     S2048 under remat "none", "dots" and "full": losses and gradients
     bitwise equal, "dots" peak below "none"; (e) one AdamW step on int8
     weights (base width, 1 layer, fp32) card against CPU: int values
     unchanged, scales moved, their first moments within TRAIN_GRAD_TOL
     (the moments negated must fail), the scales within 2e-5; (f)
     train_loop with a checkpoint on the card at tiny(), restored onto the
     card by default and resumed bitwise; and first, the path's kernels at
     its shapes against their plain versions, each with a control that
     must fail: B1 and B2 at B1 Hq32 Hkv8 S2048 D128 causal (bf16 tiles
     and fp32), B5 and B6 T512 at D 128 Hq32 Hkv8 on its int8 cache (bf16
     and fp32 compute; B5's group-8 instantiation, B6's tile bodies).
     The profiler windows of phases 6, 10, 30 and 32 run through
     utils/profiling.trace; phases 30 and 32 print their training step's
     top 10 kernels, each with the op that launched it;
 33. the slice of profiling, the Hugging Face import and the token loader:
     (a) prompt-lookup speculation (k 4) with an MoE target, phase 32's
     1-layer fp32 Mixtral-width model at capacity factor 1.0 on the card
     and on the CPU, 4 slots: greedy tokens equal, routing compared call
     by call as phase 32 compares it, the capacity binding; (b)
     meta-llama/Meta-Llama-3-8B's config.json widths (LLAMA3_8B: d_model
     4096, 32 layers, 32/8 heads of 128, d_ff 14336, vocab 128256, rope
     500000, untied embeddings; what the port cannot express in
     LLAMA3_NOT_EXPRESSED) as a seeded random bf16 state dict in Hugging
     Face's key names and [out, in] layout on the card (8.03B parameters),
     converted there by utils/hf_convert.params_from_hf (its peak memory
     printed), served at 32 layers on an int8 cache, 8 slots, CUDA-graph
     decode, chunked prefill 512, phase 5's first 8 prompts, 24 greedy
     tokens each (tokens/s, TPOT, TTFT, peak memory, B1/B5/B6 launches at D
     128 Hq32 Hkv8), one profiled graph step with its top kernels beside
     the step's roofline and B5's (utils/profiling.roofline_time); (c) the
     same widths at 2 layers trained 3 AdamW steps at B1 S2048 on batches
     of utils/data.TokenLoader(native=True) (cpp/dataloader.cpp built by
     g++) over a shard that write_token_file wrote, each batch equal to
     the Python engine's, the losses finite, B1 and B2 launched.
 34. training on a device mesh (parallel/): (a) one NCCL rank
     (initialize_distributed from the variables the phase sets, world
     size 1) on a {data 1, model 1, ctx 1} mesh: the base model's two AdamW
     steps at B4 S2048 bitwise equal to the steps without a mesh; (b) 4
     gloo ranks sharing the card (parallel/launch.py, mesh_rank): ring
     attention at Llama-3-8B's attention width (B1 Hq32 Hkv8 D128, S 32768,
     8192 a rank, bf16; causal and window 4096) forward and gradients
     against flash_attention on the whole sequence (B1's and B2-B4's gates
     of the output's max), with the last live rotation dropped and dK/dV
     not sent home as controls that must fail; the quantized ring (int8,
     int4, e4m3) against B7 on the whole sequence (B1's gate) and against
     the bf16 ring (a mean relative error per storage), each with the ring
     without its own shard's step as the control; the base model trained
     one AdamW step on {ctx 4} (8192 inputs) and on {data 2, model 2} (B4
     S2048) beside the unsharded step; fp32 parity at 2 layers on both
     layouts (loss and grad_norm rtol 2e-4, each gradient leaf 2e-4 of its
     max, every parameter 1e-4) with controls; the scaling benchmark's
     three layouts (4 ranks on one card, not multi-GPU scaling).  The
     ranks' launches of B1, B1 windowed,
     B2, B3, B4 and B7 are summed into the kernel line ("launches_mesh").
     Serving on the mesh (decode/sharded.py, DecodeEngine(mesh=)): (a)'s
     rank serves the base model on its mesh with CUDA graphs captured,
     tokens, logprobs and prefill logits bitwise equal to the engine
     without a mesh; (b)'s ranks serve Llama-3-8B's widths (seeded random
     weights): fp32 parity at 2 layers on {model 4} and {data 2, model 2}
     (4 prompts, one prefilled in chunks, greedy; and on {data 2, model 2}
     with a 1-layer draft at spec 2) against the engine without a mesh,
     tokens equal and every
     decode step's and verification's logits within MESH_SERVE_LOGIT_TOL
     of their max, each layout with a control that must fail both (the
     all-reduce after wo left out; query heads on the wrong KV heads);
     bf16 weights on an int8 cache at 4 layers on {model 4}: tokens/s and
     TPOT (4 gloo ranks on one card, eager steps: not multi-GPU tensor
     parallelism).  Their B1 (or B8), B5 and B6 launches go into the
     kernel line ("launches_mesh_serving").  Pipeline and expert
     parallelism in the same 4 ranks (mesh_pp_ep): (f) Llama-3-8B's widths
     at 4 layers trained by make_pp_train_step on {pipe 4} and {pipe 2,
     model 2} (B4 S1024, 4 microbatches): finite, falling losses, the
     first and last stages' weights moved; (g) the pipeline's fp32 parity
     at the base width on {pipe 4} against the unsharded model forwarded
     over all S tokens, with a dropped shift as the control; (h)
     Mixtral-8x7B's widths served on {expert 4} and {expert 2, model 2}:
     fp32 parity at 2 layers against the engine without a mesh (tokens,
     logits; one rank's experts zeroed as the control) and bf16 weights on
     an int8 cache at 8 layers timed beside rank 0's engine without a
     mesh; (i) Mixtral's widths trained at 1 layer (B1 S2048, AdamW) on
     both meshes and a small-width 8-expert model's fp32 parity (the
     expert outputs' gradient summed over "expert" as the control).  Their
     launches are also in the kernel line apart ("launches_mesh_pipeline",
     "launches_mesh_expert_training", "launches_mesh_expert_serving").
Serving's decode steps run as CUDA graphs (decode/graphs.py); each
wrapper's launch count adds what a capture recorded at every replay.
The line before the last is the kernel JSON (eleven kernels; B1, B5, B6 and
B8 each with its windowed row and windowed launches under "window", B2, B3
and B4 with phase 26's windowed and segmented rows under "window" and
"segments", B8 with its segmented row; B1-B4 and B8 with
"launches_window" and "launches_segments"; B1's segmented row under
"segments"; B1-B10 with their D 32 and D 256 rows under "d32" and "d256",
the launches of those widths on their paths beside them; B5 and B6 with
their fp32-cache D 256 rows under "d256_fp32_cache"; B1-B6 with their
launches on phase 32's MoE paths under "launches_moe_serving" and
"launches_moe_training", and B1, B2, B5 and B6 with their checks at
the Mixtral path's shapes under "mixtral_shapes"; B1, B5 and B6 with their
launches on phase 33's Llama-3-8B-width serving under
"launches_llama3_serving", B1 and B2 on its training under
"launches_llama3_training", B1 and B6 on its MoE speculation under
"launches_moe_speculation"; B1-B4 and B7 with phase 34's under
"launches_mesh", B1's windowed ones under "launches_mesh_window"; B1,
B5, B6 and B8 with phase 34's serving ones under "launches_mesh_serving"); the
last line is the JSON contract line {"ok": true, "device": {...}}.
It imports torch and the port only, never jax or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
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
# Phase 28's B5/B6 rows also hold each slot to its own max |O|: at 6000
# keys a slot's outputs are ~0.1, so the absolute gate alone would let one
# page of its walk be read wrong (plain versions on the CPU, D 256: 0.02).
SLOT_REL_TOL = B5_TOL
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
FP32_FUNCTIONS = {"baselines": (("naive_fa2_fp32", "fa1_fp32"), 4),
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
# over the stored-width ring (fp32 compute, with and without segment ids),
# 4 storages x 2 q types x D 64 and 128 (x 2 for the FMA block).
B7_FUNCTIONS = (("fa2_fwd_quant_wgmma", "fa2_fwd_quant_fp32"), 48)
# The libraries of head dims 32 and 256 (csrc/<name>_d32.cu, _d256.cu):
# B1's wgmma body (2 input types x 2 tile types) and fp32 body (with and
# without ids); B5 and B6 over their six caches (the fp32 cache's too at
# D 256) x 2 q types x (B5) groups of at most 2 and 8 or (B6) the split
# body's two compute types, the bf16 and the fp32 tile body; B9 and B10
# (one each); B8's mma body (2 input types x 2 tile types) and fp32 body,
# each with and without ids; B7's wgmma body (4 storages x 2 q types) and
# fp32 body (the same, with and without ids).
B1_WIDE_FUNCTIONS = (("fa2_fwd_wgmma", "fa2_fwd_fp32"), 6)
WIDE_FUNCTIONS = {
    "fa2_forward_d32": B1_WIDE_FUNCTIONS, "fa2_forward_d256": B1_WIDE_FUNCTIONS,
    "paged_decode_d32": (("paged_decode_kernel",), 24),
    "paged_decode_d256": (("paged_decode_kernel",), 24),
    "paged_chunk_d32": (("paged_chunk_split", "paged_chunk_mma", "paged_chunk_fp32"), 48),
    "paged_chunk_d256": (("paged_chunk_split", "paged_chunk_mma", "paged_chunk_fp32"), 48),
    **{f"baselines_d{d}": (("fa1_fp32", "naive_fa2_fp32"), 2) for d in (32, 256)},
    **{f"fa2_forward_small_d{d}": (("small_mma", "small_fp32"), 10) for d in (32, 256)},
    **{f"fa2_forward_quant_d{d}": (("fa2_fwd_quant_wgmma", "fa2_fwd_quant_fp32"), 24)
       for d in (32, 256)},
}
# The backward's libraries of head dims 32 and 256 (csrc/fa2_backward_d32.cu,
# _d256.cu): per input type (bf16, fp32) and 16-bit tile type (bf16, fp16)
# the prologue, B2's and B4's KV-major kernel (at D 256 bwd_fused_wgmma_wide)
# and B3's; the fp32 prologue, B2's and B4's fp32 body (at D 256
# bwd_kv_fp32_wide) and B3's; B2's dQ reduce (two output types).
BWD_WIDE_FUNCTIONS = (("bwd_fused_wgmma", "bwd_dq_wgmma", "bwd_prologue", "dq_reduce",
                       "bwd_kv_fp32", "bwd_dq_fp32"), 22)
WIDE_BWD_LIBRARIES = ("fa2_backward_d32", "fa2_backward_d256")


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


# Every source, the longest compiles first (by their measured nvcc seconds),
# so that no core idles while the last long one runs.
BUILD_ORDER = ("paged_chunk", "fa2_forward_quant", "fa2_backward", "paged_chunk_d256",
               "fa2_forward_quant_d256", "fa2_forward_quant_d32", "fa2_backward_d256",
               "fa2_backward_d32", "paged_chunk_d32", "paged_decode", "fa2_forward_small",
               "fa2_forward", "fa2_forward_small_d256", "fa2_forward_small_d32",
               "paged_decode_d256", "paged_decode_d32", "fa2_forward_d256",
               "fa2_forward_d32", "r5_d128_fwd", "baselines", "baselines_d256",
               "baselines_d32")


def phase_build(_build) -> dict:
    """Phase 1's build and ptxas gates: every source of BUILD_ORDER built in
    parallel, then every gated instantiation's registers, spills and wgmma
    notes.  Returns the new builds' compiler logs by source."""
    t0 = time.perf_counter()
    build_logs = _build.build(*BUILD_ORDER)
    log(f"phase 1: built {sorted(build_logs)} in {time.perf_counter() - t0:.1f} s; "
        f"each source's nvcc seconds: "
        f"{json.dumps({n: round(t, 1) for n, t in sorted(_build.BUILD_SECONDS.items())})}")
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
    for name, (functions, count) in WIDE_FUNCTIONS.items():
        check_ptxas(build_logs.get(name) or ptxas_log(_build, name), name, functions,
                    count)
    for name in WIDE_BWD_LIBRARIES:
        check_ptxas(build_logs.get(name) or ptxas_log(_build, name), name,
                    *BWD_WIDE_FUNCTIONS)
    return build_logs


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
    """Base width in fp32, cut to 1 layer: CUDA (kernels) against CPU
    (plain versions)."""
    cfg = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=1)
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



def phase_profile(torch, np, eng, label="profile", new_tokens=24, steps=5):
    """Where a decode step's time goes: eight running requests, `steps`
    steps (speculative rounds, for a speculative engine; bursts, for a
    bursting one: `new_tokens` keeps them busy through the window) under
    torch.profiler (utils/profiling.trace), timed on the host clock over the
    same window (so the step time includes the profiler's own host
    overhead).  `lengths` are the slots' cached lengths as the window
    starts."""
    from cuda_flash_attention_tpu_torch.utils import profiling

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, eng.cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1501, eng.max_seqs)]
    reqs = eng.submit_many(prompts, max_new_tokens=new_tokens)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    tokens0 = eng.stats["tokens"]
    lengths = [int(n) for n in eng.lengths[eng.active]]
    t = profiling.trace(eng.step, iters=steps, warmup=0)
    step_ms = t.wall_ms / steps
    busy_ms = t.busy_ms
    # The host's launch calls: kernels launched one by one, and graph
    # replays (each one launch of a whole captured step).
    host_calls = {o.name: o.count / steps for o in t.ops
                  if "LaunchKernel" in o.name or "GraphLaunch" in o.name}
    # B5's and B6's kernels (csrc/paged_decode.cu, csrc/paged_chunk.cu) and
    # their shares of the busy time.
    b5_ms, b6_ms = (sum(k.total_ms for k in t.kernels if name in k.name) / steps
                    for name in ("paged_decode_kernel", "paged_chunk_"))
    res = dict(
        batch=len(reqs), decode_step_ms=step_ms,
        tokens_per_step=(eng.stats["tokens"] - tokens0) / steps,
        device_busy_ms_per_step=busy_ms,
        device_idle_share=1 - busy_ms / step_ms,
        kernel_launches_per_step=sum(k.count for k in t.kernels) / steps,
        host_launch_calls_per_step=sum(host_calls.values()),
        host_launch_calls=host_calls,
        b5_ms_per_step=b5_ms, b5_share_of_busy=b5_ms / busy_ms,
        b6_ms_per_step=b6_ms, b6_share_of_busy=b6_ms / busy_ms,
        top_kernels_ms_per_step={k.name[:48]: k.total_ms / steps
                                 for k in t.kernels[:8]},
        lengths=lengths)
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
                       tokens_shape=(2, 129), cfg=None, n_layers=2, **cfg_kw):
    """One AdamW step at the base width in fp32, cut to `n_layers` layers:
    card (kernels) against CPU (plain versions).  The first Adam moment is
    (1 - b1) times the clipped gradient, so it holds each gradient leaf to
    the tolerance; the global gradient norm, taken before clipping, is held
    on its own.  cfg_kw: the configuration's window, global_every and sinks
    (phase 26 (d)); `cfg` another fp32 configuration in place of the base
    one (phase 30)."""
    if cfg is None:
        cfg = dataclasses.replace(transformer.TransformerConfig.base(
            dtype=torch.float32, attn_tile_dtype=None, **cfg_kw), n_layers=n_layers)
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


def phase_train_profile(torch, state, step, tokens, label="train profile",
                        by_source=False):
    """Where a train step's time goes (phase 10 at B4 S2048, phase 30 at
    the Gemma-2 widths, phase 32 at Mixtral's): one step under
    torch.profiler (utils/profiling.trace), timed on the host clock over
    the same window; device time by kind and by part of the step.  With
    `by_source`, one more line: the top 10 kernels, each with the ops that
    launched it (the outermost op or range around its launch and the
    innermost op)."""
    from cuda_flash_attention_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    t = profiling.trace(lambda: step(state, tokens)[1]["loss"].item(), iters=1,
                        warmup=0)
    by_kind = {"attention (this port's kernels)": 0.0, "matmul (cuBLAS)": 0.0,
               "other (elementwise, reductions, copies)": 0.0}
    for k in t.kernels:
        if any(n in k.name for n in ("fa2_fwd_", "bwd_kv_", "bwd_dq_",
                                     "bwd_fused_wgmma", "bwd_prologue",
                                     "dq_reduce")):
            kind = "attention (this port's kernels)"
        elif any(n in k.name for n in ("nvjet", "gemm", "cutlass")):
            kind = "matmul (cuBLAS)"
        else:
            kind = "other (elementwise, reductions, copies)"
        by_kind[kind] += k.total_ms
    # The step's parts by the ops around each launch: the forward and loss
    # and the AdamW update (models/training.py's two ranges), the backward
    # (autograd's thread).
    by_part = {"forward and loss": 0.0, "backward": 0.0,
               "AdamW update and grad norm": 0.0, "other": 0.0}
    for chains in t.sources.values():
        for chain, ms in chains:
            part = ("forward and loss" if chain.startswith("train_step.value_and_grad")
                    else "AdamW update and grad norm"
                    if chain.startswith("train_step.update")
                    else "backward" if chain.startswith("autograd::engine")
                    else "other")
            by_part[part] += ms
    res = dict(step_ms=t.wall_ms, device_busy_ms=t.busy_ms,
               device_idle_share=1 - t.busy_ms / t.wall_ms,
               kernel_launches=sum(k.count for k in t.kernels),
               device_ms_by_kind=by_kind, device_ms_by_part=by_part,
               top_kernels_ms={k.name[:48]: k.total_ms for k in t.kernels[:10]})
    log(label, json.dumps(res))
    if by_source:
        res["top_kernels_by_source"] = [
            dict(kernel=name[:64], ms=ms, share_of_busy=ms / t.busy_ms, op=op)
            for name, ms, op in t.top(10)]
        log(f"{label} by source op", json.dumps(res["top_kernels_by_source"]))
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
    """fp32 at base width, cut to 2 layers: verify_step on the card against
    the CPU, then speculative greedy, a prefix-cache hit and chunked
    prefill each against the card's plain greedy tokens.  The path's chunks
    of more than 64 rows run B6's fp32 tile body: its launches are counted
    over the phase."""
    reset_counts(["paged_chunk_fp32_tile"])
    cfg = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=2)
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
    new_tokens = 4
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
            phase_profile(torch, np, eng, "spec profile (draft, k 4)",
                          new_tokens=32, steps=2)
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


CLI_RUNS = tuple((p, m) for p in ("fp32", "fp16", "bf16")
                 for m in ("forward", "backward", "forward_backward"))


def phase_cli(torch, np, cli, io, reference, build_dir, shape=(8, 16, 2048, 64),
              runs=CLI_RUNS, methods=("fa1", "fa2-naive", "naive"),
              edge=(8, 16, 100, 64), in_subprocess=True, seed=17):
    """The CLI end to end on a numpy-seeded data directory of `shape`
    (Stress-1 by default): fa2 in `runs` (every mode and precision), `methods`
    forward in fp32, fa2 forward on an `edge` directory (Edge-NonPowerOf2,
    which must take B8); with `in_subprocess`, one run as `python -m
    cuda_flash_attention_tpu_torch.cli` in a subprocess.  Every written file
    is held to the fp32 oracle."""
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

        rng = np.random.default_rng(seed)
        stress = [rng.random(shape, dtype=np.float32) for _ in range(3)]
        ref = oracle(stress, chunked=True)
        outputs = {"forward": ("O.bin", "logsumexp.bin"),
                   "backward": ("dQ.bin", "dK.bin", "dV.bin"),
                   "forward_backward": ("O.bin", "logsumexp.bin", "dQ.bin",
                                        "dK.bin", "dV.bin")}
        paths = {}
        sub = None
        if in_subprocess and ("fp32", "forward") in runs:
            # fp32 forward once more through `python -m`, in a directory of
            # its own, started first so that its start-up overlaps the runs
            # below (backward reads the forward's files from its directory).
            paths["subprocess"] = data_dir("subprocess", stress)
            sub = subprocess.Popen(
                [sys.executable, "-m", "cuda_flash_attention_tpu_torch.cli", "fa2",
                 "forward", "fp32", paths["subprocess"]], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=root))
        try:
            for precision, mode in runs:
                if precision not in paths:
                    paths[precision] = data_dir(precision, stress)
                path = paths[precision]
                if cli.main(["fa2", mode, precision, path]) != 0:
                    raise AssertionError(f"cli fa2 {mode} {precision}: non-zero exit")
                check(path, ref, outputs[mode], precision, f"fa2 {mode} {precision}",
                      mode)
            if sub is not None:
                stdout, stderr = sub.communicate(timeout=600)
                if sub.returncode != 0:
                    raise AssertionError(f"cli subprocess: {sub.returncode}\n"
                                         f"{stdout}\n{stderr}")
                log("cli subprocess:", stdout.strip().splitlines()[-1])
                check(paths["subprocess"], ref, outputs["forward"], "fp32",
                      "fa2 forward fp32 (python -m)")
        finally:
            if sub is not None and sub.poll() is None:
                sub.kill()
                sub.wait()
        # fp16 files against fp16's own gates, the bf16 run's same file as
        # the control.
        for (precision, mode, name), err in rel.items():
            if precision == "fp16" and name != "logsumexp.bin":
                fp16_gate(f"cli fa2 {mode} {name} {io.data_dir_name(*shape)}", err,
                          rel[("bf16", mode, name)], CLI_FP16_REL_TOL[name])
        for method in methods:
            path = data_dir(method, stress)
            if cli.main([method, "forward", "fp32", path]) != 0:
                raise AssertionError(f"cli {method}: non-zero exit")
            names = ("O.bin", "logsumexp.bin") if method == "naive" else ("O.bin",)
            if os.path.exists(os.path.join(path, "logsumexp.bin")) != (method == "naive"):
                raise AssertionError(f"cli {method}: logsumexp.bin written wrongly")
            check(path, ref, names, "fp32", f"{method} forward fp32")
        del ref
        if edge is not None:
            arrays = [rng.random(edge, dtype=np.float32) for _ in range(3)]
            path = data_dir("edge", arrays)
            small = "fa2_forward_small" + ("" if edge[3] in (64, 128) else f"_d{edge[3]}")
            before = launch_counts()[small]
            if cli.main(["fa2", "forward", "fp32", path]) != 0:
                raise AssertionError("cli edge: non-zero exit")
            if launch_counts()[small] == before:
                raise AssertionError(f"cli edge {edge}: B8 ({small}) never ran")
            check(path, oracle(arrays, chunked=False), outputs["forward"], "fp32",
                  f"fa2 forward fp32 Edge-NonPowerOf2 D{edge[3]}")
    worst = max(checked, key=lambda c: c["max_abs_err"] / c["tol"])
    log("cli", json.dumps(dict(data=io.data_dir_name(*shape), files_checked=len(checked),
                               worst=worst)))
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
    slots, 32 greedy tokens) on an int8 cache (the control), (a) an e4m3
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
    new_tokens = 6
    res = {}
    for name, p, cache, kw in modes:
        eng = decode.DecodeEngine(p, cfg, max_seqs=8, max_seq_len=2048,
                                  cache_dtype=cache, **kw)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        reqs = eng.run(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        need = (("paged_chunk", "paged_decode") if kw
                else ("fa2_forward", "paged_decode"))
        check_served(f"quant serving {name}", reqs, eng, launches, need,
                     cfg.vocab_size, new_tokens)
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
                                                 "quant profile (int4 weights)",
                                                 steps=2)
        del eng
    del params, w8a8, w4
    torch.cuda.empty_cache()

    # (b) + (d) in fp32 at base width, cut to 1 layer: the card against
    # the CPU.
    cfg32 = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=1)
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
    b, p, gen = 16, 128, 16
    out = {}
    reset_counts(SERVING_KERNELS)
    loop = decode_bench.measure_decode_throughput(cfg, batch=b, prompt_len=p,
                                                  gen_tokens=gen, repeats=1)
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

    # Phase 5's 12 requests at bursts 1 and 8: the same tokens (32 new
    # tokens each).
    served, served_new = {}, 6
    for burst in (1, 8):
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                                  decode_burst=burst)
        torch.cuda.synchronize()
        reset_counts(SERVING_KERNELS)
        t0 = time.perf_counter()
        reqs = eng.run(serving_mix(np, cfg), max_new_tokens=served_new)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counts(SERVING_KERNELS)
        check_served(f"bench serving burst {burst}", reqs, eng, launches,
                     ("fa2_forward", "paged_decode"), cfg.vocab_size, served_new)
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
                                                  new_tokens=8 * 8 + 1, steps=2)
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
    train = train_bench.measure_train_throughput(cfg, 4, 2048, iters=2, repeats=1)
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
    new_tokens = 8
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
    tokens on every layer) at base width in fp32, cut to 2 layers, card
    against CPU, greedy
    tokens bitwise equal: engine decode, speculation (k 3, a one-layer
    windowed draft) and chunked prefill (chunk 512, a 1300-token prompt).
    The sink page must still be resident when each request ends."""
    cfg = dataclasses.replace(
        transformer.TransformerConfig.base(dtype=torch.float32, attn_tile_dtype=None),
        attn_window=512, attn_sinks=SINKS, n_layers=2)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    rng = np.random.default_rng(27)
    short = rng.integers(0, cfg.vocab_size, 900).tolist()
    long = rng.integers(0, cfg.vocab_size, 1300).tolist()
    n_new = 6
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
    configurations train 4 AdamW steps each on one batch of B4 S2048 bf16:
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
        for _ in range(3):
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


# Phase 27: a Gemma-2-2B-width hybrid model served at head_dim 256.  The
# widths of google/gemma-2-2b's published config.json; the weights random
# from a seed.  What the JAX package's block cannot express of Gemma-2 is
# listed, not emulated.
GEMMA2_2B = dict(d_model=2304, n_layers=26, n_heads=8, n_kv_heads=4, head_dim=256,
                 d_ff=9216, vocab_size=256000, rope_theta=10000.0, attn_window=4096,
                 global_every=2)
GEMMA2_NOT_EXPRESSED = ("SwiGLU stands in for GeGLU",
                        "no attention or final logit soft-capping",
                        "no post-attention and post-FFN norms", "no embedding scale")
D256_KERNELS = ("fa2_forward_d256", "fa2_forward_d256_window", "paged_decode_d256",
                "paged_decode_d256_window", "paged_chunk_d256", "paged_chunk_d256_window")
# Those phase 27 must launch.  B1's windowed launches there are 0 by design:
# under chunked prefill B1 runs only a prompt's first chunk, whose 512 rows
# the 4096 window covers, so the API folds the window away (as JAX's
# _normalize_window does); phase 28 runs B1's windowed D 256 instantiation.
D256_NEED = tuple(n for n in D256_KERNELS if n != "fa2_forward_d256_window")


def d256_launches(launches) -> dict:
    """B1's, B5's and B6's launches at D 256, windowed and global."""
    return {n: dict(windowed=launches[f"{n}_d256_window"],
                    global_=launches[f"{n}_d256"] - launches[f"{n}_d256_window"])
            for n in SERVING_KERNELS}


def phase_gemma2_serving(torch, np, transformer, decode, dataclasses):
    """The Gemma-2-2B-width hybrid configuration (head_dim 256, GQA 8/4, a
    4096-token window on the even layers, the odd ones global; bf16 weights)
    served on an int8 cache, 8 slots, CUDA-graph decode: 12 requests (8
    prompts of 64-1500 tokens, 4 of 4500-6000 so that the local group
    recycles past the window), chunked prefill 512, 8 greedy tokens each.
    After every step no decoding slot's local group holds more pages than
    the window's live bound; B1's, B5's and B6's launches at D 256 must be
    > 0, B5's and B6's windowed ones too (D256_NEED)."""
    cfg = transformer.TransformerConfig(param_dtype=torch.bfloat16, **GEMMA2_2B)
    log("gemma2 config", json.dumps(dict(GEMMA2_2B, q_dim=cfg.q_dim,
                                         not_expressed=GEMMA2_NOT_EXPRESSED)))
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(64, 1501, 8)]
    for i, n in zip((1, 4, 7, 10), rng.integers(4500, 6001, 4)):
        prompts.insert(i, rng.integers(0, cfg.vocab_size, int(n)).tolist())
    new_tokens = 8
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=6144,
                              page_size=128, cache_dtype=torch.int8, prefill_chunk=512)
    bound = eng._worst_pages_for(1, 1 << 20)[0]
    peak_total, peak_slot = [0, 0], [0, 0]
    names = SERVING_KERNELS + D256_KERNELS
    torch.cuda.synchronize()
    reset_counts(names)
    t0 = time.perf_counter()
    reqs = eng.submit_many(prompts, max_new_tokens=new_tokens)
    while any(not r.done for r in reqs) or eng._pending:
        eng.step()
        for g in range(eng.n_groups):
            live = [eng._live_page_count(s, g) for s in range(eng.max_seqs)]
            peak_total[g] = max(peak_total[g], sum(live))
            peak_slot[g] = max(peak_slot[g], max(live))
            if g == 0 and any(live[s] > bound for s in np.flatnonzero(eng.active)):
                raise AssertionError(f"gemma2: a decoding slot's local group holds "
                                     f"{live} pages (bound {bound})")
    eng.step()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(names)
    check_served("gemma2", reqs, eng, launches, D256_NEED, cfg.vocab_size, new_tokens)
    for a in eng._group_allocs:
        if a.available != eng.num_pages - 1:
            raise AssertionError("gemma2: a group's pages leaked")
    if peak_slot[0] >= peak_slot[1]:
        raise AssertionError(f"gemma2: the local group's peak {peak_slot[0]} pages a "
                             f"slot is not below the global group's {peak_slot[1]}")
    total = sum(len(r.generated) for r in reqs)
    res = dict(config="gemma-2-2b widths, w4096 global_every 2, D256", requests=len(reqs),
               tokens=total, seconds=elapsed, tokens_per_s=total / elapsed,
               tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
               ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
               steps=eng.stats["steps"], prefill_chunks=eng.stats["prefill_chunks"],
               local_bound_pages=bound, peak_live_pages_local=peak_total[0],
               peak_live_pages_global=peak_total[1], peak_slot_pages_local=peak_slot[0],
               peak_slot_pages_global=peak_slot[1], prompt_lens=[len(p) for p in prompts],
               d256_launches=d256_launches(launches), launches=launches,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("gemma2 hybrid serving", json.dumps(res))
    del eng, params
    torch.cuda.empty_cache()
    return res


FP32_D256_KERNELS = ("paged_decode_d256", "paged_chunk_d256")


def phase_gemma2_parity(torch, np, transformer, decode, dataclasses):
    """The Gemma-2-2B widths at 2 layers (the local one and a global one) in
    fp32 on an int8 cache and on an fp32 cache (B5 and B6 at D 256 on
    fp32 pages), card against CPU: greedy tokens equal over two
    prompts below the window (8 new tokens each); speculation and prefix
    caching refused on the hybrid cache, as the JAX engine refuses them.
    The fp32 cache's runs chunk the prefill (128), and B5's and B6's D 256
    launches on the card are returned."""
    cfg = transformer.TransformerConfig(dtype=torch.float32, attn_tile_dtype=None,
                                        **dict(GEMMA2_2B, n_layers=2))
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg, device="cuda")
    rng = np.random.default_rng(28)
    # The fp32 cache's prompts prefill in 2 and 4 chunks of at most 128.
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (200, 400)]
    out = {}
    for dev in ("cuda", "cpu"):
        p = transformer.tree_map(lambda w: w.to(dev), params)
        if dev == "cpu":
            for kw in (dict(prefix_cache=True), dict(spec_tokens=2)):
                try:
                    decode.DecodeEngine(p, cfg, max_seqs=2, max_seq_len=1024,
                                        cache_dtype=torch.int8, device=dev, **kw)
                except NotImplementedError:
                    continue
                raise AssertionError(f"gemma2: the hybrid cache took {kw}")
        for cache in (torch.int8, torch.float32):
            # The fp32 cache's run chunks its prefill, so that B6 reads it.
            chunk = 128 if cache == torch.float32 else None
            eng = decode.DecodeEngine(p, cfg, max_seqs=2, max_seq_len=1024,
                                      cache_dtype=cache, device=dev, prefill_chunk=chunk)
            reset_counts(FP32_D256_KERNELS)
            out[dev, cache] = [r.generated for r in eng.run(prompts, max_new_tokens=8)]
            if dev == "cuda" and cache == torch.float32:
                launches = read_counts(FP32_D256_KERNELS)
            del eng
        del p
    for cache in (torch.int8, torch.float32):
        if out["cuda", cache] != out["cpu", cache]:
            raise AssertionError(f"gemma2 fp32, {cache} cache: card tokens "
                                 f"{out['cuda', cache]} vs CPU {out['cpu', cache]}")
    res = dict(equal=True, int8_cache_tokens=out["cuda", torch.int8],
               fp32_cache_tokens=out["cuda", torch.float32],
               fp32_cache_launches=launches)
    log("gemma2 fp32 2 layers (card vs CPU)", json.dumps(res))
    if not all(launches.values()):
        raise AssertionError(f"gemma2 fp32 cache: B5 or B6 never ran: {launches}")
    del params
    torch.cuda.empty_cache()
    return res


# Phase 28: every new instantiation against its plain version.  B1 at D 32
# (B4 Hq16 Hkv8 S2048) and D 256 (B1 Hq8 Hkv4 S4096, the Gemma-2 prefill's
# heads), in bf16 tiles, fp16 tiles (fp32 inputs) and fp32, under four
# masks; B5 and B6 (T 5: the split body; T 512: the bf16 and fp32 tile
# bodies) at D 32 and 256 on int8, int4, e4m3 and bf16 caches; B7 with a
# window (160) and with 2 segments, at the base attention shape.
WIDE_B1_SHAPES = {32: (4, 16, 8, 2048), 256: (1, 8, 4, 4096)}
WIDE_B1_MASKS = ("causal", "window 128 sinks 4", "band -100", "4 documents")
WIDE_CACHES = ("int8", "int4", "e4m3", "bf16")
# (name, T, lengths, compute): B5 at the Gemma serving shape's lengths, B6's
# speculation and chunked-prefill lengths.
WIDE_PAGED = (("B5", 1, [6000, 1, 129, 0, 777, 1500, 128, 4500], "bf16"),
              ("B6 T5", 5, B6_SPEC_LENGTHS, "bf16"),
              ("B6 T512", 512, B6_PREFILL_LENGTHS, "bf16"),
              ("B6 T512 fp32", 512, B6_PREFILL_LENGTHS, "fp32"))
# An fp32 cache at D 256, every body: B5 and B6's split body
# in fp32 compute as well (the card-against-CPU path), the bf16 tile body
# (T 512 bf16) and the fp32 one.
WIDE_FP32_PAGED = (WIDE_PAGED[0][:3] + ("fp32",), WIDE_PAGED[0],
                   WIDE_PAGED[1][:3] + ("fp32",), *WIDE_PAGED[1:])


def wide_mask_kw(torch, mask, b, s, control=False, device="cuda"):
    """B1's keyword arguments for one of WIDE_B1_MASKS (ids as the kernels
    take them, [B, S] int32, on `device`); with `control`, the mask one key
    off: the window one wider, the band's offset one less negative, the ids
    shifted by one token, causal dropped."""
    if mask == "causal":
        return dict(causal=not control, window=None, sinks=0)
    if mask.startswith("window"):
        return dict(causal=True, window=128 + control, sinks=4)
    if mask.startswith("band"):
        return dict(causal=False, window=-100 + control, sinks=0)
    ids = (torch.arange(s, device=device) * 4 // s).to(torch.int32).expand(b, s)
    if control:
        ids = torch.roll(ids, 1, dims=1)
    return dict(causal=True, window=None, sinks=0, q_seg=ids.contiguous(),
                kv_seg=ids.contiguous())


def phase_wide_b1(torch, F, attention, fa2, common):
    """B1 at D 32 and 256 against its plain version under WIDE_B1_MASKS in
    each tile body; controls (the mask one key off; the bf16 instantiation
    for fp16 tiles) must fail the gate; device time beside the
    kept-pair bound and SDPA on the same inputs (causal by its flag, the
    other masks as a boolean attn_mask)."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    rows = []
    for d, (b, hq, hkv, s) in WIDE_B1_SHAPES.items():
        raw = [torch.randn(b, h, s, d, generator=gen, device="cuda")
               for h in (hq, hkv, hkv)]
        scale = d ** -0.5
        for mask in WIDE_B1_MASKS:
            mkw = wide_mask_kw(torch, mask, b, s)
            keep = common.build_element_mask(
                s, s, causal=mkw["causal"], kv_len=s, device="cuda",
                window=mkw["window"], sinks=mkw["sinks"], q_seg=mkw.get("q_seg"),
                kv_seg=mkw.get("kv_seg"))
            pairs = int(keep.sum().item()) * (b if keep.ndim == 2 else 1)
            for kind in ("bf16", "fp16", "fp32"):
                tile = tile_of(torch, kind)
                q, k, v = (t.to(torch.bfloat16) if kind == "bf16" else t for t in raw)
                kw = dict(mkw, sm_scale=scale, kv_len=s, tile_dtype=tile)
                o_k, lse_k = fa2.fa2_forward_aligned(q, k, v, **kw)
                o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (o_k.float() - o_p.float()).abs().max().item()
                lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)
                label = f"B1 D{d} {mask} {kind}"
                if kind == "fp16":
                    o_c, _ = fa2.fa2_forward_aligned(q, k, v, **dict(kw, tile_dtype=torch.bfloat16))
                    control_err = rel_err(o_c, o_p)
                    fp16_gate(label, rel_err(o_k, o_p), control_err, FP16_REL_TOL["B1"])
                    err_ok = True
                else:
                    ckw = dict(kw, **wide_mask_kw(torch, mask, b, s, control=True))
                    o_c, _ = fa2.fa2_forward_plain(q, k, v, **ckw)
                    control_err = (o_k.float() - o_c.float()).abs().max().item()
                    tol = B1_TOL[kind]
                    err_ok = err <= tol
                    if control_err <= tol:
                        raise AssertionError(f"{label}: the control passes the gate "
                                             f"({control_err} <= {tol})")
                if not (err_ok and lse_err <= LSE_REL_TOL and dead_equal):
                    raise AssertionError(f"{label}: max_abs_err {err}, lse rel err "
                                         f"{lse_err}, dead rows equal {dead_equal}")
                lib_in = [t.to(tile or torch.float32) for t in (q, k, v)]
                # SDPA: causal by its flag (its flash kernel), the other
                # masks as a boolean attn_mask.
                sdpa_kw = (dict(is_causal=True) if mask == "causal" else dict(
                    attn_mask=keep if keep.ndim == 2 else keep.expand(b, hq, s, s)))
                flops = 4 * hq * pairs * d
                t_bytes = nbytes(q, k, v, o_k, lse_k) / HBM_BYTES_PER_S
                t_ops = flops / PEAK_FLOPS[kind]
                ms = time_ms(lambda: fa2.fa2_forward_aligned(q, k, v, **kw), iters=10)
                row = dict(kernel="fa2_forward", case=f"D{d} {mask}", kind=kind, B=b,
                           Hq=hq, Hkv=hkv, S=s, D=d, max_abs_err=err, lse_rel_err=lse_err,
                           control_max_abs_err=control_err, ms=ms,
                           plain_ms=time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw),
                                            iters=1, warmup=1),
                           library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                               *lib_in, scale=scale, enable_gqa=True, **sdpa_kw),
                               iters=1, warmup=1),
                           bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes > t_ops else "operations",
                           tflops=flops / ms / 1e9)
                rows.append(row)
                log("wide B1", json.dumps(row))
                del o_k, lse_k, o_p, lse_p, o_c, lib_in
            del keep
        del raw
        torch.cuda.empty_cache()
    return rows


def wide_pages(torch, kv_cache, gen, cache, shape):
    """A paged cache of one of WIDE_CACHES (or fp32) from random rows,
    written by the cache's own quantizer (bf16 and fp32: the rows in that
    type, unit scales)."""
    if cache in ("bf16", "fp32"):
        return random_pages(torch, kv_cache, gen, cache, shape)
    return quant_pages(torch, kv_cache, gen, cache, shape)


def slot_rel_err(torch, o_k, o_p) -> float:
    """The largest over slots (dim 0) of max |o_k - o_p| / max |o_p|; a
    slot whose plain output is all 0 (no key) is held to 0 exactly."""
    diff = (o_k.float() - o_p.float()).abs().flatten(1).amax(1)
    scale = o_p.float().abs().flatten(1).amax(1)
    rel = torch.where(scale > 0, diff / scale.clamp_min(1e-30),
                      torch.where(diff > 0, float("inf"), 0.0))
    return rel.max().item()


def phase_wide_paged(torch, dec_attn, kv_cache, cases=None, seed=29):
    """B5 and B6's three bodies at D 32 and 256 on WIDE_CACHES against their
    plain versions, over all outputs (B5_TOL) and slot by slot
    (SLOT_REL_TOL); two controls must each fail that gate: the plain
    version over every length one key short, and over the longest slot's
    middle page read from page 0, which no slot owns (a wrong long walk);
    device time beside the bound.  At D 256 also on an fp32 cache
    (WIDE_FP32_PAGED: each body, fp32 compute held to 2e-5).  `cases`, (D,
    (Hq, Hkv), (name, T, lengths, compute), caches) each, replaces these
    (phase 32 passes the Mixtral path's shapes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    if cases is None:
        cases = [(d, heads, case, WIDE_CACHES) for d, heads in ((32, (16, 8)), (256, (8, 4)))
                 for case in WIDE_PAGED] + [(256, (8, 4), case, ("fp32",))
                                            for case in WIDE_FP32_PAGED]
    for d, (hq, hkv), (name, chunk, lens, compute), caches in cases:
        n, pps = len(lens), -(-max(lens) // 128)
        num_pages = n * pps + 1
        table = (torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
                 ).reshape(n, pps).to(torch.int32).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cdt = torch.bfloat16 if compute == "bf16" else torch.float32
        qshape = (n, hq, d) if chunk == 1 else (n, chunk, hq, d)
        q = torch.randn(qshape, generator=gen, device="cuda").to(cdt)
        kernel_fn, plain_fn = ((dec_attn.paged_decode_attention,
                                dec_attn.paged_decode_attention_plain) if chunk == 1
                               else (dec_attn.paged_chunk_attention,
                                     dec_attn.paged_chunk_attention_plain))
        kw = dict(sm_scale=d ** -0.5, compute_dtype=cdt)
        # The controls: every slot one key short (a slot of length T
        # loses its first row's only key), and the longest slot with its
        # middle page swapped for page 0.
        short = torch.clamp(lengths - 1, min=0)
        longest = max(range(n), key=lambda i: lens[i])
        wrong = table.clone()
        wrong[longest, lens[longest] // 128 // 2] = 0
        for cache in caches:
            pages = wide_pages(torch, kv_cache, gen, cache, (hkv, num_pages, 128, d))
            o_k = kernel_fn(q, pages, table, lengths, **kw)
            o_p = plain_fn(q, pages, table, lengths, **kw)
            o_c = plain_fn(q, pages, table, short, **kw)
            o_w = plain_fn(q, pages, wrong, lengths, **kw)
            torch.cuda.synchronize()
            tol, slot_tol = B5_TOL[compute], SLOT_REL_TOL[compute]

            def errs(o):
                return ((o_k.float() - o.float()).abs().max().item(),
                        slot_rel_err(torch, o_k, o))

            err, slot_err = errs(o_p)
            control_err, control_slot = errs(o_c)
            page_err, page_slot = errs(o_w)
            label = f"{name} D{d} {cache} {compute}"
            if not (err <= tol and slot_err <= slot_tol
                    and torch.isfinite(o_k.float()).all()):
                raise AssertionError(f"{label}: max_abs_err {err} (tol {tol}), "
                                     f"slot rel err {slot_err} (tol {slot_tol})")
            for what, (c_abs, c_slot) in (("one key short", (control_err, control_slot)),
                                          ("wrong page", (page_err, page_slot))):
                if c_abs <= tol and c_slot <= slot_tol:
                    raise AssertionError(f"{label}: the {what} control passes the "
                                         f"gate ({c_abs}, slot rel {c_slot})")
            elem = 0.5 if cache == "int4" else pages.k_pages.element_size()
            bound_ms, bound_by, _, moved = paged_bound(lens, chunk, hq, hkv, d, elem,
                                                       q, o_k, compute)
            ms = queued_ms(torch, lambda: kernel_fn(q, pages, table, lengths, **kw))
            row = dict(kernel="paged_decode" if chunk == 1 else "paged_chunk",
                       case=f"{name} D{d}", T=chunk, D=d, Hq=hq, Hkv=hkv,
                       cache=cache, compute=compute, lengths=lens, max_abs_err=err,
                       slot_rel_err=slot_err, control_max_abs_err=control_err,
                       page_control_slot_rel_err=page_slot, ms=ms,
                       plain_ms=time_ms(lambda: plain_fn(q, pages, table, lengths, **kw),
                                        iters=1, warmup=1),
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       gbps=moved / ms / 1e6)
            rows.append(row)
            log("wide paged", json.dumps(row))
            del pages, o_k, o_p, o_c, o_w
    return rows


def phase_b7_masks(torch, quant, fq):
    """B7 with a causal window of 160 (tests/test_window.py:223's) and with 2
    segments (tests/test_quant.py:144's), at the base attention shape B4
    Hq16 Hkv8 S2048 D64, on int8, int4 and e4m3 K/V in bf16 and fp32
    compute, against its plain version; the control (the window one wider,
    the ids shifted by one token) must fail the gate; device time beside
    the kept-pair bound and the same call without the mask."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    b, hq, hkv, s, d = 4, 16, 8, 2048, 64
    rows = []
    half = torch.cat([torch.zeros(b, s // 2), torch.ones(b, s // 2)], 1).to(
        torch.int32).cuda()
    for storage in ("int8", "int4", "e4m3"):
        for compute in ("bf16", "fp32"):
            cdt = torch.bfloat16 if compute == "bf16" else torch.float32
            _, args, _ = quant_problem(torch, quant, fq, gen, storage, b, hq, hkv, s, d,
                                       cdt)
            base = dict(causal=True, sm_scale=d ** -0.5, kv_len=s, compute_dtype=cdt)
            for mask in ("window 160", "2 segments"):
                if mask.startswith("window"):
                    mkw, ckw = dict(window=160), dict(window=161)
                    pairs = window_pairs(s, s, True, 160, 0) * b
                else:
                    mkw = dict(q_seg=half, kv_seg=half)
                    shifted = torch.roll(half, 1, dims=1).contiguous()
                    ckw = dict(q_seg=shifted, kv_seg=shifted)
                    pairs = 2 * causal_pairs(s // 2, s // 2, True) * b
                kw = dict(base, **mkw)
                o_k, lse_k = fq.fa2_forward_quant_aligned(*args, **kw)
                o_p, lse_p = fq.fa2_forward_quant_plain(*args, **kw)
                o_c, _ = fq.fa2_forward_quant_plain(*args, **dict(base, **ckw))
                torch.cuda.synchronize()
                label = f"B7 {mask} {storage} {compute}"
                err = (o_k.float() - o_p.float()).abs().max().item()
                control_err = (o_k.float() - o_c.float()).abs().max().item()
                lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)
                def passes(o):
                    return (bf16_excess(o_k, o) <= BF16_ATOL["B7"] if compute == "bf16"
                            else (o_k.float() - o.float()).abs().max().item() <= 2e-5)

                if not (passes(o_p) and dead_equal and lse_err <= LSE_REL_TOL):
                    raise AssertionError(f"{label}: max_abs_err {err}, lse {lse_err}")
                if passes(o_c):
                    raise AssertionError(f"{label}: the control passes the gate "
                                         f"({control_err})")
                flops = 4 * hq * pairs * d
                moved = nbytes(*args, o_k, lse_k)
                t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[compute]
                row = dict(kernel="fa2_forward_quant", case=f"B4 S2048 {mask}",
                           storage=storage, compute=compute, max_abs_err=err,
                           control_max_abs_err=control_err,
                           ms=time_ms(lambda: fq.fa2_forward_quant_aligned(*args, **kw),
                                      iters=10),
                           global_ms=time_ms(lambda: fq.fa2_forward_quant_aligned(
                               *args, **base), iters=10),
                           plain_ms=time_ms(lambda: fq.fa2_forward_quant_plain(*args, **kw),
                                            iters=1, warmup=1),
                           library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes > t_ops else "operations")
                rows.append(row)
                log("B7 masks", json.dumps(row))
                del o_k, lse_k, o_p, o_c
            del args
    # Windowed and segmented launches on the public API (its main path).
    reset_counts(("fa2_forward_quant", "fa2_forward_quant_window",
                  "fa2_forward_quant_segments"))
    (q, k_q, v_q), _, _ = quant_problem(torch, quant, fq, gen, "int8", b, hq, hkv, s, d,
                                        torch.bfloat16)
    fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True, window=160)
    fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True, q_segment_ids=half,
                                    kv_segment_ids=half)
    torch.cuda.synchronize()
    launches = read_counts(("fa2_forward_quant", "fa2_forward_quant_window",
                            "fa2_forward_quant_segments"))
    if not (launches["fa2_forward_quant_window"] and launches["fa2_forward_quant_segments"]):
        raise AssertionError(f"B7 masks: the API launched {launches}")
    return rows, launches


# Phase 29: B2, B3 and B4 at D 32 and 256 against their plain versions, at
# phase 28's B1 shapes (D 32 B4 Hq16 Hkv8 S2048, D 256 B1 Hq8 Hkv4 S4096)
# under its four masks, with bf16 tiles, fp16 tiles on fp32 inputs and in
# fp32.  Each gate has a control that must fail it: in fp32 the mask one
# key off, with bf16 tiles one 64-key tile off (one key moves a bf16
# gradient by less than the 5e-2 gate): causal dropped, the window and the
# band narrower (a wider one would revive rows whose lse says they keep no
# key, and the control would read NaN), the ids shifted; for fp16 tiles
# the bf16 instantiation on the same inputs (fp16_gate).
WIDE_BWD_KINDS = ("bf16", "fp16", "fp32")


def wide_bwd_control(torch, mask, b, s, kind, device="cuda"):
    """The control mask of a phase-29 row (see above), ids on `device`."""
    off = 1 if kind == "fp32" else 64
    if mask == "causal":
        return dict(causal=False, window=None, sinks=0)
    if mask.startswith("window"):
        return dict(causal=True, window=128 - off, sinks=4)
    if mask.startswith("band"):
        return dict(causal=False, window=-100 - off, sinks=0)
    ids = (torch.arange(s, device=device) * 4 // s).to(torch.int32).expand(b, s)
    ids = torch.roll(ids, off, dims=1).contiguous()
    return dict(causal=True, window=None, sinks=0, q_seg=ids, kv_seg=ids)


def timed_call(torch, fn):
    """(fn's output, its device ms by CUDA events around one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_wide_bwd(torch, fp32_bwd, fa2, bwd, common):
    """Phase 29: each row a (head dim, mask, tile type) problem: B1 forms O
    and lse, then B2, B3 and B4 against the plain backward (B2's plain
    version, whose dQ, dK and dV B3's and B4's compute too) within BWD_TOL
    (FP16_REL_TOL for fp16 tiles) of each output's max, each control beyond
    its gate; device time (queued) beside the bound over the kept pairs,
    each kernel's plain version's time, and SDPA's backward on the same
    card and inputs: its flash backward under causal masking with 16-bit
    tiles, its memory-efficient backward otherwise (fp32; the other masks
    as its bias).  Returns the rows and the launches of these checks."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    rows = []
    names = tuple(f"{n}_d{d}" for n in BWD_NAMES for d in (32, 256))
    reset_counts(names)
    for d, (b, hq, hkv, s) in WIDE_B1_SHAPES.items():
        raw = [torch.randn(b, h, s, d, generator=gen, device="cuda")
               for h in (hq, hkv, hkv, hq)]
        scale = d ** -0.5
        for mask in WIDE_B1_MASKS:
            mkw = wide_mask_kw(torch, mask, b, s)
            keep = common.build_element_mask(
                s, s, causal=mkw["causal"], kv_len=s, device="cuda",
                window=mkw["window"], sinks=mkw["sinks"], q_seg=mkw.get("q_seg"),
                kv_seg=mkw.get("kv_seg"))
            pairs = int(keep.expand(b, 1, s, s).sum().item())
            for kind in WIDE_BWD_KINDS:
                tile = tile_of(torch, kind)
                q, k, v, do = (t.to(torch.bfloat16) if kind == "bf16" else t for t in raw)
                kw = dict(mkw, sm_scale=scale, kv_len=s, tile_dtype=tile)
                o, lse = fa2.fa2_forward_aligned(q, k, v, **kw)
                di = (o.float() * do.float()).sum(-1)
                kernels = {
                    "fa2_backward_fused": lambda kw_: bwd.fa2_backward_fused_aligned(
                        q, k, v, o, do, lse, **kw_),
                    "fa2_backward_dq": lambda kw_: (bwd.fa2_backward_dq_aligned(
                        q, k, v, do, lse, di, **kw_),),
                    "fa2_backward_dkv": lambda kw_: bwd.fa2_backward_dkv_aligned(
                        q, k, v, do, lse, di, **kw_),
                }
                plains = {
                    "fa2_backward_fused": lambda: bwd.fa2_backward_fused_plain(
                        q, k, v, o, do, lse, **kw),
                    "fa2_backward_dq": lambda: bwd.fa2_backward_dq_plain(
                        q, k, v, do, lse, di, **kw),
                    "fa2_backward_dkv": lambda: bwd.fa2_backward_dkv_plain(
                        q, k, v, do, lse, di, **kw),
                }
                want, plain_ms = timed_call(torch, plains["fa2_backward_fused"])
                outs = {"fa2_backward_fused": (0, 3), "fa2_backward_dq": (0, 1),
                        "fa2_backward_dkv": (1, 3)}
                if kind == "fp16":
                    control = None
                else:
                    ckw = dict(kw, **wide_bwd_control(torch, mask, b, s, kind))
                    control = bwd.fa2_backward_fused_plain(q, k, v, o, do, lse, **ckw)
                lib_in = [t.to(tile or torch.float32) for t in (q, k, v, do)]
                lq, lk, lv, ldo = lib_in
                lib_ms = None
                if mask == "causal" and kind != "fp32":
                    try:
                        lib_ms, lib_name = library_backward_ms(torch, fp32_bwd, lq, lk,
                                                               lv, ldo, scale)
                    except RuntimeError as e:  # the flash op refuses the shape
                        log(f"wide bwd D{d}: SDPA's flash backward refused: {e}")
                if lib_ms is None:
                    groups = hq // hkv
                    lk, lv = (t.repeat_interleave(groups, dim=1) for t in (lk, lv))
                    lib_ms = queued_ms(torch, fp32_bwd.masked_backward(
                        lq, lk, lv, ldo, scale, keep), iters=5)
                    lib_name = "SDPA memory-efficient backward, mask as bias"
                del lib_in, lq, lk, lv, ldo
                io = {"q": nbytes(q), "kv": nbytes(k, v), "stat": b * hq * s * 4}
                moved = {
                    "fa2_backward_fused": 4 * io["q"] + 2 * io["kv"] + io["stat"],
                    "fa2_backward_dq": 3 * io["q"] + io["kv"] + 2 * io["stat"],
                    "fa2_backward_dkv": 2 * io["q"] + 2 * io["kv"] + 2 * io["stat"],
                }
                for name in BWD_NAMES:
                    lo, hi = outs[name]
                    got = kernels[name](kw)
                    torch.cuda.synchronize()
                    errs = [rel_err(g, w) for g, w in zip(got, want[lo:hi])]
                    abs_err = max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want[lo:hi]))
                    label = f"{name} D{d} {mask} {kind}"
                    if kind == "fp16":
                        bf = kernels[name](dict(kw, tile_dtype=torch.bfloat16))
                        control_err = max(rel_err(g, w) for g, w in zip(bf, want[lo:hi]))
                        fp16_gate(label, max(errs), control_err, FP16_REL_TOL["bwd"])
                        del bf
                    else:
                        control_err = max(rel_err(g, w)
                                          for g, w in zip(got, control[lo:hi]))
                        if not max(errs) <= BWD_TOL[kind]:
                            raise AssertionError(f"{label}: relative errors {errs} "
                                                 f"(tol {BWD_TOL[kind]})")
                        if not control_err > BWD_TOL[kind]:
                            raise AssertionError(f"{label}: the control passes the gate "
                                                 f"({control_err} <= {BWD_TOL[kind]})")
                    del got
                    flops = BWD_MATMULS[name] * 2 * hq * pairs * d
                    peak = PEAK_FLOPS["fp32" if kind == "fp32" else "bf16"]
                    t_bytes, t_ops = moved[name] / HBM_BYTES_PER_S, flops / peak
                    ms = queued_ms(torch, lambda: kernels[name](kw), iters=5)
                    row = dict(kernel=name, case=f"D{d} {mask}", kind=kind, B=b, Hq=hq,
                               Hkv=hkv, S=s, D=d, rel_err=max(errs), max_abs_err=abs_err,
                               control_rel_err=control_err, ms=ms,
                               plain_ms=(plain_ms if name == "fa2_backward_fused" else
                                         timed_call(torch, plains[name])[1]),
                               library_ms=lib_ms, library=lib_name,
                               bound_ms=max(t_bytes, t_ops) * 1e3,
                               bound_by="bytes" if t_bytes > t_ops else "operations",
                               kept_pairs=pairs, tflops=flops / ms / 1e9)
                    rows.append(row)
                    log("wide bwd", json.dumps(row))
                del o, lse, di, want, control
                torch.cuda.empty_cache()
            del keep
        del raw
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, read_counts(names)


def phase_gemma2_train(torch, np, transformer, training, common):
    """Phase 30: the Gemma-2-2B widths (GEMMA2_2B, 26 layers, bf16 weights
    and tiles) train 3 AdamW steps on one seeded batch of B1 S2048, whose
    rows the 4096 window covers (every layer runs global; phase 29 runs the
    windowed D 256 backward): a finite, falling loss; step ms, tokens/s,
    peak memory, the share of the bf16 peak; B2's D 256 launches (the
    fused route); where a step's time goes (phase 10's profiled step).
    One more step with 128-row BlockSizes (16 KV slices,
    more than the fused route's eight, as
    tests/test_torch_window_backward.py forces it) takes the split pair:
    B3's and B4's D 256 launches, a finite loss.  Then one fp32 step at
    Gemma-2's attention widths on 2 layers, card against CPU
    (phase_train_parity), with the vocabulary cut to 4096 and tokens to
    (1, 257) so that the CPU side stays within ~15 s."""
    import functools

    cfg = transformer.TransformerConfig(param_dtype=torch.bfloat16, **GEMMA2_2B)
    b, s = 1, 2048
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(30), cfg, device="cuda")
    tokens = np.random.default_rng(30).integers(0, cfg.vocab_size, (b, s + 1))
    # 1e-3 (the base phases' rate) overshoots at these widths: the loss fell
    # 12.92 -> 7.35 and rose to 11.73 on the next step.
    opt = training.make_optimizer(learning_rate=1e-4, warmup_steps=1,
                                  decay_steps=100)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    del params
    names = TRAIN_KERNELS + tuple(f"{n}_d256" for n in TRAIN_KERNELS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(names)
    losses, times = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())  # waits for the step
        times.append(time.perf_counter() - t0)
    launches = read_counts(names)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gemma2 train: loss not finite and falling: {losses}")
    if not (launches["fa2_forward_d256"] and launches["fa2_backward_fused_d256"]):
        raise AssertionError(f"gemma2 train: a D 256 kernel never ran: {launches}")
    timed = times[1:]
    median = statistics.median(timed)
    flops = model_flops(cfg, b, s)
    res = dict(config="gemma-2-2b widths, 26 layers, bf16", batch=b, seq=s,
               losses=losses, step_ms=[t * 1e3 for t in times],
               step_ms_median=median * 1e3, tokens_per_s=b * s / median,
               max_memory_allocated_gib=peak / 2 ** 30,
               params=sum(p.numel() for p in transformer.tree_leaves(state.params)),
               model_flops_per_step=flops,
               mfu_bf16_peak=flops / median / PEAK_FLOPS["bf16"], launches=launches)
    res["profile"] = phase_train_profile(torch, state, step, tokens,
                                         label="gemma2 train profile", by_source=True)
    # The other route: 128-row blocks give 16 KV slices of block_k_dkv rows.
    split_blocks = common.BlockSizes(*(128,) * 6)
    flash = transformer.flash_attention
    transformer.flash_attention = functools.partial(flash, block_sizes=split_blocks)
    reset_counts(names)
    try:
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        split_loss = metrics["loss"].item()
        split_ms = (time.perf_counter() - t0) * 1e3
    finally:
        transformer.flash_attention = flash
    split_launches = read_counts(names)
    res.update(split_loss=split_loss, split_step_ms=split_ms,
               split_launches=split_launches)
    log("gemma2 train", json.dumps(res))
    if not (np.isfinite(split_loss) and split_launches["fa2_backward_dq_d256"]
            and split_launches["fa2_backward_dkv_d256"]
            and not split_launches["fa2_backward_fused_d256"]):
        raise AssertionError(f"gemma2 train, split route: loss {split_loss}, "
                             f"launches {split_launches}")
    del state, step
    torch.cuda.empty_cache()
    parity_cfg = transformer.TransformerConfig(
        dtype=torch.float32, attn_tile_dtype=None,
        **dict(GEMMA2_2B, n_layers=2, vocab_size=4096))
    parity = phase_train_parity(torch, np, transformer, training,
                                label="gemma2 widths, 2 layers, vocab 4096",
                                tokens_shape=(1, 257), cfg=parity_cfg)
    torch.cuda.empty_cache()
    return res, parity



# Phase 31: B7, B8, B9 and B10 at head dims 32 and 256, and the path that
# needs them: the reference contract (CLI, harness) at D 32 and 256 and the
# quantized-KV public API at Gemma-2-2B's attention width.  Shapes: the
# baselines at Stress-1's batch, heads and length at D 32 (the reference's
# head dim) and at phase 28's D 256 shape; B8 at the suite's small configs;
# B7 at phase 28's shapes (D 32 B4 Hq16 Hkv8 S2048, D 256 B1 Hq8 Hkv4
# S4096).  Each gate has a control that must fail it: fp32 rows the mask one
# key off (B9, B10 and B8's unmasked rows one key short of kv_len); B8's
# bf16 rows one 8-key n-tile off (a kernel that skips one n-tile of its
# mma); fp16 tiles the bf16 instantiation (fp16_gate); B7 as phase 28
# (causal dropped, the window one wider, the ids shifted a token).
WIDE_BASELINE_SHAPES = {32: (8, 16, 2048), 256: (1, 8, 4096)}
WIDE_B8_MASKS = ("full", "causal", "window 24 sinks 2", "2 segments")
WIDE_B7_SHAPES = {32: (4, 16, 8, 2048), 256: (1, 8, 4, 4096)}
WIDE_B7_MASKS = ("causal", "window 160", "2 segments")


def wide_b8_kw(torch, mask, b, s, kv_len, kind, control=False, device="cuda"):
    """B8's mask keywords for one of WIDE_B8_MASKS; with `control` the mask
    one key off (fp32) or one 8-key n-tile off (bf16): the unmasked row
    that many keys short of kv_len, causal dropped, the window that much
    wider, the ids shifted that far."""
    off = (1 if kind == "fp32" else 8) if control else 0
    if mask == "full":
        return dict(causal=False, kv_len=kv_len - off, window=None, sinks=0)
    if mask == "causal":
        return dict(causal=not control, kv_len=kv_len, window=None, sinks=0)
    if mask.startswith("window"):
        return dict(causal=True, kv_len=kv_len, window=24 + off, sinks=2)
    half = (torch.arange(s, device=device) * 2 // s).to(torch.int32)
    ids = torch.roll(half, off).expand(b, s).contiguous()
    return dict(causal=True, kv_len=kv_len, window=None, sinks=0, q_seg=ids,
                kv_seg=ids)


def phase_wide_baselines(torch, F, base):
    """B9 and B10 at D 32 and 256 (WIDE_BASELINE_SHAPES, fp32) against their
    plain versions within BASELINE_TOL; the control, the plain version one
    key short of kv_len, must fail it; device time beside the bound, the
    plain version and fp32 SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = []
    for d, (b, h, s) in WIDE_BASELINE_SHAPES.items():
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(3))
        kw = dict(sm_scale=d ** -0.5, kv_len=s)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=kw["sm_scale"]), iters=3, warmup=1)
        o_p = base.fa1_plain(q, k, v, **kw)  # naive_fa2_plain is the same function
        o_c = base.fa1_plain(q, k, v, **dict(kw, kv_len=s - 1))
        for which, kernel in (("fa1", base.fa1_aligned),
                              ("naive_fa2", base.naive_fa2_aligned)):
            o_k = kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (o_k - o_p).abs().max().item()
            control_err = (o_k - o_c).abs().max().item()
            if not err <= BASELINE_TOL:
                raise AssertionError(f"{which} D{d}: max_abs_err {err} "
                                     f"(tol {BASELINE_TOL})")
            if control_err <= BASELINE_TOL:
                raise AssertionError(f"{which} D{d}: the control passes the gate "
                                     f"({control_err})")
            ms = time_ms(lambda: kernel(q, k, v, **kw), iters=3, warmup=1)
            bound_ms, bound_by, flops = attention_bound(b, h, s, d, False, "fp32",
                                                        q, k, v, o_k)
            row = dict(kernel=which, case=f"D{d}", B=b, H=h, S=s, D=d,
                       max_abs_err=err, control_max_abs_err=control_err, ms=ms,
                       plain_ms=time_ms(lambda: base.fa1_plain(q, k, v, **kw),
                                        iters=1, warmup=0),
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                       tflops=flops / ms / 1e9)
            rows.append(row)
            log("wide baseline", json.dumps(row))
            del o_k
        del q, k, v, o_p, o_c
        torch.cuda.empty_cache()
    return rows


def phase_wide_b8(torch, F, attention, fa2, common):
    """B8 at D 32 and 256 against its plain version at the suite's Small-1,
    Edge-NonPowerOf2 and Edge-SmallSeq in fp32, bf16 and fp16 tiles under
    WIDE_B8_MASKS, the route taking B8 at each; controls as above; device
    time (queued) beside the bound, the plain version and SDPA on the same
    inputs on the fp32 full and causal rows and the bf16 causal ones."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    rows = []
    for d in (32, 256):
        for name in ("Small-1", "Edge-NonPowerOf2", "Edge-SmallSeq"):
            b, h, s = SUITE[name]
            raw = [torch.randn(b, h, s, d, generator=gen, device="cuda")
                   for _ in range(3)]
            for kind in ("fp32", "bf16", "fp16"):
                tile = tile_of(torch, kind)
                q, k, v, scale, _, kv_len = attention._prepare(
                    *raw, False, None, tile, None, None, None, 0)
                if not attention._use_small_kernel(q, k):
                    raise AssertionError(f"B8 D{d} {name}: the route does not take B8")
                sp = q.shape[2]
                for mask in WIDE_B8_MASKS:
                    kw = dict(wide_b8_kw(torch, mask, b, sp, kv_len, kind),
                              sm_scale=scale, tile_dtype=tile)
                    o_k, lse_k = fa2.fa2_forward_small_aligned(q, k, v, **kw)
                    o_p, lse_p = fa2.fa2_forward_small_plain(q, k, v, **kw)
                    torch.cuda.synchronize()
                    err = (o_k - o_p).abs().max().item()
                    lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)
                    label = f"B8 D{d} {name} {kind} {mask}"
                    if kind == "fp16":
                        o_c, _ = fa2.fa2_forward_small_aligned(
                            q, k, v, **dict(kw, tile_dtype=torch.bfloat16))
                        control_err = rel_err(o_c, o_p)
                        fp16_gate(label, rel_err(o_k, o_p), control_err,
                                  FP16_REL_TOL["B8"])
                        err_ok = True
                    else:
                        ckw = dict(kw, **wide_b8_kw(torch, mask, b, sp, kv_len, kind,
                                                    control=True))
                        o_c, _ = fa2.fa2_forward_small_plain(q, k, v, **ckw)
                        control_err = (o_k - o_c).abs().max().item()
                        err_ok = err <= B1_TOL[kind]
                        if control_err <= B1_TOL[kind]:
                            raise AssertionError(f"{label}: the control passes the "
                                                 f"gate ({control_err})")
                    if not (err_ok and lse_err <= LSE_REL_TOL and dead_equal):
                        raise AssertionError(f"{label}: max_abs_err {err}, lse rel "
                                             f"err {lse_err}, dead rows {dead_equal}")
                    row = dict(kernel="fa2_forward_small", config=name, case=mask,
                               kind=kind, B=b, H=h, S=s, S_pad=sp, D=d,
                               max_abs_err=err, lse_rel_err=lse_err)
                    row["control_rel_err" if kind == "fp16"
                        else "control_max_abs_err"] = control_err
                    if (kind, mask) in (("fp32", "full"), ("fp32", "causal"),
                                        ("bf16", "causal")):
                        causal = kw["causal"]
                        lib_in = [t[:, :, :s].to(tile or torch.float32) for t in (q, k, v)]
                        bound_ms, bound_by, _ = attention_bound(
                            b, h, s, d, causal, kind, q, k, v, o_k, lse_k)
                        row.update(
                            ms=queued_ms(torch, lambda: fa2.fa2_forward_small_aligned(
                                q, k, v, **kw)),
                            plain_ms=queued_ms(torch, lambda: fa2.fa2_forward_small_plain(
                                q, k, v, **kw), iters=5),
                            library_ms=queued_ms(torch, lambda: F.scaled_dot_product_attention(
                                *lib_in, is_causal=causal, scale=scale)),
                            bound_ms=bound_ms, bound_by=bound_by)
                    rows.append(row)
                    del o_k, lse_k, o_p, lse_p, o_c
            del raw
    log("wide B8", json.dumps(dict(
        rows=len(rows), worst={kind: max(r["max_abs_err"] for r in rows if r["kind"] == kind)
                               for kind in ("fp32", "bf16", "fp16")},
        timed=[{k: r[k] for k in ("D", "config", "kind", "case", "ms", "plain_ms",
                                  "library_ms", "bound_ms")}
               for r in rows if "ms" in r])))
    return rows


def phase_wide_b7(torch, F, quant, fq, fa2):
    """B7 at D 32 and 256 (WIDE_B7_SHAPES) over every storage in bf16 and
    fp32 compute under WIDE_B7_MASKS against its plain version (phase 28's
    gates and controls); device time beside the bound (kept pairs), the
    plain version and, on the causal bf16 rows, B1 and SDPA on the
    dequantized bf16 K/V (yardsticks, not B7's function).  Then the public
    API at both widths over the four storages, causal bf16: the Gemma-2-2B
    attention width (B1 Hq8 Hkv4 S4096 D256) and D 32 (B4 Hq16 Hkv8
    S2048), each output equal to the aligned kernel's; its D 32 and D 256
    launches are the path's."""
    gen = torch.Generator(device="cuda").manual_seed(33)
    rows, api_inputs = [], []
    for d, (b, hq, hkv, s) in WIDE_B7_SHAPES.items():
        half = torch.cat([torch.zeros(b, s // 2), torch.ones(b, s // 2)], 1).to(
            torch.int32).cuda()
        shifted = torch.roll(half, 1, dims=1).contiguous()
        for storage in STORAGES:
            for compute in ("bf16", "fp32"):
                cdt = torch.bfloat16 if compute == "bf16" else torch.float32
                api, args, (kd, vd) = quant_problem(torch, quant, fq, gen, storage, b,
                                                    hq, hkv, s, d, cdt)
                base = dict(causal=True, sm_scale=d ** -0.5, kv_len=s, compute_dtype=cdt)
                for mask in WIDE_B7_MASKS:
                    if mask == "causal":
                        mkw, ckw = {}, dict(causal=False)
                        pairs = causal_pairs(s, s, True) * b
                    elif mask.startswith("window"):
                        mkw, ckw = dict(window=160), dict(window=161)
                        pairs = window_pairs(s, s, True, 160, 0) * b
                    else:
                        mkw = dict(q_seg=half, kv_seg=half)
                        ckw = dict(q_seg=shifted, kv_seg=shifted)
                        pairs = 2 * causal_pairs(s // 2, s // 2, True) * b
                    kw = dict(base, **mkw)
                    o_k, lse_k = fq.fa2_forward_quant_aligned(*args, **kw)
                    o_p, lse_p = fq.fa2_forward_quant_plain(*args, **kw)
                    o_c, _ = fq.fa2_forward_quant_plain(*args, **dict(base, **ckw))
                    torch.cuda.synchronize()
                    label = f"B7 D{d} {mask} {storage} {compute}"
                    err = (o_k.float() - o_p.float()).abs().max().item()
                    control_err = (o_k.float() - o_c.float()).abs().max().item()
                    lse_err, dead_equal = lse_gate(torch, lse_k, lse_p)

                    def passes(o):
                        return (bf16_excess(o_k, o) <= BF16_ATOL["B7"] if compute == "bf16"
                                else (o_k.float() - o.float()).abs().max().item()
                                <= B7_FP32_TOL)

                    if not (passes(o_p) and dead_equal and lse_err <= LSE_REL_TOL):
                        raise AssertionError(f"{label}: max_abs_err {err}, bf16 excess "
                                             f"{bf16_excess(o_k, o_p)}, lse {lse_err}, "
                                             f"dead rows {dead_equal}")
                    if passes(o_c):
                        raise AssertionError(f"{label}: the control passes the gate "
                                             f"({control_err})")
                    flops = 4 * hq * pairs * d
                    t_bytes = nbytes(*args, o_k, lse_k) / HBM_BYTES_PER_S
                    t_ops = flops / PEAK_FLOPS[compute]
                    ms = time_ms(lambda: fq.fa2_forward_quant_aligned(*args, **kw),
                                 iters=5, warmup=1)
                    row = dict(kernel="fa2_forward_quant", case=f"D{d} {mask}", B=b,
                               Hq=hq, Hkv=hkv, S=s, D=d, storage=storage,
                               compute=compute, max_abs_err=err,
                               bf16_excess=bf16_excess(o_k, o_p), lse_rel_err=lse_err,
                               control_max_abs_err=control_err, ms=ms,
                               plain_ms=time_ms(lambda: fq.fa2_forward_quant_plain(
                                   *args, **kw), iters=1, warmup=0),
                               library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
                               bound_by="bytes" if t_bytes > t_ops else "operations",
                               tflops=flops / ms / 1e9)
                    if mask == "causal" and compute == "bf16":
                        row["b1_dequant_ms"] = time_ms(lambda: fa2.fa2_forward_aligned(
                            args[0], kd, vd, causal=True, sm_scale=d ** -0.5, kv_len=s,
                            tile_dtype=torch.bfloat16), iters=5, warmup=1)
                        row["sdpa_dequant_ms"] = time_ms(
                            lambda: F.scaled_dot_product_attention(
                                args[0], kd, vd, is_causal=True, scale=d ** -0.5,
                                enable_gqa=True), iters=5, warmup=1)
                        api_inputs.append((api, o_k))
                    rows.append(row)
                    log("wide B7", json.dumps(row))
                    del o_p, lse_p, o_c
                    if not (mask == "causal" and compute == "bf16"):
                        del o_k
                del args, kd, vd
            torch.cuda.empty_cache()
    # The public API at both widths: its launches are the path's.
    names = ("fa2_forward_quant", "fa2_forward_quant_d32", "fa2_forward_quant_d256")
    reset_counts(names)
    for (q, k_q, v_q), o_k in api_inputs:
        o = fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True)
        if not torch.equal(o, o_k[:, :, :q.shape[2]]):
            raise AssertionError(f"B7 D{q.shape[3]}: the public API differs from the "
                                 "aligned kernel")
    torch.cuda.synchronize()
    launches = read_counts(names)
    log("wide B7 public API launches", json.dumps(launches))
    if launches != {"fa2_forward_quant": 8, "fa2_forward_quant_d32": 4,
                    "fa2_forward_quant_d256": 4}:
        raise AssertionError(f"B7 public API at D 32 and 256 launched {launches}")
    del api_inputs
    torch.cuda.empty_cache()
    return rows, launches


def phase_wide_harness(harness, configs, dataclasses):
    """The harness's forward experiment (10 configs x fa2-naive, vanilla,
    fa2) and its fa1 rows re-made at head dim 32, fp32 at tolerance 1e-3:
    every row PASS."""
    cfgs = [dataclasses.replace(c, head_dim=32)
            for c in (configs.create_experiment_configs("forward")
                      + configs.create_test_configs("forward", "fa1"))]
    h = harness.Harness(tolerance=1e-3, iters=3, warmup=1, device="cuda")
    results = h.run(cfgs)
    for r in results:
        log("harness D32 csv:", ",".join(str(x) for x in r.as_row().values()))
    failed = [r.as_row() for r in results if not r.passed]
    if failed or len(results) != len(cfgs):
        raise AssertionError(f"harness D32: {len(failed)} FAIL rows of {len(results)} "
                             f"run ({len(cfgs)} configs): {failed[:1]}")
    return results


# Phase 32: mixture of experts at Mixtral-8x7B's widths (mistralai/
# Mixtral-8x7B-v0.1 config.json: d_model 4096, 32/8 heads of 128, d_ff 14336,
# vocab 32000, rope_theta 1e6, 8 experts, top 2, every layer MoE, router aux
# coefficient 0.02), depth cut (32 layers are 46.7B parameters, 93 GB in
# bf16), random bf16 weights drawn on the card; capacity factor 4.0 =
# n_experts / top_k makes JAX's static-capacity layer drop no token, as
# Mixtral's routing drops none.  Then remat "dots", gradients through int8
# weights and training checkpoints.
MIXTRAL_8X7B = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, head_dim=128, d_ff=14336, rope_theta=1e6,
                    n_experts=8, expert_top_k=2, moe_every=1, router_aux_coef=0.02,
                    capacity_factor=4.0)
MIXTRAL_NOT_EXPRESSED = (
    "RMSNorm eps 1e-6, not 1e-5",
    "static capacity stands in for dropless sparse dispatch: every expert runs "
    "on N + 1 rows (rounded up to 8), about 4x the routed work, a cost of the "
    "JAX design, not of the port")
MOE_MARGIN = 1e-6  # routing: a flip is allowed only under this top-k margin
QUANT_SCALE_TOL = 2e-5


def moe_model_flops(cfg, b: int, s: int) -> int:
    """The routed work of a train step: 6 x (attention projections, the
    router and top_k experts' three products per token, the head) x tokens,
    plus attention (model_flops's term); not the static capacity's padding."""
    per_layer = (2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + cfg.d_model * cfg.n_experts
                 + cfg.expert_top_k * 3 * cfg.d_model * cfg.d_ff)
    matmul = cfg.n_layers * per_layer + cfg.d_model * cfg.vocab_size
    attn = 3 * 4 * b * cfg.n_heads * causal_pairs(s, s, True) * cfg.head_dim
    return 6 * matmul * b * s + cfg.n_layers * attn


def moe_op_share(torch, decode, eng) -> dict:
    """The MoE ops' device time in one eager decode step (the body the
    engine's graph captures, decode_step over every slot, none active so
    that nothing is written): router top-k, the scatter into the experts'
    buffer and the gather back, the experts' batched products, against the
    step's whole device time (utils/profiling.trace: the device time each
    op launched)."""
    from cuda_flash_attention_tpu_torch.utils import profiling

    n = eng.max_seqs
    dev = torch.device("cuda")
    args = (torch.zeros(n, dtype=torch.long, device=dev),
            torch.zeros(n, dtype=torch.long, device=dev))
    with torch.inference_mode():
        t = profiling.trace(lambda: decode.decode_step(
            eng.params, *args, eng.caches, eng._tables_dev(),
            torch.zeros(n, dtype=torch.bool, device=dev), eng.cfg), iters=1, warmup=1)
    groups = {"topk": ("aten::topk",), "scatter_gather": ("aten::index_copy",
                                                           "aten::index", "aten::index_select"),
              "bmm": ("aten::bmm",)}
    ms = {g: sum(o.total_ms for o in t.ops if o.name in keys)
          for g, keys in groups.items()}
    return dict(eager_step_device_ms=t.busy_ms, moe_ms=ms,
                moe_share=sum(ms.values()) / t.busy_ms)


def mixtral_paged_cases(np):
    """B5 and B6 at the Mixtral path's shapes (D 128, Hq32 Hkv8: B5's
    group-8 instantiation, B6's tile bodies at T x group 2048) on its int8
    cache, bf16 and fp32 compute: 8 slots at phase 5's first seven prompt
    lengths (B5 at its last decode step, prompt + 23; B6 T512 at its last
    chunk) and one slot of T tokens, whose only key the short control
    drops."""
    prompts = np.random.default_rng(4).integers(64, 1501, 12)[:7].tolist()
    cases = [("Mixtral B5", 1, [1] + [n + 23 for n in prompts]),
             ("Mixtral B6 T512", 512, [512] + prompts)]
    return [(128, (32, 8), (name, t, lens, compute), ("int8",))
            for name, t, lens in cases for compute in ("bf16", "fp32")]


def phase_mixtral_attention(torch, F, fp32_bwd, fa2, bwd):
    """B1 and B2 at the Mixtral training path's shape (B1 Hq32 Hkv8 S2048
    D128 causal, group 4) in bf16 tiles and fp32 against their plain
    versions: B1's O within B1_TOL and its lse within LSE_REL_TOL, B2's
    dQ, dK and dV within BWD_TOL of each output's max; each control (the
    plain version with causal dropped) must fail its gate.  Device time
    (queued) beside each kernel's bound: max(bytes moved, as phases 28 and
    29 count them, over HBM_BYTES_PER_S; FLOPs over the causal pairs over
    the peak), the plain versions' times and the library's: SDPA, and its
    flash backward in bf16 or its memory-efficient backward in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(38)
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    raw = [torch.randn(b, h, s, d, generator=gen, device="cuda") for h in (hq, hkv, hkv, hq)]
    pairs = b * causal_pairs(s, s, True)
    rows = []

    def bound(moved, flops, kind):
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind]
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"

    for kind in ("bf16", "fp32"):
        tile = tile_of(torch, kind)
        q, k, v, do = (t.to(torch.bfloat16) if kind == "bf16" else t for t in raw)
        kw = dict(causal=True, window=None, sinks=0, sm_scale=d ** -0.5, kv_len=s,
                  tile_dtype=tile)
        ckw = dict(kw, causal=False)
        o, lse = fa2.fa2_forward_aligned(q, k, v, **kw)
        o_p, lse_p = fa2.fa2_forward_plain(q, k, v, **kw)
        o_c, _ = fa2.fa2_forward_plain(q, k, v, **ckw)
        got = bwd.fa2_backward_fused_aligned(q, k, v, o, do, lse, **kw)
        want = bwd.fa2_backward_fused_plain(q, k, v, o, do, lse, **kw)
        control = bwd.fa2_backward_fused_plain(q, k, v, o, do, lse, **ckw)
        torch.cuda.synchronize()
        fwd_err = (o.float() - o_p.float()).abs().max().item()
        fwd_control = (o.float() - o_c.float()).abs().max().item()
        lse_err, dead_equal = lse_gate(torch, lse, lse_p)
        bwd_err = max(rel_err(g, w) for g, w in zip(got, want[:3]))
        bwd_control = max(rel_err(g, w) for g, w in zip(got, control[:3]))
        io_q, io_kv, io_stat = nbytes(q), nbytes(k, v), b * hq * s * 4
        b1_bound, b1_by = bound(2 * io_q + io_kv + io_stat, 4 * hq * pairs * d, kind)
        b2_bound, b2_by = bound(4 * io_q + 2 * io_kv + io_stat,
                                BWD_MATMULS["fa2_backward_fused"] * 2 * hq * pairs * d, kind)
        row = dict(shape="B1 Hq32 Hkv8 S2048 D128 causal", kind=kind,
                   b1_max_abs_err=fwd_err, b1_control_max_abs_err=fwd_control,
                   b1_lse_rel_err=lse_err, b2_rel_err=bwd_err,
                   b2_control_rel_err=bwd_control,
                   b1_ms=queued_ms(torch, lambda: fa2.fa2_forward_aligned(q, k, v, **kw),
                                   iters=5),
                   b2_ms=queued_ms(torch, lambda: bwd.fa2_backward_fused_aligned(
                       q, k, v, o, do, lse, **kw), iters=5),
                   b1_bound_ms=b1_bound, b1_bound_by=b1_by, b2_bound_ms=b2_bound,
                   b2_bound_by=b2_by,
                   b1_plain_ms=time_ms(lambda: fa2.fa2_forward_plain(q, k, v, **kw),
                                       iters=1, warmup=1),
                   b2_plain_ms=time_ms(lambda: bwd.fa2_backward_fused_plain(
                       q, k, v, o, do, lse, **kw), iters=1, warmup=1),
                   # SDPA (causal by its flag, GQA by enable_gqa) and its
                   # backward (library_backward_ms) on the same inputs.
                   b1_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, scale=kw["sm_scale"], enable_gqa=True),
                       iters=5),
                   b2_library_ms=library_backward_ms(torch, fp32_bwd, q, k, v, do,
                                                     kw["sm_scale"])[0])
        rows.append(row)
        log("mixtral attention", json.dumps(row))
        if not (fwd_err <= B1_TOL[kind] and lse_err <= LSE_REL_TOL and dead_equal
                and bwd_err <= BWD_TOL[kind]):
            raise AssertionError(f"mixtral attention {kind}: {row}")
        if fwd_control <= B1_TOL[kind] or bwd_control <= BWD_TOL[kind]:
            raise AssertionError(f"mixtral attention {kind}: a control passes its "
                                 f"gate: {row}")
        del o, lse, o_p, lse_p, o_c, got, want, control
    del raw
    torch.cuda.empty_cache()
    return rows


def phase_mixtral_serving(torch, np, transformer, decode):
    """(a) Mixtral widths at 8 layers (bf16, ~11.9B parameters) served on an
    int8 cache, 8 slots, CUDA-graph decode, chunked prefill 512 (an MoE
    chunk step carries all 8 rows, JAX's): phase 5's 12 prompts, 24 greedy
    tokens each; B1, B5 and B6 launched, no page leaked, every token in the
    vocabulary; one profiled decode step (graph) and the MoE ops' share of
    an eager one."""
    cfg = transformer.TransformerConfig(param_dtype=torch.bfloat16,
                                        **dict(MIXTRAL_8X7B, n_layers=8))
    log("mixtral config", json.dumps(dict(MIXTRAL_8X7B, served_layers=8,
                                          not_expressed=MIXTRAL_NOT_EXPRESSED)))
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(32), cfg, device="cuda")
    n_params = sum(p.numel() for p in transformer.tree_leaves(params))
    prompts = serving_mix(np, cfg)
    new_tokens = 24
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048, page_size=128,
                              cache_dtype=torch.int8, prefill_chunk=512)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(SERVING_KERNELS)
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(SERVING_KERNELS)
    check_served("mixtral", reqs, eng, launches, SERVING_KERNELS, cfg.vocab_size,
                 new_tokens)
    total = sum(len(r.generated) for r in reqs)
    res = dict(config="mixtral-8x7b widths, 8 layers, bf16", params=n_params,
               requests=len(reqs), tokens=total, seconds=elapsed,
               tokens_per_s=total / elapsed,
               tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
               ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
               steps=eng.stats["steps"], prefill_chunks=eng.stats["prefill_chunks"],
               launches=launches,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    res["profile"] = phase_profile(torch, np, eng, label="mixtral decode profile",
                                   new_tokens=8, steps=1)
    res["moe_ops"] = moe_op_share(torch, decode, eng)
    log("mixtral serving", json.dumps(res))
    del eng
    torch.cuda.empty_cache()
    return res


def phase_mixtral_train(torch, np, transformer, training):
    """(b) Mixtral widths at 2 layers (~3.2B parameters, bf16 weights and
    tiles), AdamW lr 1e-4, 4 steps on one seeded batch of B1 S2048: a
    finite, falling loss, the router's aux loss finite; B1 and the
    backward (B2, or B3 and B4) launched; step time, tokens/s, peak memory
    and the share of the bf16 peak (routed work, moe_model_flops)."""
    cfg = transformer.TransformerConfig(param_dtype=torch.bfloat16,
                                        **dict(MIXTRAL_8X7B, n_layers=2))
    b, s = 1, 2048
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(33), cfg, device="cuda")
    tokens = np.random.default_rng(33).integers(0, cfg.vocab_size, (b, s + 1))
    opt = training.make_optimizer(learning_rate=1e-4, warmup_steps=1, decay_steps=100)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(TRAIN_KERNELS)
    losses, times = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = read_counts(TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        tok = torch.as_tensor(tokens[:, :-1], device="cuda")
        _, aux = transformer.forward(state.params, tok, cfg, return_aux=True)
    aux = float(aux)
    backward = launches["fa2_backward_fused"] or (
        launches["fa2_backward_dq"] and launches["fa2_backward_dkv"])
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and np.isfinite(aux)
            and launches["fa2_forward"] and backward):
        raise AssertionError(f"mixtral train: losses {losses}, aux {aux}, "
                             f"launches {launches}")
    median = statistics.median(times[1:])
    flops = moe_model_flops(cfg, b, s)
    res = dict(config="mixtral-8x7b widths, 2 layers, bf16", batch=b, seq=s,
               losses=losses, aux_loss=aux, step_ms=[t * 1e3 for t in times],
               step_ms_median=median * 1e3, tokens_per_s=b * s / median,
               max_memory_allocated_gib=peak / 2 ** 30,
               params=sum(p.numel() for p in transformer.tree_leaves(state.params)),
               routed_flops_per_step=flops,
               bf16_peak_share=flops / median / PEAK_FLOPS["bf16"], launches=launches)
    res["profile"] = phase_train_profile(torch, state, step, tokens,
                                         label="mixtral train profile", by_source=True)
    log("mixtral train", json.dumps(res))
    del state, step
    torch.cuda.empty_cache()
    return res


def record_routing(transformer, moe, calls):
    """transformer.moe_ffn wrapped to append each call's routing (fp32
    probabilities, top-k experts, ranks, kept) to `calls`, on the CPU."""
    def recorded(h, layer, cfg):
        x = h.reshape(-1, h.shape[-1])
        probs, _, idx, _ = moe._route(x, layer, cfg)
        rank = moe._ranks(idx, cfg.n_experts)
        cap = moe.expert_capacity(len(x), cfg.n_experts, cfg.expert_top_k,
                                  cfg.capacity_factor)
        calls.append(tuple(t.cpu() for t in (probs, idx, rank, rank < cap)))
        return moe.moe_ffn(h, layer, cfg)
    return recorded


def phase_mixtral_parity(torch, np, transformer, decode, moe):
    """(c) Mixtral widths at 1 layer in fp32 with capacity factor 1.0 (so
    that the capacity binds), card against CPU on one prefill_forward of
    tokens (1, 129): logits within E2E_LOGIT_TOL; each layer's routing equal
    but where a token's top-k margin is below MOE_MARGIN; the dropped
    (token, choice) pairs counted."""
    cfg = transformer.TransformerConfig(dtype=torch.float32, attn_tile_dtype=None,
                                        **dict(MIXTRAL_8X7B, n_layers=1,
                                               capacity_factor=1.0))
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(34), cfg, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(34).integers(0, cfg.vocab_size, (1, 129)))
    models = {"cuda": params, "cpu": transformer.tree_map(lambda w: w.cpu(), params)}
    out, routing = {}, {}
    inner = transformer.moe_ffn
    try:
        for dev, p in models.items():
            routing[dev] = []
            transformer.moe_ffn = record_routing(transformer, moe, routing[dev])
            with torch.inference_mode():
                logits, _ = decode.prefill_forward(p, tokens.to(dev), cfg)
            out[dev] = logits.cpu()
    finally:
        transformer.moe_ffn = inner
    diff = (out["cuda"] - out["cpu"]).abs().max().item()
    flips, dropped = routing_flips(torch, cfg, routing["cuda"], routing["cpu"],
                                   "mixtral parity")
    res = dict(config="mixtral-8x7b widths, 1 layer, fp32, capacity factor 1.0",
               tokens=list(tokens.shape), logits_max_abs_diff=diff,
               routing_flips_under_margin=flips, dropped_pairs=dropped)
    log("mixtral fp32 parity (card vs CPU)", json.dumps(res))
    if not diff <= E2E_LOGIT_TOL:
        raise AssertionError(f"mixtral parity: logits differ by {diff} "
                             f"(tol {E2E_LOGIT_TOL})")
    return res, (cfg, models)


def routing_flips(torch, cfg, card_calls, cpu_calls, what):
    """Each MoE call's routing on the card against the CPU's, call by call:
    a token may route differently only where its top-k margin (on the CPU)
    is below MOE_MARGIN, else this raises.  Returns the flips and the
    dropped (token, choice) pairs of each call."""
    flips, dropped = [], []
    for (pg, ig, rg, vg), (pc, ic, rc, vc) in zip(card_calls, cpu_calls):
        top = torch.sort(pc, dim=-1, descending=True).values
        margin = torch.stack([top[:, k] - top[:, k + 1]
                              for k in range(cfg.expert_top_k)], 1).amin(1)
        differ = (ig != ic).any(1)
        if (differ & (margin >= MOE_MARGIN)).any():
            raise AssertionError(f"{what}: tokens "
                                 f"{torch.nonzero(differ & (margin >= MOE_MARGIN)).ravel()} "
                                 f"route differently with a top-k margin >= {MOE_MARGIN}")
        flips.append(int(differ.sum()))
        dropped.append(dict(cuda=int((~vg).sum()), cpu=int((~vc).sum())))
    return flips, dropped


def phase_remat_dots(torch, np, transformer):
    """(d) One base-width value_and_grad at B4 S2048 under remat "none",
    "dots" and "full": losses and gradients bitwise equal to "none"'s (the
    recomputed kernels are deterministic), each one's peak memory, "dots"
    below "none"."""
    import dataclasses

    cfg = transformer.TransformerConfig.base()
    params = transformer.init_params(torch.Generator().manual_seed(35), cfg, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(35).integers(0, cfg.vocab_size,
                                                                 (4, 2049)), device="cuda")
    res, ref = {}, None
    for remat in ("none", "dots", "full"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss, grads = transformer.value_and_grad(
            params, tokens, dataclasses.replace(cfg, remat=remat))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        leaves = transformer.tree_leaves(grads)
        if ref is None:
            ref = (loss, leaves)
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(leaves, ref[1]))
        res[remat] = dict(loss=loss.item(), loss_equal=bool(loss == ref[0]),
                          grad_max_abs_diff=diff, peak_gib=peak / 2 ** 30, ms=ms)
        del grads, leaves
    log("remat dots (base B4 S2048)", json.dumps(res))
    if not all(r["loss_equal"] and r["grad_max_abs_diff"] == 0 for r in res.values()):
        raise AssertionError(f"remat: a policy's loss or gradients differ: {res}")
    if not res["dots"]["peak_gib"] < res["none"]["peak_gib"]:
        raise AssertionError(f"remat: dots peak {res['dots']['peak_gib']} GiB not below "
                             f"none's {res['none']['peak_gib']}")
    del params
    torch.cuda.empty_cache()
    return res


def phase_quant_grads(torch, np, transformer, training, quant):
    """(e) One AdamW step (lr 5e-6, no warmup) at base width, 2 layers,
    fp32, on int8 weights (quantize_transformer_params), card against CPU:
    the int8 values unchanged on both and the scales moved.  The gate on
    the gradients is the scales' first moments (after one step, (1 - b1)
    times the gradient), card within TRAIN_GRAD_TOL of each leaf's max
    |CPU value|; its control, the CPU's moments negated (the gradient's
    sign flipped), must fail it.  The scales after the step are printed
    and held within QUANT_SCALE_TOL of the CPU's, which is no check of
    the gradients: Adam's first step moves an element by at most lr,
    whatever its gradient, so two devices are at most 2 lr = 1e-5 apart."""
    import dataclasses

    cfg = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=1)
    params = quant.quantize_transformer_params(
        transformer.init_params(torch.Generator().manual_seed(36), cfg, device="cpu"),
        torch.int8)
    tokens = np.random.default_rng(36).integers(0, cfg.vocab_size, (1, 129))
    out = {}
    for dev in ("cuda", "cpu"):
        p = transformer.array_map(lambda t: t.to(dev), params)
        opt = training.make_optimizer(learning_rate=5e-6, warmup_steps=0, decay_steps=10)
        out[dev] = training.make_optax_train_step(cfg, opt)(
            training.init_train_state(p, opt), tokens)
    (s_g, m_g), (s_c, _) = out["cuda"], out["cpu"]
    before = [x for x in transformer.tree_leaves(params) if hasattr(x, "scales")]
    after = {dev: [x for x in transformer.tree_leaves(out[dev][0].params)
                   if hasattr(x, "scales")] for dev in out}
    mus = {dev: [x for x in transformer.tree_leaves(out[dev][0].opt_state.mu)
                 if hasattr(x, "scales")] for dev in out}
    values_same = all(torch.equal(a.values.cpu(), b.values) for dev in out
                      for a, b in zip(after[dev], before))
    moved = max((a.scales.cpu() - b.scales).abs().max().item()
                for a, b in zip(after["cuda"], before))
    scale_diff = max((a.scales.cpu() - b.scales).abs().max().item()
                     for a, b in zip(after["cuda"], after["cpu"]))
    def mu_rel_err(sign):
        return max(((a.scales.cpu() - sign * b.scales).abs().max()
                    / b.scales.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(mus["cuda"], mus["cpu"]))

    mu_err, mu_control = mu_rel_err(1), mu_rel_err(-1)
    res = dict(config="base widths, 1 layer, fp32, int8 weights", quantized=len(before),
               int_values_unchanged=values_same, scales_max_move=moved,
               scales_card_cpu_max_abs_diff=scale_diff, scale_mu_rel_err=mu_err,
               scale_mu_control_rel_err=mu_control, loss=m_g["loss"].item())
    log("quantized-weight gradients (card vs CPU)", json.dumps(res))
    if not (values_same and moved > 0 and scale_diff <= QUANT_SCALE_TOL
            and mu_err <= TRAIN_GRAD_TOL):
        raise AssertionError(f"quantized gradients: {res}")
    if mu_control <= TRAIN_GRAD_TOL:
        raise AssertionError(f"quantized gradients: the negated control passes the "
                             f"gate: {res}")
    return res


def phase_checkpoint(torch, np, transformer, training, checkpoint):
    """(f) train_loop with checkpoint_dir on the card at tiny(): one step
    saved, restored onto the card (restore_checkpoint's default device),
    one step resumed; parameters and first moments bitwise equal to two
    uninterrupted steps."""
    import tempfile

    cfg = transformer.TransformerConfig.tiny()
    batches = [np.random.default_rng(37 + i).integers(0, cfg.vocab_size, (2, 129))
               for i in range(2)]
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
    full = training.train_loop(cfg, iter(batches), num_steps=2, optimizer=opt,
                               log_every=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        training.train_loop(cfg, iter(batches[:1]), num_steps=1, optimizer=opt,
                            log_every=0, device="cuda", checkpoint_dir=tmp,
                            checkpoint_every=1)
        saved = checkpoint.restore_checkpoint(tmp)
    on_card = all(t.is_cuda for t in transformer.array_leaves(saved["params"]))
    state = training.TrainState(saved["params"], saved["opt_state"], saved["step"])
    resumed, _ = training.make_optax_train_step(cfg, opt)(state, batches[1])
    equal = all(torch.equal(a, b) for a, b in zip(
        transformer.array_leaves([resumed.params, resumed.opt_state.mu]),
        transformer.array_leaves([full.params, full.opt_state.mu])))
    res = dict(config="tiny, 2 AdamW steps", restored_on_card=on_card,
               resumed_step=resumed.step, bitwise_equal=equal)
    log("checkpoint resume (card)", json.dumps(res))
    if not (on_card and equal and resumed.step == full.step == 2):
        raise AssertionError(f"checkpoint: {res}")
    return res



# Phase 33: meta-llama/Meta-Llama-3-8B's config.json, as the object
# utils/hf_convert.config_from_hf reads (LlamaConfig's attribute names).
# No weights are downloaded: a seeded random bf16 state dict in Hugging
# Face's key names and [out, in] layout stands in for the checkpoint.
LLAMA3_8B = dict(vocab_size=128256, hidden_size=4096, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                 intermediate_size=14336, rope_theta=500000.0, rms_norm_eps=1e-5,
                 tie_word_embeddings=False, max_position_embeddings=8192)
LLAMA3_NOT_EXPRESSED = (
    "RMSNorm eps 1e-5 (config.json rms_norm_eps); both packages' rms_norm use 1e-6",)


def llama_state_dict(torch, hf, n_layers: int, seed: int) -> dict:
    """A random Llama state dict on the card in Hugging Face's key names
    and layout (nn.Linear's [out, in]), bf16: projections N(0, 1/in), the
    embedding N(0, 1), norm scales 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, f, v = hf.hidden_size, hf.intermediate_size, hf.vocab_size
    q, kv = hf.num_attention_heads * hf.head_dim, hf.num_key_value_heads * hf.head_dim

    def normal(out, inp, scale=None):
        w = torch.randn(out, inp, generator=gen, device="cuda", dtype=torch.bfloat16)
        return w.mul_(inp ** -0.5 if scale is None else scale)

    def ones(n):
        return torch.ones(n, device="cuda", dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": normal(v, d, scale=1.0),
          "model.norm.weight": ones(d), "lm_head.weight": normal(v, d)}
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": ones(d),
                   pre + "post_attention_layernorm.weight": ones(d),
                   pre + "self_attn.q_proj.weight": normal(q, d),
                   pre + "self_attn.k_proj.weight": normal(kv, d),
                   pre + "self_attn.v_proj.weight": normal(kv, d),
                   pre + "self_attn.o_proj.weight": normal(d, q),
                   pre + "mlp.gate_proj.weight": normal(f, d),
                   pre + "mlp.up_proj.weight": normal(f, d),
                   pre + "mlp.down_proj.weight": normal(d, f)})
    return sd


def llama_from_hf(torch, hf_convert, n_layers: int, seed: int):
    """Llama-3-8B's widths at `n_layers`: the HF-layout state dict drawn on
    the card, converted there by params_from_hf, the dict freed.  Returns
    (params, cfg, conversion figures: parameters, the dict's and the
    tree's GiB, the card's allocation as the conversion starts (the dict),
    the conversion's peak and its ms)."""
    import types

    hf = types.SimpleNamespace(**dict(LLAMA3_8B, num_hidden_layers=n_layers))
    cfg = hf_convert.config_from_hf(hf, param_dtype=torch.bfloat16)
    sd = llama_state_dict(torch, hf, n_layers, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = hf_convert.params_from_hf(sd, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    leaves = [t for layer in params["layers"] for t in layer.values()] + [
        params[k] for k in ("embed", "final_norm", "lm_head")]
    figures = dict(params=sum(t.numel() for t in sd.values()),
                   state_dict_gib=sum(nbytes(t) for t in sd.values()) / 2 ** 30,
                   tree_gib=nbytes(*leaves) / 2 ** 30,
                   allocated_before_gib=before / 2 ** 30,
                   conversion_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   conversion_ms=ms)
    wq = sd["model.layers.0.self_attn.q_proj.weight"]
    if not torch.equal(params["layers"][0]["wq"], wq.t()):
        raise AssertionError("llama3: wq is not the transposed q_proj")
    del sd, wq, leaves
    torch.cuda.empty_cache()
    return params, cfg, figures


def phase_llama3_serving(torch, np, decode, hf_convert, profiling):
    """(a) Llama-3-8B's widths at all 32 layers (8.03B parameters, bf16),
    converted from an HF-layout state dict on the card, served through
    DecodeEngine on an int8 cache, 8 slots, CUDA-graph decode, chunked
    prefill 512: phase 5's first 8 prompt lengths, 24 greedy tokens each
    (B1, B5 and B6 launched at D 128 Hq32 Hkv8, no page leaked, tokens in
    the vocabulary); tokens/s, TPOT, TTFT, peak memory; one profiled graph
    decode step (phase 6's window) with its top kernels, beside the step's
    roofline (every weight byte and each slot's cached K/V read once) and
    B5's share of the busy time beside B5's own roofline."""
    params, cfg, conv = llama_from_hf(torch, hf_convert, 32, seed=33)
    log("llama3 config", json.dumps(dict(LLAMA3_8B, not_expressed=LLAMA3_NOT_EXPRESSED,
                                         **conv)))
    prompts = serving_mix(np, cfg)[:8]
    new_tokens = 24
    eng = decode.DecodeEngine(params, cfg, max_seqs=8, max_seq_len=2048, page_size=128,
                              cache_dtype=torch.int8, prefill_chunk=512)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(SERVING_KERNELS)
    t0 = time.perf_counter()
    reqs = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(SERVING_KERNELS)
    check_served("llama3", reqs, eng, launches, SERVING_KERNELS, cfg.vocab_size,
                 new_tokens)
    total = sum(len(r.generated) for r in reqs)
    res = dict(config="meta-llama-3-8b widths, 32 layers, bf16", params=conv["params"],
               requests=len(reqs), tokens=total, seconds=elapsed,
               tokens_per_s=total / elapsed,
               tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
               ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
               steps=eng.stats["steps"], prefill_chunks=eng.stats["prefill_chunks"],
               launches=launches,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    prof = phase_profile(torch, np, eng, label="llama3 decode profile", new_tokens=8,
                         steps=1)
    # Rooflines of that step: each matmul weight read once (the embedding's
    # rows are gathered, not read whole) and 2 FLOPs a weight a token; B5's
    # bytes and FLOPs as paged_bound counts them (int8 K/V, fp32 scales,
    # bf16 q and out), over every layer.
    peaks = profiling.chip_peaks()
    n, lens = len(prof["lengths"]), [x + 1 for x in prof["lengths"]]
    weights = sum(t.numel() for t in [eng.params["lm_head"]] + [
        w for layer in eng.params["layers"] for k, w in layer.items() if w.ndim == 2])
    kv_bytes = 2 * sum(lens) * cfg.kv_dim * (1 + 4 / cfg.head_dim) * cfg.n_layers
    step_roof = profiling.roofline_time(2 * weights * n, 2 * weights + kv_bytes,
                                        peaks=peaks)
    b5_bytes = cfg.n_layers * (2 * sum(lens) * cfg.n_kv_heads * (cfg.head_dim + 4)
                               + 2 * 2 * n * cfg.q_dim + 4 * sum(-(-x // 128) for x in lens)
                               + 4 * n)
    b5_roof = profiling.roofline_time(4 * cfg.head_dim * cfg.n_heads * sum(lens)
                                      * cfg.n_layers, b5_bytes, peaks=peaks)
    res["profile"] = prof
    res["roofline"] = dict(
        chip=peaks.name, step_ms=step_roof["t_ideal_s"] * 1e3, step_bound=step_roof["bound"],
        step_share_of_busy=step_roof["t_ideal_s"] * 1e3 / prof["device_busy_ms_per_step"],
        b5_ms=b5_roof["t_ideal_s"] * 1e3, b5_bound=b5_roof["bound"],
        b5_measured_ms=prof["b5_ms_per_step"],
        b5_share_of_busy=prof["b5_share_of_busy"])
    log("llama3 serving", json.dumps(res))
    del eng
    gc.collect()  # the engine's captured graphs hold it in reference cycles
    torch.cuda.empty_cache()
    return res


def phase_llama3_train(torch, np, training, hf_convert, data):
    """(b) Llama-3-8B's widths at 2 layers (1.49B parameters, bf16 weights
    and tiles), converted from an HF-layout state dict on the card, train 3
    AdamW steps (lr 1e-4) at B1 S2048 on batches of TokenLoader(native=True)
    over a shard that write_token_file wrote (the loader built by g++ from
    cpp/dataloader.cpp): each native batch equal to the Python engine's,
    the losses finite, B1 and the backward launched."""
    import tempfile

    params, cfg, conv = llama_from_hf(torch, hf_convert, 2, seed=34)
    b, s = 1, 2048
    opt = training.make_optimizer(learning_rate=1e-4, warmup_steps=1, decay_steps=100)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    del params
    losses, times, equal = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "tokens.bin")
        data.write_token_file(shard, np.random.default_rng(34).integers(
            0, cfg.vocab_size, 4 * b * (s + 1)))
        kw = dict(batch=b, seq_len=s, seed=34)
        with data.TokenLoader(shard, native=True, **kw) as nat, \
                data.TokenLoader(shard, native=False, **kw) as py:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(TRAIN_KERNELS)
            for _ in range(3):
                batch = next(nat)
                equal.append(bool(np.array_equal(batch, next(py))))
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(metrics["loss"].item())
                times.append(time.perf_counter() - t0)
            native = nat.native
    launches = read_counts(TRAIN_KERNELS)
    backward = launches["fa2_backward_fused"] or (
        launches["fa2_backward_dq"] and launches["fa2_backward_dkv"])
    res = dict(config="meta-llama-3-8b widths, 2 layers, bf16", batch=b, seq=s,
               params=conv["params"], conversion=conv, loader_native=native,
               loader_library=data.library_path().name,
               batches_equal=equal, losses=losses, step_ms=[t * 1e3 for t in times],
               step_ms_median=statistics.median(times[1:]) * 1e3,
               tokens_per_s=b * s / statistics.median(times[1:]),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    log("llama3 train", json.dumps(res))
    if not (native and all(equal) and all(np.isfinite(losses))
            and launches["fa2_forward"] and backward):
        raise AssertionError(f"llama3 train: {res}")
    del state, step
    torch.cuda.empty_cache()
    return res


def phase_moe_speculation(torch, np, transformer, decode, moe, cfg, models):
    """(c) Prompt-lookup speculation (k 4) with an MoE target: phase 32's
    1-layer fp32 Mixtral-width model at capacity factor 1.0 on the card and
    on the CPU, 4 slots, 4 prompts that repeat themselves, 6 greedy tokens
    each.  The gate: equal tokens; each MoE call's routing is compared as
    phase 32 compares it, and the tokens may differ only after a call whose
    routing flipped under MOE_MARGIN (a flip at a wider margin raises)."""
    rng = np.random.default_rng(35)
    prompts = [(rng.integers(0, cfg.vocab_size, int(n)).tolist() * 4)[:int(m)]
               for n, m in ((12, 40), (7, 33), (20, 64), (9, 50))]
    out, routing, stats = {}, {}, {}
    inner = transformer.moe_ffn
    try:
        for dev, p in models.items():
            routing[dev] = []
            transformer.moe_ffn = record_routing(transformer, moe, routing[dev])
            eng = decode.DecodeEngine(p, cfg, max_seqs=4, max_seq_len=512,
                                      cache_dtype=torch.float32, spec_tokens=4,
                                      spec_mode="prompt_lookup", device=dev)
            reset_counts(SERVING_KERNELS)
            reqs = eng.run(prompts, max_new_tokens=6)
            # Prompt lookup runs no draft model: B1 prefills, B6 verifies.
            check_served(f"moe speculation {dev}", reqs, eng,
                         read_counts(SERVING_KERNELS),
                         ("fa2_forward", "paged_chunk") if dev == "cuda" else (),
                         cfg.vocab_size, 6)
            out[dev] = [r.generated for r in reqs]
            stats[dev] = dict(eng.stats, launches=read_counts(SERVING_KERNELS))
            del eng
    finally:
        transformer.moe_ffn = inner
    first_flip = None
    for i, (card, cpu) in enumerate(zip(routing["cuda"], routing["cpu"])):
        if card[1].shape != cpu[1].shape:
            break
        flips, _ = routing_flips(torch, cfg, [card], [cpu], "moe speculation")
        if flips[0]:
            first_flip = i
            break
    res = dict(config="mixtral-8x7b widths, 1 layer, fp32, capacity factor 1.0",
               spec_tokens=4, equal=out["cuda"] == out["cpu"], tokens=out["cuda"],
               calls=len(routing["cuda"]), first_flip_under_margin=first_flip,
               dropped_pairs=sum(int((~c[3]).sum()) for c in routing["cuda"]),
               card_stats=stats["cuda"], cpu_stats=stats["cpu"])
    log("moe speculation (card vs CPU)", json.dumps(res))
    if not (res["equal"] or first_flip is not None):
        raise AssertionError(f"moe speculation: tokens differ with no routing flip: "
                             f"{out}")
    if not (stats["cuda"]["spec_rounds"] and res["dropped_pairs"]):
        raise AssertionError(f"moe speculation: no round, or the capacity never "
                             f"bound: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 34: training on a device mesh (parallel/).
# ---------------------------------------------------------------------------

# The kernels of the mesh path whose launches the ranks sum: B1 (and its
# windowed launches), B2, B3, B4 and B7.
MESH_KERNELS = ("fa2_forward", "fa2_forward_window", "fa2_backward_fused",
                "fa2_backward_dq", "fa2_backward_dkv", "fa2_forward_quant")
# Ring attention at Llama-3-8B's attention width: B1 Hq32 Hkv8 D128, 32768
# tokens over 4 ctx ranks; the windowed case skips rotations and leaves
# dead rows in its band step.
MESH_RING = dict(b=1, hq=32, hkv=8, s=32768, d=128)
MESH_RING_WINDOW = 4096
# Queries scaled by 4 for the gated ring checks: sharper softmax rows, so
# that a dropped shard moves O by a large share of its max (at the unscaled
# inputs O averages thousands of keys and a dropped quarter moves it below
# B1's gate).  The quantized ring runs the unscaled inputs, as the JAX tests'.
MESH_PEAKY = 4.0
MESH_QUANT = (("int8", True), ("int4", True), ("float8_e4m3fn", False))
# The quantized ring's two checks, each with the ring without its own
# shard's step as the control that must fail it.  (1) On the peaky queries, against
# B7 on the whole sequence over the same per-token quantization (a rank's
# shard quantizes to the same values as the whole sequence's, so only the
# ring's merge differs): B1's gate of the reference's max |O|.  (2) On the
# unscaled inputs (the JAX tests' regime), against the bf16 ring: the mean
# |error| relative to the bf16 ring's mean |O|, per storage, each limit set
# between the sound reading and the control's on the H100 (PERF.md, PR 22).
# Peaky queries magnify the quantization error itself (a logit moves by the
# query's scale times the key's rounding), which is why (2) runs unscaled.
QUANT_RING_MEAN_TOL = {"int8": 5e-2, "int4": 3e-1, "float8_e4m3fn": 1e-1}
MESH_LOSS_RTOL = 2e-4  # tests/test_training.py's sharded-step tolerances
MESH_PARAM_ATOL = 1e-4
# The first Adam moment after one step is (1 - b1) times the clipped
# gradient: each gathered leaf is held to the unsharded step's, relative to
# that leaf's max (as phase 8 holds card against CPU), and grad_norm at the
# loss's rtol.
MESH_GRAD_TOL = 2e-4
MESH_TIMEOUT = 300  # seconds: the 4 ranks' run and gloo's collectives
MESH_BASE_STEPS = 1  # (c)'s AdamW steps a layout


def _rel_err(torch, got, want, world) -> float:
    """max |got - want| / max |want| over every rank's block."""
    import torch.distributed as dist

    e = torch.stack([(got.float() - want.float()).abs().max(), want.float().abs().max()])
    dist.all_reduce(e, op=dist.ReduceOp.MAX)
    return float(e[0] / e[1])


def _mean_rel_err(torch, got, want) -> float:
    """mean |got - want| / mean |want| over every rank's block."""
    import torch.distributed as dist

    s = torch.stack([(got.float() - want.float()).abs().sum(), want.float().abs().sum()])
    dist.all_reduce(s)
    return float(s[0] / s[1])


def mesh_adamw_steps(transformer, training, cfg, params, opt, tokens, mesh, n=2):
    """n AdamW steps (training.make_optax_train_step) from the full tree
    `params` (with a mesh, this rank's blocks of it): each step's loss and
    grad_norm, the first step's first Adam moment and the parameters after
    the last step, every leaf gathered whole."""
    state = training.init_train_state(
        params if mesh is None else transformer.shard_params(params, mesh, cfg), opt)
    step = training.make_optax_train_step(cfg, opt, mesh=mesh)
    res = dict(losses=[], grad_norms=[])
    for i in range(n):
        state, m = step(state, tokens)
        res["losses"].append(float(m["loss"]))
        res["grad_norms"].append(float(m["grad_norm"]))
        trees = dict(mu=state.opt_state.mu) if i == 0 else {}
        if i == n - 1:
            trees["params"] = state.params
        for key, tree in trees.items():
            res[key] = transformer.tree_leaves(
                tree if mesh is None else transformer.gather_params(tree, mesh, cfg))
    return res


def compare_adamw_steps(res, ref, b1) -> dict:
    """mesh_adamw_steps' readings against the unsharded ones: the losses'
    and grad norms' relative errors, the first moments' (the clipped
    gradient times 1 - b1) error relative to each leaf's max, and, after
    the last step, the parameters' largest error with its element's
    gradient on both sides."""
    n = len(res["losses"])
    row = dict(
        loss_rel_err=max(abs(a - b) / abs(b)
                         for a, b in zip(res["losses"], ref["losses"][:n])),
        grad_norm_rel_err=max(abs(a - b) / abs(b) for a, b in
                              zip(res["grad_norms"], ref["grad_norms"][:n])),
        grad_rel_err=max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(res["mu"], ref["mu"])))
    if "params" in res:
        diffs = [(a - b).abs() for a, b in zip(res["params"], ref["params"])]
        i = max(range(len(diffs)), key=lambda j: float(diffs[j].max()))
        at = int(diffs[i].argmax())
        # The worst element's clipped gradient on each side (the first
        # moment over 1 - b1) and its leaf's largest.
        g_mesh, g_ref = (float(t["mu"][i].flatten()[at]) / (1 - b1) for t in (res, ref))
        row.update(param_max_abs_err=float(diffs[i].max()),
                   worst_param=dict(
                       leaf=i, shape=list(diffs[i].shape), index=at, grad=g_mesh,
                       unsharded_grad=g_ref,
                       leaf_max_abs_grad=float(ref["mu"][i].abs().max()) / (1 - b1)))
    return row


def mesh_rank() -> dict:
    """One of phase 34's 4 gloo ranks, every one on cuda:0: the ring at
    Llama-3-8B's attention width with its controls, the quantized ring
    with its controls, the base model trained on {ctx 4} and {data 2,
    model 2}, fp32 parity at 2 layers with controls, and the scaling
    benchmark's layouts.  Every rank returns its launch counts on the
    path; rank 0 also the checks and times."""
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.kernels.attention import flash_attention
    from cuda_flash_attention_tpu_torch.kernels.fa2_forward_quant import (
        flash_attention_quantized_kv,
    )
    from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES, reset
    from cuda_flash_attention_tpu_torch.models import training, transformer
    from cuda_flash_attention_tpu_torch.parallel import ring
    from cuda_flash_attention_tpu_torch.parallel.collectives import Exchange
    from cuda_flash_attention_tpu_torch.parallel.distributed import scaling_rank
    from cuda_flash_attention_tpu_torch.parallel.mesh import (
        CTX_AXIS,
        DATA_AXIS,
        make_device_mesh,
    )
    from cuda_flash_attention_tpu_torch.parallel.sharded import shard
    from cuda_flash_attention_tpu_torch.quant.qtensor import quantize_kv

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    launches = collections.Counter()
    out = {"seconds": {}}
    t_section = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        out["seconds"][name] = now - t_section[0]
        t_section[0] = now

    def counted(fn):
        """fn() on the mesh path: its launches join the phase's counts."""
        reset()
        res = fn()
        torch.cuda.synchronize()
        for name in MESH_KERNELS:
            launches[name] += LAUNCHES[name]
        return res

    def wall(fn):
        """(fn(), wall ms) with every rank starting together."""
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def max_over_ranks(x: float) -> float:
        t = torch.tensor([x], device="cuda")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    # (a) The ring at Llama-3-8B's attention width, forward and gradients,
    # against flash_attention on the whole sequence.
    ctx = make_device_mesh({CTX_AXIS: world}, device="cuda")
    spec = (None, None, CTX_AXIS, None)
    c = MESH_RING
    g = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q = randn(c["b"], c["hq"], c["s"], c["d"])
    k, v = randn(c["b"], c["hkv"], c["s"], c["d"]), randn(c["b"], c["hkv"], c["s"], c["d"])
    do = randn(c["b"], c["hq"], c["s"], c["d"])
    peaky = q * MESH_PEAKY

    def ring_call(qq, causal, window, backward=True):
        ql, kl, vl = (shard(x, ctx, spec).requires_grad_(backward) for x in (qq, k, v))

        def run():
            o = ring.ring_attention(ctx, ql, kl, vl, causal=causal, window=window)
            if backward:
                o.backward(shard(do, ctx, spec))
            return o.detach()

        o, ms = wall(run)
        return (o, ql.grad, kl.grad, vl.grad), ms

    def reference(causal, window):
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (peaky, k, v))
        o, fwd_ms = wall_solo(torch, lambda: flash_attention(
            qr, kr, vr, causal=causal, window=window))
        _, bwd_ms = wall_solo(torch, lambda: o.backward(do))
        return ([shard(t, ctx, spec) for t in (o.detach(), qr.grad, kr.grad, vr.grad)],
                fwd_ms, fwd_ms + bwd_ms)

    # gloo opens a pair's connection at its first message: open them here,
    # outside the timed calls.
    Exchange([torch.zeros(1, device="cuda")], ctx, CTX_AXIS).wait()
    ring_rows = []
    for window in (None, MESH_RING_WINDOW):
        route = ring.backward_route(shard(q, ctx, spec), shard(k, ctx, spec),
                                    causal=True, window=window)
        blocks = [shard(x, ctx, spec) for x in (peaky, k, v)]
        fwd = counted(lambda: wall(lambda: ring.ring_attention(
            ctx, *blocks, causal=True, window=window)))[1]
        del blocks
        got, total = counted(lambda: ring_call(peaky, True, window))
        # The reference in one rank at a time: rank 0's alone is timed.
        ref = None
        for r in range(world):
            dist.barrier()
            if r == rank:
                ref = reference(True, window)
        want, ref_fwd, ref_total = ref
        errs = {n: _rel_err(torch, a, b, world)
                for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        # Control 1: the last live rotation dropped (forward).
        steps = ring._live_ring_steps
        ring._live_ring_steps = lambda *a: steps(*a) - 1
        try:
            ctrl, _ = ring_call(peaky, True, window, backward=False)
        finally:
            ring._live_ring_steps = steps
        ctrl_o = _rel_err(torch, ctrl[0], want[0], world)
        row = dict(case="causal" if window is None else f"causal window {window}",
                   S=c["s"], S_per_rank=c["s"] // world, backward_route=route,
                   live_steps=steps(world, True, window, c["s"] // world),
                   rel_err=errs, control_last_rotation_dropped_rel_err=ctrl_o,
                   ring_fwd_ms=max_over_ranks(fwd),
                   ring_fwd_bwd_ms=max_over_ranks(total),
                   whole_sequence_fwd_ms=ref_fwd, whole_sequence_fwd_bwd_ms=ref_total)
        if window is not None:
            # Control 2: dK/dV not sent home (a 3-hop exchange after the
            # window's 2 live steps; the 1-hop one of the global ring would
            # cost a second global backward).
            home = ring._send_home
            ring._send_home = lambda dk, dv, *a: (dk, dv)
            try:
                ctrl2, _ = ring_call(peaky, True, window)
            finally:
                ring._send_home = home
            row["control_no_home_hop_rel_err"] = {
                n: _rel_err(torch, ctrl2[i], want[i], world)
                for i, n in ((2, "dk"), (3, "dv"))}
        ring_rows.append(row)
        del got, want, ref, ctrl
    out["ring"] = ring_rows
    section("ring")

    # (b) The quantized ring (B7) at the same shape: on the peaky queries
    # against B7 on the whole sequence, on the unscaled inputs against the
    # bf16 ring (B1) on the same blocks; each with the ring without its
    # first step (each rank's own shard: the diagonal, when causal) as the
    # control.
    kind = ring._step_kind

    def quant_ring(blocks, kv_dtype, causal, control=False):
        if control:
            ring._step_kind = lambda causal, idx, step, n: (
                "skip" if step == 0 else kind(causal, idx, step, n))
        try:
            return ring.ring_attention_quantized(ctx, *blocks, kv_dtype=kv_dtype,
                                                 causal=causal)
        finally:
            ring._step_kind = kind

    sharp = [shard(x, ctx, spec) for x in (peaky, k, v)]
    unscaled = [shard(x, ctx, spec) for x in (q, k, v)]
    bf16 = {}
    quant_rows = []
    for name, causal in MESH_QUANT:
        kv_dtype = name if name == "int4" else getattr(torch, name)
        if causal not in bf16:
            bf16[causal] = wall(lambda: ring.ring_attention(ctx, *unscaled, causal=causal))
        oq, ms = counted(lambda: wall(lambda: quant_ring(unscaled, kv_dtype, causal)))
        o_sharp = counted(lambda: quant_ring(sharp, kv_dtype, causal))
        kq, vq = quantize_kv(k, v, kv_dtype)
        whole = shard(flash_attention_quantized_kv(peaky, kq, vq, causal=causal),
                      ctx, spec)
        del kq, vq
        ctrl_sharp = quant_ring(sharp, kv_dtype, causal, control=True)
        ctrl_unscaled = quant_ring(unscaled, kv_dtype, causal, control=True)
        o_bf16, bf16_ms = bf16[causal]
        quant_rows.append(dict(
            kv_dtype=name, causal=causal,
            whole_sequence_rel_err=_rel_err(torch, o_sharp, whole, world),
            control_whole_sequence_rel_err=_rel_err(torch, ctrl_sharp, whole, world),
            bf16_ring_mean_rel_err=_mean_rel_err(torch, oq, o_bf16),
            control_bf16_ring_mean_rel_err=_mean_rel_err(torch, ctrl_unscaled, o_bf16),
            bf16_ring_rel_err=_rel_err(torch, oq, o_bf16, world),
            ms=max_over_ranks(ms), bf16_ring_ms=max_over_ranks(bf16_ms)))
        del oq, o_sharp, whole, ctrl_sharp, ctrl_unscaled
    out["quant_ring"] = quant_rows
    del q, k, v, do, peaky, bf16, sharp, unscaled
    torch.cuda.empty_cache()
    section("quant_ring")

    # (c) TransformerConfig.base() trained one AdamW step on {ctx 4} (8192
    # inputs, 2048 a rank) and on {data 2, model 2} (B4 S2048), beside the
    # unsharded step ((d) holds two steps' values).
    cfg = transformer.TransformerConfig.base()
    full = transformer.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                   device="cuda")
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=0, decay_steps=100)
    train_rows = {}
    for layout, shape, tshape in (("ctx4", {CTX_AXIS: world}, (1, 8193)),
                                  ("dp2_tp2", {DATA_AXIS: 2, "model": 2}, (4, 2049))):
        mesh = make_device_mesh(shape, device="cuda")
        tokens = torch.from_numpy(np.random.default_rng(34).integers(
            0, cfg.vocab_size, tshape)).cuda()
        state = training.init_train_state(transformer.shard_params(full, mesh, cfg), opt)
        step = training.make_optax_train_step(cfg, opt, mesh=mesh)
        losses, times = [], []
        for _ in range(MESH_BASE_STEPS):
            (state, m), ms = counted(lambda: wall(lambda: step(state, tokens)))
            losses.append(float(m["loss"]))
            times.append(ms)
        del state
        torch.cuda.empty_cache()
        row = dict(tokens=list(tshape), losses=losses,
                   step_ms=[max_over_ranks(t) for t in times],
                   peak_gib=max_over_ranks(torch.cuda.max_memory_allocated() / 2 ** 30))
        dist.barrier()
        if rank == 0:
            state1 = training.init_train_state(full, opt)
            step1 = training.make_optax_train_step(cfg, opt)
            ref, ref_ms = [], []
            for _ in range(MESH_BASE_STEPS):
                (state1, m), ms = wall_solo(torch, lambda: step1(state1, tokens))
                ref.append(float(m["loss"]))
                ref_ms.append(ms)
            row.update(unsharded_losses=ref, unsharded_step_ms=ref_ms)
            del state1
            torch.cuda.empty_cache()
        dist.barrier()
        train_rows[layout] = row
    out["train"] = train_rows
    del full
    torch.cuda.empty_cache()
    section("train")

    # (d) fp32 parity at 2 layers of the same width: two AdamW steps (no
    # warmup) on each layout against the unsharded steps: the losses and
    # grad_norms, the first step's gradients (its first Adam moment) and
    # the parameters after the second.  The step size is 1e-4: at 1e-3
    # ctx4's parameters read 1.03e-4 off (atol 1e-4) with the loss 8.7e-8
    # off.  Adam moves an element by lr * g / (|g| + eps), which turns the
    # fp32 reassociation of a sharded sum into up to a whole step where |g|
    # is near eps; the worst element's gradient is printed to show it.
    # Each layout's control must fail: one step, its gradients checked.
    cfg32 = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=2)
    p32 = transformer.init_params(torch.Generator(device="cuda").manual_seed(1), cfg32,
                                  device="cuda")
    opt32 = training.make_optimizer(learning_rate=1e-4, warmup_steps=0, decay_steps=10)
    tokens32 = torch.from_numpy(np.random.default_rng(35).integers(
        0, cfg32.vocab_size, (2, 257))).cuda()

    def steps32(mesh, n=2):
        return mesh_adamw_steps(transformer, training, cfg32, p32, opt32, tokens32,
                                mesh, n)

    summed = transformer.all_reduce_coalesced

    parity = {}
    for layout, shape in (("ctx4", {CTX_AXIS: world}),
                          ("dp2_tp2", {DATA_AXIS: 2, "model": 2})):
        mesh = make_device_mesh(shape, device="cuda")
        res = counted(lambda: steps32(mesh))
        if layout == "ctx4":
            steps = ring._live_ring_steps
            ring._live_ring_steps = lambda *a: steps(*a) - 1
            try:
                ctrl = steps32(mesh, n=1)
            finally:
                ring._live_ring_steps = steps
        else:
            # value_and_grad's sum of the gradients over data left out.
            transformer.all_reduce_coalesced = lambda grads, *a: list(grads)
            try:
                ctrl = steps32(mesh, n=1)
            finally:
                transformer.all_reduce_coalesced = summed
        parity[layout] = (res, ctrl)
    dist.barrier()
    if rank == 0:
        ref = steps32(None)

        def compare(res):
            return compare_adamw_steps(res, ref, opt32.b1)

        out["fp32_parity"] = {
            layout: dict(**compare(res), control=compare(ctrl),
                         control_kind="ring's last live rotation dropped"
                         if layout == "ctx4" else "gradients not summed over data")
            for layout, (res, ctrl) in parity.items()}
    dist.barrier()
    del p32, parity
    torch.cuda.empty_cache()
    section("fp32_parity")

    # (e) The scaling benchmark's three layouts (tiny model, batch 8, 512;
    # one timed step after the warm-up).
    out["scaling"] = scaling_rank("cuda", 8, 512, 1, transformer.TransformerConfig.tiny())
    section("scaling")

    # Serving on the mesh (mesh_serving), its launches apart.
    serve_launches = collections.Counter()

    def counted_serving(fn):
        reset()
        res = fn()
        torch.cuda.synchronize()
        for name in MESH_SERVE_KERNELS:
            serve_launches[name] += LAUNCHES[name]
        return res

    out["serving"] = mesh_serving(rank, counted_serving)
    section("serving")
    # (f)-(i) Pipeline and expert parallelism (mesh_pp_ep).
    out["pp_ep"] = mesh_pp_ep(rank, counted, counted_serving, wall, max_over_ranks)
    section("pp_ep")
    out["pp_ep_launches"] = out["pp_ep"].pop("launches")
    out["launches"] = dict(launches)
    out["serve_launches"] = dict(serve_launches)
    keep = ("launches", "serve_launches", "pp_ep_launches")
    return out if rank == 0 else {k: out[k] for k in keep}


# Phase 34's serving on the mesh: Llama-3-8B's widths (LLAMA3_8B) with
# seeded random weights.  fp32 parity at 2 layers on {model 4} and {data 2,
# model 2}: 4 prompts (300 tokens, prefilled in 128-token chunks, and 37,
# 100 and 5 tokens, one bucket prefill), 6 greedy tokens each, and on {data
# 2, model 2} the same with a 1-layer draft at spec 2, against the engine
# without a mesh on the card (the same weights; eager, so that each of its
# steps' logits can be read).  Gates: the tokens equal, and every decode
# step's and speculative verification's logits within MESH_SERVE_LOGIT_TOL
# of their max, a limit between the readings and the controls' (PERF.md
# §6).  Controls that must fail both gates: on {model 4} the
# all-reduce after wo left out (each rank keeps its partial sums), on
# {data 2, model 2} every query head attending the next KV head's pages.
# Then bf16 weights on an int8 cache at 4 layers on {model 4}: 8 prompts
# of 128 tokens, 16 tokens each, tokens/s and TPOT, beside the same run of
# the engine without a mesh on rank 0 (its steps captured, and eager).
MESH_SERVE_KERNELS = ("fa2_forward", "fa2_forward_small", "paged_decode",
                      "paged_chunk")
MESH_SERVE_LOGIT_TOL = 1e-3
MESH_SERVE_PROMPTS = (300, 37, 100, 5)
MESH_SERVE_LAYERS = {"fp32": 2, "bf16": 4}


def mesh_serving(rank: int, counted) -> dict:
    """Phase 34 (b)'s serving part in one of the 4 gloo ranks (the module
    note above MESH_SERVE_KERNELS); `counted(fn)` runs fn on the counted
    path.  Rank 0 also runs the unsharded references and holds the gates'
    readings."""
    import contextlib
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.decode import engine as eng_mod
    from cuda_flash_attention_tpu_torch.decode import model as model_mod
    from cuda_flash_attention_tpu_torch.models import transformer
    from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather
    from cuda_flash_attention_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        make_device_mesh,
    )
    from cuda_flash_attention_tpu_torch.utils import hf_convert

    def config(layers, **kw):
        hf = types.SimpleNamespace(**dict(LLAMA3_8B, num_hidden_layers=layers))
        return hf_convert.config_from_hf(hf, **kw)

    cfg = config(MESH_SERVE_LAYERS["fp32"], dtype=torch.float32,
                 attn_tile_dtype=None)
    params = transformer.init_params(torch.Generator(device="cuda").manual_seed(37),
                                     cfg, device="cuda")
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in MESH_SERVE_PROMPTS]
    new = 6
    record = {"target": None, "mesh": None, "logits": []}

    def recorded(fn):
        """The engine's decode_step / verify_step, keeping the target's
        logits of every decode step and speculative verification (on a
        mesh every slot's rows and the whole vocabulary: gathered over data
        and model)."""
        def call(p, *a, **kw):
            logits, caches = fn(p, *a, **kw)
            if p is record["target"] and not kw.get("paged_write"):
                full, mesh = logits, record["mesh"]
                if mesh is not None:
                    full = all_gather(all_gather(logits, mesh, MODEL_AXIS, -1), mesh,
                                      DATA_AXIS, 0)
                if rank == 0:
                    record["logits"].append(full.clone())
            return logits, caches
        return call

    step_graph = eng_mod.StepGraph

    class EagerStep(step_graph):
        """A step that runs eagerly on the card too (the reference's, so
        that each step's logits can be read)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, eager=True))

    @contextlib.contextmanager
    def eager_steps(eager: bool):
        """The engines made and run inside step eagerly, with `eager`."""
        eng_mod.StepGraph = EagerStep if eager else step_graph
        try:
            yield
        finally:
            eng_mod.StepGraph = step_graph

    def serve(mesh, spec: bool, eager=False):
        kw = dict(draft_params=dict(params, layers=params["layers"][:1]),
                  draft_cfg=draft_cfg, spec_tokens=2) if spec else {}
        with eager_steps(eager):
            eng = eng_mod.DecodeEngine(params, cfg, max_seqs=4, max_seq_len=512,
                                       cache_dtype=torch.float32, prefill_chunk=128,
                                       mesh=mesh, **kw)
            record.update(target=eng.params, mesh=mesh, logits=[])
            reqs = eng.run(prompts, max_new_tokens=new)
        tokens = [r.generated for r in reqs]
        if mesh is not None:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, tokens)
            if any(t != tokens for t in every):
                raise AssertionError(f"phase 34 serving: the ranks disagree: {every}")
        ok = all(r.done for r in reqs) and all(
            a.available == a.num_pages - 1 for a in eng._group_allocs)
        stats = dict(eng.stats)
        del eng
        gc.collect()
        return tokens, record["logits"], ok, stats

    saved = {n: getattr(eng_mod, n) for n in ("decode_step", "verify_step")}
    for n, fn in saved.items():
        setattr(eng_mod, n, recorded(fn))
    out = {}
    try:
        ref = {}
        dist.barrier()
        if rank == 0:
            for spec in (False, True):
                ref[spec] = serve(None, spec, eager=True)
        dist.barrier()

        def compare(run, spec):
            tokens, logits, ok, stats = run
            if rank != 0:
                return {}
            want_tokens, want_logits = ref[spec][0], ref[spec][1]
            errs = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(logits, want_logits)]
            return dict(tokens_equal=tokens == want_tokens, steps=len(logits),
                        ref_steps=len(want_logits), logits_rel_err=max(errs),
                        drained=ok, graphs=stats["graphs"],
                        spec_rounds=stats["spec_rounds"],
                        prefill_chunks=stats["prefill_chunks"])

        attn_out = model_mod._attn_out
        rolled = {n: getattr(model_mod, n)
                  for n in ("paged_decode_attention", "paged_chunk_attention")}

        def roll(fn):  # each query head attends the next KV head's pages
            def call(q, pages, *a, **kw):
                group = q.shape[-2] // pages.k_pages.shape[0]
                return fn(q.roll(group, dims=-2), pages, *a, **kw)
            return call

        for layout, shape in (("model4", {MODEL_AXIS: 4}),
                              ("dp2_tp2", {DATA_AXIS: 2, MODEL_AXIS: 2})):
            mesh = make_device_mesh(shape, device="cuda")
            row = {"greedy": compare(counted(lambda: serve(mesh, False)), False)}
            if layout == "dp2_tp2":  # the speculative run
                row["spec"] = compare(counted(lambda: serve(mesh, True)), True)
            if layout == "model4":
                model_mod._attn_out = lambda x, o, layer, m: attn_out(x, o, layer, None)
                kind = "the all-reduce after wo left out"
            else:
                for n, fn in rolled.items():
                    setattr(model_mod, n, roll(fn))
                kind = "each query head attending the next KV head's pages"
            try:
                row["control"] = dict(compare(serve(mesh, False), False), kind=kind)
            finally:
                model_mod._attn_out = attn_out
                for n, fn in rolled.items():
                    setattr(model_mod, n, fn)
            out[layout] = row
    finally:
        for n, fn in saved.items():
            setattr(eng_mod, n, fn)
    del params, ref
    torch.cuda.empty_cache()

    # bf16 weights, int8 cache, 4 layers on {model 4}: tokens/s and TPOT.
    cfg16 = config(MESH_SERVE_LAYERS["bf16"], param_dtype=torch.bfloat16)
    p16 = transformer.init_params(torch.Generator(device="cuda").manual_seed(38),
                                  cfg16, device="cuda")
    mix = np.random.default_rng(38).integers(0, cfg16.vocab_size, (8, 128)).tolist()

    def timed(mesh, run=lambda fn: fn(), eager=False):
        """The mix's tokens/s, TPOT and step time on `mesh` (None: the
        engine without one), after one short run for the kernels' first
        calls."""
        with eager_steps(eager):
            eng = eng_mod.DecodeEngine(p16, cfg16, max_seqs=8, max_seq_len=2048,
                                       cache_dtype=torch.int8, prefill_chunk=512,
                                       mesh=mesh)
            eng.run([mix[0][:64]], max_new_tokens=2)
            torch.cuda.synchronize()
            if mesh is not None:
                dist.barrier()
            steps0 = eng.stats["steps"]
            t0 = time.perf_counter()
            reqs = run(lambda: eng.run(mix, max_new_tokens=16))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        total = sum(len(r.generated) for r in reqs)
        steps = eng.stats["steps"] - steps0
        res = dict(
            layers=cfg16.n_layers, requests=len(reqs), tokens=total,
            seconds=elapsed, tokens_per_s=total / elapsed,
            tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
            ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
            engine_step_ms=elapsed / max(steps, 1) * 1e3, steps=steps,
            graphs=eng.stats["graphs"] and not eager,
            graph_replays=eng.graph_replays, done=all(r.done for r in reqs),
            drained=eng.allocator.available == eng.num_pages - 1)
        del eng
        gc.collect()  # captured graphs hold their engine in reference cycles
        torch.cuda.empty_cache()
        return res

    mesh = make_device_mesh({MODEL_AXIS: 4}, device="cuda")
    out["bf16_int8"] = dict(
        timed(mesh, counted),
        logits_gather_bytes_per_step=8 * cfg16.vocab_size * 4)
    if rank == 0:
        out["bf16_int8_no_mesh"] = {k: timed(None, eager=k == "eager")
                                    for k in ("graphs", "eager")}
    del p16
    dist.barrier()
    torch.cuda.empty_cache()
    return out


def phase_mesh_serving_gates(out):
    """Phase 34 (b)'s serving gates on rank 0's readings."""
    if not out["dp2_tp2"]["spec"]["spec_rounds"]:
        raise AssertionError(f"phase 34 serving: no speculative round: {out}")
    for layout in ("model4", "dp2_tp2"):
        row = out[layout]
        for run in ("greedy", "spec"):
            r = row.get(run)
            if r is not None and not (
                    r["tokens_equal"] and r["steps"] == r["ref_steps"] and r["drained"]
                    and r["logits_rel_err"] <= MESH_SERVE_LOGIT_TOL):
                raise AssertionError(f"phase 34 serving {layout} {run}: {r}")
        if not row["greedy"]["prefill_chunks"]:
            raise AssertionError(f"phase 34 serving {layout}: a path did not run: {row}")
        c = row["control"]
        if c["tokens_equal"] or c["logits_rel_err"] <= MESH_SERVE_LOGIT_TOL:
            raise AssertionError(f"phase 34 serving {layout}: the control passed: {c}")
    b = out["bf16_int8"]
    if not (b["done"] and b["drained"] and not b["graphs"]):
        raise AssertionError(f"phase 34 serving bf16/int8: {b}")
    for name, r in out["bf16_int8_no_mesh"].items():
        if not (r["done"] and r["drained"] and r["tokens"] == b["tokens"]
                and r["graphs"] == (name == "graphs")
                and (r["graph_replays"] > 0) == r["graphs"]):
            raise AssertionError(f"phase 34 serving bf16/int8 without a mesh: {out}")


# ---------------------------------------------------------------------------
# Phase 34 (f)-(i): pipeline parallelism (models/pipeline.py) and expert
# parallelism (models/moe.py), in the same spawn of the 4 gloo ranks on the
# card (4 ranks on one H100, not multi-GPU scaling).
#   (f) Llama-3-8B's widths (LLAMA3_8B) at 4 layers, bf16 activations on
#       fp32 weights, trained by make_pp_train_step (SGD with momentum) on
#       {pipe 4} and {pipe 2, model 2}: B4 S1024 in 4 microbatches, two
#       steps on one batch.  Each rank draws only its stage (its layers'
#       blocks, the embedding on stage 0, the head on the last).  Gates:
#       finite losses that fall, stage 0's and the last stage's weights
#       moved (JAX test_pp_train_step_runs_and_learns).
#   (g) The pipeline's fp32 parity at the base width, 4 layers on {pipe 4},
#       4 microbatches: the loss and every stage's gradients
#       (pp_value_and_grad) and one step's parameters against the
#       unsharded model forwarded over all S tokens with JAX
#       make_pp_loss_fn's NLL; control: one microbatch's shift delivered
#       as zeros.
#   (h) Mixtral-8x7B's widths (MIXTRAL_8X7B) served on {expert 4} and
#       {expert 2, model 2}, each rank drawing only its blocks (the
#       engine's shard_params then keeps them as they are): fp32 at 2
#       layers on an fp32 cache (MESH_SERVE_PROMPTS, chunked prefill 128,
#       6 greedy tokens) against the engine without a mesh on rank 0 (the
#       same draws): tokens equal and every decode step's logits within
#       MESH_SERVE_LOGIT_TOL of their max; control: one rank's expert
#       outputs zeroed.  bf16 weights on an int8 cache at 8 layers, 8
#       prompts of 64 tokens, 16 each: tokens/s, TPOT and step time beside
#       rank 0's engine without a mesh.
#   (i) Mixtral's widths trained at 1 layer, B1 S2048, AdamW on bf16
#       weights (phase 32's; fp32 weights with AdamW's state, held twice
#       while the functional update builds the new trees, passed 18 GiB a
#       rank, more than 4 ranks fit on the card), two steps on {expert 4}
#       and {expert 2, model 2}: finite losses, step time, peak memory.  The fp32 parity of a small-width MoE model (8 experts in
#       every layer) against the unsharded steps under (d)'s gates;
#       control: the expert outputs gathered by gather_from, which sums
#       their gradient over "expert" (counting the one combine once a
#       rank).
MESH_PP = dict(layers=4, batch=4, seq=1024, micro=4, steps=2, lr=1e-2)
MESH_PP_PARITY = dict(layers=4, batch=4, seq=257, micro=4, lr=1e-3)
MESH_EP_SERVE_LAYERS = {"fp32": 2, "bf16": 8}
MESH_EP_MIX = (8, 64)  # bf16 timing: 8 prompts of 64 tokens
MESH_EP_TRAIN = dict(layers=1, batch=1, seq=2048, steps=2)
MESH_EP_PARITY = dict(vocab_size=4096, d_model=512, n_layers=2, n_heads=8,
                      n_kv_heads=4, head_dim=64, d_ff=1024, n_experts=8,
                      moe_every=1)


def draw_layer(torch, transformer, cfg, i: int, seed: int, mesh=None) -> dict:
    """Layer i of cfg drawn on the card on its own, as this rank's blocks
    with a mesh (param_split_dims; whole without one).  Its attention, norms
    and dense SwiGLU come from init_params' 1-layer, 8-token-vocabulary
    dense twin (its layer draws come first) with a generator seeded seed +
    i; an MoE layer's router from that generator next, and each expert's
    gate, up and down from a generator of its own, so that a rank draws only
    its own experts and the model without a mesh draws the same values."""
    specs = transformer.param_split_dims(cfg, mesh)["layers"][i]

    def cut(x, spec):
        return x if mesh is None else transformer._split(x, spec, mesh).contiguous()

    one = dataclasses.replace(cfg, n_layers=1, vocab_size=8, n_experts=0)
    g = torch.Generator(device="cuda").manual_seed(seed + i)
    layer = transformer.init_params(g, one, device="cuda")["layers"][0]
    if not cfg.is_moe_layer(i):
        return {k: cut(v, specs[k]) for k, v in layer.items()}
    out = {k: cut(layer[k], specs[k]) for k in ("attn_norm", "wq", "wk", "wv", "wo",
                                                 "mlp_norm")}
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    out["router"] = (torch.randn((d, e), generator=g, device="cuda")
                     * d ** -0.5).to(cfg.param_dtype)
    for n, (k, shape) in enumerate((("moe_gate", (d, f)), ("moe_up", (d, f)),
                                    ("moe_down", (f, d)))):
        ep = 1 if mesh is None or specs[k][0] is None else mesh.size(specs[k][0])
        first = 0 if ep == 1 else mesh.index(specs[k][0]) * (e // ep)
        experts = []
        for x in range(first, first + e // ep):
            ge = torch.Generator(device="cuda").manual_seed(seed * 10_000 + i * 100 + x * 3 + n)
            w = (torch.randn(shape, generator=ge, device="cuda") * shape[0] ** -0.5).to(
                cfg.param_dtype)
            experts.append(cut(w, specs[k][1:]))
        out[k] = torch.stack(experts)
    return out


def draw_embed_head(torch, cfg, seed: int):
    """An N(0, 1) embedding and an N(0, 1/d) head, whole, from seed - 1."""
    g = torch.Generator(device="cuda").manual_seed(seed - 1)
    d, v = cfg.d_model, cfg.vocab_size
    embed = torch.randn((v, d), generator=g, device="cuda").to(cfg.param_dtype)
    head = (torch.randn((d, v), generator=g, device="cuda") * d ** -0.5).to(cfg.param_dtype)
    return embed, head


def draw_layers(torch, transformer, cfg, seed: int, mesh, layers) -> list:
    """draw_layer's layers `layers` (this rank's blocks with a mesh), the
    draws' spare memory handed back."""
    out = [draw_layer(torch, transformer, cfg, i, seed, mesh) for i in layers]
    torch.cuda.empty_cache()
    return out


def draw_model(torch, transformer, cfg, seed: int, mesh=None) -> dict:
    """The model of draw_layer's layers and draw_embed_head's embedding and
    head; with a mesh, this rank's blocks of it, drawn leaf by leaf."""
    embed, head = draw_embed_head(torch, cfg, seed)
    if mesh is not None:
        head = transformer._split(head, transformer.param_split_dims(cfg)["lm_head"],
                                  mesh).contiguous()
    return {"embed": embed,
            "layers": draw_layers(torch, transformer, cfg, seed, mesh, range(cfg.n_layers)),
            "final_norm": torch.ones(cfg.d_model, device="cuda", dtype=cfg.param_dtype),
            "lm_head": head}


def pp_stage(torch, transformer, cfg, mesh, seed: int) -> dict:
    """This rank's pipeline stage of draw_model's model: its layers' blocks
    over "model", the embedding on stage 0, the final norm and the (whole)
    head on the last (pipeline.shard_pipeline_params' layout)."""
    n, me = mesh.size("pipe"), mesh.index("pipe")
    per = cfg.n_layers // n
    stage = {"layers": draw_layers(torch, transformer, cfg, seed, mesh,
                                   range(me * per, (me + 1) * per))}
    if me in (0, n - 1):
        embed, head = draw_embed_head(torch, cfg, seed)
        if me == 0:
            stage["embed"] = embed
        if me == n - 1:
            stage.update(final_norm=torch.ones(cfg.d_model, device="cuda",
                                               dtype=cfg.param_dtype), lm_head=head)
    return stage


def pp_reference(torch, transformer, cfg, params, tokens):
    """make_pp_loss_fn's loss of the unsharded model (the mean next-token
    NLL over all S tokens; a dense model's aux is 0) and its gradient tree."""
    leaves = [p.detach().requires_grad_(True) for p in transformer.tree_leaves(params)]
    it = iter(leaves)
    wrt = transformer.tree_map(lambda _: next(it), params)
    logits = transformer.forward(wrt, tokens, cfg)[:, :-1]
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tokens[:, 1:, None])[..., 0]
    loss = nll.sum() / nll.numel()
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), transformer.tree_map(lambda _: next(grads), params)


class MeshPart:
    """What phase 34's parts (f)-(i) share inside a gloo rank: the rank,
    mesh_rank's `counted` / `counted_serving` runners (each part's launches
    also kept apart, by name), `wall` and `max_over_ranks`."""

    def __init__(self, rank: int, counted, counted_serving, wall, max_over_ranks):
        import collections

        self.rank, self.wall, self.max_over_ranks = rank, wall, max_over_ranks
        self._counted, self._counted_serving = counted, counted_serving
        self.launches = collections.defaultdict(collections.Counter)

    def run(self, name: str, fn, serving: bool = False):
        """fn() on the counted path, its launches also under `name`."""
        from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES

        res = (self._counted_serving if serving else self._counted)(fn)
        for k in MESH_SERVE_KERNELS if serving else MESH_KERNELS:
            self.launches[name][k] += LAUNCHES[k]
        return res

    @staticmethod
    def every_rank(obj) -> list:
        import torch.distributed as dist

        objs = [None] * dist.get_world_size()
        dist.all_gather_object(objs, obj)
        return objs

    @staticmethod
    @contextlib.contextmanager
    def patched(module, **attrs):
        """module's attributes set to `attrs` inside the block."""
        saved = {k: getattr(module, k) for k in attrs}
        for k, v in attrs.items():
            setattr(module, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(module, k, v)


def mesh_pp_llama(mp: MeshPart, lr: float = MESH_PP["lr"]) -> dict:
    """(f): the pipeline at Llama-3-8B's widths on {pipe 4} and {pipe 2,
    model 2} (the note above MESH_PP)."""
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.models import pipeline, transformer
    from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS, make_device_mesh
    from cuda_flash_attention_tpu_torch.utils import hf_convert

    hf = types.SimpleNamespace(**dict(LLAMA3_8B, num_hidden_layers=MESH_PP["layers"]))
    cfg = hf_convert.config_from_hf(hf)
    tokens = torch.from_numpy(np.random.default_rng(40).integers(
        0, cfg.vocab_size, (MESH_PP["batch"], MESH_PP["seq"]))).cuda()
    pp_rows = {}
    for layout, shape in (("pipe4", {"pipe": 4}), ("pipe2_tp2", {"pipe": 2, MODEL_AXIS: 2})):
        mesh = make_device_mesh(shape, device="cuda")
        n, me = mesh.size("pipe"), mesh.index("pipe")
        stage = pp_stage(torch, transformer, cfg, mesh, seed=400)
        before = stage["layers"][0]["wq"].clone()
        opt = transformer.init_opt_state(stage)
        step = pipeline.make_pp_train_step(cfg, mesh, n, MESH_PP["micro"],
                                           learning_rate=lr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(MESH_PP["steps"]):
            (stage, opt, loss), ms = mp.run("pipeline", lambda: mp.wall(
                lambda: step(stage, opt, tokens)))
            losses.append(float(loss))
            times.append(mp.max_over_ranks(ms))
        ranks = mp.every_rank(dict(
            stage=me, moved=float((stage["layers"][0]["wq"] - before).abs().max()),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
        del stage, opt, before, step
        torch.cuda.empty_cache()
        median = statistics.median(times)
        pp_rows[layout] = dict(
            layers=cfg.n_layers, tokens=list(tokens.shape), n_micro=MESH_PP["micro"],
            learning_rate=lr, losses=losses, step_ms=times,
            tokens_per_s=tokens.numel() / median * 1e3, ranks=ranks,
            first_stage_moved=min(r["moved"] for r in ranks if r["stage"] == 0),
            last_stage_moved=min(r["moved"] for r in ranks if r["stage"] == n - 1))
    return pp_rows



def mesh_pp_parity(mp: MeshPart) -> dict:
    """(g): the pipeline's fp32 parity at the base width on {pipe 4}, with
    its control."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.models import pipeline, transformer
    from cuda_flash_attention_tpu_torch.parallel.mesh import make_device_mesh

    c = MESH_PP_PARITY
    cfg32 = dataclasses.replace(transformer.TransformerConfig.base(
        dtype=torch.float32, attn_tile_dtype=None), n_layers=c["layers"])
    p32 = transformer.init_params(torch.Generator(device="cuda").manual_seed(41),
                                  cfg32, device="cuda")
    tok32 = torch.from_numpy(np.random.default_rng(41).integers(
        0, cfg32.vocab_size, (c["batch"], c["seq"]))).cuda()
    mesh = make_device_mesh({"pipe": 4}, device="cuda")
    stage = pipeline.shard_pipeline_params(pipeline.stack_pipeline_params(p32, 4), mesh)
    ref_loss, ref_grads = pp_reference(torch, transformer, cfg32, p32, tok32)
    ref_grads = pipeline.shard_pipeline_params(
        pipeline.stack_pipeline_params(ref_grads, 4), mesh)
    ref_new = transformer.tree_map(lambda p, g: p - c["lr"] * g, stage, ref_grads)

    def pp_errors(loss, grads, new=None):
        leaf = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(
            transformer.tree_leaves(grads), transformer.tree_leaves(ref_grads))]
        row = dict(loss_rel_err=abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
                   grad_rel_err=mp.max_over_ranks(max(leaf)))
        if new is not None:
            row["param_max_abs_err"] = mp.max_over_ranks(max(
                float((a - b).abs().max()) for a, b in zip(
                    transformer.tree_leaves(new), transformer.tree_leaves(ref_new))))
        return row

    loss, grads = mp.run("pipeline", lambda: pipeline.pp_value_and_grad(
        stage, tok32, cfg32, mesh, c["micro"]))
    new, _, _ = mp.run("pipeline", lambda: pipeline.make_pp_train_step(
        cfg32, mesh, 4, c["micro"], learning_rate=c["lr"])(
            stage, transformer.init_opt_state(stage), tok32))
    row = pp_errors(loss, grads, new)
    shift, dropped = pipeline.Shift, []

    def dropped_shift(tensors, mesh, axis, hops=1, **kw):
        """The first microbatch a stage receives in the forward, as zeros."""
        s = shift(tensors, mesh, axis, hops, **kw)
        if hops == 1 and s.recv and not dropped:
            dropped.append(True)
            wait = s.wait
            s.wait = lambda: [torch.zeros_like(t) for t in wait()]
        return s

    with mp.patched(pipeline, Shift=dropped_shift):
        row["control"] = dict(pp_errors(*pipeline.pp_value_and_grad(
            stage, tok32, cfg32, mesh, c["micro"])),
            kind="one microbatch's shift delivered as zeros")
    del p32, stage, ref_grads, ref_new, grads, new
    torch.cuda.empty_cache()
    return dict(row, tokens=list(tok32.shape), n_micro=c["micro"])



def _own_blocks(params, mesh, cfg):
    """The engine's shard_params for a tree that is already this rank's
    blocks (draw_model with the mesh)."""
    return params


def _eager_step_class(eng_mod):
    """decode/graphs.py's StepGraph with eager=True: steps run eagerly on
    the card too, so that each one's logits can be read."""
    class EagerStep(eng_mod.StepGraph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, eager=True))

    return EagerStep


def mesh_ep_serving(mp: MeshPart) -> dict:
    """(h)'s fp32 parity: expert-parallel serving at Mixtral-8x7B's widths
    on {expert 4} and {expert 2, model 2} against the engine without a
    mesh, with its control."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.decode import engine as eng_mod
    from cuda_flash_attention_tpu_torch.models import moe as moe_mod
    from cuda_flash_attention_tpu_torch.models import transformer
    from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather
    from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS, make_device_mesh

    keep = dict(shard_params=_own_blocks)
    eager = _eager_step_class(eng_mod)

    def serve(params, cfg, mesh, prompts, new, **kw):
        """Greedy tokens, every decode step's logits (the whole vocabulary,
        on rank 0) and whether the pages drained."""
        logits, decode = [], eng_mod.decode_step

        def recorded(p, *a, **k):
            out_, caches = decode(p, *a, **k)
            full = out_ if mesh is None else all_gather(out_, mesh, MODEL_AXIS, -1)
            if mp.rank == 0:
                logits.append(full.clone())
            return out_, caches

        with mp.patched(eng_mod, decode_step=recorded, StepGraph=eager, **keep):
            eng = eng_mod.DecodeEngine(params, cfg, mesh=mesh, **kw)
            reqs = eng.run(prompts, max_new_tokens=new)
        tokens = [r.generated for r in reqs]
        drained = all(a.available == a.num_pages - 1 for a in eng._group_allocs)
        del eng
        gc.collect()
        return tokens, logits, drained

    cfg = transformer.TransformerConfig(dtype=torch.float32, attn_tile_dtype=None, **dict(
        MIXTRAL_8X7B, n_layers=MESH_EP_SERVE_LAYERS["fp32"]))
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in MESH_SERVE_PROMPTS]
    kw = dict(max_seqs=4, max_seq_len=512, cache_dtype=torch.float32, prefill_chunk=128)
    ref = None
    dist.barrier()
    if mp.rank == 0:
        ref = serve(draw_model(torch, transformer, cfg, seed=420), cfg, None, prompts, 6,
                    **kw)
        torch.cuda.empty_cache()
    dist.barrier()

    def compare(run):
        tokens, logits, drained = run
        if any(t != tokens for t in mp.every_rank(tokens)):
            raise AssertionError(f"phase 34 (h): the ranks disagree: {tokens}")
        if mp.rank != 0:
            return {}
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(logits, ref[1])]
        return dict(tokens_equal=tokens == ref[0], steps=len(logits),
                    ref_steps=len(ref[1]), logits_rel_err=max(errs), drained=drained)

    ep_serve = {}
    for layout, shape in (("expert4", {"expert": 4}),
                          ("ep2_tp2", {"expert": 2, MODEL_AXIS: 2})):
        mesh = make_device_mesh(shape, device="cuda")
        params = draw_model(torch, transformer, cfg, seed=420, mesh=mesh)
        row = dict(local_experts=params["layers"][0]["moe_gate"].shape[0],
                   local_d_ff=params["layers"][0]["moe_gate"].shape[2])
        row.update(compare(mp.run("expert_serving", lambda: serve(
            params, cfg, mesh, prompts, 6, **kw), serving=True)))
        if layout == "expert4":
            ffn = moe_mod._expert_ffn

            def zeroed(*a, **k):  # rank 1's experts answer zeros
                y = ffn(*a, **k)
                return torch.zeros_like(y) if mp.rank == 1 else y

            with mp.patched(moe_mod, _expert_ffn=zeroed):
                row["control"] = dict(compare(serve(params, cfg, mesh, prompts, 6, **kw)),
                                      kind="rank 1's expert outputs zeroed")
        ep_serve[layout] = row
        del params
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    return ep_serve


def mesh_ep_serving_timed(mp: MeshPart) -> dict:
    """(h)'s timing: bf16 weights on an int8 cache at Mixtral-8x7B's widths
    on {expert 4} and {expert 2, model 2}, beside rank 0's engine without a
    mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.decode import engine as eng_mod
    from cuda_flash_attention_tpu_torch.models import transformer
    from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS, make_device_mesh

    keep = dict(shard_params=_own_blocks)
    ep_serve = {}
    cfg16 = transformer.TransformerConfig(param_dtype=torch.bfloat16, **dict(
        MIXTRAL_8X7B, n_layers=MESH_EP_SERVE_LAYERS["bf16"]))
    mix = np.random.default_rng(43).integers(0, cfg16.vocab_size, MESH_EP_MIX).tolist()

    def timed(mesh, eager=False):
        """The mix's tokens/s, TPOT and step time, after one short run for
        the kernels' first calls."""
        torch.cuda.reset_peak_memory_stats()
        params = draw_model(torch, transformer, cfg16, seed=430, mesh=mesh)
        attrs = dict(keep, StepGraph=_eager_step_class(eng_mod)) if eager else keep
        with mp.patched(eng_mod, **attrs):
            eng = eng_mod.DecodeEngine(params, cfg16, max_seqs=8, max_seq_len=1024,
                                       cache_dtype=torch.int8, prefill_chunk=512,
                                       mesh=mesh)
            del params
            eng.run([mix[0][:32]], max_new_tokens=2)
            torch.cuda.synchronize()
            if mesh is not None:
                dist.barrier()
            steps0 = eng.stats["steps"]
            t0 = time.perf_counter()
            reqs = eng.run(mix, max_new_tokens=16)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        total = sum(len(r.generated) for r in reqs)
        steps = eng.stats["steps"] - steps0
        res = dict(layers=cfg16.n_layers, requests=len(reqs), tokens=total,
                   seconds=elapsed, tokens_per_s=total / elapsed,
                   tpot_ms_median=statistics.median(r.tpot_s for r in reqs) * 1e3,
                   ttft_ms_median=statistics.median(r.ttft_s for r in reqs) * 1e3,
                   engine_step_ms=elapsed / max(steps, 1) * 1e3, steps=steps,
                   graphs=eng.stats["graphs"] and not eager,
                   done=all(r.done for r in reqs),
                   drained=eng.allocator.available == eng.num_pages - 1,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return res

    for layout, shape in (("expert4", {"expert": 4}),
                          ("ep2_tp2", {"expert": 2, MODEL_AXIS: 2})):
        mesh = make_device_mesh(shape, device="cuda")
        ep_serve[layout] = mp.run("expert_serving", lambda: timed(mesh), serving=True)
    dist.barrier()
    if mp.rank == 0:
        ep_serve["no_mesh"] = {k: timed(None, eager=k == "eager")
                               for k in ("graphs", "eager")}
    dist.barrier()
    return ep_serve



def mesh_ep_training(mp: MeshPart) -> tuple:
    """(i): expert-parallel training at Mixtral-8x7B's widths on {expert 4}
    and {expert 2, model 2}, and a small-width MoE model's fp32 parity with
    its control: (training rows, parity rows on rank 0)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cuda_flash_attention_tpu_torch.models import moe as moe_mod
    from cuda_flash_attention_tpu_torch.models import training, transformer
    from cuda_flash_attention_tpu_torch.parallel.mesh import MODEL_AXIS, make_device_mesh

    c = MESH_EP_TRAIN
    cfg = transformer.TransformerConfig(param_dtype=torch.bfloat16,
                                        **dict(MIXTRAL_8X7B, n_layers=c["layers"]))
    tokens = torch.from_numpy(np.random.default_rng(44).integers(
        0, cfg.vocab_size, (c["batch"], c["seq"] + 1))).cuda()
    opt = training.make_optimizer(learning_rate=1e-4, warmup_steps=0, decay_steps=100)
    ep_train = {}
    for layout, shape in (("expert4", {"expert": 4}),
                          ("ep2_tp2", {"expert": 2, MODEL_AXIS: 2})):
        mesh = make_device_mesh(shape, device="cuda")
        state = training.init_train_state(
            draw_model(torch, transformer, cfg, seed=440, mesh=mesh), opt)
        step = training.make_optax_train_step(cfg, opt, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(c["steps"]):
            (state, m), ms = mp.run("expert_training", lambda: mp.wall(lambda: step(state, tokens)))
            losses.append(float(m["loss"]))
            times.append(mp.max_over_ranks(ms))
        del state, step
        torch.cuda.empty_cache()
        ep_train[layout] = dict(
            layers=cfg.n_layers, tokens=list(tokens.shape), losses=losses, step_ms=times,
            tokens_per_s=c["batch"] * c["seq"] / statistics.median(times) * 1e3,
            peak_gib=[r for r in mp.every_rank(torch.cuda.max_memory_allocated() / 2 ** 30)])
    del tokens

    cfgp = transformer.TransformerConfig(dtype=torch.float32, attn_tile_dtype=None,
                                         **MESH_EP_PARITY)
    pp = transformer.init_params(torch.Generator(device="cuda").manual_seed(45), cfgp,
                                 device="cuda")
    optp = training.make_optimizer(learning_rate=1e-4, warmup_steps=0, decay_steps=10)
    tokp = torch.from_numpy(np.random.default_rng(45).integers(
        0, cfgp.vocab_size, (2, 257))).cuda()
    parity = {}
    for layout, shape in (("expert4", {"expert": 4}),
                          ("ep2_tp2", {"expert": 2, MODEL_AXIS: 2})):
        mesh = make_device_mesh(shape, device="cuda")
        res = mp.run("expert_training", lambda: mesh_adamw_steps(
            transformer, training, cfgp, pp, optp, tokp, mesh))
        with mp.patched(moe_mod, gather_replicated=moe_mod.gather_from):
            ctrl = mesh_adamw_steps(transformer, training, cfgp, pp, optp, tokp, mesh, n=1)
        parity[layout] = (res, ctrl)
    dist.barrier()
    rows = None
    if mp.rank == 0:
        ref = mesh_adamw_steps(transformer, training, cfgp, pp, optp, tokp, None)
        rows = {
            layout: dict(**compare_adamw_steps(res, ref, optp.b1),
                         control=compare_adamw_steps(ctrl, ref, optp.b1),
                         control_kind="expert outputs gathered by gather_from")
            for layout, (res, ctrl) in parity.items()}
    dist.barrier()
    del pp, parity
    torch.cuda.empty_cache()
    return ep_train, rows


def mesh_pp_ep(rank: int, counted, counted_serving, wall, max_over_ranks) -> dict:
    """Phase 34 (f)-(i) in one of the 4 gloo ranks (the note above
    MESH_PP); `counted(fn)` / `counted_serving(fn)` run fn on the counted
    training or serving path.  Every rank returns each part's launches;
    rank 0 also the readings."""
    import torch

    mp = MeshPart(rank, counted, counted_serving, wall, max_over_ranks)
    out = {}
    for key, part in (("pp_llama3", mesh_pp_llama), ("pp_fp32_parity", mesh_pp_parity),
                      ("ep_serving", mesh_ep_serving),
                      ("ep_serving_bf16", mesh_ep_serving_timed),
                      ("ep_train", mesh_ep_training)):
        # Every rank hands its spare memory back first: the 4 ranks share
        # the card, and each part fills most of it.
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = part(mp)
    out["ep_train"], out["ep_fp32_parity"] = out["ep_train"]
    out["launches"] = {k: dict(v) for k, v in mp.launches.items()}
    return out


def phase_mesh_pp_ep_gates(out):
    """Phase 34 (f)-(i)'s gates on rank 0's readings and the launches summed
    over the ranks."""
    for layout, row in out["pp_llama3"].items():
        losses = row["losses"]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                and row["first_stage_moved"] > 0 and row["last_stage_moved"] > 0):
            raise AssertionError(f"phase 34 (f) {layout}: {row}")
    row = out["pp_fp32_parity"]

    def pp_ok(r):
        return r["loss_rel_err"] <= MESH_LOSS_RTOL and r["grad_rel_err"] <= MESH_GRAD_TOL

    if not (pp_ok(row) and row["param_max_abs_err"] <= MESH_PARAM_ATOL) \
            or pp_ok(row["control"]):
        raise AssertionError(f"phase 34 (g): {row}")
    for layout in ("expert4", "ep2_tp2"):
        row = out["ep_serving"][layout]
        if not (row["tokens_equal"] and row["steps"] == row["ref_steps"] and row["drained"]
                and row["logits_rel_err"] <= MESH_SERVE_LOGIT_TOL):
            raise AssertionError(f"phase 34 (h) {layout}: {row}")
        b = out["ep_serving_bf16"][layout]
        if not (b["done"] and b["drained"] and not b["graphs"]):
            raise AssertionError(f"phase 34 (h) {layout} bf16/int8: {b}")
    ctrl = out["ep_serving"]["expert4"]["control"]
    if ctrl["tokens_equal"] and ctrl["logits_rel_err"] <= MESH_SERVE_LOGIT_TOL:
        raise AssertionError(f"phase 34 (h): the control passed: {ctrl}")
    for name, r in out["ep_serving_bf16"]["no_mesh"].items():
        if not (r["done"] and r["drained"]
                and r["tokens"] == out["ep_serving_bf16"]["expert4"]["tokens"]
                and r["graphs"] == (name == "graphs")):
            raise AssertionError(f"phase 34 (h) bf16/int8 without a mesh: {r}")
    for layout, row in out["ep_train"].items():
        if not all(math.isfinite(x) for x in row["losses"]):
            raise AssertionError(f"phase 34 (i) {layout}: {row}")

    def grads_ok(r):
        return (r["loss_rel_err"] <= MESH_LOSS_RTOL and r["grad_norm_rel_err"] <= MESH_LOSS_RTOL
                and r["grad_rel_err"] <= MESH_GRAD_TOL)

    for layout, row in out["ep_fp32_parity"].items():
        if not (grads_ok(row) and row["param_max_abs_err"] <= MESH_PARAM_ATOL) \
                or grads_ok(row["control"]):
            raise AssertionError(f"phase 34 (i) fp32 parity {layout}: {row}")
    launches = out["launches"]
    pp, ept, eps = (launches[k] for k in ("pipeline", "expert_training", "expert_serving"))

    def backward(c):
        return c["fa2_backward_fused"] or (c["fa2_backward_dq"] and c["fa2_backward_dkv"])

    if not (pp["fa2_forward"] and backward(pp) and ept["fa2_forward"] and backward(ept)
            and eps["fa2_forward"] and eps["paged_decode"] and eps["paged_chunk"]):
        raise AssertionError(f"phase 34 (f)-(i): a kernel of the path never ran: {launches}")


def wall_solo(torch, fn):
    """(fn(), wall ms) in one rank while the others wait."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def phase_mesh_nccl(torch, np, transformer, training, distributed, mesh_mod):
    """Phase 34 (a): one rank on NCCL.  initialize_distributed from the
    environment this phase sets (world size 1), a {data 1, model 1, ctx 1}
    mesh on cuda:0, and the base model's AdamW steps (B4 S2048, bf16) on it
    against the steps without a mesh from the same weights: with every axis
    of size 1 each collective is the identity and attention takes the
    head-parallel route (flash_attention), so losses and every parameter
    must be bitwise equal."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not distributed.initialize_distributed():
            raise AssertionError("phase 34: initialize_distributed did not start")
        backend = dist.get_backend()
        mesh = mesh_mod.make_device_mesh({"data": 1, "model": 1, "ctx": 1})
        cfg = transformer.TransformerConfig.base()
        params = transformer.init_params(torch.Generator(device="cuda").manual_seed(3),
                                         cfg, device="cuda")
        tokens = np.random.default_rng(36).integers(0, cfg.vocab_size, (4, 2049))
        opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=100)
        runs = {}
        for name, m in (("no_mesh", None), ("mesh", mesh)):
            state = training.init_train_state(params, opt)
            step = training.make_optax_train_step(cfg, opt, mesh=m)
            reset_counts(TRAIN_KERNELS)
            losses = []
            for _ in range(2):
                state, metrics = step(state, tokens)
                losses.append(metrics["loss"].item())
            runs[name] = (losses, transformer.tree_leaves(state.params),
                          read_counts(TRAIN_KERNELS))
        equal = runs["mesh"][0] == runs["no_mesh"][0] and all(
            torch.equal(a, b) for a, b in zip(runs["mesh"][1], runs["no_mesh"][1]))
        res = dict(backend=backend, mesh=mesh.shape, losses=runs["mesh"][0],
                   no_mesh_losses=runs["no_mesh"][0], bitwise_equal=equal,
                   launches=runs["mesh"][2])
        del state, runs
        res["serving"] = mesh_nccl_serving(torch, np, cfg, params, mesh)
        log("mesh one rank (NCCL)", json.dumps(res))
        if backend != "nccl" or not equal or not res["serving"]["bitwise_equal"]:
            raise AssertionError(f"phase 34 (a): {res}")
        return res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_nccl_serving(torch, np, cfg, params, mesh) -> dict:
    """Phase 34 (a)'s serving: the base model (bf16 serving copy, int8
    cache, chunked prefill 512, logprobs) on the world-1 NCCL mesh with its
    decode steps captured as CUDA graphs, against the engine without a
    mesh: 4 of phase 5's prompts, 16 greedy tokens each.  The tokens, every
    token's logprob (read off each step's logits inside the graph) and the
    logits of every prefill and prefill chunk must be bitwise equal."""
    from cuda_flash_attention_tpu_torch.decode import engine as eng_mod

    prompts = serving_mix(np, cfg)[:4]
    runs = {}
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        logits = []

        def kept(fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                logits.append(out[0].clone())
                return out
            return call

        saved = {n: getattr(eng_mod, n) for n in ("prefill_forward", "verify_step")}
        for n, fn in saved.items():
            setattr(eng_mod, n, kept(fn))
        try:
            eng = eng_mod.DecodeEngine(params, cfg, max_seqs=4, max_seq_len=2048,
                                       cache_dtype=torch.int8, prefill_chunk=512,
                                       logprobs=True, mesh=m)
            reset_counts(SERVING_KERNELS)
            reqs = eng.run(prompts, max_new_tokens=16)
            torch.cuda.synchronize()
            runs[name] = dict(tokens=[r.generated for r in reqs],
                              logprobs=[r.logprobs for r in reqs], logits=logits,
                              graphs=eng.stats["graphs"], replays=eng.graph_replays,
                              launches=read_counts(SERVING_KERNELS))
        finally:
            for n, fn in saved.items():
                setattr(eng_mod, n, fn)
        del eng
        gc.collect()  # the engine's captured graphs hold it in reference cycles
    a, b = runs["mesh"], runs["no_mesh"]
    equal = (a["tokens"] == b["tokens"] and a["logprobs"] == b["logprobs"]
             and len(a["logits"]) == len(b["logits"])
             and all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])))
    torch.cuda.empty_cache()
    return dict(bitwise_equal=equal and a["graphs"] and a["replays"] > 0,
                tokens_logprobs_logits_equal=equal,
                graphs=a["graphs"], graph_replays=a["replays"],
                logits_calls=len(a["logits"]),
                tokens=sum(len(t) for t in a["tokens"]), launches=a["launches"])


def phase_mesh_ranks(launch):
    """Phase 34 (b): mesh_rank on 4 gloo ranks sharing the card; the gates
    checked here on rank 0's results (every row logged first), the
    launches summed over the ranks."""
    # The ranks' allocators grow their segments in place: (f)'s pipeline
    # steps at Llama-3-8B's widths need ~15 GB a rank at once, and with
    # fixed segments the blocks freed by the earlier parts left ~4 GB a
    # rank unusable, more than the 4 ranks' share of the card allows.  The
    # spawned ranks read the setting at their first allocation; this
    # process's allocator is already made.
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        results = launch.run("chip_smoke:mesh_rank", 4, timeout=MESH_TIMEOUT)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    out = results[0]
    launches = {n: sum(r["launches"].get(n, 0) for r in results) for n in MESH_KERNELS}
    out["launches"] = launches
    out["serve_launches"] = {n: sum(r["serve_launches"].get(n, 0) for r in results)
                             for n in MESH_SERVE_KERNELS}
    pp_ep = out["pp_ep"]
    pp_ep["launches"] = {
        part: {n: sum(r["pp_ep_launches"].get(part, {}).get(n, 0) for r in results)
               for n in (MESH_SERVE_KERNELS if part == "expert_serving" else MESH_KERNELS)}
        for part in ("pipeline", "expert_training", "expert_serving")}
    card = card_line()
    for row in out["ring"]:
        log("mesh ring (4 ranks on one card)", card, json.dumps(row))
    for row in out["quant_ring"]:
        log("mesh quantized ring (4 ranks on one card)", card, json.dumps(row))
    for layout, row in out["train"].items():
        log(f"mesh base training {layout} (4 ranks on one card)", card, json.dumps(row))
    for layout, row in out["fp32_parity"].items():
        log(f"mesh fp32 parity {layout}", json.dumps(row))
    log("mesh scaling layouts: 4 ranks on one H100, not multi-GPU scaling", card,
        json.dumps(out["scaling"]))
    log("mesh launches (summed over the 4 ranks)", json.dumps(launches))
    serving = out["serving"]
    for layout in ("model4", "dp2_tp2"):
        log(f"mesh serving fp32 parity {layout} (Llama-3-8B widths, 2 layers)",
            json.dumps(serving[layout]))
    log("mesh serving bf16 weights, int8 cache, 4 layers, {model 4}: 4 gloo ranks on "
        "one H100, not multi-GPU tensor parallelism", card, json.dumps(serving["bf16_int8"]))
    for name, row in serving["bf16_int8_no_mesh"].items():
        log(f"mesh serving's bf16/int8 run without a mesh ({name} steps), rank 0 alone",
            card, json.dumps(row))
    log("mesh serving launches (summed over the 4 ranks)",
        json.dumps(out["serve_launches"]))
    for layout, row in pp_ep["pp_llama3"].items():
        log(f"mesh pipeline training {layout} (Llama-3-8B widths, 4 layers): 4 gloo "
            "ranks on one H100, not multi-GPU scaling", card, json.dumps(row))
    log("mesh pipeline fp32 parity pipe4 (base width, 4 layers)",
        json.dumps(pp_ep["pp_fp32_parity"]))
    for layout in ("expert4", "ep2_tp2"):
        log(f"mesh expert-parallel serving fp32 parity {layout} (Mixtral-8x7B widths, "
            "2 layers)", json.dumps(pp_ep["ep_serving"][layout]))
        log(f"mesh expert-parallel serving bf16 weights, int8 cache, 8 layers, {layout} "
            "(Mixtral-8x7B widths): 4 gloo ranks on one H100, not multi-GPU expert "
            "parallelism", card, json.dumps(pp_ep["ep_serving_bf16"][layout]))
    for name, row in pp_ep["ep_serving_bf16"]["no_mesh"].items():
        log(f"mesh expert-parallel serving's bf16/int8 run without a mesh ({name} "
            "steps), rank 0 alone", card, json.dumps(row))
    for layout, row in pp_ep["ep_train"].items():
        log(f"mesh expert-parallel training {layout} (Mixtral-8x7B widths, 1 layer): "
            "4 gloo ranks on one H100, not multi-GPU scaling", card, json.dumps(row))
    for layout, row in pp_ep["ep_fp32_parity"].items():
        log(f"mesh expert-parallel fp32 parity {layout} (8 experts, d_model 512)",
            json.dumps(row))
    log("mesh pipeline and expert-parallel launches (summed over the 4 ranks)",
        json.dumps(pp_ep["launches"]))
    log("mesh rank 0's seconds by part", json.dumps(out["seconds"]))

    for row in out["ring"]:
        gates = dict(o=B1_TOL["bf16"], dq=BWD_TOL["bf16"], dk=BWD_TOL["bf16"],
                     dv=BWD_TOL["bf16"])
        if any(row["rel_err"][n] > t for n, t in gates.items()):
            raise AssertionError(f"phase 34: the ring disagrees: {row}")
        if row["control_last_rotation_dropped_rel_err"] <= B1_TOL["bf16"]:
            raise AssertionError(f"phase 34: the dropped-rotation control passed: {row}")
        if "control_no_home_hop_rel_err" in row and min(
                row["control_no_home_hop_rel_err"].values()) <= BWD_TOL["bf16"]:
            raise AssertionError(f"phase 34: the no-home-hop control passed: {row}")
    for row in out["quant_ring"]:
        tol = QUANT_RING_MEAN_TOL[row["kv_dtype"]]
        if not (row["whole_sequence_rel_err"] <= B1_TOL["bf16"]
                and row["bf16_ring_mean_rel_err"] <= tol):
            raise AssertionError(f"phase 34: the quantized ring disagrees: {row}")
        if (row["control_whole_sequence_rel_err"] <= B1_TOL["bf16"]
                or row["control_bf16_ring_mean_rel_err"] <= tol):
            raise AssertionError(f"phase 34: a quantized ring's control passed: {row}")
    for layout, row in out["train"].items():
        if not all(math.isfinite(x) for x in row["losses"]):
            raise AssertionError(f"phase 34: {layout} loss not finite: {row}")

    def grads_ok(row):
        return (row["loss_rel_err"] <= MESH_LOSS_RTOL
                and row["grad_norm_rel_err"] <= MESH_LOSS_RTOL
                and row["grad_rel_err"] <= MESH_GRAD_TOL)

    for layout, row in out["fp32_parity"].items():
        if not (grads_ok(row) and row["param_max_abs_err"] <= MESH_PARAM_ATOL) \
                or grads_ok(row["control"]):
            raise AssertionError(f"phase 34: fp32 parity {layout}: {row}")
    if not (launches["fa2_forward"] and launches["fa2_forward_window"]
            and launches["fa2_backward_fused"] and launches["fa2_backward_dq"]
            and launches["fa2_backward_dkv"] and launches["fa2_forward_quant"]):
        raise AssertionError(f"phase 34: a kernel of the mesh path never ran: {launches}")
    phase_mesh_serving_gates(serving)
    phase_mesh_pp_ep_gates(pp_ep)
    served = out["serve_launches"]
    if not (served["paged_decode"] and served["paged_chunk"]
            and served["fa2_forward"] + served["fa2_forward_small"]):
        raise AssertionError(f"phase 34: a kernel of the serving mesh never ran: {served}")
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
    from cuda_flash_attention_tpu_torch.models import lora, moe, training, transformer
    from cuda_flash_attention_tpu_torch.ops import reference
    from cuda_flash_attention_tpu_torch.parallel import distributed as par_dist
    from cuda_flash_attention_tpu_torch.parallel import launch
    from cuda_flash_attention_tpu_torch.parallel import mesh as par_mesh
    from cuda_flash_attention_tpu_torch.scripts import b1_ab, fp32_bwd, kernel_ab
    from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5
    from cuda_flash_attention_tpu_torch.utils import (
        checkpoint,
        data,
        hf_convert,
        io,
        profiling,
    )

    # fp32 means fp32: no TF32 in the plain versions' matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    phase_build(_build)

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
    serve_profile = phase_profile(torch, np, eng, new_tokens=16, steps=3)
    log(f"phase 6: profile ok in {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bwd_rows = phase_bwd(torch, fp32_bwd, attention, fa2, bwd)
    autograd = phase_autograd(torch, attention, bwd, BlockSizes)
    log(f"phase 7: B2/B3/B4 and autograd ok in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity = phase_train_parity(torch, np, transformer, training,
                                tokens_shape=(1, 129), n_layers=1)
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
                                 tokens_shape=(1, 129), **kw)
        for name, kw in (("hybrid w64", dict(attn_window=64, global_every=2)),
                         ("streaming w96 s4", dict(attn_window=96, attn_sinks=4,
                                                   n_layers=1)))}
    log(f"phase 26: windowed and packed training ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gemma2 = phase_gemma2_serving(torch, np, transformer, decode, dataclasses)
    gemma2_parity = phase_gemma2_parity(torch, np, transformer, decode, dataclasses)
    log(f"phase 27: Gemma-2-2B-width hybrid serving at D 256 ok in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide_b1 = phase_wide_b1(torch, F, attention, fa2, common)
    wide_paged = phase_wide_paged(torch, dec_attn, kv_cache)
    b7_masks, b7_mask_launches = phase_b7_masks(torch, quant, fq)
    log(f"phase 28: D 32 and 256 kernels, B7's window and ids ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide_bwd, wide_bwd_launches = phase_wide_bwd(torch, fp32_bwd, fa2, bwd, common)
    log(f"phase 29: B2, B3 and B4 at D 32 and 256 ok in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemma2_train, gemma2_train_parity = phase_gemma2_train(torch, np, transformer,
                                                           training, common)
    log(f"phase 30: Gemma-2-2B-width training at D 256 ok in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide_base = phase_wide_baselines(torch, F, base)
    wide_b8 = phase_wide_b8(torch, F, attention, fa2, common)
    wide_b7, wide_b7_launches = phase_wide_b7(torch, F, quant, fq, fa2)
    # The reference contract at D 32 (Stress-1's batch, heads and length at
    # the reference's head dim) and D 256: its launches are the path's.
    reference_wide = tuple(f"{n}_d{d}" for n in TRAIN_KERNELS + (
        "fa2_forward_small", "fa1", "naive_fa2") for d in (32, 256))
    reset_counts(reference_wide)
    build_dir = str(_build.BUILD_DIR.parent)
    phase_cli(torch, np, cli, io, reference, build_dir, shape=(8, 16, 2048, 32),
              edge=(8, 16, 100, 32), in_subprocess=False, seed=31)
    phase_cli(torch, np, cli, io, reference, build_dir, shape=(1, 8, 4096, 256),
              runs=(("fp32", "forward_backward"),), methods=("fa1", "fa2-naive"),
              edge=(8, 16, 100, 256), in_subprocess=False, seed=32)
    phase_wide_harness(harness, configs, dataclasses)
    wide_launches = read_counts(reference_wide)
    log(f"phase 31: B7-B10 at D 32 and 256, the reference contract at D 32 and 256 "
        f"and the quantized API at Gemma-2-2B's width ok in "
        f"{time.perf_counter() - t0:.1f} s; launches of the contract: "
        f"{json.dumps(wide_launches)}")
    if not all(wide_launches[f"{n}_d{d}"] for n in ("fa1", "naive_fa2", "fa2_forward_small")
               for d in (32, 256)):
        raise AssertionError(f"phase 31: a kernel of the D 32 / 256 contract never "
                             f"ran: {wide_launches}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_attention = phase_mixtral_attention(torch, F, fp32_bwd, fa2, bwd)
    moe_paged = phase_wide_paged(torch, dec_attn, kv_cache, cases=mixtral_paged_cases(np),
                                 seed=32)
    moe_serve = phase_mixtral_serving(torch, np, transformer, decode)
    moe_train = phase_mixtral_train(torch, np, transformer, training)
    remat_dots = phase_remat_dots(torch, np, transformer)
    quant_grads = phase_quant_grads(torch, np, transformer, training, quant)
    ckpt = phase_checkpoint(torch, np, transformer, training, checkpoint)
    # The fp32 parity model (card and CPU copies) is phase 33's MoE target.
    moe_parity, (moe_cfg, moe_models) = phase_mixtral_parity(torch, np, transformer,
                                                             decode, moe)
    log(f"phase 32: Mixtral-8x7B-width kernels at the path's shapes, MoE serving and "
        f"training, remat dots, int8-weight gradients, checkpoints and the fp32 "
        f"parity ok in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_spec = phase_moe_speculation(torch, np, transformer, decode, moe, moe_cfg,
                                     moe_models)
    del moe_models
    gc.collect()  # the engines' reference cycles hold the parity model
    torch.cuda.empty_cache()
    llama_serve = phase_llama3_serving(torch, np, decode, hf_convert, profiling)
    llama_train = phase_llama3_train(torch, np, training, hf_convert, data)
    log(f"phase 33: MoE prompt-lookup speculation card vs CPU, Llama-3-8B's layout "
        f"imported, served at 32 layers and trained at 2 from native-loader batches "
        f"ok in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_one = phase_mesh_nccl(torch, np, transformer, training, par_dist, par_mesh)
    gc.collect()  # the card is the 4 ranks' from here
    torch.cuda.empty_cache()
    mesh_run = phase_mesh_ranks(launch)
    log(f"phase 34: training and serving on a mesh (one NCCL rank; 4 gloo ranks on "
        f"the card: ring, quantized ring, base model on ctx 4 and data 2 x model 2, "
        f"fp32 parity, scaling layouts, Llama-3-8B-width serving on model 4 and "
        f"data 2 x model 2, Llama-3-8B-width pipeline training on pipe 4 and pipe 2 x "
        f"model 2, Mixtral-8x7B-width serving and training on expert 4 and expert 2 x "
        f"model 2) ok in {time.perf_counter() - t0:.1f} s")

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
    # Phases 27-28: B1's, B5's and B6's rows at D 32 and 256 (B1 bf16 tiles
    # under causal masking; B5 and B6 on the int8 cache) with their D 256
    # launches on the Gemma-2-width serving path; B7's windowed and
    # segmented rows (int8, bf16 compute) with the public API's launches.
    def wide_row(rows, **match):
        r = next(r for r in rows if all(r[k] == v for k, v in match.items()))
        return {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "max_abs_err", "control_max_abs_err",
                                  "control_rel_err") if k in r}
    d256 = d256_launches(gemma2["launches"])
    for k in kernels:
        n = k["name"]
        if n == "fa2_forward":
            for d in (32, 256):
                k[f"d{d}"] = wide_row(wide_b1, case=f"D{d} causal", kind="bf16")
        elif n in ("paged_decode", "paged_chunk"):
            case = "B5" if n == "paged_decode" else "B6 T5"
            for d in (32, 256):
                k[f"d{d}"] = wide_row(wide_paged, case=f"{case} D{d}", cache="int8")
        elif n == "fa2_forward_quant":
            for key, case in (("window", "B4 S2048 window 160"),
                              ("segments", "B4 S2048 2 segments")):
                k[key] = dict(wide_row(b7_masks, case=case, storage="int8",
                                       compute="bf16"),
                              launches=b7_mask_launches[f"fa2_forward_quant_{key}"])
        if n in d256:
            k["d256"]["launches"] = d256[n]["windowed"] + d256[n]["global_"]
            k["d256"]["launches_window"] = d256[n]["windowed"]
        # Phases 29-30: B2's, B3's and B4's rows at D 32 and 256 (bf16 tiles,
        # causal), with the D 256 launches of phase 30's training (B2 on the
        # fused route, B3 and B4 on the split step) and the launches of
        # phase 29's checks at both widths.
        if n in BWD_NAMES:
            for d in (32, 256):
                k[f"d{d}"] = dict(wide_row(wide_bwd, kernel=n, case=f"D{d} causal",
                                           kind="bf16"),
                                  launches_checks=wide_bwd_launches[f"{n}_d{d}"])
            k["d256"]["launches"] = (gemma2_train["launches"][f"{n}_d256"]
                                     + gemma2_train["split_launches"][f"{n}_d256"])
    # Phase 31: B7-B10 at D 32 and 256 (B9 and B10 at Stress-1's shape at D
    # 32 and B1 H8 S4096 D256; B8 at Edge-NonPowerOf2 in fp32; B7 causal on
    # int8 K/V in bf16 compute at D 32 B4 Hq16 Hkv8 S2048 and at Gemma-2's
    # B1 Hq8 Hkv4 S4096 D256), with their launches on the path: the
    # contract's CLI and harness runs (B8-B10), the public quantized API (B7).
    for k in kernels:
        n = k["name"]
        for d in (32, 256):
            if n in ("fa1", "naive_fa2"):
                k[f"d{d}"] = dict(wide_row(wide_base, kernel=n, case=f"D{d}"),
                                  launches=wide_launches[f"{n}_d{d}"])
            elif n == "fa2_forward_small":
                k[f"d{d}"] = dict(wide_row(wide_b8, D=d, config="Edge-NonPowerOf2",
                                           kind="fp32", case="full"),
                                  launches=wide_launches[f"{n}_d{d}"])
            elif n == "fa2_forward_quant":
                r = next(r for r in wide_b7 if (r["case"], r["storage"], r["compute"])
                         == (f"D{d} causal", "int8", "bf16"))
                k[f"d{d}"] = dict(wide_row(wide_b7, case=f"D{d} causal", storage="int8",
                                           compute="bf16"),
                                  b1_dequant_ms=r["b1_dequant_ms"],
                                  sdpa_dequant_ms=r["sdpa_dequant_ms"],
                                  launches=wide_b7_launches[f"{n}_d{d}"])
    if not all(k[f"d{d}"]["launches"] for k in kernels for d in (32, 256)
               if k["name"] in ("fa1", "naive_fa2", "fa2_forward_small",
                                "fa2_forward_quant")):
        raise AssertionError("phase 31: a D 32 or D 256 kernel of B7-B10 never ran "
                             "on its path")
    # Phase 32: B1, B5 and B6 launches on the Mixtral-width serving path,
    # B1 and the backward's on its training, and their checks at the path's
    # shapes; B5 and B6 on an fp32 cache at D 256 (phase 28's rows in fp32
    # compute, the bf16 tile body's in bf16) with their launches on phase
    # 27's fp32-cache parity run.
    for k in kernels:
        n = k["name"]
        if n in ("fa2_forward", "fa2_backward_fused"):
            k["mixtral_shapes"] = moe_attention
        if n in ("paged_decode", "paged_chunk"):
            k["mixtral_shapes"] = [{f: r[f] for f in (
                "case", "compute", "max_abs_err", "slot_rel_err", "control_max_abs_err",
                "page_control_slot_rel_err", "ms", "plain_ms", "bound_ms", "bound_by")}
                for r in moe_paged if r["kernel"] == n]
        if n in moe_serve["launches"]:
            k["launches_moe_serving"] = moe_serve["launches"][n]
        if n in moe_train["launches"]:
            k["launches_moe_training"] = moe_train["launches"][n]
        # Phase 33: the Llama-3-8B-width serving and training paths, and MoE
        # speculation on the card.
        if n in llama_serve["launches"]:
            k["launches_llama3_serving"] = llama_serve["launches"][n]
        if n in llama_train["launches"]:
            k["launches_llama3_training"] = llama_train["launches"][n]
        if n in moe_spec["card_stats"]["launches"]:
            k["launches_moe_speculation"] = moe_spec["card_stats"]["launches"][n]
        if n in ("paged_decode", "paged_chunk"):
            case = "B5" if n == "paged_decode" else "B6 T5"
            k["d256_fp32_cache"] = dict(
                wide_row(wide_paged, case=f"{case} D256", cache="fp32", compute="fp32"),
                launches=gemma2_parity["fp32_cache_launches"][f"{n}_d256"])
            if n == "paged_chunk":
                k["d256_fp32_cache"]["tiles"] = {
                    c: wide_row(wide_paged, case=f"B6 {c} D256", cache="fp32")
                    for c in ("T512", "T512 fp32")}
    # Phase 34: the mesh path's launches summed over the 4 ranks (the
    # rings, the quantized rings, the base model's steps on both layouts
    # and the fp32 parity steps), B1's windowed launches beside them.
    for k in kernels:
        if k["name"] in mesh_run["launches"]:
            k["launches_mesh"] = mesh_run["launches"][k["name"]]
        if k["name"] == "fa2_forward":
            k["launches_mesh_window"] = mesh_run["launches"]["fa2_forward_window"]
        # Serving on the mesh: the 4 ranks' parity and bf16 runs, and the
        # NCCL rank's mesh engine.
        if k["name"] in mesh_run["serve_launches"]:
            k["launches_mesh_serving"] = (mesh_run["serve_launches"][k["name"]]
                                          + mesh_one["serving"]["launches"].get(
                                              k["name"], 0))
        # Of those, the pipeline's and expert parallelism's parts (f)-(i).
        for part, counts in mesh_run["pp_ep"]["launches"].items():
            if k["name"] in counts:
                k[f"launches_mesh_{part}"] = counts[k["name"]]
    log("fp16 tiles:", json.dumps({"B1 Stress-1": b1_fp16, "B2-B4": [
        {k: r[k] for k in ("kernel", "inputs", "B", "S", "causal", "ms",
                           "bound_ms", "library_ms", "rel_err")} for r in bwd_fp16]}))
    log(json.dumps({"e2e_logit_diff": e2e, "train_parity": parity,
                    "autograd": autograd, "remat": remat,
                    "spec_parity": spec_parity, "qlora": qlora,
                    "window_streaming_equal": streaming,
                    "window_train_parity": window_parity,
                    "gemma2": {k: gemma2[k] for k in (
                        "tokens_per_s", "tpot_ms_median", "ttft_ms_median",
                        "peak_live_pages_local", "peak_live_pages_global",
                        "d256_launches")},
                    "gemma2_fp32_card_cpu_equal": gemma2_parity["equal"],
                    "mixtral_serving": {k: moe_serve[k] for k in (
                        "tokens_per_s", "tpot_ms_median", "ttft_ms_median",
                        "max_memory_allocated_gib", "moe_ops")},
                    "mixtral_train": {k: moe_train[k] for k in (
                        "losses", "aux_loss", "step_ms_median", "tokens_per_s",
                        "max_memory_allocated_gib", "bf16_peak_share")},
                    "mixtral_parity": moe_parity, "remat_dots": remat_dots,
                    "llama3_serving": {k: llama_serve[k] for k in (
                        "tokens_per_s", "tpot_ms_median", "ttft_ms_median",
                        "max_memory_allocated_gib", "roofline")},
                    "llama3_train": {k: llama_train[k] for k in (
                        "losses", "step_ms_median", "tokens_per_s", "batches_equal",
                        "max_memory_allocated_gib")},
                    "moe_speculation_equal": moe_spec["equal"],
                    "quant_grads": quant_grads, "checkpoint": ckpt,
                    "mesh_one_rank_nccl": mesh_one,
                    "mesh_fp32_parity": mesh_run["fp32_parity"],
                    "gemma2_train": {k: gemma2_train[k] for k in (
                        "losses", "step_ms_median", "tokens_per_s",
                        "max_memory_allocated_gib", "mfu_bf16_peak", "split_loss")},
                    "gemma2_train_parity": gemma2_train_parity,
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
