"""Decode engine: continuous batching over the paged KV cache.

Counterpart of cuda_flash_attention_tpu/decode/engine.py:
  * DEVICE: each step embeds every slot's last token, appends each layer's
    new K/V to the paged cache, runs the paged decode kernel (B5) and
    samples, for the whole batch at once; inactive slots ride along masked.
  * HOST: the scheduler: admission queue, slot table, refcounted page
    allocator.  A request is admitted when a slot is free and the page pool
    can cover its worst case next to every running slot's remaining growth.
  * Admissions of one length bucket prefill as ONE batched causal forward
    through the FA2 forward kernel (B1); each prompt's K/V is then quantized
    into freshly allocated pages.
  * Chunked prefill (`prefill_chunk`): prompts longer than the chunk
    advance one chunk per step through `verify_step` (the paged chunk
    kernel, B6), so running decodes keep emitting a token every step.
  * Prefix caching (`prefix_cache`): fully written prompt pages are
    registered under their token prefix; a later prompt that starts with
    that prefix shares the pages (refcounted) and pushes only its suffix
    through `verify_step`.
  * Speculative decoding (`spec_tokens`): a proposer (a draft model with its
    own caches on the target's page table, or prompt lookup) supplies
    spec_tokens tokens per slot, the target scores them all in one
    `verify_step`, and the host keeps the longest accepted prefix plus one
    target token: greedy output equals plain greedy decoding, sampled output
    is distributed as target-only sampling (`speculative_accept`).
  * Decode steps run as captured CUDA graphs (decode/graphs.py): the
    decode-and-sample step reads its inputs from persistent device buffers
    that the host refills before each run, and is replayed once per token.
    With `decode_burst` > 1 one run replays it up to decode_burst times
    with one readback (the JAX engine's `_device_burst`); the per-token
    step is the same graph run once.  On the CPU the step runs eagerly.
  * Logit bias and presence/frequency penalties per request: a [max_seqs,
    vocab] bias matrix added to the logits of every step (the prefill's
    first token, decode steps, speculative verification); penalties update
    its rows as tokens are emitted, and inside a burst a device count of
    the burst's own tokens replays them exactly.
  * `scan_layers` is accepted and runs the per-layer list form: JAX scans
    stacked layers to compile one layer body, and eager PyTorch compiles
    nothing, so a stacked layout would run the same kernels on the same
    values.
  * Sliding windows and attention sinks (cfg.attn_window, global_every,
    attn_sinks): layers that share a window form a window GROUP with its
    own page table and allocator (the hybrid cache of local/global
    interleaves); a windowed group frees every page entirely behind its
    window (`_recycle_stale`, a rolling cache; sink pages stay resident),
    so its pages per request are bounded by the window, and admission
    reserves per group by that bound (`_worst_pages_for`).  The hybrid
    cache refuses speculation and prefix caching, as the JAX engine does.
  * Mixture-of-experts models (cfg.n_experts > 0): the capacity of a layer
    couples every token of a call, so each call carries the JAX engine's
    rows: a chunked-prefill step runs all max_seqs rows (idle ones masked,
    their tokens 0), a bucket prefill its prompts padded with token 0, a
    decode step every slot with its last token, a prefix suffix its one
    row, and a speculative round every slot in the draft's k + 1 steps and
    the target's verify call (an idle slot with its stale last token at
    length 0, and zeros for lookup drafts), as JAX's _spec_round feeds
    them.

Serving on a mesh (`mesh=`, JAX engine.py:238-341): KV heads and the
projections split over "model", an MoE layer's experts over "expert" and,
under "data", slots and the page pool over "data", each data shard with
its own allocators over a private slice of the pool (page ids local to
it) and its own prefix map.  JAX's single
controller sees every slot; here every rank is a process
(parallel/mesh.py), and every rank runs this same host scheduler on the
same requests, with all dp allocators on the host, so that admission, page
ids and finishing agree on every rank.  Each rank holds device pages only
for its own data shard and its own KV heads, runs the model on its own
slots' rows (decode/model.py's mesh note) and samples them, and the tokens
each data shard sampled are gathered over "data" before the host reads
them.  The ranks of one data shard sample from the same logits (gathered
over "model") with the same generator state (seeded with seed plus the
shard's index).  Bucket prefills run each shard's own requests (rows
padded to the busiest shard's count); under "data", chunked prefill and
prefix suffixes run every slot, as the JAX engine's mesh calls do.
Under gloo (host-memory collectives, which no CUDA graph can capture) the
decode steps run eagerly; under NCCL they are captured as without a mesh;
`stats["graphs"]` reports which.  Captured NCCL steps have run only on a
world-1 mesh, whose collectives move no data: a captured step that holds
a real multi-rank NCCL collective is unverified (it needs several
cards).  An MoE model's experts split over "expert" and their d_ff over
"model" (models/moe.py; JAX engine.py:242-264 places them by
param_shardings): slots shard over "data" only, so the expert ranks of one
data shard serve the same slots, and each MoE layer routes every slot's
tokens (gathered over "data") on every rank.  A hybrid
multi-window-group cache refuses a mesh as JAX's does, and so does a mesh
that splits the sequence or the layers ("ctx" or "pipe"; the JAX engine
serves no pipeline either).

Entry points run on the CUDA card unless `device="cpu"` is given, which
runs the kernels' plain versions; with a mesh, on the mesh's device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.decode.graphs import StepGraph
from cuda_flash_attention_tpu_torch.decode.kv_cache import (
    PageAllocator,
    init_kv_pages,
    write_prompt_kv,
)
from cuda_flash_attention_tpu_torch.decode.model import (
    decode_step,
    prefill_forward,
    verify_step,
)
from cuda_flash_attention_tpu_torch.decode.sampling import (
    _categorical,
    sample_tokens,
    sample_with_logprob,
    speculative_accept,
    warp_logits,
)
from cuda_flash_attention_tpu_torch.decode.sharded import init_local_kv_pages
from cuda_flash_attention_tpu_torch.kernels.common import cdiv
from cuda_flash_attention_tpu_torch.models.lora import LoRATensor
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    shard_params,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import all_gather
from cuda_flash_attention_tpu_torch.parallel.mesh import (
    CTX_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
)
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    done: bool = False
    # Stop sequences: generation ends when the generated tail matches one of
    # them (the matched tokens stay in `generated`, as eos_id's does).
    stop: tuple[tuple[int, ...], ...] | None = None
    # Streaming: called with each token id when the host learns it (per
    # decode step; per accepted chunk under speculation).
    on_token: object | None = None
    # Per-token log-probabilities of the sampled tokens (engine logprobs=True).
    logprobs: list[float] = dataclasses.field(default_factory=list)
    # Per-request logit bias {token_id: bias} added to every step's logits
    # before sampling (float("-inf") bans a token).
    logit_bias: dict | None = None
    # OpenAI-style repetition controls: presence_penalty is subtracted once
    # per distinct generated token, frequency_penalty per occurrence, through
    # the same bias row (under speculation the update lands between rounds).
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Distinct generated tokens (presence-penalty checks).
    seen: set = dataclasses.field(default_factory=set)
    # Host wall clock (time.monotonic): submit -> first token is TTFT.
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def ttft_s(self) -> float | None:
        """Time to first token (s), None until the first token lands."""
        if not self.first_token_at:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first (s)."""
        if not self.finished_at or len(self.generated) < 2:
            return None
        return (self.finished_at - self.first_token_at) / (len(self.generated) - 1)


def _stop_hit(tokens: list[int], stop) -> bool:
    """True when `tokens` ends with one of the stop sequences."""
    if not stop:
        return False
    return any(len(tokens) >= len(s) and tokens[-len(s):] == list(s)
               for s in stop)


class DecodeEngine:
    """Continuous-batching generation over a quantized paged KV cache.
    ``cache_dtype`` (target and draft caches) is torch.int8, "int4",
    torch.float8_e4m3fn, torch.float8_e5m2, torch.bfloat16 or torch.float32;
    params may hold QuantizedTensor (int8/fp8/int4, W8A8) and LoRATensor
    weights.

    ``decode_burst`` > 1 runs up to that many chained decode steps per
    engine step with one readback (speculation never bursts); while chunked
    prefills are in flight a burst is capped at ``prefill_burst_cap`` steps
    (0 or None: no cap).  Streaming callbacks fire at the readback; TTFT
    and TPOT are host time at emission.  Greedy output does not depend on
    the burst length.  Sampled output is reproducible per seed (and burst
    length): the captured step draws from the engine's own generator,
    registered with its graph, so every replay draws new numbers.

    ``scan_layers`` runs the per-layer list form, as the JAX engine does
    whenever its layers do not stack: the scan there cuts compile time, and
    eager PyTorch compiles nothing."""

    def __init__(self, params, cfg: TransformerConfig, *, max_seqs: int = 8,
                 max_seq_len: int = 2048, page_size: int = 128,
                 num_pages: int | None = None, cache_dtype=torch.int8,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 min_p: float = 0.0, seed: int = 0, logprobs: bool = False,
                 device=None, mesh=None, draft_params=None,
                 draft_cfg: TransformerConfig | None = None,
                 spec_tokens: int = 0, spec_mode: str = "draft",
                 lookup_ngram: int = 2, prefix_cache: bool = False,
                 prefill_chunk: int | None = None, scan_layers: bool = False,
                 decode_burst: int = 1, prefill_burst_cap: int = 8):
        if scan_layers and any(set(layer) != set(params["layers"][0])
                               for layer in params["layers"]):
            # JAX's stack_layer_params refuses a heterogeneous stack.
            raise ValueError(
                "stack_layer_params needs homogeneous layers (same param "
                "keys); MoE-interleaved models (moe_every>1) cannot stack")
        if cfg.attn_sinks and cfg.attn_window is None:
            raise ValueError("attn_sinks require attn_window")
        # Window groups (the hybrid KV cache, JAX engine.py:188-228): layers
        # sharing a window share a page table and an allocator, so a local
        # group recycles the pages behind its window while a global group
        # keeps the whole history.  A uniform model has one group.
        self._group_windows: list[int | None] = []
        self._layer_group: list[int] = []
        for i in range(cfg.n_layers):
            w = cfg.layer_window(i)
            if w not in self._group_windows:
                self._group_windows.append(w)
            self._layer_group.append(self._group_windows.index(w))
        self.n_groups = len(self._group_windows)
        if self.n_groups > 1:
            if mesh is not None:
                raise NotImplementedError(
                    "hybrid (multi-window-group) cache is single-host: "
                    "per-group tables are not sharded yet")
            if spec_tokens:
                raise NotImplementedError(
                    "hybrid cache + speculation: the draft's group "
                    "mirroring is not wired")
            if prefix_cache:
                raise NotImplementedError(
                    "hybrid cache + prefix caching: per-group prefix maps "
                    "are not wired")
        # The whole-sequence rolling bound (None as soon as a layer is
        # global); recycling and admission run per group.
        self.window = cfg.attn_window if None not in self._group_windows else None
        self.sinks = cfg.attn_sinks if cfg.attn_window is not None else 0
        if page_size % 128 != 0:
            raise ValueError(f"page_size must be a multiple of 128; got {page_size}")
        self.mesh = mesh
        self.dp = self.tp = 1
        if mesh is not None:
            self._check_mesh(mesh, cfg, max_seqs)
            if device is not None and torch.device(device) not in (
                    mesh.device, torch.device(mesh.device.type)):
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        # This rank's data shard and its slots (every slot without "data").
        self._slots_per_shard = max_seqs // self.dp
        self._shard = mesh.index(DATA_AXIS) if mesh is not None else 0
        self._rows = slice(self._shard * self._slots_per_shard,
                           (self._shard + 1) * self._slots_per_shard)
        self.cfg = cfg
        self.params = self._serving_copy(params, cfg)
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.pages_per_seq = cdiv(max_seq_len, page_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.want_logprobs = bool(logprobs)
        if num_pages is None:
            # + a null page for each data shard (local page 0 of its pool).
            num_pages = max_seqs * self.pages_per_seq + self.dp
        if num_pages % self.dp:
            raise ValueError(
                f"num_pages ({num_pages}) must divide over the data axis "
                f"({self.dp}): each shard owns a private pool slice")
        self.num_pages = num_pages
        self.shard_pages = num_pages // self.dp
        # One allocator per (window group, data shard), group-major: group
        # 0's are `allocators`; each further group allocates ids into its
        # own layers' pools.
        self._group_allocs = [PageAllocator(self.shard_pages)
                              for _ in range(self.n_groups * self.dp)]
        self.allocators = self._group_allocs[:self.dp]
        self.caches = self._new_caches(cfg, cache_dtype)
        # Chunked prefill: prompts longer than this advance one chunk per
        # step (a multiple of the page size, so every chunk write is whole
        # pages from a page boundary).
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk must be a multiple of page_size ({page_size}: "
                f"page-aligned verify_step writes); got {prefill_chunk}"
            )

        # Speculative decoding: "draft" proposes with a small draft model
        # (its own caches on the target's page table and allocator);
        # "prompt_lookup" proposes the tokens that followed the most recent
        # earlier occurrence of the history's last `lookup_ngram` tokens.
        self.spec_tokens = int(spec_tokens)
        self.spec_mode = spec_mode
        self._use_draft = self.spec_tokens > 0 and spec_mode == "draft"
        self.lookup_ngram = int(lookup_ngram)
        if self.spec_tokens and spec_mode == "prompt_lookup":
            if draft_params is not None or draft_cfg is not None:
                raise ValueError("spec_mode='prompt_lookup' takes no draft model")
            if self.lookup_ngram < 1:
                raise ValueError("lookup_ngram must be >= 1")
        elif self.spec_tokens and spec_mode != "draft":
            raise ValueError(f"unknown spec_mode {spec_mode!r}")
        if self._use_draft:
            if draft_params is None or draft_cfg is None:
                raise ValueError("spec_tokens > 0 requires draft_params and draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share the vocab")
            if draft_cfg.n_kv_heads % self.tp or draft_cfg.n_heads % self.tp:
                raise ValueError(
                    f"the '{MODEL_AXIS}' mesh axis ({self.tp}) must divide the "
                    f"DRAFT model's n_kv_heads ({draft_cfg.n_kv_heads}) and "
                    f"n_heads ({draft_cfg.n_heads}) too")
            self.draft_cfg = draft_cfg
            self.draft_params = self._serving_copy(draft_params, draft_cfg)
            self.draft_caches = self._new_caches(draft_cfg, cache_dtype)

        # Prefix caching: full prompt pages registered under their token
        # prefix, per data shard (page ids are local to a shard's pool, and
        # a prompt hits only pages of its slot's shard): the JAX engine's
        # per-shard maps, as one map each way keyed by (shard, ...).  Each
        # allocator's on_last_free hook drops the entry of a page that died.
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache:
            self._prefix_maps: dict[tuple, int] = {}
            self._page_keys: dict[tuple, tuple] = {}
            for sh, alloc in enumerate(self.allocators):
                alloc.on_last_free = functools.partial(self._drop_prefix_entry, sh)

        # Host-side slot state (numpy; copied to the device each step).
        # page_table IS group 0's table; further window groups have their own.
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self._tables = [self.page_table] + [
            np.zeros_like(self.page_table) for _ in range(self.n_groups - 1)]
        self.lengths = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)
        self.last_token = np.zeros((max_seqs,), np.int32)
        # Chunked-prefill slots hold a request and pages but stay out of
        # `active` until their whole prompt is written.
        self.prefilling = np.zeros((max_seqs,), bool)
        self._prefill_pos = np.zeros((max_seqs,), np.int64)
        self._slot_req: list[Request | None] = [None] * max_seqs
        # Physical page ids per slot and window group; a page recycled
        # behind the window leaves None, so logical indices stay
        # length-indexed.  _slot_pages IS group 0's.
        self._slot_pages: list[list[int | None]] = [[] for _ in range(max_seqs)]
        self._group_pages = [self._slot_pages] + [
            [[] for _ in range(max_seqs)] for _ in range(self.n_groups - 1)]
        # Worst-case page need per occupied slot and group (admission
        # reservation).
        self._slot_worst = [[0] * self.n_groups for _ in range(max_seqs)]
        self._pending: deque[Request] = deque()
        self._next_uid = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + self._shard)
        # Decode steps replay captured CUDA graphs on the card, except under
        # gloo, whose collectives cross host memory and cannot be captured:
        # there they run eagerly.
        self._eager = self.device.type != "cuda" or (
            mesh is not None and "nccl" not in dist.get_backend())
        self.stats = {"steps": 0, "tokens": 0, "spec_rounds": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "prefill_chunks": 0, "graphs": not self._eager}

        # Per-slot logit-bias matrix [max_seqs, vocab] on the host, made at
        # the first biased request and dropped when the last one retires;
        # its device copy is refreshed only when the revision changes.
        self._bias: np.ndarray | None = None
        self._bias_rev = 0
        self._bias_dev_rev = -1
        self._biased_slots: set[int] = set()

        # Decode bursts: up to decode_burst chained steps per engine step.
        self.decode_burst = max(1, int(decode_burst))
        self.prefill_burst_cap = int(prefill_burst_cap or 0)
        # The decode step's persistent device inputs and outputs (a captured
        # graph reads and writes these addresses): the host fills them
        # before each run.  The bias and penalty buffers are made at first
        # use and kept, so every graph that reads them stays valid.
        dev = self.device
        self._buf = {
            "tokens": torch.zeros(max_seqs, dtype=torch.long, device=dev),
            "positions": torch.zeros(max_seqs, dtype=torch.long, device=dev),
            # One persistent page table per window group.
            "tables": [torch.zeros(max_seqs, self.pages_per_seq,
                                   dtype=torch.int32, device=dev)
                       for _ in range(self.n_groups)],
            "active": torch.zeros(max_seqs, dtype=torch.bool, device=dev),
            "remaining": torch.zeros(max_seqs, dtype=torch.int32, device=dev),
            "i": torch.zeros(1, dtype=torch.long, device=dev),
            "toks": torch.zeros(self.decode_burst, max_seqs, dtype=torch.long,
                                device=dev),
            "lps": torch.zeros(self.decode_burst, max_seqs, dtype=torch.float32,
                               device=dev),
        }
        # One graph per (bias, penalties) (sampling and logprobs are fixed
        # per engine), sharing one memory pool.
        self._graphs: dict[tuple[bool, bool], StepGraph] = {}
        self._graph_pool = (None if self._eager
                            else torch.cuda.graph_pool_handle())

    def _check_mesh(self, mesh, cfg: TransformerConfig, max_seqs: int):
        """Set dp and tp from a serving mesh, with JAX's divisibility errors;
        an axis that splits the sequence or the layers is refused."""
        for axis in (CTX_AXIS, PIPE_AXIS):
            if mesh.size(axis) > 1:
                raise NotImplementedError(
                    f"serving on a mesh splits slots over '{DATA_AXIS}' and "
                    f"heads over '{MODEL_AXIS}'; a '{axis}' axis of size "
                    f"{mesh.size(axis)} splits the sequence or the layers")
        self.dp, self.tp = mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS)
        if self.tp > 1 and (cfg.n_kv_heads % self.tp or cfg.n_heads % self.tp):
            raise ValueError(
                f"the '{MODEL_AXIS}' mesh axis ({self.tp}) must divide both "
                f"n_kv_heads ({cfg.n_kv_heads}) and n_heads ({cfg.n_heads}) "
                f"for tensor-parallel serving: KV pages are head-sharded and "
                f"must stay device-local")
        if max_seqs % self.dp:
            raise ValueError(
                f"max_seqs ({max_seqs}) must divide over the '{DATA_AXIS}' "
                f"axis ({self.dp}): slots are sharded")

    @property
    def allocator(self) -> PageAllocator:
        """The page allocator of a single data shard."""
        if self.dp != 1:
            raise AttributeError(
                "data-parallel engine has one allocator per shard: use "
                ".allocators[shard]")
        return self.allocators[0]

    def _galloc(self, shard: int, g: int) -> PageAllocator:
        return self._group_allocs[g * self.dp + shard]

    def _slot_shard(self, slot: int) -> int:
        return slot // self._slots_per_shard

    def _local(self, x):
        """This rank's data shard's rows of a slot-indexed tensor."""
        return x if self.dp == 1 else x[self._rows]

    def _gather(self, x):
        """The rows of every data shard, in slot order, from this rank's."""
        return x if self.dp == 1 else all_gather(x, self.mesh, DATA_AXIS, 0)

    def _vocab(self, logits):
        """Logits over the whole vocabulary from this rank's lm-head
        columns (the model's mesh note): gathered over "model"."""
        return logits if self.tp == 1 else all_gather(logits, self.mesh,
                                                      MODEL_AXIS, -1)

    def _serving_copy(self, params, cfg: TransformerConfig):
        """A compute-dtype copy of the 2-D weights on the engine's device
        (decode needs no fp32 master); norm scales keep their dtype.  A
        QuantizedTensor is a leaf: its values and fp32 scales move to the
        device unchanged, as the JAX engine keeps them (engine.py:157-174);
        a LoRATensor's base and adapters follow the same rules.  With a
        mesh, this rank's blocks (shard_params) of the full tree."""
        def copy(p):
            if isinstance(p, QuantizedTensor):
                return p.to(self.device)
            if isinstance(p, LoRATensor):
                return dataclasses.replace(p, base=copy(p.base), a=copy(p.a),
                                           b=copy(p.b))
            if p.ndim >= 2 and p.is_floating_point():
                return p.to(self.device, cfg.dtype)
            return p.to(self.device)

        if self.mesh is not None:
            params = shard_params(params, self.mesh, cfg)
        return _map_params(params, copy)

    def _new_caches(self, cfg: TransformerConfig, cache_dtype):
        if self.mesh is not None:
            return [init_local_kv_pages(self.mesh, cfg.n_kv_heads, self.num_pages,
                                        self.page_size, cfg.head_dim, cache_dtype,
                                        data_axis=DATA_AXIS)
                    for _ in range(cfg.n_layers)]
        return [init_kv_pages(cfg.n_kv_heads, self.num_pages, self.page_size,
                              cfg.head_dim, cache_dtype, device=self.device)
                for _ in range(cfg.n_layers)]

    def _dev(self, array) -> torch.Tensor:
        """A device COPY of host state: the host goes on mutating its numpy
        tables while the launches that read them may still be queued."""
        return torch.tensor(np.asarray(array), device=self.device)

    def _layer_tables(self, tables):
        """The model's page_table argument from one table per group: the
        table itself for one group, else a per-layer list (layers of a group
        share one tensor; decode/model.py _table_for)."""
        if self.n_groups == 1:
            return tables[0]
        return [tables[g] for g in self._layer_group]

    def _tables_dev(self, rows=None):
        """Device copies of the group tables (of `rows` only, if given), as
        the model takes them."""
        return self._layer_tables(
            [self._dev(t if rows is None else t[rows]) for t in self._tables])

    # ------------------------------------------------------------------
    # Device side
    # ------------------------------------------------------------------

    def _device_propose(self, tokens, positions, table, active):
        """k+1 greedy draft steps: proposes d1..dk and runs the extra step
        that feeds dk, so the draft cache holds K/V for every chunk position
        before the next round (its output is discarded).  Returns [n, k].
        The _device_* functions of speculation take and return this rank's
        data shard's rows."""
        k = self.spec_tokens
        tok, out = tokens, []
        for i in range(k + 1):
            logits, _ = decode_step(self.draft_params, tok, positions + i,
                                    self.draft_caches, table, active,
                                    self.draft_cfg, mesh=self.mesh)
            logits = self._vocab(logits)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        return torch.stack(out[:k], dim=1)

    def _device_propose_sampled(self, tokens, positions, table, active):
        """Sampled draft: k+1 warped categorical steps; returns the k
        proposals [n, k] and the distributions they were drawn from
        [n, k, V].  Draft and target warp alike (warp_logits), which keeps
        the acceptance rule exact for the warped target distribution."""
        k = self.spec_tokens
        tok, toks, probs = tokens, [], []
        for i in range(k + 1):
            logits, _ = decode_step(self.draft_params, tok, positions + i,
                                    self.draft_caches, table, active,
                                    self.draft_cfg, mesh=self.mesh)
            logits = self._vocab(logits)
            warped = warp_logits(logits, temperature=self.temperature,
                                 top_k=self.top_k, top_p=self.top_p,
                                 min_p=self.min_p)
            tok = _categorical(warped, self._generator).long()
            if i < k:
                toks.append(tok)
                probs.append(torch.softmax(warped, dim=-1))
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1)

    def _device_verify(self, chunk, positions, table, active):
        """Target side, greedy: argmax at every chunk position from one
        chunked forward (the chunk's K/V is appended inside).  With logprobs,
        also log_softmax at each argmax (an accepted draft i equals
        greedy[i]; the correction or bonus is greedy[m])."""
        logits, _ = verify_step(self.params, chunk, positions, self.caches,
                                table, active, self.cfg, mesh=self.mesh)
        logits = self._vocab(logits)
        bias = self._bias_dev()
        if bias is not None:
            logits = logits + self._local(bias)[:, None, :]
        greedy = torch.argmax(logits, dim=-1)
        lp = None
        if self.want_logprobs:
            lp = torch.log_softmax(logits, dim=-1).gather(-1, greedy[..., None])[..., 0]
        return greedy, lp

    def _device_verify_sampled(self, chunk, positions, table, active, draft_probs):
        """Target side, sampled: one chunked forward, then the Leviathan/Chen
        acceptance on the device.  Returns (m accepted drafts, final token,
        log pt_i(d_i) [n, k] and log pt_m(final) [n] under the warped target
        distribution, or None without logprobs).  A deterministic proposer
        (prompt lookup) passes draft_probs None: pd is one-hot at the draft,
        and the rule stays exact."""
        logits, _ = verify_step(self.params, chunk, positions, self.caches,
                                table, active, self.cfg, mesh=self.mesh)
        logits = self._vocab(logits)
        bias = self._bias_dev()
        if bias is not None:
            logits = logits + self._local(bias)[:, None, :]
        warped = warp_logits(logits.reshape(-1, logits.shape[-1]),
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p, min_p=self.min_p)
        pt = torch.softmax(warped, dim=-1).reshape(logits.shape)
        drafts = chunk[:, 1:]
        if draft_probs is None:
            draft_probs = torch.nn.functional.one_hot(
                drafts, pt.shape[-1]).to(pt.dtype)
        m, final = speculative_accept(pt, drafts, draft_probs, self._generator)
        if not self.want_logprobs:
            return m, final, None, None
        logpt = torch.log(pt.clamp_min(1e-38))
        lp_drafts = logpt[:, :-1].gather(-1, drafts[..., None])[..., 0]
        rows = torch.arange(pt.shape[0], device=pt.device)
        lp_final = logpt[rows, m.long()].gather(-1, final.long()[:, None])[:, 0]
        return m, final, lp_drafts, lp_final

    def _device_step(self, bias: bool, penalties: bool):
        """One decode-and-sample step over the persistent buffers (the body
        of the JAX engine's `_device_burst`, engine.py:772-811): slot s runs
        while remaining[s] > i, at position positions[s] + i; the token it
        samples goes to toks[i] and feeds the next step; i advances.  The
        bias rows are added to the logits; with penalties, so is
        -presence * (sampled in this burst, not before) - frequency *
        (times sampled in this burst), the uploaded bias carrying every
        earlier token's penalties.  The buffers hold every slot; the model
        runs this rank's data shard's rows, whose tokens are gathered over
        "data" into every slot's."""
        b = self._buf
        i = b["i"]
        act = b["active"] & (b["remaining"] > i)
        loc = self._local
        logits, _ = decode_step(self.params, loc(b["tokens"]),
                                loc(b["positions"]) + i, self.caches,
                                self._layer_tables([loc(t) for t in b["tables"]]),
                                loc(act), self.cfg, mesh=self.mesh)
        logits = self._vocab(logits)
        if bias:
            logits = logits + loc(b["bias"])
        if penalties:
            counts = b["counts"]
            newly = (loc(counts) > 0) & ~loc(b["pre_seen"])
            logits = (logits - loc(b["presence"])[:, None] * newly
                      - loc(b["frequency"])[:, None] * loc(counts))
        nxt, lp = self._sample_dev(logits)
        nxt = self._gather(nxt)
        if lp is not None:
            b["lps"].index_copy_(0, i, self._gather(lp)[None])
        tokens = torch.where(act, nxt.long(), b["tokens"])
        b["toks"].index_copy_(0, i, tokens[None])
        b["tokens"].copy_(tokens)
        if penalties:
            counts.scatter_add_(1, tokens[:, None], act[:, None].float())
        i.add_(1)

    def _warmup_step(self, step):
        """`step` once with every slot inactive (its cache writes go to the
        null page, which nothing attends), then the step index back at 0."""
        b = self._buf
        active = b["active"].clone()
        b["active"].zero_()
        step()
        b["active"].copy_(active)
        b["i"].zero_()

    def _graph_for(self, bias: bool, penalties: bool) -> StepGraph:
        g = self._graphs.get((bias, penalties))
        if g is None:
            step = functools.partial(self._device_step, bias, penalties)
            g = StepGraph(step, self.device,
                          warmup=functools.partial(self._warmup_step, step),
                          generator=self._generator if self.temperature > 0 else None,
                          pool=self._graph_pool, eager=self._eager)
            self._graphs[(bias, penalties)] = g
        return g

    @property
    def graph_replays(self) -> int:
        """Replays of the captured decode step so far (0 on the CPU)."""
        return sum(g.replays for g in self._graphs.values())

    def _run_decode(self, n: int, remaining: np.ndarray, penalties=None):
        """Fill the step's buffers from the host tables, run it n times (n
        graph replays on the card) and read back the tokens [n, max_seqs]
        and, with logprobs, their log-probabilities."""
        b = self._buf
        b["tokens"].copy_(torch.from_numpy(self.last_token.astype(np.int64)))
        b["positions"].copy_(torch.from_numpy(self.lengths.astype(np.int64)))
        for buf, table in zip(b["tables"], self._tables):
            buf.copy_(torch.from_numpy(table))
        b["active"].copy_(torch.from_numpy(self.active))
        b["remaining"].copy_(torch.from_numpy(remaining))
        b["i"].zero_()
        bias = self._bias_dev() is not None
        if penalties is not None:
            if "counts" not in b:
                shape, dev = (self.max_seqs, self.cfg.vocab_size), self.device
                b["pre_seen"] = torch.zeros(shape, dtype=torch.bool, device=dev)
                b["counts"] = torch.zeros(shape, dtype=torch.float32, device=dev)
                b["presence"] = torch.zeros(self.max_seqs, device=dev)
                b["frequency"] = torch.zeros(self.max_seqs, device=dev)
            for name, arr in zip(("pre_seen", "presence", "frequency"), penalties):
                b[name].copy_(torch.from_numpy(arr))
            b["counts"].zero_()
        self._graph_for(bias, penalties is not None).run(n)
        toks = b["toks"][:n].cpu().numpy()
        lps = b["lps"][:n].cpu().numpy() if self.want_logprobs else None
        return toks, lps

    def _burst_eligible(self) -> bool:
        """Bursts are exact whenever nothing the device cannot model changes
        its inputs between tokens: speculation keeps its own rounds, all
        else bursts (penalties replay on the device, chunked prefill
        interleaves one chunk per engine step between bursts)."""
        return self.decode_burst > 1 and not self.spec_tokens

    def _penalty_inputs(self):
        """A burst's penalty state: (pre_seen [slots, vocab] bool, presence
        [slots] fp32, frequency [slots] fp32), or None when no active slot
        carries penalties."""
        if not any(self.active[s] and (self._slot_req[s].presence_penalty
                                       or self._slot_req[s].frequency_penalty)
                   for s in range(self.max_seqs)):
            return None
        pre_seen = np.zeros((self.max_seqs, self.cfg.vocab_size), bool)
        presence = np.zeros((self.max_seqs,), np.float32)
        frequency = np.zeros((self.max_seqs,), np.float32)
        for s in np.flatnonzero(self.active).tolist():
            req = self._slot_req[s]
            presence[s] = req.presence_penalty
            frequency[s] = req.frequency_penalty
            if req.seen and (req.presence_penalty or req.frequency_penalty):
                pre_seen[s, list(req.seen)] = True
        return pre_seen, presence, frequency

    def _burst_step(self):
        """One burst of up to decode_burst chained steps, its tokens emitted
        in order (streaming callbacks fire at the readback; cancellation
        lands at burst bounds).  Tokens sampled past a slot's EOS or stop
        are dropped here; their K/V lies past the slot's length, unattended,
        and is overwritten later."""
        n = self.decode_burst
        if self.prefilling.any() and self.prefill_burst_cap:
            n = min(n, self.prefill_burst_cap)
        remaining = np.zeros((self.max_seqs,), np.int32)
        for slot in np.flatnonzero(self.active).tolist():
            req = self._slot_req[slot]
            remaining[slot] = max(req.max_new_tokens - len(req.generated), 0)
            self._recycle_stale(slot)
            self._ensure_page(slot, extra=min(n, int(remaining[slot])) - 1)
        with torch.inference_mode():
            toks, lps = self._run_decode(n, remaining, self._penalty_inputs())
        # Steps = the longest advance of a slot in this burst, as the
        # per-token path would count them.
        self.stats["steps"] += int(min(n, remaining.max(initial=0)))
        self.stats["burst_dispatches"] = self.stats.get("burst_dispatches", 0) + 1
        act0 = self.active.copy()
        for i in range(n):
            for slot in range(self.max_seqs):
                if not act0[slot] or i >= remaining[slot]:
                    continue
                req = self._slot_req[slot]
                if req.done:
                    continue  # EOS or stop earlier in this burst
                tok = int(toks[i, slot])
                self.lengths[slot] += 1
                self._emit(req, tok, lps[i, slot] if lps is not None else None)
                self.last_token[slot] = tok
                self._maybe_finish(req, tok)

    # ------------------------------------------------------------------
    # Scheduler (host)
    # ------------------------------------------------------------------

    def _validate_request(self, prompt: list[int], max_new_tokens: int):
        if not prompt:
            raise ValueError("empty prompt")
        # Speculative rounds write up to spec_tokens positions past the final
        # length (rejected drafts' K/V): those need real table columns.
        need = len(prompt) + max_new_tokens + self.spec_tokens
        if need > self.pages_per_seq * self.page_size:
            raise ValueError(
                f"prompt+generation (+{self.spec_tokens} speculative "
                f"overshoot) = {need} exceeds max_seq_len "
                f"{self.pages_per_seq * self.page_size}"
            )
        worst = max(self._worst_pages_for(len(prompt), max_new_tokens))
        if worst > self.shard_pages - 1:  # page 0 of each pool is the null page
            raise ValueError(
                f"request needs up to {worst} KV pages but each shard pool "
                f"has only {self.shard_pages - 1} allocatable pages; raise "
                f"num_pages or shorten prompt/max_new_tokens"
            )

    def _validate_bias(self, logit_bias):
        """Out-of-vocab bias keys are refused at submit (at admission the
        error would surface from an unrelated step())."""
        for t in logit_bias or ():
            if not 0 <= int(t) < self.cfg.vocab_size:
                raise ValueError(f"logit_bias token {int(t)} out of vocab")

    @staticmethod
    def _norm_stop(stop):
        """Stop sequences as a tuple of non-empty int tuples."""
        if stop is None:
            return None
        out = tuple(tuple(int(t) for t in s) for s in stop)
        if not all(out):
            raise ValueError("stop sequences must be non-empty")
        return out

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int | None = None, stop=None, on_token=None,
               logit_bias=None, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0) -> Request:
        """Queue a request; it is admitted as soon as a slot and pages free
        up.  `stop` is an optional list of token sequences that end
        generation; `on_token` an optional per-token streaming callback;
        `logit_bias` maps token id -> bias added to every step's logits
        (-inf bans); the penalties are OpenAI's presence and frequency
        penalties."""
        return self.submit_many([prompt], max_new_tokens, eos_id, stop,
                                on_token, logit_bias, presence_penalty,
                                frequency_penalty)[0]

    def submit_many(self, prompts, max_new_tokens: int = 32,
                    eos_id: int | None = None, stop=None, on_token=None,
                    logit_bias=None, presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> list[Request]:
        """Enqueue several requests BEFORE admitting, so prompts of one
        length bucket prefill as one batched forward."""
        stop = self._norm_stop(stop)
        self._validate_bias(logit_bias)
        bias = dict(logit_bias) if logit_bias else None
        reqs = []
        for p in prompts:
            p = [int(t) for t in p]
            self._validate_request(p, max_new_tokens)
            reqs.append(Request(self._next_uid, p, max_new_tokens, eos_id,
                                stop=stop, on_token=on_token, logit_bias=bias,
                                presence_penalty=float(presence_penalty),
                                frequency_penalty=float(frequency_penalty),
                                submitted_at=time.monotonic()))
            self._next_uid += 1
            self._pending.append(reqs[-1])
        self._admit()
        return reqs

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.max_seqs)
                if not self.active[i] and self._slot_req[i] is None]

    def _worst_pages_for(self, prompt_len: int,
                         max_new_tokens: int) -> list[int]:
        """The most pages a request holds at once, per window group (JAX
        engine.py:1225-1261): a global group holds its whole length; a
        windowed group recycles the pages behind its window every step, so
        it holds at most the window's live span (plus the speculative
        overshoot and the sink pages) or its prefill, whichever is more;
        chunked prefill recycles between chunks, so its prefill holds at
        most a chunk beside the live span."""
        # Speculative chunks overshoot the final length by up to spec_tokens
        # appended-but-rejected positions.
        total = cdiv(prompt_len + max_new_tokens + self.spec_tokens,
                     self.page_size)
        out = []
        for w in self._group_windows:
            if w is None:
                out.append(total)
                continue
            live = (cdiv(w + self.spec_tokens, self.page_size) + 1
                    + cdiv(self.sinks, self.page_size))
            prefill = cdiv(prompt_len, self.page_size)
            if self.prefill_chunk is not None and prompt_len > self.prefill_chunk:
                prefill = min(prefill,
                              cdiv(self.prefill_chunk, self.page_size) + live)
            out.append(min(total, max(live, prefill)))
        return out

    def _live_page_count(self, slot: int, g: int) -> int:
        return sum(1 for p in self._group_pages[g][slot] if p is not None)

    def _recycle_stale(self, slot: int):
        """Free the pages entirely behind each windowed group's window (the
        rolling cache, JAX engine.py:1269-1290): they keep their logical
        index as None and their table entry becomes the null page, which the
        kernels never read there.  Sink pages stay resident; global groups
        never recycle."""
        for g, w in enumerate(self._group_windows):
            if w is None:
                continue
            horizon = int(self.lengths[slot]) - w
            if horizon <= 0:
                continue
            pages = self._group_pages[g][slot]
            for pi, pid in enumerate(pages):
                if pid is None or (pi + 1) * self.page_size > horizon:
                    continue
                if pi * self.page_size < self.sinks:
                    continue  # attention-sink pages stay resident
                self._galloc(self._slot_shard(slot), g).free([pid])
                pages[pi] = None
                self._tables[g][slot, pi] = 0

    @property
    def acceptance_rate(self) -> float | None:
        """Fraction of proposed draft tokens the target accepted (None
        before any speculative round)."""
        if not self.stats["spec_proposed"]:
            return None
        return self.stats["spec_accepted"] / self.stats["spec_proposed"]

    def _budgets(self) -> list[list[int]]:
        """Allocatable pages per data shard and window group minus those
        promised to the shard's running slots but not allocated yet (live
        pages only: recycled pages are back in the pool)."""
        budgets = [[self._galloc(sh, g).available for g in range(self.n_groups)]
                   for sh in range(self.dp)]
        for s in range(self.max_seqs):
            sh = self._slot_shard(s)
            for g in range(self.n_groups):
                budgets[sh][g] -= max(0, self._slot_worst[s][g]
                                      - self._live_page_count(s, g))
        return budgets

    def _admit(self):
        """Admit pending requests in FIFO order while a slot is free whose
        data shard's page budget covers the head request's worst case in
        every window group (the first such slot).  Prefix hits prefill
        their suffix alone, long prompts (or long suffixes) start chunked
        prefill, and the rest prefill by length bucket."""
        free = self._free_slots()
        budgets = self._budgets()
        take: list[tuple[Request, int]] = []
        while self._pending and free:
            req = self._pending[0]
            worst = self._worst_pages_for(len(req.prompt), req.max_new_tokens)
            slot = next((s for s in free if all(
                b >= w for b, w in zip(budgets[self._slot_shard(s)], worst))), None)
            if slot is None:
                break
            free.remove(slot)
            sh = self._slot_shard(slot)
            budgets[sh] = [b - w for b, w in zip(budgets[sh], worst)]
            take.append((self._pending.popleft(), slot))
        if self.prefix_cache:
            missed = []
            for r, slot in take:
                hits = self._prefix_hits(r.prompt, self._slot_shard(slot))
                suffix_len = len(r.prompt) - len(hits) * self.page_size
                if not hits:
                    missed.append((r, slot))
                elif (self.prefill_chunk is not None
                      and suffix_len > self.prefill_chunk):
                    # A long uncached suffix is chunked like a long prompt.
                    self._start_chunked_prefill(r, slot, hits)
                else:
                    self._prefill_with_prefix(r, slot, hits)
            take = missed
        if self.prefill_chunk is not None:
            rest = []
            for r, slot in take:
                if len(r.prompt) > self.prefill_chunk:
                    self._start_chunked_prefill(r, slot)
                else:
                    rest.append((r, slot))
            take = rest
        # The bucket quantum covers both the FA2 block grid (128) and the
        # page size, so a prompt's K/V slice is a whole number of pages.
        quantum = max(128, self.page_size)
        buckets: dict[int, list[tuple[Request, int]]] = {}
        for r, slot in take:
            buckets.setdefault(cdiv(len(r.prompt), quantum) * quantum, []).append(
                (r, slot))
        for pad_len, pairs in buckets.items():
            self._prefill_batch([r for r, _ in pairs], [s for _, s in pairs],
                                pad_len)

    def _sample_dev(self, logits):
        """One token per row; returns (tokens, logprobs or None) on the
        device."""
        kw = dict(temperature=self.temperature, top_k=self.top_k,
                  top_p=self.top_p, min_p=self.min_p)
        if self.want_logprobs:
            return sample_with_logprob(logits, self._generator, **kw)
        return sample_tokens(logits, self._generator, **kw), None

    def _sample_slots(self, slots: list[int], row_of):
        """One token for each of `slots` from its logits row plus its bias
        row; returns (tokens, logprobs or None) on the host, in the order of
        `slots`.  `row_of(i)` is slots[i]'s row (this rank's vocab columns
        on a mesh) and is asked only for the slots of this rank's data
        shard; the rows are gathered over "model" here, so only they cross
        ranks.  Under "data" each shard samples its own slots, its rows
        padded to the busiest shard's count, and the tokens are gathered
        over "data"."""
        per = [[i for i, s in enumerate(slots) if self._slot_shard(s) == d]
               for d in range(self.dp)]
        n, mine = max(len(p) for p in per), per[self._shard]
        logits = torch.zeros(n, self.cfg.vocab_size // self.tp, device=self.device)
        if mine:
            logits[:len(mine)] = torch.stack([row_of(i) for i in mine])
        logits = self._vocab(logits)
        if mine:
            logits[:len(mine)] = self._with_bias(logits[:len(mine)],
                                                 [slots[i] for i in mine])
        tok, lp = (self._gather(x) if x is not None else None
                   for x in self._sample_dev(logits))
        order = [i for p in per for i in p + [None] * (n - len(p))]
        keep = [j for j, i in enumerate(order) if i is not None]
        inverse = np.argsort([order[j] for j in keep])
        tok = tok.cpu().numpy()[keep][inverse]
        return tok, (None if lp is None else lp.cpu().numpy()[keep][inverse])

    def _ensure_bias(self) -> np.ndarray:
        if self._bias is None:
            self._bias = np.zeros((self.max_seqs, self.cfg.vocab_size),
                                  np.float32)
        return self._bias

    def _bind_bias(self, req: Request, slot: int):
        """Write a request's logit_bias into its slot's row of the bias
        matrix (made at first use); a request without bias or penalties
        clears a row an earlier request left."""
        if not (req.logit_bias is not None or req.presence_penalty
                or req.frequency_penalty):
            if self._bias is not None and slot in self._biased_slots:
                self._bias[slot, :] = 0.0
                self._biased_slots.discard(slot)
                self._bias_rev += 1
            return
        row = self._ensure_bias()[slot]
        row[:] = 0.0
        for t, b in (req.logit_bias or {}).items():
            row[int(t)] = b  # keys validated at submit
        self._biased_slots.add(slot)
        self._bias_rev += 1

    def _bias_dev(self):
        """The bias matrix in its persistent device buffer, copied from the
        host only when the revision changed; None without biased requests."""
        if self._bias is None:
            return None
        buf = self._buf.get("bias")
        if buf is None:
            buf = self._buf["bias"] = torch.zeros(
                self.max_seqs, self.cfg.vocab_size, device=self.device)
        if self._bias_dev_rev != self._bias_rev:
            buf.copy_(torch.from_numpy(self._bias))
            self._bias_dev_rev = self._bias_rev
        return buf

    def _with_bias(self, logits, slots):
        """First-token logits of `slots` plus their bias rows."""
        if self._bias is None:
            return logits
        return logits + torch.from_numpy(self._bias[slots]).to(logits.device)

    def _emit(self, req: Request, tok: int, logprob=None):
        """Record one generated token: transcript, logprob, telemetry, the
        repetition penalties (in the slot's bias row) and the streaming
        callback."""
        if req.presence_penalty or req.frequency_penalty:
            row = self._ensure_bias()[req.slot]
            if req.presence_penalty and tok not in req.seen:
                row[tok] -= req.presence_penalty
            if req.frequency_penalty:
                row[tok] -= req.frequency_penalty
            self._biased_slots.add(req.slot)
            self._bias_rev += 1
        req.seen.add(tok)
        if not req.first_token_at:
            req.first_token_at = time.monotonic()
        req.generated.append(tok)
        if logprob is not None:
            req.logprobs.append(float(logprob))
        self.stats["tokens"] += 1
        if req.on_token is not None:
            req.on_token(tok)

    def _start_decoding(self, req: Request, slot: int, first: int, logprob):
        """A slot whose prompt is cached: emit its first token and join the
        decode batch."""
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_worst[slot] = self._worst_pages_for(len(req.prompt),
                                                       req.max_new_tokens)
        self.prefilling[slot] = False
        self.lengths[slot] = len(req.prompt)
        self.active[slot] = True
        self.last_token[slot] = first
        self._emit(req, first, logprob)
        # Under a window the prompt's pages behind it are already dead.
        self._recycle_stale(slot)
        if self.prefix_cache:
            self._register_prefix(req, slot)
        self._maybe_finish(req, first)

    def _prefill_batch(self, reqs: list[Request], slots: list[int],
                       pad_len: int):
        """One batched causal forward for the requests of a length bucket,
        prompts zero-padded to pad_len.  The padded tail's logits are unused
        under causal masking and its K/V is never attended (the lengths gate
        it); decode appends overwrite it.  A draft model prefills the same
        tokens into its own caches under the same page ids.  Under "data"
        each shard runs the requests of its own slots, its rows padded to
        the busiest shard's count (the MoE layers gather equal blocks), and
        writes their K/V into its own pool."""
        per = [[i for i, s in enumerate(slots) if self._slot_shard(s) == d]
               for d in range(self.dp)]
        mine = per[self._shard]
        row = {i: j for j, i in enumerate(mine)}
        tokens = np.zeros((max(len(p) for p in per), pad_len), np.int64)
        for j, i in enumerate(mine):
            tokens[j, :len(reqs[i].prompt)] = reqs[i].prompt
        for req, slot in zip(reqs, slots):
            self._bind_bias(req, slot)
        with torch.inference_mode():
            tokens_dev = self._dev(tokens)
            logits, kv = prefill_forward(self.params, tokens_dev, self.cfg,
                                         mesh=self.mesh)
            if self._use_draft:
                _, draft_kv = prefill_forward(self.draft_params, tokens_dev,
                                              self.draft_cfg, mesh=self.mesh)
            firsts, first_lps = self._sample_slots(
                slots, lambda i: logits[row[i], len(reqs[i].prompt) - 1])
            for i, (req, slot) in enumerate(zip(reqs, slots)):
                n_pages = cdiv(len(req.prompt), self.page_size)
                ids = []  # per window group
                for g in range(self.n_groups):
                    page_ids = self._galloc(self._slot_shard(slot), g).alloc(n_pages)
                    self._group_pages[g][slot] = list(page_ids)
                    self._tables[g][slot, :] = 0
                    self._tables[g][slot, :n_pages] = page_ids
                    ids.append(page_ids)
                if i in row:  # the request's K/V is this rank's to write
                    ids = [self._dev(x) for x in ids]
                    j, kv_len = row[i], n_pages * self.page_size
                    for li, (pages, (k, v)) in enumerate(zip(self.caches, kv)):
                        write_prompt_kv(pages, k[j, :kv_len], v[j, :kv_len],
                                        ids[self._layer_group[li]])
                    if self._use_draft:
                        for pages, (k, v) in zip(self.draft_caches, draft_kv):
                            write_prompt_kv(pages, k[j, :kv_len], v[j, :kv_len],
                                            ids[0])
                self._start_decoding(req, slot, int(firsts[i]),
                                     first_lps[i] if first_lps is not None else None)

    def _prefix_hits(self, prompt: list[int], shard: int = 0) -> list[int]:
        """The longest chain of the shard's cached pages covering this
        prompt's head.  Always leaves at least one suffix token, whose
        logits give the first generated token."""
        ps = self.page_size
        n_full = len(prompt) // ps
        if n_full and len(prompt) == n_full * ps:
            n_full -= 1
        hits: list[int] = []
        for i in range(n_full):
            pid = self._prefix_maps.get((shard, tuple(prompt[:(i + 1) * ps])))
            if pid is None:
                break
            hits.append(pid)
        return hits

    def _register_prefix(self, req: Request, slot: int):
        """Publish the slot's pages that the prompt covers fully: all later
        writes land at positions >= the prompt length, so their content is
        fixed for the page's lifetime."""
        ps, shard = self.page_size, self._slot_shard(slot)
        pages = self._slot_pages[slot]
        for i in range(min(len(req.prompt) // ps, len(pages))):
            pid = pages[i]
            key = (shard, tuple(req.prompt[:(i + 1) * ps]))
            if pid is None or (shard, pid) in self._page_keys or key in self._prefix_maps:
                continue
            self._prefix_maps[key] = pid
            self._page_keys[(shard, pid)] = key

    def _drop_prefix_entry(self, shard: int, pid: int):
        key = self._page_keys.pop((shard, pid), None)
        if key is not None:
            self._prefix_maps.pop(key, None)

    def _chunk_forward(self, slots: list[int], parts, starts, size: int,
                       full_width: bool = False):
        """verify_step with page-granular writes of `parts[i]` (tokens,
        zero-padded to `size`) at position starts[i] for each of `slots`
        (chunked prefill and prefix suffixes), mirrored into the draft's
        caches under speculation.  The call's rows are the slots alone, or
        every slot (idle ones masked: they write and attend nothing) with
        `full_width` or a "data" axis, as the JAX engine's mesh calls run; a
        rank runs its own data shard's rows.  Returns the target's logits
        [rows, size, V] (this rank's vocab columns on a mesh) and each of
        this rank's `slots`'s row in them."""
        rows = (list(range(self.max_seqs)) if full_width or self.dp > 1
                else list(slots))
        rows = rows[self._rows] if self.dp > 1 else rows
        at = {s: r for r, s in enumerate(rows)}
        tokens = np.zeros((len(rows), size), np.int64)
        first_pos = np.zeros(len(rows), np.int64)
        live = np.zeros(len(rows), bool)
        for s, part, start in zip(slots, parts, starts):
            if s in at:
                tokens[at[s], :len(part)] = part
                first_pos[at[s]] = start
                live[at[s]] = True
        with torch.inference_mode():
            args = (self._dev(tokens), self._dev(first_pos))
            table = self._tables_dev(rows)
            mask = self._dev(live)
            logits, _ = verify_step(self.params, *args, self.caches, table,
                                    mask, self.cfg, paged_write=True,
                                    mesh=self.mesh)
            if self._use_draft:
                verify_step(self.draft_params, *args, self.draft_caches, table,
                            mask, self.draft_cfg, paged_write=True,
                            mesh=self.mesh)
        return logits, {s: at[s] for s in slots if s in at}

    def _prefill_with_prefix(self, req: Request, slot: int, hits: list[int]):
        """Admission of a prefix-cache hit: share the cached pages and push
        only the uncached suffix (padded to whole pages) through one chunked
        forward that attends the shared prefix."""
        ps = self.page_size
        prefix_len = len(hits) * ps
        suffix = req.prompt[prefix_len:]
        pad_len = cdiv(len(suffix), ps) * ps
        self._bind_bias(req, slot)
        alloc = self.allocators[self._slot_shard(slot)]
        alloc.share(hits)
        pages = list(hits) + alloc.alloc(pad_len // ps)
        self._slot_pages[slot] = pages
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages
        logits, at = self._chunk_forward([slot], [suffix], [prefix_len], pad_len)
        firsts, lps = self._sample_slots(
            [slot], lambda i: logits[at[slot], len(suffix) - 1])
        self._start_decoding(req, slot, int(firsts[0]),
                             lps[0] if lps is not None else None)

    def _start_chunked_prefill(self, req: Request, slot: int, hits=None):
        """Admit a long prompt WITHOUT running its forward: the slot is
        PREFILLING and step() advances it one chunk at a time while decode
        slots keep stepping.  Pages are allocated per chunk.  With `hits`
        (prefix-cache pages covering the prompt's head) only the suffix is
        chunked."""
        self._bind_bias(req, slot)
        for g in range(self.n_groups):
            self._tables[g][slot, :] = 0
            self._group_pages[g][slot] = []
        if hits:  # prefix caching: one window group
            self.allocators[self._slot_shard(slot)].share(hits)
            self._slot_pages[slot] = list(hits)
            self.page_table[slot, :len(hits)] = hits
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_worst[slot] = self._worst_pages_for(len(req.prompt),
                                                       req.max_new_tokens)
        self.lengths[slot] = 0
        self.active[slot] = False
        self.prefilling[slot] = True
        self._prefill_pos[slot] = len(hits or ()) * self.page_size

    def _chunk_prefill_step(self):
        """Advance every prefilling slot by one chunk: one verify_step per
        distinct chunk size (full chunks, or a tail rounded up to whole
        pages whose pad K/V is never attended and is overwritten by decode
        appends).  A slot whose prompt completes samples its first token and
        joins the decode batch on this same step."""
        by_size: dict[int, list[int]] = {}
        for s in np.flatnonzero(self.prefilling).tolist():
            rem = len(self._slot_req[s].prompt) - int(self._prefill_pos[s])
            size = (self.prefill_chunk if rem >= self.prefill_chunk
                    else cdiv(rem, self.page_size) * self.page_size)
            by_size.setdefault(size, []).append(s)
        for size, slots in by_size.items():
            starts = [int(self._prefill_pos[s]) for s in slots]
            parts = [self._slot_req[s].prompt[start:start + size]
                     for s, start in zip(slots, starts)]
            for s, start in zip(slots, starts):
                self._ensure_pages_upto(s, start + size)
            # A dense model runs the chunk's slots alone (every slot under
            # "data"); an MoE model every slot, since the capacity couples
            # the call's tokens (the JAX engine's rows).
            logits, at = self._chunk_forward(slots, parts, starts, size,
                                             full_width=bool(self.cfg.n_experts))
            self.stats["prefill_chunks"] += 1
            done = []
            for i, s in enumerate(slots):
                self._prefill_pos[s] = starts[i] + size
                if starts[i] + size >= len(self._slot_req[s].prompt):
                    done.append(i)
                else:
                    # The rolling bound holds during prefill too: pages
                    # behind the window are freed between chunks.
                    self.lengths[s] = starts[i] + size
                    self._recycle_stale(s)
            if not done:
                continue
            done_slots = [slots[i] for i in done]
            toks, lps = self._sample_slots(done_slots, lambda j: logits[
                at[done_slots[j]], len(parts[done[j]]) - 1])
            for j, s in enumerate(done_slots):
                self._start_decoding(self._slot_req[s], s, int(toks[j]),
                                     lps[j] if lps is not None else None)

    def _ensure_pages_upto(self, slot: int, end_pos: int):
        """Grow every group's page list of the slot so positions < end_pos
        are writable (recycled entries count: appends stay
        length-indexed)."""
        needed = cdiv(end_pos, self.page_size)
        # _validate_request reserves the speculative overshoot, so this never
        # outgrows the table width.
        assert needed <= self.pages_per_seq, (needed, self.pages_per_seq)
        for g in range(self.n_groups):
            pages = self._group_pages[g][slot]
            while len(pages) < needed:
                (pid,) = self._galloc(self._slot_shard(slot), g).alloc(1)
                pages.append(pid)
                self._tables[g][slot, len(pages) - 1] = pid

    def _ensure_page(self, slot: int, extra: int = 0):
        """Grow the slot's page list so positions lengths[slot] ..
        lengths[slot] + extra are writable (extra > 0 for speculative chunks
        that append several tokens in one round)."""
        self._ensure_pages_upto(slot, int(self.lengths[slot]) + extra + 1)

    def _maybe_finish(self, req: Request, token: int):
        if req.done:
            return
        hit_eos = req.eos_id is not None and token == req.eos_id
        if (hit_eos or len(req.generated) >= req.max_new_tokens
                or _stop_hit(req.generated, req.stop)):
            req.done = True
            req.finished_at = time.monotonic()

    def _retire(self, slot: int) -> Request:
        req = self._slot_req[slot]
        for g in range(self.n_groups):
            self._galloc(self._slot_shard(slot), g).free(
                [p for p in self._group_pages[g][slot] if p is not None])
            self._group_pages[g][slot] = []
            self._tables[g][slot, :] = 0
        if self._bias is not None and slot in self._biased_slots:
            self._bias[slot, :] = 0.0
            self._biased_slots.discard(slot)
            self._bias_rev += 1
            if not self._biased_slots:
                self._bias = None  # no biased request left: no bias input
        self.lengths[slot] = 0
        self.active[slot] = False
        self._slot_req[slot] = None
        self._slot_worst[slot] = [0] * self.n_groups
        return req

    def generate_n(self, prompt: list[int], n: int, max_new_tokens: int = 32,
                   best_of: bool = False, max_steps: int = 10000,
                   **kw) -> list[Request]:
        """Best-of-n sampling: `n` independent completions of ONE prompt
        (temperature > 0 and logprobs=True for the ranking), returned sorted
        by total log-probability, best first (only the winner with
        best_of=True).  With prefix_cache=True the first completion's prompt
        pages register before the rest admit, so the other n-1 share them."""
        if n < 1:
            raise ValueError("n must be >= 1")
        if n > 1 and not self.want_logprobs:
            raise ValueError("generate_n ranking needs logprobs=True on the engine")
        if self.prefix_cache and n > 1:
            first = self.submit(list(prompt), max_new_tokens, **kw)
            self.step()
            reqs = [first] + self.submit_many([list(prompt)] * (n - 1),
                                              max_new_tokens, **kw)
        else:
            reqs = self.submit_many([list(prompt)] * n, max_new_tokens, **kw)
        steps = 0
        while any(not r.done for r in reqs) and steps < max_steps:
            self.step()
            steps += 1
        self.step()
        reqs = sorted(reqs, key=lambda r: -sum(r.logprobs))
        return reqs[:1] if best_of else reqs

    def cancel(self, req: Request) -> bool:
        """Abort a request: a pending one leaves the queue at once; an
        admitted one (decoding or mid-chunked-prefill) retires at the next
        step(), freeing its slot and pages.  False if it already finished."""
        if req.done:
            return False
        req.done = True
        req.finished_at = time.monotonic()
        try:
            self._pending.remove(req)
            return True  # never admitted: nothing to release
        except ValueError:
            pass
        if req.slot is not None and self._slot_req[req.slot] is req:
            self.prefilling[req.slot] = False  # no further chunks
        return True

    def _drain_finished(self, finished: list):
        """Retire done slots and admit pending requests; loop because a
        request can finish at its prefill (EOS first, or max_new_tokens=1)."""
        while True:
            for slot in range(self.max_seqs):
                req = self._slot_req[slot]
                if req is not None and req.done:
                    finished.append(self._retire(slot))
            self._admit()
            if not any(r is not None and r.done for r in self._slot_req):
                break

    def step(self) -> list[Request]:
        """One engine step: a chunk of every prefilling prompt, then one
        decode step (or one speculative round) for every active slot.
        Returns the requests that finished (their slots are freed and
        pending requests admitted)."""
        finished: list[Request] = []
        self._drain_finished(finished)
        if self.prefill_chunk is not None and self.prefilling.any():
            self._chunk_prefill_step()
            # A request can finish at chunk completion: retire it before the
            # decode below, or it would generate past its limit.
            self._drain_finished(finished)
        if not self.active.any():
            return finished
        if self.spec_tokens:
            self._spec_round()
            return finished
        if self._burst_eligible():
            self._burst_step()
            return finished
        for slot in np.flatnonzero(self.active).tolist():
            self._recycle_stale(slot)
            self._ensure_page(slot)
        with torch.inference_mode():
            toks, lps = self._run_decode(1, self.active.astype(np.int32))
        self.stats["steps"] += 1
        for slot in np.flatnonzero(self.active).tolist():
            req = self._slot_req[slot]
            tok = int(toks[0, slot])
            self.lengths[slot] += 1  # the KV of last_token is now cached
            self._emit(req, tok, lps[0, slot] if lps is not None else None)
            self.last_token[slot] = tok
            self._maybe_finish(req, tok)
        return finished

    def _lookup_proposals(self, k: int) -> np.ndarray:
        """Prompt-lookup drafts [max_seqs, k]: for each active slot, the k
        tokens that followed the most recent earlier occurrence of the
        history's last `lookup_ngram` tokens (zero-padded; no match proposes
        zeros, which the target rejects)."""
        n = self.lookup_ngram
        out = np.zeros((self.max_seqs, k), np.int64)
        for slot in np.flatnonzero(self.active).tolist():
            req = self._slot_req[slot]
            hist = req.prompt + req.generated
            if len(hist) <= n:
                continue
            pattern = hist[-n:]
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == pattern:
                    nxt = hist[start + n:start + n + k]
                    out[slot, :len(nxt)] = nxt
                    break
        return out

    def _spec_round(self):
        """One draft-and-verify round: up to spec_tokens+1 tokens per slot
        from one target forward.  Greedy: take drafts while the target's
        argmax agrees, then the target's own token.  Sampled: the
        Leviathan/Chen rule.  Chunk K/V of rejected positions stays in the
        cache unattended (the length gate) and is overwritten later."""
        k = self.spec_tokens
        for slot in np.flatnonzero(self.active).tolist():
            self._recycle_stale(slot)
            self._ensure_page(slot, extra=k)
        sampled = self.temperature > 0.0

        def host(x):  # every data shard's rows, on the host
            return self._gather(x).cpu().numpy()

        with torch.inference_mode():
            loc = self._local
            positions = loc(self._dev(self.lengths).long())
            table = loc(self._dev(self.page_table))
            act = loc(self._dev(self.active))
            last = loc(self._dev(self.last_token).long())
            draft_probs = None
            if self._use_draft and sampled:
                drafts_dev, draft_probs = self._device_propose_sampled(
                    last, positions, table, act)
            elif self._use_draft:
                drafts_dev = self._device_propose(last, positions, table, act)
            else:
                drafts_dev = loc(self._dev(self._lookup_proposals(k)))
            chunk = torch.cat([last[:, None], drafts_dev], dim=1)
            drafts = host(drafts_dev)
            if sampled:
                m_d, final_d, lp_d, lp_f = self._device_verify_sampled(
                    chunk, positions, table, act, draft_probs)
                m_all, final_all = host(m_d), host(final_d)
                if self.want_logprobs:
                    lp_drafts, lp_final = host(lp_d), host(lp_f)
            else:
                greedy_d, lp_all_d = self._device_verify(chunk, positions, table, act)
                greedy = host(greedy_d)
                if self.want_logprobs:
                    lp_all = host(lp_all_d)
        self.stats["steps"] += 1
        self.stats["spec_rounds"] += 1

        for slot in np.flatnonzero(self.active).tolist():
            req = self._slot_req[slot]
            if sampled:
                m = int(m_all[slot])
                accepted = [int(t) for t in drafts[slot, :m]]
                accepted.append(int(final_all[slot]))
                lps = ([float(x) for x in lp_drafts[slot, :m]]
                       + [float(lp_final[slot])] if self.want_logprobs else None)
            else:
                m = 0
                while m < k and greedy[slot, m] == drafts[slot, m]:
                    m += 1
                accepted = [int(t) for t in drafts[slot, :m]]
                accepted.append(int(greedy[slot, m]))  # bonus or correction
                # Accepted draft i equals greedy[i]; the final token is
                # greedy[m]: one logprob row covers both.
                lps = ([float(x) for x in lp_all[slot, :m + 1]]
                       if self.want_logprobs else None)
            take: list[int] = []
            for tok in accepted:
                take.append(tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.generated) + len(take) >= req.max_new_tokens
                        or _stop_hit(req.generated + take, req.stop)):
                    break
            for i, tok in enumerate(take):
                self._emit(req, tok, lps[i] if lps is not None else None)
            self.stats["spec_proposed"] += k
            self.stats["spec_accepted"] += m
            # K/V is now committed for the previous last_token and the
            # accepted drafts; the new last_token's lands next round.
            self.lengths[slot] += len(take)
            self.last_token[slot] = take[-1]
            self._maybe_finish(req, take[-1])

    def run(self, prompts, max_new_tokens: int = 32, eos_id: int | None = None,
            max_steps: int = 10000, stop=None, on_token=None, logit_bias=None,
            presence_penalty: float = 0.0, frequency_penalty: float = 0.0):
        """Submit all prompts (batch-admitted), step until done, return the
        requests in submission order."""
        reqs = self.submit_many(prompts, max_new_tokens, eos_id, stop=stop,
                                on_token=on_token, logit_bias=logit_bias,
                                presence_penalty=presence_penalty,
                                frequency_penalty=frequency_penalty)
        steps = 0
        while (any(not r.done for r in reqs) or self._pending) and steps < max_steps:
            self.step()
            steps += 1
        self.step()  # final retire pass: slots and pages are released
        return reqs


def _map_params(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_params(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_params(v, fn) for v in tree]
    return fn(tree)
