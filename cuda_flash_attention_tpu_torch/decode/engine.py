"""Decode engine: continuous batching over the paged KV cache.

Counterpart of cuda_flash_attention_tpu/decode/engine.py, plain path only:
  * DEVICE: each step embeds every slot's last token, appends each layer's
    new K/V to the paged cache, runs the paged decode kernel and samples,
    for the whole batch at once; inactive slots ride along masked.
  * HOST: the scheduler: admission queue, slot table, page allocator.
    A request is admitted when a slot is free and the page pool can cover
    its worst case next to every running slot's remaining growth.
  * Admissions of one length bucket prefill as ONE batched causal forward
    through the FA2 forward kernel; each prompt's K/V is then quantized
    into freshly allocated pages.

Entry points run on the CUDA card unless `device="cpu"` is given, which
runs the kernels' plain versions.  Not ported yet (and refused): speculative
decoding, prefix caching, chunked prefill, decode bursts, scanned layers,
meshes, sliding windows and sinks, logit bias and repetition penalties.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.decode.kv_cache import (
    PageAllocator,
    init_kv_pages,
    write_prompt_kv,
)
from cuda_flash_attention_tpu_torch.decode.model import decode_step, prefill_forward
from cuda_flash_attention_tpu_torch.decode.sampling import (
    sample_tokens,
    sample_with_logprob,
)
from cuda_flash_attention_tpu_torch.kernels.common import cdiv
from cuda_flash_attention_tpu_torch.models.transformer import TransformerConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    done: bool = False
    # Per-token log-probabilities of the sampled tokens (engine logprobs=True).
    logprobs: list[float] = dataclasses.field(default_factory=list)
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


def _not_ported(what: str):
    return NotImplementedError(f"DecodeEngine: {what} is not ported yet")


class DecodeEngine:
    """Continuous-batching generation over a quantized paged KV cache."""

    def __init__(self, params, cfg: TransformerConfig, *, max_seqs: int = 8,
                 max_seq_len: int = 2048, page_size: int = 128,
                 num_pages: int | None = None, cache_dtype=torch.int8,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 min_p: float = 0.0, seed: int = 0, logprobs: bool = False,
                 device=None, mesh=None, spec_tokens: int = 0,
                 prefix_cache: bool = False, prefill_chunk: int | None = None,
                 scan_layers: bool = False, decode_burst: int = 1):
        for what, unsupported in (
            ("a mesh", mesh is not None),
            ("speculative decoding (spec_tokens)", spec_tokens),
            ("prefix caching", prefix_cache),
            ("chunked prefill", prefill_chunk is not None),
            ("scanned layers", scan_layers),
            ("decode bursts (decode_burst > 1)", decode_burst != 1),
            ("sliding-window attention and sinks",
             cfg.attn_window is not None or cfg.attn_sinks),
        ):
            if unsupported:
                raise _not_ported(what)
        if page_size % 128 != 0:
            raise ValueError(f"page_size must be a multiple of 128; got {page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # Serving holds a compute-dtype copy of the 2-D weights (decode needs
        # no fp32 master); norm scales keep their dtype.
        self.params = _map_params(
            params,
            lambda p: p.to(self.device, cfg.dtype)
            if p.ndim >= 2 and p.is_floating_point() else p.to(self.device),
        )
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.pages_per_seq = cdiv(max_seq_len, page_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.want_logprobs = bool(logprobs)
        if num_pages is None:
            num_pages = max_seqs * self.pages_per_seq + 1  # + the null page
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)
        self.caches = [
            init_kv_pages(cfg.n_kv_heads, num_pages, page_size, cfg.head_dim,
                          cache_dtype, device=self.device)
            for _ in range(cfg.n_layers)
        ]
        # Host-side slot state (numpy; shipped to the device each step).
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)
        self.last_token = np.zeros((max_seqs,), np.int32)
        self._slot_req: list[Request | None] = [None] * max_seqs
        self._slot_pages: list[list[int]] = [[] for _ in range(max_seqs)]
        # Worst-case page need per occupied slot (admission reservation).
        self._slot_worst = [0] * max_seqs
        self._pending: deque[Request] = deque()
        self._next_uid = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.stats = {"steps": 0, "tokens": 0}

    # ------------------------------------------------------------------
    # Scheduler (host)
    # ------------------------------------------------------------------

    def _validate_request(self, prompt: list[int], max_new_tokens: int):
        if not prompt:
            raise ValueError("empty prompt")
        need = len(prompt) + max_new_tokens
        if need > self.pages_per_seq * self.page_size:
            raise ValueError(
                f"prompt+generation = {need} exceeds max_seq_len "
                f"{self.pages_per_seq * self.page_size}"
            )
        worst = self._worst_pages_for(len(prompt), max_new_tokens)
        if worst > self.num_pages - 1:  # page 0 is the null page
            raise ValueError(
                f"request needs up to {worst} KV pages but the pool has only "
                f"{self.num_pages - 1} allocatable pages; raise num_pages or "
                f"shorten prompt/max_new_tokens"
            )

    @staticmethod
    def _check_no_bias(logit_bias, presence_penalty, frequency_penalty):
        if logit_bias or presence_penalty or frequency_penalty:
            raise _not_ported("logit bias and repetition penalties")

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int | None = None, logit_bias=None,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0) -> Request:
        """Queue a request; it is admitted as soon as a slot and pages free
        up."""
        return self.submit_many([prompt], max_new_tokens, eos_id, logit_bias,
                                presence_penalty, frequency_penalty)[0]

    def submit_many(self, prompts, max_new_tokens: int = 32,
                    eos_id: int | None = None, logit_bias=None,
                    presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> list[Request]:
        """Enqueue several requests BEFORE admitting, so prompts of one
        length bucket prefill as one batched forward."""
        self._check_no_bias(logit_bias, presence_penalty, frequency_penalty)
        reqs = []
        for p in prompts:
            p = [int(t) for t in p]
            self._validate_request(p, max_new_tokens)
            reqs.append(Request(self._next_uid, p, max_new_tokens, eos_id,
                                submitted_at=time.monotonic()))
            self._next_uid += 1
            self._pending.append(reqs[-1])
        self._admit()
        return reqs

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.max_seqs)
                if not self.active[i] and self._slot_req[i] is None]

    def _worst_pages_for(self, prompt_len: int, max_new_tokens: int) -> int:
        return cdiv(prompt_len + max_new_tokens, self.page_size)

    def _budget(self) -> int:
        """Allocatable pages minus those promised to running slots but not
        allocated yet."""
        budget = self.allocator.available
        for s in range(self.max_seqs):
            budget -= max(0, self._slot_worst[s] - len(self._slot_pages[s]))
        return budget

    def _admit(self):
        """Admit pending requests in FIFO order while a slot is free and the
        page budget covers the head request's worst case; admissions of one
        length bucket prefill together."""
        free = self._free_slots()
        budget = self._budget()
        take: list[tuple[Request, int]] = []
        while self._pending and free:
            req = self._pending[0]
            worst = self._worst_pages_for(len(req.prompt), req.max_new_tokens)
            if budget < worst:
                break
            budget -= worst
            take.append((self._pending.popleft(), free.pop(0)))
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

    def _sample(self, logits):
        """One token per row; returns (tokens on the host, logprobs or None)."""
        kw = dict(temperature=self.temperature, top_k=self.top_k,
                  top_p=self.top_p, min_p=self.min_p)
        if self.want_logprobs:
            tok, lp = sample_with_logprob(logits, self._generator, **kw)
            return tok.cpu().numpy(), lp.cpu().numpy()
        return sample_tokens(logits, self._generator, **kw).cpu().numpy(), None

    def _emit(self, req: Request, tok: int, logprob=None):
        if not req.first_token_at:
            req.first_token_at = time.monotonic()
        req.generated.append(tok)
        if logprob is not None:
            req.logprobs.append(float(logprob))
        self.stats["tokens"] += 1

    def _prefill_batch(self, reqs: list[Request], slots: list[int],
                       pad_len: int):
        """One batched causal forward for the requests of a length bucket,
        prompts zero-padded to pad_len.  The padded tail's logits are unused
        under causal masking and its K/V is never attended (the lengths gate
        it); decode appends overwrite it."""
        tokens = np.zeros((len(reqs), pad_len), np.int64)
        for i, r in enumerate(reqs):
            tokens[i, :len(r.prompt)] = r.prompt
        with torch.inference_mode():
            logits, kv = prefill_forward(
                self.params, torch.from_numpy(tokens).to(self.device), self.cfg
            )
            last = torch.tensor([len(r.prompt) - 1 for r in reqs],
                                device=self.device)
            last_logits = logits[torch.arange(len(reqs), device=self.device), last]
            firsts, first_lps = self._sample(last_logits)
            for i, (req, slot) in enumerate(zip(reqs, slots)):
                prompt_len = len(req.prompt)
                n_pages = cdiv(prompt_len, self.page_size)
                page_ids = self.allocator.alloc(n_pages)
                self._slot_pages[slot] = list(page_ids)
                self.page_table[slot, :] = 0
                self.page_table[slot, :n_pages] = page_ids
                ids = torch.tensor(page_ids, device=self.device)
                kv_len = n_pages * self.page_size
                for li, (k, v) in enumerate(kv):
                    write_prompt_kv(self.caches[li], k[i, :kv_len], v[i, :kv_len], ids)
                first = int(firsts[i])
                req.slot = slot
                self._emit(req, first,
                           first_lps[i] if first_lps is not None else None)
                self._slot_req[slot] = req
                self._slot_worst[slot] = self._worst_pages_for(
                    prompt_len, req.max_new_tokens)
                self.lengths[slot] = prompt_len
                self.active[slot] = True
                self.last_token[slot] = first
                self._maybe_finish(req, first)

    def _ensure_page(self, slot: int):
        """Grow the slot's page list so position lengths[slot] is writable."""
        needed = cdiv(int(self.lengths[slot]) + 1, self.page_size)
        pages = self._slot_pages[slot]
        while len(pages) < needed:
            (pid,) = self.allocator.alloc(1)
            pages.append(pid)
            self.page_table[slot, len(pages) - 1] = pid

    def _maybe_finish(self, req: Request, token: int):
        if req.done:
            return
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.finished_at = time.monotonic()

    def _retire(self, slot: int) -> Request:
        req = self._slot_req[slot]
        self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.page_table[slot, :] = 0
        self.lengths[slot] = 0
        self.active[slot] = False
        self._slot_req[slot] = None
        self._slot_worst[slot] = 0
        return req

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
        """One decode step for every active slot; returns the requests that
        finished (their slots are freed and pending requests admitted)."""
        finished: list[Request] = []
        self._drain_finished(finished)
        if not self.active.any():
            return finished
        for slot in range(self.max_seqs):
            if self.active[slot]:
                self._ensure_page(slot)
        dev = self.device
        with torch.inference_mode():
            logits, self.caches = decode_step(
                self.params,
                torch.from_numpy(self.last_token).to(dev, torch.int64),
                torch.from_numpy(self.lengths).to(dev, torch.int64),
                self.caches,
                torch.from_numpy(self.page_table).to(dev),
                torch.from_numpy(self.active).to(dev),
                self.cfg,
            )
            next_tokens, lps = self._sample(logits)
        self.stats["steps"] += 1
        for slot in range(self.max_seqs):
            if not self.active[slot]:
                continue
            req = self._slot_req[slot]
            tok = int(next_tokens[slot])
            self.lengths[slot] += 1  # the KV of last_token is now cached
            self._emit(req, tok, lps[slot] if lps is not None else None)
            self.last_token[slot] = tok
            self._maybe_finish(req, tok)
        return finished

    def run(self, prompts, max_new_tokens: int = 32, eos_id: int | None = None,
            max_steps: int = 10000):
        """Submit all prompts (batch-admitted), step until done, return the
        requests in submission order."""
        reqs = self.submit_many(prompts, max_new_tokens, eos_id)
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
