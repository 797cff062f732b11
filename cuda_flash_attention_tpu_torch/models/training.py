"""Production train step: AdamW with a warmup-cosine schedule and global-norm
clipping, gradient accumulation, and a host loop with a finiteness check.

Counterpart of cuda_flash_attention_tpu/models/training.py.  The JAX package
builds its optimizer with optax; the port writes the same chain out in torch
with optax's formulas, so that the same gradients give the same updates:
  clip_by_global_norm(c):  g if |g| < c else (g / |g|) * c  (no epsilon;
                           torch.nn.utils.clip_grad_norm_ adds 1e-6)
  scale_by_adam:           mu = (1-b1) g + b1 mu,  nu = (1-b2) g^2 + b2 nu,
                           u = mu_hat / (sqrt(nu_hat) + eps), eps outside
                           the root, bias corrections at the incremented
                           count
  add_decayed_weights:     u + weight_decay * p, on every leaf
  scale_by_learning_rate:  -lr(count) * u, the schedule read at the count
                           BEFORE the increment (the first step has lr 0)
make_lora_optimizer trains only LoRA adapters (models/lora.py).  The
optimizer walks the arrays of the tree as JAX's pytree flattens it
(transformer.array_map): a QuantizedTensor's scales and fp8 values are
trained like any floating-point leaf, its integer values stay frozen (zero
gradient and zero update: JAX's allow_int path gives them zero gradients,
and its optax step cannot clip an integer leaf).  An fp8 leaf's moments and
update are computed in fp32 and stored in fp8.  train_loop saves
checkpoints with utils/checkpoint.py.

With a mesh (`mesh=`; parallel/mesh.py) the step is this rank's part of a
data x model x context x expert-parallel step: the parameters and the optimizer
state are the rank's blocks (transformer.shard_params), the tokens the
global batch on every rank, the gradients arrive summed over data and ctx
(transformer.value_and_grad), the global norm sums the squares of each
split leaf over the axes that split it ("model", and "expert" for an MoE
layer's experts) once, so it equals the unsharded norm, and AdamW runs on
the local blocks.  The LoRA optimizer takes no mesh.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.profiler import record_function

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.models.lora import (
    lora_adapters,
    replace_adapters,
)
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    _split_axes,
    array_leaves,
    array_map,
    init_params,
    loss_fn,
    param_split_dims,
    shard_params,
    tree_leaves,
    tree_map,
    value_and_grad,
)
from cuda_flash_attention_tpu_torch.parallel.collectives import all_reduce_coalesced

_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class AdamWState(NamedTuple):
    count: int  # optax's ScaleByAdamState.count and ScaleByScheduleState.count
    mu: Any
    nu: Any


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    init_value to peak_value over warmup_steps, then cosine to end_value at
    decay_steps (the total length, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tree, mesh=None, cfg: TransformerConfig | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every array, in fp32 (optax.global_norm).
    With a mesh, `tree` holds this rank's blocks (a gradient tree shaped
    like the parameters of `cfg`) and each split leaf's sum of squares is
    summed over the axes that split it ("model", "expert" or both) first:
    the norm of the full tree."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(g.float().square())
                              for g in array_leaves(tree)))

    # Each leaf's sum of squares, grouped by the axes that split it; each
    # group summed over its axes in one collective an axis.
    groups: dict[tuple, list] = {}

    def add(g, spec):
        axes = tuple(axis for _, axis in _split_axes(spec, mesh))
        groups.setdefault(axes, []).extend(
            torch.sum(a.float().square()) for a in array_leaves(g))

    tree_map(add, tree, param_split_dims(cfg, mesh))
    return torch.sqrt(sum(sum(all_reduce_coalesced(sums, mesh, *axes))
                          for axes, sums in groups.items()))


class Optimizer:
    """clip_by_global_norm(clip_norm) then adamw(schedule, b1, b2, eps,
    weight_decay), as make_optimizer's optax chain.  `update` returns
    (updates, state) and `apply_updates` adds them, as in optax."""

    def __init__(self, schedule, clip_norm: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p)

        return AdamWState(0, array_map(zeros, params), array_map(zeros, params))

    def update(self, grads, state: AdamWState, params, g_norm=None):
        """`g_norm`: the gradients' global norm where the caller has it
        (a mesh step's, over every rank's blocks); else global_norm."""
        b1, b2, c = self.b1, self.b2, self.clip_norm
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < c
        count = state.count + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        step_size = -self.schedule(state.count)
        wd = self.weight_decay

        def leaf(g, m, v, p):
            """(update, mu, nu) of one array."""
            if not p.is_floating_point():  # frozen integer values
                return torch.zeros_like(p), m, v
            dtype = p.dtype
            if dtype in _FP8:
                g, m, v, p = (t.float() for t in (g, m, v, p))
            g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * c)
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * g.square() + b2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = (u + wd * p) * step_size
            if dtype in _FP8:
                return u.to(dtype), m.to(dtype), v.to(dtype)
            return u, m, v

        out = []
        array_map(lambda *a: out.append(leaf(*a)), grads, state.mu, state.nu, params)
        trees = []
        for i in range(3):
            it = iter([o[i] for o in out])
            trees.append(array_map(lambda _: next(it), params))
        return trees[0], AdamWState(count, trees[1], trees[2])

    @staticmethod
    def apply_updates(params, updates):
        def apply(p, u):
            if not p.is_floating_point():
                return p
            if p.dtype in _FP8:
                return (p.float() + u.float()).to(p.dtype)
            return (p + u).to(p.dtype)

        return array_map(apply, params, updates)

    @staticmethod
    def trainable(params):
        """The tree the step differentiates and this optimizer updates."""
        return params

    @staticmethod
    def value_and_grad(params, tokens, cfg: TransformerConfig, mesh=None):
        return value_and_grad(params, tokens, cfg, mesh)


class LoRAOptimizer:
    """`inner` (clipping and AdamW) on the LoRA adapters alone, as
    make_lora_optimizer's optax chain: the step differentiates only the
    adapters (lora_adapters order), the clip norm is theirs, optimizer
    state exists only for them, and every frozen leaf gets a zero update,
    so it stays the same tensor, bit for bit."""

    def __init__(self, inner: Optimizer):
        self.inner = inner

    def init(self, params) -> AdamWState:
        return self.inner.init(lora_adapters(params))

    def update(self, grads, state: AdamWState, params, g_norm=None):
        return self.inner.update(grads, state, lora_adapters(params), g_norm)

    @staticmethod
    def apply_updates(params, updates):
        new = [(p + u).to(p.dtype) for p, u in zip(lora_adapters(params), updates)]
        return replace_adapters(params, new)

    @staticmethod
    def trainable(params):
        return lora_adapters(params)

    @staticmethod
    def value_and_grad(params, tokens, cfg: TransformerConfig):
        """(loss, grads of the adapters): nothing else is differentiated."""
        with torch.enable_grad():
            wrt = [a.detach().requires_grad_(True) for a in lora_adapters(params)]
            loss = loss_fn(replace_adapters(params, wrt), tokens, cfg)
            grads = list(torch.autograd.grad(loss, wrt))
        return loss.detach(), grads


def make_lora_optimizer(inner: Optimizer, params) -> LoRAOptimizer:
    """The counterpart of the JAX make_lora_optimizer (lora.py:111-123):
    trains only the adapters of `params`.  Frozen leaves get a zero update
    and no state; the optax.masked-only form, which passes frozen leaves'
    raw gradients through as updates, is not ported."""
    if not lora_adapters(params):
        raise ValueError("make_lora_optimizer: params hold no LoRATensor")
    return LoRAOptimizer(inner)


def make_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                   decay_steps: int = 10_000, weight_decay: float = 0.01,
                   clip_norm: float = 1.0, b1: float = 0.9,
                   b2: float = 0.95) -> Optimizer:
    # decay_steps is the TOTAL schedule length; warmup stays strictly inside
    # it so that short runs stay valid.
    warmup_steps = min(warmup_steps, max(decay_steps - 1, 1))
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate, warmup_steps=warmup_steps,
        decay_steps=decay_steps, end_value=learning_rate * 0.1)
    return Optimizer(schedule, clip_norm, b1, b2, eps=1e-8,
                     weight_decay=weight_decay)


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_optax_train_step(cfg: TransformerConfig, optimizer: Optimizer,
                          grad_accum: int = 1, mesh=None):
    """Returns step(state, tokens) -> (state, metrics), metrics holding
    "loss", "grad_norm" (before clipping, over what the optimizer trains:
    every leaf, or a LoRA optimizer's adapters) and "step".  Tokens [B, S + 1]
    (a tensor or an integer numpy array) go to the parameters' device.

    ``grad_accum`` > 1 splits the batch into that many microbatches run one
    after another; their fp32 gradients and losses are averaged, so the
    step equals the full-batch step at one microbatch's activation memory.

    ``mesh``: the step of one rank of a mesh (the module's note); the
    microbatches split the global batch, each as the JAX step splits it."""
    if mesh is not None and not isinstance(optimizer, Optimizer):
        raise NotImplementedError("the LoRA optimizer takes no mesh")
    kw = {} if mesh is None else {"mesh": mesh}

    def grads_of(params, tokens):
        if grad_accum <= 1:
            return optimizer.value_and_grad(params, tokens, cfg, **kw)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} must divide into grad_accum="
                             f"{grad_accum} microbatches")
        wrt = optimizer.trainable(params)
        loss_sum = 0.0
        g_sum = array_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), wrt)
        for mb in tokens.reshape(grad_accum, b // grad_accum, *tokens.shape[1:]):
            loss, g = optimizer.value_and_grad(params, mb, cfg, **kw)
            g_sum = array_map(lambda a, x: a + x.float(), g_sum, g)
            loss_sum = loss_sum + loss
        inv = 1.0 / grad_accum
        return loss_sum * inv, array_map(lambda g, p: (g * inv).to(p.dtype),
                                         g_sum, wrt)

    def step(state: TrainState, tokens) -> tuple[TrainState, dict]:
        # The two ranges name the step's parts in a profiler trace (the
        # backward's ops run on autograd's own thread, outside both).
        device = tree_leaves(optimizer.trainable(state.params))[0].device
        tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
        with record_function("train_step.value_and_grad"):
            loss, grads = grads_of(state.params, tokens)
        with record_function("train_step.update"):
            g_norm = global_norm(grads, mesh, cfg)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, g_norm)
            params = optimizer.apply_updates(state.params, updates)
            metrics = {"loss": loss, "grad_norm": g_norm,
                       "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def train_loop(cfg: TransformerConfig, data_iter, *, num_steps: int,
               params=None, optimizer: Optimizer | None = None,
               checkpoint_dir: str | None = None, checkpoint_every: int = 0,
               log_every: int = 10, seed: int = 0, device=None,
               mesh=None) -> TrainState:
    """Host loop over a token iterator; returns the final TrainState.  New
    parameters come from a CPU generator seeded with `seed` and go to
    `device` (None means the card); with a mesh, a rank keeps its blocks of
    them (and `params`, when given, are its blocks).  With checkpoint_dir and
    checkpoint_every, every checkpoint_every-th step saves (params,
    opt_state, step) there (utils/checkpoint.py), after a finiteness check
    of its loss."""
    from cuda_flash_attention_tpu_torch.utils.checkpoint import save_checkpoint

    if optimizer is None:
        optimizer = make_optimizer(decay_steps=max(num_steps, 2))
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), cfg,
                             device=resolve_device(device))
        if mesh is not None:
            params = shard_params(params, mesh, cfg)
    state = init_train_state(params, optimizer)
    step_fn = make_optax_train_step(cfg, optimizer, mesh=mesh)

    def check_finite(metrics):
        # Abort before a poisoned step goes further; checked only at log
        # boundaries, since each check waits for the device.
        if not bool(torch.isfinite(metrics["loss"])):
            raise FloatingPointError(
                f"non-finite loss at step {metrics['step']}; restore the "
                "last checkpoint to resume")

    metrics = None
    for i in range(num_steps):
        state, metrics = step_fn(state, next(data_iter))
        if log_every and (i + 1) % log_every == 0:
            check_finite(metrics)
            print(f"step {metrics['step']}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if checkpoint_dir and checkpoint_every and (i + 1) % checkpoint_every == 0:
            check_finite(metrics)
            save_checkpoint(checkpoint_dir, state.params, state.opt_state,
                            step=state.step)
    if metrics is not None:
        check_finite(metrics)
    return state
