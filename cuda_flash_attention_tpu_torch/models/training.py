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
Meshes are not ported; orbax checkpoints wait for utils/checkpoint.py.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    tree_leaves,
    tree_map,
    value_and_grad,
)


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float().square()) for g in tree_leaves(tree)))


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

        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params):
        b1, b2, c = self.b1, self.b2, self.clip_norm
        g_norm = global_norm(grads)
        keep = g_norm < c

        def clip(g):
            return torch.where(keep, g, (g / g_norm.to(g.dtype)) * c)

        grads = tree_map(clip, grads)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g.square() + b2 * v, grads, state.nu)
        count = state.count + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        step_size = -self.schedule(state.count)
        wd = self.weight_decay

        def adamw(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            return (u + wd * p) * step_size

        return tree_map(adamw, mu, nu, params), AdamWState(count, mu, nu)

    @staticmethod
    def apply_updates(params, updates):
        return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


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
                          grad_accum: int = 1):
    """Returns step(state, tokens) -> (state, metrics), metrics holding
    "loss", "grad_norm" (before clipping) and "step".  Tokens [B, S + 1]
    (a tensor or an integer numpy array) go to the parameters' device.

    ``grad_accum`` > 1 splits the batch into that many microbatches run one
    after another; their fp32 gradients and losses are averaged, so the
    step equals the full-batch step at one microbatch's activation memory."""

    def grads_of(params, tokens):
        if grad_accum <= 1:
            return value_and_grad(params, tokens, cfg)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} must divide into grad_accum="
                             f"{grad_accum} microbatches")
        loss_sum = 0.0
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for mb in tokens.reshape(grad_accum, b // grad_accum, *tokens.shape[1:]):
            loss, g = value_and_grad(params, mb, cfg)
            g_sum = tree_map(lambda a, x: a + x.float(), g_sum, g)
            loss_sum = loss_sum + loss
        inv = 1.0 / grad_accum
        return loss_sum * inv, tree_map(lambda g, p: (g * inv).to(p.dtype),
                                        g_sum, params)

    def step(state: TrainState, tokens) -> tuple[TrainState, dict]:
        device = tree_leaves(state.params)[0].device
        tokens = torch.as_tensor(tokens).to(device=device, dtype=torch.long)
        loss, grads = grads_of(state.params, tokens)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optimizer.apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": global_norm(grads),
                   "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


def train_loop(cfg: TransformerConfig, data_iter, *, num_steps: int,
               params=None, optimizer: Optimizer | None = None,
               checkpoint_dir: str | None = None, log_every: int = 10, seed: int = 0, device=None) -> TrainState:
    """Host loop over a token iterator; returns the final TrainState.  New
    parameters come from a CPU generator seeded with `seed` and go to
    `device` (None means the card)."""
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoints are not ported yet (utils/checkpoint.py)")
    if optimizer is None:
        optimizer = make_optimizer(decay_steps=max(num_steps, 2))
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed), cfg,
                             device=resolve_device(device))
    state = init_train_state(params, optimizer)
    step_fn = make_optax_train_step(cfg, optimizer)

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
    if metrics is not None:
        check_finite(metrics)
    return state
