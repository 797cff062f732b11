"""Port parity: the mixture-of-experts layer (models/moe.py) and the MoE
transformer against the JAX package's, on the CPU.

Inputs come from numpy seeds, weights from the JAX init carried across by
params_from_numpy; fp32 activations (and attn_tile_dtype=None at the model
level).  Tolerances, as tests/test_moe.py holds the JAX layer: layer
outputs within 2e-5 absolute, the router loss within 1e-6; routing
(gate_idx, rank, valid) exactly, except where a token's k-th and (k+1)-th
router probabilities are within 1e-6 of each other (two backends' fp32
routers and top-k tie rules may differ there); gradients within 1e-5 of
each leaf's own max |value|; the model's loss within 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_flash_attention_tpu.models import moe as jax_moe
from cuda_flash_attention_tpu.models import training as jax_training
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.models import moe, training, transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy


def _init_j(key, cfg_j):
    """JAX's init_params, jitted (eager it dispatches op by op)."""
    return jax.jit(jax_tf.init_params, static_argnums=1)(key, cfg_j)


MARGIN = 1e-6


def _cfgs(cf=1.25, n_experts=4, **kw):
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny_moe(n_experts=n_experts),
                                dtype=jnp.float32, attn_tile_dtype=None,
                                capacity_factor=cf, **kw)
    cfg_t = transformer.TransformerConfig.tiny_moe(
        n_experts=n_experts, dtype=torch.float32, attn_tile_dtype=None,
        capacity_factor=cf, **kw)
    return cfg_j, cfg_t


def _layer(cfg_j, seed=0):
    layer_j = jax_moe.init_moe_layer(jax.random.PRNGKey(seed), cfg_j)
    return layer_j, params_from_numpy(jax.tree.map(np.asarray, layer_j), "cpu")


def _x(seed, shape=(2, 96, 128)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _routing_j(x, layer, cfg, n):
    probs, _, idx, _ = jax_moe._route(jnp.asarray(x).reshape(n, -1), layer, cfg)
    rank = jax_moe._ranks(idx, cfg.n_experts)
    cap = jax_moe.expert_capacity(n, cfg.n_experts, cfg.expert_top_k, cfg.capacity_factor)
    return np.asarray(probs), np.asarray(idx), np.asarray(rank), np.asarray(rank) < cap


def _routing_t(x, layer, cfg, n):
    probs, _, idx, _ = moe._route(torch.from_numpy(x).reshape(n, -1), layer, cfg)
    rank = moe._ranks(idx, cfg.n_experts)
    cap = moe.expert_capacity(n, cfg.n_experts, cfg.expert_top_k, cfg.capacity_factor)
    return probs.numpy(), idx.numpy(), rank.numpy(), (rank < cap).numpy()


def _margins(probs, k):
    """Each token's gap between its k-th and (k+1)-th probability."""
    p = -np.sort(-probs, axis=-1)
    return p[:, k - 1] - p[:, k] if k < p.shape[1] else np.full(len(p), np.inf)


@pytest.mark.parametrize("cf,drops", [(1.25, False), (0.6, True)])
def test_moe_ffn_and_oracle_match_jax(cf, drops):
    """moe_ffn and moe_ffn_onehot against JAX's moe_ffn: outputs within
    2e-5, aux within 1e-6; at capacity factor 0.6 (N 192, E 4, k 2: cap 64)
    tokens are dropped."""
    cfg_j, cfg_t = _cfgs(cf)
    layer_j, layer_t = _layer(cfg_j)
    x = _x(1)
    y_j, aux_j = jax.jit(lambda xx, ll: jax_moe.moe_ffn(xx, ll, cfg_j))(jnp.asarray(x),
                                                                       layer_j)
    _, _, _, valid = _routing_j(x, layer_j, cfg_j, 192)
    assert bool((~valid).any()) == drops
    for fn in (moe.moe_ffn, moe.moe_ffn_onehot):
        y_t, aux_t = fn(torch.from_numpy(x), layer_t, cfg_t)
        assert y_t.shape == x.shape and y_t.dtype == torch.float32
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5, rtol=0)
        assert abs(float(aux_t) - float(aux_j)) < 1e-6


def test_expert_capacity_matches_jax():
    """The capacity formula over a grid of (N, E, k, cf), Python float
    arithmetic on both sides."""
    for n in (1, 7, 8, 64, 129, 512, 4096, 8192):
        for e in (2, 4, 8, 16):
            for k in (1, 2, 4):
                for cf in (0.6, 1.0, 1.25, 2.0, 4.0):
                    assert moe.expert_capacity(n, e, k, cf) == jax_moe.expert_capacity(
                        n, e, k, cf), (n, e, k, cf)


@pytest.mark.parametrize("cf", [1.25, 0.6])
@pytest.mark.parametrize("seed", [3, 4])
def test_routing_matches_jax_by_margin(cf, seed):
    """gate_idx, rank and valid equal JAX's for every token whose top-k
    margins are at least 1e-6; a token that differs must have a margin
    below that (a tie the two backends may break differently)."""
    cfg_j, cfg_t = _cfgs(cf)
    layer_j, layer_t = _layer(cfg_j, seed)
    x = _x(seed + 10, (4, 64, 128))
    n = 256
    probs, idx_j, rank_j, valid_j = _routing_j(x, layer_j, cfg_j, n)
    _, idx_t, rank_t, valid_t = _routing_t(x, layer_t, cfg_t, n)
    close = np.zeros(n, bool)
    for k in range(1, cfg_j.expert_top_k + 1):
        close |= _margins(probs, k) < MARGIN
    differ = (idx_j != idx_t).any(1)
    assert not (differ & ~close).any(), (
        f"tokens {np.flatnonzero(differ & ~close)} route differently with a "
        f"top-k margin of at least {MARGIN}")
    # A flip reorders the ranks of everything after it in that expert:
    # compare ranks only where no token flipped.
    if not differ.any():
        np.testing.assert_array_equal(rank_t, rank_j)
        np.testing.assert_array_equal(valid_t, valid_j)


@pytest.mark.parametrize("cf", [1.25, 0.6])
def test_moe_gradients_match_jax(cf):
    """The gradient of sum(y * w) + 0.01 aux with respect to x and to every
    layer weight (the router through the gate values) against jax.grad."""
    cfg_j, cfg_t = _cfgs(cf)
    layer_j, layer_t = _layer(cfg_j, 5)
    x = _x(6, (2, 48, 128))
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def loss_j(xx, ll):
        y, aux = jax_moe.moe_ffn(xx, ll, cfg_j)
        return jnp.sum(y * w) + 0.01 * aux

    gx_j, gl_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(x), layer_j)
    xt = torch.from_numpy(x).requires_grad_(True)
    lt = {k: v.clone().requires_grad_(True) for k, v in layer_t.items()}
    y, aux = moe.moe_ffn(xt, lt, cfg_t)
    (torch.sum(y * torch.from_numpy(w)) + 0.01 * aux).backward()
    assert lt["mlp_norm"].grad is None and not np.asarray(gl_j["mlp_norm"]).any()
    for got, want in [(xt.grad, gx_j)] + [(lt[k].grad, gl_j[k]) for k in (
            "router", "moe_gate", "moe_up", "moe_down")]:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * max(np.abs(want).max(), 1e-30), err
    assert float(np.abs(np.asarray(gl_j["router"])).max()) > 0


@pytest.fixture(scope="module")
def tiny_moe():
    cfg_j, cfg_t = _cfgs(0.6)
    params_j = _init_j(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j


def _params_t(params_j):
    return params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")


def _tokens(seed, batch=1, seq=49):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq)).astype(np.int32)


def test_tiny_moe_params_forward_and_loss_match_jax(tiny_moe):
    """tiny_moe's tree (layer 1 MoE), logits within 2e-5, the summed aux
    within 1e-6 and the loss (with router_aux_coef x aux) within 1e-5
    relative."""
    cfg_j, cfg_t, params_j = tiny_moe
    params_t = _params_t(params_j)
    assert [cfg_t.is_moe_layer(i) for i in range(2)] == [False, True]
    assert sorted(params_t["layers"][1]) == sorted(params_j["layers"][1])
    assert params_t["layers"][1]["moe_gate"].shape == (4, 128, 256)
    ours = transformer.init_params(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    assert jax.tree.map(np.shape, params_j) == jax.tree.map(
        lambda t: tuple(t.shape), ours)
    tok = _tokens(1)

    @jax.jit
    def run_j(p, t):
        logits, aux = jax_tf.forward(p, t[:, :-1], cfg_j, return_aux=True)
        return logits, aux, jax_tf.loss_fn(p, t, cfg_j)

    logits_j, aux_j, loss_j = run_j(params_j, jnp.asarray(tok))
    logits_t, aux_t = transformer.forward(params_t, torch.from_numpy(tok[:, :-1]).long(),
                                          cfg_t, return_aux=True)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=2e-5, rtol=0)
    assert abs(float(aux_t) - float(aux_j)) < 1e-6
    loss_t = transformer.loss_fn(params_t, torch.from_numpy(tok).long(), cfg_t)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))


def test_tiny_moe_adamw_step_matches_optax(tiny_moe):
    """One AdamW step (warmup 0, so the first step moves the weights) on
    tiny_moe: the loss and grad norm within 1e-5 relative, and every
    parameter after the step within 1e-5 of its leaf's max |value|
    wherever the port's gradient is above 1e-5 of that leaf's max.  Below
    it (an expert weight row no token reached, a near-zero product),
    Adam's first update g / (|g| + 1e-8) turns fp32 noise in g into any
    value in [-lr, lr], so there the two steps agree within 2 lr."""
    cfg_j, cfg_t, params_j = tiny_moe
    lr = 1e-3
    kw = dict(learning_rate=lr, warmup_steps=0, decay_steps=10)
    tok = _tokens(2)
    opt_j = jax_training.make_optimizer(**kw)
    state_j, m_j = jax.jit(jax_training.make_optax_train_step(cfg_j, opt_j))(
        jax_training.init_train_state(params_j, opt_j), jnp.asarray(tok))
    opt_t = training.make_optimizer(**kw)
    params_t = _params_t(params_j)
    state_t, m_t = training.make_optax_train_step(cfg_t, opt_t)(
        training.init_train_state(params_t, opt_t), tok)
    _, grads_t = transformer.value_and_grad(params_t, torch.from_numpy(tok).long(), cfg_t)
    for key in ("loss", "grad_norm"):
        assert abs(float(m_t[key]) - float(m_j[key])) <= 1e-5 * abs(float(m_j[key]))
    got, want = transformer.tree_leaves(state_t.params), jax.tree.leaves(state_j.params)
    assert len(got) == len(want)
    for p, w, gt in zip(got, want, transformer.tree_leaves(grads_t)):
        w, g = np.asarray(w), gt.numpy()
        err = np.abs(p.numpy() - w)
        small = np.abs(g) < 1e-5 * np.abs(g).max()
        assert err[~small].max(initial=0) <= 1e-5 * max(np.abs(w).max(), 1e-30)
        assert err.max() <= 2 * lr
    assert optax is not None
