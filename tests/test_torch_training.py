"""Port parity: the loss, the SGD-momentum step and the AdamW train step of
cuda_flash_attention_tpu_torch against the JAX package's (optax), at
TransformerConfig.tiny() with the JAX parameters carried across by
params_from_numpy and tokens from numpy.

fp32 activations and tiles (attn_tile_dtype=None) on both sides.  Losses and
grad norms agree to 1e-5 relative, each gradient leaf to 1e-5 of its own max
|value|, parameters after AdamW steps to 1e-5 of the leaf's max |value|.
The attention backward on the port's side is the plain version of B2 (the
fused route: S 32 is one KV slice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_flash_attention_tpu.models import training as jax_training
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES
from cuda_flash_attention_tpu_torch.models import training, transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j


def _params_t(params_j):
    return params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")


def _tokens(seed, batch=2, seq=33):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq)).astype(np.int32)


def _assert_tree_close(got, want, tol=TOL):
    got_leaves = transformer.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (err, np.abs(w).max())


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_loss_and_grads_match_jax(tiny):
    cfg_j, cfg_t, params_j = tiny
    tokens = _tokens(0)
    loss_j, grads_j = jax.value_and_grad(jax_tf.loss_fn)(
        params_j, jnp.asarray(tokens), cfg_j)
    loss_t, grads_t = transformer.value_and_grad(
        _params_t(params_j), torch.from_numpy(tokens).long(), cfg_t)
    assert _rel(loss_t, loss_j) <= TOL
    _assert_tree_close(grads_t, grads_j)


def test_sgd_momentum_steps_match_jax(tiny):
    cfg_j, cfg_t, params_j = tiny
    step_j = jax.jit(jax_tf.make_train_step(cfg_j, learning_rate=1e-2))
    step_t = transformer.make_train_step(cfg_t, learning_rate=1e-2)
    p_j, o_j = params_j, jax_tf.init_opt_state(params_j)
    p_t = _params_t(params_j)
    o_t = transformer.init_opt_state(p_t)
    for i in range(2):
        tokens = _tokens(10 + i)
        p_j, o_j, loss_j = step_j(p_j, o_j, jnp.asarray(tokens))
        p_t, o_t, loss_t = step_t(p_t, o_t, torch.from_numpy(tokens).long())
        assert _rel(loss_t, loss_j) <= TOL
    _assert_tree_close(o_t, o_j)
    _assert_tree_close(p_t, p_j)


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=3, decay_steps=10,
        end_value=3e-5)
    got = training.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    for count in range(14):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12)
    assert got(0) == 0.0


@pytest.mark.parametrize("scale", [1e-3, 1e3], ids=["unclipped", "clipped"])
def test_optimizer_update_matches_optax(scale):
    """The same gradients through both chains, twice (bias corrections at
    counts 1 and 2, a warmup lr and the peak lr)."""
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": [rng.standard_normal(11).astype(np.float32)]}
    opt_j = jax_training.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                        decay_steps=4)
    opt_t = training.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                    decay_steps=4)
    p_j = jax.tree.map(jnp.asarray, params)
    p_t = params_from_numpy(params, "cpu")
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for i in range(3):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale)
                         .astype(np.float32), params)
        u_j, s_j = opt_j.update(jax.tree.map(jnp.asarray, g), s_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u_t, s_t = opt_t.update(params_from_numpy(g, "cpu"), s_t, p_t)
        p_t = opt_t.apply_updates(p_t, u_t)
        _assert_tree_close(u_t, u_j, tol=1e-5)
    _assert_tree_close(p_t, p_j, tol=1e-6)


def test_optax_train_steps_match_jax(tiny):
    cfg_j, cfg_t, params_j = tiny
    kw = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=4)
    opt_j = jax_training.make_optimizer(**kw)
    opt_t = training.make_optimizer(**kw)
    state_j = jax_training.init_train_state(params_j, opt_j)
    state_t = training.init_train_state(_params_t(params_j), opt_t)
    step_j = jax.jit(jax_training.make_optax_train_step(cfg_j, opt_j))
    step_t = training.make_optax_train_step(cfg_t, opt_t)
    for i in range(3):
        tokens = _tokens(20 + i)
        state_j, m_j = step_j(state_j, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, tokens)
        assert m_t["step"] == int(m_j["step"]) == i + 1
        assert _rel(m_t["loss"], m_j["loss"]) <= TOL
        assert _rel(m_t["grad_norm"], m_j["grad_norm"]) <= TOL
    assert state_t.step == 3
    _assert_tree_close(state_t.params, state_j.params)


def test_grad_accum_equals_full_batch(tiny):
    """Compared on the first step's Adam moments, which are linear in the
    (clipped) gradients: Adam's normalised update would magnify fp32
    rounding differences on gradients near zero."""
    _, cfg_t, params_j = tiny
    tokens = _tokens(30, batch=4)
    out = []
    for accum in (1, 2):
        opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1,
                                      decay_steps=4)
        state = training.init_train_state(_params_t(params_j), opt)
        step = training.make_optax_train_step(cfg_t, opt, grad_accum=accum)
        out.append(step(state, tokens))
    (s1, m1), (s2, m2) = out
    assert _rel(m2["loss"], m1["loss"]) <= TOL
    assert _rel(m2["grad_norm"], m1["grad_norm"]) <= TOL
    for a, b in zip(transformer.tree_leaves([s2.opt_state.mu, s2.opt_state.nu]),
                    transformer.tree_leaves([s1.opt_state.mu, s1.opt_state.nu])):
        assert (a - b).abs().max() <= TOL * b.abs().max()


def test_remat_full_equals_none(tiny):
    _, cfg_t, params_j = tiny
    tokens = torch.from_numpy(_tokens(40)).long()
    params = _params_t(params_j)
    loss_a, g_a = transformer.value_and_grad(params, tokens, cfg_t)
    cfg_full = dataclasses.replace(cfg_t, remat="full")
    loss_b, g_b = transformer.value_and_grad(params, tokens, cfg_full)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(transformer.tree_leaves(g_a), transformer.tree_leaves(g_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("remat,exc", [("bogus", ValueError)])
def test_unported_remat_raises(tiny, remat, exc):
    _, cfg_t, params_j = tiny
    cfg = dataclasses.replace(cfg_t, remat=remat)
    with pytest.raises(exc):
        transformer.loss_fn(_params_t(params_j), torch.zeros(1, 9, dtype=torch.long),
                            cfg)


def test_bf16_step_reduces_loss_on_one_batch():
    """The default tiny() (bf16 activations and tiles) memorizes one batch,
    as tests/test_training.py does for the JAX step."""
    cfg = transformer.TransformerConfig.tiny()
    opt = training.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                  decay_steps=20)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    state = training.init_train_state(params, opt)
    step = training.make_optax_train_step(cfg, opt)
    tokens = _tokens(50, seq=129)
    losses = []
    for _ in range(8):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    assert state.step == 8


def test_train_loop_runs_and_checks_finiteness(tmp_path):
    """Two steps; with checkpoint_dir the loop saves every checkpoint_every
    steps (utils/checkpoint.py), the step restoring with it."""
    from cuda_flash_attention_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                             attn_tile_dtype=None)
    batches = iter([_tokens(60 + i) for i in range(2)])
    state = training.train_loop(cfg, batches, num_steps=2, log_every=0,
                                device="cpu", checkpoint_dir=str(tmp_path / "ck"),
                                checkpoint_every=2)
    assert state.step == 2
    assert restore_checkpoint(str(tmp_path / "ck"), device="cpu")["step"] == 2


def test_no_kernel_launches_on_the_cpu(tiny):
    _, cfg_t, params_j = tiny
    before = (LAUNCHES["fa2_forward"], LAUNCHES["fa2_backward_fused"],
              LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"])
    opt = training.make_optimizer(learning_rate=1e-3)
    step = training.make_optax_train_step(cfg_t, opt)
    step(training.init_train_state(_params_t(params_j), opt), _tokens(70))
    assert (LAUNCHES["fa2_forward"], LAUNCHES["fa2_backward_fused"],
            LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"]) == before
