"""Port parity of LoRA (models/lora.py, the LoRA AdamW of
models/training.py): `dense` on a LoRATensor against JAX's; two AdamW steps
of the LoRA optimizer against the JAX make_lora_optimizer chain from the
same adapters (adapters and loss within 1e-5 relative), every frozen leaf
bitwise unchanged and optimizer state for the adapters alone; merge_lora on
plain, int8 and int4 bases with bytes equal to JAX's after the
requantization."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import assert_same_qt, numpy_tree, raw
from cuda_flash_attention_tpu.models import lora as jax_lora
from cuda_flash_attention_tpu.models import training as jax_training
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.quant import linear as jax_linear
from cuda_flash_attention_tpu_torch.models import lora, training, transformer
from cuda_flash_attention_tpu_torch.quant import linear
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    return cfg_j, cfg_t, jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)


def _with_random_b(tree, seed=2):
    """Adapters with b != 0, so that both a and b have gradients."""
    rng = np.random.default_rng(seed)

    def _r(x):
        if isinstance(x, jax_lora.LoRATensor):
            b = (0.1 * rng.standard_normal(x.b.shape)).astype(np.float32)
            return jax_lora.LoRATensor(x.base, x.a, jnp.asarray(b), scale=x.scale)
        return x

    return jax.tree.map(_r, tree, is_leaf=lambda x: isinstance(x, jax_lora.LoRATensor))


def _rel(got, want) -> float:
    return float(np.abs(raw(got) - raw(want)).max() / max(np.abs(raw(want)).max(), 1e-30))


def test_apply_lora_is_transparent_and_masked(tiny):
    """b starts at zero, so the wrapped model is the base model; the mask
    marks only a and b."""
    _, cfg_t, params_j = tiny
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    lp = lora.apply_lora(params_t, torch.Generator().manual_seed(0), rank=4)
    wq = lp["layers"][0]["wq"]
    assert isinstance(wq, lora.LoRATensor) and wq.a.shape == (cfg_t.d_model, 4)
    assert not wq.b.any() and wq.scale == 1.0
    tokens = torch.randint(0, cfg_t.vocab_size, (1, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(transformer.forward(lp, tokens, cfg_t),
                           transformer.forward(params_t, tokens, cfg_t))
    mask = lora.lora_trainable_mask(lp)
    assert mask["layers"][0]["wq"].a is True and mask["layers"][0]["wq"].base is False
    assert mask["embed"] is False and mask["lm_head"] is False
    # QLoRA: the adapters land on the quantized base's device.
    qp = linear.quantize_transformer_params(params_t, "int4")
    lq = lora.apply_lora(qp, torch.Generator().manual_seed(0), rank=4)
    wq = lq["layers"][0]["wq"]
    assert isinstance(wq.base, QuantizedTensor) and wq.a.device == wq.base.device
    with torch.no_grad():
        assert torch.equal(transformer.forward(lq, tokens, cfg_t),
                           transformer.forward(qp, tokens, cfg_t))


@pytest.mark.parametrize("base", ["plain", "int8", "int4"])
def test_dense_on_a_lora_tensor(tiny, base):
    w = np.random.default_rng(3).standard_normal((128, 64)).astype(np.float32) * 0.1
    x = np.random.default_rng(4).standard_normal((5, 128)).astype(np.float32)
    wj = jnp.asarray(w)
    if base != "plain":
        wj = jax_linear.quantize_weight(wj, jnp.int8 if base == "int8" else "int4")
    lj = _with_random_b({"wq": jax_lora._wrap(jax.random.PRNGKey(5), wj, 4, 8.0,
                                              jnp.float32)})["wq"]
    lt = params_from_numpy(numpy_tree(lj), "cpu")
    assert isinstance(lt, lora.LoRATensor) and lt.shape == (128, 64) and lt.ndim == 2
    want = jax_linear.dense(jnp.asarray(x), lj)
    got = linear.dense(torch.from_numpy(x), lt)
    assert _rel(got, want) <= RTOL


def test_lora_adamw_steps_match_jax(tiny):
    cfg_j, cfg_t, params_j = tiny
    lp_j = _with_random_b(jax_lora.apply_lora(params_j, jax.random.PRNGKey(3), rank=4))
    lp_t = params_from_numpy(numpy_tree(lp_j), "cpu")
    kw = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=50)
    opt_j = jax_lora.make_lora_optimizer(jax_training.make_optimizer(**kw), lp_j)
    opt_t = training.make_lora_optimizer(training.make_optimizer(**kw), lp_t)
    step_j = jax.jit(jax_training.make_optax_train_step(cfg_j, opt_j))
    step_t = training.make_optax_train_step(cfg_t, opt_t)
    state_j = jax_training.init_train_state(lp_j, opt_j)
    state_t = training.init_train_state(lp_t, opt_t)
    tokens = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (2, 65))
    for _ in range(2):  # the first step's learning rate is 0 (warmup from 0)
        state_j, m_j = step_j(state_j, jnp.asarray(tokens))
        state_t, m_t = step_t(state_t, tokens)
        assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= RTOL * float(m_j["loss"])

    adapters_t = lora.lora_adapters(state_t.params)
    assert len(state_t.opt_state.mu) == len(adapters_t) == 2 * 7 * cfg_t.n_layers
    # JAX's adapters in tree order (sorted keys, as lora_adapters walks).
    adapters_j = jax.tree.leaves(jax.tree.map(
        lambda x: (x.a, x.b) if isinstance(x, jax_lora.LoRATensor) else None,
        state_j.params, is_leaf=lambda x: isinstance(x, jax_lora.LoRATensor)))
    moved = 0
    for x_t, x_j, x0 in zip(adapters_t, adapters_j, lora.lora_adapters(lp_t),
                            strict=True):
        assert _rel(x_t, x_j) <= RTOL
        moved += int(not torch.equal(x_t, x0))
    assert moved == len(adapters_t)

    # Frozen leaves: the same tensors, bit for bit; quantized or plain.
    def frozen(tree):
        return [x.base if isinstance(x, lora.LoRATensor) else x
                for x in transformer.tree_leaves(tree)]

    for before, after in zip(frozen(lp_t), frozen(state_t.params)):
        assert torch.equal(before, after)


@pytest.mark.parametrize("base", ["plain", "int8", "int4"])
def test_merge_lora_matches_jax_bytes(tiny, base):
    _, _, params_j = tiny
    if base != "plain":
        params_j = jax_linear.quantize_transformer_params(
            params_j, jnp.int8 if base == "int8" else "int4")
    lp_j = _with_random_b(jax_lora.apply_lora(params_j, jax.random.PRNGKey(7), rank=4))
    lp_t = params_from_numpy(numpy_tree(lp_j), "cpu")
    want = jax_lora.merge_lora(lp_j)
    got = lora.merge_lora(lp_t)
    for name in ("wq", "w_down"):
        g, w = got["layers"][1][name], want["layers"][1][name]
        if base == "plain":
            np.testing.assert_array_equal(raw(g), raw(w))
        else:
            assert isinstance(g, QuantizedTensor)
            assert_same_qt(g, w)
    # lm_head is not a target: untouched.
    assert not isinstance(got["lm_head"], lora.LoRATensor)


def test_full_training_refuses_quantized_leaves(tiny):
    """Full training of an int8 tree differentiates what JAX's allow_int
    path does: the scales get gradients, the int8 values zeros (frozen).
    The LoRA optimizer still refuses a tree without adapters."""
    _, cfg_t, params_j = tiny
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    qp = linear.quantize_transformer_params(params_t, torch.int8)
    tokens = torch.zeros(1, 9, dtype=torch.long)
    _, grads = transformer.value_and_grad(qp, tokens, cfg_t)
    g = grads["layers"][0]["wq"]
    assert isinstance(g, QuantizedTensor) and g.values.dtype == torch.int8
    assert not g.values.any() and g.scales.abs().sum() > 0
    with pytest.raises(ValueError, match="no LoRATensor"):
        training.make_lora_optimizer(training.make_optimizer(), params_t)
