"""Port parity of the quantization layer (quant/qtensor.py, quant/linear.py):
the same seeded numpy inputs through the JAX package and the port give
equal bytes (int8, fp8 through a uint8 view, int4), equal scales, W8A8
activations equal byte for byte, products within the JAX tests' 1e-5
relative, and a tiny quantized transformer's fp32 logits within 1e-4
relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import assert_same_qt, numpy_tree, raw
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.quant import linear as jax_linear
from cuda_flash_attention_tpu.quant import qtensor as jax_qt
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.quant import linear, qtensor
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

DTYPES = [(jnp.int8, torch.int8), (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          (jnp.float8_e5m2, torch.float8_e5m2)]
IDS = ["int8", "e4m3", "e5m2"]
PRODUCT_RTOL = 1e-5   # tests/test_quant.py:188-198
LOGIT_RTOL = 1e-4
W8A8_FLIP_RTOL = 1e-2  # one flipped int8 activation step (see below)


def _x(seed, shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    x[0, 0] = 0.0  # an all-zero slice takes the 1e-12 scale floor
    return x


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("scale", [1.0, 3e-3, 250.0])
def test_quantize_bytes_equal(jdt, tdt, axis, scale):
    x = _x(0, (6, 4, 64), scale)
    want = jax_qt.quantize(jnp.asarray(x), jdt, axis=axis)
    got = qtensor.quantize(torch.from_numpy(x), tdt, axis=axis)
    assert_same_qt(got, want)
    np.testing.assert_array_equal(raw(got.dequantize()), raw(want.dequantize()))


@pytest.mark.parametrize("jdt,tdt", DTYPES + [("int4", "int4")],
                         ids=IDS + ["int4"])
def test_quantize_kv_bytes_equal(jdt, tdt):
    rng = np.random.default_rng(1)
    k, v = (rng.standard_normal((2, 3, 40, 64)).astype(np.float32) for _ in range(2))
    k[0, 0, 5] = 0.0
    for got, want in zip(
            qtensor.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), tdt),
            jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), jdt)):
        assert_same_qt(got, want)
        assert got.shape == tuple(want.shape) and got.ndim == want.ndim == 4
        np.testing.assert_array_equal(raw(got.dequantize()), raw(want.dequantize()))


def test_int4_pack_unpack_and_container():
    q = np.random.default_rng(2).integers(-8, 8, (32, 24)).astype(np.int8)
    packed = qtensor.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_qt.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(qtensor.unpack_int4(packed).numpy(), q)
    split = qtensor.pack_int4_split_half(torch.from_numpy(q))
    np.testing.assert_array_equal(
        split.numpy(), np.asarray(jax_qt.pack_int4_split_half(jnp.asarray(q))))

    w = _x(3, (256, 48), 0.05)
    want = jax_qt.quantize_int4(jnp.asarray(w), group_size=64)
    got = qtensor.quantize_int4(torch.from_numpy(w), group_size=64)
    assert_same_qt(got, want)
    assert got.shape == tuple(want.shape) == (256, 48) and got.ndim == 2
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert got.dequantize(torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("jdt,tdt", DTYPES + [("int4", "int4")],
                         ids=IDS + ["int4"])
def test_quantize_weight_and_matmul(jdt, tdt):
    w = _x(4, (256, 96), 0.05)
    x = np.random.default_rng(5).standard_normal((2, 7, 256)).astype(np.float32)
    want = jax_linear.quantize_weight(jnp.asarray(w), jdt)
    got = linear.quantize_weight(torch.from_numpy(w), tdt)
    assert_same_qt(got, want)
    y_want = np.asarray(jax_linear.quantized_matmul(
        jnp.asarray(x), want, precision=jax.lax.Precision.HIGHEST))
    y_got = linear.quantized_matmul(torch.from_numpy(x), got).numpy()
    assert _rel(y_got, y_want) <= PRODUCT_RTOL


def test_w8a8_activations_and_product():
    w = _x(6, (128, 64), 0.05)
    x = _x(7, (9, 128), 2.0)
    want_w = jax_linear.quantize_weight(jnp.asarray(w), jnp.int8)
    want_w = jax_qt.QuantizedTensor(want_w.values, want_w.scales, act_quant=True)
    got_w = dataclasses.replace(linear.quantize_weight(torch.from_numpy(w)),
                                act_quant=True)
    # The JAX w8a8_matmul's activation quantization (linear.py:65-70).
    xj = jnp.asarray(x)
    ax = jnp.maximum(jnp.max(jnp.abs(xj), axis=-1, keepdims=True), 1e-12)
    xq_want = jnp.clip(jnp.round(xj * (127.0 / ax)), -127, 127).astype(jnp.int8)
    xq_got, ax_got = linear.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(xq_got.numpy(), np.asarray(xq_want))
    np.testing.assert_array_equal(ax_got.numpy(), np.asarray(ax))
    y_want = np.asarray(jax_linear.quantized_matmul(xj, want_w))
    y_got = linear.dense(torch.from_numpy(x), got_w).numpy()
    assert _rel(y_got, y_want) <= PRODUCT_RTOL


@pytest.fixture(scope="module")
def tiny():
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(),
                                dtype=jnp.float32, attn_tile_dtype=None)
    cfg_t = transformer.TransformerConfig.tiny(dtype=torch.float32,
                                               attn_tile_dtype=None)
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return cfg_j, cfg_t, params_j, params_t


# Jitted: one compile per tree instead of one per eager op (10x faster).
JAX_FORWARD = jax.jit(jax_tf.forward, static_argnums=2)
QUANT_MODES = [(jnp.int8, torch.int8, False), (jnp.float8_e4m3fn, torch.float8_e4m3fn, False),
               ("int4", "int4", False), (jnp.int8, torch.int8, True)]
QUANT_IDS = ["int8", "fp8", "int4", "w8a8"]


def _leaves_by_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_by_path(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_by_path(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("jdt,tdt,act", QUANT_MODES, ids=QUANT_IDS)
def test_quantize_transformer_params_and_logits(tiny, jdt, tdt, act):
    cfg_j, cfg_t, params_j, params_t = tiny
    want = jax_linear.quantize_transformer_params(params_j, jdt, act_quant=act)
    got = linear.quantize_transformer_params(params_t, tdt, act_quant=act)
    want_leaves = dict(_leaves_by_path(
        jax.tree.map(lambda x: x, want,
                     is_leaf=lambda x: isinstance(x, jax_qt.QuantizedTensor))))
    n_quant = 0
    for path, leaf in _leaves_by_path(got):
        ref = want_leaves[path]
        if isinstance(leaf, qtensor.QuantizedTensor):
            assert_same_qt(leaf, ref)
            n_quant += 1
        else:
            np.testing.assert_array_equal(raw(leaf), raw(ref))
    assert n_quant == 7 * cfg_t.n_layers + 1
    # The same tree carried across by params_from_numpy is the port's own.
    carried = params_from_numpy(numpy_tree(want), "cpu")
    assert_same_qt(carried["layers"][0]["wq"], want["layers"][0]["wq"])

    tokens = np.random.default_rng(8).integers(0, cfg_t.vocab_size, (2, 64))
    logits_want = np.asarray(JAX_FORWARD(want, jnp.asarray(tokens), cfg_j))
    with torch.no_grad():
        logits_got = transformer.forward(got, torch.from_numpy(tokens), cfg_t).numpy()
    per_position = (np.abs(logits_got - logits_want).max(axis=-1)
                    / np.abs(logits_want).max())
    if act:
        # W8A8 rounds every layer's activations to int8: an fp32 difference
        # in the last bit upstream (attention's sum order) can flip one
        # rounding, a step of 1/127 of that row's max, at a position or two.
        assert (per_position > LOGIT_RTOL).sum() <= 2
        assert per_position.max() <= W8A8_FLIP_RTOL
    else:
        assert per_position.max() <= LOGIT_RTOL


def test_w8a8_refuses_int4():
    with pytest.raises(ValueError, match="W8A8"):
        linear.quantize_transformer_params({"wq": torch.zeros(4, 4)}, "int4",
                                           act_quant=True)
