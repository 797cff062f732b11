"""Port parity on the training path: remat "dots", gradients through
quantized weights and training checkpoints (utils/checkpoint.py), on the
CPU at TransformerConfig.tiny() (and tiny_moe) in fp32 with
attn_tile_dtype=None, the JAX parameters carried across by
params_from_numpy.

Tolerances: remat "dots" gradients bitwise equal to remat "none" (a
recomputation on the CPU repeats the same operations), its loss within
1e-5 relative of JAX's "dots" loss; quantized-weight gradients within 1e-5
of each leaf's own max |value|, except fp8 values, whose gradient JAX and
the port both round to fp8 (within one e4m3 step, 2^-3 relative, of the
leaf's max); integer values' gradients are zeros on both sides; a resumed
step bitwise equal to the uninterrupted one, as tests/test_checkpoint.py
holds the JAX package.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.quant import linear as jax_linear
from cuda_flash_attention_tpu_torch.models import lora, training, transformer
from cuda_flash_attention_tpu_torch.quant import linear
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor
from cuda_flash_attention_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_for_backward,
)
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy


def _init_j(key, cfg_j):
    """JAX's init_params, jitted (eager it dispatches op by op)."""
    return jax.jit(jax_tf.init_params, static_argnums=1)(key, cfg_j)


TOL = 1e-5


def _cfgs(moe=False, **kw):
    make_j = jax_tf.TransformerConfig.tiny_moe if moe else jax_tf.TransformerConfig.tiny
    make_t = (transformer.TransformerConfig.tiny_moe if moe
              else transformer.TransformerConfig.tiny)
    cfg_j = dataclasses.replace(make_j(), dtype=jnp.float32, attn_tile_dtype=None, **kw)
    return cfg_j, make_t(dtype=torch.float32, attn_tile_dtype=None, **kw)


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = _cfgs()
    params_j = _init_j(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, params_j


def _tokens(seed, batch=1, seq=33):
    return np.random.default_rng(seed).integers(0, 256, (batch, seq)).astype(np.int32)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "tiny_moe"])
def test_remat_dots_gradients_equal_none_and_jax_loss(moe):
    """Gradients under "dots" bitwise those under "none"; on tiny_moe the
    loss within 1e-5 relative of JAX's "dots" loss."""
    cfg_j, cfg_t = _cfgs(moe)
    params_j = _init_j(jax.random.PRNGKey(1), cfg_j) if moe else None
    params = (params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu") if moe else
              transformer.init_params(torch.Generator().manual_seed(1), cfg_t, device="cpu"))
    tok = torch.from_numpy(_tokens(3)).long()
    loss_n, g_n = transformer.value_and_grad(params, tok, cfg_t)
    loss_d, g_d = transformer.value_and_grad(
        params, tok, dataclasses.replace(cfg_t, remat="dots"))
    assert float(loss_d) == float(loss_n)
    for a, b in zip(transformer.tree_leaves(g_n), transformer.tree_leaves(g_d)):
        assert torch.equal(a, b)
    if not moe:  # the JAX "dots" loss once, on the model with experts
        return
    cfg_jd = dataclasses.replace(cfg_j, remat="dots")
    loss_j = jax.jit(jax_tf.loss_fn, static_argnums=2)(params_j, jnp.asarray(_tokens(3)),
                                                       cfg_jd)
    assert abs(float(loss_d) - float(loss_j)) <= TOL * abs(float(loss_j))


def test_remat_dots_saves_the_dense_products_only():
    """Under "dots" the backward recomputes no dense product (its aten.mm
    count is "none"'s, below "full"'s, which recomputes them) but does
    recompute the experts' batched products (more bmm than "none")."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    _, cfg = _cfgs(moe=True)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.from_numpy(_tokens(4)).long()
    counts = {}
    for remat in ("none", "dots", "full"):
        with torch.enable_grad():
            wrt = [p.detach().requires_grad_(True) for p in transformer.tree_leaves(params)]
            it = iter(wrt)
            loss = transformer.loss_fn(transformer.tree_map(lambda _: next(it), params), tok,
                                       dataclasses.replace(cfg, remat=remat))
            with Count() as c:
                torch.autograd.grad(loss, wrt)
        counts[remat] = c.n
    assert counts["dots"]["mm"] == counts["none"]["mm"] < counts["full"]["mm"], counts
    assert counts["none"]["bmm"] < counts["dots"]["bmm"] == counts["full"]["bmm"], counts


def _vag_j(params_j, tok, cfg_j):
    """JAX's _vag (models/training.py): allow_int, float0 tangents as zeros."""
    loss, g = jax.jit(jax.value_and_grad(jax_tf.loss_fn, allow_int=True),
                      static_argnums=2)(params_j, jnp.asarray(tok), cfg_j)
    return loss, jax.tree.map(
        lambda gi, p: jnp.zeros_like(p) if gi.dtype == jax.dtypes.float0 else gi,
        g, params_j)


@pytest.mark.parametrize("kind", ["int8", "int4", "e4m3", "w8a8"])
def test_quantized_weight_gradients_match_jax_vag(tiny, kind):
    """value_and_grad on a quantized tree, leaf by leaf (values, scales) as
    the JAX pytree flattens it, against JAX's _vag: the scales (and fp8
    values) get gradients, int8 and packed int4 values zeros; W8A8 carries
    a gradient to the scales through its epilogue."""
    cfg_j, cfg_t, params_j = tiny
    dtype_j, dtype_t = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
                        "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
                        "w8a8": (jnp.int8, torch.int8)}[kind]
    act = kind == "w8a8"
    qp_j = jax.jit(lambda p: jax_linear.quantize_transformer_params(
        p, dtype_j, act_quant=act))(params_j)
    qp_t = params_from_numpy(numpy_tree(qp_j), "cpu")
    tok = _tokens(5, seq=17)
    loss_j, g_j = _vag_j(qp_j, tok, cfg_j)
    loss_t, g_t = transformer.value_and_grad(qp_t, torch.from_numpy(tok).long(), cfg_t)
    assert abs(float(loss_t) - float(loss_j)) <= TOL * abs(float(loss_j))
    pairs = []  # (port, JAX) gradient arrays, matched by path
    transformer.array_map(lambda a, b: pairs.append((a, b)), g_t, numpy_tree(g_j))
    assert len(pairs) == len(jax.tree.leaves(qp_j))
    moved = 0
    for g, w in pairs:
        assert str(g.dtype).split(".")[-1] == np.asarray(w).dtype.name
        gw, ww = g.float().numpy(), np.asarray(w).astype(np.float32)
        if not g.is_floating_point():
            assert not gw.any() and not ww.any()
            continue
        fp8 = g.dtype == torch.float8_e4m3fn
        scale = max(np.abs(ww).max(), 1e-30)
        assert np.abs(gw - ww).max() <= (2 ** -3 if fp8 else TOL) * scale
        moved += bool(np.abs(ww).max() > 0)
    assert moved > 0
    layer = g_t["layers"][0]["wq"]
    assert isinstance(layer, QuantizedTensor) and layer.scales.abs().sum() > 0


def test_quantized_adamw_step_trains_the_scales_only(tiny):
    """One AdamW step on int8 weights: the int8 values stay, the scales
    move; an fp8 tree's scales move and its values stay fp8 (an update of
    lr 1e-3 is mostly below one e4m3 step)."""
    _, cfg_t, params_j = tiny
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
    step = training.make_optax_train_step(cfg_t, opt)
    for dtype in (torch.int8, torch.float8_e4m3fn):
        qp = linear.quantize_transformer_params(params, dtype)
        state, metrics = step(training.init_train_state(qp, opt), _tokens(6))
        before, after = qp["layers"][0]["wq"], state.params["layers"][0]["wq"]
        assert after.values.dtype == dtype and after.scales.dtype == torch.float32
        assert not torch.equal(after.scales, before.scales)
        if dtype == torch.int8:
            assert torch.equal(after.values, before.values)
        assert torch.isfinite(metrics["loss"])


def _assert_same_tree(a, b):
    assert [type(x) for x in transformer.tree_leaves(a)] == [
        type(x) for x in transformer.tree_leaves(b)]
    for x, y in zip(transformer.array_leaves(a), transformer.array_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1 else x,
                           y.view(torch.uint8) if y.element_size() == 1 else y)


def test_checkpoint_roundtrip_with_quantized_and_lora_leaves(tmp_path, tiny):
    """params, the SGD state and the step round trip; QuantizedTensor
    (int4 with its group size, W8A8) and LoRATensor leaves come back field
    by field; `like` restores onto like's dtypes; a save leaves nothing but
    the checkpoint behind and replaces an earlier one in place."""
    _, cfg_t, params_j = tiny
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    opt = transformer.init_opt_state(params)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, opt, step=17)
    state = restore_checkpoint(path, device="cpu")
    assert state["step"] == 17
    _assert_same_tree(state["params"], params)
    _assert_same_tree(state["opt_state"], opt)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"] and os.listdir(path) == ["state.pt"]

    q = linear.quantize_transformer_params(params, "int4")
    q = lora.apply_lora(q, torch.Generator().manual_seed(1), rank=4)
    w8 = linear.quantize_transformer_params(params, torch.int8, act_quant=True)
    save_checkpoint(path, {"lora": q, "w8a8": w8}, step=3)
    state = restore_checkpoint(path, device="cpu")
    assert state["step"] == 3 and "opt_state" not in state
    _assert_same_tree(state["params"], {"lora": q, "w8a8": w8})
    wq = state["params"]["lora"]["layers"][0]["wq"]
    assert isinstance(wq, lora.LoRATensor) and wq.base.group_size == q[
        "layers"][0]["wq"].base.group_size and wq.scale == q["layers"][0]["wq"].scale
    assert state["params"]["w8a8"]["layers"][0]["wq"].act_quant

    like = {"params": {"lora": q, "w8a8": transformer.tree_map(
        lambda t: t if not isinstance(t, torch.Tensor) else t.double(), w8)}, "step": 0}
    onto = restore_checkpoint(path, like=like)
    assert onto["params"]["w8a8"]["embed"].dtype == torch.float64
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_resume_training_continuity(tmp_path, tiny):
    """Two SGD steps; a checkpoint after step 1; resuming from it and taking
    step 2 reproduces the uninterrupted run bit for bit (JAX's
    tests/test_checkpoint.py); likewise the AdamW TrainState that
    train_loop saves, resumed through make_optax_train_step."""
    _, cfg_t, params_j = tiny
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    step_fn = transformer.make_train_step(cfg_t)
    tok = torch.from_numpy(_tokens(7)).long()
    p1, o1, _ = step_fn(params, transformer.init_opt_state(params), tok)
    save_checkpoint(str(tmp_path / "sgd"), p1, o1, step=1)
    p2, o2, loss2 = step_fn(p1, o1, tok)
    state = restore_checkpoint(str(tmp_path / "sgd"), device="cpu")
    p2r, _, loss2r = step_fn(state["params"], state["opt_state"], tok)
    assert float(loss2r) == float(loss2)
    _assert_same_tree(p2r, p2)

    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
    batches = [_tokens(8), _tokens(9)]
    full = training.train_loop(cfg_t, iter(batches), num_steps=2, params=params,
                               optimizer=opt, log_every=0, device="cpu")
    training.train_loop(cfg_t, iter(batches[:1]), num_steps=1, params=params,
                        optimizer=opt, log_every=0, device="cpu",
                        checkpoint_dir=str(tmp_path / "adamw"), checkpoint_every=1)
    saved = restore_checkpoint(str(tmp_path / "adamw"), device="cpu")
    assert saved["step"] == 1 and isinstance(saved["opt_state"], training.AdamWState)
    resumed, _ = training.make_optax_train_step(cfg_t, opt)(
        training.TrainState(saved["params"], saved["opt_state"], saved["step"]), batches[1])
    assert resumed.step == full.step == 2
    _assert_same_tree(resumed.params, full.params)
    _assert_same_tree(resumed.opt_state.mu, full.opt_state.mu)


def test_train_loop_checkpoints_and_save_for_backward(tmp_path):
    """train_loop(checkpoint_dir=, checkpoint_every=3) over 3 steps leaves a
    checkpoint at step 3 (JAX's tests/test_training.py); a non-finite loss
    is refused before it is saved; save_for_backward writes the reference
    CLI's O.bin and logsumexp.bin."""
    _, cfg = _cfgs()
    data = (torch.from_numpy(_tokens(10 + i)).long() for i in range(3))
    state = training.train_loop(cfg, data, num_steps=3, log_every=0, device="cpu",
                                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    assert state.step == 3
    assert restore_checkpoint(str(tmp_path / "ck"), device="cpu")["step"] == 3
    bad = transformer.tree_map(lambda p: p * float("nan"), state.params)
    with pytest.raises(FloatingPointError):
        training.train_loop(cfg, iter([_tokens(1)]), num_steps=1, params=bad, log_every=0,
                            device="cpu", checkpoint_dir=str(tmp_path / "nan"),
                            checkpoint_every=1)
    assert not (tmp_path / "nan").exists()
    o, lse = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8)
    save_for_backward(str(tmp_path / "art"), o, lse)
    got = np.fromfile(tmp_path / "art" / "O.bin", np.float32)
    np.testing.assert_array_equal(got, o.numpy().ravel())
    assert (tmp_path / "art" / "logsumexp.bin").stat().st_size == lse.numel() * 4


def test_restore_checkpoint_defaults_to_the_card(tmp_path):
    """Without `like` or `device` a restore puts the state on the card, as
    train_loop runs there; where no card is present it raises, naming
    device="cpu", rather than restore onto the CPU unasked."""
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.ones(3)}, step=1)
    if torch.cuda.is_available():
        assert restore_checkpoint(str(tmp_path / "ck"))["params"]["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            restore_checkpoint(str(tmp_path / "ck"))
    on_cpu = restore_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert on_cpu["params"]["w"].device.type == "cpu"
