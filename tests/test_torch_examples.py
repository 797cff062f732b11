"""The port's examples (cuda_flash_attention_tpu_torch/examples/) on the
CPU with --device cpu, and the QLoRA example's losses against the JAX
example's flow (examples/finetune_lora.py: its widths, int4 base, rank-8
adapters, AdamW lr 1e-3 warmup 1 decay 50, 5 steps on rng(0)'s (4, 65)
tokens) from the same weights and adapters carried across, in fp32 (the
JAX example runs bf16 activations, whose rounding differs between the
packages), within tests/test_torch_lora.py's 1e-5 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu.models import lora as jax_lora
from cuda_flash_attention_tpu.models import training as jax_training
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu.quant import quantize_transformer_params as jax_quantize
from cuda_flash_attention_tpu_torch.examples import finetune_lora, serve
from cuda_flash_attention_tpu_torch.quant.qtensor import QuantizedTensor
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

RTOL = 1e-5


def test_serve_example_runs_on_the_cpu(capsys):
    requests, eng = serve.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(requests) == 4 and "engine stats" in out
    for r in requests:
        assert r.done and 1 <= len(r.generated) <= 24
        assert 1999 not in r.generated  # banned by its logit bias
        assert len(r.logprobs) == len(r.generated) and max(r.logprobs) <= 0
    assert eng.stats["prefill_chunks"] >= 1
    assert eng.allocator.available == eng.num_pages - 1


def test_finetune_example_runs_on_the_cpu(capsys):
    losses, served = finetune_lora.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    wq = served["layers"][0]["wq"]
    assert isinstance(wq, QuantizedTensor) and wq.bits == 4
    assert "merged wq is QuantizedTensor bits=4" in out


def test_finetune_losses_match_the_jax_example():
    widths = {f.name: getattr(finetune_lora.CFG, f.name)
              for f in dataclasses.fields(finetune_lora.CFG)
              if f.name in ("vocab_size", "d_model", "n_layers", "n_heads",
                            "n_kv_heads", "head_dim", "d_ff")}
    cfg_j = jax_tf.TransformerConfig(dtype=jnp.float32, attn_tile_dtype=None, **widths)
    cfg = dataclasses.replace(finetune_lora.CFG, dtype=torch.float32,
                              attn_tile_dtype=None)
    base = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    params_j = jax_lora.apply_lora(jax_quantize(base, "int4"), jax.random.PRNGKey(1),
                                   rank=8)
    opt_j = jax_lora.make_lora_optimizer(jax_training.make_optimizer(
        learning_rate=1e-3, warmup_steps=1, decay_steps=50), params_j)
    state_j = jax_training.init_train_state(params_j, opt_j)
    step_j = jax.jit(jax_training.make_optax_train_step(cfg_j, opt_j))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 65))
    want = []
    for _ in range(5):
        state_j, m = step_j(state_j, jnp.asarray(tokens, jnp.int32))
        want.append(float(m["loss"]))

    params = params_from_numpy(numpy_tree(params_j), "cpu")
    got, served = finetune_lora.finetune(cfg, params, tokens, log=lambda s: None)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert abs(g - w) <= RTOL * abs(w), (got, want)
    assert isinstance(served["layers"][1]["w_down"], QuantizedTensor)
