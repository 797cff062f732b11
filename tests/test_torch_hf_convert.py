"""Port parity: utils/hf_convert.py against Hugging Face's own Llama and
against the JAX package's import.  A random tiny LlamaForCausalLM (untied
and tied embeddings) converted by the port gives the logits of HF's
forward and of JAX's load_llama + forward, in fp32 within 2e-4 (the gate
of tests/test_hf_convert.py); the converted tree equals what
params_from_numpy makes of JAX's converted tree, bit for bit; the config
maps field by field; greedy tokens through the port's DecodeEngine equal
HF's generate."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from cuda_flash_attention_tpu.models import forward as jax_forward  # noqa: E402
from cuda_flash_attention_tpu.utils import hf_convert as jax_hf  # noqa: E402
from cuda_flash_attention_tpu_torch.decode import DecodeEngine  # noqa: E402
from cuda_flash_attention_tpu_torch.models import transformer  # noqa: E402
from cuda_flash_attention_tpu_torch.utils import hf_convert  # noqa: E402
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy  # noqa: E402

TOL = 2e-4
FP32 = dict(dtype=torch.float32, attn_tile_dtype=None)
FP32_J = dict(dtype=jnp.float32, attn_tile_dtype=None)


def _tiny_hf(seed, tie):
    torch.manual_seed(seed)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, rope_theta=10000.0, tie_word_embeddings=tie)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def hf(request):
    return _tiny_hf(seed=int(request.param), tie=request.param)


def test_logits_match_hf_and_jax(hf):
    params, cfg = hf_convert.load_llama(hf, **FP32)
    params_j, cfg_j = jax_hf.load_llama(hf, **FP32_J)
    ids = np.random.default_rng(0).integers(0, 256, size=(2, 48))
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.numpy()
        got = transformer.forward(params, torch.as_tensor(ids), cfg).numpy()
    want = np.asarray(jax_forward(params_j, jnp.asarray(ids, jnp.int32), cfg_j))
    assert np.abs(got - ref).max() < TOL
    assert np.abs(got - want).max() < TOL


def test_tree_equals_jax_conversion(hf):
    params, cfg = hf_convert.load_llama(hf, **FP32)
    params_j, _ = jax_hf.load_llama(hf, **FP32_J)
    want = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    pairs = [(params[k], want[k]) for k in ("embed", "final_norm", "lm_head")]
    assert len(params["layers"]) == len(want["layers"]) == 2
    for layer, layer_j in zip(params["layers"], want["layers"]):
        assert layer.keys() == layer_j.keys()
        pairs += [(layer[k], layer_j[k]) for k in layer]
    for got, exp in pairs:
        assert got.dtype == exp.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, exp)
    if hf.config.tie_word_embeddings:
        assert torch.equal(params["lm_head"], params["embed"].t())
    # New tensors: converting leaves the model's own weights untouched.
    params["embed"].zero_()
    assert hf.model.embed_tokens.weight.abs().sum() > 0


def test_state_dict_converts_on_its_own_device_and_dtype(hf):
    cfg = hf_convert.config_from_hf(hf.config, param_dtype=torch.bfloat16)
    sd = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    params = hf_convert.params_from_hf(sd, cfg)
    wq = sd["model.layers.0.self_attn.q_proj.weight"]
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    assert params["layers"][0]["wq"].shape == (128, 256)
    assert torch.equal(params["layers"][0]["wq"], wq.t())
    assert all(t.device == wq.device for t in transformer.tree_leaves(params))


def test_config_mapping_matches_jax():
    hf = _tiny_hf(seed=2, tie=True)
    cfg = hf_convert.config_from_hf(hf.config, **FP32)
    cfg_j = jax_hf.config_from_hf(hf.config, **FP32_J)
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "rope_theta"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta) == (4, 2, 64, 1e4)
    assert cfg.dtype == torch.float32 and cfg.attn_tile_dtype is None
    # A plain namespace with LlamaConfig's names serves too (no head_dim:
    # hidden / heads; no num_key_value_heads: multi-head).
    ns = dataclasses.make_dataclass("Ns", ["vocab_size", "hidden_size",
                                           "num_hidden_layers", "num_attention_heads",
                                           "intermediate_size"])(512, 256, 3, 4, 688)
    c = hf_convert.config_from_hf(ns)
    assert (c.head_dim, c.n_kv_heads, c.rope_theta, c.n_layers) == (64, 4, 10000.0, 3)


def test_greedy_tokens_match_hf_generate():
    hf = _tiny_hf(seed=1, tie=False)
    params, cfg = hf_convert.load_llama(hf, **FP32)
    prompt, steps = [5, 17, 100, 42, 7], 5
    with torch.no_grad():
        want = hf.generate(torch.as_tensor([prompt]), max_new_tokens=steps,
                           do_sample=False, num_beams=1,
                           pad_token_id=0)[0, len(prompt):].tolist()
    eng = DecodeEngine(params, cfg, max_seqs=1, max_seq_len=256, page_size=128,
                       cache_dtype=torch.float32, device="cpu")
    (req,) = eng.run([prompt], max_new_tokens=steps)
    assert req.generated == want
