"""The port's CUDA kernels on the card, held to their plain PyTorch versions
run on the CPU from the same inputs, across every variant the wrappers
accept (tile types, head dims, cache types, page sizes).  Skipped without a
card.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(--noconftest skips the root conftest.py, which configures JAX.)
Tolerances: B1 2e-2 with bf16 tiles and 2e-6 in fp32 (the JAX gates,
tests/test_fa2_forward.py); B5 2e-2 with bf16 compute and 2e-5 in fp32
(tests/test_decode.py); lse 1e-3 relative (1e-5 in fp32).  B2, B3 and B4
within 5e-2 with bf16 tiles (the JAX bf16-tile grad gate,
tests/test_fa2_backward.py) and 2e-5 in fp32, each error relative to the
plain output's own max |value|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.decode import attention as dec_attention
from cuda_flash_attention_tpu_torch.decode import kv_cache
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward, fa2_forward
from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes
from cuda_flash_attention_tpu_torch.models import (
    TransformerConfig,
    init_params,
    init_train_state,
    make_optax_train_step,
    make_optimizer,
)
from cuda_flash_attention_tpu_torch.models.transformer import tree_leaves

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,s,causal", [
    (2, 16, 8, 100, True), (1, 16, 8, 512, True), (2, 4, 4, 256, False),
    (1, 2, 1, 17, True),
])
def test_fa2_forward_kernel_matches_plain(cuda, dtype, tile, d, b, hq, hkv, s,
                                          causal):
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for h in (hq, hkv, hkv))
    before = fa2_forward.launches
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile)
    assert fa2_forward.launches == before + 1
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile)
    assert o_k.dtype == dtype and o_k.shape == q.shape
    bf16 = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if bf16 else 2e-6), err
    assert lse_err <= (1e-3 if bf16 else 1e-5), lse_err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_fa2_forward_kernel_unequal_lengths(cuda, dtype, causal):
    rng = np.random.default_rng(5)
    q = _randn(rng, 1, 4, 64, 64).to(dtype)
    k, v = (_randn(rng, 1, 2, 200, 64).to(dtype) for _ in range(2))
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal)
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-6
    assert (o_k.float().cpu() - o_p.float()).abs().max().item() <= tol
    assert ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item() <= 1e-3


@pytest.mark.parametrize("kwargs", [
    dict(shape=(1, 2, 64, 32), dtype=torch.bfloat16),   # head_dim 32
    dict(shape=(1, 2, 64, 64), dtype=torch.float16),
])
def test_fa2_forward_kernel_refuses_what_it_does_not_take(cuda, kwargs):
    x = torch.zeros(kwargs["shape"], dtype=kwargs["dtype"], device=cuda)
    with pytest.raises(NotImplementedError):
        attention.flash_attention(x, x, x, causal=True)


@pytest.mark.parametrize("cache", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-q-bf16-compute"])
@pytest.mark.parametrize("d,page,hq,hkv", [
    (64, 128, 16, 8), (128, 128, 8, 8), (64, 256, 16, 2),
])
def test_paged_decode_kernel_matches_plain(cuda, cache, q_dtype, compute, d,
                                           page, hq, hkv):
    rng = np.random.default_rng(d + page + hq)
    lengths = torch.tensor([300, 0, 1, page, 777, page + 1], dtype=torch.int32)
    n, pps = len(lengths), -(-777 // page)
    num_pages = n * pps + 1
    table = torch.from_numpy(
        rng.permutation(np.arange(1, num_pages)).astype(np.int32)).reshape(n, pps)
    pages = kv_cache.init_kv_pages(hkv, num_pages, page, d, cache, device="cpu")
    for slot in range(n):
        kv_cache.write_prompt_kv(pages, _randn(rng, pps * page, hkv, d),
                                 _randn(rng, pps * page, hkv, d), table[slot])
    q = _randn(rng, n, hq, d).to(q_dtype)
    pages_dev = kv_cache.KVPages(*(t.to(cuda) for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))
    before = dec_attention.launches
    o_k = dec_attention.paged_decode_attention(
        q.to(cuda), pages_dev, table.to(cuda), lengths.to(cuda),
        compute_dtype=compute)
    assert dec_attention.launches == before + 1
    o_p = dec_attention.paged_decode_attention(q, pages, table, lengths,
                                               compute_dtype=compute)
    assert o_k.dtype == q_dtype and not o_k[1].any()
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


def test_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the tiny model in fp32: DecodeEngine with no device
    (the card, both kernels) against device="cpu" (the plain versions)."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [[5, 7, 11], [2, 3, 200, 17, 9], list(range(40, 170))]
    runs = {}
    for dev in (None, "cpu"):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512, device=dev)
        runs[dev] = [r.generated for r in eng.run(prompts, max_new_tokens=6)]
    assert runs[None] == runs["cpu"]


SPLIT = BlockSizes(128, 128, 128, 128, 128, 128)


def _rel_err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def _bwd_problem(dtype, tile, d, b, hq, hkv, s, causal, seed):
    """Padded inputs as the autograd path builds them, on the CPU: q, k, v,
    dO from numpy, O and lse from the plain forward."""
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, b, hq, s, d).to(dtype) for _ in range(2))
    k, v = (_randn(rng, b, hkv, s, d).to(dtype) for _ in range(2))
    q, k, v, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, tile, None, None, None, 0)
    o, lse = fa2_forward.fa2_forward_plain(q, k, v, causal=causal,
                                           sm_scale=sm_scale, kv_len=kv_len,
                                           tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - s))
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile)
    return dict(q=q, k=k, v=v, o=o, do=do, lse=lse, di=di), kw


BWD_VARIANTS = pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles"])
BWD_SHAPES = pytest.mark.parametrize("b,hq,hkv,s,causal", [
    (2, 16, 8, 100, True), (1, 16, 8, 512, True), (2, 4, 4, 256, False),
    (1, 2, 1, 17, True), (1, 4, 2, 1000, True), (1, 4, 1, 300, False),
])


@BWD_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@BWD_SHAPES
def test_fa2_backward_kernels_match_plain(cuda, dtype, tile, d, b, hq, hkv, s,
                                          causal):
    x, kw = _bwd_problem(dtype, tile, d, b, hq, hkv, s, causal, seed=s + d)
    g = {n: t.to(cuda) for n, t in x.items()}
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    before = (fa2_backward.fused_launches, fa2_backward.dq_launches,
              fa2_backward.dkv_launches)
    fused = fa2_backward.fa2_backward_fused_aligned(
        g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"], **kw)
    dq = fa2_backward.fa2_backward_dq_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **kw)
    dkv = fa2_backward.fa2_backward_dkv_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **kw)
    torch.cuda.synchronize()
    assert (fa2_backward.fused_launches, fa2_backward.dq_launches,
            fa2_backward.dkv_launches) == tuple(n + 1 for n in before)
    plain = fa2_backward.fa2_backward_fused_plain(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], **kw)
    for got, want in zip(fused, plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel_err(got, want) <= tol
    assert _rel_err(dq, plain[0]) <= tol
    assert _rel_err(dkv[0], plain[1]) <= tol
    assert _rel_err(dkv[1], plain[2]) <= tol


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("block_sizes", [None, SPLIT], ids=["fused", "split"])
def test_fa2_backward_bitwise_deterministic(cuda, tile, block_sizes):
    """S 2048: the default blocks take B2, 128-row blocks (16 slices) take
    B3 + B4; two runs give the same bits."""
    rng = np.random.default_rng(7)
    q = _randn(rng, 1, 4, 2048, 64).to(cuda)
    k, v = (_randn(rng, 1, 2, 2048, 64).to(cuda) for _ in range(2))
    w = _randn(rng, 1, 4, 2048, 64).to(cuda)
    launches = (fa2_backward.fused_launches, fa2_backward.dq_launches)
    runs = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = attention.flash_attention(*ts, causal=True, tile_dtype=tile,
                                      block_sizes=block_sizes)
        runs.append(torch.autograd.grad((o * w).sum(), ts))
    fused = block_sizes is None
    assert fa2_backward.fused_launches == launches[0] + (2 if fused else 0)
    assert fa2_backward.dq_launches == launches[1] + (0 if fused else 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tile", [(torch.bfloat16, torch.bfloat16),
                                        (torch.float32, None)])
def test_flash_attention_grads_on_the_card_match_the_cpu(cuda, dtype, tile):
    rng = np.random.default_rng(8)
    xs = [_randn(rng, 2, h, 333, 64).to(dtype) for h in (8, 4, 4)]
    w = _randn(rng, 2, 8, 333, 64)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_(True) for t in xs]
        o = attention.flash_attention(*ts, causal=True, tile_dtype=tile)
        grads[dev.type] = torch.autograd.grad((o.float() * w.to(dev)).sum(), ts)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-5
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert a.dtype == dtype and _rel_err(a, b) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads_unequal_lengths(cuda, dtype, causal):
    rng = np.random.default_rng(11)
    xs = [_randn(rng, 1, 4, 64, 64).to(dtype)] + [
        _randn(rng, 1, 2, 200, 64).to(dtype) for _ in range(2)]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_(True) for t in xs]
        o = attention.flash_attention(*ts, causal=causal)
        grads[dev.type] = torch.autograd.grad(o.float().sum(), ts)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-5
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(a, b) <= tol


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of the tiny model in fp32: loss, grad norm and the
    first Adam moment (linear in the gradients) on the card against the CPU."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    tokens = np.random.default_rng(9).integers(0, 256, (2, 129))
    out = {}
    for dev in ("cuda", "cpu"):
        params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, decay_steps=4)
        out[dev] = make_optax_train_step(cfg, opt)(init_train_state(params, opt),
                                                   tokens)
    (s_g, m_g), (s_c, m_c) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(m_g[key].item() - m_c[key].item()) <= 1e-4 * abs(m_c[key].item())
    for a, b in zip(tree_leaves(s_g.opt_state.mu), tree_leaves(s_c.opt_state.mu)):
        assert _rel_err(a, b) <= 1e-3


def test_remat_full_reruns_the_forward_kernel(cuda):
    cfg = dataclasses.replace(TransformerConfig.tiny(), remat="full")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    opt = make_optimizer()
    tokens = np.random.default_rng(10).integers(0, 256, (2, 129))
    before = fa2_forward.launches
    make_optax_train_step(cfg, opt)(init_train_state(params, opt), tokens)
    assert fa2_forward.launches == before + 2 * cfg.n_layers
