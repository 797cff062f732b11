"""The port's CUDA kernels on the card, held to their plain PyTorch versions
run on the CPU from the same inputs, across every variant the wrappers
accept (tile types, head dims, cache types, page sizes).  Skipped without a
card.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(--noconftest skips the root conftest.py, which configures JAX.)
Tolerances: B1 2e-2 with bf16 tiles and 2e-6 in fp32 (the JAX gates,
tests/test_fa2_forward.py); B5 2e-2 with bf16 compute and 2e-5 in fp32
(tests/test_decode.py); lse 1e-3 relative (1e-5 in fp32).
"""

import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.decode import attention as dec_attention
from cuda_flash_attention_tpu_torch.decode import kv_cache
from cuda_flash_attention_tpu_torch.kernels import attention, fa2_forward
from cuda_flash_attention_tpu_torch.models import TransformerConfig, init_params

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
