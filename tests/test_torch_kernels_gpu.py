"""The port's CUDA kernels on the card, held to their plain PyTorch versions
run on the CPU from the same inputs, across every variant the wrappers
accept (tile types, head dims, cache types, page sizes).  Skipped without a
card.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(--noconftest skips the root conftest.py, which configures JAX.)
Tolerances: B1 and B8 2e-2 with bf16 or fp16 tiles and 2e-6 in fp32 (the
JAX gates, tests/test_fa2_forward.py); B5 and B6 2e-2 with bf16 compute and
2e-5 in fp32 (tests/test_decode.py); lse 1e-3 relative (1e-5 in fp32).  B2,
B3 and B4 within 5e-2 with bf16 or fp16 tiles (the JAX bf16-tile grad gate,
tests/test_fa2_backward.py) and 2e-5 in fp32, each error relative to the
plain output's own max |value|.  B9 and B10 within 1e-5 (FA1 re-rounds O to
fp32 at every KV tile).  On fp16 inputs (B1-B8) and bf16 or fp16 inputs
(B9, B10) the outputs come out in the inputs' type: the same gates plus one
step of that type at the output's max; the autotune's tile variants of B1
and B2 are held to the shipped tiles' outputs at the bf16 gates.
"""

import dataclasses
import functools
import gc

import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu_torch.decode import DecodeEngine
from cuda_flash_attention_tpu_torch.decode import attention as dec_attention
from cuda_flash_attention_tpu_torch.decode import kv_cache
from cuda_flash_attention_tpu_torch import cli
from cuda_flash_attention_tpu_torch.bench import Harness, TestConfig
from cuda_flash_attention_tpu_torch.dispatch import run_flash_attention
from cuda_flash_attention_tpu_torch.kernels import (
    attention,
    baselines,
    fa2_backward,
    fa2_forward,
)
from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES
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


FWD_VARIANTS = pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.float16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles", "fp32-in-fp16-tiles",
        "bf16-in-fp16-tiles"])


@FWD_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,s,causal", [
    (2, 16, 8, 100, True), (1, 16, 8, 512, True), (2, 4, 4, 256, False),
    (1, 2, 1, 17, True),
    # B1's K/V ring (2-3 stages of 128 rows) wraps 8 and 16 times; S 16
    # and 112 are shorter than one 128-row TMA box; S 1000 pads to 1024,
    # so kv_len ends inside the last box; GQA 16/2.
    (1, 4, 2, 2048, True), (1, 2, 1, 4096, False), (2, 4, 2, 16, True),
    (2, 4, 2, 112, False), (1, 4, 2, 1000, False), (1, 16, 2, 384, True),
])
def test_fa2_forward_kernel_matches_plain(cuda, dtype, tile, d, b, hq, hkv, s,
                                          causal):
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for h in (hq, hkv, hkv))
    before = LAUNCHES["fa2_forward"]
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile)
    assert LAUNCHES["fa2_forward"] == before + 1
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile)
    assert o_k.dtype == dtype and o_k.shape == q.shape
    bf16 = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if bf16 else 2e-6), err
    assert lse_err <= (1e-3 if bf16 else 1e-5), lse_err


@FWD_VARIANTS
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 200), (300, 100), (128, 384)])
def test_fa2_forward_kernel_unequal_lengths(cuda, dtype, tile, causal, sq, skv):
    """Sq != Skv: causal keeps col <= row from the top-left corner; at
    300/100 Q rows run past kv_len, at 128/384 one Q tile meets three KV
    tiles, and each padded tail ends inside a 128-row box."""
    rng = np.random.default_rng(5 + sq)
    q = _randn(rng, 1, 4, sq, 64).to(dtype)
    k, v = (_randn(rng, 1, 2, skv, 64).to(dtype) for _ in range(2))
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile)
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile)
    tol = 2e-2 if tile is not None or dtype == torch.bfloat16 else 2e-6
    assert (o_k.float().cpu() - o_p.float()).abs().max().item() <= tol
    assert ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item() <= 1e-3


@FWD_VARIANTS
def test_fa2_forward_kernel_bitwise_deterministic(cuda, dtype, tile):
    """No atomics and a fixed order of every sum: two calls give the same
    bits, at a shape that wraps the K/V ring many times."""
    rng = np.random.default_rng(11)
    q = _randn(rng, 2, 16, 2048, 128).to(dtype).to(cuda)
    k, v = (_randn(rng, 2, 8, 2048, 128).to(dtype).to(cuda) for _ in range(2))
    o1, lse1 = attention.flash_attention_with_lse(q, k, v, causal=True,
                                                  tile_dtype=tile)
    o2, lse2 = attention.flash_attention_with_lse(q, k, v, causal=True,
                                                  tile_dtype=tile)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("kwargs", [
    dict(shape=(1, 2, 64, 96), dtype=torch.bfloat16),   # head_dim 96 (no kernel)
    dict(shape=(1, 2, 64, 64), dtype=torch.float64),    # fp16 inputs run
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
    before = LAUNCHES["paged_decode"]
    o_k = dec_attention.paged_decode_attention(
        q.to(cuda), pages_dev, table.to(cuda), lengths.to(cuda),
        compute_dtype=compute)
    assert LAUNCHES["paged_decode"] == before + 1
    o_p = dec_attention.paged_decode_attention(q, pages, table, lengths,
                                               compute_dtype=compute)
    assert o_k.dtype == q_dtype and not o_k[1].any()
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("cache", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-q-bf16-compute"])
@pytest.mark.parametrize("d,hq,hkv,page", [(64, 16, 8, 128), (128, 8, 8, 128),
                                           (64, 16, 2, 256)])
@pytest.mark.parametrize("chunk", [1, 5, 512])
def test_paged_chunk_kernel_matches_plain(cuda, cache, q_dtype, compute, d, hq,
                                          hkv, page, chunk):
    """Slot 0's chunk starts at 126 (a page boundary inside the chunk at
    128-token pages), slot 1 is inactive (exact zeros), the others long and
    ragged.  The plain version runs on the same card tensors."""
    rng = np.random.default_rng(d + hq + chunk)
    lengths = torch.tensor([126 + chunk, 0, 300 + chunk, 1000 + chunk],
                           dtype=torch.int32)
    n, pps = len(lengths), -(-(1000 + chunk) // page)
    num_pages = n * pps + 1
    table = torch.from_numpy(
        rng.permutation(np.arange(1, num_pages)).astype(np.int32)).reshape(n, pps)
    pages = kv_cache.init_kv_pages(hkv, num_pages, page, d, cache, device="cpu")
    for slot in range(n):
        kv_cache.write_prompt_kv(pages, _randn(rng, pps * page, hkv, d),
                                 _randn(rng, pps * page, hkv, d), table[slot])
    pages = kv_cache.KVPages(*(t.to(cuda) for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))
    q = _randn(rng, n, chunk, hq, d).to(q_dtype).to(cuda)
    table, lengths = table.to(cuda), lengths.to(cuda)
    before = LAUNCHES["paged_chunk"]
    o_k = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                              compute_dtype=compute)
    assert LAUNCHES["paged_chunk"] == before + 1
    o_p = dec_attention.paged_chunk_attention_plain(
        q, pages, table, lengths, sm_scale=d ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert o_k.dtype == q_dtype and o_k.shape == q.shape
    assert not o_k[1].any() and torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("cache", [torch.int8, torch.float32])
def test_paged_chunk_of_one_equals_paged_decode(cuda, cache):
    """T = 1: B6 and B5 compute the same function on the same inputs."""
    rng = np.random.default_rng(3)
    lengths = torch.tensor([1, 0, 129, 777], dtype=torch.int32, device=cuda)
    pages = kv_cache.init_kv_pages(8, 4 * 7 + 1, 128, 64, cache, device="cpu")
    table = torch.arange(1, 29, dtype=torch.int32).reshape(4, 7)
    for slot in range(4):
        kv_cache.write_prompt_kv(pages, _randn(rng, 7 * 128, 8, 64),
                                 _randn(rng, 7 * 128, 8, 64), table[slot])
    pages = kv_cache.KVPages(*(t.to(cuda) for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))
    table = table.to(cuda)
    q = _randn(rng, 4, 16, 64).to(cuda)
    for compute, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        one = dec_attention.paged_chunk_attention(
            q[:, None], pages, table, lengths, compute_dtype=compute)[:, 0]
        dec = dec_attention.paged_decode_attention(q, pages, table, lengths,
                                                   compute_dtype=compute)
        assert (one - dec).abs().max().item() <= tol


def test_paged_chunk_kernel_refuses_windows(cuda):
    """Refused until sliding windows were ported: the kernel now launches
    with a window (and counts a windowed launch) and matches its plain
    version."""
    rng = np.random.default_rng(9)
    pages = kv_cache.init_kv_pages(2, 3, 128, 64, device="cpu")
    kv_cache.write_prompt_kv(pages, _randn(rng, 256, 2, 64), _randn(rng, 256, 2, 64),
                             torch.tensor([1, 2], dtype=torch.int32))
    q = _randn(rng, 1, 2, 4, 64)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    lengths = torch.full((1,), 200, dtype=torch.int32)
    kw = dict(window=64, sinks=4, compute_dtype=torch.float32)
    before = LAUNCHES["paged_chunk_window"]
    got = dec_attention.paged_chunk_attention(
        q.to(cuda), kv_cache.KVPages(*(t.to(cuda) for t in (
            pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales))),
        table.to(cuda), lengths.to(cuda), **kw)
    assert LAUNCHES["paged_chunk_window"] == before + 1
    want = dec_attention.paged_chunk_attention(q, pages, table, lengths, **kw)
    assert (got.cpu() - want).abs().max().item() <= 2e-5


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


@pytest.mark.parametrize("feature", ["draft", "prompt_lookup", "prefix",
                                     "chunked"])
def test_engine_features_on_the_card_match_the_cpu(cuda, feature):
    """Speculation (a one-layer draft; prompt lookup), prefix caching and
    chunked prefill of the tiny model in fp32: greedy tokens on the card
    (B1, B5, B6) equal those of device="cpu" (the plain versions) and of
    the card's own engine without the feature."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    draft_cfg = dataclasses.replace(cfg, n_layers=1)
    draft = dict(params, layers=params["layers"][:1])
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, 256, 256).tolist()
    prompts = [prefix + [1, 2, 3], prefix + [4, 5], rng.integers(0, 256, 300).tolist()]
    kw = {"draft": dict(spec_tokens=3, draft_params=draft, draft_cfg=draft_cfg),
          "prompt_lookup": dict(spec_tokens=3, spec_mode="prompt_lookup"),
          "prefix": dict(prefix_cache=True),
          "chunked": dict(prefill_chunk=128)}[feature]
    runs = {}
    for dev, opts in ((None, kw), ("cpu", kw), (None, {})):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512,
                           cache_dtype=torch.float32, device=dev, **opts)
        before = LAUNCHES["paged_chunk"]
        # One request first: the prefix cache holds its pages while it runs.
        first = eng.submit(prompts[0], max_new_tokens=6)
        eng.step()
        rest = eng.run(prompts[1:], max_new_tokens=6)
        runs[(dev, bool(opts))] = [r.generated for r in [first] + rest]
        if dev is None and opts:
            assert LAUNCHES["paged_chunk"] > before
        assert eng.allocator.available == eng.num_pages - 1
    assert runs[(None, True)] == runs[("cpu", True)] == runs[(None, False)]


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
    (torch.float32, torch.bfloat16), (torch.float32, torch.float16),
    (torch.bfloat16, torch.float16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles", "fp32-in-fp16-tiles",
        "bf16-in-fp16-tiles"])
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
    before = (LAUNCHES["fa2_backward_fused"], LAUNCHES["fa2_backward_dq"],
              LAUNCHES["fa2_backward_dkv"])
    fused = fa2_backward.fa2_backward_fused_aligned(
        g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"], **kw)
    dq = fa2_backward.fa2_backward_dq_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **kw)
    dkv = fa2_backward.fa2_backward_dkv_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["fa2_backward_fused"], LAUNCHES["fa2_backward_dq"],
            LAUNCHES["fa2_backward_dkv"]) == tuple(n + 1 for n in before)
    plain = fa2_backward.fa2_backward_fused_plain(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], **kw)
    for got, want in zip(fused, plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _rel_err(got, want) <= tol
    assert _rel_err(dq, plain[0]) <= tol
    assert _rel_err(dkv[0], plain[1]) <= tol
    assert _rel_err(dkv[1], plain[2]) <= tol


def _fused_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal, seed):
    """Padded inputs on the card: q, k, v, dO from numpy, O and lse from
    the plain forward; Sq and Skv may differ."""
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, b, hq, sq, d).to(dtype) for _ in range(2))
    k, v = (_randn(rng, b, hkv, skv, d).to(dtype) for _ in range(2))
    q, k, v, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, tile, None, None, None, 0)
    q, k, v = (t.cuda() for t in (q, k, v))
    o, lse = fa2_forward.fa2_forward_plain(q, k, v, causal=causal,
                                           sm_scale=sm_scale, kv_len=kv_len,
                                           tile_dtype=tile)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - sq)).cuda()
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile)
    return (q, k, v, o.to(dtype), do, lse), kw


@BWD_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal", [
    # B2's Q_s/dO ring (two stages) wraps 8 to 64 times; GQA 16/2; Sq > Skv
    # and Sq < Skv; S 1000 pads to 1024, so kv_len ends inside the last
    # 128-row KV tile.
    (1, 4, 2, 2048, 2048, True), (1, 2, 1, 4096, 4096, False),
    (1, 16, 2, 384, 384, True), (1, 4, 2, 300, 100, True),
    (1, 4, 2, 128, 384, True), (1, 4, 2, 128, 384, False),
    (1, 4, 2, 1000, 1000, False),
])
def test_fa2_backward_fused_kernel_at_long_and_unequal_lengths(
        cuda, dtype, tile, d, b, hq, hkv, sq, skv, causal):
    x, kw = _fused_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal,
                           seed=sq + skv + d)
    before = LAUNCHES["fa2_backward_fused"]
    got = fa2_backward.fa2_backward_fused_aligned(*x, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fa2_backward_fused"] == before + 1
    want = fa2_backward.fa2_backward_fused_plain(*x, **kw)
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel_err(g, w) <= tol


@BWD_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
def test_fa2_backward_fused_kernel_bitwise_deterministic(cuda, dtype, tile, d):
    """Two calls of B2 on the same inputs give the same bits: each dQ slice
    has one writer and the reduce adds them in KV-tile order."""
    x, kw = _fused_problem(dtype, tile, d, 1, 8, 2, 2048, 2048, True, seed=d)
    first = fa2_backward.fa2_backward_fused_aligned(*x, **kw)
    second = fa2_backward.fa2_backward_fused_aligned(*x, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float16),
    (torch.float32, None)], ids=["bf16", "fp32-in-fp16-tiles", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
def test_fa2_backward_fused_reads_no_dead_slice(cuda, dtype, tile, d):
    """dq_part is allocated with torch.empty and only its live slices are
    written.  A NaN-filled tensor of its size is freed just before the
    call, so dq_part takes that memory; a dead slice that the reduce read
    would show as NaN.  Causal with kv_len inside the last KV tile: slices
    above the diagonal are dead."""
    x, kw = _fused_problem(dtype, tile, d, 1, 4, 2, 1000, 1000, True, seed=5)
    q, k = x[0], x[1]
    n_slices = -(-k.shape[2] // fa2_backward.fused_kv_tile(q.dtype, tile))
    bait = torch.full((q.shape[0], q.shape[1], n_slices) + q.shape[2:],
                      float("nan"), device=cuda)
    del bait
    got = fa2_backward.fa2_backward_fused_aligned(*x, **kw)
    torch.cuda.synchronize()
    want = fa2_backward.fa2_backward_fused_plain(*x, **kw)
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= tol


def _split_problem(dtype, tile, d, hq, hkv, sq, skv, causal, kv_len=None,
                   seed=0):
    """Padded inputs of B3 and B4 on the card, O, lse and D_i = rowsum(dO *
    O) from the plain forward.  With kv_len given, q, k, v and dO are taken
    at the padded lengths sq and skv as they are (keys at or past kv_len
    masked); else padded as the API pads."""
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, 1, hq, sq, d).to(dtype) for _ in range(2))
    k, v = (_randn(rng, 1, hkv, skv, d).to(dtype) for _ in range(2))
    sm_scale = d ** -0.5
    if kv_len is None:
        q, k, v, sm_scale, _, kv_len = attention._prepare(
            q, k, v, causal, None, tile, None, None, None, 0)
        do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - sq))
    q, k, v, do = (t.cuda() for t in (q, k, v, do))
    o, lse = fa2_forward.fa2_forward_plain(q, k, v, causal=causal,
                                           sm_scale=sm_scale, kv_len=kv_len,
                                           tile_dtype=tile)
    di = (o.float() * do.float()).sum(-1)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile)
    return (q, k, v, do, lse, di), kw


def _split_outputs(x, kw):
    """(dQ, dK, dV) of B3 then B4 on the card."""
    dq = fa2_backward.fa2_backward_dq_aligned(*x, **kw)
    return (dq, *fa2_backward.fa2_backward_dkv_aligned(*x, **kw))


# fp16 tiles on fp32 inputs against their plain version, relative to its
# max |value| (chip_smoke.py FP16_REL_TOL["bwd"]); the bf16 instantiation on
# the same inputs must fail it.  bf16 outputs round past that gate, so bf16
# inputs keep the bf16 gate with fp16 tiles too.
FP16_BWD_TOL = 1e-3
SPLIT_VARIANTS = pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float16), (torch.bfloat16, torch.float16),
], ids=["bf16", "fp32-in-bf16-tiles", "fp32-in-fp16-tiles", "bf16-in-fp16-tiles"])


@SPLIT_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv,sq,skv,kv_len,causal", [
    # Sq != Skv both ways, causal and not (the API's padding).
    (4, 2, 300, 100, None, True), (4, 2, 300, 100, None, False),
    (4, 2, 128, 384, None, True), (4, 2, 128, 384, None, False),
    # One partial tile each way; S 112 is one 128-row tile short of rows.
    (4, 2, 16, 16, None, True), (4, 2, 112, 112, None, True),
    # kv_len inside the last KV tile (S 1000 pads to 1008).
    (4, 2, 1000, 1000, None, False),
    # KV rows [256, 384) wholly past kv_len 200: B4's block there walks
    # nothing and stores zeros; B3's walk stops before it.
    (4, 2, 256, 384, 200, True), (4, 2, 256, 384, 200, False),
    # GQA 16/2: B4 sums eight query heads per KV head.
    (16, 2, 384, 384, None, True),
])
def test_split_kernels_at_the_edges_of_their_tiles(cuda, dtype, tile, d, hq, hkv,
                                                   sq, skv, kv_len, causal):
    """B3 and B4 with bf16 or fp16 tiles against their plain versions (run
    on the same card tensors), at the edges of B3's 128-row Q tiles and
    128- or 64-row KV tiles and of B4's 128-row KV tiles and Q walk."""
    x, kw = _split_problem(dtype, tile, d, hq, hkv, sq, skv, causal, kv_len,
                           seed=sq + skv + d)
    before = (LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"])
    got = _split_outputs(x, kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"]) == (
        before[0] + 1, before[1] + 1)
    want = (fa2_backward.fa2_backward_dq_plain(*x, **kw),
            *fa2_backward.fa2_backward_dkv_plain(*x, **kw))
    fp16_gate = tile == torch.float16 and dtype == torch.float32
    tol = FP16_BWD_TOL if fp16_gate else 5e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= tol
    if fp16_gate:
        control = _split_outputs(x, dict(kw, tile_dtype=torch.bfloat16))
        assert max(_rel_err(c, w) for c, w in zip(control, want)) > tol
    if kv_len is not None:  # dK and dV of keys past kv_len are zeros
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@SPLIT_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
def test_split_kernels_bitwise_deterministic(cuda, dtype, tile, d):
    """Two calls of B3 and of B4 on the same inputs give the same bits: no
    block adds into another's output."""
    x, kw = _split_problem(dtype, tile, d, 8, 2, 2048, 2048, True, seed=d)
    first, second = _split_outputs(x, kw), _split_outputs(x, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv,sq,skv,kv_len,causal", [
    # B3's K/V rings and B4's Q_s/dO stage wrap 32 to 128 times.
    (4, 2, 2048, 2048, None, True), (2, 1, 4096, 4096, None, False),
    # Sq != Skv both ways, causal and not (the API's padding).
    (4, 2, 300, 100, None, True), (4, 2, 128, 384, None, True),
    (4, 2, 128, 384, None, False),
    # kv_len inside the last 64-row tile (S 1000 pads to 1008).
    (4, 2, 1000, 1000, None, False),
    # KV rows [256, 384) wholly past kv_len 200: B4's blocks there walk
    # nothing and store zeros, without waiting on a barrier.
    (4, 2, 256, 384, 200, True), (4, 2, 256, 384, 200, False),
    # GQA 16/2: B4 walks eight query heads per KV head.
    (16, 2, 384, 384, None, True),
    # One partial tile; S 112 ends inside the second 64-row tile.
    (4, 2, 16, 16, None, True), (4, 2, 112, 112, None, True),
])
def test_split_kernels_fp32_at_the_edges_of_their_rings(cuda, d, hq, hkv, sq, skv,
                                                        kv_len, causal):
    """B3's and B4's fp32 bodies (64-row tiles on the FMA units) against
    their plain versions (run on the same card tensors) at 2e-5 of the
    plain output's max, where their rings wrap and their walks end."""
    x, kw = _split_problem(torch.float32, None, d, hq, hkv, sq, skv, causal,
                           kv_len, seed=sq + skv + d)
    before = (LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"])
    got = _split_outputs(x, kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["fa2_backward_dq"], LAUNCHES["fa2_backward_dkv"]) == (
        before[0] + 1, before[1] + 1)
    want = (fa2_backward.fa2_backward_dq_plain(*x, **kw),
            *fa2_backward.fa2_backward_dkv_plain(*x, **kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        assert _rel_err(g, w) <= 2e-5
    if kv_len is not None:  # dK and dV of keys past kv_len are zeros
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("d", [64, 128])
def test_split_kernels_fp32_bitwise_deterministic(cuda, d):
    """Two calls of B3's and B4's fp32 bodies on the same inputs give the
    same bits: every sum runs in one order and no block adds into
    another's output."""
    x, kw = _split_problem(torch.float32, None, d, 8, 2, 2048, 2048, True, seed=d)
    first, second = _split_outputs(x, kw), _split_outputs(x, kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp32", "bf16-tiles"])
@pytest.mark.parametrize("block_sizes", [None, SPLIT], ids=["fused", "split"])
def test_fa2_backward_bitwise_deterministic(cuda, tile, block_sizes):
    """S 2048: the default blocks take B2, 128-row blocks (16 slices) take
    B3 + B4; two runs give the same bits."""
    rng = np.random.default_rng(7)
    q = _randn(rng, 1, 4, 2048, 64).to(cuda)
    k, v = (_randn(rng, 1, 2, 2048, 64).to(cuda) for _ in range(2))
    w = _randn(rng, 1, 4, 2048, 64).to(cuda)
    launches = (LAUNCHES["fa2_backward_fused"], LAUNCHES["fa2_backward_dq"])
    runs = []
    for _ in range(2):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = attention.flash_attention(*ts, causal=True, tile_dtype=tile,
                                      block_sizes=block_sizes)
        runs.append(torch.autograd.grad((o * w).sum(), ts))
    fused = block_sizes is None
    assert LAUNCHES["fa2_backward_fused"] == launches[0] + (2 if fused else 0)
    assert LAUNCHES["fa2_backward_dq"] == launches[1] + (0 if fused else 2)
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
    before = LAUNCHES["fa2_forward"]
    make_optax_train_step(cfg, opt)(init_train_state(params, opt), tokens)
    assert LAUNCHES["fa2_forward"] == before + 2 * cfg.n_layers


@FWD_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,s,causal", [
    (1, 1, 128, True), (8, 16, 100, False), (8, 16, 32, True), (2, 3, 17, False),
    (1, 2, 128, False),
])
def test_fa2_forward_small_kernel_matches_plain(cuda, dtype, tile, d, b, h, s,
                                                causal):
    """B8 through the public API: Sq = Skv <= 128 with Hq = Hkv."""
    rng = np.random.default_rng(s + d + 1)
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for _ in range(3))
    before = (LAUNCHES["fa2_forward"], LAUNCHES["fa2_forward_small"])
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile)
    assert (LAUNCHES["fa2_forward"], LAUNCHES["fa2_forward_small"]) == (
        before[0], before[1] + 1)
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile)
    assert o_k.dtype == dtype and o_k.shape == q.shape
    low = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if low else 2e-6), err
    assert lse_err <= (1e-3 if low else 1e-5), lse_err


def test_small_shape_gradients_match_the_cpu(cuda):
    """Autograd over a B8 forward (S 100, Hq = Hkv) and the B2 backward."""
    rng = np.random.default_rng(12)
    xs = [_randn(rng, 2, 4, 100, 64) for _ in range(3)]
    w = _randn(rng, 2, 4, 100, 64)
    grads = {}
    before = LAUNCHES["fa2_forward_small"]
    for dev in (cuda, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_(True) for t in xs]
        o = attention.flash_attention(*ts, causal=True)
        grads[dev.type] = torch.autograd.grad((o * w.to(dev)).sum(), ts)
    assert LAUNCHES["fa2_forward_small"] == before + 1
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(a, b) <= 2e-5


@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,s", [(1, 2, 100), (2, 4, 256), (1, 1, 1000),
                                   (1, 3, 64)])
def test_baseline_kernels_match_plain(cuda, which, d, b, h, s):
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, b, h, s, d) for _ in range(3))
    fn = getattr(baselines, f"{which}_attention")
    before = LAUNCHES[which]
    o_k = fn(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert LAUNCHES[which] == before + 1
    o_p = fn(q, k, v)
    assert o_k.shape == q.shape and o_k.dtype == torch.float32
    assert (o_k.cpu() - o_p).abs().max().item() <= 1e-5


@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
@pytest.mark.parametrize("b,h,sq,skv,kv_len,d", [
    (1, 2, 2048, 2048, 2048, 64), (1, 2, 2048, 2048, 2000, 128),
    (1, 2, 304, 128, 100, 64), (1, 2, 128, 384, 384, 128),
    (17, 8, 128, 192, 150, 64),  # B * H = 136 blocks, more than 132 SMs
])
def test_baseline_kernels_at_long_and_unequal_lengths(cuda, which, b, h, sq,
                                                      skv, kv_len, d):
    """B9 and B10 against their plain versions on the card, through the
    aligned entry points: S 2048, Sq != Skv, kv_len < Skv."""
    rng = np.random.default_rng(sq + skv + d)
    q = _randn(rng, b, h, sq, d).to(cuda)
    k, v = (_randn(rng, b, h, skv, d).to(cuda) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, kv_len=kv_len)
    before = LAUNCHES[which]
    o_k = getattr(baselines, f"{which}_aligned")(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[which] == before + 1
    o_p = getattr(baselines, f"{which}_plain")(q, k, v, **kw)
    assert (o_k - o_p).abs().max().item() <= 1e-5


# The fp32 FMA block of B10 and B1's fp32 body (csrc/fma_block.cuh): a
# block of 128 threads owning a 64-row Q tile, 64-row K and V stages in two
# rings (two K stages and one V stage at D 64, one of each at D 128), P
# written over the K stage just read.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,skv,kv_len", [
    (64, 64, 64),      # one KV tile: the second K stage is never filled
    (65, 65, 65),      # a second tile of one row; K/V rows past skv are zeros
    (192, 192, 192),   # three tiles: the two-stage K ring wraps mid-loop
    (4096, 4096, 4096),  # 64 KV tiles: the rings wrap many times
    (300, 320, 301),   # kv_len inside the last KV tile, Sq != Skv
], ids=str)
def test_naive_fa2_kernel_at_the_block_edges(cuda, d, sq, skv, kv_len):
    rng = np.random.default_rng(sq + skv + d + kv_len)
    q = _randn(rng, 2, 3, sq, d).to(cuda)
    k, v = (_randn(rng, 2, 3, skv, d).to(cuda) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, kv_len=kv_len)
    before = LAUNCHES["naive_fa2"]
    o_k = baselines.naive_fa2_aligned(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["naive_fa2"] == before + 1
    o_p = baselines.naive_fa2_plain(q, k, v, **kw)
    assert (o_k - o_p).abs().max().item() <= 1e-5


@pytest.mark.parametrize("d", [64, 128])
def test_naive_fa2_kernel_bitwise_deterministic(cuda, d):
    """Every sum in a fixed order: two calls give the same bits."""
    rng = np.random.default_rng(d)
    q, k, v = (_randn(rng, 2, 4, 2048, d).to(cuda) for _ in range(3))
    o1, o2 = (baselines.naive_fa2_aligned(q, k, v, sm_scale=d ** -0.5,
                                          kv_len=2000) for _ in range(2))
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal", [
    # GQA groups of 2, 8 and 3 heads and Hq = Hkv at S 2048 and 512: causal
    # trip counts from 1 to 32 KV tiles, the diagonal tile masked.
    (1, 16, 8, 2048, 2048, True), (1, 16, 2, 2048, 2048, True),
    (2, 4, 4, 2048, 2048, True), (1, 6, 2, 512, 512, True),
    # Sq != Skv: Q rows past kv_len; one Q tile meeting six KV tiles.
    (1, 4, 4, 300, 100, True), (1, 4, 4, 300, 100, False),
    (1, 4, 2, 128, 384, True), (1, 4, 4, 128, 384, False),
    # One KV tile (S 16, S 64: the second K stage is never filled) or three
    # (S 192).
    (2, 4, 4, 16, 16, True), (2, 4, 4, 64, 64, False), (1, 2, 2, 192, 192, True),
], ids=str)
def test_fa2_forward_fp32_kernel_at_the_block_edges(cuda, d, b, hq, hkv, sq,
                                                    skv, causal):
    """B1's fp32 body (tile code 0) through fa2_forward_aligned, against its
    plain version on the card: 2e-6 on O, 1e-5 relative on lse."""
    rng = np.random.default_rng(sq + skv + hkv + d)
    q = _randn(rng, b, hq, sq, d).to(cuda)
    k, v = (_randn(rng, b, hkv, skv, d).to(cuda) for _ in range(2))
    kw = dict(causal=causal, sm_scale=d ** -0.5, kv_len=skv, tile_dtype=None)
    before = LAUNCHES["fa2_forward"]
    o_k, lse_k = fa2_forward.fa2_forward_aligned(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fa2_forward"] == before + 1
    o_p, lse_p = fa2_forward.fa2_forward_plain(q, k, v, **kw)
    assert (o_k - o_p).abs().max().item() <= 2e-6
    assert ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item() <= 1e-5


@pytest.mark.parametrize("method,mode,precision", [
    ("fa2", m, p) for m in ("forward", "backward", "forward_backward")
    for p in ("fp32", "fp16", "bf16")
] + [(m, "forward", "fp32") for m in ("fa1", "fa2-naive", "naive")])
@pytest.mark.parametrize("s", [100, 256])
def test_registry_on_the_card_matches_the_cpu(cuda, method, mode, precision, s):
    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 2, 4, s, 64) for _ in range(3))
    o, lse = attention.flash_attention_with_lse(q, k, v)
    kw = dict(o=o, lse=lse) if mode == "backward" else {}
    out = {dev.type: run_flash_attention(
        method, mode, precision, q.to(dev), k.to(dev), v.to(dev),
        **{n: t.to(dev) for n, t in kw.items()})
        for dev in (cuda, torch.device("cpu"))}
    tol = {"fp32": 2e-5, "fp16": 5e-2, "bf16": 5e-2}[precision]
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if want is None:
            assert got is None
        else:
            assert _rel_err(got, want) <= tol, name


def test_cli_on_the_card_writes_what_the_cpu_writes(cuda, tmp_path):
    dirs = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev / "B2_H4_S100_D64"
        d.mkdir(parents=True)
        rng = np.random.default_rng(13)
        for n in "QKV":
            rng.random((2, 4, 100, 64), dtype=np.float32).tofile(d / f"{n}.bin")
        assert cli.main(["fa2", "forward_backward", "fp32", str(d),
                         "--device", dev]) == 0
        dirs[dev] = d
    for name in ("O.bin", "logsumexp.bin", "dQ.bin", "dK.bin", "dV.bin"):
        a = np.fromfile(dirs["cuda"] / name, dtype="<f4")
        b = np.fromfile(dirs["cpu"] / name, dtype="<f4")
        assert np.abs(a - b).max() <= 1e-3 * max(1.0, np.abs(b).max()), name


def test_harness_on_the_card_passes_and_times(cuda):
    cfgs = [TestConfig("Edge", 2, 4, 100, 64, kernel_type=k)
            for k in ("fa2", "fa1", "fa2-naive", "vanilla-attn")]
    cfgs += [TestConfig("Small", 1, 2, 256, 64, test_mode=m)
             for m in ("backward", "both")]
    results = Harness(iters=2, device="cuda", verbose=False).run(cfgs)
    assert [r.passed for r in results] == [True] * len(cfgs)
    assert all(r.kernel_time_ms > 0 for r in results)


# ---------------------------------------------------------------------------
# The quantized path: B7, B5 and B6 on fp8 and int4 pages, X.  B7 and X with
# bf16 compute hold O element by element to one bf16 step of the value plus
# BF16_ATOL near zero (chip_smoke.py's gate); B7 in fp32 2e-5; B5 and B6 as
# above.  lse: B7 1e-3 relative in bf16 and 1e-5 in fp32; X 2e-4 (v3 8e-3,
# one bf16 step of its bf16 l) and 1e-4 on the mean over rows.
# ---------------------------------------------------------------------------

BF16_RTOL = 2.0 ** -7
BF16_ATOL = {"B7": 4e-3, "X": 5e-4}


def _bf16_excess(o_k, o_p) -> float:
    o_k, o_p = o_k.float(), o_p.float()
    return ((o_k - o_p).abs() - BF16_RTOL * o_p.abs()).clamp_min(0).max().item()


QUANT_STORAGE = [torch.int8, torch.float8_e4m3fn, torch.float8_e5m2, "int4"]
NEW_CACHES = [torch.float8_e4m3fn, torch.float8_e5m2, "int4"]


@pytest.mark.parametrize("storage", QUANT_STORAGE, ids=str)
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-q-bf16-compute"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
# S 129 and 1000 end inside the bf16 body's 128-row Q and KV tiles (the API
# pads to 1024: kv_len inside the last tile); S 128 is one tile of it and S
# 64 half of one (one tile of keys for the fp32 body's 64-row tiles).
@pytest.mark.parametrize("b,hq,hkv,s", [(1, 4, 2, 200), (2, 8, 8, 384), (1, 4, 2, 129),
                                        (1, 16, 8, 1000), (2, 4, 2, 128), (1, 2, 1, 64)])
def test_fa2_forward_quant_kernel_matches_plain(cuda, storage, q_dtype, compute,
                                                causal, d, b, hq, hkv, s):
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
    from cuda_flash_attention_tpu_torch.quant import quantize_kv

    rng = np.random.default_rng(d + s + hq)
    q = _randn(rng, b, hq, s, d).to(q_dtype).to(cuda)
    k_q, v_q = quantize_kv(_randn(rng, b, hkv, s, d).to(cuda),
                           _randn(rng, b, hkv, s, d).to(cuda), storage)
    kw = dict(causal=causal, compute_dtype=compute)
    before = LAUNCHES["fa2_forward_quant"]
    o_k, lse_k = fq.flash_attention_quantized_kv_with_lse(q, k_q, v_q, **kw)
    assert LAUNCHES["fa2_forward_quant"] == before + 1
    args = (q, k_q.values, k_q.scales[..., 0].contiguous(), v_q.values,
            v_q.scales[..., 0].contiguous())
    o_p, lse_p = fq.fa2_forward_quant_plain(*args, causal=causal, sm_scale=d ** -0.5,
                                            kv_len=s, compute_dtype=compute)
    torch.cuda.synchronize()
    assert o_k.dtype == q_dtype and o_k.shape == q.shape
    bf16 = compute == torch.bfloat16
    if bf16:
        excess = _bf16_excess(o_k, o_p)
        assert excess <= BF16_ATOL["B7"], excess
    else:
        assert (o_k - o_p).abs().max().item() <= 2e-5
    lse_err = (lse_k - lse_p).abs() / (lse_p.abs().clamp_min(1.0) if bf16 else 1.0)
    assert lse_err.max().item() <= (1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("make", [
    lambda q, k: (q.double(), k),                        # fp64 q (fp16 runs)
    lambda q, k: (q[..., :48].contiguous(), k[..., :48].contiguous()),  # D 48
    lambda q, k: (q, k.to(torch.bfloat16)),              # bf16 "storage"
], ids=["fp64-q", "d48", "bf16-storage"])
def test_fa2_forward_quant_kernel_refuses_what_it_does_not_take(cuda, make):
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq

    q = torch.zeros(1, 2, 128, 64, device=cuda)
    k = torch.zeros(1, 2, 128, 64, dtype=torch.int8, device=cuda)
    q, k = make(q, k)
    s = torch.ones(1, 2, 128, device=cuda)
    with pytest.raises(NotImplementedError):
        fq.fa2_forward_quant_aligned(q, k, s, k, s, causal=False, sm_scale=0.125,
                                     kv_len=128)


def _cache_pages(rng, cache, hkv, num_pages, page, d, table, n, pps, cuda):
    pages = kv_cache.init_kv_pages(hkv, num_pages, page, d, cache, device="cpu")
    for slot in range(n):
        kv_cache.write_prompt_kv(pages, _randn(rng, pps * page, hkv, d),
                                 _randn(rng, pps * page, hkv, d), table[slot])
    return kv_cache.KVPages(*(t.to(cuda) for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))


@pytest.mark.parametrize("cache", NEW_CACHES, ids=str)
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d,hq,hkv", [(64, 16, 8), (128, 8, 8)])
def test_paged_decode_kernel_on_fp8_and_int4_pages(cuda, cache, q_dtype, compute,
                                                   d, hq, hkv):
    rng = np.random.default_rng(d + hq)
    lengths = torch.tensor([300, 0, 1, 128, 777, 129], dtype=torch.int32)
    n, pps, page = len(lengths), 7, 128
    num_pages = n * pps + 1
    table = torch.from_numpy(
        rng.permutation(np.arange(1, num_pages)).astype(np.int32)).reshape(n, pps)
    pages = _cache_pages(rng, cache, hkv, num_pages, page, d, table, n, pps, cuda)
    q = _randn(rng, n, hq, d).to(q_dtype).to(cuda)
    table, lengths = table.to(cuda), lengths.to(cuda)
    before = LAUNCHES["paged_decode"]
    o_k = dec_attention.paged_decode_attention(q, pages, table, lengths,
                                               compute_dtype=compute)
    assert LAUNCHES["paged_decode"] == before + 1
    o_p = dec_attention.paged_decode_attention_plain(
        q, pages, table, lengths, sm_scale=d ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert not o_k[1].any()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("cache", NEW_CACHES, ids=str)
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("chunk", [1, 5, 512])
def test_paged_chunk_kernel_on_fp8_and_int4_pages(cuda, cache, compute, chunk):
    rng = np.random.default_rng(chunk)
    d, hq, hkv, page = 64, 16, 8, 128
    lengths = torch.tensor([126 + chunk, 0, 300 + chunk, 1000 + chunk],
                           dtype=torch.int32)
    n, pps = len(lengths), -(-(1000 + chunk) // page)
    num_pages = n * pps + 1
    table = torch.from_numpy(
        rng.permutation(np.arange(1, num_pages)).astype(np.int32)).reshape(n, pps)
    pages = _cache_pages(rng, cache, hkv, num_pages, page, d, table, n, pps, cuda)
    q = _randn(rng, n, chunk, hq, d).to(compute).to(cuda)
    table, lengths = table.to(cuda), lengths.to(cuda)
    before = LAUNCHES["paged_chunk"]
    o_k = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                              compute_dtype=compute)
    assert LAUNCHES["paged_chunk"] == before + 1
    o_p = dec_attention.paged_chunk_attention_plain(
        q, pages, table, lengths, sm_scale=d ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert not o_k[1].any() and torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("variant", ["v0_current", "v1_mxu_ones", "v2_lane_part",
                                     "v3_bf16_sum", "v4_split_kv"])
def test_r5_probe_variants_match_plain(cuda, variant):
    from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5

    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 2, 4, 512, 128).to(torch.bfloat16).to(cuda)
               for _ in range(3))
    before = LAUNCHES["r5_d128_fwd"]
    o_k, lse_k = r5.fwd(q, k, v, variant)
    assert LAUNCHES["r5_d128_fwd"] == before + 1
    o_p, lse_p = r5.fwd_plain(q, k, v, variant)
    torch.cuda.synchronize()
    excess = _bf16_excess(o_k, o_p)
    assert excess <= BF16_ATOL["X"], excess
    lse_d = (lse_k - lse_p).abs()
    assert lse_d.max().item() <= (8e-3 if variant == "v3_bf16_sum" else 2e-4)
    assert lse_d.mean().item() <= 1e-4


# ---------------------------------------------------------------------------
# B5 as split-KV flash-decoding (csrc/paged_decode.cu): every cache code at
# D 64 and 128 and groups 1, 2 and 8, with lengths on the splits' edges and
# slots longer than one split; determinism, the arrival counters, and a
# CUDA graph.  Tolerances as test_paged_decode_kernel_matches_plain.
# ---------------------------------------------------------------------------

ALL_CACHES = [torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn,
              torch.float8_e5m2, "int4"]
# 12 pages a slot: the split plan makes runs of one or two pages (128 or 256
# tokens), so 256 and 512 end splits, 257 starts one, and 1000 and 1536
# span several; slot 0 is inactive.
SPLIT_LENGTHS = [0, 1, 256, 257, 512, 1000, 1536]
SPLIT_PPS = 12


def _decode_split_problem(cache, d, group, compute, cuda, seed=0):
    rng = np.random.default_rng(seed)
    hq = 8
    hkv = hq // group
    n = len(SPLIT_LENGTHS)
    num_pages = n * SPLIT_PPS + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)).reshape(n, SPLIT_PPS)
    pages = _cache_pages(rng, cache, hkv, num_pages, 128, d, table, n, SPLIT_PPS, cuda)
    q = _randn(rng, n, hq, d).to(compute).to(cuda)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=cuda)
    return q, pages, table.to(cuda), lengths


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("cache", ALL_CACHES, ids=str)
def test_paged_decode_splits_match_plain(cuda, cache, d, group, compute):
    q, pages, table, lengths = _decode_split_problem(cache, d, group, compute, cuda)
    n_splits = dec_attention.decode_split_plan(
        len(SPLIT_LENGTHS), 8 // group, SPLIT_PPS,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    per = dec_attention.split_pages(SPLIT_PPS, n_splits) * 128
    assert n_splits > 1 and 256 % per == 0 and max(SPLIT_LENGTHS) > per
    before = LAUNCHES["paged_decode"]
    o_k = dec_attention.paged_decode_attention(q, pages, table, lengths,
                                               compute_dtype=compute)
    assert LAUNCHES["paged_decode"] == before + 1
    o_p = dec_attention.paged_decode_attention_plain(
        q, pages, table, lengths, sm_scale=d ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert o_k.dtype == compute and not o_k[0].any()
    assert torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("cache", [torch.int8, "int4"], ids=str)
def test_paged_decode_splits_are_deterministic_and_reset(cuda, cache):
    """Two calls give the same bits (the splits fold in split order); after
    each call, and after a call at another num_seqs (whose split plan may
    differ), every arrival counter is back at zero and the next call still
    gives the first one's bits."""
    q, pages, table, lengths = _decode_split_problem(cache, 64, 2, torch.bfloat16, cuda, 1)
    first = dec_attention.paged_decode_attention(q, pages, table, lengths)
    again = dec_attention.paged_decode_attention(q, pages, table, lengths)
    counters = dec_attention._counters[cuda.index if cuda.index is not None
                                       else torch.cuda.current_device()]
    assert torch.equal(first, again) and not counters.any()
    part = dec_attention.paged_decode_attention(
        q[2:5].clone(), pages, table[2:5].clone(), lengths[2:5].clone())
    assert not counters.any()
    assert (part.float() - first[2:5].float()).abs().max().item() <= 2e-2
    assert torch.equal(dec_attention.paged_decode_attention(q, pages, table, lengths),
                       first)
    assert not counters.any()


def test_paged_decode_replays_in_a_cuda_graph(cuda):
    """Captured once, replayed after `lengths` changes in place: the same
    output as the eager call on the new lengths (the launch reads no
    length on the host)."""
    q, pages, table, lengths = _decode_split_problem(torch.int8, 64, 2, torch.bfloat16, cuda, 2)
    dec_attention.paged_decode_attention(q, pages, table, lengths)  # counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec_attention.paged_decode_attention(q, pages, table, lengths)
    for new in ([5, 0, 1536, 300, 129, 1, 12 * 128], [0] * 7, SPLIT_LENGTHS):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        want = dec_attention.paged_decode_attention(q, pages, table, lengths)
        torch.cuda.synchronize()
        assert torch.equal(out, want), new


# ---------------------------------------------------------------------------
# B8 with its Q-tile grid (csrc/fa2_forward_small.cu): every padded length
# around the 16-row and 64-row edges, kv_len inside the slot, causal or not,
# fp32 inputs in all three tile types and bf16 inputs in bf16 (cp.async) and
# fp16 tiles, one slot and 257.  Tolerances as
# test_fa2_forward_small_kernel_matches_plain.
# ---------------------------------------------------------------------------

@FWD_VARIANTS
@pytest.mark.parametrize("bh", [(1, 1), (1, 257)], ids=["BH1", "BH257"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "kv_len<S"])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 100, 127, 128])
def test_fa2_forward_small_q_tiles_match_plain(cuda, dtype, tile, bh, causal,
                                               ragged, s):
    rng = np.random.default_rng(s * 7 + causal)
    kv_len = max(1, s - s // 3) if ragged else s
    d = 128 if s in (17, 100) else 64
    q, k, v = (_randn(rng, *bh, s, d).to(dtype) for _ in range(3))
    kw = dict(causal=causal, sm_scale=d ** -0.5, kv_len=kv_len, tile_dtype=tile)
    before = LAUNCHES["fa2_forward_small"]
    o_k, lse_k = fa2_forward.fa2_forward_small_aligned(
        q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    assert LAUNCHES["fa2_forward_small"] == before + 1
    o_p, lse_p = fa2_forward.fa2_forward_small_plain(q, k, v, **kw)
    low = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if low else 2e-6), err
    assert lse_err <= (1e-3 if low else 1e-5), lse_err


# ---------------------------------------------------------------------------
# B6 on its two Hopper bodies (csrc/paged_chunk.cu): the split-KV body for
# T * group <= 64, the tile bodies above; every cache code at D 64 and 128,
# groups 1, 2 and 8 and T 1 to 512; lengths on the splits' edges and rows
# with columns in one split and none in the next; determinism, the arrival
# counters, T = 1 against B5, and a CUDA graph.  Tolerances as
# test_paged_chunk_kernel_matches_plain.
# ---------------------------------------------------------------------------

# T 33 at group 2 and 8 ends inside a 64-row tile of the tile bodies.
B6_CHUNKS = [1, 2, 5, 8, 33, 128, 512]
B6_PPS = 12  # 1536 tokens a slot


def _b6_lengths(chunk):
    """An inactive slot, a slot of length T, length - T at 126 (rows on both
    sides of page 1's start), 256 (a page and split edge) and 1000."""
    return [0, chunk, 126 + chunk, 256 + chunk, 1000 + chunk]


@functools.lru_cache(maxsize=None)
def _b6_pages(cache, d, hkv, pps, n):
    rng = np.random.default_rng(d + hkv + pps)
    num_pages = n * pps + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)).reshape(n, pps)
    pages = _cache_pages(rng, cache, hkv, num_pages, 128, d, table, n, pps,
                         torch.device("cuda"))
    return pages, table.cuda()


def _b6_problem(cache, d, group, chunk, compute, lengths, pps, seed=0):
    hkv = 8 // group if group < 8 else 1
    pages, table = _b6_pages(cache, d, hkv, pps, len(lengths))
    rng = np.random.default_rng(seed + chunk)
    q = _randn(rng, len(lengths), chunk, hkv * group, d).to(compute).cuda()
    return q, pages, table, torch.tensor(lengths, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("chunk", B6_CHUNKS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("cache", ALL_CACHES, ids=str)
def test_paged_chunk_bodies_match_plain(cuda, cache, d, group, chunk, compute):
    q, pages, table, lengths = _b6_problem(cache, d, group, chunk, compute,
                                           _b6_lengths(chunk), B6_PPS)
    before = LAUNCHES["paged_chunk"]
    o_k = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                              compute_dtype=compute)
    assert LAUNCHES["paged_chunk"] == before + 1
    o_p = dec_attention.paged_chunk_attention_plain(
        q, pages, table, lengths, sm_scale=d ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert o_k.dtype == compute and not o_k[0].any()
    assert torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("cache", [torch.float32, torch.int8, "int4"], ids=str)
@pytest.mark.parametrize("chunk,group", [(1, 1), (2, 2), (5, 2), (8, 1), (5, 8), (8, 8)])
def test_paged_chunk_splits_at_their_edges(cuda, chunk, group, cache, compute):
    """tests/test_torch_b6_split.py's lengths on 4 pages a slot (an inactive
    slot, length T, length - T at 126, 128, 254 and 256, a full table): the
    plan makes one page a split, so split 1 holds columns for the last rows
    of the slot at 126 + T and none for its first."""
    lengths = [0, chunk, 126 + chunk, 128 + chunk, 254 + chunk, 256 + chunk, 512]
    q, pages, table, lengths = _b6_problem(cache, 64, group, chunk, compute, lengths, 4)
    hkv = pages.k_pages.shape[0]
    n_splits = dec_attention.chunk_split_plan(
        7, hkv, 4, chunk, group, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_splits == 4
    o_k = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                              compute_dtype=compute)
    o_p = dec_attention.paged_chunk_attention_plain(
        q, pages, table, lengths, sm_scale=64 ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert not o_k[0].any() and torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("chunk", [5, 512])
def test_paged_chunk_is_deterministic_and_resets_its_counters(cuda, chunk):
    """Two calls give the same bits (the splits fold in split order); after
    each call, and after a call at another num_seqs (whose split plan may
    differ), every arrival counter is back at zero and the next call still
    gives the first one's bits."""
    q, pages, table, lengths = _b6_problem(torch.int8, 64, 2, chunk, torch.bfloat16,
                                           _b6_lengths(chunk), B6_PPS, seed=1)
    first = dec_attention.paged_chunk_attention(q, pages, table, lengths)
    again = dec_attention.paged_chunk_attention(q, pages, table, lengths)
    counters = dec_attention._counters[cuda.index if cuda.index is not None
                                       else torch.cuda.current_device()]
    assert torch.equal(first, again) and not counters.any()
    part = dec_attention.paged_chunk_attention(
        q[2:4].clone(), pages, table[2:4].clone(), lengths[2:4].clone())
    assert not counters.any()
    assert (part.float() - first[2:4].float()).abs().max().item() <= 2e-2
    assert torch.equal(dec_attention.paged_chunk_attention(q, pages, table, lengths),
                       first)
    assert not counters.any()


@pytest.mark.parametrize("cache", ALL_CACHES, ids=str)
def test_paged_chunk_of_one_equals_paged_decode_on_split_pages(cuda, cache):
    """T = 1 on the split body and B5 compute one function."""
    for compute, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, pages, table, lengths = _b6_problem(cache, 64, 2, 1, compute,
                                               _b6_lengths(1), B6_PPS, seed=2)
        one = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                                  compute_dtype=compute)[:, 0]
        dec = dec_attention.paged_decode_attention(q[:, 0].contiguous(), pages, table,
                                                   lengths, compute_dtype=compute)
        assert (one.float() - dec.float()).abs().max().item() <= tol


def test_paged_chunk_replays_in_a_cuda_graph(cuda):
    """The split body captured once, replayed after `lengths` changes in
    place: the same output as the eager call on the new lengths (the launch
    reads no length on the host)."""
    q, pages, table, lengths = _b6_problem(torch.int8, 64, 2, 5, torch.bfloat16,
                                           _b6_lengths(5), B6_PPS, seed=3)
    dec_attention.paged_chunk_attention(q, pages, table, lengths)  # counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec_attention.paged_chunk_attention(q, pages, table, lengths)
    for new in ([5, 0, 1536, 300, 129], [0] * 5, _b6_lengths(5)):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        want = dec_attention.paged_chunk_attention(q, pages, table, lengths)
        torch.cuda.synchronize()
        assert torch.equal(out, want), new


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("variant", ["v0_current", "v1_mxu_ones", "v2_lane_part",
                                     "v3_bf16_sum", "v4_split_kv"])
def test_r5_probe_on_its_wgmma_body(cuda, variant, s):
    """X's two-pass wgmma body against its plain version at S 128 (v4's
    halves of 64 keys: a masked partial tile), 256 and 2048, under phase
    23's gates."""
    from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as r5

    rng = np.random.default_rng(s)
    q, k, v = (_randn(rng, 1, 3, s, 128).to(torch.bfloat16).to(cuda) for _ in range(3))
    o_k, lse_k = r5.fwd(q, k, v, variant)
    o_p, lse_p = r5.fwd_plain(q, k, v, variant)
    torch.cuda.synchronize()
    assert _bf16_excess(o_k, o_p) <= BF16_ATOL["X"]
    lse_d = (lse_k - lse_p).abs()
    assert lse_d.max().item() <= (8e-3 if variant == "v3_bf16_sum" else 2e-4)
    assert lse_d.mean().item() <= 1e-4


# ---------------------------------------------------------------------------
# Decode steps as CUDA graphs (decode/graphs.py): the engine's bursts and
# per-token steps, the benchmark's device loop.  The tiny model in fp32
# (fp32 compute in B5) for the card-against-CPU comparisons; bf16 tiles and
# an int8 cache where the graph is compared with eager launches on the card
# (the same kernels on the same inputs: bitwise).
# ---------------------------------------------------------------------------

def _cache_ptrs(eng):
    return [t.data_ptr() for c in eng.caches for t in (c.k_pages, c.k_scales,
                                                        c.v_pages, c.v_scales)]


@pytest.mark.parametrize("scan_layers", [False, True], ids=["list", "stacked"])
def test_graph_burst_matches_an_eager_decode_loop(cuda, scan_layers):
    """Greedy tokens of the engine at bursts 1 and 4 (replayed graphs) and
    of an eager decode_step loop from the same prefill are bitwise equal;
    scan_layers (the list form in the port) changes nothing."""
    from cuda_flash_attention_tpu_torch.bench import decode_bench

    cfg = TransformerConfig.tiny()
    b, p, n = 4, 128, 9
    params, caches, table, _ = decode_bench.build_state(
        cfg, b, p, 2 * p, scan_layers=scan_layers)
    prompts = decode_bench._prompt_tokens(cfg, b, p, 0).tolist()
    toks = {}
    for burst in (1, 4):
        eng = DecodeEngine(params, cfg, max_seqs=b, max_seq_len=2 * p,
                           decode_burst=burst, scan_layers=scan_layers)
        toks[burst] = [r.generated for r in eng.run(prompts, max_new_tokens=n + 1)]
        assert eng.graph_replays > 0
    loop = decode_bench.make_loop_fn(cfg, table, p, graph=False)
    loop(params, caches, torch.tensor([t[0] for t in toks[1]], device=cuda), n)
    eager = [[t[0]] + col for t, col in zip(toks[1], loop.history.T.tolist())]
    assert toks[4] == toks[1] == eager
    graph = decode_bench.make_loop_fn(cfg, table, p)
    graph(params, caches, torch.tensor([t[0] for t in toks[1]], device=cuda), n)
    assert torch.equal(graph.history, loop.history)


def test_moe_decode_step_replays_in_a_cuda_graph(cuda):
    """tiny_moe's decode step over 16 slots (6 of them inactive, carrying
    their last tokens as the engine feeds them; 16 tokens overflow the
    capacity at factor 0.6) captured in a CUDA graph and replayed on new
    tokens: bitwise the eager step's logits and appended K/V."""
    from cuda_flash_attention_tpu_torch.decode.model import decode_step

    cfg = TransformerConfig.tiny_moe(capacity_factor=0.6)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    params = {k: ([{n: w.to(cfg.dtype) if w.ndim >= 2 else w for n, w in layer.items()}
                   for layer in v] if k == "layers" else v.to(cfg.dtype) if v.ndim >= 2
                  else v) for k, v in params.items()}
    n, pps = 16, 2
    rng = np.random.default_rng(32)
    table = torch.arange(1, n * pps + 1, dtype=torch.int32, device=cuda).reshape(n, pps)
    active = torch.from_numpy(rng.random(n) < 0.7).to(cuda)
    positions = torch.from_numpy(rng.integers(0, 200, n)).to(cuda)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, n)).to(cuda)

    def caches():
        return [kv_cache.init_kv_pages(cfg.n_kv_heads, n * pps + 1, 128, cfg.head_dim,
                                       torch.int8, device=cuda) for _ in range(cfg.n_layers)]

    c_graph, c_eager = caches(), caches()
    with torch.inference_mode():
        decode_step(params, tokens, positions, c_graph, table, active, cfg)  # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = decode_step(params, tokens, positions, c_graph, table, active, cfg)
        for seed in range(3):
            tokens.copy_(torch.from_numpy(np.random.default_rng(seed).integers(
                0, cfg.vocab_size, n)))
            graph.replay()
            want, _ = decode_step(params, tokens, positions, c_eager, table, active, cfg)
            torch.cuda.synchronize()
            assert torch.equal(logits, want), seed
    for a, b in zip(c_graph, c_eager):
        assert torch.equal(a.k_pages, b.k_pages) and torch.equal(a.v_pages, b.v_pages)


@pytest.mark.parametrize("cf", [1.25, 0.6])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, cf):
    """models/moe.py's layer (scatter, batched products, gather) in fp32 on
    the card against the CPU: routing equal but under a 1e-6 top-k margin,
    outputs within 2e-5 and the router loss within 1e-6 where no token's
    routing differs; at factor 0.6 tokens drop."""
    from cuda_flash_attention_tpu_torch.models import moe

    cfg = TransformerConfig.tiny_moe(dtype=torch.float32, capacity_factor=cf)
    layer = moe.init_moe_layer(torch.Generator().manual_seed(1), cfg, "cpu")
    x = _randn(np.random.default_rng(2), 2, 96, cfg.d_model)
    got = moe.moe_ffn(x.to(cuda), {k: v.to(cuda) for k, v in layer.items()}, cfg)
    want = moe.moe_ffn(x, layer, cfg)
    probs, _, idx_c, _ = moe._route(x.reshape(-1, cfg.d_model), layer, cfg)
    _, _, idx_g, _ = moe._route(x.to(cuda).reshape(-1, cfg.d_model),
                                {k: v.to(cuda) for k, v in layer.items()}, cfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    margin = torch.stack([top[:, k] - top[:, k + 1] for k in range(2)], 1).amin(1)
    differ = (idx_g.cpu() != idx_c).any(1)
    assert not (differ & (margin >= 1e-6)).any()
    rank = moe._ranks(idx_c, cfg.n_experts)
    cap = moe.expert_capacity(192, cfg.n_experts, 2, cf)
    assert bool((rank >= cap).any()) == (cf < 1)
    if not differ.any():
        assert (got[0].cpu() - want[0]).abs().max().item() <= 2e-5
        assert abs(float(got[1]) - float(want[1])) <= 1e-6


def test_graph_replays_after_the_table_grows_and_a_slot_retires(cuda):
    """Bursts cross page boundaries (the table grows between replays), a
    short request retires mid-run and a queued one takes its slot: the
    card's tokens equal the CPU's, every cache writer kept its buffers (the
    graph holds their addresses), and no page leaks."""
    cfg = TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, 256).tolist()
    prompts = [rng.integers(0, 256, 125).tolist(), shared + [1, 2],
               rng.integers(0, 256, 300).tolist(), shared + [7]]
    budgets = [9, 3, 7, 12]
    runs = {}
    for dev in (None, "cpu"):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512,
                           cache_dtype=torch.float32, device=dev, decode_burst=4,
                           prefix_cache=True, prefill_chunk=128)
        ptrs = _cache_ptrs(eng)
        reqs = [eng.submit(pr, max_new_tokens=m) for pr, m in zip(prompts, budgets)]
        while any(not r.done for r in reqs):
            eng.step()
        eng.step()
        runs[dev] = [r.generated for r in reqs]
        assert [len(g) for g in runs[dev]] == budgets
        assert _cache_ptrs(eng) == ptrs
        assert eng.allocator.available == eng.num_pages - 1
        if dev is None:
            assert eng.graph_replays > 0 and eng.stats["burst_dispatches"] > 0
    assert runs[None] == runs["cpu"]


def test_sampled_graph_replays_draw_new_numbers(cuda):
    """A sampled burst's replays draw different tokens, and a reseeded
    engine repeats them."""
    cfg = TransformerConfig.tiny()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [[5, 7, 11], [2, 3, 200, 17, 9]]

    def run(seed):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512,
                           temperature=5.0, seed=seed, decode_burst=8)
        out = [r.generated for r in eng.run(prompts, max_new_tokens=17)]
        assert eng.graph_replays >= 16
        return out

    a = run(1)
    assert all(len(set(g[1:9])) > 1 and len(set(g[9:])) > 1 for g in a)
    assert all(g[1:9] != g[9:] for g in a)
    assert run(1) == a
    assert run(2) != a


def test_capture_holds_the_collector_off(cuda):
    """A dropped engine's graphs sit in reference cycles until the collector
    runs; a collection inside another capture would destroy them there and
    invalidate it.  StepGraph holds the collector off while it captures:
    here the step sets a threshold that collects generation 0, where the
    old graph's cycle lies, at its next allocations."""
    from cuda_flash_attention_tpu_torch.decode.graphs import StepGraph

    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(10 ** 9)  # nothing collects until the step asks
    try:
        x = torch.zeros(1, device=cuda)
        old = StepGraph(lambda: x.add_(1), cuda, warmup=lambda: None)
        old.run(1)
        cycle = [old]
        cycle.append(cycle)
        del old, cycle

        def step():
            gc.set_threshold(1)
            _ = [[] for _ in range(8)]
            x.add_(2)

        new = StepGraph(step, cuda, warmup=lambda: None)
        new.run(2)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert x.item() == 5


def test_launch_counts_include_graph_replays(cuda):
    """Each replay of the captured step adds the step's launches to the
    wrappers' counts: B5 launches once a layer per step, eagerly in each
    capture's warm-up and in every replay."""
    cfg = TransformerConfig.tiny()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512, decode_burst=4)
    before = LAUNCHES["paged_decode"]
    eng.run([[5, 7, 11], [2, 3]], max_new_tokens=10)
    captures = len(eng._graphs)
    assert eng.graph_replays > 0 and captures == 1
    assert (LAUNCHES["paged_decode"] - before
            == cfg.n_layers * (eng.graph_replays + captures))
    graph = next(iter(eng._graphs.values()))
    assert graph.launch_delta["paged_decode"] == cfg.n_layers


@pytest.mark.parametrize("weights", ["w8a8", "int4", "lora"])
def test_quantized_and_lora_steps_capture(cuda, weights):
    """W8A8 (torch._int_mm), int4 weights (dequantized per product) and a
    LoRA weight run in the captured step: the card's greedy tokens equal
    the CPU's at fp32."""
    from cuda_flash_attention_tpu_torch.models import apply_lora
    from cuda_flash_attention_tpu_torch.quant import quantize_transformer_params

    cfg = TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    if weights == "lora":
        params = apply_lora(params, torch.Generator().manual_seed(1), rank=4)
    else:
        params = quantize_transformer_params(
            params, "int4" if weights == "int4" else torch.int8,
            act_quant=weights == "w8a8")
    runs = {}
    for dev in (None, "cpu"):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=512,
                           device=dev, decode_burst=2)
        runs[dev] = [r.generated for r in eng.run([[5, 7, 11], [2, 3]],
                                                  max_new_tokens=6)]
    assert runs[None] == runs["cpu"]


# ---------------------------------------------------------------------------
# Sliding windows and attention sinks (B1, B8, B5, B6): each windowed kernel
# against its plain version on the CPU, at chip_smoke phase 25's shapes and
# around the walks' edges; table entries behind the window naming another
# slot's pages (what the engine's recycling leaves) change no output bit;
# the hybrid window-group engine's captured decode steps give the CPU's
# tokens.  Tolerances as the unwindowed tests above; a row that keeps no
# key carries the plain version's lse bit for bit.
# ---------------------------------------------------------------------------

WINDOW_FWD = pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles", "bf16-in-fp16-tiles"])


def _windowed_forward_check(cuda, b, hq, hkv, sq, skv, d, causal, window, sinks,
                            dtype, tile, small=False):
    rng = np.random.default_rng(sq + skv + d)
    q = _randn(rng, b, hq, sq, d).to(dtype)
    k, v = (_randn(rng, b, hkv, skv, d).to(dtype) for _ in range(2))
    q, k, v, scale, _, kv_len = attention._prepare(q, k, v, causal, None, tile,
                                                   None, None, window, sinks)
    kw = dict(causal=causal, sm_scale=scale, kv_len=kv_len, tile_dtype=tile,
              window=window, sinks=sinks)
    name = "fa2_forward_small" if small else "fa2_forward"
    fn = fa2_forward.fa2_forward_small_aligned if small else fa2_forward.fa2_forward_aligned
    before = (LAUNCHES[name], LAUNCHES[name + "_window"])
    o_k, lse_k = fn(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    assert (LAUNCHES[name], LAUNCHES[name + "_window"]) == (before[0] + 1, before[1] + 1)
    o_p, lse_p = fn(q, k, v, **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    tol = 2e-6 if (tile or dtype) == torch.float32 else 2e-2
    assert (o_k.float() - o_p.float()).abs().max().item() <= tol
    dead = lse_p < -1e30
    assert torch.equal(lse_k[dead], lse_p[dead])
    live = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0))[~dead]
    assert live.numel() == 0 or live.max().item() <= (1e-5 if tol == 2e-6 else 1e-3)
    return int(dead.sum())


@WINDOW_FWD
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,sinks", [
    (1, 4, 2, 1536, 1536, True, 128, 4),    # phase 25's serving shapes
    (1, 4, 2, 1536, 1536, True, 128, 0),
    (1, 2, 1, 8192, 8192, True, 1024, 0),   # long, a wide window
    (2, 4, 2, 1024, 1024, False, -100, 0),  # a band: rows with no key
    (1, 4, 2, 1024, 1024, False, 64, 0),
    (1, 4, 2, 300, 300, True, 1, 0),
    (1, 4, 2, 700, 700, True, 100, 130),    # sinks past the first tile
    (2, 4, 2, 200, 130, True, 64, 0),       # Sq > Skv + window: dead rows
    (1, 4, 2, 130, 700, True, 64, 4),
    (1, 2, 2, 1024, 1024, False, -300, 0),  # a 128-row tile walks nothing
], ids=str)
def test_windowed_fa2_forward_matches_plain(cuda, b, hq, hkv, sq, skv, causal,
                                            window, sinks, d, dtype, tile):
    _windowed_forward_check(cuda, b, hq, hkv, sq, skv, d, causal, window, sinks,
                            dtype, tile)


@WINDOW_FWD
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,window,sinks", [
    (100, True, 32, 4), (128, True, 1, 0), (100, False, -20, 0), (17, True, 8, 2),
], ids=str)
def test_windowed_fa2_forward_small_matches_plain(cuda, s, causal, window, sinks,
                                                  d, dtype, tile):
    _windowed_forward_check(cuda, 4, 8, 8, s, s, d, causal, window, sinks, dtype,
                            tile, small=True)


def _stale_table(table, lengths, chunk, window, sinks, page=128):
    """Entries behind every row's window (not sink pages) pointed at the
    next slot's page of the same index."""
    out = table.clone()
    for s, n in enumerate(lengths):
        first = max(0, n - chunk - window + 1)
        for p in range(table.shape[1]):
            if p * page < n and (p + 1) * page <= first and p * page >= sinks:
                out[s, p] = table[(s + 1) % table.shape[0], p]
    return out


WINDOW_LENGTHS = [2048, 1, 129, 0, 777, 1500, 128, 2000]


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("cache", ALL_CACHES, ids=str)
@pytest.mark.parametrize("chunk,d,group", [
    (chunk, d, group) for chunk in (1, 5) for d in (64, 128) for group in (2, 8)
] + [(512, 64, 2)], ids=str)  # T 512 at the base model's D 64 and group 2
@pytest.mark.parametrize("window,sinks", [(128, 4), (300, 200)], ids=str)
def test_windowed_paged_kernels_match_plain(cuda, window, sinks, chunk, d, group,
                                            cache, compute):
    """B5 (chunk 1) and B6 (T 5: the split body; T 512: the tile bodies);
    the output is bitwise the same when the entries behind the window name
    another slot's pages."""
    rng = np.random.default_rng(d + group + chunk)
    hq = 16 if group == 2 else 8
    hkv = hq // group
    n, pps = len(WINDOW_LENGTHS), 16
    num_pages = n * pps + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)).reshape(n, pps)
    pages = _cache_pages(rng, cache, hkv, num_pages, 128, d, table, n, pps, cuda)
    lens = [max(x, chunk) if x else 0 for x in WINDOW_LENGTHS]
    lengths = torch.tensor(lens, dtype=torch.int32)
    stale = _stale_table(table, lens, chunk, window, sinks)
    assert not torch.equal(stale, table)
    kw = dict(compute_dtype=compute, window=window, sinks=sinks)
    if chunk == 1:
        q = _randn(rng, n, hq, d).to(compute)
        fn, name = dec_attention.paged_decode_attention, "paged_decode"
    else:
        q = _randn(rng, n, chunk, hq, d).to(compute)
        fn, name = dec_attention.paged_chunk_attention, "paged_chunk"
    before = LAUNCHES[name + "_window"]
    o_k = fn(q.to(cuda), pages, table.to(cuda), lengths.to(cuda), **kw)
    o_s = fn(q.to(cuda), pages, stale.to(cuda), lengths.to(cuda), **kw)
    assert LAUNCHES[name + "_window"] == before + 2
    cpu_pages = kv_cache.KVPages(*(t.cpu() for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))
    o_p = fn(q, cpu_pages, table, lengths, **kw)
    tol = 2e-5 if compute == torch.float32 else 2e-2
    assert (o_k.cpu().float() - o_p.float()).abs().max().item() <= tol
    assert torch.equal(o_k, o_s), "an entry behind the window was read"


@pytest.mark.parametrize("config", ["hybrid", "streaming"])
def test_captured_windowed_decode_matches_the_cpu(cuda, config):
    """The hybrid (window 128 on every other layer, per-group tables) and
    streaming (window 128, 16 sinks) engines: the card's captured decode
    steps, in bursts of 4 that cross recycled pages, give the CPU's eager
    tokens in fp32, and every group's pages return to its pool."""
    extra = (dict(attn_window=128, global_every=2) if config == "hybrid"
             else dict(attn_window=128, attn_sinks=16))
    cfg = dataclasses.replace(
        TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None), **extra)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (300, 130, 460)]
    runs = {}
    for dev in (None, "cpu"):
        eng = DecodeEngine(params, cfg, max_seqs=2, max_seq_len=1024,
                           cache_dtype=torch.float32, device=dev, decode_burst=4,
                           prefill_chunk=256)
        reqs = eng.run(prompts, max_new_tokens=140)
        runs[dev] = [r.generated for r in reqs]
        for a in eng._group_allocs:
            assert a.available == a.num_pages - 1
        if dev is None:
            assert eng.graph_replays > 0
            assert LAUNCHES["paged_decode_window"] > 0
    assert runs[None] == runs["cpu"]


# ---------------------------------------------------------------------------
# Training with windows, sinks and segment ids: the windowed and segmented
# B2, B3 and B4 (both tile kinds, both routes' kernels) and the segmented
# B1 and B8, each against its plain version on the CPU.  Cases reach the
# walks' edges: windows inside one tile and across several, sinks inside
# the first tile and past it, a band whose last rows keep no key, Sq > Skv
# + window (dead rows), the reference tiles' dead-row case (window 520, Sq
# 1500, Skv 700), segments with and without a window, and a padded batch
# whose pad ids match no key.  A row that keeps no key must get dQ = 0
# exactly and carry the plain version's lse bit for bit.
# ---------------------------------------------------------------------------

MASKED_VARIANTS = pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
], ids=["bf16", "fp32", "fp32-in-bf16-tiles", "bf16-in-fp16-tiles"])


def _packed_ids(rng, b, s, n_seg):
    """[b, s] int32 ids of n_seg contiguous documents cut at random points."""
    ids = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), n_seg - 1, replace=False))
        ids[i] = np.searchsorted(cuts, np.arange(s), side="right")
    return torch.from_numpy(ids)


def _masked_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal, window, sinks,
                    n_seg, seed, ids=None):
    """Padded CPU inputs of a windowed or segmented backward: q, k, v, dO
    from numpy, O and lse from the plain forward, D_i; the keyword
    arguments of every wrapper (window and sinks as the API normalizes
    them, the ids padded as it pads them)."""
    rng = np.random.default_rng(seed)
    q, do = (_randn(rng, b, hq, sq, d).to(dtype) for _ in range(2))
    k, v = (_randn(rng, b, hkv, skv, d).to(dtype) for _ in range(2))
    if ids is None and n_seg:
        ids = (_packed_ids(rng, b, sq, n_seg),) * 2 if sq == skv else (
            _packed_ids(rng, b, sq, n_seg), _packed_ids(rng, b, skv, n_seg))
    q_ids, kv_ids = ids if ids is not None else (None, None)
    window, sinks = attention._window_of(window, sinks, causal, q, k)
    qp, kp, vp, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, tile, q_ids, kv_ids, window, sinks)
    q_seg, kv_seg = attention._segments_of(q_ids, kv_ids, qp, kp)
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len, tile_dtype=tile,
              window=window, sinks=sinks, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = fa2_forward.fa2_forward_plain(qp, kp, vp, **kw)
    do = torch.nn.functional.pad(do, (0, 0, 0, qp.shape[2] - sq))
    di = (o.float() * do.float()).sum(-1)
    return dict(q=qp, k=kp, v=vp, o=o, do=do, lse=lse, di=di), kw


def _to(x, kw, device):
    out = dict(kw)
    for n in ("q_seg", "kv_seg"):
        if out[n] is not None:
            out[n] = out[n].to(device)
    return {n: t.to(device) for n, t in x.items()}, out


def _masked_counts(kw):
    names = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")
    tags = ([""] + (["_window"] if kw["window"] is not None else [])
            + (["_segments"] if kw["q_seg"] is not None else []))
    return tuple(LAUNCHES[n + t] for n in names for t in tags)


MASKED_BWD = pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,causal,window,sinks,n_seg", [
        (1, 4, 2, 512, 512, True, 128, 0, 0),     # the hybrid local layer's call
        (1, 4, 2, 512, 512, True, 100, 4, 0),     # sinks inside the first tile
        (1, 4, 2, 700, 700, True, 100, 130, 0),   # sinks past the first tile
        (1, 8, 2, 2048, 2048, True, 128, 0, 0),   # the rings wrap many times
        (1, 4, 2, 1024, 1024, True, 512, 4, 0),   # streaming's window
        (2, 4, 2, 1024, 1024, False, -100, 0, 0),  # a band: rows with no key
        (1, 4, 2, 1024, 1024, False, 64, 0, 0),
        (1, 2, 1, 1500, 700, True, 520, 0, 0),    # the reference tiles' dead rows
        (1, 4, 4, 200, 130, True, 64, 0, 0),      # Sq > Skv + window
        (1, 4, 2, 300, 300, True, 3, 0, 0),
        (2, 4, 2, 512, 512, True, None, 0, 4),    # packed documents
        (2, 4, 2, 512, 512, False, None, 0, 3),
        (1, 4, 2, 512, 512, True, 128, 4, 3),     # segments under a window
        (1, 4, 2, 300, 500, True, None, 0, 2),    # Sq != Skv, ids of each
    ], ids=str)


@MASKED_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@MASKED_BWD
def test_masked_backward_kernels_match_plain(cuda, dtype, tile, d, b, hq, hkv,
                                             sq, skv, causal, window, sinks,
                                             n_seg):
    """B2, B3 and B4 with a window, sinks or segment ids against the plain
    backward; each launch counted under its `_window` and `_segments`
    names; dQ of a row that keeps no key exactly 0."""
    x, kw = _masked_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal, window,
                            sinks, n_seg, seed=sq + skv + d)
    g, gkw = _to(x, kw, cuda)
    before = _masked_counts(kw)
    fused = fa2_backward.fa2_backward_fused_aligned(
        g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"], **gkw)
    dq = fa2_backward.fa2_backward_dq_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **gkw)
    dkv = fa2_backward.fa2_backward_dkv_aligned(
        g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"], **gkw)
    torch.cuda.synchronize()
    assert _masked_counts(kw) == tuple(n + 1 for n in before)
    plain = fa2_backward.fa2_backward_fused_plain(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], **kw)
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    for got, want in zip(fused, plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _rel_err(got, want) <= tol
    for got, want in ((dq, plain[0]), (dkv[0], plain[1]), (dkv[1], plain[2])):
        assert bool(torch.isfinite(got.float()).all())
        assert _rel_err(got, want) <= tol
    dead = x["lse"] < -1e30
    if dead.any():
        for got in (fused[0], dq):
            assert bool((got.cpu()[dead] == 0).all())


@MASKED_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,sinks", [
    (True, 128, 0), (True, 100, 130), (False, -100, 0), (True, 520, 0)], ids=str)
def test_masked_fused_reduce_reads_only_written_slices(cuda, dtype, tile, d,
                                                       causal, window, sinks):
    """B2 writes only the slices of the (KV tile, Q tile) pairs its walk
    visits; under a window most slices of a row are never written.  A
    NaN-filled tensor of dq_part's size is freed just before the call, so
    dq_part takes that memory: a slice the reduce read without B2 having
    written it would show as NaN."""
    x, kw = _masked_problem(dtype, tile, d, 1, 4, 2, 1000, 1000, causal, window,
                            sinks, 0, seed=9)
    g, gkw = _to(x, kw, cuda)
    q, k = g["q"], g["k"]
    n_slices = -(-k.shape[2] // fa2_backward.fused_kv_tile(q.dtype, tile))
    bait = torch.full((q.shape[0], q.shape[1], n_slices) + tuple(q.shape[2:]),
                      float("nan"), device=cuda)
    del bait
    got = fa2_backward.fa2_backward_fused_aligned(
        g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"], **gkw)
    torch.cuda.synchronize()
    want = fa2_backward.fa2_backward_fused_plain(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], **kw)
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        assert _rel_err(a, w) <= tol


@MASKED_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
def test_masked_backward_kernels_bitwise_deterministic(cuda, dtype, tile, d):
    x, kw = _masked_problem(dtype, tile, d, 1, 8, 2, 2048, 2048, True, 128, 4, 3,
                            seed=d)
    g, gkw = _to(x, kw, cuda)
    args = (g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"])
    split = (g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"])
    for fn, a in ((fa2_backward.fa2_backward_fused_aligned, args),
                  (fa2_backward.fa2_backward_dq_aligned, split),
                  (fa2_backward.fa2_backward_dkv_aligned, split)):
        first, second = fn(*a, **gkw), fn(*a, **gkw)
        for p, r in zip(first if isinstance(first, tuple) else (first,),
                        second if isinstance(second, tuple) else (second,)):
            assert torch.equal(p, r)


@MASKED_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window,sinks,n_seg", [
    (2, 4, 2, 512, 512, True, None, 0, 4),
    (2, 4, 2, 512, 512, False, None, 0, 3),
    (1, 4, 2, 1024, 1024, True, 128, 4, 3),
    (1, 4, 2, 300, 500, False, None, 0, 2),
    (2, 4, 2, 2048, 2048, True, None, 0, 4),
], ids=str)
def test_segmented_fa2_forward_matches_plain(cuda, dtype, tile, d, b, hq, hkv,
                                             sq, skv, causal, window, sinks,
                                             n_seg):
    x, kw = _masked_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal, window,
                            sinks, n_seg, seed=sq + d)
    g, gkw = _to(x, kw, cuda)
    before = LAUNCHES["fa2_forward_segments"]
    o_k, lse_k = fa2_forward.fa2_forward_aligned(g["q"], g["k"], g["v"], **gkw)
    assert LAUNCHES["fa2_forward_segments"] == before + 1
    o_p, lse_p = fa2_forward.fa2_forward_plain(x["q"], x["k"], x["v"], **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    tol = 2e-6 if (tile or dtype) == torch.float32 else 2e-2
    assert (o_k.float() - o_p.float()).abs().max().item() <= tol
    dead = lse_p < -1e30
    assert torch.equal(lse_k[dead], lse_p[dead])
    live = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0))[~dead]
    assert live.max().item() <= (1e-5 if tol == 2e-6 else 1e-3)


@MASKED_VARIANTS
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s,causal,window,sinks", [
    (100, True, None, 0), (100, False, None, 0), (128, True, 32, 4), (17, True, None, 0),
], ids=str)
def test_segmented_fa2_forward_small_matches_plain(cuda, dtype, tile, d, s,
                                                   causal, window, sinks):
    x, kw = _masked_problem(dtype, tile, d, 4, 8, 8, s, s, causal, window, sinks,
                            2, seed=s + d)
    g, gkw = _to(x, kw, cuda)
    assert attention._use_small_kernel(g["q"], g["k"])
    before = LAUNCHES["fa2_forward_small_segments"]
    o_k, lse_k = fa2_forward.fa2_forward_small_aligned(g["q"], g["k"], g["v"],
                                                       **gkw)
    assert LAUNCHES["fa2_forward_small_segments"] == before + 1
    o_p, lse_p = fa2_forward.fa2_forward_small_plain(x["q"], x["k"], x["v"], **kw)
    tol = 2e-6 if (tile or dtype) == torch.float32 else 2e-2
    assert (o_k.cpu().float() - o_p.float()).abs().max().item() <= tol
    assert ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max() <= (
        1e-5 if tol == 2e-6 else 1e-3)


@MASKED_VARIANTS
@pytest.mark.parametrize("s", [128, 300])
def test_padding_ids_give_zero_rows_and_key_gradients(cuda, dtype, tile, s):
    """Padding tokens whose ids match no key (queries -7, keys -8): their O
    rows are 0 and the pad keys' dK and dV exactly 0, on both routes."""
    rng = np.random.default_rng(s)
    real = s - 28
    q_ids = torch.tensor([[0] * real + [-7] * 28], dtype=torch.int32)
    kv_ids = torch.tensor([[0] * real + [-8] * 28], dtype=torch.int32)
    q, k, v, w = (_randn(rng, 1, 2, s, 64).to(dtype).to(cuda) for _ in range(4))
    for bs in (None, SPLIT):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = attention.flash_attention(*ts, q_segment_ids=q_ids.to(cuda),
                                      kv_segment_ids=kv_ids.to(cuda),
                                      tile_dtype=tile, block_sizes=bs)
        dq, dk, dv = torch.autograd.grad((o.float() * w.float()).sum(), ts)
        assert bool((o[:, :, real:] == 0).all())
        assert bool((dk[:, :, real:] == 0).all()) and bool((dv[:, :, real:] == 0).all())
        assert bool((dq[:, :, real:] == 0).all())
        for t in (o, dq, dk, dv):
            assert bool(torch.isfinite(t.float()).all())


@MASKED_VARIANTS
@pytest.mark.parametrize("s,window,sinks,blocks,fused", [
    (1024, 128, 0, None, False),   # narrow, no sinks: the split pair
    (1024, 512, 4, None, True),    # sinks: the fused B2
    (1024, 600, 0, None, True),    # 2 * window >= S: fused
    (2048, 512, 4, "split", False),  # 16 KV slices of 128 rows: split
], ids=str)
def test_windowed_autograd_matches_plain(cuda, dtype, tile, s, window, sinks,
                                         blocks, fused):
    """torch.autograd.grad of flash_attention with a window on the card
    against the same call on the CPU, on the route the rule picks."""
    rng = np.random.default_rng(window + sinks)
    q = _randn(rng, 1, 4, s, 64).to(dtype)
    k, v = (_randn(rng, 1, 2, s, 64).to(dtype) for _ in range(2))
    w = _randn(rng, 1, 4, s, 64)
    bs = SPLIT if blocks == "split" else None
    names = ("fa2_backward_fused_window", "fa2_backward_dq_window",
             "fa2_backward_dkv_window")
    grads, moved = {}, {}
    for dev in ("cuda", "cpu"):
        ts = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        before = tuple(LAUNCHES[n] for n in names)
        o = attention.flash_attention(*ts, causal=True, window=window, sinks=sinks,
                                      tile_dtype=tile, block_sizes=bs)
        grads[dev] = torch.autograd.grad((o.float() * w.to(dev)).sum(), ts)
        moved[dev] = tuple(LAUNCHES[n] - b for n, b in zip(names, before))
    assert moved["cpu"] == (0, 0, 0)
    assert moved["cuda"] == ((1, 0, 0) if fused else (0, 1, 1))
    tol = 5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(got, want) <= tol


# ---------------------------------------------------------------------------
# Head dims 32 and 256: B1 (every tile body and mask), B5 and B6 (every
# cache the kernels take there, both compute types, the split and both tile
# bodies), against their plain versions; B7 with a window and segment ids;
# B7-B10 at D 32 and 256, and a width outside the registry refused.
# Tolerances as above.
# ---------------------------------------------------------------------------

WIDE_CACHES = [torch.bfloat16, torch.int8, torch.float8_e4m3fn, "int4"]


@FWD_VARIANTS
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("b,hq,hkv,s,causal", [
    (2, 16, 8, 100, True), (1, 4, 2, 2048, True), (1, 4, 2, 1000, False),
    (2, 4, 2, 16, True), (2, 4, 4, 128, False),
])
def test_fa2_forward_head_dims_match_plain(cuda, dtype, tile, d, b, hq, hkv, s, causal):
    """Through the API: B1, or B8 where one tile of Hq = Hkv takes it (S
    128 here), as in JAX at every head dim."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for h in (hq, hkv, hkv))
    name = "fa2_forward_small" if (s, hq) == (128, hkv) else "fa2_forward"
    before = (LAUNCHES[name], LAUNCHES[f"{name}_d{d}"])
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile)
    assert (LAUNCHES[name], LAUNCHES[f"{name}_d{d}"]) == (before[0] + 1, before[1] + 1)
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile)
    bf16 = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if bf16 else 2e-6), err
    assert lse_err <= (1e-3 if bf16 else 1e-5), lse_err


@FWD_VARIANTS
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("mask", ["window 128 sinks 4", "band -100", "4 documents"])
def test_fa2_forward_head_dims_masked_match_plain(cuda, dtype, tile, d, mask):
    """A window with sinks, a non-causal band (rows with no key: lse bit for
    bit) and 4 packed documents a row, at B2 Hq8 Hkv4 S640."""
    rng = np.random.default_rng(d)
    b, hq, hkv, s = 2, 8, 4, 640
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for h in (hq, hkv, hkv))
    kw = dict(causal=True, tile_dtype=tile)
    if mask.startswith("window"):
        kw.update(window=128, sinks=4)
    elif mask.startswith("band"):
        kw.update(causal=False, window=-100)
    else:
        ids = torch.from_numpy(np.sort(rng.integers(0, 4, (b, s)), axis=1).astype(np.int32))
        kw.update(q_segment_ids=ids, kv_segment_ids=ids)
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda),
        **{n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()})
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    tol = 2e-6 if (tile or dtype) == torch.float32 else 2e-2
    assert (o_k.float() - o_p.float()).abs().max().item() <= tol
    dead = lse_p < -1e30
    assert torch.equal(lse_k[dead], lse_p[dead])
    assert bool(dead.any()) == mask.startswith("band")
    live = ((lse_k - lse_p).abs() / lse_p.abs().clamp_min(1.0))[~dead]
    assert live.max().item() <= (1e-5 if tol == 2e-6 else 1e-3)


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("cache", WIDE_CACHES + [torch.float32], ids=str)
@pytest.mark.parametrize("chunk,group", [(1, 2), (1, 8), (5, 2), (512, 2)], ids=str)
@pytest.mark.parametrize("window", [None, 128], ids=str)
@pytest.mark.parametrize("d", [32, 256])
def test_paged_head_dims_match_plain(cuda, d, window, chunk, group, cache, compute):
    """B5 (chunk 1) and B6 (T 5: the split body; T 512: the bf16 and fp32
    tile bodies) at D 32 and 256, globally and under window 128 with 4
    sinks, every cache (at D 256 an fp32 cache's V lands over K in B5 and
    the split body, and the bf16 tile body stages 32 tokens at a time)."""
    q, pages, table, lengths = _b6_problem(cache, d, group, chunk, compute,
                                           _b6_lengths(chunk), 12)
    kw = dict(compute_dtype=compute)
    if window is not None:
        kw.update(window=window, sinks=4)
    if chunk == 1:
        q = q[:, 0].contiguous()
        fn, plain, name = (dec_attention.paged_decode_attention,
                           dec_attention.paged_decode_attention_plain, "paged_decode")
    else:
        fn, plain, name = (dec_attention.paged_chunk_attention,
                           dec_attention.paged_chunk_attention_plain, "paged_chunk")
    before = LAUNCHES[f"{name}_d{d}"]
    o_k = fn(q, pages, table, lengths, **kw)
    assert LAUNCHES[f"{name}_d{d}"] == before + 1
    o_p = plain(q, pages, table, lengths, sm_scale=d ** -0.5, **kw)
    torch.cuda.synchronize()
    assert o_k.dtype == compute and not o_k[0].any()
    assert torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("chunk", [1, 5, 33, 512])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("window,sinks", [(None, 0), (128, 4), (300, 0)], ids=str)
def test_paged_fp32_cache_d256_matches_plain(cuda, window, sinks, group, chunk, compute):
    """B5 and B6's three bodies on an fp32 cache at D 256 (T 1: B5; T 5 and
    33: the split body below 64 rows, the tile bodies above; T 512: the tile
    bodies) against their plain versions at groups 1, 2 and 8, globally,
    under window 128 with 4 sinks and under window 300, on lengths at a
    page's and a split's edges and an inactive slot; fp32 compute within
    2e-5, bf16 within 2e-2."""
    q, pages, table, lengths = _b6_problem(torch.float32, 256, group, chunk, compute,
                                           _b6_lengths(chunk), 12)
    kw = dict(compute_dtype=compute)
    if window is not None:
        kw.update(window=window, sinks=sinks)
    if chunk == 1:
        q = q[:, 0].contiguous()
        fn, plain, name = (dec_attention.paged_decode_attention,
                           dec_attention.paged_decode_attention_plain, "paged_decode")
    else:
        fn, plain, name = (dec_attention.paged_chunk_attention,
                           dec_attention.paged_chunk_attention_plain, "paged_chunk")
    before = LAUNCHES[f"{name}_d256"]
    o_k = fn(q, pages, table, lengths, **kw)
    assert LAUNCHES[f"{name}_d256"] == before + 1
    o_p = plain(q, pages, table, lengths, sm_scale=256 ** -0.5, **kw)
    torch.cuda.synchronize()
    assert not o_k[0].any() and torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.mark.parametrize("storage", QUANT_STORAGE, ids=str)
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask", ["window 160", "2 segments", "band -10",
                                  "window ids dead"])
def test_fa2_forward_quant_masks_match_plain(cuda, storage, q_dtype, compute, d, mask):
    """B7 with a causal window (the JAX test's 160), two segments, a band
    over Sq 300 > Skv 150 (rows whose Q tile runs no KV tile: -inf) and a
    window with ids no key carries (dead rows: O 0, lse bit for bit)."""
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
    from cuda_flash_attention_tpu_torch.quant import quantize_kv

    rng = np.random.default_rng(d + len(mask))
    b, hq, hkv, sq, skv = 2, 8, 4, 512, 512
    if mask.startswith("band"):
        sq, skv = 300, 150
    q = _randn(rng, b, hq, sq, d).to(q_dtype)
    k_q, v_q = quantize_kv(_randn(rng, b, hkv, skv, d), _randn(rng, b, hkv, skv, d),
                           storage)
    kw = dict(causal=True, compute_dtype=compute)
    if mask == "window 160":
        kw.update(window=160)
    elif mask == "2 segments":
        ids = torch.cat([torch.zeros(b, 256), torch.ones(b, 256)], 1).int()
        kw.update(q_segment_ids=ids, kv_segment_ids=ids)
    elif mask.startswith("band"):
        kw.update(causal=False, window=-10, block_q=128, block_k=128)
    else:
        ids = torch.from_numpy(np.sort(rng.integers(0, 3, (b, sq)), axis=1).astype(np.int32))
        q_ids = ids.clone()
        q_ids[:, 60:90] = 5
        kw.update(window=48, q_segment_ids=q_ids, kv_segment_ids=ids)
    on = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    to = lambda t: dataclasses.replace(t, values=t.values.to(cuda),  # noqa: E731
                                       scales=t.scales.to(cuda))
    before = LAUNCHES["fa2_forward_quant"]
    o_k, lse_k = fq.flash_attention_quantized_kv_with_lse(q.to(cuda), to(k_q), to(v_q), **on)
    assert LAUNCHES["fa2_forward_quant"] == before + 1
    o_p, lse_p = fq.flash_attention_quantized_kv_with_lse(q, k_q, v_q, **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    if compute == torch.bfloat16:
        assert _bf16_excess(o_k, o_p) <= BF16_ATOL["B7"]
    else:
        assert (o_k - o_p).abs().max().item() <= 2e-5
    dead = lse_p < -1e30
    assert torch.equal(lse_k[dead], lse_p[dead]) and not o_k[dead].any()
    assert bool(dead.any()) == (mask in ("band -10", "window ids dead"))
    lse_err = (lse_k - lse_p).abs()[~dead]
    if compute == torch.bfloat16:
        lse_err = lse_err / lse_p.abs()[~dead].clamp_min(1.0)
    assert lse_err.max().item() <= (1e-3 if compute == torch.bfloat16 else 1e-5)


# ---------------------------------------------------------------------------
# B2, B3 and B4 at head dims 32 and 256 (chip_smoke.py phase 29 holds them
# at the training shapes): every input and tile type, causal, a window with
# sinks, a band whose last rows keep no key and segment ids, Sq != Skv both
# ways, kv_len inside the last tile and GQA 16/2, each against the plain
# backward on the CPU; each launch counted under `<name>_d32` or
# `<name>_d256`; fp16 tiles on fp32 inputs held to FP16_BWD_TOL with the
# bf16 instantiation failing it; dQ of a row that keeps no key exactly 0.
# ---------------------------------------------------------------------------
WIDE_BWD_CASES = pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,causal,window,sinks,n_seg", [
        (1, 4, 2, 1000, 1000, True, None, 0, 0),   # kv_len inside the last tile
        (1, 4, 2, 300, 100, True, None, 0, 0),     # Sq > Skv
        (1, 4, 2, 128, 384, False, None, 0, 0),    # Sq < Skv
        (1, 16, 2, 384, 384, True, None, 0, 0),    # GQA 16/2
        (1, 4, 2, 512, 512, True, 100, 4, 0),      # a window with sinks
        (2, 4, 2, 512, 512, False, -100, 0, 0),    # a band: rows with no key
        (2, 4, 2, 512, 512, True, None, 0, 3),     # packed documents
        (1, 4, 2, 300, 500, True, None, 0, 2),     # ids with Sq != Skv
    ], ids=str)
BWD_NAMES = ("fa2_backward_fused", "fa2_backward_dq", "fa2_backward_dkv")


def _wide_outputs(g, kw):
    """(B2's dQ, dK, dV, B3's dQ, B4's dK, dV) on the card."""
    split = (g["q"], g["k"], g["v"], g["do"], g["lse"], g["di"])
    return (*fa2_backward.fa2_backward_fused_aligned(
        g["q"], g["k"], g["v"], g["o"], g["do"], g["lse"], **kw),
        fa2_backward.fa2_backward_dq_aligned(*split, **kw),
        *fa2_backward.fa2_backward_dkv_aligned(*split, **kw))


@BWD_VARIANTS
@pytest.mark.parametrize("d", [32, 256])
@WIDE_BWD_CASES
def test_backward_head_dims_match_plain(cuda, dtype, tile, d, b, hq, hkv, sq, skv,
                                        causal, window, sinks, n_seg):
    x, kw = _masked_problem(dtype, tile, d, b, hq, hkv, sq, skv, causal, window,
                            sinks, n_seg, seed=sq + skv + d)
    g, gkw = _to(x, kw, cuda)
    before = [LAUNCHES[f"{n}_d{d}"] for n in BWD_NAMES]
    got = _wide_outputs(g, gkw)
    torch.cuda.synchronize()
    assert [LAUNCHES[f"{n}_d{d}"] for n in BWD_NAMES] == [n + 1 for n in before]
    plain = fa2_backward.fa2_backward_fused_plain(
        x["q"], x["k"], x["v"], x["o"], x["do"], x["lse"], **kw)
    want = plain + plain
    fp16_gate = tile == torch.float16 and dtype == torch.float32
    tol = (FP16_BWD_TOL if fp16_gate else
           5e-2 if (tile is not None or dtype == torch.bfloat16) else 2e-5)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert bool(torch.isfinite(a.float()).all())
        assert _rel_err(a, w) <= tol
    if fp16_gate:
        control = _wide_outputs(g, dict(gkw, tile_dtype=torch.bfloat16))
        assert max(_rel_err(c, w) for c, w in zip(control, want)) > tol
    dead = x["lse"] < -1e30
    if dead.any():
        for dq in (got[0], got[3]):
            assert bool((dq.cpu()[dead] == 0).all())


@pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float16),
    (torch.float32, None)], ids=["bf16", "fp32-in-fp16-tiles", "fp32"])
@pytest.mark.parametrize("masked", [False, True], ids=["causal", "w128-s4-3-documents"])
def test_backward_d256_bitwise_deterministic(cuda, dtype, tile, masked):
    """Two runs of B2, B3 and B4 at D 256 (B1 Hq8 Hkv2 S2048) give the same
    bits: each dQ slice has one writer, the reduce adds in KV-tile order,
    and no block adds into another's output."""
    window, sinks, n_seg = (128, 4, 3) if masked else (None, 0, 0)
    x, kw = _masked_problem(dtype, tile, 256, 1, 8, 2, 2048, 2048, True, window,
                            sinks, n_seg, seed=256)
    g, gkw = _to(x, kw, cuda)
    for a, r in zip(_wide_outputs(g, gkw), _wide_outputs(g, gkw)):
        assert torch.equal(a, r)


@pytest.mark.parametrize("dtype,tile", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, None)], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [32, 256])
def test_fused_reduce_reads_no_dead_slice_at_d32_d256(cuda, dtype, tile, d):
    """As test_fa2_backward_fused_reads_no_dead_slice with the head dim's
    own dQ slices (64 KV rows at D 256 with bf16 tiles): a NaN-filled
    tensor of dq_part's size freed just before the call; causal, kv_len
    inside the last KV tile."""
    x, kw = _fused_problem(dtype, tile, d, 1, 4, 2, 1000, 1000, True, seed=5)
    q, k = x[0], x[1]
    n_slices = -(-k.shape[2] // fa2_backward.fused_kv_tile(q.dtype, tile, d))
    assert n_slices == (16 if tile is None or d == 256 else 8)
    bait = torch.full((q.shape[0], q.shape[1], n_slices) + q.shape[2:],
                      float("nan"), device=cuda)
    del bait
    got = fa2_backward.fa2_backward_fused_aligned(*x, **kw)
    torch.cuda.synchronize()
    want = fa2_backward.fa2_backward_fused_plain(*x, **kw)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= (2e-5 if tile is None else 5e-2)


# B7, B8, B9 and B10 at head dims 32 and 256 (chip_smoke phase 31's cases
# at small sizes): each from its own library, counted under `<name>_d32` or
# `<name>_d256` besides its name.
@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("b,h,sq,skv,kv_len", [
    (1, 2, 100, 100, 100), (2, 4, 256, 256, 200), (1, 1, 1000, 1000, 1000),
    (1, 2, 304, 128, 100), (17, 8, 128, 192, 150)])
def test_baseline_kernels_at_d32_d256_match_plain(cuda, which, d, b, h, sq, skv, kv_len):
    """B9 (one group of 128 threads at D 256) and B10 (P V a 64-column
    quarter at a time at D 256; two O columns a thread at D 32) against
    their plain versions within 1e-5, through the aligned entry points."""
    rng = np.random.default_rng(sq + skv + d)
    q = _randn(rng, b, h, sq, d).to(cuda)
    k, v = (_randn(rng, b, h, skv, d).to(cuda) for _ in range(2))
    kw = dict(sm_scale=d ** -0.5, kv_len=kv_len)
    before = (LAUNCHES[which], LAUNCHES[f"{which}_d{d}"])
    o_k = getattr(baselines, f"{which}_aligned")(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES[which], LAUNCHES[f"{which}_d{d}"]) == (before[0] + 1, before[1] + 1)
    o_p = getattr(baselines, f"{which}_plain")(q, k, v, **kw)
    assert (o_k - o_p).abs().max().item() <= 1e-5


@FWD_VARIANTS
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("b,h,s", [(1, 1, 128), (8, 16, 100), (8, 16, 32)],
                         ids=["Small-1", "Edge-NonPowerOf2", "Edge-SmallSeq"])
@pytest.mark.parametrize("mask", ["full", "causal", "window 24 sinks 2", "2 segments"])
def test_fa2_forward_small_at_d32_d256_matches_plain(cuda, dtype, tile, d, b, h, s, mask):
    """B8 through the public API at the suite's small configs: the route
    takes B8 at every head dim, as JAX's; O and lse against the plain
    version (2e-2 and 1e-3 relative with 16-bit tiles or inputs, 2e-6 and
    1e-5 in fp32)."""
    rng = np.random.default_rng(s + d + len(mask))
    q, k, v = (_randn(rng, b, h, s, d).to(dtype) for _ in range(3))
    kw = dict(tile_dtype=tile, causal=mask != "full")
    if mask.startswith("window"):
        kw.update(window=24, sinks=2)
    elif mask == "2 segments":
        ids = (torch.arange(s) * 2 // s).int().expand(b, s).contiguous()
        kw.update(q_segment_ids=ids, kv_segment_ids=ids)
    on = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    names = ("fa2_forward", "fa2_forward_small", f"fa2_forward_small_d{d}")
    before = [LAUNCHES[n] for n in names]
    o_k, lse_k = attention.flash_attention_with_lse(q.to(cuda), k.to(cuda), v.to(cuda),
                                                    **on)
    torch.cuda.synchronize()
    assert [LAUNCHES[n] for n in names] == [before[0], before[1] + 1, before[2] + 1]
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, **kw)
    low = tile is not None or dtype == torch.bfloat16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    lse_err = ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item()
    assert err <= (2e-2 if low else 2e-6), err
    assert lse_err <= (1e-3 if low else 1e-5), lse_err


@pytest.mark.parametrize("storage", QUANT_STORAGE, ids=str)
@pytest.mark.parametrize("q_dtype,compute", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16),
], ids=["bf16", "fp32", "fp32-q-bf16-compute"])
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("mask", ["causal", "full", "window 160", "2 segments"])
@pytest.mark.parametrize("b,hq,hkv,s", [(2, 8, 4, 512), (1, 4, 2, 200)])
def test_fa2_forward_quant_at_d32_d256_matches_plain(cuda, storage, q_dtype, compute,
                                                     d, mask, b, hq, hkv, s):
    """B7 through the public API at D 32 (64-byte rows, m64n32k16 P V) and
    D 256 (64-row KV stages, P V in two n128 halves; the fp32 body on one
    byte stage), S 200 ending inside the last tile: the bf16 gate of phase
    19 (fp32 2e-5), lse 1e-3 relative (1e-5)."""
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
    from cuda_flash_attention_tpu_torch.quant import quantize_kv

    rng = np.random.default_rng(d + s + len(mask))
    q = _randn(rng, b, hq, s, d).to(q_dtype)
    k_q, v_q = quantize_kv(_randn(rng, b, hkv, s, d), _randn(rng, b, hkv, s, d), storage)
    kw = dict(causal=mask != "full", compute_dtype=compute)
    if mask == "window 160":
        kw.update(window=160)
    elif mask == "2 segments":
        ids = (torch.arange(s) * 2 // s).int().expand(b, s).contiguous()
        kw.update(q_segment_ids=ids, kv_segment_ids=ids)
    on = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    to = lambda t: dataclasses.replace(t, values=t.values.to(cuda),  # noqa: E731
                                       scales=t.scales.to(cuda))
    before = LAUNCHES[f"fa2_forward_quant_d{d}"]
    o_k, lse_k = fq.flash_attention_quantized_kv_with_lse(q.to(cuda), to(k_q), to(v_q), **on)
    torch.cuda.synchronize()
    assert LAUNCHES[f"fa2_forward_quant_d{d}"] == before + 1
    o_p, lse_p = fq.flash_attention_quantized_kv_with_lse(q, k_q, v_q, **kw)
    o_k, lse_k = o_k.cpu(), lse_k.cpu()
    assert o_k.dtype == q_dtype and o_k.shape == q.shape
    bf16 = compute == torch.bfloat16
    if bf16:
        assert _bf16_excess(o_k, o_p) <= BF16_ATOL["B7"]
    else:
        assert (o_k - o_p).abs().max().item() <= 2e-5
    lse_err = (lse_k - lse_p).abs() / (lse_p.abs().clamp_min(1.0) if bf16 else 1.0)
    assert lse_err.max().item() <= (1e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("kernel", ["b7", "b8", "b9", "b10"])
def test_kernels_refuse_a_width_outside_the_registry(cuda, kernel):
    """B7, B8, B9 and B10 take head dims 32, 64, 128 and 256: at D 48 each
    raises on a CUDA tensor and launches nothing, falling back to nothing."""
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq

    d = 48
    x = torch.zeros(1, 2, 128, d, device=cuda)
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError, match="head_dim 48 not in"):
        if kernel == "b7":
            k = torch.zeros(1, 2, 128, d, dtype=torch.int8, device=cuda)
            sc = torch.ones(1, 2, 128, device=cuda)
            fq.fa2_forward_quant_aligned(x, k, sc, k, sc, causal=False, sm_scale=0.125,
                                         kv_len=128)
        elif kernel == "b8":
            fa2_forward.fa2_forward_small_aligned(x, x, x, causal=False, sm_scale=0.125,
                                                  kv_len=128)
        elif kernel == "b9":
            baselines.fa1_aligned(x, x, x, sm_scale=0.125, kv_len=128)
        else:
            baselines.naive_fa2_aligned(x, x, x, sm_scale=0.125, kv_len=128)
    assert dict(LAUNCHES) == before



def test_profile_ops_records_the_port_kernels_on_the_card(cuda):
    """utils/profiling on the card: B1 through the public API and a matmul
    under torch.profiler give nonzero device time by kernel name (B1's
    fa2_fwd kernel and cuBLAS's), counted once a call; kernel_device_time
    with a match keeps only B1's."""
    from cuda_flash_attention_tpu_torch.utils import profiling

    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, 4, 512, 64, generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    w = torch.randn(512, 512, generator=gen, device=cuda)

    def step(q, k, v, w):
        return attention.flash_attention(q, k, v, causal=True), w @ w

    ops = profiling.profile_ops(step, q, k, v, w, iters=3, warmup=1)
    assert ops and all(o.total_ms >= 0 for o in ops) and sum(o.total_ms for o in ops) > 0
    b1 = [o for o in ops if "fa2_fwd" in o.name]
    assert b1 and sum(o.count for o in b1) == 3, [o.name for o in ops]
    assert any(o.count >= 3 and o.total_ms > 0 for o in ops if "fa2_fwd" not in o.name)
    t = profiling.trace(step, q, k, v, w, iters=2, warmup=0)
    assert t.device.startswith("cuda") and t.busy_ms > 0 and t.wall_ms > 0
    assert any(op for _, _, op in t.top(5)), t.sources
    only_b1 = profiling.kernel_device_time(step, q, k, v, w, match="fa2_fwd", iters=3)
    whole = profiling.kernel_device_time(step, q, k, v, w, iters=3)
    assert 0 < only_b1 < whole
    assert "h100" not in profiling.chip_peaks(cuda).name.lower() or (
        profiling.chip_peaks(cuda).bf16_tflops == 989.0)


@pytest.mark.parametrize("hq,hkv,slots", [(8, 2, 8), (16, 4, 4)], ids=["tp4", "dp2-tp2"])
@pytest.mark.parametrize("cache", [torch.int8, torch.float32], ids=str)
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("chunk", [0, 3, 128], ids=["B5", "B6-T3", "B6-T128"])
def test_paged_kernels_at_llama3_head_local_shapes(cuda, hq, hkv, slots, cache,
                                                   compute, chunk):
    """B5 (chunk 0) and B6 on one rank's block of Llama-3-8B's serving on a
    mesh (Hq 32, Hkv 8, D 128; decode/sharded.py): tp 4 leaves a rank 8
    query heads on 2 KV heads of every slot; dp 2 x tp 2 16 on 4 of its
    data shard's 4 slots, over its half of the page pool.  Ragged lengths
    with an inactive slot."""
    rng = np.random.default_rng(hq + chunk)
    lengths = torch.tensor([300, 37, 0, 777, 5, 129, 1, 128][:slots],
                           dtype=torch.int32) + chunk * (torch.arange(slots) != 2)
    pps = -(-int(lengths.max()) // 128)
    num_pages = slots * pps + 1
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(
        np.int32)).reshape(slots, pps)
    pages = kv_cache.init_kv_pages(hkv, num_pages, 128, 128, cache, device="cpu")
    for slot in range(slots):
        kv_cache.write_prompt_kv(pages, _randn(rng, pps * 128, hkv, 128),
                                 _randn(rng, pps * 128, hkv, 128), table[slot])
    pages = kv_cache.KVPages(*(t.to(cuda) for t in (
        pages.k_pages, pages.k_scales, pages.v_pages, pages.v_scales)))
    q_dtype = torch.bfloat16 if compute == torch.bfloat16 else torch.float32
    q = _randn(rng, slots, max(chunk, 1), hq, 128).to(q_dtype).to(cuda)
    table, lengths = table.to(cuda), lengths.to(torch.int32).to(cuda)
    name = "paged_decode" if chunk == 0 else "paged_chunk"
    before = LAUNCHES[name]
    if chunk == 0:
        o_k = dec_attention.paged_decode_attention(q[:, 0], pages, table, lengths,
                                                   compute_dtype=compute)[:, None]
    else:
        o_k = dec_attention.paged_chunk_attention(q, pages, table, lengths,
                                                  compute_dtype=compute)
    assert LAUNCHES[name] == before + 1
    o_p = dec_attention.paged_chunk_attention_plain(
        q, pages, table, lengths, sm_scale=128 ** -0.5, compute_dtype=compute)
    torch.cuda.synchronize()
    assert not o_k[2].any() and torch.isfinite(o_k.float()).all()
    err = (o_k.float() - o_p.float()).abs().max().item()
    assert err <= (2e-2 if compute == torch.bfloat16 else 2e-5), err


@pytest.fixture
def nccl_world1(cuda):
    """A world-1 NCCL process group on the card for the test's duration
    (address tcp://localhost at a free port)."""
    import socket

    import torch.distributed as dist

    if not dist.is_nccl_available():
        pytest.skip("needs NCCL")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_pp_step_on_world1_nccl_mesh_equals_unsharded(cuda, nccl_world1):
    """make_pp_train_step on a world-1 NCCL {pipe 1} mesh (one stage, one
    microbatch: no transfer, every sum over "pipe" the identity) against
    the same SGD-momentum step written out on the unsharded model
    (transformer.forward over all S tokens, JAX make_pp_loss_fn's NLL):
    the loss and every parameter and momentum leaf bitwise equal, B1 and
    B2 (or B3 + B4) launched."""
    from cuda_flash_attention_tpu_torch.models import pipeline, transformer
    from cuda_flash_attention_tpu_torch.parallel.mesh import make_device_mesh

    cfg = TransformerConfig(vocab_size=4096, d_model=512, n_layers=4, n_heads=8,
                            n_kv_heads=4, head_dim=64, d_ff=1024)
    params = init_params(torch.Generator(device="cuda").manual_seed(24), cfg,
                         device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (2, 257))).cuda()
    mesh = make_device_mesh({"pipe": 1}, device="cuda")
    stage = pipeline.shard_pipeline_params(
        pipeline.stack_pipeline_params(params, 1), mesh)
    step = pipeline.make_pp_train_step(cfg, mesh, 1, 1, learning_rate=1e-3)
    before = {n: LAUNCHES[n] for n in ("fa2_forward", "fa2_backward_fused",
                                       "fa2_backward_dq")}
    got, got_opt, got_loss = step(stage, transformer.init_opt_state(stage), tokens)
    launched = {n: LAUNCHES[n] - v for n, v in before.items()}

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    wrt = transformer.tree_map(lambda _: next(it), params)
    logits = transformer.forward(wrt, tokens, cfg)[:, :-1]
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, tokens[:, 1:, None])[..., 0]
    loss = nll.sum() / (2 * 256) + cfg.router_aux_coef * torch.zeros((), device="cuda")
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    opt = transformer.tree_map(lambda p: 0.9 * torch.zeros_like(p, dtype=torch.float32)
                               + next(it).float(), params)
    want = transformer.tree_map(lambda p, m: (p - 1e-3 * m).to(p.dtype), params, opt)
    torch.cuda.synchronize()
    assert torch.equal(got_loss, loss.detach())
    for k in ("embed", "final_norm", "lm_head"):  # the one stage holds them all
        assert torch.equal(got[k], want[k]), k
    for i, layer in enumerate(want["layers"]):
        for k, v in layer.items():
            assert torch.equal(got["layers"][i][k], v), (i, k)
            assert torch.equal(got_opt["layers"][i][k], opt["layers"][i][k]), (i, k)
    assert launched["fa2_forward"] == 4
    assert launched["fa2_backward_fused"] + launched["fa2_backward_dq"] == 4


def test_ep_layer_on_world1_nccl_mesh_equals_unsharded(cuda, nccl_world1):
    """moe_ffn(mesh=) on a world-1 NCCL {data 1, expert 1, model 1} mesh
    (every gather and sum over an axis of size 1 the identity) against
    moe_ffn without a mesh, bf16 activations at 8 experts top 2 and a
    binding capacity: the output, the aux loss and the gradients of the
    input and of every weight bitwise equal."""
    from cuda_flash_attention_tpu_torch.models import moe
    from cuda_flash_attention_tpu_torch.parallel.mesh import make_device_mesh

    cfg = TransformerConfig(d_model=1024, d_ff=2048, n_experts=8, capacity_factor=1.0)
    layer = moe.init_moe_layer(torch.Generator().manual_seed(24), cfg, cuda)
    x = torch.randn(2, 256, 1024, generator=torch.Generator().manual_seed(25)).to(
        cuda, torch.bfloat16)
    mesh = make_device_mesh({"data": 1, "expert": 1, "model": 1}, device="cuda")
    dy = torch.randn(2, 256, 1024, generator=torch.Generator().manual_seed(26)).to(
        cuda, torch.bfloat16)
    outs = []
    for m in (None, mesh):
        h = x.clone().requires_grad_(True)
        w = {k: v.clone().requires_grad_(True) for k, v in layer.items()}
        y, aux = moe.moe_ffn(h, w, cfg, mesh=m)
        torch.autograd.backward([y, aux], [dy, torch.ones_like(aux)])
        outs.append([y.detach(), aux.detach(), h.grad,
                     *(w[k].grad for k in ("router", "moe_gate", "moe_up", "moe_down"))])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 16-bit inputs (fp16 in B1-B8, bf16 and fp16 in B9 and B10) and the
# autotune's tile variants.
# ---------------------------------------------------------------------------


def _step(t) -> float:
    """One step of t's 16-bit type at its largest |value| (0 for fp32)."""
    m = t.float().abs().max().item()
    bits = {torch.float16: 10, torch.bfloat16: 7}.get(t.dtype)
    return 0.0 if bits is None or m == 0 else 2.0 ** (np.floor(np.log2(m)) - bits)


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp16-tiles", "bf16-tiles"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,s,causal,window", [
    (1, 4, 2, 300, True, None), (2, 4, 4, 100, False, None),
    (1, 4, 2, 1000, True, 128), (1, 2, 1, 2048, False, None),
])
def test_fp16_inputs_forward_kernels_match_plain(cuda, tile, d, b, hq, hkv, s, causal,
                                                  window):
    """B1 (and B8 at S 100 with one KV head per query head) on fp16 inputs
    in fp16 and bf16 tiles: O in fp16, lse fp32, `_fp16in` launches."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_randn(rng, b, h, s, d).half() for h in (hq, hkv, hkv))
    name = "fa2_forward_small" if s <= 128 and hq == hkv else "fa2_forward"
    before = LAUNCHES[f"{name}_fp16in"]
    o_k, lse_k = attention.flash_attention_with_lse(
        q.to(cuda), k.to(cuda), v.to(cuda), causal=causal, tile_dtype=tile,
        window=window)
    assert LAUNCHES[f"{name}_fp16in"] == before + 1
    o_p, lse_p = attention.flash_attention_with_lse(q, k, v, causal=causal,
                                                    tile_dtype=tile, window=window)
    assert o_k.dtype == torch.float16 and lse_k.dtype == torch.float32
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    assert err <= 2e-2 + _step(o_p), err
    assert ((lse_k.cpu() - lse_p).abs() / lse_p.abs().clamp_min(1)).max().item() <= 1e-3


@pytest.mark.parametrize("tile", [None, torch.bfloat16], ids=["fp16-tiles", "bf16-tiles"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("route", ["fused", "split"])
def test_fp16_inputs_backward_kernels_match_plain(cuda, tile, d, route):
    """B2 (fused) and B3 + B4 (split: 128-row BlockSizes over 9 KV slices,
    S 1100 padded to 1152) on fp16 inputs, GQA 4/2, causal: fp16 gradients
    within 5e-2 of the plain ones' max, plus one fp16 step."""
    rng = np.random.default_rng(d + (route == "split"))
    q, do = (_randn(rng, 1, 4, 1100, d).half() for _ in range(2))
    k, v = (_randn(rng, 1, 2, 1100, d).half() for _ in range(2))
    blocks = BlockSizes(*[128] * 6) if route == "split" else None
    names = (["fa2_backward_fused"] if route == "fused"
             else ["fa2_backward_dq", "fa2_backward_dkv"])
    before = [LAUNCHES[f"{n}_fp16in"] for n in names]

    def grads(*xs):
        xs = [x.clone().requires_grad_() for x in xs[:3]] + [xs[3]]
        o = attention.flash_attention(*xs[:3], causal=True, tile_dtype=tile,
                                      block_sizes=blocks)
        return torch.autograd.grad((o.float() * xs[3].float()).sum(), xs[:3])

    got = grads(*(t.to(cuda) for t in (q, k, v, do)))
    assert [LAUNCHES[f"{n}_fp16in"] for n in names] == [x + 1 for x in before]
    want = grads(q, k, v, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float16
        err = (g.float().cpu() - w.float()).abs().max().item()
        assert err <= 5e-2 * w.float().abs().max().item() + _step(w), err


@pytest.mark.parametrize("storage", [torch.int8, torch.float8_e4m3fn, "int4"])
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_fp16_q_quantized_kernel_matches_plain(cuda, storage, compute, d):
    """B7 on fp16 q over 1-byte and packed int4 K/V: fp16 O."""
    from cuda_flash_attention_tpu_torch import quant
    from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq

    rng = np.random.default_rng(d)
    q = _randn(rng, 1, 4, 300, d).half()
    k_q, v_q = quant.quantize_kv(_randn(rng, 1, 2, 300, d), _randn(rng, 1, 2, 300, d),
                                 storage)
    before = LAUNCHES["fa2_forward_quant_fp16in"]
    o_k = fq.flash_attention_quantized_kv(
        q.to(cuda), *(dataclasses.replace(t, values=t.values.to(cuda),
                                          scales=t.scales.to(cuda)) for t in (k_q, v_q)),
        causal=True, compute_dtype=compute)
    assert LAUNCHES["fa2_forward_quant_fp16in"] == before + 1
    o_p = fq.flash_attention_quantized_kv(q, k_q, v_q, causal=True, compute_dtype=compute)
    assert o_k.dtype == torch.float16
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    tol = (2e-2 if compute == torch.bfloat16 else 2e-5) + _step(o_p)
    assert err <= tol, err


@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("s", [100, 256])
def test_16bit_inputs_baseline_kernels_match_plain(cuda, which, dtype, d, s):
    """B9 and B10 on bf16 and fp16 inputs: S in fp32, P rounded to the input
    type, O in it (FA1 re-rounded at every KV tile): within 1e-3 of the
    output's max plus one step of the type."""
    rng = np.random.default_rng(d + s)
    q, k, v = (torch.from_numpy(rng.random((2, 3, s, d), dtype=np.float32)).to(dtype)
               for _ in range(3))
    fn = getattr(baselines, f"{which}_attention")
    tag = "bf16" if dtype == torch.bfloat16 else "fp16"
    before = LAUNCHES[f"{which}_{tag}in"]
    o_k = fn(q.to(cuda), k.to(cuda), v.to(cuda))
    assert LAUNCHES[f"{which}_{tag}in"] == before + 1
    o_p = fn(q, k, v)
    assert o_k.dtype == dtype
    err = (o_k.float().cpu() - o_p.float()).abs().max().item()
    assert err <= 1e-3 * o_p.float().abs().max().item() + _step(o_p), err


@pytest.mark.parametrize("kernel", ["fwd", "fused", "dq", "dkv"])
@pytest.mark.parametrize("d", [64, 128])
def test_autotune_variants_match_the_shipped_tiles(cuda, kernel, d):
    """Every candidate tile shape that builds (bench/autotune.py), run from
    its own library, against the shipped tiles' output on the same inputs
    at the bf16 gates (B1 O 2e-2; B2's dQ, B3's dQ, B4's dK 5e-2 of the max);
    one whose build the source or ptxas refuses is a failed row with its
    reason, and a launch error fails (strict)."""
    from cuda_flash_attention_tpu_torch.bench import autotune

    rows = autotune.sweep(kernel, b=1, h=4, kv_heads=2, s=1024, d=d, tile=torch.bfloat16,
                          causal=True, iters=1, strict=True)
    ok = [r for r in rows if "error" not in r]
    assert any(r["default"] for r in ok)
    for r in ok:
        if kernel == "fwd":
            assert r["max_abs_diff"] <= 2e-2, r
        else:
            assert r["rel_diff"] <= 5e-2, r
    assert all(r["error"] for r in rows if r["ms"] == float("inf"))
