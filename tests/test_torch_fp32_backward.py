"""What the fp32 bodies of B2, B3 and B4 (csrc/fa2_backward.cu on the FMA
block of csrc/fma_block.cuh) rest on, held on the CPU; the CUDA kernels
themselves are held to their plain versions on the card by
tests/test_torch_kernels_gpu.py.

- B2's and B4's walk (64-row KV tiles over 64-row Q tiles) and B3's (64-row
  Q tiles over 64-row KV tiles) against the element mask: a pair of tiles
  is walked exactly when it holds a live (row, key) pair.  That covers
  B4's causal start at the diagonal's tile, the KV tiles wholly past
  kv_len, and B3's stop at the diagonal and at kv_len.
- The prologue with fp32 tiles (fused_prologue_plain, tile_dtype fp32):
  Q_s, dO, K, V and lse * log2(e) are, to the bit, what the plain
  backward (_p_ds with fp32 tiles) uses; D_i is rowsum(dO * O) in fp32
  with O, the caller's own without it.
"""

import re

import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu_torch.kernels import attention, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.common import LOG2E, build_element_mask, cdiv
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain

WALK_SHAPES = pytest.mark.parametrize("sq,skv,kv_len,causal", [
    (2048, 2048, 2048, True), (2048, 2048, 2048, False), (384, 384, 300, True),
    (300, 128, 100, True), (128, 384, 384, True), (128, 384, 384, False),
    (256, 384, 200, True), (256, 384, 200, False), (112, 192, 130, True),
    (1008, 1008, 1000, False), (16, 16, 16, True), (112, 112, 112, True),
], ids=str)


def _live(sq, skv, kv_len, causal):
    """The element mask [sq, skv] (all live where nothing masks)."""
    mask = build_element_mask(sq, skv, causal=causal, kv_len=kv_len, device="cpu")
    return torch.ones(sq, skv, dtype=torch.bool) if mask is None else mask.expand(sq, skv)


@WALK_SHAPES
def test_fp32_kv_walk_follows_the_mask(sq, skv, kv_len, causal):
    """KV tile kt of B2's or B4's fp32 body walks Q tile qt exactly when
    the two 64-row tiles hold a live pair: under causal from the tile of
    the KV tile's first row, and nothing for a KV tile past kv_len."""
    live = _live(sq, skv, kv_len, causal)
    walks = fa2_backward.fused_live_q_tiles(sq, skv, kv_len, causal, 64, fp32=True)
    assert fa2_backward.fused_q_tile(128, fp32=True) == 64
    assert len(walks) == cdiv(skv, 64)
    for kt, walked in enumerate(walks):
        for qt in range(cdiv(sq, 64)):
            block = live[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64]
            assert (qt in walked) == bool(block.any()), (kt, qt)


@WALK_SHAPES
def test_fp32_dq_walk_follows_the_mask(sq, skv, kv_len, causal):
    """Q tile qt of B3's fp32 body walks KV tile kt exactly when the two
    64-row tiles hold a live pair: it stops at the diagonal's tile under
    causal and at kv_len."""
    live = _live(sq, skv, kv_len, causal)
    walks = fa2_backward.dq_kv_tiles(sq, kv_len, causal, 64, fp32=True)
    assert fa2_backward.dq_kv_tile(64, fp32=True) == 64
    assert len(walks) == cdiv(sq, 64)
    for qt, walked in enumerate(walks):
        for kt in range(cdiv(skv, 64)):
            block = live[qt * 64:(qt + 1) * 64, kt * 64:(kt + 1) * 64]
            assert (kt in walked) == bool(block.any()), (qt, kt)


def _problem(d, causal, seed=0):
    """Padded fp32 inputs as the autograd path builds them (GQA 4/2, S
    200): q, k, v, dO from numpy, O and lse from the plain forward."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 200, d), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 200, d), dtype=np.float32))
            for _ in range(2))
    q, k, v, sm_scale, _, kv_len = attention._prepare(
        q, k, v, causal, None, None, None, None, None, 0)
    o, lse = fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_len=kv_len, tile_dtype=None)
    do = torch.nn.functional.pad(do, (0, 0, 0, q.shape[2] - 200))
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    return (q, k, v, o, do, lse), kw


@pytest.mark.parametrize("with_o", [True, False], ids=["B2", "B3-B4"])
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_prologue_forms_what_the_plain_backward_uses(d, with_o):
    """fp32 tiles: Q_s is Q times the fp32 value of sm_scale * log2(e), one
    fp32 multiply, and dO, K, V pass as they are, exactly as _p_ds forms
    them; lse * log2(e) is the fp32 product; D_i is the fused plain
    version's rowsum(dO * O) with O (B2) and the caller's without (B3,
    B4, here not that rowsum, so a fold would show)."""
    (q, k, v, o, do, lse), kw = _problem(d, causal=True, seed=d)
    di_in = torch.from_numpy(np.random.default_rng(1).standard_normal(
        lse.shape, dtype=np.float32))
    got = fa2_backward.fused_prologue_plain(
        q, k, v, o if with_o else None, do, lse, sm_scale=kw["sm_scale"],
        tile_dtype=torch.float32, di=None if with_o else di_in)
    _, _, qs, _, dos = fa2_backward._p_ds(q, k, v, do, lse, di_in, tile_dtype=None,
                                          **kw)
    assert all(t.dtype == torch.float32 for t in got)
    assert torch.equal(got[0], qs) and torch.equal(got[1], dos)
    assert torch.equal(got[2], k) and torch.equal(got[3], v)
    assert torch.equal(got[4], lse * LOG2E)
    if with_o:
        assert torch.equal(got[5], (do * o).sum(dim=-1))
    else:
        assert got[5] is di_in


def _ptxas_report(names, spill=0):
    """ptxas -v lines for kernels `names` (mangled), as nvcc prints them."""
    lines = []
    for name in names:
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  "ptxas info    : Used 206 registers, used 1 barriers"]
    return "\n".join(lines)


_NS = "_ZN48_GLOBAL__N__1480c6c9_15_fa2_backward_cu_d969567c"
FP32_ENTRIES = [f"{_NS}11bwd_kv_fp32ILi{d}ELb{f}EEEvPKfS2_S2_S2_S2_S2_PfS3_S3_iiiiiii"
                for d in (64, 128) for f in (0, 1)] + [
    f"{_NS}11bwd_dq_fp32ILi{d}EEEvPKfS2_S2_S2_S2_S2_Pfiiiiiifi" for d in (64, 128)] + [
    f"{_NS}12bwd_prologueIffLi{d}EEEvPKT_S3_S3_PKfS5_S3_S3_PT0_S7_S7_S7_PfS8_iiiif"
    for d in (64, 128)]
PROLOGUE_16 = [f"{_NS}12bwd_prologueIf13__nv_bfloat16Li64EEEvPKT_S4_S4_PKfS6_S4_S4_PT0_"
               "S8_S8_S8_PfS9_iiiif",
               f"{_NS}12bwd_prologueI13__nv_bfloat16S1_Li128EEEvPKT_S4_S4_PKfS6_S4_S4_"
               "PT0_S8_S8_S8_PfS9_iiiif"]


def test_ptxas_gates_count_the_fp32_backward_instantiations():
    """chip_smoke's phase 1 holds the eight fp32 backward instantiations
    (bwd_kv_fp32 at D 64 and 128 x FUSED, bwd_dq_fp32 and the fp32
    prologue at D 64 and 128): it passes them clean, fails on one spilled
    byte or a missing one, and B2's 16-bit prologue gate counts only the
    16-bit prologues."""
    import chip_smoke

    functions, count = chip_smoke.FP32_FUNCTIONS["fa2_backward"]
    assert count == len(FP32_ENTRIES) == 8
    chip_smoke.check_ptxas(_ptxas_report(FP32_ENTRIES), "fp32 block", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_report(FP32_ENTRIES[:7]) + "\n"
                               + _ptxas_report(FP32_ENTRIES[7:], spill=4),
                               "fp32 block", functions, count)
    with pytest.raises(AssertionError, match="only 7"):
        chip_smoke.check_ptxas(_ptxas_report(FP32_ENTRIES[1:]), "fp32 block",
                               functions, count)
    b2 = chip_smoke.BWD_FUNCTIONS["B2"][0]
    report = chip_smoke.ptxas_by_function(_ptxas_report(FP32_ENTRIES + PROLOGUE_16))
    matched = [fn for fn in report if any(re.search(k, fn) for k in b2)]
    assert matched == PROLOGUE_16
