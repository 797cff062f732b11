"""Kernel B5's split-KV plan and its split-and-combine arithmetic, on the CPU.

The CUDA kernel (csrc/paged_decode.cu) walks each slot's pages in splits
that `decode_split_plan` picks from shapes alone, stores a partial (m, l,
acc) per split and folds the partials in split order.  Here the plan is
checked as a partition of the page table, and a plain PyTorch model of the
split-and-combine (this file's `split_model`, used by no other code) is held
to the plain version of B5 and to the JAX package's paged_decode_attention
(its Pallas kernel in interpret mode), on the same pages, at lengths on and
around page and split boundaries.  Tolerances: 2e-5 with fp32 compute and
2e-2 with bf16 compute (tests/test_torch_paged_decode.py).  Last, chip_smoke's
phase-1 ptxas gates on B5's instantiations and B8's fp32 body."""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.decode import attention as jax_attention
from cuda_flash_attention_tpu.decode import kv_cache as jax_kv
from cuda_flash_attention_tpu_torch.decode import attention, kv_cache
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    kv_storage_cast,
)

PAGE = 128
HKV, GROUP, D = 2, 2, 64
PPS = 4
# Lengths on and around the page and split edges, an inactive slot and a
# full table.
LENGTHS = [0, 1, 127, 128, 129, PPS * PAGE]
CACHES = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
          "int4": ("int4", "int4")}
COMPUTE = {"fp32": (jnp.float32, torch.float32, 2e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("num_seqs,n_kv,pps,sms", list(itertools.product(
    (1, 2, 8, 64, 257), (1, 2, 8), (1, 2, 7, 16, 64, 200), (1, 78, 132))))
def test_split_plan_partitions_the_page_table(num_seqs, n_kv, pps, sms):
    """Every page index falls in exactly one split, the splits run in order
    and none is empty; the grid reaches two blocks an SM wherever the page
    table allows (else one page a split)."""
    n = attention.decode_split_plan(num_seqs, n_kv, pps, sms)
    per = attention.split_pages(pps, n)
    assert 1 <= n <= pps
    splits = [list(range(s * per, min(pps, (s + 1) * per))) for s in range(n)]
    assert all(splits) and sum(splits, []) == list(range(pps))
    assert num_seqs * n_kv * n >= 2 * sms or n == pps


def test_split_plan_reads_shapes_only():
    """The plan takes four integers (no tensor, so no value of `lengths`):
    phase 3's shape (8 slots, 8 KV heads, 16 pages) on a 132-SM card gives
    six splits of three pages, 384 blocks."""
    params = inspect.signature(attention.decode_split_plan).parameters
    assert list(params) == ["num_seqs", "n_kv_heads", "pages_per_seq", "sm_count"]
    assert attention.decode_split_plan(8, 8, 16, 132) == 6
    assert attention.split_pages(16, 6) == 3
    # The long case: 8 slots of 64 pages, five splits of 13, 13, 13, 13, 12.
    assert attention.decode_split_plan(8, 8, 64, 132) == 5
    assert attention.split_pages(64, 5) == 13


def split_model(q, pages, table, lengths, *, sm_scale, compute_dtype, n_splits):
    """B5's split-and-combine in plain PyTorch: split s scores the slot's
    live tokens of pages [s p, (s + 1) p) with its own max m_s, l_s = sum
    of exp(s - m_s), acc_s = (P * v_scale, rounded to the compute dtype) V;
    the output folds the non-empty splits in split order with weights
    exp(m_s - M), M their largest m, as the kernel's last block does.  An
    empty slot gives zeros."""
    n, n_heads, d = q.shape
    hkv, _, page, _ = pages.k_pages.shape
    group = n_heads // hkv
    pps = table.shape[1]
    per = attention.split_pages(pps, n_splits)
    cols = torch.arange(pps * page)
    lengths = lengths.long()
    live = torch.arange(pps)[None, :] * page < lengths[:, None]
    ids = torch.where(live, table, 0).long()

    def gather(x):  # [Hkv, P, page, *] -> [n, Hkv, pps * page, *]
        g = x[:, ids]
        return g.transpose(0, 1).reshape(n, hkv, pps * page, *x.shape[3:])

    k = kv_storage_cast(gather(pages.k_pages), d, compute_dtype).float()
    v = kv_storage_cast(gather(pages.v_pages), d, compute_dtype).float()
    ks, vs = gather(pages.k_scales), gather(pages.v_scales)
    qf = q.reshape(n, hkv, group, d).to(compute_dtype).float()
    s_all = (qf @ k.transpose(-1, -2)) * (ks * sm_scale)[:, :, None, :]
    parts = []
    for s in range(n_splits):
        lo, hi = s * per * page, min(pps, (s + 1) * per) * page
        keep = ((cols >= lo) & (cols < hi))[None, :] & (cols[None, :] < lengths[:, None])
        keep = keep[:, None, None, :]                                # [n, 1, 1, L]
        sc = s_all + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = (p * vs[:, :, None, :]).to(compute_dtype).float() @ v
        parts.append((m, l, acc))
    big = torch.stack([torch.where(l > 0, m, float("-inf")) for m, l, _ in parts]).amax(0)
    num = torch.zeros(n, hkv, group, d)
    den = torch.zeros(n, hkv, group, 1)
    for m, l, acc in parts:  # in split order; empty splits add nothing
        f = torch.where(l > 0, torch.exp(m - big), 0.0)
        num = num + acc * f
        den = den + l * f
    out = num * torch.where(den == 0, 0.0, 1.0 / den)
    return out.reshape(n, n_heads, d).to(q.dtype)


def _setup(cache, seed):
    """The same cache contents in both packages, written through each
    package's own prompt writer from one numpy prompt per slot."""
    jdt, tdt = CACHES[cache]
    rng = np.random.default_rng(seed)
    n = len(LENGTHS)
    num_pages = n * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(n, PPS)
    pj = jax_kv.init_kv_pages(HKV, num_pages, PAGE, D, jdt)
    pt = kv_cache.init_kv_pages(HKV, num_pages, PAGE, D, tdt, device="cpu")
    for s in range(n):
        k = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, HKV, D)).astype(np.float32)
        pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    q = rng.standard_normal((n, HKV * GROUP, D)).astype(np.float32)
    return pj, pt, table, np.array(LENGTHS, np.int32), q


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("cache", list(CACHES))
def test_split_model_matches_plain_and_jax(cache, compute):
    """The model at one split a page, two splits and one split against the
    plain B5 (which takes each row whole) and the JAX kernel."""
    jc, tc, tol = COMPUTE[compute]
    pj, pt, table, lengths, q = _setup(cache, seed=len(cache) + len(compute))
    qt = torch.from_numpy(q).to(tc)
    args = (pt, torch.from_numpy(table), torch.from_numpy(lengths))
    plain = attention.paged_decode_attention(qt, *args, compute_dtype=tc)
    o_j = np.asarray(jax_attention.paged_decode_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(lengths),
        compute_dtype=jc).astype(jnp.float32))
    for n_splits in (PPS, 2, 1):
        got = split_model(qt, *args, sm_scale=D ** -0.5, compute_dtype=tc,
                          n_splits=n_splits)
        assert got.dtype == tc and got.shape == q.shape
        assert not got[0].any(), "an inactive slot (length 0) gives zeros"
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                                   atol=tol, rtol=0)
        np.testing.assert_allclose(got.float().numpy(), o_j, atol=tol, rtol=0)


def _ptxas_report(names, spill=0):
    """ptxas -v lines for kernels `names` (mangled), as nvcc prints them."""
    lines = []
    for name in names:
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  "ptxas info    : Used 135 registers, used 1 barriers"]
    return "\n".join(lines)


_B5_NS = "_ZN48_GLOBAL__N__89400caa_15_paged_decode_cu_0e274df8"
B5_ENTRIES = [f"{_B5_NS}19paged_decode_kernelI{tq}{tc}Li{d}ELi{g}EEEvPKT_PKT0_PKfS8_SA_"
              "PKiSC_PS3_PfPiiiiiifi"
              for tq in ("f", "13__nv_bfloat16")
              for tc in ("f", "13__nv_bfloat16", "a", "13__nv_fp8_e4m3",
                         "13__nv_fp8_e5m2", "NS_6Int4x2E")
              for d in (64, 128) for g in (2, 8)]
# B8's fp32 body at D 64 and 128, without and with segment ids.
B8_FP32_ENTRIES = [
    f"_ZN53_GLOBAL__N__77380a0a_20_fa2_forward_small_cu_a84d0c3f10small_fp32ILi{d}ELb{seg}EEEv"
    "PKfS2_S2_PfS3_PKiS5_iiiifiii" for d in (64, 128) for seg in (0, 1)]


def test_phase_1_gates_every_b5_and_b8_fp32_instantiation():
    """chip_smoke's phase 1 holds B5's 48 instantiations (six caches x two
    q types x D 64 and 128 x groups of at most 2 and 8) and B8's fp32 body
    at D 64 and 128, without and with segment ids: clean reports pass, one spilled byte or a missing
    instantiation fails."""
    import chip_smoke

    functions, count = chip_smoke.B5_FUNCTIONS
    assert count == len(B5_ENTRIES) == 48
    chip_smoke.check_ptxas(_ptxas_report(B5_ENTRIES), "B5", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_report(B5_ENTRIES[:47])
                               + "\n" + _ptxas_report(B5_ENTRIES[47:], spill=8),
                               "B5", functions, count)
    with pytest.raises(AssertionError, match="only 47"):
        chip_smoke.check_ptxas(_ptxas_report(B5_ENTRIES[1:]), "B5", functions, count)
    functions, count = chip_smoke.FP32_FUNCTIONS["fa2_forward_small"]
    assert count == len(B8_FP32_ENTRIES) == 4
    chip_smoke.check_ptxas(_ptxas_report(B8_FP32_ENTRIES), "fp32 block", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_report(B8_FP32_ENTRIES, spill=4), "fp32 block",
                               functions, count)
