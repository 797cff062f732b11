"""Kernel B6's split plan, its choice of body and its split-and-combine
arithmetic with per-row causal bounds, on the CPU.

The CUDA kernel (csrc/paged_chunk.cu) takes its split-KV body where a KV
head's T * group query rows fit one launch's row tiles (`chunk_body`, from
shapes alone), walks each slot's pages in the splits that
`chunk_split_plan` picks, stores a partial (m, l, acc) per split and row,
and folds the partials in split order, leaving out a row's partial with
l = 0 (a split can hold columns for some rows of the chunk and none for
others).  Here the plan is checked as a partition of the page table, and a
plain PyTorch model of the split-and-combine (this file's `split_model`,
used by no other code) is held to the plain version of B6 and to the JAX
package's paged_chunk_attention (its Pallas kernel in interpret mode), on
the same pages, at T 1, 2, 5 and 8 and groups 1, 2 and 8, with lengths
that put length - T on a page boundary, on a split boundary and just
before one, a slot of length T and an inactive slot.  Tolerances: 2e-5
with fp32 compute and 2e-2 with bf16 compute (tests/test_torch_paged_chunk.py).
Last, chip_smoke's phase-1 ptxas gates on B6's and X's new instantiations."""

import functools
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
D = 64
PPS = 4
CACHES = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
          "int4": ("int4", "int4")}
COMPUTE = {"fp32": (jnp.float32, torch.float32, 2e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
GROUPS = {1: 2, 2: 2, 8: 1}  # group -> KV heads
CHUNKS = (1, 2, 5, 8)


def lengths_for(chunk: int) -> list[int]:
    """An inactive slot, a slot of length T (the chunk is the whole slot),
    length - T at 126 (rows on both sides of page 1's start: at one page a
    split, split 1 holds columns for the chunk's last rows and none for its
    first), at 128 (a page boundary), at 254 (the same at two pages a
    split), at 256 (a split boundary at two pages a split), and a full
    table."""
    return [0, chunk, 126 + chunk, 128 + chunk, 254 + chunk, 256 + chunk, PPS * PAGE]


@pytest.mark.parametrize("num_seqs,n_kv,pps,chunk,group,sms", list(itertools.product(
    (1, 8, 64), (1, 8), (1, 7, 16, 64), (1, 5, 8, 512), (1, 2, 8), (78, 132))))
def test_split_plan_partitions_the_page_table(num_seqs, n_kv, pps, chunk, group, sms):
    """Every page index falls in exactly one split, the splits run in order
    and none is empty; the split body's grid of (split, slot, KV head, row
    tile) blocks reaches two blocks an SM wherever the page table allows
    (else one page a split); the tile bodies take one split."""
    n = attention.chunk_split_plan(num_seqs, n_kv, pps, chunk, group, sms)
    per = attention.split_pages(pps, n)
    assert 1 <= n <= pps
    splits = [list(range(s * per, min(pps, (s + 1) * per))) for s in range(n)]
    assert all(splits) and sum(splits, []) == list(range(pps))
    if attention.chunk_body(chunk, group) == "split":
        tiles = attention.chunk_row_tiles(chunk, group)
        assert (tiles - 1) * 16 < chunk * group <= tiles * 16
        assert num_seqs * n_kv * tiles * n >= 2 * sms or n == pps
    else:
        assert n == 1


def test_body_and_plan_read_shapes_only():
    """The body's choice takes (T, group) and the plan integers only (no
    tensor, so no value of `lengths`): speculation's verify (T 5 at the
    base model's group 2, and T 1 to 8 at group 8) takes the split body,
    chunked prefill and prefix suffixes (T 512, T 128) the tile bodies;
    phase 12's speculation shape (8 slots, 8 KV heads, 16 pages) on a
    132-SM card gives six splits of three pages, 384 blocks."""
    for fn in (attention.chunk_body, attention.chunk_row_tiles):
        assert list(inspect.signature(fn).parameters) == ["chunk", "group"]
    assert list(inspect.signature(attention.chunk_split_plan).parameters) == [
        "num_seqs", "n_kv_heads", "pages_per_seq", "chunk", "group", "sm_count"]
    assert [attention.chunk_body(t, 2) for t in (1, 5, 32, 33, 128, 512)] == [
        "split", "split", "split", "tiles", "tiles", "tiles"]
    assert [attention.chunk_body(t, 8) for t in (1, 5, 8, 9)] == [
        "split", "split", "split", "tiles"]
    assert attention.chunk_row_tiles(5, 2) == 1 and attention.chunk_row_tiles(4, 2) == 1
    assert attention.chunk_row_tiles(5, 8) == 3 and attention.chunk_row_tiles(8, 8) == 4
    assert attention.chunk_split_plan(8, 8, 16, 5, 2, 132) == 6
    assert attention.split_pages(16, 6) == 3
    assert attention.chunk_split_plan(4, 8, 16, 512, 2, 132) == 1


def test_body_rule_matches_the_kernels_constants():
    """chunk_body and chunk_row_tiles mirror csrc/paged_chunk.cu's
    kSplitRows and kRowTile, which pick the body and the row tile on the
    card: the two must agree, or the plan sizes the wrong grid."""
    import re
    from pathlib import Path

    src = (Path(attention.__file__).parent.parent / "csrc" / "paged_chunk.cu").read_text()
    constants = dict(re.findall(r"constexpr int (kSplitRows|kRowTile) = (\d+);", src))
    assert int(constants["kSplitRows"]) == attention._SPLIT_ROWS
    assert int(constants["kRowTile"]) == attention._ROW_TILE
    rows = attention._SPLIT_ROWS
    assert attention.chunk_body(rows, 1) == "split" and attention.chunk_body(rows + 1, 1) == "tiles"


def split_model(q, pages, table, lengths, *, sm_scale, compute_dtype, n_splits):
    """B6's split-and-combine in plain PyTorch: split s scores the slot's
    columns of pages [s p, (s + 1) p) that row t sees (col <= length - T +
    t) with the row's own max m_s, l_s = sum of exp(s - m_s) and acc_s =
    (P * v_scale, rounded to the compute dtype) V; a row's partial with no
    column has l_s = 0 and is left out; the output folds the rest in split
    order with weights exp(m_s - M), M their largest m, as the kernel's
    last block does.  A row with no column at all gives zeros."""
    n, chunk, n_heads, d = q.shape
    hkv, _, page, _ = pages.k_pages.shape
    group = n_heads // hkv
    rows = chunk * group
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
    qf = (q.reshape(n, chunk, hkv, group, d).transpose(1, 2)
          .reshape(n, hkv, rows, d).to(compute_dtype).float())
    pos = lengths[:, None] - chunk + torch.arange(rows)[None, :] // group  # [n, rows]
    s_all = (qf @ k.transpose(-1, -2)) * (ks * sm_scale)[:, :, None, :]
    parts = []
    for s in range(n_splits):
        lo, hi = s * per * page, min(pps, (s + 1) * per) * page
        keep = (cols >= lo) & (cols < hi) & (cols[None, None, :] <= pos[:, :, None])
        keep = keep[:, None]                                         # [n, 1, rows, L]
        sc = s_all + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(keep, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = (p * vs[:, :, None, :]).to(compute_dtype).float() @ v
        parts.append((m, l, acc))
    big = torch.stack([torch.where(l > 0, m, float("-inf")) for m, l, _ in parts]).amax(0)
    num = torch.zeros(n, hkv, rows, d)
    den = torch.zeros(n, hkv, rows, 1)
    for m, l, acc in parts:  # in split order; a row's empty partial adds nothing
        f = torch.where(l > 0, torch.exp(torch.where(l > 0, m - big, 0.0)), 0.0)
        num = num + acc * f
        den = den + l * f
    out = num * torch.where(den == 0, 0.0, 1.0 / den)
    return (out.reshape(n, hkv, chunk, group, d).transpose(1, 2)
            .reshape(n, chunk, n_heads, d).to(q.dtype))


@functools.lru_cache(maxsize=None)
def _pages(cache: str, hkv: int, with_jax: bool):
    """The same cache contents in both packages (JAX's only `with_jax`),
    written through each package's own prompt writer from one numpy prompt
    per slot (positions past a slot's length are garbage the masks hide)."""
    jdt, tdt = CACHES[cache]
    rng = np.random.default_rng(len(cache) * 10 + hkv)
    n = len(lengths_for(1))
    num_pages = n * PPS + 1
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(n, PPS)
    pj = jax_kv.init_kv_pages(hkv, num_pages, PAGE, D, jdt) if with_jax else None
    pt = kv_cache.init_kv_pages(hkv, num_pages, PAGE, D, tdt, device="cpu")
    for s in range(n):
        k = rng.standard_normal((PPS * PAGE, hkv, D)).astype(np.float32)
        v = rng.standard_normal((PPS * PAGE, hkv, D)).astype(np.float32)
        if with_jax:
            pj = jax_kv.write_prompt_kv(pj, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(table[s]))
        kv_cache.write_prompt_kv(pt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(table[s]))
    return pj, pt, table


def _q(chunk, group, hkv, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(lengths_for(chunk)), chunk, hkv * group, D)
                               ).astype(np.float32)


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("chunk", CHUNKS)
def test_split_model_matches_plain(chunk, group, cache, compute):
    """The model at one split a page, two splits and one split against the
    plain B6, which takes each row whole."""
    _, tc, tol = COMPUTE[compute]
    hkv = GROUPS[group]
    _, pt, table = _pages(cache, hkv, False)
    q = torch.from_numpy(_q(chunk, group, hkv, chunk * 10 + group)).to(tc)
    lengths = torch.tensor(lengths_for(chunk), dtype=torch.int32)
    args = (pt, torch.from_numpy(table), lengths)
    plain = attention.paged_chunk_attention(q, *args, compute_dtype=tc)
    assert not plain[0].any(), "an inactive slot (length 0) gives zeros"
    for n_splits in (PPS, 2, 1):
        got = split_model(q, *args, sm_scale=D ** -0.5, compute_dtype=tc,
                          n_splits=n_splits)
        assert got.dtype == tc and got.shape == q.shape
        assert torch.isfinite(got.float()).all() and not got[0].any()
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("compute", list(COMPUTE))
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("chunk,group", [(5, 2), (8, 8), (1, 1)])
def test_split_model_matches_jax(chunk, group, cache, compute):
    """The model at one split a page against the JAX kernel on the same
    pages (speculation's T 5 at group 2, T 8 at group 8, T 1 at group 1)."""
    jc, tc, tol = COMPUTE[compute]
    hkv = GROUPS[group]
    pj, pt, table = _pages(cache, hkv, True)
    q = _q(chunk, group, hkv, chunk * 10 + group)
    lengths = np.array(lengths_for(chunk), np.int32)
    got = split_model(torch.from_numpy(q).to(tc), pt, torch.from_numpy(table),
                      torch.from_numpy(lengths), sm_scale=D ** -0.5,
                      compute_dtype=tc, n_splits=PPS)
    o_j = np.asarray(jax_attention.paged_chunk_attention(
        jnp.asarray(q, jc), pj, jnp.asarray(table), jnp.asarray(lengths),
        compute_dtype=jc).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), o_j, atol=tol, rtol=0)


def test_one_split_holds_columns_for_some_rows_only():
    """At T 5 and one page a split, the slot of length 126 + T has rows at
    positions 126-130: split 1 (page 1, from 128) holds columns for rows
    t >= 2 and none for rows 0 and 1, whose partial there has l = 0; the
    model's fold leaves it out and no NaN appears."""
    chunk, group = 5, 2
    hkv = GROUPS[group]
    _, pt, table = _pages("int8", hkv, False)
    q = torch.from_numpy(_q(chunk, group, hkv, 3))
    lengths = torch.tensor(lengths_for(chunk), dtype=torch.int32)
    slot = lengths_for(chunk).index(126 + chunk)
    pos = 126 + torch.arange(chunk)
    assert (pos < PAGE).tolist() == [True, True, False, False, False]
    got = split_model(q, pt, torch.from_numpy(table), lengths, sm_scale=D ** -0.5,
                      compute_dtype=torch.float32, n_splits=PPS)
    want = attention.paged_chunk_attention(q, pt, torch.from_numpy(table), lengths,
                                           compute_dtype=torch.float32)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[slot].numpy(), want[slot].numpy(), atol=2e-5, rtol=0)


def _ptxas_report(names, spill=0, note=False):
    """ptxas -v lines for kernels `names` (mangled), as nvcc prints them."""
    lines = []
    for name in names:
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  "ptxas info    : Used 168 registers, used 1 barriers"]
        if note:
            lines.append(f"ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
                         f"instructions are serialized in the function '{name}'")
    return "\n".join(lines)


_NS = "_ZN48_GLOBAL__N__5f0e1a2b_14_paged_chunk_cu_7c3d9e01"
_TQ = ("f", "13__nv_bfloat16")
_TC = ("f", "13__nv_bfloat16", "a", "13__nv_fp8_e4m3", "13__nv_fp8_e5m2", "NS_6Int4x2E")
B6_SPLIT_ENTRIES = [f"{_NS}17paged_chunk_splitI{tq}{tc}Li{d}ELb{mma}EEEvPKT_"
                    for tq in _TQ for tc in _TC for d in (64, 128) for mma in (0, 1)]
B6_MMA_ENTRIES = [f"{_NS}15paged_chunk_mmaI{tq}{tc}Li{d}EEEvPKT_"
                  for tq in _TQ for tc in _TC for d in (64, 128)]
B6_FP32_ENTRIES = [f"{_NS}16paged_chunk_fp32I{tq}{tc}Li{d}EEEvPKT_"
                   for tq in _TQ for tc in _TC for d in (64, 128)]
X_ENTRIES = [f"_ZN52_GLOBAL__N__1a2b3c4d_14_r5_d128_fwd_cu_9e8f7a6b6r5_fwdILi{v}EEEv"
             "14CUtensorMap_stS1_PK13__nv_bfloat16PS2_Pfif" for v in range(5)]


def test_phase_1_gates_every_new_b6_and_x_instantiation():
    """chip_smoke's phase 1 holds B6's split body (48: six caches x two q
    types x D 64 and 128 x fp32 compute on the FMA units and bf16 compute
    on the tensor cores), its bf16 tile body (24), its fp32 tile body on
    the FMA block (24) and X's five variants: clean reports pass, one
    spilled byte, a wgmma serialisation note or a missing instantiation
    fails."""
    import chip_smoke

    functions, count = chip_smoke.B6_FUNCTIONS
    entries = B6_SPLIT_ENTRIES + B6_MMA_ENTRIES + B6_FP32_ENTRIES
    assert count == len(entries) == 96
    chip_smoke.check_ptxas(_ptxas_report(entries), "B6", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_report(entries[:95])
                               + "\n" + _ptxas_report(entries[95:], spill=8),
                               "B6", functions, count)
    with pytest.raises(AssertionError, match="only 95"):
        chip_smoke.check_ptxas(_ptxas_report(entries[1:]), "B6", functions, count)
    functions, count = chip_smoke.X_FUNCTIONS
    assert count == len(X_ENTRIES) == 5
    chip_smoke.check_ptxas(_ptxas_report(X_ENTRIES), "X", functions, count)
    with pytest.raises(AssertionError, match="serialises"):
        chip_smoke.check_ptxas(_ptxas_report(X_ENTRIES[:4]) + "\n"
                               + _ptxas_report(X_ENTRIES[4:], note=True),
                               "X", functions, count)
