"""Port parity at head dims 32 and 256 in training: the FA2 backward (B2,
B3 and B4) of cuda_flash_attention_tpu_torch against the JAX package's, on
the same numpy inputs.

On the CPU the port runs the plain versions of B1 and B2-B4; the JAX side
is called with force_kernel=True, so its reference is the Pallas kernels in
interpret mode.  Shapes: tests/test_fa2_forward.py's HeadDim-32 (B2 H4
S256) and HeadDim-256 (B1 H2 S256), with half as many KV heads.
Gradients: torch.autograd.grad of flash_attention against jax.grad of the
JAX API, each relative to the JAX gradient's own max |value|: 1e-5 in fp32
(tests/test_torch_fa2_backward.py's autograd gate), 5e-2 with bf16 tiles
(at D 256, the Gemma-2 width).
At S 256 no block size gives more than eight KV slices, so the port's
split route is taken by setting the route rule to refuse the fused one;
at S 1152 128-row blocks force it as JAX's rule does, and the two routes
agree.  The route helpers (live Q tiles, dQ slice bytes, `_use_fused_bwd`)
at D 32 and 256, phase 1's gate of the D 32 and D 256 libraries, and the
tiny hybrid model at head_dim 256 (loss and gradients against JAX's
loss_fn) close the file.  The CUDA kernels are held to these plain
versions on the card by tests/test_torch_kernels_gpu.py and chip_smoke.py
phases 29-30.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels.common import fit_block as jax_fit
from cuda_flash_attention_tpu.models import transformer as jax_tf
from cuda_flash_attention_tpu_torch.kernels import attention, common, fa2_backward
from cuda_flash_attention_tpu_torch.kernels.fa2_forward import fa2_forward_plain
from cuda_flash_attention_tpu_torch.models import transformer
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

# (B, Hq, Hkv, S) by head dim: HeadDim-32 and HeadDim-256 with GQA.
SHAPES = {32: (2, 4, 2, 256), 256: (1, 2, 1, 256)}
TOL = {None: 1e-5, "bf16": 5e-2}
SPLIT = common.BlockSizes(*(128,) * 6)


def _segments(b, s, seed):
    """Three contiguous segments a row, cut at random points."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, s), np.int32)
    for row in ids:
        for cut in np.sort(rng.choice(np.arange(1, s), 2, replace=False)):
            row[cut:] += 1
    return ids


MASKS = {
    "full": lambda b, s: dict(causal=False),
    "causal": lambda b, s: dict(causal=True),
    "window 48 sinks 4": lambda b, s: dict(causal=True, window=48, sinks=4),
    "segments": lambda b, s: dict(causal=True, q_segment_ids=_segments(b, s, s),
                                  kv_segment_ids=_segments(b, s, s)),
}


def _inputs(d, seed):
    b, hq, hkv, s = SHAPES[d]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d))]


def _jax_grads(q, k, v, w, tile, mask_kw):
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in mask_kw.items()}
    return [np.asarray(g) for g in jax.grad(lambda *x: jnp.sum(
        jax_attention.flash_attention(*x, force_kernel=True,
                                      tile_dtype=None if tile is None else jnp.bfloat16,
                                      **jkw) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, w, tile, mask_kw, **kw):
    """The port's gradients and the backward routes it took."""
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for n, x in mask_kw.items()}
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    calls = []
    fused, split = fa2_backward.fa2_backward_fused_plain, fa2_backward.fa2_backward_dq_plain
    try:
        fa2_backward.fa2_backward_fused_plain = \
            lambda *a, **k_: calls.append("fused") or fused(*a, **k_)
        fa2_backward.fa2_backward_dq_plain = \
            lambda *a, **k_: calls.append("split") or split(*a, **k_)
        o = attention.flash_attention(
            *ts, tile_dtype=None if tile is None else torch.bfloat16, **tkw, **kw)
        got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    finally:
        fa2_backward.fa2_backward_fused_plain = fused
        fa2_backward.fa2_backward_dq_plain = split
    return [g.numpy() for g in got], calls


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d,mask,tile", [
    (d, m, None) for d in SHAPES for m in MASKS] + [(256, "causal", "bf16")], ids=str)
def test_grads_match_jax_on_both_routes(d, mask, tile, monkeypatch):
    """Both of the port's routes (the fused B2 by default, the split B3 +
    B4 with the fused route refused) against jax.grad of the JAX API."""
    q, k, v, w = _inputs(d, seed=d + len(mask))
    mask_kw = MASKS[mask](q.shape[0], q.shape[2])
    want = _jax_grads(q, k, v, w, tile, mask_kw)
    got, calls = _port_grads(q, k, v, w, tile, mask_kw)
    assert calls == ["fused"]
    for g, j in zip(got, want):
        assert g.shape == j.shape and _rel_err(g, j) <= TOL[tile]
    monkeypatch.setattr(attention, "_use_fused_bwd", lambda *a, **k_: False)
    got, calls = _port_grads(q, k, v, w, tile, mask_kw)
    assert calls == ["split"]
    for g, j in zip(got, want):
        assert _rel_err(g, j) <= TOL[tile]


@pytest.mark.parametrize("d", [32, 256])
def test_block_sizes_force_the_split_route(d):
    """S 1152, B1 H2/1, causal, fp32: the default blocks give the fused B2,
    128-row blocks nine KV slices and the split pair (JAX's rule); the two
    routes' gradients agree within the fp32 gate."""
    rng = np.random.default_rng(d)
    q, w = (rng.standard_normal((1, 2, 1152, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 1, 1152, d), dtype=np.float32) for _ in range(2))
    fused, calls_f = _port_grads(q, k, v, w, None, {}, causal=True)
    split, calls_s = _port_grads(q, k, v, w, None, {}, causal=True, block_sizes=SPLIT)
    assert (calls_f, calls_s) == (["fused"], ["split"])
    for f, s in zip(fused, split):
        assert _rel_err(s, f) <= TOL[None]


# (Sq, Skv, kv_len, causal, window, sinks), tests/test_torch_window_backward's
# walks: causal windows inside a tile and across several, sinks in the first
# tile and past it, a band whose last rows keep no key, Sq > Skv + window.
WALKS = [(512, 512, 512, True, None, 0), (512, 512, 500, True, 100, 4),
         (700, 700, 700, True, 100, 130), (1024, 1024, 1024, False, -100, 0),
         (384, 256, 200, True, 64, 0), (512, 512, 512, False, 64, 3)]


@pytest.mark.parametrize("fp32", [False, True], ids=["16-bit tiles", "fp32"])
@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("sq,skv,kv_len,causal,window,sinks", WALKS, ids=str)
def test_walks_follow_the_mask(sq, skv, kv_len, causal, window, sinks, d, fp32):
    """B2's and B4's walk visits Q tile qt from KV tile kt (64-row KV tiles
    at D 256 with 16-bit tiles), and B3's KV tile kt from Q tile qt (32-row
    KV tiles at D 256), exactly when the two tiles hold a kept pair; B2's
    reduce reads every slice holding a key of the row and only slices B2
    wrote for it."""
    mask = common.build_element_mask(sq, skv, causal=causal, kv_len=kv_len,
                                     device="cpu", window=window, sinks=sinks)
    live = torch.ones(sq, skv, dtype=torch.bool) if mask is None else mask.expand(sq, skv)
    bq = fa2_backward.fused_q_tile(d, fp32)
    bk = fa2_backward.fused_kv_tile(torch.float32, None if fp32 else torch.bfloat16, d)
    assert (bq, bk) == ((64, 64) if fp32 else {32: (128, 128), 256: (64, 64)}[d])
    kv_walks = fa2_backward.fused_live_q_tiles(sq, skv, kv_len, causal, d, fp32,
                                               window, sinks)
    assert len(kv_walks) == -(-skv // bk)
    for kt, walked in enumerate(kv_walks):
        for qt in range(-(-sq // bq)):
            block = live[qt * bq:(qt + 1) * bq, kt * bk:(kt + 1) * bk]
            assert (qt in walked) == bool(block.any()), (kt, qt)
    bn, bq3 = fa2_backward.dq_kv_tile(d, fp32), 64 if fp32 else 128
    assert bn == (64 if fp32 else {32: 64, 256: 32}[d])
    for qt, walked in enumerate(fa2_backward.dq_kv_tiles(sq, kv_len, causal, d,
                                                         fp32, window, sinks)):
        for kt in range(-(-skv // bn)):
            block = live[qt * bq3:(qt + 1) * bq3, kt * bn:(kt + 1) * bn]
            assert (kt in walked) == bool(block.any()), (qt, kt)
    for r in range(sq):
        read = fa2_backward.reduce_kv_tiles(r, kv_len, causal, bk, window, sinks)
        keeps = {c // bk for c in torch.nonzero(live[r]).flatten().tolist()}
        assert keeps <= set(read) and read == sorted(read)
        assert all(r // bq in kv_walks[kt] for kt in read)


def test_dq_slice_bytes_at_d256():
    """The Gemma-2 prefill's heads, B1 Hq8 S2048 D256 causal: 64-row KV
    tiles and Q steps, 528 of the 1024 (Q tile, KV tile) pairs live, each
    slice row written once and read once: 0.55 GB against the 1.07 GB of
    writing and reading every slice; not causal every slice is live."""
    b, hq, s, d = 1, 8, 2048, 256
    every = 4 * d * b * hq * (s // 64) * s
    got = fa2_backward.fused_dq_slice_bytes(b, hq, s, s, s, True, d)
    assert got == 4 * d * b * hq * 2 * 528 * 64 == 553_648_128
    assert fa2_backward.fused_dq_slice_bytes(b, hq, s, s, s, False, d) == 2 * every
    # D 32 keeps D 64's tiles: B4 Hq16 S2048, 17,408 live (row, KV tile) pairs.
    assert fa2_backward.fused_dq_slice_bytes(4, 16, s, s, s, True, 32) == \
        4 * 32 * 4 * 16 * 2 * 17408


# (B, Hq, S, D, q dtype, tile, block_k_dkv): the port's route against JAX's.
# At D 256 the port's B2 keeps one fp32 slice a 64 KV rows: B1 Hq8 S2048
# needs 0.54 GB and B2 exactly 1 GiB (fused in both), B4 2 GiB, and in fp32
# B1 Hq8 S4096 2 GiB (the port splits where JAX, on its 1024-row slices,
# stays fused: ROADMAP.md's known divergences).
ROUTES = [
    ((1, 8, 2048, 256, torch.bfloat16, torch.bfloat16, 1024), True, True),
    ((2, 8, 2048, 256, torch.bfloat16, torch.bfloat16, 1024), True, True),
    ((4, 8, 2048, 256, torch.bfloat16, torch.bfloat16, 1024), True, False),
    ((1, 8, 2048, 256, torch.bfloat16, torch.bfloat16, 128), False, False),
    ((1, 8, 4096, 256, torch.float32, None, 1024), True, False),
    ((1, 8, 2048, 256, torch.float32, None, 1024), True, True),
    ((4, 16, 2048, 32, torch.bfloat16, torch.bfloat16, 1024), True, True),
    ((16, 16, 2048, 32, torch.bfloat16, torch.bfloat16, 1024), True, True),
    ((32, 16, 2048, 32, torch.bfloat16, torch.bfloat16, 1024), True, False),
    ((2, 4, 1152, 32, torch.float32, None, 128), False, False),
]


@pytest.mark.parametrize("row,jax_fused,port_fused", ROUTES, ids=str)
def test_use_fused_bwd_against_jax(row, jax_fused, port_fused):
    b, h, s, d, dtype, tile, bk = row
    q = types.SimpleNamespace(shape=(b, h, s, d), dtype=dtype)
    k = types.SimpleNamespace(shape=(b, h // 2, s, d), dtype=dtype)
    bk = jax_fit(bk, s)
    assert jax_attention._use_fused_bwd(q, k, bk) == jax_fused
    assert attention._use_fused_bwd(q, k, bk, tile) == port_fused


def test_kv_tiles_and_head_dims_of_the_wrappers():
    """B2's dQ slices cover 128 KV rows with 16-bit tiles (64 at D 256) and
    64 in fp32; every backward wrapper checks the four registry head dims,
    as B7-B10 do, each width's library named by kernel_library."""
    rows = {(code, d): fa2_backward._kv_rows(code, d)
            for code in (0, 1, 2) for d in (32, 64, 128, 256)}
    assert rows == {**{(0, d): 64 for d in (32, 64, 128, 256)},
                    **{(c, d): 128 for c in (1, 2) for d in (32, 64, 128)},
                    (1, 256): 64, (2, 256): 64}
    assert common.FORWARD_HEAD_DIMS == (32, 64, 128, 256)
    assert common.KERNEL_HEAD_DIMS == (64, 128)
    assert [common.kernel_library("fa2_backward", d) for d in (32, 64, 128, 256)] == [
        "fa2_backward_d32", "fa2_backward", "fa2_backward", "fa2_backward_d256"]
    for name in ("baselines", "fa2_forward_small", "fa2_forward_quant"):
        assert [common.kernel_library(name, d) for d in (32, 64, 128, 256)] == [
            f"{name}_d32", name, name, f"{name}_d256"]


def test_phase_1_gates_the_backward_libraries():
    """chip_smoke's phase 1 holds each of the D 32 and D 256 backward
    libraries' 22 kernels (4 x (prologue, B2, B4, B3) with 16-bit tiles,
    the fp32 prologue, B2, B4 and B3, the reduce twice): a clean report
    passes, a spilled byte or a missing instantiation fails."""
    import chip_smoke

    def report(names, spill=0):
        return "\n".join(
            line for n in names for line in (
                f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'",
                f"ptxas info    : Function properties for {n}",
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
                "spill loads", "ptxas info    : Used 168 registers"))

    functions, count = chip_smoke.BWD_WIDE_FUNCTIONS
    assert count == 4 * 4 + 4 + 2
    assert chip_smoke.WIDE_BWD_LIBRARIES == ("fa2_backward_d32", "fa2_backward_d256")
    names = [f"_Z{i}{functions[i % len(functions)]}Ii{i}E" for i in range(count)]
    chip_smoke.check_ptxas(report(names), "fa2_backward_d256", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(report(names[1:]) + "\n" + report(names[:1], 8),
                               "fa2_backward_d256", functions, count)
    with pytest.raises(AssertionError, match=f"only {count - 1}"):
        chip_smoke.check_ptxas(report(names[1:]), "fa2_backward_d256", functions, count)


def test_phase_29_controls_fail_the_gates():
    """chip_smoke phase 29's controls on the plain backward at D 256 (B1 H2/1
    S512): every mask's control (one key off in fp32, one 64-key tile off
    with bf16 tiles) moves the gradients past its gate and stays finite."""
    import chip_smoke

    b, s, d = 1, 512, 256
    rng = np.random.default_rng(29)
    q, do = (torch.from_numpy(rng.standard_normal((b, 2, s, d), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, 1, s, d), dtype=np.float32))
            for _ in range(2))
    for mask in chip_smoke.WIDE_B1_MASKS:
        mkw = chip_smoke.wide_mask_kw(torch, mask, b, s, device="cpu")
        for kind in ("bf16", "fp32"):
            tile = torch.bfloat16 if kind == "bf16" else None
            kw = dict(mkw, sm_scale=d ** -0.5, kv_len=s, tile_dtype=tile)
            o, lse = fa2_forward_plain(q, k, v, **kw)
            want = fa2_backward.fa2_backward_fused_plain(q, k, v, o, do, lse, **kw)
            ctl = fa2_backward.fa2_backward_fused_plain(q, k, v, o, do, lse, **dict(
                kw, **chip_smoke.wide_bwd_control(torch, mask, b, s, kind, device="cpu")))
            err = max(chip_smoke.rel_err(c, w_) for c, w_ in zip(ctl, want))
            assert np.isfinite(err) and err > chip_smoke.BWD_TOL[kind], (mask, kind)


def test_hybrid_d256_model_loss_and_grads_match_jax():
    """The tiny hybrid model at head_dim 256 (2 layers, window 32 on the
    first, global_every 2; q_dim 1024 beside d_model 128), fp32: the loss
    and every gradient leaf against JAX's loss_fn (tests/test_window.py:183),
    as tests/test_torch_window_backward.py holds it at D 64."""
    kw = dict(head_dim=256, attn_window=32, global_every=2)
    cfg_j = dataclasses.replace(jax_tf.TransformerConfig.tiny(), dtype=jnp.float32,
                                attn_tile_dtype=None, **kw)
    cfg_t = dataclasses.replace(
        transformer.TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None), **kw)
    assert cfg_t.q_dim == 1024 and [cfg_t.layer_window(i) for i in range(2)] == [32, None]
    params_j = jax_tf.init_params(jax.random.PRNGKey(0), cfg_j)
    tokens = np.random.default_rng(2).integers(0, 256, (1, 65)).astype(np.int32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_tf.loss_fn),
                              static_argnums=2)(params_j, jnp.asarray(tokens), cfg_j)
    loss_t, grads_t = transformer.value_and_grad(
        params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"),
        torch.from_numpy(tokens).long(), cfg_t)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    leaves_t, leaves_j = transformer.tree_leaves(grads_t), jax.tree.leaves(grads_j)
    assert len(leaves_t) == len(leaves_j)
    for g, w in zip(leaves_t, leaves_j):
        w = np.asarray(w, np.float32)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
