"""Port parity at head dims 32 and 256 on the reference contract's path: the
baselines B9 (FA1) and B10 (naive FA2), the small-problem forward B8 and
the quantized-KV forward B7 of cuda_flash_attention_tpu_torch against the
JAX package's, on the same numpy inputs, and the CLI against the JAX CLI
at the reference's head dim 32.

On the CPU the port runs the kernels' plain versions; the JAX kernels run
in interpret mode (B8 through force_kernel=True).  Tolerances, absolute:
the baselines at the JAX fp32 gate, 2e-6 on O
(tests/test_torch_baselines_dispatch.py); B8 2e-6 on O and 1e-5 on lse in
fp32, 2e-2 with bf16 and fp16 tiles (tests/test_torch_small_forward.py);
B7 2e-5 on O and 1e-5 on lse in fp32 compute, 2e-2 on O and 1e-3 relative
on lse in bf16 (tests/test_torch_fa2_forward_quant.py); the CLI's files at
the JAX fp32 gates (tests/test_torch_cli_harness.py).  chip_smoke.py's
phase 1 gates of the six D 32 and D 256 libraries and phase 31's controls
close the file; the CUDA kernels are held to these plain versions on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py phase 31.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _quant_trees import numpy_tree
from cuda_flash_attention_tpu import cli as jax_cli
from cuda_flash_attention_tpu.kernels import attention as jax_attention
from cuda_flash_attention_tpu.kernels import baselines as jax_baselines
from cuda_flash_attention_tpu.kernels import fa2_forward_quant as jax_fq
from cuda_flash_attention_tpu.quant import qtensor as jax_qt
from cuda_flash_attention_tpu_torch import cli
from cuda_flash_attention_tpu_torch.kernels import attention, baselines, common
from cuda_flash_attention_tpu_torch.kernels import fa2_forward_quant as fq
from cuda_flash_attention_tpu_torch.kernels.launches import LAUNCHES
from cuda_flash_attention_tpu_torch.utils import io
from cuda_flash_attention_tpu_torch.utils.convert import params_from_numpy

WIDE = (32, 256)


def _uniform(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(shape, dtype=np.float32) for _ in range(3))


def _normal(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [100, 256])
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("which", ["fa1", "naive_fa2"])
def test_baselines_match_jax_at_d32_d256(which, d, s):
    q, k, v = _uniform((1, 2, s, d), seed=d + s)
    want = getattr(jax_baselines, f"{which}_attention")(
        *(jnp.asarray(x) for x in (q, k, v)))
    before = dict(LAUNCHES)
    got = getattr(baselines, f"{which}_attention")(
        *(torch.from_numpy(x) for x in (q, k, v)))
    assert dict(LAUNCHES) == before  # the CPU runs the plain version
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


TILES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
         "fp16": (jnp.float16, torch.float16)}
B8_TOL = {"fp32": (2e-6, 1e-5), "bf16": (2e-2, 2e-2), "fp16": (2e-2, 2e-2)}


@pytest.mark.parametrize("precision,causal", [("fp32", False), ("fp32", True),
                                              ("bf16", True), ("fp16", False)])
@pytest.mark.parametrize("d", WIDE)
def test_small_forward_matches_jax_at_d32_d256(d, precision, causal, monkeypatch):
    """B2 H2 S100 (Edge-NonPowerOf2's length): the route takes B8, as JAX's
    does at every head dim (attention.py:273-277)."""
    calls = []
    real = attention.fa2_forward_small_aligned
    monkeypatch.setattr(attention, "fa2_forward_small_aligned", lambda *a, **kw: (
        calls.append(a[0].shape[3]), real(*a, **kw))[1])
    q, k, v = _normal((2, 2, 100, d), seed=d)
    jax_tile, torch_tile = TILES[precision]
    o_j, lse_j = jax_attention.flash_attention_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, tile_dtype=jax_tile,
        force_kernel=True)
    o_t, lse_t = attention.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, tile_dtype=torch_tile)
    assert calls == [d]
    tol_o, tol_lse = B8_TOL[precision]
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=tol_o, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=tol_lse, rtol=0)


@pytest.mark.parametrize("d", common.FORWARD_HEAD_DIMS)
def test_small_route_at_every_head_dim(d):
    """One whole tile a head and Hq = Hkv take B8 at all four widths, as in
    JAX; GQA or S > 128 do not."""
    x = torch.zeros(1, 2, 128, d)
    assert attention._use_small_kernel(x, x)
    assert not attention._use_small_kernel(x, x[:, :1])
    assert not attention._use_small_kernel(torch.zeros(1, 2, 256, d),
                                           torch.zeros(1, 2, 256, d))


STORAGE = {"int8": jnp.int8, "e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2,
           "int4": "int4"}
COMPUTE = {"bf16": (jnp.bfloat16, torch.bfloat16), "fp32": (jnp.float32, torch.float32)}
B7_O_TOL = {"fp32": 2e-5, "bf16": 2e-2}
B7_LSE_TOL = {"fp32": 1e-5, "bf16": 1e-3}  # fp32 absolute, bf16 relative


def _quantized(q, k, v, storage, compute, **kw):
    """(JAX, port) (O, lse) as numpy on one quantization of K/V."""
    k_q, v_q = jax_qt.quantize_kv(jnp.asarray(k), jnp.asarray(v), STORAGE[storage])
    jdt, tdt = COMPUTE[compute]
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    want = jax_fq.flash_attention_quantized_kv_with_lse(
        jnp.asarray(q), k_q, v_q, compute_dtype=jdt, **jkw)
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    got = fq.flash_attention_quantized_kv_with_lse(
        torch.from_numpy(q), params_from_numpy(numpy_tree(k_q), "cpu"),
        params_from_numpy(numpy_tree(v_q), "cpu"), compute_dtype=tdt, **tkw)
    return ([np.asarray(x, np.float32) for x in want],
            [got[0].float().numpy(), got[1].numpy()])


# Every storage in both compute types at each width, causal in half of them.
B7_CASES = [(d, st, cp, (i + j) % 2 == 0) for d in WIDE for i, st in enumerate(STORAGE)
            for j, cp in enumerate(COMPUTE)]


@pytest.mark.parametrize("d,storage,compute,causal", B7_CASES)
def test_quantized_matches_jax_at_d32_d256(d, storage, compute, causal):
    """GQA 2 at a ragged S 100."""
    q = _normal((1, 4, 100, d), seed=d)[0]
    k, v = _normal((1, 2, 100, d), seed=d + 1)[:2]
    (o_j, lse_j), (o_t, lse_t) = _quantized(q, k, v, storage, compute, causal=causal)
    assert o_t.shape == (1, 4, 100, d) and lse_t.shape == (1, 4, 100)
    assert np.abs(o_t - o_j).max() <= B7_O_TOL[compute]
    lse_err = np.abs(lse_t - lse_j)
    if compute == "bf16":
        lse_err = lse_err / np.maximum(np.abs(lse_j), 1.0)
    assert lse_err.max() <= B7_LSE_TOL[compute]


@pytest.mark.parametrize("d", WIDE)
def test_quantized_dead_rows_under_a_window(d):
    """A causal window of 64 over Sq 520 > Skv 150 (rows past kv_len +
    window keep no key): O = 0 and the JAX kernel's lse bit for bit, which
    follows its own 128-row tiles (-inf where its Q tile walks no KV tile,
    else the mask value times ln 2), not the port's 64-row tiles at D 256."""
    q = _normal((1, 4, 520, d), seed=3)[0]
    k, v = _normal((1, 2, 150, d), seed=4)[:2]
    (o_j, lse_j), (o_t, lse_t) = _quantized(q, k, v, "int8", "fp32", causal=True,
                                            window=64, block_q=128, block_k=128)
    dead = lse_j < -1e30
    assert dead.any() and np.isneginf(lse_j).any() and (~np.isinf(lse_j[dead])).any()
    np.testing.assert_array_equal(lse_t[dead], lse_j[dead])
    np.testing.assert_array_equal(o_t[dead], 0.0)
    assert np.abs(o_t - o_j)[~dead].max() <= B7_O_TOL["fp32"]
    np.testing.assert_allclose(lse_t[~dead], lse_j[~dead], atol=1e-5, rtol=0)


CLI_TOL = {"O.bin": 2e-6, "logsumexp.bin": 1e-5, "dQ.bin": 1e-5, "dK.bin": 1e-5,
           "dV.bin": 1e-5}


@pytest.mark.parametrize("argv", [
    ("fa2", "forward_backward", "fp32"), ("fa2", "forward", "bf16"),
    ("fa1", "forward", "fp32"), ("fa2-naive", "forward", "fp32"),
    ("naive", "forward", "fp32")], ids="-".join)
def test_cli_matches_the_jax_cli_at_d32(tmp_path, argv):
    """One B1_H2_S100_D32 directory (the reference's head dim; S 100 takes
    B8) through both CLIs, every written file compared (fp32 at the JAX
    fp32 gates; the bf16-tile run's O at 2e-2, its lse 1e-3 relative)."""
    src = tmp_path / "src" / io.data_dir_name(1, 2, 100, 32)
    src.mkdir(parents=True)
    for name, x in zip("QKV", _uniform((1, 2, 100, 32), seed=32)):
        x.tofile(src / f"{name}.bin")
    dirs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        ddir = tmp_path / name / src.name
        shutil.copytree(src, ddir)
        extra = ["--device", "cpu"] if name == "port" else []
        assert main([*argv, str(ddir), *extra]) == 0
        dirs[name] = ddir
    files = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == files
    for name in files:
        a = np.fromfile(dirs["port"] / name, dtype="<f4")
        b = np.fromfile(dirs["jax"] / name, dtype="<f4")
        if name not in CLI_TOL:
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif argv[2] == "bf16":
            tol = 2e-2 if name == "O.bin" else 1e-3 * np.abs(b).max()
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=CLI_TOL[name], rtol=0, err_msg=name)


def test_phase_1_gates_the_reference_libraries():
    """chip_smoke's phase 1 holds each of the six new libraries' kernels (B9
    and B10 one each; B8's mma body in 2 input x 2 tile types and its fp32
    body, each with and without ids; B7's wgmma body in 4 storages x 2 q
    types and its fp32 body with and without ids) and B9 beside B10 in the
    base library: a clean report passes, a spilled byte, a serialisation
    note or a missing instantiation fails."""
    import chip_smoke

    def report(names, spill=0, note=False):
        return "\n".join(
            line for n in names for line in (
                f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'",
                f"ptxas info    : Function properties for {n}",
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes "
                "spill loads", "ptxas info    : Used 168 registers") + ((
                    f"ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
                    f"instructions are serialized in the function '{n}'",) if note else ()))

    names = [f"{n}_d{d}" for n in ("baselines", "fa2_forward_small", "fa2_forward_quant")
             for d in WIDE]
    libraries = {n: chip_smoke.WIDE_FUNCTIONS[n] for n in names}
    assert [libraries[f"{n}_d32"][1] for n in (
        "baselines", "fa2_forward_small", "fa2_forward_quant")] == [2, 10, 24]
    assert set(chip_smoke.WIDE_FUNCTIONS) <= set(chip_smoke.BUILD_ORDER)
    assert chip_smoke.FP32_FUNCTIONS["baselines"] == (("naive_fa2_fp32", "fa1_fp32"), 4)
    for name, (functions, count) in libraries.items():
        names = [f"_Z{i}{functions[i % len(functions)]}Ii{i}E" for i in range(count)]
        chip_smoke.check_ptxas(report(names), name, functions, count)
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.check_ptxas(report(names[1:]) + "\n" + report(names[:1], 8),
                                   name, functions, count)
        with pytest.raises(AssertionError, match="spills or serialises"):
            chip_smoke.check_ptxas(report(names[1:]) + "\n"
                                   + report(names[:1], note=True), name, functions, count)
        with pytest.raises(AssertionError, match=f"only {count - 1}"):
            chip_smoke.check_ptxas(report(names[1:]), name, functions, count)


def test_phase_31_controls_fail_the_gates():
    """chip_smoke phase 31's controls, on the plain versions at small sizes:
    B9/B10's one key short of kv_len, B8's mask one key (fp32) or one 8-key
    n-tile (bf16) off under each of its masks at each width, and B7's
    (causal dropped, the window one wider, the ids shifted a token) each
    move the output past its gate and stay finite."""
    import chip_smoke

    for d in WIDE:
        q, k, v = (torch.from_numpy(x) for x in _normal((1, 2, 256, d), seed=d))
        o = baselines.fa1_plain(q, k, v, sm_scale=d ** -0.5, kv_len=256)
        o_c = baselines.fa1_plain(q, k, v, sm_scale=d ** -0.5, kv_len=255)
        assert (o - o_c).abs().max().item() > chip_smoke.BASELINE_TOL
        for name in ("Small-1", "Edge-NonPowerOf2", "Edge-SmallSeq"):
            b, h, s = chip_smoke.SUITE[name]
            raw = [torch.from_numpy(x) for x in _normal((2, 2, s, d), seed=s)]
            for kind in ("fp32", "bf16"):
                tile = chip_smoke.tile_of(torch, kind)
                q, k, v, scale, _, kv_len = attention._prepare(
                    *raw, False, None, tile, None, None, None, 0)
                sp = q.shape[2]
                for mask in chip_smoke.WIDE_B8_MASKS:
                    kw = dict(chip_smoke.wide_b8_kw(torch, mask, 2, sp, kv_len, kind,
                                                    device="cpu"),
                              sm_scale=scale, tile_dtype=tile)
                    ckw = dict(kw, **chip_smoke.wide_b8_kw(torch, mask, 2, sp, kv_len,
                                                           kind, control=True, device="cpu"))
                    o, _ = attention.fa2_forward_small_aligned(q, k, v, **kw)
                    o_c, _ = attention.fa2_forward_small_aligned(q, k, v, **ckw)
                    err = (o - o_c).abs().max().item()
                    assert np.isfinite(err) and err > chip_smoke.B1_TOL[kind], (
                        d, name, kind, mask)
        q = torch.from_numpy(_normal((1, 4, 512, d), seed=5)[0])
        k, v = (torch.from_numpy(x) for x in _normal((1, 2, 512, d), seed=6)[:2])
        half = torch.cat([torch.zeros(1, 256), torch.ones(1, 256)], 1).to(torch.int32)
        shifted = torch.roll(half, 1, dims=1).contiguous()
        for storage in ("int8", "int4"):
            args = fq.aligned_inputs(q, *fq.quantize_kv(k, v, chip_smoke.storage_dtype(
                torch, storage)))
            for compute, cdt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
                base = dict(causal=True, sm_scale=d ** -0.5, kv_len=512, compute_dtype=cdt)
                x = (args[0].to(cdt),) + args[1:]
                for mkw, ckw in ((dict(), dict(causal=False)),
                                 (dict(window=160), dict(window=161)),
                                 (dict(q_seg=half, kv_seg=half),
                                  dict(q_seg=shifted, kv_seg=shifted))):
                    o, _ = fq.fa2_forward_quant_plain(*x, **dict(base, **mkw))
                    o_c, _ = fq.fa2_forward_quant_plain(*x, **dict(base, **ckw))
                    if compute == "bf16":
                        err = chip_smoke.bf16_excess(o, o_c)
                        assert err > chip_smoke.BF16_ATOL["B7"], (d, storage, mkw)
                    else:
                        err = (o - o_c).abs().max().item()
                        assert err > chip_smoke.B7_FP32_TOL, (d, storage, mkw)
                    assert np.isfinite(err)
