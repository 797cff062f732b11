"""Port parity of the D=128 rowsum probe (kernel X): each of the five
variants of scripts/r5_d128_fwd.py's Pallas kernel (read, not edited; its
module constants set to B, H, S = 1, 2, 256 and run in TPU interpret mode)
against the port's plain version on the same bf16 inputs: O within 2e-2
(bf16 output) and lse within 1e-3; v3's lse within 8e-3, one bf16 step of
its bf16-rounded l (sums that differ in their last fp32 bits by summation
order round to neighbouring bf16 values: log(1 + 2^-7) = 7.8e-3)."""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cuda_flash_attention_tpu_torch.scripts import r5_d128_fwd as port

ROOT = Path(__file__).resolve().parents[1]
O_TOL, LSE_TOL = 2e-2, 1e-3
LSE_TOL_BF16_L = 8e-3  # v3: one bf16 step of l


@pytest.fixture(scope="module")
def probe():
    # The script puts a fixed checkout path first on sys.path before its
    # imports: load what it imports from this checkout first, and take the
    # path back out after it has run.
    import cuda_flash_attention_tpu.kernels.common  # noqa: F401
    import cuda_flash_attention_tpu.utils.profiling  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        "r5_d128_fwd_probe", ROOT / "scripts" / "r5_d128_fwd.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    mod.B, mod.H, mod.S = 1, 2, 256
    rng = np.random.default_rng(0)
    x = [rng.standard_normal((1, 2, 256, mod.D)).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in x]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in x]
    return mod, jx, tx


@pytest.mark.parametrize("variant", port.VARIANTS)
def test_variant_matches_jax_probe(probe, variant):
    mod, jx, tx = probe
    with pltpu.force_tpu_interpret_mode():
        o_j, lse_j = mod.fwd(*jx, variant)
    o_t, lse_t = port.fwd(*tx, variant)
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (1, 2, 256, 128)
    assert lse_t.shape == (1, 2, 256, 1)
    o_j = np.asarray(o_j.astype(jnp.float32))
    assert np.abs(o_t.float().numpy() - o_j).max() <= O_TOL
    tol = LSE_TOL_BF16_L if variant == "v3_bf16_sum" else LSE_TOL
    assert np.abs(lse_t.numpy() - np.asarray(lse_j)).max() <= tol


def test_entry_point_on_the_cpu(capsys):
    rows = port.main(["--device", "cpu"])
    assert [r["variant"] for r in rows] == list(port.VARIANTS)
    assert all(r["ms"] is None and r["err"] <= O_TOL for r in rows)
    assert "not measured" in capsys.readouterr().out


def test_refuses_unknown_variant():
    x = torch.zeros(1, 1, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="variant"):
        port.fwd(x, x, x, "v5")
