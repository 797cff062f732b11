"""Port parity: utils/profiling.py against the JAX package's
utils/profiling.py.  The roofline and MFU arithmetic given the same peaks
(to 1e-12 relative), the H100-only peak table, and the profiler's
aggregation on a CPU function (each op counted calls x iters; on the CPU
the times are the CPU ops', never a device time).  The card's side
(nonzero device time, kernel names) is in tests/test_torch_kernels_gpu.py."""

import types

import pytest
import torch

from cuda_flash_attention_tpu.utils import profiling as jax_prof
from cuda_flash_attention_tpu_torch.utils import profiling

PEAKS = (("h100", 989.0, 3350.0, 3.86496e12), ("odd", 197.0, 819.0, 4.0e11))
WORK = ((3.4e13, 1.2e9, 0.0, 1.0), (1.0e9, 5.0e10, 0.0, 0.5),
        (2.0e12, 1.0e8, 1.0e12, 1.0), (8.6e11, 3.0e9, 2.0e10, profiling.FP32_DERATE))


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("peaks", PEAKS, ids=lambda p: p[0])
@pytest.mark.parametrize("flops,hbm,exps,derate", WORK)
def test_roofline_and_mfu_match_jax(peaks, flops, hbm, exps, derate):
    mine = profiling.roofline_time(flops, hbm, transcendentals=exps, derate=derate,
                                   peaks=profiling.ChipPeaks(*peaks))
    want = jax_prof.roofline_time(flops, hbm, transcendentals=exps, derate=derate,
                                  peaks=jax_prof.ChipPeaks(*peaks))
    assert mine.keys() == want.keys()
    assert mine["bound"] == want["bound"]
    assert all(_close(mine[k], want[k]) for k in want if k != "bound")
    for seconds in (1e-3, 0.37):
        m = profiling.mfu(flops, seconds, derate=derate,
                          peaks=profiling.ChipPeaks(*peaks))
        w = jax_prof.mfu(flops, seconds, derate=derate,
                         peaks=jax_prof.ChipPeaks(*peaks))
        assert m.keys() == w.keys() and m["chip"] == w["chip"]
        assert all(_close(m[k], w[k]) for k in w if k != "chip")


def test_chip_peaks_cpu_is_unknown_with_h100_numbers():
    p = profiling.chip_peaks("cpu")
    assert p.name == "unknown"
    assert (p.bf16_tflops, p.hbm_gbps) == (989.0, 3350.0)
    assert p.exp_per_s == 16 * 132 * 1.83e9
    assert set(profiling._CHIP_PEAKS) == {"h100"}  # no TPU entry
    assert not any(tpu in frag for frag in profiling._CHIP_PEAKS
                   for tpu in ("v4", "v5", "v6", "tpu"))
    assert profiling.FP32_DERATE * 989.0 == pytest.approx(67.0)
    assert not hasattr(profiling, "mxu_derate")


def _step(a, b):
    return torch.mm(a, b).relu() + b.sum()


def test_profile_ops_counts_calls_times_iters():
    a, b = torch.randn(32, 32), torch.randn(32, 32)
    ops = {o.name: o for o in profiling.profile_ops(_step, a, b, iters=3, warmup=1,
                                                    device="cpu")}
    for name in ("aten::mm", "aten::relu", "aten::sum", "aten::add"):
        assert ops[name].count == 3, (name, ops[name])
        assert ops[name].total_ms >= 0
    totals = [o.total_ms for o in ops.values()]
    assert list(ops) == [o.name for o in sorted(ops.values(), key=lambda o: -o.total_ms)]
    assert sum(totals) > 0
    t = profiling.trace(_step, a, b, iters=5, warmup=0, device="cpu")
    assert {o.name: o.count for o in t.kernels}["aten::mm"] == 5
    assert t.iters == 5 and t.device == "cpu" and t.sources == {}
    assert t.wall_ms > 0 and t.busy_ms > 0
    assert [row[0] for row in t.top(2)] == [k.name for k in t.kernels[:2]]


def test_train_step_ranges_name_its_parts():
    """The train step's two ranges show as host ops in a trace: the forward
    and loss under train_step.value_and_grad, AdamW under
    train_step.update."""
    from cuda_flash_attention_tpu_torch.models import training, transformer

    cfg = transformer.TransformerConfig.tiny(dtype=torch.float32, attn_tile_dtype=None)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = training.make_optimizer(learning_rate=1e-3, warmup_steps=1, decay_steps=4)
    step = training.make_optax_train_step(cfg, opt)
    state = training.init_train_state(params, opt)
    tokens = torch.randint(0, cfg.vocab_size, (1, 17))
    t = profiling.trace(step, state, tokens, iters=1, warmup=0, device="cpu")
    ops = {o.name: o for o in t.ops}
    assert ops["train_step.value_and_grad"].count == 1
    assert ops["train_step.update"].count == 1
    assert ops["train_step.update"].total_ms > 0


def test_kernel_device_time_match_and_copies(monkeypatch):
    a = torch.randn(64, 64)
    fn = lambda x: x.clone().mul_(2)  # noqa: E731
    assert profiling.kernel_device_time(fn, a, iters=4, device="cpu") > 0
    assert profiling.kernel_device_time(fn, a, match=r"^aten::mul_$", iters=4,
                                        device="cpu") > 0
    # The sums over one fixed op list (two profiled runs time differently).
    ops = [profiling.OpTime("fa2_fwd_wgmma", 4, 8.0),
           profiling.OpTime("Memcpy DtoD (Device -> Device)", 4, 2.0),
           profiling.OpTime("Memset (Device)", 4, 1.0),
           profiling.OpTime("nvjet_gemm", 4, 4.0)]
    monkeypatch.setattr(profiling, "profile_ops", lambda *a, **k: ops)
    seconds = lambda **kw: profiling.kernel_device_time(fn, a, iters=4, **kw)  # noqa: E731
    assert seconds() == pytest.approx(12.0 / 4e3)
    assert seconds(exclude_copies=False) == pytest.approx(15.0 / 4e3)
    assert seconds(match="fa2_fwd") == pytest.approx(8.0 / 4e3)
    assert seconds(match="Memcpy") == pytest.approx(2.0 / 4e3)
    assert seconds(match="^nothing$") == 0.0


def test_profile_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.profile_ops(_step, torch.ones(2, 2), torch.ones(2, 2))


def _event(name, parent=None, kernels=()):
    return types.SimpleNamespace(name=name, cpu_parent=parent, kernels=[
        types.SimpleNamespace(name=k, duration=us) for k, us in kernels])


def test_kernel_sources_walk_past_runtime_calls():
    """A kernel's source is the outermost op or range around its launch
    call and the innermost op: "...: MulBackward0 > aten::mul"."""
    top = _event("autograd::engine::evaluate_function: MulBackward0")
    mul_bwd = _event("MulBackward0", top)
    mul = _event("aten::mul", mul_bwd)
    launch = _event("cudaLaunchKernel", mul, [("elementwise_kernel", 30.0)])
    mm = _event("aten::mm", None)
    launch2 = _event("cuLaunchKernel", _event("cudaLaunchKernelExC", mm),
                     [("nvjet_gemm", 50.0), ("elementwise_kernel", 10.0)])
    orphan = _event("cudaGraphLaunch", None, [("paged_decode_kernel", 7.0)])
    src = profiling.kernel_sources([top, mul_bwd, mul, launch, mm, launch2, orphan])
    assert src["elementwise_kernel"] == [
        ("autograd::engine::evaluate_function: MulBackward0 > aten::mul", 0.03),
        ("aten::mm", 0.01)]
    assert src["nvjet_gemm"] == [("aten::mm", 0.05)]
    assert src["paged_decode_kernel"] == [("(no op)", 0.007)]
