"""The D=128 rowsum probe (kernel X) and its entry point.

Counterpart of scripts/r5_d128_fwd.py, whose Pallas kernel `fwd` it
replaces (csrc/r5_d128_fwd.cu): non-causal attention over bf16 q, k, v
[B, H, S, 128] in five variants that differ only in how the softmax row sum
l is formed (v0_current, v1_mxu_ones, v2_lane_part, v3_bf16_sum,
v4_split_kv; the source note says what each is on the card).  The probe
asks which rowsum B1's D=128 redesign should use.  On a CPU tensor `fwd`
runs the plain version; on a CUDA tensor it launches the kernel or raises.

    python -m cuda_flash_attention_tpu_torch.scripts.r5_d128_fwd

prints, at the probe's B4 H8 S2048 D128 bf16, one line per variant
(device ms, TFLOP/s at 4 B H S^2 D, max |O - O_B1| against B1 on the same
inputs), then B1 and SDPA at the same shape.  With --device cpu it runs
the plain versions at CPU_SHAPE and prints errors only: a CPU time is
not a device time.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from cuda_flash_attention_tpu_torch._device import resolve_device
from cuda_flash_attention_tpu_torch.kernels import _build, launches
from cuda_flash_attention_tpu_torch.kernels.common import LN2, LOG2E

VARIANTS = ("v0_current", "v1_mxu_ones", "v2_lane_part", "v3_bf16_sum",
            "v4_split_kv")
B, H, S, D = 4, 8, 2048, 128
CPU_SHAPE = (1, 1, 128)  # B, H, S of the plain run on the CPU
# exp2 of a bf16 operand as JAX defines it (lax.exp2 lowers to
# exp(ln2 * x) with ln2 in the operand's type): exp(bf16(LN2_BF16 * x)),
# every step rounded to bf16.  ln 2 in bf16 is 0.69140625, so this P runs
# up to 6% (on average 1.75%) above a true exp2 at these scores; it is the
# probe's function, and the kernel computes the same.
LN2_BF16 = 0.69140625


# The C entry point's argument types (csrc/r5_d128_fwd.cu).
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("r5_d128_fwd")
    fn = lib.cfa_r5_d128_fwd
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def fwd(q, k, v, variant: str):
    """The probe's function: (O [B, H, S, D] bf16, lse [B, H, S, 1] fp32)
    for bf16 q, k, v, as the JAX script's fwd returns them."""
    _check(q, k, v, variant)
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, variant)
    if q.device.type != "cuda":
        raise ValueError(f"r5_d128_fwd: unsupported device {q.device}")
    out = launch(_lib(), q, k, v, variant)
    launches.count("r5_d128_fwd")
    return out


def launch(lib: ctypes.CDLL, q, k, v, variant: str):
    """One launch of X from `lib` (csrc/r5_d128_fwd.cu built, or an earlier
    build of it with the same entry point) on CUDA tensors; returns (O,
    lse) as fwd does."""
    b, h, s, d = q.shape
    if (d != 128 or s % 128 or any(t.dtype != torch.bfloat16 for t in (q, k, v))
            or b * h > 65535):
        raise NotImplementedError(
            f"r5_d128_fwd kernel: bf16 q/k/v with D 128 and S a multiple of "
            f"128; got {q.dtype} {tuple(q.shape)}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("r5_d128_fwd kernel: q/k/v must be contiguous, "
                             "16-byte aligned and on one device")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), device=q.device, dtype=torch.float32)
    err = lib.cfa_r5_d128_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, s, (d ** -0.5) * LOG2E, VARIANTS.index(variant),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "cfa_r5_d128_fwd_error_string", err, "r5_d128_fwd")
    return o, lse


def _exp2_bf16(x: torch.Tensor) -> torch.Tensor:
    """JAX's exp2 of the bf16 tensor x (see LN2_BF16), as fp32."""
    return torch.exp(x.to(torch.bfloat16) * LN2_BF16).float()


def fwd_plain(q, k, v, variant: str):
    """The probe's function in plain PyTorch, with the TPU kernel's rounding
    points (scripts/r5_d128_fwd.py:41-101): Q scaled in fp32 and rounded to
    bf16; S fp32; P = exp2(bf16(S - m)) in bf16 (JAX's bf16 exp2,
    LN2_BF16); l per variant (v0, v1, v2:
    the fp32 sum of P; v3: that sum rounded to bf16; v4: two halves, each
    one pass, joined by the online rescale); O = PV / l in bf16, lse =
    m*ln2 + log(l)."""
    _check(q, k, v, variant)
    c = (q.shape[-1] ** -0.5) * LOG2E
    qs = (q.float() * c).to(torch.bfloat16).float()
    kf, vf = k.float(), v.float()
    if variant == "v4_split_kv":
        half = q.shape[2] // 2
        m = torch.full_like(qs[..., :1], -float("inf"))
        l, pv = torch.zeros_like(m), torch.zeros_like(qs)
        for part in (slice(0, half), slice(half, 2 * half)):
            s = qs @ kf[:, :, part].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = _exp2_bf16(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = pv * alpha + p @ vf[:, :, part]
            m = m_new
    else:
        s = qs @ kf.transpose(-1, -2)
        m = s.amax(dim=-1, keepdim=True)
        p = _exp2_bf16(s - m)
        pv = p @ vf
        l = p.sum(dim=-1, keepdim=True)
        if variant == "v3_bf16_sum":
            l = l.to(torch.bfloat16).float()
    o = (pv * torch.where(l == 0.0, 1.0, 1.0 / l)).to(torch.bfloat16)
    lse = m * LN2 + torch.log(torch.where(l == 0.0, 1.0, l))
    return o, lse


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> list[dict]:
    """Run every variant at the probe's shape (CPU_SHAPE on the CPU) and
    print its line; returns the rows.  B1 (kernels/fa2_forward.py, non-causal) on
    the same inputs is the error reference, as the JAX script's
    flash_attention_with_lse."""
    from cuda_flash_attention_tpu_torch.kernels.fa2_forward import (
        fa2_forward_aligned,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, h, s = (B, H, S) if device.type == "cuda" else CPU_SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, D, generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    flops = 4 * b * h * s * s * D
    b1_kw = dict(causal=False, sm_scale=scale, kv_len=s, tile_dtype=torch.bfloat16)
    o_ref = fa2_forward_aligned(q, k, v, **b1_kw)[0].float()
    timed = device.type == "cuda"
    rows = []
    for variant in VARIANTS:
        o, _ = fwd(q, k, v, variant)
        err = (o.float() - o_ref).abs().max().item()
        ms = _time_ms(lambda: fwd(q, k, v, variant)) if timed else None
        rows.append(dict(variant=variant, ms=ms, err=err,
                         tflops=flops / ms / 1e9 if timed else None))
        if timed:
            print(f"{variant:14s} {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF  "
                  f"err {err:.2e}", flush=True)
        else:
            print(f"{variant:14s} not measured (CPU)  err {err:.2e}", flush=True)
    if timed:
        import torch.nn.functional as F

        for name, fn in (
                ("B1", lambda: fa2_forward_aligned(q, k, v, **b1_kw)),
                ("SDPA", lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))):
            ms = _time_ms(fn)
            rows.append(dict(variant=name, ms=ms, err=None, tflops=flops / ms / 1e9))
            print(f"{name:14s} {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF", flush=True)
    return rows


if __name__ == "__main__":
    main()
