"""The fp32 bodies of the FA2 backward kernels (B2, or B3 + B4) on one
card, at the reference suite's shapes whose fp32 `fa2 both` rows the
harness runs them on.

    python -m cuda_flash_attention_tpu_torch.scripts.fp32_bwd

At Large-2 (B4 H12 S1024) and Stress-1 (B8 H16 S2048), D 64, not causal, as
the registry's backward calls them (default block sizes), it takes the
route attention._use_fused_bwd gives (the fused B2 at Large-2; B3 + B4 at
Stress-1, where B2's dQ slices would pass the rule's 1 GiB cap) and prints
one JSON line per kernel of the route: device time per call (b1_ab's
`device_ms`, the calls queued behind a sleep kernel), TFLOP/s, the bound
(each input read once and each output written once, or the FLOPs at 67
TFLOP/s; B2 five S x S x D products per pair, B3 three, B4 four), and the
time of one PyTorch call computing dQ, dK and dV: the fp32 backward of
SDPA's memory-efficient kernel, fed by its own forward.  Then the route's
total beside it.  The card's name and power limit come first.
scripts/kernel_ab.py's `b2-fp32`, `b3-fp32`, `b4-fp32` and `b3-b4-fp32`
time the same bodies against an earlier build of their source, in turns,
at these shapes and phase 7's other fp32 shapes (SHAPES and
efficient_backward are theirs too).
"""

from __future__ import annotations

import json

import torch

from cuda_flash_attention_tpu_torch.kernels import attention
from cuda_flash_attention_tpu_torch.kernels import fa2_backward as bwd
from cuda_flash_attention_tpu_torch.kernels import fa2_forward as fa2
from cuda_flash_attention_tpu_torch.kernels.common import BlockSizes, fit_block
from cuda_flash_attention_tpu_torch.scripts import b1_ab

SHAPES = {"Large-2": (4, 12, 1024), "Stress-1": (8, 16, 2048)}
_MATMULS = {"fa2_backward_fused": 5, "fa2_backward_dq": 3, "fa2_backward_dkv": 4}


def efficient_backward(q, k, v, do, scale, causal=False):
    """SDPA's memory-efficient fp32 backward on the same inputs (K and V
    with q's heads), fed by its own forward: one call giving dQ, dK and
    dV."""
    o, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, causal, scale=scale)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
        do, q, k, v, None, o, lse, seed, offset, 0.0, [True, True, True, False],
        causal, scale=scale)


def masked_backward(q, k, v, do, scale, mask):
    """SDPA's backward with `mask` (boolean, True keeps; [S, S] or [B, 1, S,
    S]) as its attention bias (0 kept, the type's lowest value masked, so a
    row that keeps no key stays finite), in q's type: the memory-efficient
    backward, fed by its own forward, on K and V with q's heads.  The
    yardstick of a windowed or segmented backward."""
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill_(
        ~mask, torch.finfo(q.dtype).min)
    if bias.ndim == 2:
        bias = bias[None, None]
    bias = bias.expand(q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    o, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, bias, True, 0.0, False, scale=scale)
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
        do, q, k, v, bias, o, lse, seed, offset, 0.0, [True, True, True, False],
        False, scale=scale)


def fused_route(q, k) -> bool:
    """Whether the registry's fp32 backward takes B2 (True) or B3 + B4 at
    q and k's shapes, D 64 and not causal: attention._use_fused_bwd at the
    default dK/dV block."""
    block = fit_block(BlockSizes.default(False).block_k_dkv, k.shape[2])
    return attention._use_fused_bwd(q, k, block, None)


def bound(kernel: str, b: int, h: int, s: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations") of one fp32 backward kernel at B b, H h
    = Hkv, Sq = Skv = s, D 64, not causal: each input read once and each
    output written once, or its products at 67 TFLOP/s."""
    qb, stat = b * h * s * 64 * 4, b * h * s * 4
    # Inputs and outputs of each kernel (Hq = Hkv, so K and V are q-sized):
    # B2 q k v O dO lse -> dQ dK dV; B3 q k v dO lse D_i -> dQ; B4 the same
    # -> dK dV.
    moved = {"fa2_backward_fused": 8 * qb + stat,
             "fa2_backward_dq": 5 * qb + 2 * stat,
             "fa2_backward_dkv": 6 * qb + 2 * stat}[kernel]
    t_bytes = moved / b1_ab.HBM_BYTES_PER_S
    t_ops = _MATMULS[kernel] * 2 * b * h * s * s * 64 / b1_ab.PEAK_FLOPS["fp32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("fp32_bwd: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(b1_ab.card_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name, (b, h, s) in SHAPES.items():
        q, k, v, do = (torch.randn(b, h, s, 64, generator=gen, device="cuda")
                       for _ in range(4))
        scale = 64 ** -0.5
        kw = dict(causal=False, sm_scale=scale, kv_len=s, tile_dtype=None)
        o, lse = fa2.fa2_forward_aligned(q, k, v, **kw)
        di = (o * do).sum(dim=-1)
        fused = fused_route(q, k)
        calls = ({"fa2_backward_fused": lambda: bwd.fa2_backward_fused_aligned(
                     q, k, v, o, do, lse, **kw)} if fused else
                 {"fa2_backward_dq": lambda: bwd.fa2_backward_dq_aligned(
                     q, k, v, do, lse, di, **kw),
                  "fa2_backward_dkv": lambda: bwd.fa2_backward_dkv_aligned(
                      q, k, v, do, lse, di, **kw)})
        library_ms = b1_ab.device_ms(efficient_backward(q, k, v, do, scale))
        total = 0.0
        for kernel, fn in calls.items():
            ms = b1_ab.device_ms(fn)
            total += ms
            flops = _MATMULS[kernel] * 2 * b * h * s * s * 64
            bound_ms, bound_by = bound(kernel, b, h, s)
            row = dict(config=name, kernel=kernel, route="fused" if fused else "split",
                       B=b, H=h, S=s, D=64, device_ms=ms, tflops=flops / ms / 1e9,
                       bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            rows.append(row)
            print("fp32 backward", json.dumps(row), flush=True)
        print("fp32 backward route", json.dumps(dict(
            config=name, route="fused" if fused else "split", device_ms=total,
            library_ms=library_ms)), flush=True)
        del q, k, v, do, o, lse, di
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
