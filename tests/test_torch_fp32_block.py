"""What stays around the fp32 FMA block of B10 and B1's fp32 body
(csrc/fma_block.cuh), on the CPU: B9 and B10 refuse inputs that cp.async
cannot copy 16 bytes at a time, and scripts/fp32_bwd.py times the fp32
backward bodies on the route and with the bounds that the harness's fp32
`fa2 both` rows meet.  No kernel runs here."""

import pytest
import torch

from cuda_flash_attention_tpu_torch.kernels import baselines
from cuda_flash_attention_tpu_torch.scripts import fp32_bwd


def _offset(shape, floats):
    """A contiguous fp32 tensor of `shape` that starts `floats` floats past
    a 16-byte boundary."""
    n = 1
    for x in shape:
        n *= x
    base = torch.zeros(n + 4)
    start = (-(base.data_ptr() // 4) + floats) % 4
    return base[start:start + n].view(shape)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_baselines_refuse_inputs_off_16_byte_boundaries(which):
    shape = (1, 2, 64, 64)
    t = {n: _offset(shape, 1 if n == which else 0) for n in "qkv"}
    assert all(x.is_contiguous() for x in t.values())
    baselines._check("naive_fa2", *(_offset(shape, 0) for _ in range(3)))
    with pytest.raises(ValueError, match="16-byte aligned"):
        baselines._check("naive_fa2", t["q"], t["k"], t["v"])


@pytest.mark.parametrize("config,fused", [("Large-2", True), ("Stress-1", False)])
def test_fp32_bwd_takes_the_harness_route(config, fused):
    """B2 at Large-2; B3 + B4 at Stress-1, where B2's dQ slices would pass
    the 1 GiB cap.  Shapes only: the tensors hold no data."""
    b, h, s = fp32_bwd.SHAPES[config]
    q = torch.empty(b, h, s, 64, device="meta")
    assert fp32_bwd.fused_route(q, q) is fused


@pytest.mark.parametrize("config,kernel,ms", [
    ("Large-2", "fa2_backward_fused", 0.4808),   # 5 products of S x S x D
    ("Stress-1", "fa2_backward_dq", 3.0770),     # 3
    ("Stress-1", "fa2_backward_dkv", 4.1027),    # 4
])
def test_fp32_bwd_bounds_are_the_fp32_operations(config, kernel, ms):
    b, h, s = fp32_bwd.SHAPES[config]
    got, by = fp32_bwd.bound(kernel, b, h, s)
    assert by == "operations" and got == pytest.approx(ms, rel=1e-4)
    flops = fp32_bwd._MATMULS[kernel] * 2 * b * h * s * s * 64
    assert got == pytest.approx(flops / 67e12 * 1e3)
