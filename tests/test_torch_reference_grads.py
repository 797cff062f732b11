"""The harness's gradient oracle (ops/reference.reference_attention_grads)
against an fp64 reference on the CPU: its row max carries no gradient, so
its fp32 dK stays at fp32 rounding along a long row, where the max's
gradient path (a sum that is zero only in exact arithmetic, routed to each
row's argmax key) gave an error that grows with the row's length (on an H100
at S 32768: 1.6e-3, cuda_flash_attention_tpu_torch/scripts/
longctx_grads.py)."""

import pytest
import torch

from cuda_flash_attention_tpu_torch.ops.reference import reference_attention_grads
from cuda_flash_attention_tpu_torch.scripts.longctx_grads import chunked_grads


@pytest.mark.parametrize("chunked", [True, False])
def test_oracle_gradients_hold_fp32_rounding_on_a_long_row(chunked):
    """Uniform inputs as the harness draws them, one head of S 4096: the
    oracle's dQ, dK, dV within 1e-6 of the fp64 gradients, where the
    row max with its gradient misses dK by several times that."""
    gen = torch.Generator().manual_seed(42)
    q, k, v = (torch.rand(1, 1, 4096, 64, generator=gen) for _ in range(3))
    want = chunked_grads(q, k, v, torch.float64, max_grad=False)
    got = reference_attention_grads(q, k, v, chunked=chunked)
    errs = [(g.double() - w).abs().max().item() for g, w in zip(got, want)]
    assert max(errs) <= 1e-6, errs
    with_max = chunked_grads(q, k, v, torch.float32, max_grad=True)
    assert (with_max[1].double() - want[1]).abs().max().item() > 2 * errs[1]
