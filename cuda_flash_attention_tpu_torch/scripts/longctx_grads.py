"""The harness's long-context gradients, checked against fp64: which of dQ,
dK and dV differ between the kernels (`--mode both`, fp32 tiles), the
fp32 chunked oracle (ops/reference.reference_attention_grads) and SDPA's
fp32 memory-efficient backward, and which of them is right.

    python -m cuda_flash_attention_tpu_torch.scripts.longctx_grads --seq 8192,32768

At each length (the LongCtx configs: B1 H8 D64, the harness's seeded
uniform inputs, loss sum(O)) it prints one JSON line per gradient: its
largest |value|, the largest difference between each pair, and each one's
against an fp64 Q-chunked reference on `--fp64-heads` heads.  The oracle
is also run with the row max carrying its gradient, as it did before
ops/reference.py detached it (`oracle_max_grad`).  The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from cuda_flash_attention_tpu_torch.bench.configs import TestConfig
from cuda_flash_attention_tpu_torch.bench.harness import Harness
from cuda_flash_attention_tpu_torch.dispatch import run_flash_attention
from cuda_flash_attention_tpu_torch.ops.reference import reference_attention_grads
from cuda_flash_attention_tpu_torch.scripts.b1_ab import card_line


def chunked_grads(q, k, v, dtype, max_grad: bool, chunk: int = 512):
    """dQ, dK, dV of sum(softmax(q k^T / sqrt(D)) v) in `dtype`, Q-chunked
    under checkpoint; with `max_grad` the row max keeps its gradient."""
    ts = [t.to(dtype).detach().requires_grad_() for t in (q, k, v)]
    scale = q.shape[-1] ** -0.5

    def one(qi, kk, vv):
        s = (qi @ kk.transpose(-1, -2)) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - (m if max_grad else m.detach()))
        return (p @ vv / p.sum(-1, keepdim=True)).sum()

    loss = sum(checkpoint(one, ts[0][:, :, r:r + chunk], ts[1], ts[2],
                          use_reentrant=False) for r in range(0, q.shape[2], chunk))
    return torch.autograd.grad(loss, ts)


def sdpa_grads(q, k, v):
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        o = torch.nn.functional.scaled_dot_product_attention(*ts)
        return torch.autograd.grad(o.sum(), ts)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", default="8192,16384,32768")
    ap.add_argument("--fp64-heads", default="0,5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("longctx_grads: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    rows = []
    for s in (int(x) for x in args.seq.split(",")):
        q, k, v = Harness(device="cuda")._make_qkv(TestConfig(f"LongCtx-S{s}-FA2", 1, 8,
                                                              s, 64))
        out = run_flash_attention("fa2", "forward_backward", "fp32", q, k, v)
        grads = {"kernel": [out[n] for n in ("dq", "dk", "dv")],
                 "oracle": reference_attention_grads(q, k, v, chunked=True),
                 "oracle_max_grad": chunked_grads(q, k, v, torch.float32, True),
                 "sdpa": sdpa_grads(q, k, v)}
        del out
        fp64 = {h: chunked_grads(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1],
                                 torch.float64, False)
                for h in (int(x) for x in args.fp64_heads.split(","))}
        for i, name in enumerate(("dq", "dk", "dv")):
            row = dict(S=s, grad=name, max_abs=grads["oracle"][i].abs().max().item())
            for a, b in (("kernel", "oracle"), ("kernel", "sdpa"), ("oracle", "sdpa"),
                         ("oracle_max_grad", "oracle")):
                row[f"{a}_vs_{b}"] = (grads[a][i] - grads[b][i]).abs().max().item()
            for who, g in grads.items():
                row[f"{who}_vs_fp64"] = max(
                    (g[i][:, h:h + 1].double() - ref[i]).abs().max().item()
                    for h, ref in fp64.items())
            rows.append(row)
            print("LongCtx grads", json.dumps(row), flush=True)
        del grads, fp64
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
