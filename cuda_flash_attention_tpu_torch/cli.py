"""Engine CLI: the reference CLI's contract on the card.

    python -m cuda_flash_attention_tpu_torch.cli \
        <naive|fa1|fa2|fa2-naive> <forward|backward|forward_backward> \
        <fp16|fp32|bf16> <data_dir> [--causal] [--device cuda|cpu]

Counterpart of cuda_flash_attention_tpu/cli.py, with the same contract:
  * the shape comes from the data dir's basename B{B}_H{H}_S{S}_D{D}, and
    Q.bin, K.bin, V.bin are raw little-endian fp32 (utils/io.py);
  * forward writes O.bin, and logsumexp.bin when the method gives one (the
    baselines fa1 and fa2-naive do not);
  * backward loads O.bin and logsumexp.bin, and dO.bin if present, else
    uses dO = 1; it writes dQ.bin, dK.bin and dV.bin;
  * forward_backward does both in one invocation;
  * exit code 2 for a usage error, 1 for a ValueError or FileNotFoundError.
`naive` is the materialized oracle (VANILLA), not `fa2-naive`.  The run is
on the CUDA card unless `--device cpu` asks for the CPU, where the kernels'
plain versions run.
"""

from __future__ import annotations

import os
import sys
import time

import torch


def run(method: str, mode: str, precision: str, data_dir: str,
        causal: bool = False, device="cuda") -> dict:
    from cuda_flash_attention_tpu_torch._device import resolve_device
    from cuda_flash_attention_tpu_torch.dispatch import (
        ModeType,
        run_flash_attention,
    )
    from cuda_flash_attention_tpu_torch.utils.io import (
        file_exists,
        load_binary_file,
        parse_config_string,
        save_binary_file,
    )
    from cuda_flash_attention_tpu_torch.utils.timing import Timer

    dev = resolve_device(device)
    b, h, s, d = parse_config_string(data_dir)
    shape = (b, h, s, d)
    print(f"[cfa-torch] config: B={b} H={h} S={s} D={d} on {dev}")

    def load(name, shape):
        return torch.from_numpy(
            load_binary_file(os.path.join(data_dir, name), shape)).to(dev)

    q, k, v = (load(n, shape) for n in ("Q.bin", "K.bin", "V.bin"))
    mode_t = ModeType.parse(mode)
    kwargs: dict = {}
    if mode_t == ModeType.BACKWARD:
        if not (file_exists(os.path.join(data_dir, "O.bin"))
                and file_exists(os.path.join(data_dir, "logsumexp.bin"))):
            raise FileNotFoundError(
                "backward mode requires O.bin and logsumexp.bin from a prior "
                "forward run"
            )
        kwargs["o"] = load("O.bin", shape)
        kwargs["lse"] = load("logsumexp.bin", (b, h, s))
    if mode_t in (ModeType.BACKWARD, ModeType.FORWARD_BACKWARD):
        if file_exists(os.path.join(data_dir, "dO.bin")):
            kwargs["do"] = load("dO.bin", shape)
            print("[cfa-torch] using dO.bin")
        else:
            print("[cfa-torch] dO.bin absent -> dO = 1 (L = sum(O))")

    timer = Timer()
    timer.start()
    out = run_flash_attention(method, mode_t, precision, q, k, v,
                              causal=causal, **kwargs)
    timer.stop()

    written = []
    if "o" in out:
        save_binary_file(os.path.join(data_dir, "O.bin"), out["o"])
        written.append("O.bin")
        if out.get("lse") is not None:
            save_binary_file(os.path.join(data_dir, "logsumexp.bin"), out["lse"])
            written.append("logsumexp.bin")
    for name, key in [("dQ.bin", "dq"), ("dK.bin", "dk"), ("dV.bin", "dv")]:
        if key in out:
            save_binary_file(os.path.join(data_dir, name), out[key])
            written.append(name)
    print(f"[cfa-torch] wrote {' '.join(written)} ({timer.mean_ms:.2f} ms on "
          "the host clock, kernel builds included)")
    return out


def usage() -> str:
    return (
        "usage: python -m cuda_flash_attention_tpu_torch.cli "
        "<naive|fa1|fa2|fa2-naive> <forward|backward|forward_backward> "
        "<fp16|fp32|bf16> <data_dir> [--causal] [--device cuda|cpu]"
    )


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    causal = "--causal" in argv
    argv = [a for a in argv if a != "--causal"]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print(usage(), file=sys.stderr)
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) != 4:
        print(usage(), file=sys.stderr)
        return 2
    method, mode, precision, data_dir = argv
    t0 = time.time()
    try:
        run(method, mode, precision, data_dir, causal=causal, device=device)
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        print(usage(), file=sys.stderr)
        return 1
    print(f"[cfa-torch] done in {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
