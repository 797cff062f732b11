"""Harness CLI, with the flags of the JAX package's:

  python -m cuda_flash_attention_tpu_torch.bench --mode forward --kernel fa2
  python -m cuda_flash_attention_tpu_torch.bench --experiment
  python -m cuda_flash_attention_tpu_torch.bench --seqlen-experiment [--extended]

`--extended` adds the long-context points (LongCtx-S8192/16384/32768, B1 H8
D64, fa2 only, against the Q-chunked oracles).  It runs on the CUDA card
unless `--device cpu` asks for the CPU (where no time is taken).
`--save-results` writes the CSV and draws the plots of bench/plots.py
where matplotlib imports; where it does not, one line says that the plots
were not drawn and why.  Exit code 1 when any config failed.
"""

from __future__ import annotations

import argparse
import os


def save_plots(rows, output_dir: str, prefix: str, device: str = "cuda") -> list[str]:
    """bench/plots.py's figures of the rows, or one line saying why none
    was drawn (a CPU run has no device times; matplotlib does not
    import)."""
    if device == "cpu":
        print("Plots not drawn: a CPU run takes no device times")
        return []
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"Plots not drawn: matplotlib does not import ({e})")
        return []
    from cuda_flash_attention_tpu_torch.bench.plots import generate_plots

    paths = generate_plots(rows, output_dir, prefix=prefix)
    for path in paths:
        print(f"Saved plot: {path}")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description="FlashAttention-2 benchmark harness "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--mode", choices=["forward", "backward", "both"],
                   default="forward")
    p.add_argument("--kernel", choices=["fa2", "fa2-naive", "fa1", "vanilla-attn"],
                   default="fa2")
    p.add_argument("--precision", choices=["fp32", "bf16", "fp16"], default="fp32")
    p.add_argument("--experiment", action="store_true",
                   help="cross all kernels x all configs")
    p.add_argument("--seqlen-experiment", action="store_true",
                   help="sequence-length scaling sweep (S=128..4096)")
    p.add_argument("--extended", action="store_true",
                   help="add long-context points (8k-32k) to the seqlen sweep")
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--no-stop-on-failure", action="store_true")
    p.add_argument("--save-results", action="store_true")
    p.add_argument("--output-dir", default="plots")
    p.add_argument("--no-oracle-timing", action="store_true",
                   help="skip timing the (slow) materialized oracle")
    p.add_argument("--configs", nargs="*", default=None,
                   help="subset of config names to run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from cuda_flash_attention_tpu_torch.bench.configs import (
        create_experiment_configs,
        create_sequence_length_experiment_configs,
        create_test_configs,
    )
    from cuda_flash_attention_tpu_torch.bench.harness import Harness

    if args.mode in ("backward", "both") and args.kernel != "fa2":
        p.error("backward/both modes support only --kernel fa2")

    if args.seqlen_experiment:
        configs = create_sequence_length_experiment_configs(
            args.mode, args.precision, args.tolerance, extended=args.extended
        )
    elif args.experiment:
        configs = create_experiment_configs(args.mode, args.precision, args.tolerance)
    else:
        configs = create_test_configs(
            args.mode, args.kernel, args.precision, args.tolerance
        )
    if args.configs:
        configs = [c for c in configs if any(s in c.name for s in args.configs)]

    h = Harness(
        tolerance=args.tolerance,
        stop_on_failure=not args.no_stop_on_failure,
        time_oracle=not args.no_oracle_timing,
        device=args.device,
    )
    h.run(configs)
    print()
    print(h.summary())

    if args.save_results:
        os.makedirs(args.output_dir, exist_ok=True)
        prefix = "" if args.mode == "forward" else f"{args.mode}_"
        if args.seqlen_experiment:
            prefix += "seqlen_"
        csv_path = os.path.join(args.output_dir, f"{prefix}experiment_results.csv")
        h.save_csv(csv_path)
        print(f"\nSaved results to: {csv_path}")
        save_plots([r.as_row() for r in h.results], args.output_dir, prefix,
                   args.device)

    n_fail = sum(not r.passed for r in h.results)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
