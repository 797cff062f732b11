"""Kernel launch counts, one per hand-written kernel, keyed by name:

  fa2_forward (B1), fa2_forward_small (B8), fa2_backward_fused (B2),
  fa2_backward_dq (B3), fa2_backward_dkv (B4), paged_decode (B5),
  paged_chunk (B6; paged_chunk_fp32_tile counts the launches of those that
  ran its fp32 tile body), fa2_forward_quant (B7), fa1 (B9), naive_fa2
  (B10), r5_d128_fwd (X).  A launch with a sliding window also counts under
  the kernel's name with `_window` appended (B1-B8), and one with segment
  ids under `_segments` (B1-B4, B7, B8).  A launch at head dim 32 or 256
  (B1-B10) also counts under `<name>_d32` or `<name>_d256`, and a
  windowed one there under `<name>_d32_window` or `<name>_d256_window`
  too.  A launch on fp16 inputs (B1-B8; fp16 q in B7) also counts under
  `<name>_fp16in`, and B9's and B10's on bf16 inputs under `<name>_bf16in`.

A wrapper adds one where it launches its kernel and nowhere else.  A
reader sets counts to 0 (`reset`) and reads `LAUNCHES`; a missing name
reads 0.  decode/graphs.py snapshots the counts around a capture and adds
the capture's launches at every replay."""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter[str] = collections.Counter()


def count(name: str, window=None, segments=None, head_dim=None,
          inputs: str | None = None) -> None:
    """One launch of kernel `name`, with a sliding window unless `window`
    is None, with segment ids unless `segments` is None, at `head_dim`, on
    `inputs` ("fp16", "bf16") where the caller counts its input type."""
    LAUNCHES[name] += 1
    if inputs is not None:
        LAUNCHES[f"{name}_{inputs}in"] += 1
    if window is not None:
        LAUNCHES[name + "_window"] += 1
    if segments is not None:
        LAUNCHES[name + "_segments"] += 1
    if head_dim in (32, 256):
        LAUNCHES[f"{name}_d{head_dim}"] += 1
        if window is not None:
            LAUNCHES[f"{name}_d{head_dim}_window"] += 1


def reset(*names: str) -> None:
    """Set the named counts (every count, with no names) to 0."""
    for name in names or list(LAUNCHES):
        LAUNCHES[name] = 0
