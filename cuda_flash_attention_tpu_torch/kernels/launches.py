"""Kernel launch counts, one per hand-written kernel, keyed by name:

  fa2_forward (B1), fa2_forward_small (B8), fa2_backward_fused (B2),
  fa2_backward_dq (B3), fa2_backward_dkv (B4), paged_decode (B5),
  paged_chunk (B6; paged_chunk_fp32_tile counts the launches of those that
  ran its fp32 tile body), fa2_forward_quant (B7), fa1 (B9), naive_fa2
  (B10), r5_d128_fwd (X).  A launch with a sliding window also counts under
  the kernel's name with `_window` appended (B1, B8, B5, B6).

A wrapper adds one where it launches its kernel and nowhere else.  A
reader sets counts to 0 (`reset`) and reads `LAUNCHES`; a missing name
reads 0.  decode/graphs.py snapshots the counts around a capture and adds
the capture's launches at every replay."""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter[str] = collections.Counter()


def count(name: str, window=None) -> None:
    """One launch of kernel `name`, with a sliding window unless `window`
    is None."""
    LAUNCHES[name] += 1
    if window is not None:
        LAUNCHES[name + "_window"] += 1


def reset(*names: str) -> None:
    """Set the named counts (every count, with no names) to 0."""
    for name in names or list(LAUNCHES):
        LAUNCHES[name] = 0
