"""Benchmark/accuracy config matrix.

Counterpart of cuda_flash_attention_tpu/bench/configs.py, copied rather than
imported: the 10 named configs of the reference suite (including
Edge-NonPowerOf2 S=100 and Edge-SmallSeq S=32), the 3-kernel experiment
cross, and the sequence-length scaling sweep at B4 H8 D64.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TestConfig:
    name: str
    batch_size: int
    num_heads: int
    seq_len: int
    head_dim: int
    kernel_type: str = "fa2"     # fa2 | fa2-naive | fa1 | vanilla-attn
    test_mode: str = "forward"   # forward | backward | both
    precision: str = "fp32"      # fp32 | bf16 | fp16 (tile dtype)
    tolerance: float = 1e-3
    seed: int = 42


_BASE = [
    # (name, B, H, S, D)
    ("Small-1", 1, 1, 128, 64),
    ("Small-2", 2, 4, 256, 64),
    ("Small-3", 2, 8, 256, 64),
    ("Medium-1", 2, 8, 512, 64),
    ("Medium-2", 4, 8, 512, 64),
    ("Large-1", 2, 8, 1024, 64),
    ("Large-2", 4, 12, 1024, 64),
    ("Edge-NonPowerOf2", 8, 16, 100, 64),
    ("Edge-SmallSeq", 8, 16, 32, 64),
    ("Stress-1", 8, 16, 2048, 64),
]


def create_test_configs(test_mode="forward", kernel_type="fa2",
                        precision="fp32", tolerance=1e-3):
    return [
        TestConfig(
            name=n, batch_size=b, num_heads=h, seq_len=s, head_dim=d,
            kernel_type=kernel_type, test_mode=test_mode,
            precision=precision, tolerance=tolerance,
        )
        for n, b, h, s, d in _BASE
    ]


def create_experiment_configs(mode="forward", precision="fp32", tolerance=1e-3):
    """All kernels x all configs (forward); fa2 only for backward/both."""
    if mode == "forward":
        kernel_types = ["fa2-naive", "vanilla-attn", "fa2"]
    else:
        kernel_types = ["fa2"]
    configs = []
    for kt in kernel_types:
        configs.extend(create_test_configs(mode, kt, precision, tolerance))
    return configs


def create_sequence_length_experiment_configs(mode="forward", precision="fp32",
                                              tolerance=1e-3, extended=False):
    """S in {128..4096} at B=4 H=8 D=64.

    ``extended=True`` adds the long-context points (8k-32k, B=1, FA2 only —
    the materialized baselines would need an S x S buffer in device
    memory)."""
    seq_lengths = [128, 256, 512, 1024, 2048, 4096]
    if mode == "forward":
        kernel_types = ["fa2-naive", "vanilla-attn", "fa2"]
    else:
        kernel_types = ["fa2"]
    extra = []
    if extended:
        # All modes: the harness switches to the Q-chunked oracle (forward)
        # and the checkpointed chunked gradient oracle (backward/both) above
        # the 1 GB score-buffer threshold.
        extra = [
            TestConfig(
                name=f"LongCtx-S{s}-FA2", batch_size=1, num_heads=8,
                seq_len=s, head_dim=64, kernel_type="fa2", test_mode=mode,
                precision=precision, tolerance=tolerance,
            )
            for s in (8192, 16384, 32768)
        ]
    return [
        TestConfig(
            name=f"SeqLen-S{s}-{kt.upper()}", batch_size=4, num_heads=8,
            seq_len=s, head_dim=64, kernel_type=kt, test_mode=mode,
            precision=precision, tolerance=tolerance,
        )
        for s in seq_lengths
        for kt in kernel_types
    ] + extra
