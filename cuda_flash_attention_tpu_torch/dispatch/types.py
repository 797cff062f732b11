"""Method/mode/precision enums of the dispatch layer.

Counterpart of cuda_flash_attention_tpu/dispatch/types.py, copied rather than
imported: the port never imports the JAX package.  Note the CLI's method
`naive` means VANILLA, the materialized oracle, not `fa2-naive`.
"""

from __future__ import annotations

import enum


class ComputeType(enum.Enum):
    VANILLA = "vanilla"  # materialized attention (ops/reference.py)
    FLASH_ATTENTION_1 = "fa1"
    FLASH_ATTENTION_2_NAIVE = "fa2-naive"
    FLASH_ATTENTION_2 = "fa2"

    @classmethod
    def parse(cls, s: str) -> "ComputeType":
        aliases = {
            "naive": cls.VANILLA,  # reference CLI calls vanilla "naive"
            "vanilla": cls.VANILLA,
            "vanilla-attn": cls.VANILLA,
            "fa1": cls.FLASH_ATTENTION_1,
            "fa2-naive": cls.FLASH_ATTENTION_2_NAIVE,
            "fa2_naive": cls.FLASH_ATTENTION_2_NAIVE,
            "fa2": cls.FLASH_ATTENTION_2,
        }
        try:
            return aliases[s.lower()]
        except KeyError:
            raise ValueError(
                f"unknown method {s!r}; expected one of {sorted(aliases)}"
            ) from None


class ModeType(enum.Enum):
    FORWARD = "forward"
    BACKWARD = "backward"
    FORWARD_BACKWARD = "forward_backward"

    @classmethod
    def parse(cls, s: str) -> "ModeType":
        s = s.lower().replace("-", "_")  # "forward-backward" is accepted too
        for m in cls:
            if m.value == s:
                return m
        raise ValueError(f"unknown mode {s!r}")


class ComputeDataType(enum.Enum):
    FP32 = "fp32"
    FP16 = "fp16"  # fp16 tiles
    BF16 = "bf16"  # bf16 tiles

    @classmethod
    def parse(cls, s: str) -> "ComputeDataType":
        for m in cls:
            if m.value == s.lower():
                return m
        raise ValueError(f"unknown precision {s!r}")
