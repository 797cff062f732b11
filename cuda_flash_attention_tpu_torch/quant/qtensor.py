"""Quantized tensor container and quantize/dequantize ops.

Counterpart of cuda_flash_attention_tpu/quant/qtensor.py: the same
container, layouts and arithmetic, in torch on the tensor's own device, so
that the same inputs give the same bytes as the JAX package:
  * int8 values are round-half-even of x / scale (a division, not a
    multiplication by the inverse), clipped to +-127;
  * fp8 values are clip(x / scale, +-qmax) cast to the fp8 type, which
    rounds to nearest even in both packages;
  * int4 weights pack two rows per byte (row 2r in the low nibble, 2r+1 in
    the high one, group-wise scales); int4 K/V packs split-half along the
    last axis (byte j holds element j low and element j + D/2 high).

Scales are symmetric per-slice absmax: scale = max(amax, 1e-12) / qmax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# Largest-magnitude finite value per storage dtype.
_QMAX = {
    torch.int8: 127.0,
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
}


def supported_quant_dtypes():
    return tuple(_QMAX)


def qmax_for(dtype: torch.dtype) -> float:
    if dtype not in _QMAX:
        raise ValueError(
            f"unsupported quantization dtype {dtype}; supported: {list(_QMAX)}"
        )
    return _QMAX[dtype]


def _is_int4(dtype) -> bool:
    return isinstance(dtype, str) and dtype == "int4"


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """values: int8/fp8 tensor; scales: fp32 with the quantized axes reduced
    to 1.  dequantized x ~= values.float() * scales (broadcast).

    ``act_quant``: matmuls against this tensor also quantize the activations
    to int8 and contract int8 x int8 (W8A8, quant/linear.py).
    ``bits=4`` with ``group_size``: a packed group-wise int4 [in, out]
    weight (pairs along the in axis, scales per (group, column)); ``bits=4``
    without it: packed split-half int4 K/V (width D/2)."""

    values: torch.Tensor
    scales: torch.Tensor
    act_quant: bool = False
    bits: int = 8
    group_size: int = 0

    @property
    def shape(self):
        if self.bits == 4:
            if self.group_size:  # packed weight: pairs along the in axis
                return (self.values.shape[0] * 2,) + tuple(self.values.shape[1:])
            # packed K/V: split-half along the last axis
            return tuple(self.values.shape[:-1]) + (self.values.shape[-1] * 2,)
        return tuple(self.values.shape)

    @property
    def ndim(self):
        # The logical rank: models/lora.apply_lora matches 2-D projections
        # by it, packed int4 included.
        return len(self.shape)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def to(self, device) -> "QuantizedTensor":
        """The same tensor on `device`: values and fp32 scales unchanged."""
        return dataclasses.replace(self, values=self.values.to(device),
                                   scales=self.scales.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.bits == 4 and self.group_size:  # packed weight
            v = unpack_int4(self.values).float()  # [in, out]
            g = self.group_size
            w = v.reshape(v.shape[0] // g, g, v.shape[1]) * self.scales
            return w.reshape(v.shape).to(dtype)
        if self.bits == 4:  # packed K/V
            from cuda_flash_attention_tpu_torch.kernels.common import (
                kv_storage_cast,
            )

            v = kv_storage_cast(self.values, self.values.shape[-1] * 2,
                                torch.float32)
            return (v * self.scales).to(dtype)
        return (self.values.float() * self.scales).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[in, out] int8 values in [-8, 7] -> [in/2, out] int8 with row 2r in
    the low nibble and row 2r+1 in the high nibble."""
    lo = q[0::2] & 0xF
    hi = q[1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: sign-extended 4-bit values as int8."""
    lo = ((packed & 0xF) ^ 8) - 8          # sign-extend the low nibble
    hi = packed >> 4                        # arithmetic shift keeps the sign
    n2, out = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(n2 * 2, out).to(torch.int8)


def quantize_int4(w: torch.Tensor, group_size: int = 128) -> QuantizedTensor:
    """Group-wise symmetric int4 for a 2-D [in, out] weight: scales per
    (group_size input rows, output column)."""
    if w.ndim != 2:
        raise ValueError(f"int4 quantization expects 2D weights; {tuple(w.shape)}")
    in_dim, out = w.shape
    group_size = min(group_size, in_dim)
    if in_dim % group_size or in_dim % 2:
        raise ValueError(
            f"int4 needs group_size | in_dim and an even in_dim; got "
            f"in_dim={in_dim} group_size={group_size}"
        )
    wf = w.float().reshape(in_dim // group_size, group_size, out)
    amax = wf.abs().amax(dim=1, keepdim=True)  # [G, 1, out]
    scales = amax.clamp_min(1e-12) / 7.0
    q = torch.round(wf / scales).clamp(-8, 7).to(torch.int8)
    return QuantizedTensor(values=pack_int4(q.reshape(in_dim, out)),
                           scales=scales, bits=4, group_size=group_size)


def quantize(x: torch.Tensor, dtype=torch.int8,
             axis: int | Sequence[int] = -1) -> QuantizedTensor:
    """Symmetric absmax quantization along `axis` (reduced in the scales)."""
    qmax = qmax_for(dtype)
    x = x.float()
    amax = x.abs().amax(dim=axis, keepdim=True)
    scales = amax.clamp_min(1e-12) / qmax
    q = x / scales
    if dtype == torch.int8:
        values = torch.round(q).clamp(-qmax, qmax).to(torch.int8)
    else:
        values = q.clamp(-qmax, qmax).to(dtype)
    return QuantizedTensor(values=values, scales=scales)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)


def pack_int4_split_half(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two per byte split-half along the last
    axis: byte j holds element j (low nibble) and element j + D/2 (high
    nibble).  The one definition of the K/V packing; its inverse is
    kernels/common.kv_storage_cast."""
    d = q.shape[-1]
    if d % 2:
        raise ValueError(f"int4 split-half packing needs an even D; {d}")
    return ((q[..., : d // 2] & 0xF) | (q[..., d // 2:] << 4)).to(torch.int8)


def quantize_rows_int4(x: torch.Tensor):
    """Per-row (last-axis) symmetric int4: (packed values, scales[..., 1])
    at qmax 7, shared by the KV-cache writers and quantize_kv."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scales = amax.clamp_min(1e-12) / 7.0
    q = torch.round(x / scales).clamp(-8, 7).to(torch.int8)
    return pack_int4_split_half(q), scales


def _quantize_kv_int4(x: torch.Tensor) -> QuantizedTensor:
    """Per-token int4 for [B, H, S, D] K/V (split-half packed)."""
    packed, scales = quantize_rows_int4(x)
    return QuantizedTensor(values=packed, scales=scales, bits=4)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, dtype=torch.int8):
    """Per-token (per [b, h, s] row) quantization of K and V [B, H, S, D],
    the layout the quantized attention kernel (B7) reads.  dtype "int4"
    packs two values per byte (split-half)."""
    if _is_int4(dtype):
        return _quantize_kv_int4(k), _quantize_kv_int4(v)
    return quantize(k, dtype, axis=-1), quantize(v, dtype, axis=-1)
