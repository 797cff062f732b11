"""FlashAttention-2 forward: kernel B1 and its plain PyTorch version.

Replaces cuda_flash_attention_tpu/kernels/fa2_forward.py::fa2_forward_aligned
(the Pallas TPU kernel).  The CUDA kernel is csrc/fa2_forward.cu; its source
note says what bounds it on the H100 and how its design answers that.  On a
CPU tensor the wrapper runs `fa2_forward_plain`; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cuda_flash_attention_tpu_torch.kernels import _build
from cuda_flash_attention_tpu_torch.kernels.common import (
    DEFAULT_MASK_VALUE,
    LN2,
    LOG2E,
    build_element_mask,
)

# Kernel launches since the last reset (the wrapper adds one per launch).
launches = 0

_SOURCE = "fa2_forward"
_HEAD_DIMS = (64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    fn = lib.cfa_fa2_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def fa2_forward_aligned(q, k, v, *, causal: bool, sm_scale: float,
                        kv_len: int, tile_dtype=None):
    """FA2 forward over sequence-padded q [B, Hq, Sq, D] and k/v
    [B, Hkv, Skv, D] (Hq a multiple of Hkv; query head h reads KV head
    h // (Hq // Hkv)).  Keys at or past `kv_len` are masked.  Returns
    (O like q, lse [B, Hq, Sq] fp32, natural log)."""
    if q.device.type == "cpu":
        return fa2_forward_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                 kv_len=kv_len, tile_dtype=tile_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_forward: unsupported device {q.device}")
    global launches
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16) or tile_dtype not in (
            None, torch.bfloat16):
        raise NotImplementedError(
            f"fa2_forward kernel: inputs fp32/bf16 and tiles None/bf16; got "
            f"{q.dtype} with tile_dtype {tile_dtype}"
        )
    in_bf16 = q.dtype == torch.bfloat16
    bf16_tiles = tile_dtype == torch.bfloat16 or in_bf16
    if d not in _HEAD_DIMS:
        raise NotImplementedError(f"fa2_forward kernel: head_dim {d} not in {_HEAD_DIMS}")
    if b * hq > 65535:
        raise NotImplementedError("fa2_forward kernel: batch * heads > 65535")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("fa2_forward kernel: q/k/v must be contiguous, "
                             "on one device, of one dtype")
        if t.data_ptr() % 16:
            raise ValueError("fa2_forward kernel: inputs must be 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32)
    lib = _lib()
    err = lib.cfa_fa2_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, hq, hkv, sq, skv, d, kv_len, sm_scale * LOG2E, int(causal),
        int(in_bf16), int(bf16_tiles),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, "cfa_fa2_forward_error_string", err, "fa2_forward")
    launches += 1
    return o, lse


def fa2_forward_plain(q, k, v, *, causal: bool, sm_scale: float,
                      kv_len: int, tile_dtype=None):
    """The kernel's function in plain PyTorch, with the TPU kernel's rounding
    points: Q is scaled by sm_scale*log2(e) in fp32 and then rounded to the
    tile type; K and V are cast to it; S and the softmax are fp32 (exp2
    domain, masked scores at DEFAULT_MASK_VALUE, masked P exactly 0); P is
    rounded to the tile type before the PV product; O = PV / l with l == 0
    guarded; lse = m*ln2 + log(l).  The tile type is `tile_dtype`, else q's
    dtype.

    It takes the whole row at once rather than tile by tile, and it does not
    reproduce two bf16 details of the TPU kernel, so parity at bf16 is a
    tolerance, not bits:
      * the bf16 exp2 chain the TPU kernel uses for score tiles of at least
        2^18 elements (fa2_forward.py:84, 221);
      * the bf16-rounded rowsum that V-augmentation gives at D < 128
        (fa2_forward.py:66-75, 228-229): here l sums the fp32 P.
    """
    eff = tile_dtype if tile_dtype is not None else q.dtype
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    qs = (q.float() * (sm_scale * LOG2E)).to(eff).float()
    ks = k.to(eff).float()
    vs = v.to(eff).float()
    s = qs @ ks.transpose(-1, -2)
    mask = build_element_mask(q.shape[2], k.shape[2], causal=causal,
                              kv_len=kv_len, device=q.device)
    if mask is not None:
        s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(eff).float() @ vs
    o = pv * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = m * LN2 + torch.log(torch.where(l == 0.0, 1.0, l))
    return o.to(q.dtype), lse[..., 0]
