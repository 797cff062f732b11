"""What B7's Hopper bodies (csrc/fa2_forward_quant.cu) and B6's fp32 tile
body rest on, checked on the CPU: every stored code the converter warps and
the FMA block's decode produce is exact in the type they write (bf16 for the
wgmma body, fp32 for the FMA block), so converting once a block loses
nothing against the plain version's kv_storage_cast; the 2^23 magic-number
decodes of csrc/paged_kv.cuh, emulated with the source's own constants, give
every int8 and int4 code; and chip_smoke's phase 1 gates every B7
instantiation (both bodies).  No kernel runs here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from cuda_flash_attention_tpu_torch.kernels.common import kv_storage_cast

CSRC = Path(__file__).resolve().parent.parent / "cuda_flash_attention_tpu_torch" / "csrc"


def _codes(dtype):
    """Every finite value of a 1-byte storage type, as fp32."""
    if dtype == torch.int8:
        return torch.arange(-128, 128, dtype=torch.int8).float()
    x = torch.arange(256, dtype=torch.uint8).view(dtype).float()
    return x[torch.isfinite(x)]


@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn, torch.float8_e5m2],
                         ids=str)
def test_every_stored_code_is_exact_in_bf16(dtype):
    x = _codes(dtype)
    assert len(x) >= 248  # e5m2: 256 less its infinities and NaNs
    assert torch.equal(x.to(torch.bfloat16).float(), x)


def test_int4_codes_are_exact_in_bf16_and_decode_split_half():
    """Packed int4 [.., D/2]: byte j holds element j (low nibble) and j + D/2
    (high), as the converters unpack it; all 16 codes are exact in bf16."""
    lo = np.arange(-8, 8)
    hi = np.arange(7, -9, -1)
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8).view(np.int8)
    got = kv_storage_cast(torch.from_numpy(packed)[None], 32, torch.bfloat16).float()[0]
    assert torch.equal(got, torch.from_numpy(np.concatenate([lo, hi]).astype(np.float32)))


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte n is byte (s >> 4n) & 7 of y:x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n) for n in range(4))


def _as_float(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


def _magic(fn: str):
    """(xor mask, byte_perm's y and selector, the subtrahend) of one of
    csrc/paged_kv.cuh's decodes."""
    src = (CSRC / "paged_kv.cuh").read_text()
    body = src[src.index(f"void {fn}("):]
    body = body[:body.index("\n}\n")]
    mask = int(re.search(r"w \^ (0x[0-9A-Fa-f]+)u", body).group(1), 16)
    y, sel = (int(v, 16) for v in re.search(
        r"__byte_perm\(\w+, (0x[0-9A-Fa-f]+)u, (0x[0-9A-Fa-f]+)u \| i\)", body).groups())
    sub = float(re.search(r"- (\d+)\.f", body).group(1))
    return mask, y, sel, sub


def test_int8_magic_number_decode_gives_every_code():
    mask, y, sel, sub = _magic("int8x4_to_float")
    for b in range(256):
        w = b * 0x01010101  # the byte in all four lanes
        u = w ^ mask
        for i in range(4):
            got = _as_float(_byte_perm(u, y, sel | i)) - sub
            assert got == np.int8(np.uint8(b)), (b, i, got)


def test_int4_magic_number_decode_gives_every_code():
    mask, y, sel, sub = _magic("int4x8_to_float")
    for b in range(256):
        w = b * 0x01010101
        u = w ^ mask
        lo, hi = u & 0x0F0F0F0F, (u >> 4) & 0x0F0F0F0F
        want_lo = ((b & 0xF) ^ 8) - 8
        want_hi = ((b >> 4) ^ 8) - 8
        for i in range(4):
            assert _as_float(_byte_perm(lo, y, sel | i)) - sub == want_lo
            assert _as_float(_byte_perm(hi, y, sel | i)) - sub == want_hi


def _ptxas_report(names, spill=0, note=False):
    """ptxas -v lines for kernels `names` (mangled), as nvcc prints them."""
    lines = []
    for name in names:
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  "ptxas info    : Used 168 registers, used 1 barriers"]
        if note:
            lines.append(f"ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async "
                         f"instructions are serialized in the function '{name}'")
    return "\n".join(lines)


_NS = "_ZN53_GLOBAL__N__8e41f3ce_20_fa2_forward_quant_cu_667adafb"
_TQ = ("f", "13__nv_bfloat16")
_TC = ("a", "13__nv_fp8_e4m3", "13__nv_fp8_e5m2", "NS_6Int4x2E")
B7_ENTRIES = (
    [f"{_NS}19fa2_fwd_quant_wgmmaI{tq}{tc}Li{d}EEEv14CUtensorMap_stS2_PKT_PKfS7_PS3_"
     "PfPKiSA_iiiiifiiNS_9QuantDeadE" for tq in _TQ for tc in _TC for d in (64, 128)]
    + [f"{_NS}18fa2_fwd_quant_fp32I{tq}{tc}Li{d}ELb{seg}EEvPKT_PKhPKfS6_S8_PS2_PfPKiSB_"
       "iiiiifiiNS_9QuantDeadE"
       for tq in _TQ for tc in _TC for d in (64, 128) for seg in (0, 1)])


def test_phase_1_gates_every_b7_instantiation():
    """chip_smoke's phase 1 holds B7's 48 instantiations (the wgmma body, 4
    storages x 2 q types x D 64 and 128, and the FMA-block body, those
    without and with segment ids): clean reports pass, one spilled byte, a
    wgmma serialisation note or a missing instantiation fails."""
    functions, count = chip_smoke.B7_FUNCTIONS
    assert count == len(B7_ENTRIES) == 48
    chip_smoke.check_ptxas(_ptxas_report(B7_ENTRIES), "B7", functions, count)
    with pytest.raises(AssertionError, match="spills"):
        chip_smoke.check_ptxas(_ptxas_report(B7_ENTRIES[:47]) + "\n"
                               + _ptxas_report(B7_ENTRIES[47:], spill=4),
                               "B7", functions, count)
    with pytest.raises(AssertionError, match="serialises"):
        chip_smoke.check_ptxas(_ptxas_report(B7_ENTRIES[1:]) + "\n"
                               + _ptxas_report(B7_ENTRIES[:1], note=True),
                               "B7", functions, count)
    with pytest.raises(AssertionError, match="only 47"):
        chip_smoke.check_ptxas(_ptxas_report(B7_ENTRIES[1:]), "B7", functions, count)
