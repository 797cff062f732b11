// Paged KV cache elements for the port's paged attention kernels (B5,
// csrc/paged_decode.cu; B6, csrc/paged_chunk.cu): the storage types of a
// page (fp32, bf16, int8, fp8 e4m3 / e5m2, and int4 packed split-half),
// their stored row widths, their exact conversions to fp32 (int8 and int4
// by the 2^23 magic number), the output store and loads of N bytes.
// Everything sits in an anonymous namespace: each source that includes it
// is its own shared library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// A byte of packed int4 pages: two signed nibbles.
struct Int4x2 {
  int8_t b;
};

template <typename Tc>
constexpr bool kPacked = std::is_same<Tc, Int4x2>::value;
// Stored bytes of one cached row of D elements.
template <typename Tc, int D>
constexpr int kRowBytesOf = kPacked<Tc> ? D / 2 : D * static_cast<int>(sizeof(Tc));

// The four signed bytes of w as floats, exactly, by the 2^23 magic number:
// byte + 128 becomes the low mantissa bits of 2^23, and one subtraction
// removes both.  No integer-to-float conversion, which runs at a quarter of
// the FMA rate and would otherwise set a chunk's time.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __int_as_float(__byte_perm(u, 0x4B00u, 0x5440u | i)) - 8388736.f;
  }
}

// The low and the high nibbles of w's four bytes, signed int4, as floats
// (exactly, as int8x4_to_float with nibble + 8).
__device__ __forceinline__ void int4x8_to_float(uint32_t w, float (&lo)[4],
                                                float (&hi)[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l = u & 0x0F0F0F0Fu;
  const uint32_t h = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __int_as_float(__byte_perm(l, 0x4B00u, 0x5440u | i)) - 8388616.f;
    hi[i] = __int_as_float(__byte_perm(h, 0x4B00u, 0x5440u | i)) - 8388616.f;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N bytes (2, 4, 8 or 16, aligned to N) of shared memory in one load.
template <int N>
struct Bytes;
template <>
struct Bytes<2> {
  using T = uint16_t;
};
template <>
struct Bytes<4> {
  using T = uint32_t;
};
template <>
struct Bytes<8> {
  using T = uint2;
};
template <>
struct Bytes<16> {
  using T = uint4;
};

}  // namespace
