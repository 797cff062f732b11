// Stored K/V elements for the port's kernels over paged or quantized K/V
// (B5, csrc/paged_decode.cu; B6, csrc/paged_chunk.cu; B7,
// csrc/fa2_forward_quant.cu): the storage types (fp32, bf16, int8, fp8
// e4m3 / e5m2, and int4 packed split-half), their stored row widths, their
// exact conversions to fp32 (int8 and int4 by the 2^23 magic number, fp8 by
// the card's fp8x2 conversion), the output store and loads of N bytes; and
// the fp32 FMA block's (csrc/fma_block.cuh) ring of stored-width K/V tiles,
// shared by B7's fp32 body and B6's fp32 tile body: each 64-row tile and its
// scales arrive by cp.async in their stored width, and the block decodes a
// landed tile once into its fp32 K and V stages.  Everything sits in an
// anonymous namespace: each source that includes it is its own shared
// library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "fma_block.cuh"  // the FMA block; includes hopper.cuh

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

// The four bytes of w (int8, fp8 e4m3 or e5m2, the lowest byte first) as
// floats, exactly.
template <typename Tc>
__device__ __forceinline__ void decode4(uint32_t w, float (&f)[4]) {
  if constexpr (std::is_same<Tc, int8_t>::value) {
    int8x4_to_float(w, f);
  } else {
    constexpr __nv_fp8_interpretation_t kKind =
        std::is_same<Tc, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2;
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), kKind)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), kKind)));
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  }
}

// N bytes (1, 2, 4, 8 or 16, aligned to N) of shared memory in one load;
// 32 (an fp32 V row's eight elements a lane at D = 256) in two.
template <int N>
struct Bytes;
template <>
struct Bytes<1> {
  using T = uint8_t;
};
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
struct alignas(16) Uint4x2 {
  uint4 lo, hi;
};
template <>
struct Bytes<32> {
  using T = Uint4x2;
};

// ---------------------------------------------------------------------------
// The fp32 FMA block over stored-width K/V.  Shared memory of a block: the
// fp32 K, V and Q tiles ([64, D] each, 16-byte chunk c of row r at chunk
// c ^ (r & 7): fma_swz), then the ring's stages, each a stored K tile, a
// stored V tile (64 rows of kRow bytes) and their 64 + 64 scales, then one
// mbarrier per stage.  A block holds at most three blocks' worth of an
// SM (FmaBlock's D 64 count: 168 registers a thread at three); the ring
// takes three stages where they leave as many blocks an SM as one stage
// does, else two, else one (D 128 in one byte: two blocks of 113 KB an SM).
// Where not even one stage fits beside the fp32 tiles (bf16 rows at D =
// 256: 192 KB of tiles and a 66 KB stage), kStages is 0: the kernel decodes
// each tile straight from device memory (fma_decode_global) and keeps its
// 64 + 64 scales after the tiles.
// ---------------------------------------------------------------------------
template <typename Tc, int D>
struct FmaRaw {
  static constexpr int kRow = kRowBytesOf<Tc, D>;
  static constexpr int kTile = kFmaTile * kRow;            // bytes of a stored tile
  static constexpr int kStage = 2 * kTile + 2 * kFmaTile * 4;
  static constexpr int kK = 0;                              // floats
  static constexpr int kV = kFmaTile * fma_slot(D);         // P takes K's slot
  static constexpr int kQ = 2 * kFmaTile * fma_slot(D);
  static constexpr int kRaw = 3 * kFmaTile * fma_slot(D) * 4;  // bytes
  static constexpr int smem(int stages) { return kRaw + stages * (kStage + 8); }
  static constexpr int blocks(int stages) {
    return 233472 / (smem(stages) + 1024) < 3 ? 233472 / (smem(stages) + 1024) : 3;
  }
  static constexpr int kStages = smem(1) > 232448              ? 0
                                 : blocks(3) == blocks(1) ? 3
                                 : blocks(2) == blocks(1) ? 2
                                                          : 1;
  static constexpr int kBar = kRaw + kStages * kStage;
  static constexpr int kSmem = kStages ? smem(kStages) : kRaw + 2 * kFmaTile * 4;
  static constexpr int kBlocksPerSm = kStages ? blocks(kStages) : 1;
  static_assert(kRow % 16 == 0, "rows are copied 16 bytes at a time");
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// 64 stored K and V rows from k_rows and v_rows (contiguous) and their
// scales into a stage of the ring by cp.async, rows at or past `valid`
// zero-filled and not read (a zero byte is a finite code in every storage,
// and its scale 0), then this thread's arrival on `bar` (initialised with
// kFmaThreads).  The scales go 4 bytes at a time: they need no alignment.
template <typename Tc, int D>
__device__ __forceinline__ void fma_raw_issue(unsigned char* stage, uint32_t bar,
                                              const unsigned char* k_rows,
                                              const unsigned char* v_rows,
                                              const float* k_sc, const float* v_sc,
                                              int valid) {
  using R = FmaRaw<Tc, D>;
  constexpr int kVec = R::kRow / 16;
  for (int i = threadIdx.x; i < kFmaTile * kVec; i += kFmaThreads) {
    const bool in = i / kVec < valid;
    const size_t off = in ? 16 * static_cast<size_t>(i) : 0;
    cp_async16(smem_addr(stage + 16 * i), k_rows + off, in);
    cp_async16(smem_addr(stage + R::kTile + 16 * i), v_rows + off, in);
  }
  const int r = threadIdx.x & (kFmaTile - 1);  // 128 threads: K's, then V's
  const bool in = r < valid;
  cp_async4(smem_addr(stage + 2 * R::kTile + 4 * threadIdx.x),
            (threadIdx.x < kFmaTile ? k_sc : v_sc) + (in ? r : 0), in);
  cp_async_arrive(bar);
}

// A landed stored tile (64 rows of kRowBytesOf<Tc, D> bytes) decoded once
// into the fp32 tile `dst` (fma_swz layout): this thread's share, 16 stored
// bytes at a time.  Exact for every code.
template <typename Tc, int D>
__device__ __forceinline__ void fma_decode_tile(float* dst, const unsigned char* src) {
  constexpr int kRow = kRowBytesOf<Tc, D>;
  constexpr int kVec = kRow / 16;
  auto put = [&](int r, int c, float a, float b, float x, float y) {
    *reinterpret_cast<float4*>(dst + fma_swz<D>(r, c)) = make_float4(a, b, x, y);
  };
#pragma unroll 2
  for (int i = threadIdx.x; i < kFmaTile * kVec; i += kFmaThreads) {
    const int r = i / kVec;
    const int cb = (i - r * kVec) * 16;  // stored byte of the row
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * kRow + cb);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (std::is_same<Tc, __nv_bfloat16>::value) {
      // Two bf16 values a word: their bits, shifted, are the floats.
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        put(r, cb / 8 + k, __uint_as_float(w[2 * k] << 16),
            __uint_as_float(w[2 * k] & 0xffff0000u), __uint_as_float(w[2 * k + 1] << 16),
            __uint_as_float(w[2 * k + 1] & 0xffff0000u));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kPacked<Tc>) {  // byte j: element j low, j + D / 2 high
          float lo[4], hi[4];
          int4x8_to_float(w[k], lo, hi);
          put(r, cb / 4 + k, lo[0], lo[1], lo[2], lo[3]);
          put(r, (D / 2 + cb) / 4 + k, hi[0], hi[1], hi[2], hi[3]);
        } else {
          float f[4];
          decode4<Tc>(w[k], f);
          put(r, cb / 4 + k, f[0], f[1], f[2], f[3]);
        }
      }
    }
  }
}

// fma_decode_tile from device memory: 64 stored rows from `src`
// (contiguous), rows at or past `valid` zeros and not read.  For a ring
// stage that does not fit (FmaRaw::kStages 0).
template <typename Tc, int D>
__device__ __forceinline__ void fma_decode_global(float* dst, const unsigned char* src,
                                                  int valid) {
  constexpr int kRow = kRowBytesOf<Tc, D>;
  static_assert(std::is_same<Tc, __nv_bfloat16>::value, "bf16 rows only");
  for (int i = threadIdx.x; i < kFmaTile * kRow / 16; i += kFmaThreads) {
    const int r = i / (kRow / 16);
    const int cb = (i - r * (kRow / 16)) * 16;
    const uint4 raw = r < valid ? *reinterpret_cast<const uint4*>(src + r * kRow + cb)
                                : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      *reinterpret_cast<float4*>(dst + fma_swz<D>(r, cb / 8 + k)) = make_float4(
          __uint_as_float(w[2 * k] << 16), __uint_as_float(w[2 * k] & 0xffff0000u),
          __uint_as_float(w[2 * k + 1] << 16), __uint_as_float(w[2 * k + 1] & 0xffff0000u));
    }
  }
}

// Pages of a slot's table that the rows of one call can read under a
// window with sinks (B5: one row; B6: `span` = window + T - 1 columns for T
// rows): `span` columns ending anywhere in a page touch cdiv(span - 1,
// page) + 1 pages, the sinks cdiv(sinks, page) more.  The split-KV bodies
// share out this many pages' worth of a slot's live chunks
// (decode/attention.py live_page_span is its twin).
inline int live_page_span(int pages_per_seq, int page_size, int span, int sinks) {
  const long long pages = (static_cast<long long>(span) - 1 + page_size - 1) / page_size + 1 +
                          (static_cast<long long>(sinks) + page_size - 1) / page_size;
  return static_cast<int>(pages < pages_per_seq ? pages : pages_per_seq);
}

}  // namespace
