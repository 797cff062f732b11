// Hopper (sm_90a) building blocks shared by the port's hand-written
// kernels: 16-bit (bf16, fp16) and fp32 row loads and stores, rounding to
// an input type, wgmma issue/commit/wait and the
// 128- and 64-byte-swizzle shared-memory descriptors, mbarriers, cp.async into an
// mbarrier, TMA loads (3-D tensor maps and 1-D bulk copies), the tensor-map
// encoder looked up in libcuda at run time, and the once-per-device
// shared-memory attribute.  Everything sits in an anonymous namespace: each
// source that includes it is its own shared library.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float* x) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __half22float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Two neighbouring values of an fp32, bf16 or fp16 row as fp32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// x rounded to the input type T (to nearest even) and back to fp32: the
// value a 16-bit input's P takes before P V; fp32 keeps x.
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// wgmma.  Operand lists of the 64- and 128-column fp32 accumulators.
// ---------------------------------------------------------------------------
#define CFA_R32                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define CFA_R64                                                              \
  CFA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63"
#define CFA_ACC8(d, i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CFA_ACC32(d) CFA_ACC8(d, 0), CFA_ACC8(d, 8), CFA_ACC8(d, 16), CFA_ACC8(d, 24)
#define CFA_ACC64(d)                                                         \
  CFA_ACC32(d), CFA_ACC8(d, 32), CFA_ACC8(d, 40), CFA_ACC8(d, 48),           \
      CFA_ACC8(d, 56)

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an in-flight wgmma reads or writes: the empty asm keeps
// the compiler from reusing them, or reading them, across the wait.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
// Every swizzle atom (8 rows of 128 bytes) starts on a 1024-byte boundary,
// so the base-offset field stays 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

// The same with the 64-byte swizzle (layout type 2), for rows of 64 bytes
// (32 16-bit columns): a swizzle atom is 8 rows x 64 bytes, 16-byte chunk c
// of row r at c ^ ((r / 2) % 4), each atom on a 512-byte boundary.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{2} << 62);
}

// ---------------------------------------------------------------------------
// mbarriers, cp.async and TMA.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 16 bytes from global to shared memory, asynchronously; with `full` false
// nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory (no alignment beyond 4 bytes), as
// cp_async16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// Wait until every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Arrive on `bar` once every cp.async this thread has issued so far has
// landed (the arrival is counted in the barrier's initial count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; the bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory; they complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const void* src,
                                            uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

// Raises the kernel's dynamic shared-memory limit to `smem` once per device
// (devices 0-63; others on every call) instead of on every launch.  `done`
// is a function-local static of the caller, so one per instantiation.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int smem,
                          std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// cuTensorMapEncodeTiled lives in libcuda.so.1, which the CUDA runtime has
// already loaded: it is looked up there, so the build needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// Sliding windows and attention sinks (B1-B6, B8).  A row at
// position `row` keeps column `col` when row - col < window or col < sinks
// (and-ed with each kernel's causal and length bounds); "no window" is a
// window of kNoWindow, which no key distance reaches.
constexpr int kNoWindow = 1 << 30;

__device__ __forceinline__ bool in_window(int row, int col, int window,
                                          int sinks) {
  return row - col < window || col < sinks;
}

// The KV tiles (of `tile` columns) a range of rows walks: the sink tiles
// [0, cdiv(sinks, tile)), then the tiles from the one holding `first_col`
// (the oldest column the range's first row keeps) to the one holding
// end_col - 1; a tile in both ranges is walked once.  Step i < n is tile
// at(i).  A kernel's producer and consumers, and each split of a split-KV
// walk, step through this one sequence.  kernels/common.py window_tiles
// is its plain twin.
struct KvWalk {
  int n_sink, lo, n;
  __device__ __forceinline__ KvWalk(int first_col, int end_col, int sinks,
                                    int tile) {
    const int n_end = end_col > 0 ? (end_col + tile - 1) / tile : 0;
    n_sink = min((sinks + tile - 1) / tile, n_end);
    lo = max(n_sink, max(0, first_col) / tile);
    n = n_sink + max(0, n_end - lo);
  }
  __device__ __forceinline__ int at(int i) const {
    return i < n_sink ? i : lo + (i - n_sink);
  }
};

// The transpose of KvWalk: the Q tiles (of `q_tile` rows, n_q of them)
// that the KV tile of rows [k0, k0 + kv_rows) meets with a kept pair.
// Under causal masking from the tile holding row k0; a tile holding a sink
// column (k0 < sinks) to the last Q tile, else to the one holding the last
// row whose window reaches the tile, k0 + kv_rows - 1 + window - 1 (none
// where that row is negative: a band); none for a KV tile at or past
// kv_len.  Step i < n is Q tile lo + i.  The KV-major backward kernels'
// producer and consumers step through this one sequence;
// kernels/common.py window_q_tiles is its plain twin.
struct QWalk {
  int lo, n;
  __device__ __forceinline__ QWalk(int k0, int kv_rows, int n_q, int q_tile,
                                   int causal, int window, int sinks,
                                   int kv_len) {
    lo = causal ? min(k0 / q_tile, n_q) : 0;
    int hi = n_q;
    if (k0 >= sinks) {
      const long long last = static_cast<long long>(k0) + kv_rows + window - 2;
      hi = last < 0 ? 0 : static_cast<int>(min(static_cast<long long>(n_q),
                                               last / q_tile + 1));
    }
    n = k0 < kv_len ? max(0, hi - lo) : 0;
  }
  __device__ __forceinline__ int at(int i) const { return lo + i; }
};

// Segment ids (sequence packing): int32 rows of round_up(length, 128) per
// batch element, null for none; a row keeps only keys of its own id.
__host__ __device__ __forceinline__ int seg_stride(int n) {
  return (n + 127) & ~127;
}

// Errors of the tensor-map step, beyond the cudaError_t range.
constexpr int kErrNoEncoder = 100000;
constexpr int kErrEncode = 100001;

}  // namespace
