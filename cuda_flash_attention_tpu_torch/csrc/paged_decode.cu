// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/decode/attention.py::paged_decode_attention
//   (body _decode_kernel).
// One query token per sequence slot attends over that slot's pages of the
// paged KV cache: pages [Hkv, P, page, D] of int8, fp8 (e4m3 / e5m2), bf16
// or fp32, or packed int4 [Hkv, P, page, D/2] (split-half: byte j holds
// element j in the low nibble and element j + D/2 in the high one), with
// fp32 per-token scales [Hkv, P, page]; the page table [n, pages_per_seq] maps the
// slot's logical pages to physical ones; lengths [n] gives each slot's
// token count (0 for an inactive slot, whose output is zeros).
//
// What bounds it on the H100: bytes.  Each live K/V element is read once and
// used by the `group` query heads that share its KV head (2 at the base
// model), so the kernel does ~2 * group FLOPs per cached byte against a
// ~295 FLOP/byte ridge; the floor is the live pages' bytes (K and V plus
// their scales) at 3.35 TB/s, which fp8 keeps at int8's and int4 halves.
// What the design does about it:
//   * one thread block per (slot, KV head); the block reads its own page ids
//     from the table and visits only live pages (p * page < length), so a
//     dead table entry is never dereferenced and no dead byte is moved;
//   * a 128-token chunk of K and V is copied once into shared memory with
//     16-byte loads in its stored width and decoded in registers (fp8 by the
//     card's exact conversion, int4 by two nibble sign-extensions): the K
//     scale multiplies the
//     score column and the V scale multiplies P, as the TPU kernel does; no
//     dequantized page is ever written;
//   * all `group` query heads of the KV head are scored from the same staged
//     chunk, with an fp32 online softmax (natural exp, as the TPU kernel).
// At batch 8 the grid is 8 * Hkv = 64 blocks on 132 SMs: splitting a slot's
// pages across blocks (flash-decoding's split-KV with a second combine pass)
// is later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // tokens per chunk: one thread per token
constexpr int kMaxGroup = 8;   // query heads per KV head
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

// A byte of packed int4 pages: two sign-extended nibbles.
struct Int4x2 {
  int8_t b;
};
__device__ __forceinline__ float lo_nibble(int8_t b) {
  const uint8_t top = static_cast<uint8_t>(static_cast<uint8_t>(b) << 4);
  return static_cast<float>(static_cast<int8_t>(top) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t b) {
  return static_cast<float>(b >> 4);
}

template <typename Tc>
constexpr bool kPacked = std::is_same<Tc, Int4x2>::value;
// Stored bytes of one cached row of D elements.
template <typename Tc, int D>
constexpr int kRowBytesOf = kPacked<Tc> ? D / 2 : D * static_cast<int>(sizeof(Tc));

// Value of a cache element in the compute type, as fp32.  int8, int4, fp8
// and bf16 are exact in bf16; an fp32 cache read with bf16 compute rounds.
template <typename Tc>
__device__ __forceinline__ float cache_value(Tc x, bool bf16_compute) {
  const float f = to_float(x);
  return bf16_compute ? round_bf16(f) : f;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                    const float* __restrict__ k_scales,
                    const Tc* __restrict__ v_pages,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, Tq* __restrict__ out,
                    int n_heads, int num_pages, int page_size,
                    int pages_per_seq, float sm_scale, int bf16_compute) {
  constexpr int kRowBytes = kRowBytesOf<Tc, D>;
  constexpr int kStride = kRowBytes + 16;  // conflict-free 16-byte row reads
  constexpr int kParts = kThreads / D;     // token partitions of the PV sum
  constexpr int kPartTokens = kThreads / kParts;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* kbuf = smem_raw;
  unsigned char* vbuf = smem_raw + kThreads * kStride;
  __shared__ float qf[kMaxGroup][D];
  __shared__ float ps[kMaxGroup][kThreads];
  __shared__ float ksc[kThreads];
  __shared__ float vsc[kThreads];
  __shared__ float red_max[kMaxGroup][kWarps];
  __shared__ float red_sum[kMaxGroup][kWarps];

  const int slot = blockIdx.x;
  const int hk = blockIdx.y;
  const int n_kv = gridDim.y;
  const int group = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bf16c = bf16_compute != 0;
  const int length = lengths[slot];
  const size_t q_base = (static_cast<size_t>(slot) * n_heads + hk * group) * D;

  for (int i = tid; i < group * D; i += kThreads) {
    const float x = to_float(q[q_base + i]);
    qf[i / D][i % D] = bf16c ? round_bf16(x) : x;
  }

  const int d = tid % D;      // output column of this thread in the PV sum
  const int part = tid / D;   // and its token partition
  float m_run[kMaxGroup], l_run[kMaxGroup], acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }

  const int n_chunks = (length + kThreads - 1) / kThreads;
  for (int c = 0; c < n_chunks; ++c) {
    const int tok0 = c * kThreads;
    const int page = tok0 / page_size;
    const int pid = page_table[static_cast<size_t>(slot) * pages_per_seq + page];
    const size_t row0 =
        (static_cast<size_t>(hk) * num_pages + pid) * page_size +
        (tok0 - page * page_size);

    __syncthreads();  // the previous chunk's readers are done
    {
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(k_pages) + row0 * kRowBytes;
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(v_pages) + row0 * kRowBytes;
      constexpr int kVecPerRow = kRowBytes / 16;
      for (int i = tid; i < kThreads * kVecPerRow; i += kThreads) {
        const int r = i / kVecPerRow;
        const int cb = (i - r * kVecPerRow) * 16;
        *reinterpret_cast<uint4*>(kbuf + r * kStride + cb) =
            *reinterpret_cast<const uint4*>(ksrc + static_cast<size_t>(i) * 16);
        *reinterpret_cast<uint4*>(vbuf + r * kStride + cb) =
            *reinterpret_cast<const uint4*>(vsrc + static_cast<size_t>(i) * 16);
      }
      ksc[tid] = k_scales[row0 + tid];
      vsc[tid] = v_scales[row0 + tid];
    }
    __syncthreads();

    // Scores of this thread's token for every query head of the group.
    const bool valid = tok0 + tid < length;
    float s[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    if constexpr (kPacked<Tc>) {
      // Byte j of the row holds elements j and j + D/2.
      const int8_t* krow = reinterpret_cast<const int8_t*>(kbuf + tid * kStride);
#pragma unroll 2
      for (int b0 = 0; b0 < D / 2; b0 += 16) {
        alignas(16) int8_t e[16];
        *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(krow + b0);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float lo = lo_nibble(e[j]);
          const float hi = hi_nibble(e[j]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) {
              s[g] = fmaf(qf[g][b0 + j], lo, s[g]);
              s[g] = fmaf(qf[g][b0 + j + D / 2], hi, s[g]);
            }
          }
        }
      }
    } else {
      const Tc* krow = reinterpret_cast<const Tc*>(kbuf + tid * kStride);
      constexpr int kElemsPerVec = 16 / sizeof(Tc);
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += kElemsPerVec) {
        alignas(16) Tc e[kElemsPerVec];
        *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(krow + d0);
#pragma unroll
        for (int j = 0; j < kElemsPerVec; ++j) {
          const float kv = cache_value(e[j], bf16c);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) s[g] = fmaf(qf[g][d0 + j], kv, s[g]);
          }
        }
      }
    }
    const float col_scale = ksc[tid] * sm_scale;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      s[g] = valid ? s[g] * col_scale : kMaskValue;
      float mx = s[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (lane == 0) red_max[g][warp] = mx;
    }
    __syncthreads();

    float alpha[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      float cm = red_max[g][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) cm = fmaxf(cm, red_max[g][w]);
      const float m_new = fmaxf(m_run[g], cm);
      alpha[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      const float p = valid ? expf(s[g] - m_new) : 0.f;
      if (g < group) ps[g][tid] = bf16c ? round_bf16(p * vsc[tid]) : p * vsc[tid];
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) red_sum[g][warp] = sum;
    }
    __syncthreads();

    // This thread's column d of the staged V rows: its byte, and for int4
    // its nibble.
    const unsigned char* vcol =
        vbuf + (kPacked<Tc> ? d % (D / 2) : d * static_cast<int>(sizeof(Tc)));
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      float sum = red_sum[g][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red_sum[g][w];
      l_run[g] = l_run[g] * alpha[g] + sum;
      acc[g] *= alpha[g];
    }
#pragma unroll 4
    for (int t = part * kPartTokens; t < (part + 1) * kPartTokens; ++t) {
      float vv;
      if constexpr (kPacked<Tc>) {
        const int8_t byte = *reinterpret_cast<const int8_t*>(vcol + t * kStride);
        vv = d < D / 2 ? lo_nibble(byte) : hi_nibble(byte);
      } else {
        vv = cache_value(*reinterpret_cast<const Tc*>(vcol + t * kStride), bf16c);
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) acc[g] = fmaf(ps[g][t], vv, acc[g]);
      }
    }
  }

  // Sum the token partitions of the PV product, then normalise.
  if (kParts > 1) {
    __syncthreads();
    float* comb = ps[0];  // [kParts - 1][kMaxGroup][D] fits in ps
    if (part > 0) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) comb[((part - 1) * kMaxGroup + g) * D + d] = acc[g];
      }
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < kParts; ++p) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) acc[g] += comb[((p - 1) * kMaxGroup + g) * D + d];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
      const float inv = l_run[g] == 0.f ? 0.f : 1.f / l_run[g];
      store(out + q_base + g * D + d, acc[g] * inv);
    }
  }
}

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

template <typename Tq, typename Tc, int D>
cudaError_t launch(int num_seqs, int n_heads, int n_kv_heads, const void* q,
                   const void* k_pages, const void* k_scales,
                   const void* v_pages, const void* v_scales,
                   const void* page_table, const void* lengths, void* out,
                   int num_pages, int page_size, int pages_per_seq,
                   float sm_scale, int bf16_compute, cudaStream_t stream) {
  const size_t smem = 2 * kThreads * (kRowBytesOf<Tc, D> + 16);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(paged_decode_kernel<Tq, Tc, D>,
                                  static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_seqs, n_kv_heads);
  paged_decode_kernel<Tq, Tc, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tc*>(k_pages),
      static_cast<const float*>(k_scales), static_cast<const Tc*>(v_pages),
      static_cast<const float*>(v_scales), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<Tq*>(out), n_heads,
      num_pages, page_size, pages_per_seq, sm_scale, bf16_compute);
  return cudaGetLastError();
}

template <typename Tq, typename Tc>
cudaError_t launch_d(int head_dim, int num_seqs, int n_heads, int n_kv_heads,
                     const void* q, const void* kp, const void* ks,
                     const void* vp, const void* vs, const void* pt,
                     const void* len, void* out, int num_pages, int page_size,
                     int pps, float sm_scale, int bf16_compute,
                     cudaStream_t st) {
  if (head_dim == 64) {
    return launch<Tq, Tc, 64>(num_seqs, n_heads, n_kv_heads, q, kp, ks, vp,
                              vs, pt, len, out, num_pages, page_size, pps,
                              sm_scale, bf16_compute, st);
  }
  if (head_dim == 128) {
    return launch<Tq, Tc, 128>(num_seqs, n_heads, n_kv_heads, q, kp, ks, vp,
                               vs, pt, len, out, num_pages, page_size, pps,
                               sm_scale, bf16_compute, st);
  }
  return cudaErrorInvalidValue;
}

template <typename Tq>
cudaError_t launch_cache(int cache_dtype, int head_dim, int num_seqs,
                         int n_heads, int n_kv_heads, const void* q,
                         const void* kp, const void* ks, const void* vp,
                         const void* vs, const void* pt, const void* len,
                         void* out, int num_pages, int page_size, int pps,
                         float sm_scale, int bf16_compute, cudaStream_t st) {
  switch (cache_dtype) {
    case 0:
      return launch_d<Tq, float>(head_dim, num_seqs, n_heads, n_kv_heads, q,
                                 kp, ks, vp, vs, pt, len, out, num_pages,
                                 page_size, pps, sm_scale, bf16_compute, st);
    case 1:
      return launch_d<Tq, __nv_bfloat16>(head_dim, num_seqs, n_heads,
                                         n_kv_heads, q, kp, ks, vp, vs, pt,
                                         len, out, num_pages, page_size, pps,
                                         sm_scale, bf16_compute, st);
    case 2:
      return launch_d<Tq, int8_t>(head_dim, num_seqs, n_heads, n_kv_heads, q,
                                  kp, ks, vp, vs, pt, len, out, num_pages,
                                  page_size, pps, sm_scale, bf16_compute, st);
    case 3:
      return launch_d<Tq, __nv_fp8_e4m3>(head_dim, num_seqs, n_heads,
                                         n_kv_heads, q, kp, ks, vp, vs, pt,
                                         len, out, num_pages, page_size, pps,
                                         sm_scale, bf16_compute, st);
    case 4:
      return launch_d<Tq, __nv_fp8_e5m2>(head_dim, num_seqs, n_heads,
                                         n_kv_heads, q, kp, ks, vp, vs, pt,
                                         len, out, num_pages, page_size, pps,
                                         sm_scale, bf16_compute, st);
    case 5:
      return launch_d<Tq, Int4x2>(head_dim, num_seqs, n_heads, n_kv_heads, q,
                                  kp, ks, vp, vs, pt, len, out, num_pages,
                                  page_size, pps, sm_scale, bf16_compute, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out [num_seqs, n_heads, head_dim] (fp32, or bf16 when q_bf16);
// k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim] of
// cache_dtype 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8 e4m3, 4 = fp8 e5m2, or
// 5 = int4 [.., head_dim / 2] split-half; k_scales, v_scales
// [n_kv_heads, num_pages, page_size] fp32; page_table [num_seqs,
// pages_per_seq] int32; lengths [num_seqs] int32.  page_size is a multiple
// of 128 and n_heads / n_kv_heads <= 8.  Returns a cudaError_t.
int cfa_paged_decode(const void* q, const void* k_pages, const void* k_scales,
                     const void* v_pages, const void* v_scales,
                     const void* page_table, const void* lengths, void* out,
                     int num_seqs, int n_heads, int n_kv_heads, int num_pages,
                     int page_size, int pages_per_seq, int head_dim,
                     float sm_scale, int q_bf16, int cache_dtype,
                     int bf16_compute, void* stream) {
  if (page_size % kThreads != 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return static_cast<int>(launch_cache<__nv_bfloat16>(
        cache_dtype, head_dim, num_seqs, n_heads, n_kv_heads, q, k_pages,
        k_scales, v_pages, v_scales, page_table, lengths, out, num_pages,
        page_size, pages_per_seq, sm_scale, bf16_compute, st));
  }
  return static_cast<int>(launch_cache<float>(
      cache_dtype, head_dim, num_seqs, n_heads, n_kv_heads, q, k_pages,
      k_scales, v_pages, v_scales, page_table, lengths, out, num_pages,
      page_size, pages_per_seq, sm_scale, bf16_compute, st));
}

const char* cfa_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
