// The D=128 rowsum probe for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel scripts/r5_d128_fwd.py::fwd (body _core):
// non-causal attention over bf16 q, k, v [B, H, S, 128] with O in bf16 and
// the natural-log lse in fp32, in five variants that differ only in how the
// softmax row sum l is formed.  Q is scaled by sm_scale * log2(e) in fp32
// and rounded to bf16; S = Q K^T in fp32.  v0-v3 are one pass in the TPU
// probe: m is the maximum of the whole row, then P = exp2(bf16(S - m)) in
// bf16 and O = P V / l.  exp2 of a bf16 operand is JAX's: exp(bf16(ln2 x))
// with ln2 rounded to bf16 (0.69140625), each step rounded to bf16, up to
// 6% above a true exp2; the kernel computes that same function.  The row
// sum l:
//   v0  l = the whole row's fp32 sum of P formed at every KV tile, as the
//       TPU kernel's jnp.sum over the row does: the tile's per-thread sums
//       reduced across the quad by two shuffles, then added to l;
//   v1  l = P @ ones: one extra mma.sync of P's A fragments against a ones
//       B fragment (n = 8), the tensor cores doing the sum;
//   v2  l = per-thread fp32 partials over all tiles, one quad-shuffle
//       reduction at the end: B1's rowsum (csrc/fa2_forward.cu), so v2 is
//       the yardstick for B1's form and v0 - v2 is what the per-tile
//       reduction costs;
//   v3  l = v2's sum rounded once to bf16: the TPU probe's bf16 jnp.sum,
//       which XLA accumulates in fp32 and rounds at the end (checked on the
//       CPU), so a true bf16 accumulation would be another function;
//   v4  the row split in two halves, each one pass (its own row max), the
//       two joined by the online rescale alpha = exp2(m_old - m_new).
//
// What bounds it on the H100: tensor-core operations (4 S^2 D FLOPs per
// head: B4 H8 S2048 is 6.9e10 FLOPs, 0.070 ms at 989 TFLOP/s, against 68 MB,
// 0.020 ms at 3.35 TB/s).  The design is B1's: one block per (64-row Q tile,
// b * H), four warps of 16 rows, Q in mma.sync A fragments, P from the S
// accumulators into A fragments, V read transposed by ldmatrix.  A 64-row
// tile's whole row of 2048 fp32 scores (512 KiB) fits neither registers nor
// shared memory, so the row maximum that the one-pass variants need first is
// a pass of its own over K: every variant computes Q K^T twice (1.5x the
// product work of one pass), and v4 twice per half.  The rowsum variants
// are therefore compared on a two-pass body, where the extra pass dilutes
// their differences.  B1's per-tile online softmax (one pass) is the
// yardstick timed beside the variants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 128;
constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kLD = kD + 8;  // bf16 elements: conflict-free ldmatrix
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) of a bf16 [S, 128] matrix into a shared tile
// with leading dimension kLD, 16 bytes per thread and step.
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int row0) {
  constexpr int kChunks = kD / 8;
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += 128) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * kLD + c) = *reinterpret_cast<const uint4*>(
        src + static_cast<size_t>(row0 + r) * kD + c);
  }
}

// S = Q K^T for the staged K tile: s[j] is n-tile j (8 keys).
__device__ __forceinline__ void scores(float (*s)[4], uint32_t (*qa)[4],
                                       const __nv_bfloat16* ks, int lane) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kBlockN / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
    }
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(128)
r5_fwd(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
       float* __restrict__ lse, int s_len, float qscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * kLD;
  __nv_bfloat16* vs = ks + kBlockN * kLD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBlockM;
  const size_t base = static_cast<size_t>(blockIdx.y) * s_len * kD;
  const __nv_bfloat16* kp = k + base;
  const __nv_bfloat16* vp = v + base;

  // Q tile: scaled in fp32, rounded to bf16.
  for (int i = threadIdx.x; i < kBlockM * (kD / 8); i += 128) {
    const int r = i / (kD / 8);
    const int c = (i - r * (kD / 8)) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + base + static_cast<size_t>(q0 + r) * kD + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      w[j] = pack_bf16(f.x * qscale, f.y * qscale);
    }
    *reinterpret_cast<uint4*>(qs + r * kLD + c) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kLD + kk * 16 +
                            (lane >> 4) * 8);
  }

  constexpr int kSegments = VARIANT == 4 ? 2 : 1;
  const int seg_len = s_len / kSegments;
  const uint32_t ones = pack_bf16(1.f, 1.f);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};             // v0, v2-v4: this thread's share
  float lc[4] = {0.f, 0.f, 0.f, 0.f};  // v1: P @ ones, rows g and g + 8
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int seg = 0; seg < kSegments; ++seg) {
    const int lo = seg * seg_len;
    const int hi = lo + seg_len;
    // Pass 1: the row maximum over the segment.
    float mx[2] = {-INFINITY, -INFINITY};
    for (int k0 = lo; k0 < hi; k0 += kBlockN) {
      __syncthreads();
      stage(ks, kp, k0);
      __syncthreads();
      float s[kBlockN / 8][4];
      scores(s, qa, ks, lane);
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      const float alpha = exp2f(m_run[i] - m_new);  // 0 on the first segment
      m_run[i] = m_new;
      l[i] *= alpha;
      lc[2 * i] *= alpha;
      lc[2 * i + 1] *= alpha;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }

    // Pass 2: P, the row sum and P V.
    for (int k0 = lo; k0 < hi; k0 += kBlockN) {
      __syncthreads();
      stage(ks, kp, k0);
      stage(vs, vp, k0);
      __syncthreads();
      float s[kBlockN / 8][4];
      scores(s, qa, ks, lane);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = round_bf16(s[j][e] - m_run[e >> 1]);
          const float p = round_bf16(expf(round_bf16(x * kLn2Bf16)));
          if constexpr (VARIANT == 0) {
            rs[e >> 1] += p;
          } else if constexpr (VARIANT != 1) {
            l[e >> 1] += p;
          }
          s[j][e] = p;
        }
      }
      if constexpr (VARIANT == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
          rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
          l[i] += rs[i];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        if constexpr (VARIANT == 1) mma_bf16(lc, pa, ones, ones);
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD +
                      dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }

  float row_l[2];
  if constexpr (VARIANT == 1) {
    row_l[0] = lc[0];  // every column of P @ ones holds the row sum
    row_l[1] = lc[2];
  } else if constexpr (VARIANT == 0) {
    row_l[0] = l[0];  // already the row's sum in every lane of the quad
    row_l[1] = l[1];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = l[i];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      row_l[i] = VARIANT == 3 ? round_bf16(x) : x;
    }
  }
  const int row_a = q0 + warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    const float inv = row_l[i] == 0.f ? 1.f : 1.f / row_l[i];
    __nv_bfloat16* op = o + base + static_cast<size_t>(row) * kD;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8 + t4 * 2) =
          __floats2bfloat162_rn(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    }
    if (t4 == 0) {
      lse[static_cast<size_t>(blockIdx.y) * s_len + row] =
          m_run[i] * kLn2 + logf(row_l[i] == 0.f ? 1.f : row_l[i]);
    }
  }
}

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

template <int VARIANT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s_len, float qscale,
                   cudaStream_t stream) {
  const int smem = 3 * kBlockM * kLD * static_cast<int>(sizeof(__nv_bfloat16));
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(r5_fwd<VARIANT>, smem, smem_set);
  if (err != cudaSuccess) return err;
  r5_fwd<VARIANT><<<dim3(s_len / kBlockM, bh), 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o [bh, s_len, 128] bf16 (bh = batch * heads), lse [bh, s_len]
// fp32, contiguous; s_len a multiple of 128; qscale = sm_scale * log2(e);
// variant 0-4 as above.  Returns a cudaError_t.
int cfa_r5_d128_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int s_len, float qscale, int variant,
                    void* stream) {
  if (s_len % (2 * kBlockN) != 0 || bh < 1 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(q, k, v, o, lse, bh, s_len, qscale, st));
    case 1: return static_cast<int>(launch<1>(q, k, v, o, lse, bh, s_len, qscale, st));
    case 2: return static_cast<int>(launch<2>(q, k, v, o, lse, bh, s_len, qscale, st));
    case 3: return static_cast<int>(launch<3>(q, k, v, o, lse, bh, s_len, qscale, st));
    case 4: return static_cast<int>(launch<4>(q, k, v, o, lse, bh, s_len, qscale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cfa_r5_d128_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
