// FlashAttention-2 forward for small problems (kernel B8) on Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/fa2_forward.py::fa2_forward_small_aligned
//   (body _fa2_fwd_small_kernel).
// It computes O = softmax(scale * Q K^T) V and the natural-log logsumexp per
// row for problems whose whole (padded) sequence is one tile: Sq = Skv =
// s_pad <= 128 and as many KV heads as query heads, so every (batch, head)
// pair is one independent slot.  Causal masking and a ragged KV tail
// (kv_len) apply inside each slot; slots never see each other's keys.
// Windows and segment ids are not taken; the Python wrapper refuses them.
//
// What bounds it on the H100: the bytes, and at these sizes mostly the fixed
// cost of a launch.  A slot does 4 * s^2 * D FLOPs on 4 * s * D values, so
// at the reference suite's Edge shapes (B8 H16 S32/S100 D64) the work is a
// few microseconds of the card in total.  The TPU kernel packs several slots
// into one block-diagonal matmul to amortise its per-grid-step overhead; on
// the card a block per slot is cheap, so the design instead makes one slot
// as short as possible:
//   * one block per slot (a grid-stride loop when slots outnumber what the
//     card holds at once): the Edge shapes' 128 slots spread over 128 SMs;
//   * the slot's whole Q, K and V (<= 128 rows) are staged in shared memory
//     once, Q scaled by sm_scale * log2(e) in fp32 before its rounding;
//   * one warp per 16 query rows keeps its strip of scores in registers and
//     takes the softmax in one pass: there is one KV tile, so no online
//     rescaling; under causal a warp stops at its diagonal;
//   * bf16 and fp16 tiles run on mma.sync m16n8k16 with fp32 accumulation,
//     P going from the S accumulators straight into A fragments; fp32 runs
//     on the FMA units (no TF32), held to IEEE fp32.
// The TPU kernel's V-augmented rowsum (a v5e work-around) is left out: l
// sums the fp32 P.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kMaxRows = 128;  // the largest padded sequence of a slot
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void load8(const float* p, float* x) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The two 16-bit tile types of the tensor-core path: packing two fp32 values
// (round to nearest even) and the m16n8k16 product with fp32 accumulation.
template <typename Tt>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // c += a (16x16, row) * b (16x8, col).
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// fp16 tiles overflow above 65504 and keep P below 2^-14 as subnormals,
// where the JAX package's fp16 emulation (a 10-bit mantissa in fp32) does
// neither; the two agree in fp16's normal range.
template <>
struct Tile<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

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

// Copy the first `rows` rows of a slot's [s_pad, D] matrix into a 16-bit
// shared tile of type Tt with leading dimension LD, multiplied by `scale`
// in fp32 before the rounding.  Rows at or past s_pad are zero (P is 0
// there, and 0 * NaN would poison the PV product).
template <typename Tt, typename Tin, int D, int LD>
__device__ __forceinline__ void stage_tile(Tt* dst, const Tin* src, int rows,
                                           int s_pad, float scale) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    float x[8];
    if (r < s_pad) {
      load8(src + static_cast<size_t>(r) * D + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    uint4 packed;
    packed.x = Tile<Tt>::pack(x[0] * scale, x[1] * scale);
    packed.y = Tile<Tt>::pack(x[2] * scale, x[3] * scale);
    packed.z = Tile<Tt>::pack(x[4] * scale, x[5] * scale);
    packed.w = Tile<Tt>::pack(x[6] * scale, x[7] * scale);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = packed;
  }
}

__device__ __forceinline__ bool masked(int row, int col, int kv_len,
                                       int causal) {
  return col >= kv_len || (causal && col > row);
}

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt) on the tensor cores.  One warp per 16 rows of the
// slot (blockDim.x = 32 * rows16 / 16).  Fragment layouts are those of
// mma.m16n8k16: thread (g = lane / 4, t = lane % 4) holds accumulator
// elements (row g, cols 2t, 2t+1) and (row g + 8, cols 2t, 2t+1) of each
// 8-column n-tile.
// ---------------------------------------------------------------------------
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(256)
small_mma(const Tin* __restrict__ q, const Tin* __restrict__ k,
          const Tin* __restrict__ v, Tin* __restrict__ o,
          float* __restrict__ lse, int n_slots, int s_pad, int kv_len,
          float qscale, int causal) {
  constexpr int LD = D + 8;  // 16-byte row padding: conflict-free ldmatrix
  constexpr int NT = kMaxRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows16 = (s_pad + 15) & ~15;
  Tt* qs = reinterpret_cast<Tt*>(smem_raw);
  Tt* ks = qs + rows16 * LD;
  Tt* vs = ks + rows16 * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_a = warp * 16 + g;
  const int row_b = row_a + 8;
  // Columns this warp's rows can see: up to its diagonal under causal, and
  // none at or past kv_len.
  const int col_end =
      min(causal ? min(rows16, warp * 16 + 16) : rows16, (kv_len + 15) & ~15);

  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const size_t off = static_cast<size_t>(slot) * s_pad * D;
    __syncthreads();  // every warp is done with the previous slot's tiles
    stage_tile<Tt, Tin, D, LD>(qs, q + off, rows16, s_pad, qscale);
    stage_tile<Tt, Tin, D, LD>(ks, k + off, rows16, s_pad, 1.f);
    stage_tile<Tt, Tin, D, LD>(vs, v + off, rows16, s_pad, 1.f);
    __syncthreads();

    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                              (lane >> 4) * 8);
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 < col_end) {
          uint32_t bf[4];
          ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          Tile<Tt>::mma(s[2 * np], qa[kk], bf[0], bf[1]);
          Tile<Tt>::mma(s[2 * np + 1], qa[kk], bf[2], bf[3]);
        }
      }
    }

    // One-pass softmax over the whole row: max, exp2, sum.  Masked scores
    // count as the mask value in the max (as in the TPU kernel) and give
    // P exactly 0.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < col_end) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t4 * 2 + (e & 1);
          if (masked(e < 2 ? row_a : row_b, col, kv_len, causal)) {
            s[j][e] = kMaskValue;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < col_end) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + t4 * 2 + (e & 1);
          const float p = masked(e < 2 ? row_a : row_b, col, kv_len, causal)
                              ? 0.f
                              : exp2f(s[j][e] - mx[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }

    // O = P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of k-step kk; V is read transposed by ldmatrix.
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk * 16 < col_end) {
        uint32_t pa[4];
        pa[0] = Tile<Tt>::pack(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = Tile<Tt>::pack(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = Tile<Tt>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = Tile<Tt>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      dp * 16 + (lane >> 4) * 8);
          Tile<Tt>::mma(acc[2 * dp], pa, bf[0], bf[1]);
          Tile<Tt>::mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }

    const float inv_a = l[0] == 0.f ? 1.f : 1.f / l[0];
    const float inv_b = l[1] == 0.f ? 1.f : 1.f / l[1];
    Tin* op = o + off;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (row_a < s_pad) {
        store2(op + static_cast<size_t>(row_a) * D + col, acc[j][0] * inv_a,
               acc[j][1] * inv_a);
      }
      if (row_b < s_pad) {
        store2(op + static_cast<size_t>(row_b) * D + col, acc[j][2] * inv_b,
               acc[j][3] * inv_b);
      }
    }
    if (t4 == 0) {
      float* lp = lse + static_cast<size_t>(slot) * s_pad;
      if (row_a < s_pad) {
        lp[row_a] = mx[0] * kLn2 + logf(l[0] == 0.f ? 1.f : l[0]);
      }
      if (row_b < s_pad) {
        lp[row_b] = mx[1] * kLn2 + logf(l[1] == 0.f ? 1.f : l[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units.  256 threads as 16 x 16 walk the slot's rows in
// passes of 64: thread (ty, tx) owns rows 4ty..4ty+3 of the pass and
// columns tx + 16j (j < 8) of S, and columns tx + 16j (j < D / 16) of O.  A
// row's 16 threads are 16 neighbouring lanes, so row reductions are four
// shuffles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256)
small_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int n_slots, int s_pad, int kv_len,
           float qscale, int causal) {
  constexpr int kPass = 64;
  constexpr int LDK = D + 1;  // odd strides: conflict-free column reads
  constexpr int LDV = D;
  constexpr int LDP = kMaxRows + 1;
  constexpr int NJ = kMaxRows / 16;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows16 = (s_pad + 15) & ~15;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kPass * LDK;
  float* vs = ks + rows16 * LDK;
  float* ps = vs + rows16 * LDV;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kv_end = min(rows16, kv_len);

  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const size_t off = static_cast<size_t>(slot) * s_pad * D;
    __syncthreads();
    for (int i = threadIdx.x; i < rows16 * D; i += 256) {
      const int r = i / D;
      const int c = i - r * D;
      const bool in = r < s_pad;
      ks[r * LDK + c] = in ? k[off + static_cast<size_t>(r) * D + c] : 0.f;
      vs[r * LDV + c] = in ? v[off + static_cast<size_t>(r) * D + c] : 0.f;
    }
    for (int r0 = 0; r0 < s_pad; r0 += kPass) {
      __syncthreads();  // K/V staged; the previous pass is done with Q and P
      for (int i = threadIdx.x; i < kPass * D; i += 256) {
        const int r = i / D;
        const int c = i - r * D;
        qs[r * LDK + c] = r0 + r < s_pad
                              ? q[off + static_cast<size_t>(r0 + r) * D + c] * qscale
                              : 0.f;
      }
      __syncthreads();
      const int col_end = causal ? min(kv_end, r0 + kPass) : kv_end;

      float s[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDK + d];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (16 * j < col_end) {
            const float kv = ks[(tx + 16 * j) * LDK + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
          }
        }
      }

      float mx[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        mx[i] = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (16 * j < col_end) {
            if (masked(row, tx + 16 * j, kv_len, causal)) s[i][j] = kMaskValue;
            mx[i] = fmaxf(mx[i], s[i][j]);
          }
        }
#pragma unroll
        for (int off2 = 1; off2 < 16; off2 <<= 1) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off2));
        }
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (16 * j < col_end) {
            const int col = tx + 16 * j;
            const float p = masked(row, col, kv_len, causal)
                                ? 0.f
                                : exp2f(s[i][j] - mx[i]);
            l[i] += p;
            ps[(ty * 4 + i) * LDP + col] = p;
          }
        }
#pragma unroll
        for (int off2 = 1; off2 < 16; off2 <<= 1) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], off2);
        }
      }
      __syncthreads();

      float acc[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int c = 0; c < col_end; ++c) {
        float vv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= s_pad) continue;
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[off + static_cast<size_t>(row) * D + tx + 16 * j] = acc[i][j] * inv;
        }
        if (tx == 0) {
          lse[static_cast<size_t>(slot) * s_pad + row] =
              mx[i] * kLn2 + logf(l[i] == 0.f ? 1.f : l[i]);
        }
      }
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to `smem` once per device
// (devices 0-63; others on every call).  `done` is a function-local static of
// the caller, so one per instantiation.  The limit is set for the largest
// slot (128 rows), so it holds for every smaller one.
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

// Blocks to launch: one per slot, capped at what the card holds resident at
// once (the kernels loop over the remaining slots).
template <typename Kernel>
cudaError_t grid_size(Kernel kernel, int threads, size_t smem, int n_slots,
                      int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return err;
  *blocks = std::max(1, std::min(n_slots, sms * std::max(per_sm, 1)));
  return cudaSuccess;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int n_slots, s_pad, kv_len;
  float qscale;
  int causal;
  cudaStream_t stream;
};

template <typename Tin, typename Tt, int D>
cudaError_t launch_mma(const Args& a) {
  const int rows16 = (a.s_pad + 15) & ~15;
  const int threads = 32 * (rows16 / 16);
  const size_t smem = 3 * rows16 * (D + 8) * sizeof(Tt);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(
      small_mma<Tin, Tt, D>,
      static_cast<int>(3 * kMaxRows * (D + 8) * sizeof(Tt)), smem_set);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = grid_size(small_mma<Tin, Tt, D>, threads, smem, a.n_slots, &blocks);
  }
  if (err != cudaSuccess) return err;
  small_mma<Tin, Tt, D><<<blocks, threads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<Tin*>(a.o), a.lse, a.n_slots,
      a.s_pad, a.kv_len, a.qscale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Args& a) {
  const int rows16 = (a.s_pad + 15) & ~15;
  auto smem_of = [](int rows) {
    return (64 * (D + 1) + rows * (D + 1) + rows * D + 64 * (kMaxRows + 1)) *
           sizeof(float);
  };
  const size_t smem = smem_of(rows16);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(small_fp32<D>,
                                  static_cast<int>(smem_of(kMaxRows)), smem_set);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = grid_size(small_fp32<D>, 256, smem, a.n_slots, &blocks);
  }
  if (err != cudaSuccess) return err;
  small_fp32<D><<<blocks, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse,
      a.n_slots, a.s_pad, a.kv_len, a.qscale, a.causal);
  return cudaGetLastError();
}

template <typename Tin, int D>
cudaError_t launch_mma_tiles(const Args& a, int tiles) {
  return tiles == 1 ? launch_mma<Tin, __nv_bfloat16, D>(a)
                    : launch_mma<Tin, __half, D>(a);
}

}  // namespace

extern "C" {

// q, k, v, o [n_slots, s_pad, head_dim] (every (batch, head) pair one slot);
// lse [n_slots, s_pad] fp32.  All contiguous, s_pad <= 128.  in_bf16:
// q/k/v/o are bf16 (else fp32).  tiles: 0 fp32 on the FMA units (needs fp32
// inputs), 1 bf16 or 2 fp16 on the tensor cores.  qscale = sm_scale *
// log2(e).  Returns a cudaError_t.
int cfa_fa2_forward_small(const void* q, const void* k, const void* v,
                          void* o, void* lse, int n_slots, int s_pad,
                          int head_dim, int kv_len, float qscale, int causal,
                          int in_bf16, int tiles, void* stream) {
  if (s_pad < 1 || s_pad > kMaxRows || n_slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, static_cast<float*>(lse), n_slots, s_pad, kv_len,
               qscale, causal, static_cast<cudaStream_t>(stream)};
  if (tiles == 1 || tiles == 2) {
    if (in_bf16) {
      if (head_dim == 64) return launch_mma_tiles<__nv_bfloat16, 64>(a, tiles);
      if (head_dim == 128) return launch_mma_tiles<__nv_bfloat16, 128>(a, tiles);
    } else {
      if (head_dim == 64) return launch_mma_tiles<float, 64>(a, tiles);
      if (head_dim == 128) return launch_mma_tiles<float, 128>(a, tiles);
    }
  } else if (tiles == 0 && !in_bf16) {
    if (head_dim == 64) return launch_fp32<64>(a);
    if (head_dim == 128) return launch_fp32<128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_fa2_forward_small_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
