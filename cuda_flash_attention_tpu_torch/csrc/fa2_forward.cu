// FlashAttention-2 forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/fa2_forward.py::fa2_forward_aligned
//   (bodies _fa2_fwd_kernel and _single_kv_attention).
// It computes O = softmax(scale * Q K^T) V and the natural-log logsumexp per
// query row, with causal masking, a ragged KV tail (kv_len) and GQA (query
// head h reads KV head h / (Hq / Hkv)).  Window, sinks and segment ids are not
// taken here; the Python wrapper refuses them.
//
// What bounds it on the H100: tensor-core FLOPs.  Per query head, causal
// prefill does ~2*S^2*D FLOPs against ~6*S*D bytes in bf16 (Q and O, plus
// K and V shared by the two heads of a GQA group): ~S/3 FLOPs per byte, so
// the serving shapes (B 1-8, Hq 16, Hkv 8, S 128-1024, D 64) sit at or above
// the card's ~295 FLOP/byte ridge from S ~ 900 on, and the roofline there is
// the 989 TFLOP/s of bf16 mma.  The design keeps every S and P tile on chip
// and reads K and V once per 64-row Q tile:
//   * one thread block per (64-row Q tile, b*Hq); four warps, 16 rows each;
//   * the Q tile is scaled by sm_scale*log2(e) in fp32 once, rounded to the
//     tile type and held in registers as mma A fragments for the whole loop;
//   * the loop over 64-row KV tiles runs inside the block and, under causal,
//     stops at the diagonal tile instead of running masked iterations;
//   * bf16 and fp16 tiles run on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate); P goes from the S accumulators straight into A fragments,
//     rounded to the tile type, without touching shared memory;
//   * the online softmax keeps m and l in fp32 in the exp2 domain;
//   * fp32 tiles run on the fp32 FMA units (no TF32), held to IEEE fp32.
// wgmma, TMA and a pipelined KV ring are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBlockM = 64;  // Q rows per thread block
constexpr int kBlockN = 64;  // KV rows per loop iteration
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

// Copy rows [row0, row0 + ROWS) of a [nrows, D] matrix into a 16-bit shared
// tile of type Tt with leading dimension LD, multiplied by `scale` in fp32
// before the rounding.  Rows past nrows are zero (never NaN: P is 0 there, and 0 * NaN
// would poison the PV product).
template <typename Tt, typename Tin, int D, int ROWS, int LD, int NTHREADS>
__device__ __forceinline__ void stage_tile(Tt* dst, const Tin* src,
                                           int row0, int nrows, float scale) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    float x[8];
    if (row0 + r < nrows) {
      load8(src + static_cast<size_t>(row0 + r) * D + c, x);
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

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt) on the tensor cores.  128 threads; warp w owns Q rows
// [16w, 16w + 16) of the tile.  Fragment layouts are those of
// mma.m16n8k16: thread (g = lane / 4, t = lane % 4) holds accumulator
// elements (row g, cols 2t, 2t+1) and (row g + 8, cols 2t, 2t+1) of each
// 8-column n-tile.
// ---------------------------------------------------------------------------
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(128)
fa2_fwd_mma(const Tin* __restrict__ q, const Tin* __restrict__ k,
            const Tin* __restrict__ v, Tin* __restrict__ o,
            float* __restrict__ lse, int hq, int hkv, int sq, int skv,
            int kv_len, float qscale, int causal) {
  constexpr int LD = D + 8;  // 16-byte row padding: conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tt* qs = reinterpret_cast<Tt*>(smem_raw);
  Tt* ks = qs + kBlockM * LD;
  Tt* vs = ks + kBlockN * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Causal tiles near the end of the sequence carry the most KV tiles:
  // hand them out first so the short ones fill the tail of the grid.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const Tin* qp = q + static_cast<size_t>(bh) * sq * D;
  const Tin* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const Tin* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;

  stage_tile<Tt, Tin, D, kBlockM, LD, 128>(qs, qp, q0, sq, qscale);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  }

  const int kv_end = causal ? min(kv_len, q0 + kBlockM) : kv_len;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<Tt, Tin, D, kBlockN, LD, 128>(ks, kp, k0, skv, 1.f);
    stage_tile<Tt, Tin, D, kBlockN, LD, 128>(vs, vp, k0, skv, 1.f);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        Tile<Tt>::mma(s[2 * np], qa[kk], bf[0], bf[1]);
        Tile<Tt>::mma(s[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }

    const bool need_mask =
        (k0 + kBlockN > kv_len) || (causal && k0 + kBlockN - 1 > q0);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= kv_len || (causal && col > row)) s[j][e] = kMaskValue;
        }
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - m_run[e >> 1]);
        // Exact zero for masked entries (a row masked so far has m equal
        // to the mask value, where exp2 alone would give 1).
        if (need_mask && s[j][e] == kMaskValue) p = 0.f;
        rs[e >> 1] += p;
        s[j][e] = p;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of k-step kk; V is read transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv_a = l_run[0] == 0.f ? 1.f : 1.f / l_run[0];
  const float inv_b = l_run[1] == 0.f ? 1.f : 1.f / l_run[1];
  Tin* op = o + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row_a < sq) {
      store2(op + static_cast<size_t>(row_a) * D + col, acc[j][0] * inv_a,
             acc[j][1] * inv_a);
    }
    if (row_b < sq) {
      store2(op + static_cast<size_t>(row_b) * D + col, acc[j][2] * inv_b,
             acc[j][3] * inv_b);
    }
  }
  if (t4 == 0) {
    float* lp = lse + static_cast<size_t>(bh) * sq;
    if (row_a < sq) {
      lp[row_a] = m_run[0] * kLn2 + logf(l_run[0] == 0.f ? 1.f : l_run[0]);
    }
    if (row_b < sq) {
      lp[row_b] = m_run[1] * kLn2 + logf(l_run[1] == 0.f ? 1.f : l_run[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 tiles on the FMA units.  256 threads as 16 x 16: thread (ty, tx) owns
// rows 4ty..4ty+3 and columns tx + 16j of each S tile, and the same rows and
// columns tx + 16j of O.  A row's 16 threads are 16 neighbouring lanes, so
// row reductions are four shuffles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256)
fa2_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int hq, int hkv, int sq, int skv,
             int kv_len, float qscale, int causal) {
  constexpr int LDQ = D + 1;  // odd strides: conflict-free column reads
  constexpr int LDK = D + 1;
  constexpr int LDV = D;
  constexpr int LDP = kBlockN + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockM * LDQ;
  float* vs = ks + kBlockN * LDK;
  float* ps = vs + kBlockN * LDV;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const float* qp = q + static_cast<size_t>(bh) * sq * D;
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;

  for (int i = threadIdx.x; i < kBlockM * D; i += 256) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r * LDQ + c] =
        q0 + r < sq ? qp[static_cast<size_t>(q0 + r) * D + c] * qscale : 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kBlockM) : kv_len;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  float m_run[4], l_run[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockN * D; i += 256) {
      const int r = i / D;
      const int c = i - r * D;
      const bool in = k0 + r < skv;
      const size_t at = static_cast<size_t>(k0 + r) * D + c;
      ks[r * LDK + c] = in ? kp[at] : 0.f;
      vs[r * LDV + c] = in ? vp[at] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    const bool need_mask =
        (k0 + kBlockN > kv_len) || (causal && k0 + kBlockN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + tx + 16 * j;
          if (col >= kv_len || (causal && col > row)) s[i][j] = kMaskValue;
        }
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[i][j] - m_new);
        if (need_mask && s[i][j] == kMaskValue) p = 0.f;
        rs += p;
        ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
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
  }

  float* op = o + static_cast<size_t>(bh) * sq * D;
  float* lp = lse + static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      op[static_cast<size_t>(row) * D + tx + 16 * j] = acc[i][j] * inv;
    }
    if (tx == 0) lp[row] = m_run[i] * kLn2 + logf(l == 0.f ? 1.f : l);
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

template <typename Tin, typename Tt, int D>
cudaError_t launch_mma(dim3 grid, cudaStream_t stream, const void* q,
                       const void* k, const void* v, void* o, void* lse,
                       int hq, int hkv, int sq, int skv, int kv_len,
                       float qscale, int causal) {
  const size_t smem = (kBlockM + 2 * kBlockN) * (D + 8) * sizeof(Tt);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(fa2_fwd_mma<Tin, Tt, D>,
                                  static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  fa2_fwd_mma<Tin, Tt, D><<<grid, 128, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<Tin*>(o),
      static_cast<float*>(lse), hq, hkv, sq, skv, kv_len, qscale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(dim3 grid, cudaStream_t stream, const void* q,
                        const void* k, const void* v, void* o, void* lse,
                        int hq, int hkv, int sq, int skv, int kv_len,
                        float qscale, int causal) {
  const size_t smem = (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
                       kBlockM * (kBlockN + 1)) * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(fa2_fwd_fp32<D>, static_cast<int>(smem),
                                  smem_set);
  if (err != cudaSuccess) return err;
  fa2_fwd_fp32<D><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), hq, hkv, sq, skv, kv_len, qscale, causal);
  return cudaGetLastError();
}

// The tensor-core launch for input type Tin and tile code `tiles` (1 bf16,
// 2 fp16).
template <typename Tin, int D>
cudaError_t launch_mma_tiles(int tiles, dim3 grid, cudaStream_t st,
                             const void* q, const void* k, const void* v,
                             void* o, void* lse, int hq, int hkv, int sq,
                             int skv, int kv_len, float qscale, int causal) {
  if (tiles == 1) {
    return launch_mma<Tin, __nv_bfloat16, D>(grid, st, q, k, v, o, lse, hq,
                                             hkv, sq, skv, kv_len, qscale,
                                             causal);
  }
  return launch_mma<Tin, __half, D>(grid, st, q, k, v, o, lse, hq, hkv, sq,
                                    skv, kv_len, qscale, causal);
}

}  // namespace

extern "C" {

// q [batch, hq, sq, head_dim]; k, v [batch, hkv, skv, head_dim]; o like q;
// lse [batch, hq, sq] fp32.  All contiguous.  in_bf16: q/k/v/o are bf16
// (else fp32).  tiles: 0 fp32 on the FMA units (needs fp32 inputs), 1 bf16
// or 2 fp16 on the tensor cores.  qscale = sm_scale * log2(e).  Returns a
// cudaError_t.
int cfa_fa2_forward(const void* q, const void* k, const void* v, void* o,
                    void* lse, int batch, int hq, int hkv, int sq, int skv,
                    int head_dim, int kv_len, float qscale, int causal,
                    int in_bf16, int tiles, void* stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles == 1 || tiles == 2) {
    if (in_bf16) {
      if (head_dim == 64) {
        return launch_mma_tiles<__nv_bfloat16, 64>(
            tiles, grid, st, q, k, v, o, lse, hq, hkv, sq, skv, kv_len, qscale,
            causal);
      }
      if (head_dim == 128) {
        return launch_mma_tiles<__nv_bfloat16, 128>(
            tiles, grid, st, q, k, v, o, lse, hq, hkv, sq, skv, kv_len, qscale,
            causal);
      }
    } else {
      if (head_dim == 64) {
        return launch_mma_tiles<float, 64>(tiles, grid, st, q, k, v, o, lse,
                                           hq, hkv, sq, skv, kv_len, qscale,
                                           causal);
      }
      if (head_dim == 128) {
        return launch_mma_tiles<float, 128>(tiles, grid, st, q, k, v, o, lse,
                                            hq, hkv, sq, skv, kv_len, qscale,
                                            causal);
      }
    }
  } else if (tiles == 0 && !in_bf16) {
    if (head_dim == 64) {
      return launch_fp32<64>(grid, st, q, k, v, o, lse, hq, hkv, sq, skv,
                             kv_len, qscale, causal);
    }
    if (head_dim == 128) {
      return launch_fp32<128>(grid, st, q, k, v, o, lse, hq, hkv, sq, skv,
                              kv_len, qscale, causal);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_fa2_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
