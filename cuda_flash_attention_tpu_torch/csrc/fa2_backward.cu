// FlashAttention-2 backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three Pallas TPU kernels of
//   cuda_flash_attention_tpu/kernels/fa2_backward.py:
//   B2 fa2_backward_fused_aligned  (dK, dV and per-KV-tile dQ partials, one
//                                   recompute, D_i folded in)
//   B3 fa2_backward_dq_aligned     (dQ on a Q-major grid)
//   B4 fa2_backward_dkv_aligned    (dK, dV on a KV-major grid)
// They compute what _compute_p_ds and the three kernel bodies compute, with
// causal masking, a ragged KV tail (kv_len) and GQA (query head h reads KV
// head h / (Hq / Hkv)).  Windows, sinks and segment ids are not taken here;
// the Python wrappers refuse them.
//
// The algebra (fa2_backward.py:59-112), per (query row i, key j):
//   Q_s = round_tile(Q * sm_scale * log2(e))          (fp32 multiply first)
//   P   = exp2(Q_s K^T - lse * log2(e)), exactly 0 where masked
//   dS  = P * (dO V^T - D_i),  D_i = rowsum(dO * O) in fp32
//   dV  = P^T dO,  dK = ln2 * (dS^T Q_s),  dQ = sm_scale * (dS K)
// P and dS are rounded to the tile type before their products; every sum is
// fp32.
//
// What bounds it on the H100: tensor-core FLOPs.  The backward does 2.5x the
// forward's matmul work (five S x S x D products against two) on the same
// ~6 S D bytes per head, so at the train shape (B 4, Hq 16, Hkv 8, S 2048,
// D 64, causal, bf16) it sits far above the ~295 FLOP/byte ridge.  The
// designs keep S, P and dS on chip and never add floats across blocks.
//
// With bf16 or fp16 tiles all three kernels share one design, fed by TMA
// and mbarrier rings, products on `wgmma.mma_async` with fp32 accumulators:
//   * a prologue, once per call, forms what every block would otherwise
//     form again for every tile it meets: Q_s (the fp32 multiply, then the
//     rounding), lse * log2(e), D_i (folded in from O and dO in fp32 for B2;
//     the caller's D_i copied for B3 and B4), and dO, K and V in the tile
//     type where the inputs are not (TMA copies bytes and cannot scale or
//     convert), into padded planes whose rows past Sq hold zeros.  It
//     rounds where the plain version rounds;
//   * B2 and B4 run one kernel, `bwd_fused_wgmma`, with B4 leaving out the
//     dQ phase (template flag DQ): one block per (128-row KV tile, b*Hkv),
//     384 threads.  Warpgroup 0 is the producer (`setmaxnreg.dec`): one
//     thread loads the K and V tiles once by TMA, then streams the walk's
//     Q_s and dO tiles (3-D maps, 128-byte swizzle, rows past Sq as zeros)
//     and their lse and D_i rows (1-D bulk copies) into a ring of stages
//     with full and empty mbarriers.  The walk covers the GQA group's query
//     heads and, under causal, only the Q tiles at or below the diagonal; a
//     KV tile wholly past kv_len walks nothing.  Warpgroups 1 and 2
//     (`setmaxnreg.inc`) each own 64 KV rows: S^T = K Q_s^T and dP^T = V
//     dO^T from shared memory; P^T and dS^T in registers (the accumulators,
//     rounded to the tile type, are the register A fragments); dV += P^T dO
//     and dK += dS^T Q_s with B read through the transpose bit.  dK and dV
//     accumulate in registers over the whole walk (the GQA sum without
//     atomics) and are stored once.  Q tiles are 128 rows at D = 64 and 64
//     at D = 128, which keeps the dK and dV accumulators (D / 2 registers
//     each) and the S^T and dP^T ones within 240 registers.  B2 adds the dQ
//     phase: each consumer writes its dS^T rows, swizzled, into one of two
//     shared buffers; after a named barrier each computes its half of the
//     dQ tile, dS K over the tile's 128 KV rows, with A = dS^T and B = the
//     K tile both through the transpose bits, and stores it into its own
//     slice dq_part[b, h, kv_tile] (the halves are Q rows at D = 64 and
//     columns at D = 128);
//   * B2's reduce adds each Q row's live slices in KV-tile order,
//     multiplies by sm_scale and writes q's type.  Only the slices of the
//     Q tiles a KV tile reaches are written, and only those are read: a
//     skipped slice holds zeros or nothing, so the ordered sum is exact and
//     bitwise the same from run to run, with no atomicAdd;
//   * B3, `bwd_dq_wgmma`: one block per (128-row Q tile, b*Hq), 384
//     threads, the Q tiles handed out longest causal row first.  The
//     producer loads the block's Q_s and dO tiles and their lse and D_i
//     rows once, then streams 128-row (D = 64) or 64-row (D = 128) K and V
//     tiles through rings of their own; the walk stops at the causal
//     diagonal and at kv_len.  Each consumer owns 64 Q rows: S = Q_s K^T and
//     dP = dO V^T (both K-major, from shared memory), P and dS = P (dP -
//     D_i) in fp32, dS rounded to the tile type as the register A fragment
//     of dQ += dS K, whose B is the K tile read through the transpose bit.
//     dQ stays in registers over the whole walk (S 64 + dP 64 + dQ 32
//     registers at D = 64, 32 + 32 + 64 at D = 128) and is stored once,
//     times sm_scale, in q's type; nothing is added across blocks.  As in
//     B1's forward, dQ(t) runs on the tensor cores while the gradients of
//     tile t + 1 run on the other units (S(t + 1) and dP(t + 1) are issued
//     first), and the two consumers take turns to issue their products;
//     dS is rounded into the A fragments only once dQ(t) has completed
//     (rounding it into a second set of fragments while dQ(t) was in
//     flight, then copying them over, ran a third slower at the train
//     shape and drew ptxas's C7513 in one instantiation).
// B3 and B4 take exp2 on the special-function unit with results below
// 2^-126 flushed to zero, as B1 does; B2 keeps exp2f.
// fp32 tiles (B2, B3 and B4) run on the FMA units (no TF32), held to IEEE
// fp32; B2's fp32 body writes zeros into the slices above the diagonal,
// which the reduce skips.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kKvRows = 128;  // KV rows per block of B2/B4 with bf16 tiles
constexpr int kTile32 = 64;   // Q and KV tile of the fp32 kernels
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// wgmma forms of the 16-bit tiles, with fp32 accumulators of 32 (N = 64)
// or 64 (N = 128) registers.  ss: A and B both from shared memory,
// K-major.  ss_tt: both from shared memory, MN-major (the transpose bits).
// rs: A from registers, B from shared memory, MN-major.  The scale-d
// predicate is 0 to overwrite the accumulators, 1 to add to them.
#define CFA_BWD_SS_N64(TY, TA, TB)                                           \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{" CFA_R32 "}, %32, %33, p, 1, 1, " TA ", " TB ";\n}\n"               \
      : CFA_ACC32(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define CFA_BWD_SS_N128(TY)                                                  \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{" CFA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                         \
      : CFA_ACC64(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define CFA_BWD_RS_N64(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{" CFA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC32(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define CFA_BWD_RS_N128(TY)                                                  \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{" CFA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC64(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// The two 16-bit tile types of the tensor-core path: packing two fp32 values
// (round to nearest even) and the wgmma forms.
template <typename Tt>
struct Tile;

#define CFA_BWD_WGMMA_FORMS(TY)                                              \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, \
                                            uint64_t desc_b, int scale_d) {  \
    CFA_BWD_SS_N64(TY, "0", "0");                                            \
  }                                                                          \
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, \
                                            uint64_t desc_b, int scale_d) {  \
    CFA_BWD_SS_N128(TY);                                                     \
  }                                                                          \
  static __device__ __forceinline__ void ss_tt(float (&d)[32],               \
                                               uint64_t desc_a,              \
                                               uint64_t desc_b, int scale_d) { \
    CFA_BWD_SS_N64(TY, "1", "1");                                            \
  }                                                                          \
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, \
                                            uint64_t desc_b) {               \
    CFA_BWD_RS_N64(TY);                                                      \
  }                                                                          \
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, \
                                            uint64_t desc_b) {               \
    CFA_BWD_RS_N128(TY);                                                     \
  }

template <>
struct Tile<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  CFA_BWD_WGMMA_FORMS("bf16")
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
  CFA_BWD_WGMMA_FORMS("f16")
};

// Copy rows [row0, row0 + ROWS) of a [nrows, D] fp32 matrix into a shared
// tile with leading dimension LD, multiplied by `scale`.  Rows past nrows
// are zero.
template <int D, int ROWS, int LD, int NTHREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int nrows, float scale) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * LD + c] =
        row0 + r < nrows ? src[static_cast<size_t>(row0 + r) * D + c] * scale
                         : 0.f;
  }
}

// exp2 on the special-function unit; results below 2^-126 flush to zero
// (B1's, csrc/fa2_forward.cu).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Per-row statistics of one Q tile into shared memory: lse * log2(e), and
// D_i, which is either read (B4's fp32 body) or folded in from O and dO in
// fp32 (B2's, FOLD).  Rows past sq get 0 for both, so their P is finite
// and their dS, with zero dO, is 0.
template <typename Tin, int D, int ROWS, int NTHREADS, bool FOLD>
__device__ __forceinline__ void stage_stats(float* lse2_s, float* di_s,
                                            const float* lp, const float* dip,
                                            const Tin* op, const Tin* dop,
                                            int q0, int sq) {
  if (FOLD) {
    constexpr int kTpr = NTHREADS / ROWS;  // threads per row, neighbours
    constexpr int kEpt = D / kTpr;         // elements per thread
    const int r = threadIdx.x / kTpr;
    const int c0 = (threadIdx.x % kTpr) * kEpt;
    float acc = 0.f;
    if (q0 + r < sq) {
      const size_t at = static_cast<size_t>(q0 + r) * D;
#pragma unroll
      for (int c = c0; c < c0 + kEpt; c += 8) {
        float a[8], b[8];
        load8(dop + at + c, a);
        load8(op + at + c, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(a[j], b[j], acc);
      }
    }
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (threadIdx.x % kTpr == 0) {
      di_s[r] = acc;
      lse2_s[r] = q0 + r < sq ? lp[q0 + r] * kLog2e : 0.f;
    }
  } else if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    lse2_s[r] = q0 + r < sq ? lp[q0 + r] * kLog2e : 0.f;
    di_s[r] = q0 + r < sq ? dip[q0 + r] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// fp32 tiles on the FMA units.  256 threads as 16 x 16: thread (ty, tx) owns
// rows 4ty..4ty+3 of a 64-row tile and columns tx + 16j.  Every product reads
// its operands from shared memory; odd leading dimensions keep the column
// reads conflict-free.
// ---------------------------------------------------------------------------
template <int D, bool FUSED>
__global__ void __launch_bounds__(256)
bwd_kv_fp32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ o,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ di, float* __restrict__ dk,
            float* __restrict__ dv, float* __restrict__ dq_part, int hq,
            int hkv, int sq, int skv, int kv_len, float qscale, int causal) {
  constexpr int T = kTile32;
  constexpr int LDK = D + 1;
  constexpr int LDP = T + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + T * LDK;
  float* qs = vs + T * LDK;
  float* dos = qs + T * LDK;
  float* pt = dos + T * LDK;   // P^T [kv][q]
  float* dst = pt + T * LDP;   // dS^T [kv][q]
  float* lse2_s = dst + T * LDP;
  float* di_s = lse2_s + T;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int kt = blockIdx.x;
  const int k0 = kt * T;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const size_t kv_off = static_cast<size_t>(bh) * skv * D;

  stage_f32<D, T, LDK, 256>(ks, k + kv_off, k0, skv, 1.f);
  stage_f32<D, T, LDK, 256>(vs, v + kv_off, k0, skv, 1.f);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }
  const int n_q_tiles = (sq + T - 1) / T;
  const int q_first = causal ? min(k0 / T, n_q_tiles) : 0;

  for (int gi = 0; gi < groups; ++gi) {
    const size_t bhq = static_cast<size_t>(b) * hq + hk * groups + gi;
    const float* qp = q + bhq * sq * D;
    const float* dop = dout + bhq * sq * D;
    const float* op = FUSED ? o + bhq * sq * D : nullptr;
    const float* lp = lse + bhq * sq;
    const float* dip = FUSED ? nullptr : di + bhq * sq;
    float* dqp = FUSED
        ? dq_part + (bhq * gridDim.x + kt) * static_cast<size_t>(sq) * D
        : nullptr;
    if (FUSED) {
      const int dead = min(q_first * T, sq) * D / 4;
      for (int i = threadIdx.x; i < dead; i += 256) {
        reinterpret_cast<float4*>(dqp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int qt = q_first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * T;
      __syncthreads();
      stage_f32<D, T, LDK, 256>(qs, qp, q0, sq, qscale);
      stage_f32<D, T, LDK, 256>(dos, dop, q0, sq, 1.f);
      stage_stats<float, D, T, 256, FUSED>(lse2_s, di_s, lp, dip, op, dop, q0,
                                           sq);
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty * 4 + i) * LDK + d];
          vv[i] = vs[(ty * 4 + i) * LDK + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * LDK + d];
          dv4[j] = dos[(tx + 16 * j) * LDK + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dv4[j], dpt[i][j]);
          }
        }
      }
      const bool need_mask = (k0 + T > kv_len) || (causal && k0 + T - 1 > q0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float p = exp2f(st[i][j] - lse2_s[c]);
          if (need_mask && (row >= kv_len || (causal && row > q0 + c))) p = 0.f;
          pt[(ty * 4 + i) * LDP + c] = p;
          dst[(ty * 4 + i) * LDP + c] = p * (dpt[i][j] - di_s[c]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q_s.
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        float dov[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = dos[c * LDK + tx + 16 * j];
          qv[j] = qs[c * LDK + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = pt[(ty * 4 + i) * LDP + c];
          const float ds = dst[(ty * 4 + i) * LDP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(p, dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds, qv[j], dk_acc[i][j]);
          }
        }
      }

      if (FUSED) {
        // dQ slice: rows q 4ty+i, columns tx + 16j, summed over the tile's
        // KV rows: dS[q][c] K[c][d] = dS^T[c][q] K[c][d].
        float dq[4][DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < T; ++c) {
          float kv[DJ];
#pragma unroll
          for (int j = 0; j < DJ; ++j) kv[j] = ks[c * LDK + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ds = dst[c * LDP + ty * 4 + i];
#pragma unroll
            for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(ds, kv[j], dq[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty * 4 + i;
          if (row >= sq) continue;
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dqp[static_cast<size_t>(row) * D + tx + 16 * j] = dq[i][j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= skv) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t at = kv_off + static_cast<size_t>(row) * D + tx + 16 * j;
      dk[at] = dk_acc[i][j] * kLn2;
      dv[at] = dv_acc[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
bwd_dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dq, int hq, int hkv, int sq, int skv,
            int kv_len, float qscale, float sm_scale, int causal) {
  constexpr int T = kTile32;
  constexpr int LDK = D + 1;
  constexpr int LDP = T + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + T * LDK;
  float* ks = dos + T * LDK;
  float* vs = ks + T * LDK;
  float* dss = vs + T * LDK;  // dS [q][kv]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;

  stage_f32<D, T, LDK, 256>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq,
                            qscale);
  stage_f32<D, T, LDK, 256>(dos, dout + static_cast<size_t>(bh) * sq * D, q0,
                            sq, 1.f);
  float lse2[4], dd[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse2[i] = row < sq ? lse[static_cast<size_t>(bh) * sq + row] * kLog2e : 0.f;
    dd[i] = row < sq ? di[static_cast<size_t>(bh) * sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + T) : kv_len;
  const int n_tiles = (kv_end + T - 1) / T;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();
    stage_f32<D, T, LDK, 256>(ks, kp, k0, skv, 1.f);
    stage_f32<D, T, LDK, 256>(vs, vp, k0, skv, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dv4[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * LDK + d];
        dv4[i] = dos[(ty * 4 + i) * LDK + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * LDK + d];
        vv[j] = vs[(tx + 16 * j) * LDK + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv4[i], vv[j], dp[i][j]);
        }
      }
    }
    const bool need_mask = (k0 + T > kv_len) || (causal && k0 + T - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = exp2f(s[i][j] - lse2[i]);
        if (need_mask && (col >= kv_len || (causal && col > row))) p = 0.f;
        dss[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - dd[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * LDK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty * 4 + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

  float* dqp = dq + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dqp[static_cast<size_t>(row) * D + tx + 16 * j] = acc[i][j] * sm_scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt): the prologue (B2, B3, B4), the KV-major wgmma
// kernel (B2 with DQ, B4 without), B2's dQ reduce, and B3's Q-major wgmma
// kernel.
// ---------------------------------------------------------------------------
// Eight lanes' worth of a row: 8 values of a 16-bit tile type, packed.
template <typename Tt>
__device__ __forceinline__ void store8(Tt* p, const float* x, float scale) {
  uint4 packed;
  packed.x = Tile<Tt>::pack(x[0] * scale, x[1] * scale);
  packed.y = Tile<Tt>::pack(x[2] * scale, x[3] * scale);
  packed.z = Tile<Tt>::pack(x[4] * scale, x[5] * scale);
  packed.w = Tile<Tt>::pack(x[6] * scale, x[7] * scale);
  *reinterpret_cast<uint4*>(p) = packed;
}

// D / 8 lanes per row, 8 contiguous values a lane.  Rows [0, q_rows *
// sq_pad) are query rows (b*Hq + h, r): Q_s = round_tile(Q * qscale) with
// the fp32 multiply first, dO in the tile type (where dos is given), lse2 =
// lse * log2(e) and D_i, both 0 for rows r >= sq (the padding up to
// sq_pad).  D_i is rowsum(dO * O) in fp32 where o is given (B2), else the
// caller's di [q_rows, sq] copied (B3, B4).  The rows after them are K and
// V rows, cast to the tile type (where ks is given).  Every conversion
// rounds to nearest even, where the plain version rounds.
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(256)
bwd_prologue(const Tin* __restrict__ q, const Tin* __restrict__ o,
             const Tin* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ di_in, const Tin* __restrict__ k,
             const Tin* __restrict__ v, Tt* __restrict__ qs,
             Tt* __restrict__ dos, Tt* __restrict__ ks, Tt* __restrict__ vs,
             float* __restrict__ lse2, float* __restrict__ di, int q_rows,
             int sq, int sq_pad, int kv_rows, float qscale) {
  constexpr int kLanes = D / 8;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const size_t row = (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x) / kLanes;
  const size_t n_q = static_cast<size_t>(q_rows) * sq_pad;
  float acc = 0.f;
  size_t bhq = 0;
  int r = 0;
  if (row < n_q) {
    bhq = row / sq_pad;
    r = static_cast<int>(row - bhq * sq_pad);
    if (r < sq) {
      const size_t at = (bhq * sq + r) * D + 8 * sub;
      float x[8], g[8], y[8];
      load8(q + at, x);
      store8(qs + at, x, qscale);
      if (o != nullptr || dos != nullptr) load8(dout + at, g);
      if (o != nullptr) {
        load8(o + at, y);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(g[i], y[i], acc);
      }
      if (dos != nullptr) store8(dos + at, g, 1.f);
    }
  } else if (ks != nullptr && row - n_q < static_cast<size_t>(kv_rows)) {
    const size_t at = (row - n_q) * D + 8 * sub;
    float x[8];
    load8(k + at, x);
    store8(ks + at, x, 1.f);
    load8(v + at, x);
    store8(vs + at, x, 1.f);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (row < n_q && sub == 0) {
    lse2[row] = r < sq ? lse[bhq * sq + r] * kLog2e : 0.f;
    if (o != nullptr) {
      di[row] = acc;
    } else {
      di[row] = r < sq ? di_in[bhq * sq + r] : 0.f;
    }
  }
}

// Shared memory of the KV-major kernel, from a 1024-byte-aligned base: the
// block's K and V tiles, kStages stages of Q_s and of dO, with DQ two dS^T
// buffers, kStages stages of the row statistics ([lse2 | D_i][BQ] fp32),
// then the mbarriers.  Without DQ (B4) a third stage in place of the dS^T
// buffers ran as fast as two, and 8% slower at a ragged S 1000 (timed by
// scripts/kernel_ab.py --kernel b4; PERF.md).  K, V, Q_s and dO arrive by TMA as boxes of R rows x
// 64 columns (128 bytes), 128-byte-swizzled (16-byte chunk c of row r at c
// ^ (r % 8)).  dS^T [128 kv][BQ q] is stored by the consumers in the same
// swizzle, as BQ / 64 atoms of 128 rows x 64 q columns.
template <int D, bool DQ>
struct BwdLayout {
  static constexpr int BQ = D == 64 ? 128 : 64;  // Q rows per step of the walk
  static constexpr int kStages = 2;
  static constexpr int kBoxes = D / 64;
  static constexpr int kKVBox = kKvRows * 128;
  static constexpr int kQBox = BQ * 128;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kDsAtom = kKvRows * 128;
  static constexpr int kDsBytes = DQ ? kDsAtom * (BQ / 64) : 0;
  static constexpr int kStatBytes = 2 * BQ * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDs = kDO + kStages * kQBytes;
  static constexpr int kStats = kDs + 2 * kDsBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  // full K/V, full and empty of each stage, and alignment slack.
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Registers per thread after setmaxnreg: 128 x 24 + 256 x 240 = 64512 of
// the SM's 65536 (one block per SM).  Both wgmma kernels.
constexpr int kBwdThreads = 384;
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;

// One block per (128-row KV tile, b * Hkv).  Warpgroup 0 is the producer:
// one thread loads the K and V tiles once, then streams the walk's Q_s and
// dO tiles with their statistics into the stage ring.  Warpgroups 1 and 2
// (consumer c) own KV rows [64 c, 64 c + 64) of the tile; warp w of a
// consumer holds rows 16 w + g and 16 w + g + 8 of every accumulator,
// columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-column group j.  With DQ
// (B2) each step also writes the tile's dQ slice; without it (B4) the block
// computes dK and dV only, and dq_part is not written.
template <typename Tin, typename Tt, int D, bool DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_fused_wgmma(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ lse2, const float* __restrict__ di,
                Tin* __restrict__ dk, Tin* __restrict__ dv,
                float* __restrict__ dq_part, int hq, int hkv, int sq,
                int sq_pad, int skv, int kv_len, int causal) {
  using L = BwdLayout<D, DQ>;
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_kv = base + L::kBars;
  const uint32_t full_q = full_kv + 8;             // stage s at + 8 s
  const uint32_t empty_q = full_q + 8 * kStages;

  const int kt = blockIdx.x;
  const int k0 = kt * kKvRows;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const int n_q = (sq + BQ - 1) / BQ;
  // Under causal the walk starts at the diagonal; a KV tile wholly past
  // kv_len walks nothing (its dK and dV are zeros, its dQ slice is dead).
  const int q_first = causal ? min(k0 / BQ, n_q) : 0;
  const int per_head = k0 < kv_len ? n_q - q_first : 0;
  const int n_steps = groups * per_head;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_q + 8 * s, 1);
      mbar_init(empty_q + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (threadIdx.x == 0 && n_steps > 0) {
      mbar_expect_tx(full_kv, 2 * L::kKVBytes);
#pragma unroll
      for (int box = 0; box < L::kBoxes; ++box) {
        tma_load_3d(base + L::kK + box * L::kKVBox, &k_map, full_kv, box * 64,
                    k0, bh);
        tma_load_3d(base + L::kV + box * L::kKVBox, &v_map, full_kv, box * 64,
                    k0, bh);
      }
      for (int j = 0; j < n_steps; ++j) {
        const int gi = j / per_head;
        const int q0 = (q_first + j - gi * per_head) * BQ;
        const int bhq = b * hq + hk * groups + gi;
        const int st = j % kStages;
        // The first pass over the ring finds every stage empty.
        mbar_wait(empty_q + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_q + 8 * st, 2 * L::kQBytes + L::kStatBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(base + L::kQ + st * L::kQBytes + box * L::kQBox, &q_map,
                      full_q + 8 * st, box * 64, q0, bhq);
          tma_load_3d(base + L::kDO + st * L::kQBytes + box * L::kQBox,
                      &do_map, full_q + 8 * st, box * 64, q0, bhq);
        }
        const size_t row = static_cast<size_t>(bhq) * sq_pad + q0;
        const uint32_t stats = base + L::kStats + st * L::kStatBytes;
        tma_load_1d(stats, lse2 + row, BQ * 4, full_q + 8 * st);
        tma_load_1d(stats + BQ * 4, di + row, BQ * 4, full_q + 8 * st);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r_a = 64 * c + 16 * warp + g;  // this thread's rows of the KV tile
  const int r_b = r_a + 8;
  const int kv_a = k0 + r_a;
  const int kv_b = k0 + r_b;
  // The consumer's share of each dQ tile (DQ): Q rows [qm, qm + 64) and
  // columns [dn, dn + 64), over all 128 KV rows of the tile.
  const int qm = BQ == 128 ? 64 * c : 0;
  const int dn = D == 128 ? 64 * c : 0;
  const uint32_t ks = base + L::kK + 64 * c * 128;  // this consumer's K rows
  const uint32_t vs = base + L::kV + 64 * c * 128;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_steps > 0) mbar_wait(full_kv, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int gi = j / per_head;
    const int q0 = (q_first + j - gi * per_head) * BQ;
    const int bhq = b * hq + hk * groups + gi;
    const int st = j % kStages;
    const uint32_t qs = base + L::kQ + st * L::kQBytes;
    const uint32_t dos = base + L::kDO + st * L::kQBytes;
    const float* lse2_s =
        reinterpret_cast<const float*>(smem + L::kStats + st * L::kStatBytes);
    const float* di_s = lse2_s + BQ;
    mbar_wait(full_q + 8 * st, (j / kStages) & 1);

    // S^T = K Q_s^T and dP^T = V dO^T: D / 16 k-steps of 32 bytes, four to
    // a 128-byte box, all operands K-major.
    float st_acc[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
      Tile<Tt>::ss(st_acc, sw128_desc(ks + off, 16, 1024),
                   sw128_desc(qs + qoff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
      Tile<Tt>::ss(dpt, sw128_desc(vs + off, 16, 1024),
                   sw128_desc(dos + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(st_acc);
    hold(dpt);

    // P^T = exp2(S^T - lse2), exactly 0 where masked; dS^T = P^T (dP^T -
    // D_i), both in fp32, then rounded to the tile type: the accumulators
    // of column groups 2 kk and 2 kk + 1 are exactly the register A
    // fragment of k-step kk.
    const bool need_mask =
        (k0 + kKvRows > kv_len) || (causal && k0 + kKvRows - 1 > q0);
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jj * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? kv_a : kv_b;
        // B2 keeps exp2f; B4 takes exp2_ftz, as B1 and B3 (12% faster at
        // the train shape, PERF.md).
        const float x = st_acc[4 * jj + e] - lse2_s[col];
        float p = DQ ? exp2f(x) : exp2_ftz(x);
        if (need_mask && (row >= kv_len || (causal && row > q0 + col))) p = 0.f;
        st_acc[4 * jj + e] = p;
        dpt[4 * jj + e] = p * (dpt[4 * jj + e] - di_s[col]);
      }
    }
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = Tile<Tt>::pack(st_acc[8 * kk + 2 * i], st_acc[8 * kk + 2 * i + 1]);
        sa[kk][i] = Tile<Tt>::pack(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }
    }

    // dS^T into dS buffer j % 2 (the dQ product reads it as A, MN-major).
    unsigned char* dsb = smem + L::kDs + (j & 1) * L::kDsBytes;
    if constexpr (DQ) {
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const int atom = jj / 8;
        const int ch = jj % 8;
        *reinterpret_cast<uint32_t*>(dsb + atom * L::kDsAtom + r_a * 128 +
                                     ((ch ^ (r_a & 7)) * 16) + 4 * t4) =
            sa[jj / 2][(jj & 1) * 2];
        *reinterpret_cast<uint32_t*>(dsb + atom * L::kDsAtom + r_b * 128 +
                                     ((ch ^ (r_b & 7)) * 16) + 4 * t4) =
            sa[jj / 2][(jj & 1) * 2 + 1];
      }
    }

    // dV += P^T dO and dK += dS^T Q_s: k-step kk reads Q rows [16 kk, 16
    // kk + 16) of the stage, two 8-row groups 1024 bytes apart, MN-major;
    // the 64-column boxes are kQBox apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::rs(dv_acc, pa[kk], sw128_desc(dos + kk * 16 * 128, L::kQBox, 1024));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::rs(dk_acc, sa[kk], sw128_desc(qs + kk * 16 * 128, L::kQBox, 1024));
    }
    wgmma_commit();

    float dq[32];
    if constexpr (DQ) {
      // dS^T's generic-proxy stores must be visible to wgmma (the async
      // proxy), and both consumers' halves in place (named barrier 1),
      // before the dQ product.  Buffer j % 2 was last read by the dQ
      // product of step j - 2, which both consumers waited for before step
      // j - 1's barrier.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");

      // The dQ slice: dS K over the tile's 128 KV rows (8 k-steps), A =
      // dS^T and B = the K tile both MN-major.
      wgmma_fence();
      const uint32_t dsa = smem_addr(dsb) + (qm / 64) * L::kDsAtom;
      const uint32_t kb = base + L::kK + (dn / 64) * L::kKVBox;
#pragma unroll
      for (int kk = 0; kk < kKvRows / 16; ++kk) {
        Tile<Tt>::ss_tt(dq, sw128_desc(dsa + kk * 16 * 128, L::kDsAtom, 1024),
                        sw128_desc(kb + kk * 16 * 128, L::kKVBox, 1024), kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    hold(dk_acc);
    hold(dv_acc);
    if constexpr (DQ) hold(dq);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hold(pa[kk]);
      hold(sa[kk]);
    }
    // Q_s, dO and the statistics of this stage are read.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_q + 8 * st);

    if constexpr (DQ) {
      float* dqp =
          dq_part + (static_cast<size_t>(bhq) * gridDim.x + kt) * sq * D;
      const int ra = q0 + qm + 16 * warp + g;
      const int rb = ra + 8;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = dn + jj * 8 + t4 * 2;
        if (ra < sq) store2(dqp + static_cast<size_t>(ra) * D + col, dq[4 * jj], dq[4 * jj + 1]);
        if (rb < sq) store2(dqp + static_cast<size_t>(rb) * D + col, dq[4 * jj + 2], dq[4 * jj + 3]);
      }
    }
  }

  const size_t kv_off = static_cast<size_t>(bh) * skv * D;
  Tin* dkp = dk + kv_off;
  Tin* dvp = dv + kv_off;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = jj * 8 + t4 * 2;
    if (kv_a < skv) {
      store2(dkp + static_cast<size_t>(kv_a) * D + col, dk_acc[4 * jj] * kLn2,
             dk_acc[4 * jj + 1] * kLn2);
      store2(dvp + static_cast<size_t>(kv_a) * D + col, dv_acc[4 * jj],
             dv_acc[4 * jj + 1]);
    }
    if (kv_b < skv) {
      store2(dkp + static_cast<size_t>(kv_b) * D + col, dk_acc[4 * jj + 2] * kLn2,
             dk_acc[4 * jj + 3] * kLn2);
      store2(dvp + static_cast<size_t>(kv_b) * D + col, dv_acc[4 * jj + 2],
             dv_acc[4 * jj + 3]);
    }
  }
}

// dQ = sm_scale * (sum of the live slices of dq_part, in KV-tile order), in
// q's type.  Slice t (KV rows [t tile, t tile + tile)) is live for row r
// when t tile < kv_len and, under causal, t tile <= r; every other slice
// holds zeros or nothing, so skipping it leaves the ordered sum exact.
template <typename Tout>
__global__ void __launch_bounds__(256)
dq_reduce(const float* __restrict__ dq_part, Tout* __restrict__ dq, int sq,
          int d, int n_slices, int n_live, int tile, int causal,
          float sm_scale) {
  // blockIdx.y is b * Hq + h; x walks that head's sq * d / 4 float4s.
  const size_t head = static_cast<size_t>(blockIdx.y) * sq * d;
  const float* src = dq_part + head * n_slices;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < sq * d / 4;
       i += gridDim.x * 256) {
    const int r = 4 * i / d;
    const int last = causal ? min(n_live, r / tile + 1) : n_live;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < last; ++t) {
      const float4 x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(t) * sq * d + 4 * i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store2(dq + head + 4 * i, acc.x * sm_scale, acc.y * sm_scale);
    store2(dq + head + 4 * i + 2, acc.z * sm_scale, acc.w * sm_scale);
  }
}

// Shared memory of B3's kernel, from a 1024-byte-aligned base: the block's
// Q_s and dO tiles (BQ rows), kStages K stages, kStages V stages (BN rows
// each), the row statistics ([lse2 | D_i][BQ] fp32), then the mbarriers.
// Every tile is D / 64 TMA boxes of R rows x 128 bytes, 128-byte-swizzled.
template <int D>
struct DqLayout {
  static constexpr int BQ = 128;                 // Q rows per block
  static constexpr int BN = D == 64 ? 128 : 64;  // KV rows per ring stage
  static constexpr int kStages = 3;  // 1.08-1.23x faster than 2 (PERF.md)
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = BQ * 128;
  static constexpr int kKVBox = BN * 128;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kStatBytes = 2 * BQ * 4;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kStats = kV + kStages * kKVBytes;
  static constexpr int kBars = kStats + kStatBytes;
  // full Q, full and empty of each K and V stage, and alignment slack.
  static constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
};

// B3: one block per (128-row Q tile, b * Hq), the tiles handed out from the
// last, so the longest causal rows start first.  Warpgroup 0 is the
// producer: one thread loads the block's Q_s and dO tiles and their lse2
// and D_i rows once, then streams the K and V tiles of the walk (to the
// causal diagonal and kv_len) into their rings.  Warpgroups 1 and 2
// (consumer c) own Q rows [64 c, 64 c + 64) of the tile; warp w of a
// consumer holds rows 16 w + g and 16 w + g + 8 of every accumulator,
// columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-column group j.
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap do_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ lse2, const float* __restrict__ di,
             Tin* __restrict__ dq, int hq, int hkv, int sq, int sq_pad,
             int kv_len, float sm_scale, int causal) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ;
  constexpr int BN = L::BN;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_q = base + L::kBars;
  const uint32_t full_k = full_q + 8;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * hq + query head
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  // Under causal the walk ends at the tile's last row before sq; a walk
  // with no key (kv_len 0) loads nothing and stores zeros.
  const int kv_end = causal ? min(kv_len, min(sq, q0 + BQ)) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(full_q, 2 * L::kQBytes + L::kStatBytes);
#pragma unroll
      for (int box = 0; box < L::kBoxes; ++box) {
        tma_load_3d(base + L::kQ + box * L::kQBox, &q_map, full_q, box * 64,
                    q0, bh);
        tma_load_3d(base + L::kDO + box * L::kQBox, &do_map, full_q, box * 64,
                    q0, bh);
      }
      const size_t row = static_cast<size_t>(bh) * sq_pad + q0;
      tma_load_1d(base + L::kStats, lse2 + row, BQ * 4, full_q);
      tma_load_1d(base + L::kStats + BQ * 4, di + row, BQ * 4, full_q);
      const int kv_head = b * hkv + hk;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        // The first pass over a ring finds every stage empty.  V goes
        // first: its stage is freed before K's (after dP, not after dQ).
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        mbar_wait(empty_v + 8 * st, parity);
        mbar_expect_tx(full_v + 8 * st, L::kKVBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(base + L::kV + st * L::kKVBytes + box * L::kKVBox,
                      &v_map, full_v + 8 * st, box * 64, t * BN, kv_head);
        }
        mbar_wait(empty_k + 8 * st, parity);
        mbar_expect_tx(full_k + 8 * st, L::kKVBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(base + L::kK + st * L::kKVBytes + box * L::kKVBox,
                      &k_map, full_k + 8 * st, box * 64, t * BN, kv_head);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r_a = 64 * c + 16 * warp + g;  // this thread's rows of the Q tile
  const int row_a = q0 + r_a;
  const int row_b = row_a + 8;
  const int qc0 = q0 + 64 * c;
  const uint32_t qs = base + L::kQ + 64 * c * 128;  // this consumer's Q rows
  const uint32_t dos = base + L::kDO + 64 * c * 128;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float lse2_r[2] = {0.f, 0.f}, di_r[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    mbar_wait(full_q, 0);
    const float* stats = reinterpret_cast<const float*>(smem + L::kStats);
    lse2_r[0] = stats[r_a];
    lse2_r[1] = stats[r_a + 8];
    di_r[0] = stats[BQ + r_a];
    di_r[1] = stats[BQ + r_a + 8];
  }
  // A K or V stage is free once this warp's product that read it has
  // completed.
  auto release = [&](uint32_t empty, int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
  };
  float s[BN / 2], dp[BN / 2];
  uint32_t sa[BN / 16][4];
  // Issue S = Q_s K^T and dP = dO V^T of tile t, one group, not waited
  // for: D / 16 k-steps of 32 bytes, four to a 128-byte box, all operands
  // K-major.
  auto issue_sdp = [&](int t) {
    const int st = t % kStages;
    mbar_wait(full_k + 8 * st, (t / kStages) & 1);
    mbar_wait(full_v + 8 * st, (t / kStages) & 1);
    const uint32_t ks = base + L::kK + st * L::kKVBytes;
    const uint32_t vs = base + L::kV + st * L::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      Tile<Tt>::ss(s, sw128_desc(qs + qoff, 16, 1024),
                   sw128_desc(ks + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      Tile<Tt>::ss(dp, sw128_desc(dos + qoff, 16, 1024),
                   sw128_desc(vs + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // Issue dQ += dS K of tile t from sa, one group, not waited for: k-step
  // kk reads K rows [16 kk, 16 kk + 16) of the stage, two 8-row groups 1024
  // bytes apart, MN-major (the transpose bit); the 64-column boxes are
  // kKVBox apart.
  auto issue_dq = [&](int t) {
    const uint32_t ks = base + L::kK + (t % kStages) * L::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      Tile<Tt>::rs(dq_acc, sa[kk], sw128_desc(ks + kk * 16 * 128, L::kKVBox, 1024));
    }
    wgmma_commit();
  };
  // P = exp2(S - lse2), exactly 0 where masked, and dS = P (dP - D_i) of
  // tile t in fp32, in place of S.
  auto grads = [&](int t) {
    const int k0 = t * BN;
    const bool need_mask =
        (k0 + BN > kv_len) || (causal && k0 + BN - 1 > qc0);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + jj * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float p = exp2_ftz(s[4 * jj + e] - lse2_r[e >> 1]);
        if (need_mask && (col >= kv_len || (causal && col > row))) p = 0.f;
        s[4 * jj + e] = p * (dp[4 * jj + e] - di_r[e >> 1]);
      }
    }
  };
  // dS in the tile type: the accumulators of column groups 2 kk and 2 kk +
  // 1 are exactly the register A fragment of k-step kk.
  auto pack_ds = [&] {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sa[kk][i] = Tile<Tt>::pack(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }
  };
  // dQ(t) and its K stage are done.
  auto finish_dq = [&](int t) {
    wgmma_wait<0>();
    hold(dq_acc);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hold(sa[kk]);
    release(empty_k, t);
  };

  // dQ(t) runs on the tensor cores while the gradients of tile t + 1 run
  // on the other units: S(t + 1) and dP(t + 1) are issued before dQ(t) and
  // waited for (wait_group 1) before it, and dS(t + 1) is rounded into the
  // A fragments once dQ(t) is done.  Every pass of the loop issues the
  // same two groups (the last tile's dQ is peeled off), so ptxas can
  // pipeline them.  The two consumers take turns to issue their products
  // (named barriers 1 and 2, 256 threads: one consumer waits, the other
  // arrives), so that one's gradients run while the other's products hold
  // the tensor cores; consumer 0 has the first turn.
  auto take_turn = [&] {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
  };
  auto pass_turn = [&] {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
  };
  if (n_tiles > 0) {
    if (c == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    take_turn();
    issue_sdp(0);
    pass_turn();
    wgmma_wait<0>();
    hold(s);
    hold(dp);
    release(empty_v, 0);
    grads(0);
    pack_ds();
  }
  for (int t = 0; t + 1 < n_tiles; ++t) {
    take_turn();
    issue_sdp(t + 1);
    issue_dq(t);
    pass_turn();
    wgmma_wait<1>();
    hold(s);
    hold(dp);
    release(empty_v, t + 1);
    grads(t + 1);
    finish_dq(t);
    pack_ds();
  }
  if (n_tiles > 0) {
    take_turn();
    issue_dq(n_tiles - 1);
    pass_turn();
    finish_dq(n_tiles - 1);
  }

  Tin* dqp = dq + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = jj * 8 + t4 * 2;
    if (row_a < sq) {
      store2(dqp + static_cast<size_t>(row_a) * D + col,
             dq_acc[4 * jj] * sm_scale, dq_acc[4 * jj + 1] * sm_scale);
    }
    if (row_b < sq) {
      store2(dqp + static_cast<size_t>(row_b) * D + col,
             dq_acc[4 * jj + 2] * sm_scale, dq_acc[4 * jj + 3] * sm_scale);
    }
  }
}

// Arguments shared by every launch.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  const float* di;
  void* dq;  // dQ (B3) or the fp32 dQ slices (B2)
  void* dk;
  void* dv;
  int batch, hq, hkv, sq, skv, kv_len;
  float qscale, sm_scale;
  int causal;
  cudaStream_t stream;
};

template <int D, bool FUSED>
cudaError_t launch_kv_fp32(const Args& a) {
  const size_t smem = (4 * kTile32 * (D + 1) + 2 * kTile32 * (kTile32 + 1) +
                       2 * kTile32) * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(bwd_kv_fp32<D, FUSED>,
                                  static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + kTile32 - 1) / kTile32, a.batch * a.hkv);
  bwd_kv_fp32<D, FUSED><<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.di,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      static_cast<float*>(a.dq), a.hq, a.hkv, a.sq, a.skv, a.kv_len, a.qscale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_fp32(const Args& a) {
  const size_t smem =
      (4 * kTile32 * (D + 1) + kTile32 * (kTile32 + 1)) * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(bwd_dq_fp32<D>, static_cast<int>(smem),
                                  smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kTile32 - 1) / kTile32, a.batch * a.hq);
  bwd_dq_fp32<D><<<grid, 256, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dq), a.hq, a.hkv, a.sq, a.skv,
      a.kv_len, a.qscale, a.sm_scale, a.causal);
  return cudaGetLastError();
}

// The workspace of the 16-bit tiles (B2, B3, B4): Q_s (and, where the
// inputs are not already in the tile type, dO, K and V) in the tile type,
// then the lse2 and D_i planes [batch * hq, sq_pad] fp32, sq_pad = sq
// rounded up to 128.  Each part starts on a 256-byte boundary.
struct BwdWorkspace {
  size_t qs, dos, ks, vs, lse2, di, total;
};

size_t align256(size_t x) { return (x + 255) & ~size_t{255}; }

int sq_padded(int sq) { return (sq + kKvRows - 1) / kKvRows * kKvRows; }

BwdWorkspace bwd_workspace(int batch, int hq, int hkv, int sq, int skv, int d,
                           bool cast_in) {
  const size_t q_bytes = 2 * static_cast<size_t>(batch) * hq * sq * d;
  const size_t kv_bytes = 2 * static_cast<size_t>(batch) * hkv * skv * d;
  const size_t stat_bytes = 4 * static_cast<size_t>(batch) * hq * sq_padded(sq);
  BwdWorkspace w{};
  size_t at = 0;
  w.qs = at;
  at = align256(at + q_bytes);
  w.dos = at;
  if (cast_in) at = align256(at + q_bytes);
  w.ks = at;
  if (cast_in) at = align256(at + kv_bytes);
  w.vs = at;
  if (cast_in) at = align256(at + kv_bytes);
  w.lse2 = at;
  at = align256(at + stat_bytes);
  w.di = at;
  w.total = align256(at + stat_bytes);
  return w;
}

// A 3-D map over a contiguous 16-bit [rows, seq, d] tensor: boxes of
// box_rows x 64 columns with the 128-byte swizzle; reads past seq give
// zeros.
int map_3d(CUtensorMap* map, const void* ptr, int tiles, int rows, int seq,
           int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tiles == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// What the wgmma kernels read: Q_s, dO, K and V in the tile type (the
// inputs themselves where they are in it already), and the padded lse2 and
// D_i planes, each as a tensor map or a pointer.
struct Planes {
  CUtensorMap q_map, do_map, k_map, v_map;
  const float* lse2;
  const float* di;
  int sq_pad;
};

// The prologue (D_i folded in from a.o for B2, a.di copied for B3 and B4),
// then the four maps: Q_s and dO in boxes of q_box rows, K and V in boxes
// of kv_box rows.
template <typename Tin, typename Tt, int D>
int prepare(const Args& a, int tiles, void* workspace, int q_box, int kv_box,
            Planes* p) {
  constexpr bool kCast = !std::is_same<Tin, Tt>::value;
  const BwdWorkspace w =
      bwd_workspace(a.batch, a.hq, a.hkv, a.sq, a.skv, D, kCast);
  auto* ws = static_cast<unsigned char*>(workspace);
  Tt* qs = reinterpret_cast<Tt*>(ws + w.qs);
  Tt* dos = kCast ? reinterpret_cast<Tt*>(ws + w.dos) : nullptr;
  Tt* ks = kCast ? reinterpret_cast<Tt*>(ws + w.ks) : nullptr;
  Tt* vs = kCast ? reinterpret_cast<Tt*>(ws + w.vs) : nullptr;
  float* lse2 = reinterpret_cast<float*>(ws + w.lse2);
  float* di = reinterpret_cast<float*>(ws + w.di);
  p->sq_pad = sq_padded(a.sq);
  p->lse2 = lse2;
  p->di = di;
  const int q_rows = a.batch * a.hq;
  const int kv_rows = kCast ? a.batch * a.hkv * a.skv : 0;
  const size_t rows = static_cast<size_t>(q_rows) * p->sq_pad + kv_rows;
  bwd_prologue<Tin, Tt, D><<<static_cast<unsigned>((rows * (D / 8) + 255) / 256),
                             256, 0, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.o),
      static_cast<const Tin*>(a.dout), a.lse, a.di,
      static_cast<const Tin*>(a.k), static_cast<const Tin*>(a.v), qs, dos, ks,
      vs, lse2, di, q_rows, a.sq, p->sq_pad, kv_rows, a.qscale);
  const cudaError_t cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return cerr;
  const int kv_heads = a.batch * a.hkv;
  int err = map_3d(&p->k_map, kCast ? ks : a.k, tiles, kv_heads, a.skv, D, kv_box);
  if (err == 0) err = map_3d(&p->v_map, kCast ? vs : a.v, tiles, kv_heads, a.skv, D, kv_box);
  if (err == 0) err = map_3d(&p->q_map, qs, tiles, q_rows, a.sq, D, q_box);
  if (err == 0) err = map_3d(&p->do_map, kCast ? dos : a.dout, tiles, q_rows, a.sq, D, q_box);
  return err;
}

// B2 (DQ) or B4: the prologue, then the KV-major kernel.
template <typename Tin, typename Tt, int D, bool DQ>
int launch_kv_wgmma(const Args& a, int tiles, void* workspace) {
  using L = BwdLayout<D, DQ>;
  Planes p;
  const int err = prepare<Tin, Tt, D>(a, tiles, workspace, L::BQ, kKvRows, &p);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t cerr =
      set_smem_once(bwd_fused_wgmma<Tin, Tt, D, DQ>, L::kSmem, smem_set);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((a.skv + kKvRows - 1) / kKvRows, a.batch * a.hkv);
  bwd_fused_wgmma<Tin, Tt, D, DQ><<<grid, kBwdThreads, L::kSmem, a.stream>>>(
      p.k_map, p.v_map, p.q_map, p.do_map, p.lse2, p.di,
      static_cast<Tin*>(a.dk), static_cast<Tin*>(a.dv),
      static_cast<float*>(a.dq), a.hq, a.hkv, a.sq, p.sq_pad, a.skv, a.kv_len,
      a.causal);
  return cudaGetLastError();
}

// B3: the prologue, then the Q-major kernel.
template <typename Tin, typename Tt, int D>
int launch_dq_wgmma(const Args& a, int tiles, void* workspace) {
  using L = DqLayout<D>;
  Planes p;
  const int err = prepare<Tin, Tt, D>(a, tiles, workspace, L::BQ, L::BN, &p);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t cerr =
      set_smem_once(bwd_dq_wgmma<Tin, Tt, D>, L::kSmem, smem_set);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((a.sq + L::BQ - 1) / L::BQ, a.batch * a.hq);
  bwd_dq_wgmma<Tin, Tt, D><<<grid, kBwdThreads, L::kSmem, a.stream>>>(
      p.q_map, p.do_map, p.k_map, p.v_map, p.lse2, p.di,
      static_cast<Tin*>(a.dq), a.hq, a.hkv, a.sq, p.sq_pad, a.kv_len,
      a.sm_scale, a.causal);
  return cudaGetLastError();
}

enum class BwdKernel { kFused, kDq, kDkv };  // B2, B3, B4

template <typename Tin, typename Tt, int D>
int launch_16bit(BwdKernel kernel, const Args& a, int tiles, void* workspace) {
  if (kernel == BwdKernel::kDq) return launch_dq_wgmma<Tin, Tt, D>(a, tiles, workspace);
  if (kernel == BwdKernel::kFused) {
    return launch_kv_wgmma<Tin, Tt, D, true>(a, tiles, workspace);
  }
  return launch_kv_wgmma<Tin, Tt, D, false>(a, tiles, workspace);
}

template <typename Tin, int D>
int launch_tiles(BwdKernel kernel, const Args& a, int tiles, void* workspace) {
  return tiles == 1
             ? launch_16bit<Tin, __nv_bfloat16, D>(kernel, a, tiles, workspace)
             : launch_16bit<Tin, __half, D>(kernel, a, tiles, workspace);
}

template <int D>
int launch_fp32(BwdKernel kernel, const Args& a) {
  if (kernel == BwdKernel::kDq) return launch_dq_fp32<D>(a);
  if (kernel == BwdKernel::kFused) return launch_kv_fp32<D, true>(a);
  return launch_kv_fp32<D, false>(a);
}

// The instantiations of every kernel.  in_bf16: q/k/v/o/dO and the
// gradients are bf16 (else fp32).  tiles: 0 fp32 on the FMA units (needs
// fp32 inputs), 1 bf16 or 2 fp16 on the tensor cores.
int dispatch(BwdKernel kernel, const Args& a, int head_dim, int in_bf16,
             int tiles, void* workspace) {
  if (tiles == 1 || tiles == 2) {
    if (in_bf16) {
      if (head_dim == 64) return launch_tiles<__nv_bfloat16, 64>(kernel, a, tiles, workspace);
      if (head_dim == 128) return launch_tiles<__nv_bfloat16, 128>(kernel, a, tiles, workspace);
    } else {
      if (head_dim == 64) return launch_tiles<float, 64>(kernel, a, tiles, workspace);
      if (head_dim == 128) return launch_tiles<float, 128>(kernel, a, tiles, workspace);
    }
  } else if (tiles == 0 && !in_bf16) {
    if (head_dim == 64) return launch_fp32<64>(kernel, a);
    if (head_dim == 128) return launch_fp32<128>(kernel, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Rows of the KV tile that owns one dQ slice in B2 for tile code `tiles`:
// dq_part has ceil(skv / tile) slices.
int cfa_fa2_backward_kv_tile(int tiles) {
  return tiles ? kKvRows : kTile32;
}

// Bytes of the workspace of B2, B3 and B4 for these shapes and types (0
// with fp32 tiles).
long long cfa_fa2_backward_workspace(int batch, int hq, int hkv, int sq,
                                     int skv, int head_dim, int in_bf16,
                                     int tiles) {
  if (tiles != 1 && tiles != 2) return 0;
  return static_cast<long long>(
      bwd_workspace(batch, hq, hkv, sq, skv, head_dim, !(in_bf16 && tiles == 1))
          .total);
}

// B2.  q, o, dout [batch, hq, sq, head_dim]; k, v, dk, dv [batch, hkv, skv,
// head_dim]; lse [batch, hq, sq] fp32 (natural log); dq_part [batch, hq,
// ceil(skv / kv_tile), sq, head_dim] fp32, of which the kernel writes the
// live slices (cfa_fa2_backward_dq_reduce reads exactly those).  All
// contiguous and 16-byte aligned.  qscale = sm_scale * log2(e).
// workspace: cfa_fa2_backward_workspace bytes, 256-byte aligned (unused
// with fp32 tiles).  Returns a cudaError_t, or an error of the tensor-map
// step.
int cfa_fa2_backward_fused(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dk, void* dv, void* dq_part, int batch,
                           int hq, int hkv, int sq, int skv, int head_dim,
                           int kv_len, float qscale, int causal, int in_bf16,
                           int tiles, void* workspace, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), nullptr,
               dq_part, dk, dv, batch, hq, hkv, sq, skv, kv_len, qscale, 0.f,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kFused, a, head_dim, in_bf16, tiles, workspace);
}

// B2's dQ from its slices: dq [batch, hq, sq, head_dim] (bf16 when
// out_bf16, else fp32) = sm_scale * the ordered sum of the live slices of
// dq_part (tile code `tiles`, as the fused launch).  Returns a cudaError_t.
int cfa_fa2_backward_dq_reduce(const void* dq_part, void* dq, int batch, int hq,
                               int sq, int skv, int head_dim, int kv_len,
                               int causal, float sm_scale, int out_bf16,
                               int tiles, void* stream) {
  const int tile = tiles ? kKvRows : kTile32;
  const int n_slices = (skv + tile - 1) / tile;
  const int n_live = std::min(n_slices, (kv_len + tile - 1) / tile);
  const dim3 grid(std::min((sq * head_dim / 4 + 255) / 256, 64), batch * hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(dq_part);
  if (out_bf16) {
    dq_reduce<__nv_bfloat16><<<grid, 256, 0, st>>>(
        src, static_cast<__nv_bfloat16*>(dq), sq, head_dim, n_slices, n_live,
        tile, causal, sm_scale);
  } else {
    dq_reduce<float><<<grid, 256, 0, st>>>(
        src, static_cast<float*>(dq), sq, head_dim, n_slices, n_live, tile,
        causal, sm_scale);
  }
  return cudaGetLastError();
}

// B4.  As B2 without o and dq_part, with di [batch, hq, sq] fp32 =
// rowsum(dO * O).
int cfa_fa2_backward_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dk, void* dv, int batch, int hq, int hkv,
                         int sq, int skv, int head_dim, int kv_len,
                         float qscale, int causal, int in_bf16, int tiles,
                         void* workspace, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), nullptr, dk, dv, batch, hq, hkv,
               sq, skv, kv_len, qscale, 0.f, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kDkv, a, head_dim, in_bf16, tiles, workspace);
}

// B3.  As B4, with dq like q, scaled by sm_scale.
int cfa_fa2_backward_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, int batch, int hq, int hkv, int sq, int skv,
                        int head_dim, int kv_len, float qscale, float sm_scale,
                        int causal, int in_bf16, int tiles, void* workspace,
                        void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, nullptr, batch, hq,
               hkv, sq, skv, kv_len, qscale, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kDq, a, head_dim, in_bf16, tiles, workspace);
}

const char* cfa_fa2_backward_error_string(int err) {
  if (err == kErrNoEncoder) {
    return "libcuda.so.1 has no cuTensorMapEncodeTiled";
  }
  if (err == kErrEncode) {
    return "cuTensorMapEncodeTiled refused a backward tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
