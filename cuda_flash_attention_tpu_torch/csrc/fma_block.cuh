// The fp32 attention block on Hopper's FMA units, shared by B10 (naive
// FA2, csrc/baselines.cu), B1's fp32 body (csrc/fa2_forward.cu), B8's fp32
// body (csrc/fa2_forward_small.cu), the fp32 bodies of the FA2 backward
// (B2, B3 and B4, csrc/fa2_backward.cu, whose source note says how they use
// it) and, over K/V in their stored width (the ring of csrc/paged_kv.cuh),
// B7's fp32 body (csrc/fa2_forward_quant.cu) and B6's fp32 tile body
// (csrc/paged_chunk.cu).  It holds the pieces the kernels
// run; each keeps its own schedule and arithmetic around them.  All are
// bound by fp32 FLOPs on the FMA units (67 TFLOP/s); what keeps them from
// it is what an SM issues and waits for besides the FMAs: shared loads, the
// softmax, barriers.  The forward block is described here:
//
//   * A block of 128 threads (four warps) owns one 64-row Q tile for the
//     whole KV loop.  Thread (ty, tx), ty = 2 * warp + lane /
//     16 and tx = lane % 16, holds S rows ty + 8 r (r < 8) and columns tx +
//     16 j (j < 4) of the 64 x 64 score tile, an 8 x 4 register tile, and O
//     rows ty + 8 r, columns 64 h + 4 tx .. + 3 (h < D / 64), in registers
//     for the whole KV loop.  A row's 16 threads are the 16 lanes of one
//     half-warp, so a row reduction is four xor shuffles.
//   * K and V arrive by cp.async, every thread issuing its share, into two
//     rings of 64-row stages (kKStages, kVStages), each stage completing on
//     its own mbarrier.  The block synchronises at the end of each tile and
//     refills the stages tile t used with tiles t + kKStages and t +
//     kVStages: with two K stages and one V stage (D = 64), K(t + 1) lands
//     while tile t is computed and V(t + 1) while S(t + 1) and its softmax
//     are.
//   * P is written over the K stage that S(t) has just read, so a block
//     holds Q, two K stages and one V stage in 64 KB at D = 64, three blocks
//     (12 warps) an SM, and Q, one K and one V stage in 96 KB at D = 128,
//     two blocks an SM.  Blocks of two or more groups sharing the rings
//     (each group with a P tile of its own) ran slower on the H100 at every
//     shape measured: a block's groups meet at every barrier, so their
//     softmax phases coincide, and fewer warps fit an SM, whereas
//     independent blocks overlap one's softmax with another's FMAs.
//   * At D = 32 a row's 16 threads hold its 32 O columns two apiece
//     (columns 2 tx, 2 tx + 1; fma_pv and fma_store_o take both layouts), and at D = 256
//     a thread holds 128 accumulators, one block (four warps) an SM.
//   * Q, K and P are rows whose 16-byte chunk c is stored at chunk c ^
//     (row & 7): float4 reads of one chunk from 8 neighbouring rows hit 8
//     different bank quads, without padding.  V is read by rows (a
//     half-warp reads 256 contiguous bytes).
//   * S = Q K^T is summed over d in order and P V over the tile's keys in
//     order, per output element: the same sums, in the same order, as the
//     16 x 16 scalar block this replaces.  Per 4 columns of d, a thread
//     issues 4 float4 loads of K and 8 of Q for 128 FMAs (10.7 FMAs per
//     load instruction, against 2 in that block); P V at D = 64 8 of P and
//     4 of V for 128 FMAs, at D = 128 8 and 8 for 256.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int kFmaTile = 64;  // Q rows per block, KV rows per stage
constexpr int kFmaThreads = 128;

// Floats of a tile row's slot in shared memory: D, and at D = 32 the 64 of
// a P row, which is written over the K stage that S has read.
constexpr int fma_slot(int D) { return D < kFmaTile ? kFmaTile : D; }

// O columns a thread holds for DC 64-column blocks of D: four a block, and
// at D = 32 two.
constexpr int fma_cols(int D, int DC) { return D == 32 ? 2 : 4 * DC; }

// Shared memory of a block, in floats: the K ring (kKStages tiles), the V
// ring (kVStages tiles) and the Q tile; then one mbarrier per stage, K's
// first.  At D = 128 a second K stage would take the block to 128 KB, one
// block (four warps) an SM, which ran slower on the H100 than two blocks
// with one K stage each.  kBlocksPerSm blocks fit an SM's 228 KB (1 KB of
// it reserved per block), at most three (D = 32 would fit six, at 80
// registers a thread, which spill), and the kernels tell ptxas so
// (__launch_bounds__).
template <int D>
struct FmaBlock {
  static constexpr int kKStages = D <= 64 ? 2 : 1;
  static constexpr int kVStages = 1;
  static constexpr int kTile = kFmaTile * fma_slot(D);
  static constexpr int kV = kKStages * kTile;
  static constexpr int kQ = kV + kVStages * kTile;
  static constexpr int kFloats = kQ + kTile;
  static constexpr int kSmem = kFloats * 4 + 8 * (kKStages + kVStages);
  static constexpr int kBlocksPerSm =
      233472 / (kSmem + 1024) < 3 ? 233472 / (kSmem + 1024) : 3;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// The block's two rings: KV tile t sits in K stage t % kKStages and V stage
// t % kVStages; each stage's mbarrier completes once every thread's
// cp.asyncs of it landed.  P(t) is written over K(t)'s stage once S(t) has
// read it.
template <typename L>
struct FmaStages {
  float* smem;
  uint32_t bar;  // K stage s's mbarrier at bar + 8 s, V stage s's after K's

  __device__ __forceinline__ explicit FmaStages(float* base)
      : smem(base), bar(smem_addr(base + L::kFloats)) {}

  // Thread 0, before the block's first barrier.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < L::kKStages + L::kVStages; ++s) {
      mbar_init(bar + 8 * s, kFmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ __forceinline__ float* q() const { return smem + L::kQ; }
  __device__ __forceinline__ float* k(int t) const {
    return smem + (t % L::kKStages) * L::kTile;
  }
  __device__ __forceinline__ float* v(int t) const {
    return smem + L::kV + (t % L::kVStages) * L::kTile;
  }
  __device__ __forceinline__ uint32_t k_bar(int t) const {
    return bar + 8 * (t % L::kKStages);
  }
  __device__ __forceinline__ uint32_t v_bar(int t) const {
    return bar + 8 * (L::kKStages + t % L::kVStages);
  }
  __device__ __forceinline__ void wait_k(int t) const {
    mbar_wait(k_bar(t), (t / L::kKStages) & 1);
  }
  __device__ __forceinline__ void wait_v(int t) const {
    mbar_wait(v_bar(t), (t / L::kVStages) & 1);
  }
};

// Float offset of chunk c (4 floats) of row r in a swizzled [64, D] tile
// (D = 64 for P).
template <int D>
__device__ __forceinline__ int fma_swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 2);
}

struct FmaThread {
  int ty, tx;
};

__device__ __forceinline__ FmaThread fma_thread() {
  const int lane = threadIdx.x & 31;
  return {static_cast<int>(((threadIdx.x >> 5) << 1) | (lane >> 4)), lane & 15};
}

// Rows [t * 64, t * 64 + 64) of one head's [n, D] rows (rows at or past n
// arrive as zeros) into `dst` by cp.async, swizzled or by rows: this
// thread's share of the block's.
template <int D, bool kSwizzle>
__device__ __forceinline__ void fma_copy_tile(float* dst, const float* src,
                                              int t, int n) {
  constexpr int kChunks = D / 4;
  const int k0 = t * kFmaTile;
  for (int i = threadIdx.x; i < kFmaTile * kChunks; i += kFmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool in = k0 + r < n;
    cp_async16(smem_addr(dst + (kSwizzle ? fma_swz<D>(r, c) : r * D + 4 * c)),
               src + static_cast<size_t>(in ? k0 + r : 0) * D + 4 * c, in);
  }
}

// Four neighbouring values of an fp32, bf16 or fp16 row as fp32, and back.
__device__ __forceinline__ float4 fma_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 fma_load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 fma_load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// fma_copy_tile of a 16-bit (bf16 or fp16) [n, D] tile (B9's and B10's
// 16-bit inputs): cp.async copies
// bytes and cannot widen, so each thread loads four values at a time,
// widens them to fp32 (exact) and stores them where cp.async would have.
template <int D, bool kSwizzle, typename T16>
__device__ __forceinline__ void fma_copy_tile16(float* dst, const T16* src,
                                                int t, int n) {
  constexpr int kChunks = D / 4;
  const int k0 = t * kFmaTile;
  for (int i = threadIdx.x; i < kFmaTile * kChunks; i += kFmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const float4 x = k0 + r < n
                         ? fma_load4(src + static_cast<size_t>(k0 + r) * D + 4 * c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + (kSwizzle ? fma_swz<D>(r, c) : r * D + 4 * c)) = x;
  }
}

// fma_copy_tile of K or V (K swizzled, V by rows), then this thread's
// arrival on `bar`: once its cp.asyncs have landed (fp32), or at once after
// its stores (16-bit rows; the arrival releases them).  Every thread of the
// block calls it for every tile of the ring.
template <int D, bool kSwizzle, typename Tin>
__device__ __forceinline__ void fma_load_tile(float* dst, uint32_t bar,
                                              const Tin* src, int t, int n) {
  if constexpr (std::is_same<Tin, float>::value) {
    fma_copy_tile<D, kSwizzle>(dst, src, t, n);
    cp_async_arrive(bar);
  } else {
    fma_copy_tile16<D, kSwizzle>(dst, src, t, n);
    mbar_arrive(bar);
  }
}

template <int D, typename L, typename Tin>
__device__ __forceinline__ void fma_load_k(const FmaStages<L>& st, int t,
                                           const Tin* kp, int n) {
  fma_load_tile<D, true>(st.k(t), st.k_bar(t), kp, t, n);
}

template <int D, typename L, typename Tin>
__device__ __forceinline__ void fma_load_v(const FmaStages<L>& st, int t,
                                           const Tin* vp, int n) {
  fma_load_tile<D, false>(st.v(t), st.v_bar(t), vp, t, n);
}

__device__ __forceinline__ void fma_store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void fma_store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}

__device__ __forceinline__ void fma_store4(__half* p, float4 x) {
  const __half2 a = __floats2half2_rn(x.x, x.y);
  const __half2 b = __floats2half2_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}

// Rows [q0, q0 + 64) of one head's Q ([n, D] fp32 or bf16; rows at or past
// n are zeros), each element multiplied by `scale` once in fp32, into the
// block's swizzled Q tile (plain loads: the product is formed in registers
// on the way).
template <int D, typename Tin>
__device__ __forceinline__ void fma_load_q(float* qs, const Tin* qp, int q0,
                                           int n, float scale) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kFmaTile * kChunks; i += kFmaThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) {
      x = fma_load4(qp + static_cast<size_t>(q0 + r) * D + 4 * c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(qs + fma_swz<D>(r, c)) = x;
  }
}

// s[r][j] = sum over d, in order, of Q[ty + 8 r][d] K[tx + 16 j][d].  At D
// = 256, where a thread's 128 O accumulators stay live, one chunk at a time.
template <int D>
__device__ __forceinline__ void fma_scores(const float* qs, const float* ks,
                                           const FmaThread& th,
                                           float (&s)[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
  }
#pragma unroll(D > 128 ? 1 : 4)
  for (int c = 0; c < D / 4; ++c) {
    float4 k4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k4[j] = *reinterpret_cast<const float4*>(ks + fma_swz<D>(th.tx + 16 * j, c));
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 q4 =
          *reinterpret_cast<const float4*>(qs + fma_swz<D>(th.ty + 8 * r, c));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = fmaf(q4.x, k4[j].x, s[r][j]);
        s[r][j] = fmaf(q4.y, k4[j].y, s[r][j]);
        s[r][j] = fmaf(q4.z, k4[j].z, s[r][j]);
        s[r][j] = fmaf(q4.w, k4[j].w, s[r][j]);
      }
    }
  }
}

// Offset of P[ty + 8 r][tx + 16 j] in the block's P tile.
__device__ __forceinline__ int fma_p_at(const FmaThread& th, int r, int j) {
  const int col = th.tx + 16 * j;
  return fma_swz<kFmaTile>(th.ty + 8 * r, col >> 2) + (col & 3);
}

// P[ty + 8 r][tx + 16 j] into the block's P tile.
__device__ __forceinline__ void fma_store_p(float* ps, const FmaThread& th,
                                            int r, int j, float p) {
  ps[fma_p_at(th, r, j)] = p;
}

// P V at D = 32, where a thread holds O columns 2 tx and 2 tx + 1 of its
// rows: acc[r][e] += P[ty + 8 r][c] V[c][2 tx + e], key c by key in order.
// V by rows as stored, or swizzled (kSwizzledB) as fma_pv reads it; fma_pv
// calls it.
template <bool kSwizzledB>
__device__ __forceinline__ void fma_pv_d32(const float* ps, const float* vs,
                                           const FmaThread& th, float (&acc)[8][2]) {
#pragma unroll 2
  for (int c = 0; c < kFmaTile; c += 4) {
    float4 p4[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      p4[r] = *reinterpret_cast<const float4*>(ps + fma_swz<kFmaTile>(th.ty + 8 * r,
                                                                     c >> 2));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v2 = *reinterpret_cast<const float2*>(
          vs + (kSwizzledB ? fma_swz<32>(c + e, th.tx >> 1) + 2 * (th.tx & 1)
                           : (c + e) * 32 + 2 * th.tx));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = e == 0 ? p4[r].x : e == 1 ? p4[r].y : e == 2 ? p4[r].z
                                                                     : p4[r].w;
        acc[r][0] = fmaf(p, v2.x, acc[r][0]);
        acc[r][1] = fmaf(p, v2.y, acc[r][1]);
      }
    }
  }
}

// acc[r][4 h + e] += P[ty + 8 r][c] V[c][64 (h0 + h) + 4 tx + e], key c by
// key in order (one fmaf per key and element), for DC 64-column blocks of
// V from block h0.  V is read by rows, as stored (kSwizzledB false) or
// swizzled (true: chunk 16 (h0 + h) + tx of row c sits at chunk (16 (h0 +
// h) + tx) ^ (c & 7), so a half-warp's 16 chunks of one row still span 256
// distinct bytes).  The backward reads its Q_s, dO and K tiles so.  At
// D = 32, acc[r][e] += P[ty + 8 r][c] V[c][2 tx + e] (fma_pv_d32).
template <int D, bool kSwizzledB = false, int DC = D / 64>
__device__ __forceinline__ void fma_pv(const float* ps, const float* vs,
                                       const FmaThread& th,
                                       float (&acc)[8][fma_cols(D, DC)], int h0 = 0) {
  if constexpr (D == 32) {
    fma_pv_d32<kSwizzledB>(ps, vs, th, acc);
  } else {
#pragma unroll(DC > 2 ? 1 : 2)
    for (int c = 0; c < kFmaTile; c += 4) {
      float4 p4[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        p4[r] = *reinterpret_cast<const float4*>(ps + fma_swz<kFmaTile>(th.ty + 8 * r,
                                                                       c >> 2));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 v4[DC];
#pragma unroll
        for (int h = 0; h < DC; ++h) {
          const int chunk = 16 * (h0 + h) + th.tx;
          v4[h] = *reinterpret_cast<const float4*>(
              vs + (kSwizzledB ? fma_swz<D>(c + e, chunk) : (c + e) * D + 4 * chunk));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float p = e == 0 ? p4[r].x : e == 1 ? p4[r].y : e == 2 ? p4[r].z
                                                                       : p4[r].w;
#pragma unroll
          for (int h = 0; h < DC; ++h) {
            acc[r][4 * h] = fmaf(p, v4[h].x, acc[r][4 * h]);
            acc[r][4 * h + 1] = fmaf(p, v4[h].y, acc[r][4 * h + 1]);
            acc[r][4 * h + 2] = fmaf(p, v4[h].z, acc[r][4 * h + 2]);
            acc[r][4 * h + 3] = fmaf(p, v4[h].w, acc[r][4 * h + 3]);
          }
        }
      }
    }
  }
}

// Row max and sum over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float fma_row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float fma_row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// A thread's D / 16 O columns of one row (fp32, bf16 or fp16, `row` its first
// element) from a[] * scale, at any head dim: 64 h + 4 tx .. + 3, or at
// D = 32 columns 2 tx and 2 tx + 1.
template <int D, typename Tout>
__device__ __forceinline__ void fma_store_cols(Tout* row, const FmaThread& th,
                                               const float (&a)[D / 16], float scale) {
  if constexpr (D == 32) {
    store2(row + 2 * th.tx, a[0] * scale, a[1] * scale);
  } else {
#pragma unroll
    for (int h = 0; h < D / 64; ++h) {
      fma_store4(row + 64 * h + 4 * th.tx,
                 make_float4(a[4 * h] * scale, a[4 * h + 1] * scale,
                             a[4 * h + 2] * scale, a[4 * h + 3] * scale));
    }
  }
}

// O rows q0 + ty + 8 r (those before n) of one head ([n, D], fp32, bf16 or fp16)
// from acc * scale[r], four values at a time: DC 64-column blocks from
// block h0; at D = 32 a thread's two columns (fma_store_cols).
template <int D, int DC = D / 64, typename Tout>
__device__ __forceinline__ void fma_store_o(Tout* op, int q0, int n,
                                            const FmaThread& th,
                                            const float (&acc)[8][fma_cols(D, DC)],
                                            const float (&scale)[8], int h0 = 0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + th.ty + 8 * r;
    if (row >= n) continue;
    if constexpr (D == 32) {
      fma_store_cols<D>(op + static_cast<size_t>(row) * D, th, acc[r], scale[r]);
    } else {
#pragma unroll
      for (int h = 0; h < DC; ++h) {
        fma_store4(op + static_cast<size_t>(row) * D + 64 * (h0 + h) + 4 * th.tx,
                   make_float4(acc[r][4 * h] * scale[r], acc[r][4 * h + 1] * scale[r],
                               acc[r][4 * h + 2] * scale[r],
                               acc[r][4 * h + 3] * scale[r]));
      }
    }
  }
}

}  // namespace
