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
// (kv_len) apply inside each slot, and so do a sliding window (row - col <
// window; a recency band without causal masking) and attention sinks (col
// < sinks kept besides), as one more clause of the element mask: a slot's
// whole row is one tile, so there is no walk to shorten.  Slots never see
// each other's keys.  Segment ids (sequence packing) are one more clause:
// a block stages its rows' and the slot's keys' ids in shared memory once,
// and a row keeps only keys of its own id; each body is instantiated with
// and without ids.
//
// What bounds it on the H100: the bytes, and at these sizes mostly the fixed
// cost of a launch and the latency of one block's chain of loads, products
// and softmax.  A slot does 4 * s^2 * D FLOPs on 4 * s * D values, so at the
// reference suite's Edge shapes (B8 H16 S32/S100 D64) the work is a few
// microseconds of the card in total.  The TPU kernel packs several slots
// into one block-diagonal matmul to amortise its per-grid-step overhead; on
// the card a block is cheap, so the design keeps B8's own schedule (the
// whole row is one KV tile, so the softmax takes one pass: the max over all
// of the row's columns, then exp2, then the sum; no online rescaling) and
// makes each block's chain short:
//   * the grid is (slot, 64-row Q tile): the suite's Small-1 (one slot of
//     128 rows) runs two blocks, and a slot's Q tiles run side by side; under
//     causal masking the diagonal's heavier tile is scheduled first, and a
//     block stops at its diagonal;
//   * fp32 runs on the FMA units (no TF32, held to IEEE fp32) with the fp32
//     block of csrc/fma_block.cuh: 128 threads per Q tile, K and V (<= 128
//     rows) in two 64-row stages each by cp.async on mbarriers, Q scaled by
//     sm_scale * log2(e) once in fp32, S in two 8 x 4 register tiles with the
//     row max taken over both before any exp2, P written over the K stages
//     and P V summed key by key.  S sums over d in order and P V over keys
//     in order, per element, as the 16 x 16 scalar block it replaces did;
//   * bf16 and fp16 tiles run on mma.sync m16n8k16 with fp32 accumulation,
//     one warp per 16 rows of the Q tile, P going from the S accumulators
//     straight into A fragments (wgmma's 64-row warpgroup tiles buy little
//     with one KV tile of <= 128 rows).  Bf16 K and V in bf16 tiles arrive
//     by cp.async while Q is scaled and rounded; other inputs are loaded
//     eight chunks a thread at a time before any of them is converted.
// The TPU kernel's V-augmented rowsum (a v5e work-around) is left out: l
// sums the fp32 P.
//
// Head dims 32, 64, 128 and 256 (CFA_HEAD_DIMS: this library 64 and 128,
// csrc/fa2_forward_small_d32.cu and _d256.cu the others).  At D = 32 the
// fp32 body's tiles take fma_slot(32) = 64 floats a row, so that P's 64
// columns fit over a K stage; the mma body needs nothing new.  At D = 256:
//   * fp32: two K, two V and one Q tile of 64 x 256 floats would take 320
//     KB.  The block holds Q and the two K stages; once S(t) has read K(t),
//     V(t) is loaded over it (its own mbarrier), and P takes a 32 KB region
//     after Q: 224 KB, one block an SM.  Both S tiles are formed before any
//     exp2, so the one-pass softmax stays;
//   * mma: Q's fragments (64 registers), S (64) and O's accumulators (128)
//     would pass the 255 a thread has.  Q's fragments die with S, and O is
//     formed in two passes of 128 columns over the same P (s stays live),
//     each normalised and stored before the next; shared memory (64 + 2 x
//     128 rows of 264 bf16) is 165 KB, one block an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "fma_block.cuh"  // the fp32 body's block; includes hopper.cuh

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (D 32 and 256
// each in their own library, so that nvcc compiles the widths in parallel).
// The input types: fp32 and bf16 here, fp16 alone with CFA_FP16_INPUTS
// (csrc/fa2_forward_small_fp16in.cu, every head dim).
#ifndef CFA_HEAD_DIMS
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif

namespace {

constexpr int kMaxRows = 128;  // the largest padded sequence of a slot
constexpr int kQTile = 64;     // Q rows per block, both bodies
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr float kLn2 = 0.6931471805599453f;

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

// The first `rows` rows of a [*, D] matrix into a 16-bit shared tile of
// type Tt with leading dimension LD, each multiplied by `scale` in fp32
// before the rounding; rows at or past `n_valid` are zeros (P is 0 there,
// and 0 * NaN would poison the P V product).  A thread issues the loads of
// kBatch 8-element chunks before it converts any of them.
template <typename Tt, typename Tin, int D, int LD>
__device__ __forceinline__ void stage_tile(Tt* dst, const Tin* src, int rows,
                                           int n_valid, float scale) {
  constexpr int kChunks = D / 8;
  constexpr int kBatch = 8;
  const int n = rows * kChunks;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * blockDim.x) {
    float x[kBatch][8];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / kChunks;
      if (i < n && r < n_valid) {
        load8(src + static_cast<size_t>(r) * D + (i - r * kChunks) * 8, x[b]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[b][j] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * blockDim.x;
      if (i < n) {
        const int r = i / kChunks;
        uint4 packed;
        packed.x = Tile<Tt>::pack(x[b][0] * scale, x[b][1] * scale);
        packed.y = Tile<Tt>::pack(x[b][2] * scale, x[b][3] * scale);
        packed.z = Tile<Tt>::pack(x[b][4] * scale, x[b][5] * scale);
        packed.w = Tile<Tt>::pack(x[b][6] * scale, x[b][7] * scale);
        *reinterpret_cast<uint4*>(dst + r * LD + (i - r * kChunks) * 8) = packed;
      }
    }
  }
}

// The first `rows` rows of a 16-bit [*, D] matrix already in the tile type
// into a shared tile with leading dimension LD by cp.async (rows at or past
// `n_valid` arrive as zeros); the caller waits with cp_async_wait_all.
template <typename Tt, int D, int LD>
__device__ __forceinline__ void copy_tile(Tt* dst, const Tt* src, int rows,
                                          int n_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool in = r < n_valid;
    cp_async16(smem_addr(dst + r * LD + c),
               src + static_cast<size_t>(in ? r : 0) * D + c, in);
  }
}

// The ids of a block's rows (from row q0) and of its slot's keys, in
// shared memory; null without segment ids.
struct SegIds {
  const int* q;
  const int* kv;
  int q0;
};

// SEG: with segment ids (each body is instantiated with and without them,
// so that the slots without ids run the code they ran before).
template <bool SEG>
__device__ __forceinline__ bool masked(int row, int col, int kv_len,
                                       int causal, int window, int sinks,
                                       const SegIds& seg) {
  bool out = col >= kv_len || (causal && col > row) ||
             !in_window(row, col, window, sinks);
  if constexpr (SEG) out = out || seg.q[row - seg.q0] != seg.kv[col];
  return out;
}

// The segment ids of the block's Q tile (q_rows rows from q0) and of its
// slot's s_pad keys into `dst` ([kQTile | kMaxRows] ints), from q_seg and
// kv_seg ([batch, 128] each; the slot's batch element is slot / heads).
// Made visible by the caller's barrier.
__device__ __forceinline__ SegIds stage_ids(int* dst, const int* q_seg,
                                            const int* kv_seg, size_t slot,
                                            int heads, int q0, int s_pad) {
  if (q_seg == nullptr) return SegIds{nullptr, nullptr, 0};
  const size_t at = slot / heads * kMaxRows;
  for (int i = threadIdx.x; i < kQTile + s_pad; i += blockDim.x) {
    dst[i] = i < kQTile ? (q0 + i < kMaxRows ? q_seg[at + q0 + i] : 0)
                        : kv_seg[at + i - kQTile];
  }
  return SegIds{dst, dst + kQTile, q0};
}

// First row of this block's Q tile: under causal masking the tiles nearer
// the end see more keys, so they are scheduled first.
__device__ __forceinline__ int q_tile_start() {
  return (gridDim.y - 1 - blockIdx.y) * kQTile;
}

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt) on the tensor cores.  One warp per 16 rows of the
// Q tile (blockDim.x = 32 * min(64, rows16) / 16; a warp whose rows start
// at or past rows16 only stages).  Fragment layouts are those of
// mma.m16n8k16: thread (g = lane / 4, t = lane % 4) holds accumulator
// elements (row g, cols 2t, 2t+1) and (row g + 8, cols 2t, 2t+1) of each
// 8-column n-tile.  Shared memory: Q [q_rows][LD], K and V [rows16][LD].
// ---------------------------------------------------------------------------
template <typename Tin, typename Tt, int D, bool SEG>
__global__ void __launch_bounds__(128)
small_mma(const Tin* __restrict__ q, const Tin* __restrict__ k,
          const Tin* __restrict__ v, Tin* __restrict__ o,
          float* __restrict__ lse, const int* __restrict__ q_seg,
          const int* __restrict__ kv_seg, int heads, int s_pad, int kv_len,
          float qscale, int causal, int window, int sinks) {
  constexpr int LD = D + 8;  // 16-byte row padding: conflict-free ldmatrix
  constexpr int NT = kMaxRows / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows16 = (s_pad + 15) & ~15;
  const int q_rows = min(kQTile, rows16);
  Tt* qs = reinterpret_cast<Tt*>(smem_raw);
  Tt* ks = qs + q_rows * LD;
  Tt* vs = ks + rows16 * LD;
  int* ids = reinterpret_cast<int*>(vs + rows16 * LD);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const size_t slot = blockIdx.x;
  const int q0 = q_tile_start();
  const int row0 = q0 + warp * 16;
  const int row_a = row0 + g;
  const int row_b = row_a + 8;
  // K/V rows any warp of the block reads: to the tile's diagonal under
  // causal, to kv_len rounded up to 16.
  const int kv_rows = min(causal ? min(rows16, q0 + kQTile) : rows16,
                          (kv_len + 15) & ~15);
  // Columns this warp's rows can see.
  const int col_end = min(causal ? min(rows16, row0 + 16) : rows16,
                          (kv_len + 15) & ~15);

  const size_t off = slot * s_pad * D;
  if constexpr (std::is_same<Tin, Tt>::value) {
    copy_tile<Tt, D, LD>(ks, k + off, kv_rows, s_pad);
    copy_tile<Tt, D, LD>(vs, v + off, kv_rows, s_pad);
  } else {
    stage_tile<Tt, Tin, D, LD>(ks, k + off, kv_rows, s_pad, 1.f);
    stage_tile<Tt, Tin, D, LD>(vs, v + off, kv_rows, s_pad, 1.f);
  }
  stage_tile<Tt, Tin, D, LD>(qs, q + off + static_cast<size_t>(q0) * D, q_rows,
                             s_pad - q0, qscale);
  const SegIds seg = SEG ? stage_ids(ids, q_seg, kv_seg, slot, heads, q0, s_pad)
                        : SegIds{nullptr, nullptr, 0};
  if constexpr (std::is_same<Tin, Tt>::value) cp_async_wait_all();
  __syncthreads();
  if (row0 >= rows16) return;

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
        if (masked<SEG>(e < 2 ? row_a : row_b, col, kv_len, causal, window,
                        sinks, seg)) {
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
        const float p = masked<SEG>(e < 2 ? row_a : row_b, col, kv_len, causal,
                                    window, sinks, seg)
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
  // A fragment of k-step kk; V is read transposed by ldmatrix.  kOC
  // columns of O a pass (D = 256: two passes over the same P).
  constexpr int kOC = D > 128 ? 128 : D;
  const float inv_a = l[0] == 0.f ? 1.f : 1.f / l[0];
  const float inv_b = l[1] == 0.f ? 1.f : 1.f / l[1];
  Tin* op = o + off;
#pragma unroll 1
  for (int h = 0; h < D; h += kOC) {
    float acc[kOC / 8][4];
#pragma unroll
    for (int j = 0; j < kOC / 8; ++j) {
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
        for (int dp = 0; dp < kOC / 16; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + h +
                      dp * 16 + (lane >> 4) * 8);
          Tile<Tt>::mma(acc[2 * dp], pa, bf[0], bf[1]);
          Tile<Tt>::mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kOC / 8; ++j) {
      const int col = h + j * 8 + t4 * 2;
      if (row_a < s_pad) {
        store2(op + static_cast<size_t>(row_a) * D + col, acc[j][0] * inv_a,
               acc[j][1] * inv_a);
      }
      if (row_b < s_pad) {
        store2(op + static_cast<size_t>(row_b) * D + col, acc[j][2] * inv_b,
               acc[j][3] * inv_b);
      }
    }
  }
  if (t4 == 0) {
    float* lp = lse + slot * s_pad;
    if (row_a < s_pad) lp[row_a] = mx[0] * kLn2 + logf(l[0] == 0.f ? 1.f : l[0]);
    if (row_b < s_pad) lp[row_b] = mx[1] * kLn2 + logf(l[1] == 0.f ? 1.f : l[1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units: the fp32 block of csrc/fma_block.cuh over one
// 64-row Q tile, the whole row's (<= 128) keys at once.  Shared memory as
// FmaStages lays it out with two K and two V stages (80 KB at D = 32 and 64,
// two blocks an SM; 160 KB at D = 128, one).  At D = 256 (kVOverK) V(t)
// takes K(t)'s stage once S(t) has read it, and the two P tiles a region of
// their own after Q (224 KB).
// ---------------------------------------------------------------------------
template <int D>
struct SmallFmaLayout {
  static constexpr bool kVOverK = D > 128;
  static constexpr int kKStages = 2;
  static constexpr int kVStages = 2;
  static constexpr int kTile = kFmaTile * fma_slot(D);
  static constexpr int kV = kVOverK ? 0 : kKStages * kTile;
  static constexpr int kQ = kVOverK ? kKStages * kTile : kV + kVStages * kTile;
  static constexpr int kP = kQ + kTile;  // kVOverK: P(t) at kP + t * 64 * 64
  static constexpr int kFloats = kP + (kVOverK ? kKStages * kFmaTile * kFmaTile : 0);
  static constexpr int kSmem = kFloats * 4 + 8 * (kKStages + kVStages);
  // The segment ids after the mbarriers (SegIds).
  static constexpr int kIds = kSmem;
  static constexpr int kSmemIds = kIds + 4 * (kQTile + kMaxRows);
  static_assert(kKStages * kFmaTile >= kMaxRows, "K holds a whole slot");
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

template <int D, bool SEG>
__global__ void __launch_bounds__(kFmaThreads)
small_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, const int* __restrict__ q_seg,
           const int* __restrict__ kv_seg, int heads, int s_pad, int kv_len,
           float qscale, int causal, int window, int sinks) {
  using L = SmallFmaLayout<D>;
  constexpr int DO = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const FmaStages<L> st(smem);
  const FmaThread th = fma_thread();
  const size_t off = static_cast<size_t>(blockIdx.x) * s_pad * D;
  const int q0 = q_tile_start();
  // KV tiles the block's rows see: to its diagonal under causal, to kv_len.
  const int kv_end = causal ? min(kv_len, q0 + kFmaTile) : kv_len;
  const int n_kv = (kv_end + kFmaTile - 1) / kFmaTile;  // 1 or 2

  // P(t): over K(t), or (kVOverK) in its own region.
  auto p_tile = [&](int t) {
    return L::kVOverK ? smem + L::kP + t * kFmaTile * kFmaTile : st.k(t);
  };

  if (threadIdx.x == 0) st.init();
  __syncthreads();  // the stages' barriers are initialised
  // Both K tiles first: the softmax needs all of S before any of V.
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < n_kv) fma_load_k<D>(st, t, k + off, s_pad);
  }
  if constexpr (!L::kVOverK) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < n_kv) fma_load_v<D>(st, t, v + off, s_pad);
    }
  }
  // Q scaled by sm_scale * log2(e) once, in fp32, while K and V land.
  fma_load_q<D>(st.q(), q + off, q0, s_pad, qscale);
  const SegIds seg =
      SEG ? stage_ids(reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) +
                                             L::kIds),
                      q_seg, kv_seg, blockIdx.x, heads, q0, s_pad)
          : SegIds{nullptr, nullptr, 0};
  __syncthreads();  // Q (and the ids) are in place

  float s[2][8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < n_kv) {
      st.wait_k(t);
      fma_scores<D>(st.q(), st.k(t), th, s[t]);
      if constexpr (L::kVOverK) {
        __syncthreads();  // K(t) is read: V(t) takes its stage
        fma_load_v<D>(st, t, v + off, s_pad);
      }
    }
  }
  __syncthreads();  // K is read: P takes its stages

  // One-pass softmax over the row's columns in both tiles: max, exp2, sum.
  // Masked scores count as the mask value in the max and give P exactly 0;
  // l is summed over this thread's columns in order, then across the row.
  float l[8], mx[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + th.ty + 8 * r;
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < n_kv) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (masked<SEG>(row, kFmaTile * t + th.tx + 16 * j, kv_len, causal,
                          window, sinks, seg)) {
            s[t][r][j] = kMaskValue;
          }
          m = fmaxf(m, s[t][r][j]);
        }
      }
    }
    mx[r] = fma_row_max(m);
    float rs = 0.f;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < n_kv) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = masked<SEG>(row, kFmaTile * t + th.tx + 16 * j, kv_len,
                                      causal, window, sinks, seg)
                              ? 0.f
                              : exp2f(s[t][r][j] - mx[r]);
          rs += p;
          fma_store_p(p_tile(t), th, r, j, p);
        }
      }
    }
    l[r] = fma_row_sum(rs);
  }
  __syncthreads();  // P is in place

  float acc[8][DO];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[r][c] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < n_kv) {
      st.wait_v(t);
      fma_pv<D>(p_tile(t), st.v(t), th, acc);
    }
  }

  // O = acc / l (l == 0 guarded) and lse = m ln 2 + log l.
  float inv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  fma_store_o<D>(o + off, q0, s_pad, th, acc, inv);
  if (th.tx == 0) {
    float* lp = lse + static_cast<size_t>(blockIdx.x) * s_pad;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + th.ty + 8 * r;
      if (row < s_pad) lp[row] = mx[r] * kLn2 + logf(l[r] == 0.f ? 1.f : l[r]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* q_seg;
  const int* kv_seg;
  int n_slots, heads, s_pad, kv_len;
  float qscale;
  int causal, window, sinks;
  cudaStream_t stream;
};

// One block per (slot, 64-row Q tile).
dim3 grid_of(const Args& a) {
  return dim3(a.n_slots, (a.s_pad + kQTile - 1) / kQTile);
}

template <typename Tin, typename Tt, int D, bool SEG>
cudaError_t launch_mma_seg(const Args& a) {
  const int rows16 = (a.s_pad + 15) & ~15;
  const int q_rows = std::min(kQTile, rows16);
  // The tiles, then (SEG) the segment ids, kQTile + kMaxRows ints.
  constexpr size_t kIds = SEG ? 4 * (kQTile + kMaxRows) : 0;
  const size_t smem = (q_rows + 2 * rows16) * (D + 8) * sizeof(Tt) + kIds;
  static std::atomic<uint64_t> smem_set{0};
  // The limit is set for the largest slot (128 rows), so it holds for all.
  cudaError_t err = set_smem_once(
      small_mma<Tin, Tt, D, SEG>,
      static_cast<int>((kQTile + 2 * kMaxRows) * (D + 8) * sizeof(Tt) + kIds),
      smem_set);
  if (err != cudaSuccess) return err;
  small_mma<Tin, Tt, D, SEG><<<grid_of(a), 32 * (q_rows / 16), smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<Tin*>(a.o), a.lse, a.q_seg,
      a.kv_seg, a.heads, a.s_pad, a.kv_len, a.qscale, a.causal, a.window,
      a.sinks);
  return cudaGetLastError();
}

template <typename Tin, typename Tt, int D>
cudaError_t launch_mma(const Args& a) {
  return a.q_seg != nullptr ? launch_mma_seg<Tin, Tt, D, true>(a)
                            : launch_mma_seg<Tin, Tt, D, false>(a);
}

template <int D, bool SEG>
cudaError_t launch_fp32_seg(const Args& a) {
  using L = SmallFmaLayout<D>;
  constexpr int kSmem = SEG ? L::kSmemIds : L::kSmem;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(small_fp32<D, SEG>, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  small_fp32<D, SEG><<<grid_of(a), kFmaThreads, kSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.q_seg,
      a.kv_seg, a.heads, a.s_pad, a.kv_len, a.qscale, a.causal, a.window,
      a.sinks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Args& a) {
  return a.q_seg != nullptr ? launch_fp32_seg<D, true>(a)
                            : launch_fp32_seg<D, false>(a);
}

template <typename Tin, int D>
cudaError_t launch_mma_tiles(const Args& a, int tiles) {
  return tiles == 1 ? launch_mma<Tin, __nv_bfloat16, D>(a)
                    : launch_mma<Tin, __half, D>(a);
}

}  // namespace

extern "C" {

// q, k, v, o [n_slots, s_pad, head_dim] (every (batch, head) pair one slot,
// `heads` slots a batch element; head_dim one of this library's, as
// CFA_HEAD_DIMS); lse [n_slots, s_pad] fp32.  All contiguous and 16-byte
// aligned, s_pad <= 128.  q_seg and kv_seg [n_slots
// / heads, 128] int32 segment ids, or both null.  in_type: q/k/v/o are 0
// fp32, 1 bf16 or 2 fp16 (this library's input types).  tiles: 0 fp32 on
// the FMA units (needs fp32 inputs), 1 bf16 or 2 fp16 on the tensor cores.  qscale = sm_scale * log2(e).
// window and sinks as cfa_fa2_forward's (kNoWindow: no window).  Returns a
// cudaError_t.
int cfa_fa2_forward_small(const void* q, const void* k, const void* v,
                          void* o, void* lse, const void* q_seg,
                          const void* kv_seg, int n_slots, int heads,
                          int s_pad, int head_dim, int kv_len, float qscale,
                          int causal, int window, int sinks, int in_type,
                          int tiles, void* stream) {
  if (s_pad < 1 || s_pad > kMaxRows || n_slots < 1 || heads < 1 ||
      (q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, static_cast<float*>(lse),
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
               n_slots, heads, s_pad, kv_len, qscale, causal, window, sinks,
               static_cast<cudaStream_t>(stream)};
  // This library's head dims (CFA_HEAD_DIMS).
#ifdef CFA_FP16_INPUTS
#define CFA_CASE(D)                                                          \
  if (head_dim == D && in_type == 2 && (tiles == 1 || tiles == 2)) {         \
    return launch_mma_tiles<__half, D>(a, tiles);                            \
  }
#else
#define CFA_CASE(D)                                                          \
  if (head_dim == D) {                                                       \
    if (tiles == 1 || tiles == 2) {                                          \
      if (in_type == 1) return launch_mma_tiles<__nv_bfloat16, D>(a, tiles); \
      if (in_type == 0) return launch_mma_tiles<float, D>(a, tiles);         \
    }                                                                        \
    if (tiles == 0 && in_type == 0) return launch_fp32<D>(a);                \
  }
#endif
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_fa2_forward_small_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
