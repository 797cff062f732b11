// The two baseline attention kernels of the reference suite on Hopper
// (sm_90a), plain C interface for ctypes.  Both are forward-only, fp32-only
// and non-causal, as the reference's; their schedules are what they measure,
// so they are kept, not tuned.  Each runs them on a block built for Hopper's
// FMA units (B9 its own; B10 the fp32 block of csrc/fma_block.cuh, shared
// with B1's fp32 body): the block changed, not the schedule.
//
// B9 FlashAttention-1 replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/baselines.py::_fa1_aligned
//   (body _fa1_kernel).
//   FA1's schedule, as the reference's f-attn.cu, is what B9 measures and
//   stays: one thread block per (batch, head); the loop over 64-row KV
//   tiles is OUTER and the loop over 64-row Q tiles INNER; the running
//   output O and the row statistics m and l live in device memory, so every
//   (KV tile, Q tile) pair reads them, rescales O by l_prev * alpha /
//   l_new, adds P V / l_new, and writes all three back.
//
// B10 naive FlashAttention-2 replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/baselines.py::_naive_fa2_aligned
//   (body _naive_fa2_kernel).
//   The FA2 schedule without its tuning, what B10 measures and keeps: each
//   64-row Q tile carries its running m, l and output in registers across
//   a KV loop over fixed 64-row tiles, and renormalises the output eagerly
//   at every tile (acc * l_prev * alpha / l_new + P V / l_new) instead of
//   dividing once at the end; natural exp; no causal skip.  The source
//   once said "no cp.async pipelining": that described its first block,
//   not the schedule, and went with that block.
//
// What bounds them on the H100: fp32 FLOPs on the FMA units (4 * S^2 * D per
// head, 67 TFLOP/s: 2.05 ms at the suite's Stress-1, B8 H16 S2048 D64), and
// for FA1 also its own schedule's traffic: O, m and l cross device memory
// once per (KV tile, Q tile) pair, S / 32 times the output's size at S =
// 2048 (about 4.3 GB at Stress-1, 1.3 ms at 3.35 TB/s if nothing overlaps
// it).  Both keep S and P in shared memory and registers; scores are
// natural-log (exp, not exp2), scaled by sm_scale after the product, as in
// the TPU kernels.  KV tiles wholly past kv_len are not visited.
//
// B10's block is csrc/fma_block.cuh's (its note says why): 128 threads a
// block for one 64-row Q tile, 8 x 4 register tiles read with 128-bit loads from
// swizzled rows, K and V by cp.async into two K stages and one V stage (at
// D = 128 one of each), P over the K stage just read, three blocks an SM
// at D = 32 and 64 and two at D = 128.  At D = 256 a thread's 128
// accumulators leave no room for a second 8 x 16 tile of P V beside them:
// P V is formed a 64-column quarter at a time, each quarter folded into the
// accumulators (acc * scale_old + pv * scale_pv) before the next, so every
// element's arithmetic stays the reference's; one block an SM.
//
// B9's block is built for its two bounds:
//   * 512 threads in four groups of 128, group g taking Q tiles g, g + 4,
//     ... of each KV tile.  The Q tiles of one KV tile are independent, so
//     four pairs are in flight at once and a group that waits for device
//     memory (its O, m and l, its next Q tile) leaves the FMA units to the
//     other three; each group synchronises on its own named barrier, the
//     block only once per KV tile;
//   * K, V and Q arrive by cp.async into mbarriers: the next KV tile's K
//     and V and each group's next Q tile land while the current pairs
//     compute (at D = 64; at D = 128 shared memory holds one stage of each);
//   * 8 x 4 register tiles of S and 8 x 4 (8 x 8 at D = 128) of P V, read
//     with 128-bit shared loads from rows padded to D + 4 (conflict-free):
//     in S 10.7 FMAs per load instruction, 2.7 per loaded float, against 2
//     and 2 in the 4 x 4 scalar tile of B9 and B10 before; P V the
//     same at D = 64, and 6.4 FMAs per load at D = 128, where P is read one
//     value at a time to leave registers for the 64 accumulators;
//   * O goes back a float4 at a time (a warp writes whole 256-byte rows),
//     m and l once per row and pair.
// At D = 32 a thread holds two O columns (2 tx, 2 tx + 1, as
// csrc/fma_block.cuh at D = 32) and a Q buffer is sized for P's 68-float
// rows, not Q's 36; the layout is D = 64's.  At D = 256 one group of 128
// threads: a 64-row Q buffer of D + 4 floats a row is 66.5 KB, so four
// groups' beside one 132 KB K/V stage would take 400 KB of the SM's 227;
// one group keeps the schedule (every Q tile of a KV tile in turn, O, m
// and l through device memory) with one K/V stage and one Q buffer, and a
// thread's 8 x 16 P V tile in registers, one block (four warps) an SM.
// Each row's arithmetic is the reference's, in the same order: S summed
// over d, then scaled; the max, alpha, P and its sum; l_new; O updated from
// the two scales.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "fma_block.cuh"  // B10's block; includes hopper.cuh

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (csrc/
// baselines_d32.cu and baselines_d256.cu, each in its own library, so that
// nvcc compiles the widths in parallel).
#ifndef CFA_HEAD_DIMS
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif

namespace {

constexpr int kTile = 64;  // Q and KV rows per tile
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE

// ---------------------------------------------------------------------------
// B9.  One block of 512 threads per (batch, head): four groups of 128
// threads (warps 4g .. 4g + 3), group g taking Q tiles g, g + 4, g + 8, ...
// of every KV tile (at D = 256 one group of 128 threads taking them all).
// Within a group thread (ty, tx), ty = 2 * warp + lane /
// 16 and tx = lane % 16, owns S rows ty + 8 i (i < 8) and columns tx + 16 j
// (j < 4) of the 64 x 64 score tile, and O rows ty + 8 i, columns 64 h +
// 4 tx .. + 3 (h < D / 64; at D = 32 columns 2 tx and 2 tx + 1).  Shared
// memory, in floats: kKVBufs stages of K (rows padded to D + 4) and V, then
// kQBufs Q buffers per group (rows padded to D + 4; P [64][68] takes a
// buffer's place once S is formed), then each group's two output scales per
// row, then the mbarriers.
// ---------------------------------------------------------------------------
template <int D>
struct Fa1 {
  static constexpr int kGroups = D > 128 ? 1 : 4;
  static constexpr int kThreads = 128 * kGroups;
  // Two stages of K/V and two Q buffers per group at D = 32 and 64; at D =
  // 128 and 256 one of each fits in the 227 KB of shared memory.
  static constexpr int kKVBufs = D <= 64 ? 2 : 1;
  static constexpr int kQBufs = D <= 64 ? 2 : 1;
  static constexpr int LDK = D + 4;     // K and Q rows
  static constexpr int LDP = kTile + 4;  // P rows
  static constexpr int kKFloats = kTile * LDK;
  static constexpr int kKV = kKFloats + kTile * D;
  // A Q buffer holds P once S is formed: at D = 32 P's rows are the longer.
  static constexpr int kQFloats = kTile * (LDK > LDP ? LDK : LDP);
  static constexpr int kQ = kKVBufs * kKV;
  static constexpr int kScales = kQ + kGroups * kQBufs * kQFloats;
  static constexpr int kFloats = kScales + kGroups * 2 * kTile;
  static constexpr int kSmem = kFloats * 4 + 8 * (kKVBufs + kGroups * kQBufs);
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

template <int D>
__global__ void __launch_bounds__(Fa1<D>::kThreads, 1)
fa1_fp32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o,
         float* __restrict__ m, float* __restrict__ l, int sq, int skv,
         int kv_len, float sm_scale) {
  using L = Fa1<D>;
  constexpr int kGroups = L::kGroups;
  constexpr int kQBufs = L::kQBufs;
  constexpr int kKVBufs = L::kKVBufs;
  constexpr int LDK = L::LDK;
  constexpr int LDP = L::LDP;
  constexpr int DC = D / 64;  // float4 column groups of O per thread
  constexpr int kCols = D == 32 ? 2 : 4 * DC;  // O columns per thread
  // P values per shared load in P V: a float4 at D = 32 and 64; one at D =
  // 128 and 256, where the P V tile leaves no registers for more.
  constexpr int KP = D <= 64 ? 4 : 1;
  constexpr int kChunks = D / 4;     // 16-byte chunks per row
  extern __shared__ __align__(16) float smem[];
  const uint32_t kv_full = smem_addr(smem + L::kFloats);  // stage s at + 8 s
  const uint32_t q_full = kv_full + 8 * kKVBufs;  // group g, buffer b at + 8 (g kQBufs + b)

  const int group = threadIdx.x >> 7;
  const int gt = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int ty = ((gt >> 5) << 1) | (lane >> 4);
  const size_t bh = blockIdx.x;
  const float* qp = q + bh * sq * D;
  const float* kp = k + bh * skv * D;
  const float* vp = v + bh * skv * D;
  float* op = o + bh * sq * D;
  float* mp = m + bh * sq;
  float* lp = l + bh * sq;
  float* sc = smem + L::kScales + group * 2 * kTile;  // [scale_old, scale_pv][row]
  const int n_kv = (kv_len + kTile - 1) / kTile;
  const int n_q = (sq + kTile - 1) / kTile;
  const int n_mine = n_q > group ? (n_q - group + kGroups - 1) / kGroups : 0;
  const int n_pairs = n_kv * n_mine;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKVBufs; ++s) mbar_init(kv_full + 8 * s, L::kThreads);
    for (int s = 0; s < kGroups * kQBufs; ++s) mbar_init(q_full + 8 * s, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of KV tile t into stage t % kKVBufs, by every thread; rows
  // past skv are zeros.
  auto load_kv = [&](int t) {
    float* ks = smem + (t % kKVBufs) * L::kKV;
    float* vs = ks + L::kKFloats;
    const int k0 = t * kTile;
    for (int i = threadIdx.x; i < kTile * kChunks; i += L::kThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 4;
      const bool in = k0 + r < skv;
      const size_t at = static_cast<size_t>(in ? k0 + r : 0) * D + c;
      cp_async16(smem_addr(ks + r * LDK + c), kp + at, in);
      cp_async16(smem_addr(vs + r * D + c), vp + at, in);
    }
    cp_async_arrive(kv_full + 8 * (t % kKVBufs));
  };
  // The Q tile of this group's pair p into buffer p % kQBufs, by the
  // group; rows past sq are zeros.
  auto load_q = [&](int p) {
    const int q0 = (group + kGroups * (p % n_mine)) * kTile;
    const int buf = group * kQBufs + p % kQBufs;
    float* qs = smem + L::kQ + buf * L::kQFloats;
    for (int i = gt; i < kTile * kChunks; i += 128) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 4;
      const bool in = q0 + r < sq;
      cp_async16(smem_addr(qs + r * LDK + c),
                 qp + static_cast<size_t>(in ? q0 + r : 0) * D + c, in);
    }
    cp_async_arrive(q_full + 8 * buf);
  };
  auto group_sync = [&] {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
  };

  load_kv(0);
  for (int p = 0; p < kQBufs && p < n_pairs; ++p) load_q(p);
  int p = 0;
  for (int t = 0; t < n_kv; ++t) {  // KV tiles: the outer loop
    __syncthreads();  // every group is done with tile t - 1
    if (kKVBufs == 2) {
      if (t + 1 < n_kv) load_kv(t + 1);  // lands while tile t is worked on
    } else if (t > 0) {
      load_kv(t);
    }
    mbar_wait(kv_full + 8 * (t % kKVBufs), (t / kKVBufs) & 1);
    const float* ks = smem + (t % kKVBufs) * L::kKV;
    const float* vs = ks + L::kKFloats;
    const int k0 = t * kTile;
    for (int i = 0; i < n_mine; ++i, ++p) {  // Q tiles: the inner loop
      const int q0 = (group + kGroups * i) * kTile;
      const int buf = group * kQBufs + p % kQBufs;
      float* qs = smem + L::kQ + buf * L::kQFloats;
      mbar_wait(q_full + 8 * buf, (p / kQBufs) & 1);

      // S = Q K^T, summed over d in order.
      float s[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kv4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LDK + d);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 q4 = *reinterpret_cast<const float4*>(qs + (ty + 8 * r) * LDK + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[r][j] = fmaf(q4.x, kv4[j].x, s[r][j]);
            s[r][j] = fmaf(q4.y, kv4[j].y, s[r][j]);
            s[r][j] = fmaf(q4.z, kv4[j].z, s[r][j]);
            s[r][j] = fmaf(q4.w, kv4[j].w, s[r][j]);
          }
        }
      }
      // m and l of these rows come back from device memory.
      float m_prev[8], l_prev[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + ty + 8 * r;
        const bool live = t > 0 && row < sq;
        m_prev[r] = live ? mp[row] : -INFINITY;
        l_prev[r] = live ? lp[row] : 0.f;
      }
      group_sync();  // the group is done with Q: P takes its place

      // Per row: the running max and sum from (m_prev, l_prev), P =
      // exp(S - m_new), and the scales l_prev * alpha / l_new (old output)
      // and 1 / l_new (P V).
      float* ps = qs;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + ty + 8 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = k0 + tx + 16 * j < kv_len ? s[r][j] * sm_scale : kMaskValue;
          mx = fmaxf(mx, s[r][j]);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m_prev[r], mx);
        const float alpha = expf(m_prev[r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pj = expf(s[r][j] - m_new);
          rs += pj;
          ps[(ty + 8 * r) * LDP + tx + 16 * j] = pj;
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1) {
          rs += __shfl_xor_sync(0xffffffffu, rs, off);
        }
        const float l_new = alpha * l_prev[r] + rs;
        const float scale_pv = l_new == 0.f ? 1.f : 1.f / l_new;
        if (tx == 0) {
          sc[ty + 8 * r] = l_prev[r] * alpha * scale_pv;
          sc[kTile + ty + 8 * r] = scale_pv;
          if (row < sq) {
            mp[row] = m_new;
            lp[row] = l_new;
          }
        }
      }
      group_sync();  // P and the scales are in place

      // P V, summed over the tile's keys in order.
      float pv[8][kCols];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) pv[r][j] = 0.f;
      }
#pragma unroll 2
      for (int c = 0; c < kTile; c += KP) {
        float pk[8][KP];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float* src = ps + (ty + 8 * r) * LDP + c;
          if constexpr (KP == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            pk[r][0] = x.x; pk[r][1] = x.y; pk[r][2] = x.z; pk[r][3] = x.w;
          } else {
            pk[r][0] = *src;
          }
        }
#pragma unroll
        for (int e = 0; e < KP; ++e) {
          if constexpr (D == 32) {
            const float2 v2 = *reinterpret_cast<const float2*>(vs + (c + e) * D + 2 * tx);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              pv[r][0] = fmaf(pk[r][e], v2.x, pv[r][0]);
              pv[r][1] = fmaf(pk[r][e], v2.y, pv[r][1]);
            }
          } else {
            float4 v4[DC];
#pragma unroll
            for (int h = 0; h < DC; ++h) {
              v4[h] = *reinterpret_cast<const float4*>(vs + (c + e) * D + 64 * h + 4 * tx);
            }
#pragma unroll
            for (int r = 0; r < 8; ++r) {
#pragma unroll
              for (int h = 0; h < DC; ++h) {
                pv[r][4 * h] = fmaf(pk[r][e], v4[h].x, pv[r][4 * h]);
                pv[r][4 * h + 1] = fmaf(pk[r][e], v4[h].y, pv[r][4 * h + 1]);
                pv[r][4 * h + 2] = fmaf(pk[r][e], v4[h].z, pv[r][4 * h + 2]);
                pv[r][4 * h + 3] = fmaf(pk[r][e], v4[h].w, pv[r][4 * h + 3]);
              }
            }
          }
        }
      }
      group_sync();  // P is read: the buffer takes the next Q tile
      if (p + kQBufs < n_pairs) load_q(p + kQBufs);

      // O = scale_old * O_prev + scale_pv * P V, a float4 at a time.
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + ty + 8 * r;
        if (row >= sq) continue;
        const float scale_old = sc[ty + 8 * r];
        const float scale_pv = sc[kTile + ty + 8 * r];
        if constexpr (D == 32) {
          float2* at = reinterpret_cast<float2*>(op + static_cast<size_t>(row) * D + 2 * tx);
          const float2 o_prev = t > 0 ? *at : make_float2(0.f, 0.f);
          *at = make_float2(scale_old * o_prev.x + scale_pv * pv[r][0],
                            scale_old * o_prev.y + scale_pv * pv[r][1]);
        }
#pragma unroll
        for (int h = 0; h < DC; ++h) {
          float4* at = reinterpret_cast<float4*>(
              op + static_cast<size_t>(row) * D + 64 * h + 4 * tx);
          const float4 o_prev = t > 0 ? *at : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 o_new;
          o_new.x = scale_old * o_prev.x + scale_pv * pv[r][4 * h];
          o_new.y = scale_old * o_prev.y + scale_pv * pv[r][4 * h + 1];
          o_new.z = scale_old * o_prev.z + scale_pv * pv[r][4 * h + 2];
          o_new.w = scale_old * o_prev.w + scale_pv * pv[r][4 * h + 3];
          *at = o_new;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B10.  One block per (64-row Q tile, batch * head), carrying its running
// m, l and output in registers across the whole KV loop
// (csrc/fma_block.cuh has the block: thread layout, rings, loads and the
// two products).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kFmaThreads, FmaBlock<D>::kBlocksPerSm)
naive_fa2_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int sq,
               int skv, int kv_len, float sm_scale) {
  using L = FmaBlock<D>;
  constexpr int DO = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const FmaStages<L> st(smem);
  const FmaThread th = fma_thread();
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kp = k + bh * skv * D;
  const float* vp = v + bh * skv * D;
  float* qs = st.q();
  const int n_kv = (kv_len + kTile - 1) / kTile;

  if (threadIdx.x == 0) st.init();
  fma_load_q<D>(qs, q + bh * sq * D, q0, sq, 1.f);
  __syncthreads();
  for (int t = 0; t < L::kKStages && t < n_kv; ++t) fma_load_k<D>(st, t, kp, skv);
  for (int t = 0; t < L::kVStages && t < n_kv; ++t) fma_load_v<D>(st, t, vp, skv);

  float m_run[8], l_run[8], acc[8][DO];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kTile;
    st.wait_k(t);
    float s[8][4];
    fma_scores<D>(qs, st.k(t), th, s);
    float* ps = st.k(t);
    __syncthreads();  // K(t) is read: P takes its stage

    // Per row: S scaled after the product, the kv_len tail masked, the
    // running max and sum updated, P = exp(S - m_new), and the scales of
    // the old output (l_prev * alpha / l_new) and of P V (1 / l_new).
    float scale_old[8], scale_pv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = k0 + th.tx + 16 * j < kv_len ? s[r][j] * sm_scale : kMaskValue;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m_run[r], fma_row_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        rs += p;
        fma_store_p(ps, th, r, j, p);
      }
      const float l_new = alpha * l_run[r] + fma_row_sum(rs);
      scale_pv[r] = l_new == 0.f ? 1.f : __frcp_rn(l_new);  // = 1 / l_new
      scale_old[r] = l_run[r] * alpha * scale_pv[r];
      m_run[r] = m_new;
      l_run[r] = l_new;
    }
    __syncthreads();  // P is in place

    // P V of this tile, then the eager renormalisation.
    st.wait_v(t);
    if constexpr (D > 128) {
      // A 64-column quarter at a time, each folded into acc before the next.
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        float pv[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) pv[r][c] = 0.f;
        }
        fma_pv<D, false, 1>(ps, st.v(t), th, pv, h);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][4 * h + c] = acc[r][4 * h + c] * scale_old[r] + pv[r][c] * scale_pv[r];
          }
        }
      }
    } else {
      float pv[8][DO];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < DO; ++c) pv[r][c] = 0.f;
      }
      fma_pv<D>(ps, st.v(t), th, pv);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < DO; ++c) {
          acc[r][c] = acc[r][c] * scale_old[r] + pv[r][c] * scale_pv[r];
        }
      }
    }
    __syncthreads();  // K(t), V(t) and P are read: refill
    if (t + L::kKStages < n_kv) fma_load_k<D>(st, t + L::kKStages, kp, skv);
    if (t + L::kVStages < n_kv) fma_load_v<D>(st, t + L::kVStages, vp, skv);
  }
  const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  fma_store_o<D>(o + bh * sq * D, q0, sq, th, acc, one);
}

template <int D>
cudaError_t launch_fa1(const float* q, const float* k, const float* v,
                       float* o, float* m, float* l, int bh, int sq, int skv,
                       int kv_len, float sm_scale, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(fa1_fp32<D>, Fa1<D>::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  fa1_fp32<D><<<bh, Fa1<D>::kThreads, Fa1<D>::kSmem, stream>>>(
      q, k, v, o, m, l, sq, skv, kv_len, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_naive(const float* q, const float* k, const float* v,
                         float* o, int bh, int sq, int skv, int kv_len,
                         float sm_scale, cudaStream_t stream) {
  using L = FmaBlock<D>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(naive_fa2_fp32<D>, L::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  naive_fa2_fp32<D><<<grid, kFmaThreads, L::kSmem, stream>>>(
      q, k, v, o, sq, skv, kv_len, sm_scale);
  return cudaGetLastError();
}
}  // namespace

extern "C" {

// B9.  q, o [bh, sq, head_dim]; k, v [bh, skv, head_dim] (head_dim one of
// this library's, CFA_HEAD_DIMS); m, l [bh, sq] fp32 scratch (the running
// max and sum, written by the kernel).  All fp32 and contiguous.  Keys at
// or past kv_len are masked.  Returns a cudaError_t.
int cfa_fa1_forward(const void* q, const void* k, const void* v, void* o,
                    void* m, void* l, int bh, int sq, int skv, int head_dim,
                    int kv_len, float sm_scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // This library's head dims (CFA_HEAD_DIMS).
#define CFA_CASE(D)                                                          \
  if (head_dim == D) {                                                       \
    return launch_fa1<D>(qf, kf, vf, of, mf, lf, bh, sq, skv, kv_len,        \
                         sm_scale, st);                                      \
  }
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// B10.  As B9 without the m and l scratch.
int cfa_naive_fa2_forward(const void* q, const void* k, const void* v, void* o,
                          int bh, int sq, int skv, int head_dim, int kv_len,
                          float sm_scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFA_CASE(D)                                                          \
  if (head_dim == D) {                                                       \
    return launch_naive<D>(qf, kf, vf, of, bh, sq, skv, kv_len, sm_scale, st); \
  }
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_baselines_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
