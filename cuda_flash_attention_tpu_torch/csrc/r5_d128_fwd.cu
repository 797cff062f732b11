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
//   v1  l = P @ ones: one extra wgmma (m64n8k16) of P's register A
//       fragments against a tile of bf16 ones in shared memory at every
//       k-step of P V, the tensor cores doing the sum;
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
// 0.020 ms at 3.35 TB/s).  A 128-row tile's whole row of 2048 fp32 scores
// fits neither registers nor shared memory, so the row maximum that the
// one-pass variants need first is a pass of its own over K: every variant
// computes Q K^T twice, a floor of 1.5x the one-pass products (0.104 ms
// here), and v4 twice per half.  The body is B1's Hopper machinery
// (csrc/fa2_forward.cu, helpers in csrc/hopper.cuh) under that two-pass
// schedule:
//   * one block per (128-row Q tile, b * H), 384 threads in three
//     warpgroups; warpgroup 0 is the producer (`setmaxnreg.dec`): one
//     thread streams 128-key K tiles with TMA (3-D maps over [B*H, S, 128],
//     128-byte swizzle; rows past S arrive as zeros) into a ring of
//     kKStages stages for pass 1, then K and V tiles into their two rings
//     for pass 2, in the order the consumers take them; each stage has a
//     "full" mbarrier armed with its byte count and an "empty" one that the
//     8 consumer warps arrive on once the wgmma that read it completed;
//   * warpgroups 1 and 2 are the consumers, 64 Q rows each
//     (`setmaxnreg.inc`); each stages its Q once, scaled in fp32, rounded
//     to bf16 and stored with the swizzle TMA gives K and V;
//   * pass 1: S = Q K^T by wgmma m64n128k16 (both operands in shared
//     memory) and the row maximum in registers; no exp, no V.  v4 keeps one
//     maximum per half;
//   * pass 2: S again, then the exp chain in place, P from the S
//     accumulators into register A fragments and O += P V by wgmma against
//     V in its ring; S(t + 1) is issued before P V(t), so the chain of tile
//     t + 1 runs while P V(t) is on the tensor cores, and the consumers take
//     turns to issue their products (named barriers), so that one's chain
//     overlaps the other's products.  Ordinary code never touches an
//     accumulator or an A fragment between a wgmma's issue and its wait
//     (ptxas would serialise every wgmma of the kernel: C7512-C7514).
// A partial last tile of a half (v4 at S = 128 mod 256) is masked: -inf in
// pass 1's maximum and P = 0 in pass 2.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kD = 128;
constexpr int kTileM = 128;     // Q rows of a block
constexpr int kConsumerM = 64;  // Q rows of a consumer warpgroup
constexpr int kTileN = 128;     // keys of a ring stage
constexpr int kBoxCols = 64;    // columns of a 128-byte swizzle box
constexpr int kThreads = 384;
constexpr int kKStages = 2;
constexpr int kVStages = 2;
// Registers per thread after setmaxnreg: 128 x 40 + 256 x 232 = 64512 of
// the SM's 65536 (one block per SM).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16

// Shared memory from a 1024-byte-aligned base: the two consumers' Q tiles,
// the K ring, the V ring, each consumer's 1 KB of bf16 ones (v1), then the
// mbarriers.  A tile of R rows is two boxes of R rows x 128 bytes, each
// 128-byte-swizzled (16-byte chunk c of row r at c ^ (r % 8)).
struct Layout {
  static constexpr int kQBox = kConsumerM * 128;
  static constexpr int kKVBox = kTileN * 128;
  static constexpr int kQBytes = kQBox * (kD / kBoxCols);
  static constexpr int kKVBytes = kKVBox * (kD / kBoxCols);
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kKStages * kKVBytes;
  static constexpr int kOnes = kV + kVStages * kKVBytes;
  static constexpr int kBars = kOnes + 2 * 1024;
  static constexpr int kSmem = kBars + 2 * 8 * (kKStages + kVStages) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d[64] (+)= A (64x16, shared, K-major) * B (16x128, shared, K-major).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" CFA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CFA_ACC64(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64] += A (64x16, registers) * B (16x128, shared, MN-major: transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" CFA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CFA_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[4] += A (64x16, registers) * B (16x8 of ones, shared): every column of
// d is the row sum of A's 16 values, so d accumulates P's row sums.
__device__ __forceinline__ void wgmma_ones(float (&d)[4], const uint32_t* a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A shared-memory descriptor without swizzle (layout type 0).  The ones
// tile is read through it: any 16 x 8 window of the 1 KB of ones is ones.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// A consumer's 64 Q rows [row0, row0 + 64) of a [rows, 128] bf16 matrix,
// scaled by `scale` in fp32 and rounded to bf16, into the swizzled Q tile.
__device__ __forceinline__ void stage_q(unsigned char* dst, const __nv_bfloat16* src,
                                        int row0, float scale, int tid) {
  constexpr int kChunks = kD / 8;
#pragma unroll
  for (int it = 0; it < kConsumerM * kChunks / 128; ++it) {
    const int i = tid + it * 128;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    float x[8];
    load8(src + static_cast<size_t>(row0 + r) * kD + c * 8, x);
    uint4 packed;
    packed.x = pack_bf16(x[0] * scale, x[1] * scale);
    packed.y = pack_bf16(x[2] * scale, x[3] * scale);
    packed.z = pack_bf16(x[4] * scale, x[5] * scale);
    packed.w = pack_bf16(x[6] * scale, x[7] * scale);
    const int box = c / 8;
    const int chunk = (c % 8) ^ (r % 8);
    *reinterpret_cast<uint4*>(dst + box * Layout::kQBox + r * 128 + chunk * 16) = packed;
  }
}

// Issue S = Q K^T (not waited for): 8 k-steps of 32 bytes, four to a
// 128-byte box, both operands K-major.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qs, uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(qs + (kk / 4) * Layout::kQBox + off, 16, 1024),
             sw128_desc(ks + (kk / 4) * Layout::kKVBox + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (not waited for), and for v1 the row sums of P against the
// ones: k-step kk reads V rows [16 kk, 16 kk + 16), two 8-row groups 1024
// bytes apart, MN-major; the 64-column boxes are kKVBox apart.
template <int VARIANT>
__device__ __forceinline__ void issue_pv(float (&acc)[64], float (&lc)[4],
                                         uint32_t (&pa)[kTileN / 16][4], uint32_t vs,
                                         uint32_t ones) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    wgmma_pv(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, Layout::kKVBox, 1024));
    if constexpr (VARIANT == 1) wgmma_ones(lc, pa[kk], plain_desc(ones));
  }
  wgmma_commit();
}

// P in bf16: the accumulators of column groups 2 kk and 2 kk + 1 are
// exactly the register A fragment of k-step kk.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kTileN / 16][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads, 1)
r5_fwd(const __grid_constant__ CUtensorMap k_map,
       const __grid_constant__ CUtensorMap v_map,
       const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
       float* __restrict__ lse, int s_len, float qscale) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_k = base + L::kBars;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * kKStages;
  const uint32_t empty_k = full_v + 8 * kVStages;
  const uint32_t empty_v = empty_k + 8 * kKStages;

  const int q0 = blockIdx.x * kTileM;
  const int bh = blockIdx.y;
  constexpr int kSegments = VARIANT == 4 ? 2 : 1;
  const int seg_len = s_len / kSegments;
  const int n_tiles = (seg_len + kTileN - 1) / kTileN;  // key tiles of a segment

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread keeps the rings full, in the consumers' order.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&v_map))
                   : "memory");
      // The t-th tile into a ring of `stages`; the first pass over a ring
      // finds every stage empty.
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                      uint32_t empty, int stages, int t, int key0) {
        const int st = t % stages;
        mbar_wait(empty + 8 * st, ((t / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kKVBytes);
#pragma unroll
        for (int box = 0; box < kD / kBoxCols; ++box) {
          tma_load_3d(ring + st * L::kKVBytes + box * L::kKVBox, map, full + 8 * st,
                      box * kBoxCols, key0, bh);
        }
      };
      int kt = 0, vt = 0;
      for (int seg = 0; seg < kSegments; ++seg) {
        const int lo = seg * seg_len;
        for (int j = 0; j < n_tiles; ++j) {  // pass 1
          load(&k_map, base + L::kK, full_k, empty_k, kKStages, kt++, lo + j * kTileN);
        }
        // Pass 2 takes K(j + 1) before V(j); so does the producer.
        load(&k_map, base + L::kK, full_k, empty_k, kKStages, kt++, lo);
        for (int j = 0; j < n_tiles; ++j) {
          if (j + 1 < n_tiles) {
            load(&k_map, base + L::kK, full_k, empty_k, kKStages, kt++,
                 lo + (j + 1) * kTileN);
          }
          load(&v_map, base + L::kV, full_v, empty_v, kVStages, vt++, lo + j * kTileN);
        }
      }
    }
  } else {
    // Consumer c: Q rows [q0 + 64 c, q0 + 64 c + 64).  Warp w of the
    // warpgroup holds rows 16 w + g and 16 w + g + 8 of every accumulator,
    // columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of each 8-column group j.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int qc0 = q0 + kConsumerM * c;
    stage_q(smem + c * L::kQBytes, q + static_cast<size_t>(bh) * s_len * kD, qc0, qscale,
            tid);
    const uint32_t ones = base + L::kOnes + 1024 * c;
    if constexpr (VARIANT == 1) {
      *reinterpret_cast<uint2*>(smem + L::kOnes + 1024 * c + 8 * tid) =
          make_uint2(0x3F803F80u, 0x3F803F80u);  // bf16 1.0 pairs
    }
    // The generic-proxy stores must be visible to wgmma (the async proxy)
    // and complete in all four warps before the first product.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    const uint32_t qs = base + c * L::kQBytes;

    float m_run[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};             // v0, v2-v4: this thread's share
    float lc[4] = {0.f, 0.f, 0.f, 0.f};  // v1: P @ ones, rows g and g + 8
    float acc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    float s[64];
    uint32_t pa[kTileN / 16][4];
    int kc = 0, vc = 0;  // K and V tiles taken so far
    // A K or V stage is free once this warp's product that read it has
    // completed.
    auto release = [&](uint32_t empty, int stages, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (t % stages));
    };
    auto scores = [&] {
      const int st = kc % kKStages;
      mbar_wait(full_k + 8 * st, (kc / kKStages) & 1);
      issue_qk(s, qs, base + L::kK + st * L::kKVBytes);
    };
    // Named barriers 3 and 4 (256 threads: one consumer waits, the other
    // arrives) hand the turn to issue products between the consumers;
    // consumer 0 has the first turn.
    auto take_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory"); };
    auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory"); };
    if (c == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    // Whether column (j, e) of this thread, at key k0 + ..., lies at or past
    // the segment's end `hi`.
    auto past = [&](int k0, int hi, int j, int e) {
      return k0 + j * 8 + t4 * 2 + (e & 1) >= hi;
    };
    // JAX's bf16 exp chain against the row maximum, in place, and the
    // variant's share of the row sum: bf16(s - m) and its bf16 product with
    // ln 2 two columns at a time (bf16x2; the product of two bf16 values is
    // exact in fp32, so the one rounding is the fp32 chain's), expf of each
    // in fp32, rounded to bf16.
    auto chain = [&](int k0, int hi) {
      const bool partial = hi - k0 < kTileN;
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e & 1) continue;  // columns e and e + 1 of a row, as a pair
          const float mr = m_run[e >> 1];
          const __nv_bfloat162 x2 = __floats2bfloat162_rn(s[4 * j + e] - mr,
                                                          s[4 * j + e + 1] - mr);
          const float2 y = __bfloat1622float2(__hmul2(x2, __float2bfloat162_rn(kLn2Bf16)));
          float2 p = __bfloat1622float2(__floats2bfloat162_rn(expf(y.x), expf(y.y)));
          if (partial && past(k0, hi, j, e)) p.x = 0.f;
          if (partial && past(k0, hi, j, e + 1)) p.y = 0.f;
          if constexpr (VARIANT == 0) {
            rs[e >> 1] += p.x;
            rs[e >> 1] += p.y;
          } else if constexpr (VARIANT != 1) {
            l[e >> 1] += p.x;
            l[e >> 1] += p.y;
          }
          s[4 * j + e] = p.x;
          s[4 * j + e + 1] = p.y;
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
    };
    auto finish_pv = [&] {
      wgmma_wait<0>();
      hold(acc);
      hold(lc);
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) hold(pa[kk]);
      release(empty_v, kVStages, vc);
      ++vc;
    };
    auto pv = [&] {
      const int st = vc % kVStages;
      mbar_wait(full_v + 8 * st, (vc / kVStages) & 1);
      issue_pv<VARIANT>(acc, lc, pa, base + L::kV + st * L::kKVBytes, ones);
    };

    for (int seg = 0; seg < kSegments; ++seg) {
      const int lo = seg * seg_len;
      const int hi = lo + seg_len;
      // Pass 1: the row maximum over the segment.
      float mx[2] = {-INFINITY, -INFINITY};
      for (int j = 0; j < n_tiles; ++j) {
        const int k0 = lo + j * kTileN;
        scores();
        wgmma_wait<0>();
        hold(s);
        release(empty_k, kKStages, kc);
        ++kc;
        const bool partial = hi - k0 < kTileN;
#pragma unroll
        for (int jj = 0; jj < kTileN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = partial && past(k0, hi, jj, e) ? -INFINITY : s[4 * jj + e];
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
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
          acc[4 * j + 2 * i] *= alpha;
          acc[4 * j + 2 * i + 1] *= alpha;
        }
      }

      // Pass 2: P, the row sum and P V.  Tile j's P V runs on the tensor
      // cores while tile j + 1's chain runs: S(j + 1) is issued before
      // P V(j) and waited for (wait_group 1) before it.
      take_turn();
      scores();
      pass_turn();
      wgmma_wait<0>();
      hold(s);
      release(empty_k, kKStages, kc);
      ++kc;
      chain(lo, hi);
      pack_p(pa, s);
      for (int j = 0; j + 1 < n_tiles; ++j) {
        take_turn();
        scores();
        pv();
        pass_turn();
        wgmma_wait<1>();
        hold(s);
        release(empty_k, kKStages, kc);
        ++kc;
        chain(lo + (j + 1) * kTileN, hi);
        finish_pv();
        pack_p(pa, s);
      }
      take_turn();
      pv();
      pass_turn();
      finish_pv();
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
    const int row_a = qc0 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_a + 8 * i;
      const float inv = row_l[i] == 0.f ? 1.f : 1.f / row_l[i];
      __nv_bfloat16* op = o + (static_cast<size_t>(bh) * s_len + row) * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        store2(op + j * 8 + t4 * 2, acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
      if (t4 == 0) {
        lse[static_cast<size_t>(bh) * s_len + row] =
            m_run[i] * kLn2 + logf(row_l[i] == 0.f ? 1.f : row_l[i]);
      }
    }
  }
}

// A 3-D map over a contiguous bf16 [bh, s_len, 128] K or V: boxes of 128
// rows x 64 columns with the 128-byte swizzle; reads past s_len give zeros.
int kv_map(CUtensorMap* map, const void* ptr, int bh, int s_len) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kD) * 2,
                                 static_cast<cuuint64_t>(s_len) * kD * 2};
  const cuuint32_t box[3] = {kBoxCols, kTileN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(ptr), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int VARIANT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
           int s_len, float qscale, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  int err = kv_map(&k_map, k, bh, s_len);
  if (err == 0) err = kv_map(&v_map, v, bh, s_len);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t cerr = set_smem_once(r5_fwd<VARIANT>, Layout::kSmem, smem_set);
  if (cerr != cudaSuccess) return cerr;
  r5_fwd<VARIANT><<<dim3(s_len / kTileM, bh), kThreads, Layout::kSmem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_len, qscale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o [bh, s_len, 128] bf16 (bh = batch * heads), lse [bh, s_len]
// fp32, contiguous; s_len a multiple of 128; qscale = sm_scale * log2(e);
// variant 0-4 as above.  Returns a cudaError_t, or an error of the
// tensor-map step (cfa_r5_d128_fwd_error_string names it).
int cfa_r5_d128_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int s_len, float qscale, int variant,
                    void* stream) {
  if (s_len % kTileM != 0 || s_len < kTileM || bh < 1 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<0>(q, k, v, o, lse, bh, s_len, qscale, st);
    case 1: return launch<1>(q, k, v, o, lse, bh, s_len, qscale, st);
    case 2: return launch<2>(q, k, v, o, lse, bh, s_len, qscale, st);
    case 3: return launch<3>(q, k, v, o, lse, bh, s_len, qscale, st);
    case 4: return launch<4>(q, k, v, o, lse, bh, s_len, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cfa_r5_d128_fwd_error_string(int err) {
  if (err == kErrNoEncoder) return "libcuda.so.1 has no cuTensorMapEncodeTiled";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused the K/V tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
