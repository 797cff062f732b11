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
// design keeps S, P and dS on chip and never adds floats across blocks:
//   * B2/B4: one thread block per (128-row KV tile, b*Hkv), eight warps of 16
//     KV rows each.  It walks the GQA group's query heads and, under causal,
//     only the Q tiles at or below the diagonal, computing S^T and dP^T with
//     KV rows as the mma M dimension so that P^T and dS^T feed the dV and dK
//     products straight from registers.  dK and dV accumulate in registers
//     over the whole walk (the GQA sum without atomics) and are stored once.
//   * B2 writes dS^T to shared memory and multiplies it by the K tile into
//     its own slice dq_part[b, h, kv_tile]; Q tiles above the diagonal get
//     zeros.  The wrapper sums the slices in a fixed order, so dQ is bitwise
//     deterministic and uses no atomicAdd.
//   * B3: one block per (64-row Q tile, b*Hq), four warps of 16 Q rows; the
//     KV loop stops at the diagonal tile, as the forward's does.
//   * bf16 and fp16 tiles run on mma.sync m16n8k16 with fp32 accumulation;
//     fp32 tiles run on the FMA units (no TF32), held to IEEE fp32.
// wgmma, TMA and a pipelined ring of Q tiles are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kKvRows = 128;  // KV rows per block of B2/B4 with bf16 tiles
constexpr int kDqRows = 64;   // Q rows per block of B3 with bf16 tiles
constexpr int kDqKv = 64;     // KV rows per loop iteration of B3
constexpr int kTile32 = 64;   // Q and KV tile of the fp32 kernels
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Fragment addresses for ldmatrix.x4 on a 16-bit shared tile with leading
// dimension ld (elements).  Fragment layouts are those of mma.m16n8k16:
// thread (g = lane / 4, t = lane % 4) holds accumulator elements (row g,
// cols 2t, 2t+1) and (row g + 8, cols 2t, 2t+1) of each 8-column n-tile.
//
// A operand, rows m0.. and k-cols k0.. of a row-major [m][k] tile.
__device__ __forceinline__ int a_off(int lane, int ld, int m0, int k0) {
  return (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
// A operand read from a tile stored transposed, [k][m] (with .trans).
__device__ __forceinline__ int a_off_t(int lane, int ld, int m0, int k0) {
  const int mat = lane >> 3;
  return (k0 + (mat >> 1) * 8 + (lane & 7)) * ld + m0 + (mat & 1) * 8;
}
// B operand of two n-tiles (n0.., n0+8..) from a tile stored [n][k].
__device__ __forceinline__ int b_off_nk(int lane, int ld, int n0, int k0) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// B operand of two n-tiles from a tile stored [k][n] (with .trans).
__device__ __forceinline__ int b_off_kn(int lane, int ld, int n0, int k0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// Copy rows [row0, row0 + ROWS) of a [nrows, D] matrix into a 16-bit shared
// tile of type Tt with leading dimension LD, multiplied by `scale` in fp32
// before the rounding.  Rows past nrows are zero.
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

// The fp32 twin of stage_tile (no rounding).
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

// Per-row statistics of one Q tile into shared memory: lse * log2(e), and
// D_i, which is either read (B3/B4) or folded in from O and dO in fp32 (B2,
// fold_di).  Rows past sq get 0 for both, so their P is finite and their
// dS, with zero dO, is 0.
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
// B2 (FUSED) and B4 with bf16 or fp16 tiles (Tt) on the tensor cores.  256 threads; warp
// w owns KV rows [16w, 16w + 16) of the block's 128-row KV tile.  Q tiles are
// BQ rows: 64 at D = 64, 32 at D = 128 (the S^T and dP^T accumulators shrink
// to make room for the wider dK and dV ones).
// ---------------------------------------------------------------------------
template <typename Tin, typename Tt, int D, bool FUSED>
__global__ void __launch_bounds__(256)
bwd_kv_mma(const Tin* __restrict__ q, const Tin* __restrict__ k,
           const Tin* __restrict__ v, const Tin* __restrict__ o,
           const Tin* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ di, Tin* __restrict__ dk,
           Tin* __restrict__ dv, float* __restrict__ dq_part, int hq, int hkv,
           int sq, int skv, int kv_len, float qscale, int causal) {
  constexpr int BQ = D == 128 ? 32 : 64;
  constexpr int LD = D + 8;    // 16-byte row padding: conflict-free ldmatrix
  constexpr int LDS = BQ + 8;  // dS^T tile [kv][q]
  constexpr int RG = BQ / 16;  // dQ partial: 16-row groups of the Q tile
  constexpr int NC = D * RG / 8;  // ... and columns per warp (8 warps)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tt* ks = reinterpret_cast<Tt*>(smem_raw);
  Tt* vs = ks + kKvRows * LD;
  Tt* qs = vs + kKvRows * LD;
  Tt* dos = qs + BQ * LD;
  Tt* dst = dos + BQ * LD;
  float* lse2_s = reinterpret_cast<float*>(dst + (FUSED ? kKvRows * LDS : 0));
  float* di_s = lse2_s + BQ;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Under causal the first KV tiles see the most Q tiles: they go first.
  const int kt = blockIdx.x;
  const int k0 = kt * kKvRows;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const size_t kv_off = static_cast<size_t>(bh) * skv * D;

  stage_tile<Tt, Tin, D, kKvRows, LD, 256>(ks, k + kv_off, k0, skv, 1.f);
  stage_tile<Tt, Tin, D, kKvRows, LD, 256>(vs, v + kv_off, k0, skv, 1.f);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }
  const int n_q_tiles = (sq + BQ - 1) / BQ;
  const int q_first = causal ? min(k0 / BQ, n_q_tiles) : 0;
  const int kv_a = k0 + warp * 16 + g;  // this thread's two KV rows
  const int kv_b = kv_a + 8;

  for (int gi = 0; gi < groups; ++gi) {
    const size_t bhq = static_cast<size_t>(b) * hq + hk * groups + gi;
    const Tin* qp = q + bhq * sq * D;
    const Tin* dop = dout + bhq * sq * D;
    const Tin* op = FUSED ? o + bhq * sq * D : nullptr;
    const float* lp = lse + bhq * sq;
    const float* dip = FUSED ? nullptr : di + bhq * sq;
    float* dqp = FUSED
        ? dq_part + (bhq * gridDim.x + kt) * static_cast<size_t>(sq) * D
        : nullptr;
    if (FUSED) {
      // Q tiles wholly above the diagonal own a slice too: zeros.
      const int dead = min(q_first * BQ, sq) * D / 4;
      for (int i = threadIdx.x; i < dead; i += 256) {
        reinterpret_cast<float4*>(dqp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int qt = q_first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's Q, dO, dS^T and stats are used
      stage_tile<Tt, Tin, D, BQ, LD, 256>(qs, qp, q0, sq, qscale);
      stage_tile<Tt, Tin, D, BQ, LD, 256>(dos, dop, q0, sq, 1.f);
      stage_stats<Tin, D, BQ, 256, FUSED>(lse2_s, di_s, lp, dip, op, dop, q0,
                                          sq);
      __syncthreads();

      // S^T = K Q_s^T and dP^T = V dO^T for this warp's 16 KV rows.
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, ks + a_off(lane, LD, warp * 16, kk * 16));
        ldmatrix_x4(va, vs + a_off(lane, LD, warp * 16, kk * 16));
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, qs + b_off_nk(lane, LD, np * 16, kk * 16));
          ldmatrix_x4(bd, dos + b_off_nk(lane, LD, np * 16, kk * 16));
          Tile<Tt>::mma(st[2 * np], ka, bq[0], bq[1]);
          Tile<Tt>::mma(st[2 * np + 1], ka, bq[2], bq[3]);
          Tile<Tt>::mma(dpt[2 * np], va, bd[0], bd[1]);
          Tile<Tt>::mma(dpt[2 * np + 1], va, bd[2], bd[3]);
        }
      }

      // P^T = exp2(S^T - lse2), exactly 0 where masked; dS^T in dpt.
      const bool need_mask =
          (k0 + kKvRows > kv_len) || (causal && k0 + kKvRows - 1 > q0);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? kv_a : kv_b;
          float p = exp2f(st[j][e] - lse2_s[c]);
          if (need_mask && (row >= kv_len || (causal && row > q0 + c))) p = 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - di_s[c]);
        }
      }

      // dV += P^T dO and dK += dS^T Q_s: the accumulators of n-tiles 2kk
      // and 2kk+1 are exactly the A fragment of k-step kk.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = Tile<Tt>::pack(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = Tile<Tt>::pack(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = Tile<Tt>::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = Tile<Tt>::pack(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        sa[0] = Tile<Tt>::pack(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = Tile<Tt>::pack(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = Tile<Tt>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = Tile<Tt>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, dos + b_off_kn(lane, LD, dp * 16, kk * 16));
          ldmatrix_x4_trans(bq, qs + b_off_kn(lane, LD, dp * 16, kk * 16));
          Tile<Tt>::mma(dv_acc[2 * dp], pa, bd[0], bd[1]);
          Tile<Tt>::mma(dv_acc[2 * dp + 1], pa, bd[2], bd[3]);
          Tile<Tt>::mma(dk_acc[2 * dp], sa, bq[0], bq[1]);
          Tile<Tt>::mma(dk_acc[2 * dp + 1], sa, bq[2], bq[3]);
        }
      }

      if (FUSED) {
        // dQ slice of this KV tile: dS K, with dS read back transposed
        // from shared memory.  Warp w computes rows 16 (w % RG) .. and
        // columns NC (w / RG) .. of the Q tile.
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int c = j * 8 + t4 * 2;
          *reinterpret_cast<uint32_t*>(dst + (warp * 16 + g) * LDS + c) =
              Tile<Tt>::pack(dpt[j][0], dpt[j][1]);
          *reinterpret_cast<uint32_t*>(dst + (warp * 16 + g + 8) * LDS + c) =
              Tile<Tt>::pack(dpt[j][2], dpt[j][3]);
        }
        __syncthreads();
        const int rg = warp % RG;
        const int c0 = (warp / RG) * NC;
        float dq[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < kKvRows / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, dst + a_off_t(lane, LDS, rg * 16, kk * 16));
#pragma unroll
          for (int np = 0; np < NC / 16; ++np) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, ks + b_off_kn(lane, LD, c0 + np * 16, kk * 16));
            Tile<Tt>::mma(dq[2 * np], a, bk[0], bk[1]);
            Tile<Tt>::mma(dq[2 * np + 1], a, bk[2], bk[3]);
          }
        }
        const int ra = q0 + rg * 16 + g;
        const int rb = ra + 8;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = c0 + j * 8 + t4 * 2;
          if (ra < sq) store2(dqp + static_cast<size_t>(ra) * D + col, dq[j][0], dq[j][1]);
          if (rb < sq) store2(dqp + static_cast<size_t>(rb) * D + col, dq[j][2], dq[j][3]);
        }
      }
    }
  }

  Tin* dkp = dk + kv_off;
  Tin* dvp = dv + kv_off;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (kv_a < skv) {
      store2(dkp + static_cast<size_t>(kv_a) * D + col, dk_acc[j][0] * kLn2,
             dk_acc[j][1] * kLn2);
      store2(dvp + static_cast<size_t>(kv_a) * D + col, dv_acc[j][0], dv_acc[j][1]);
    }
    if (kv_b < skv) {
      store2(dkp + static_cast<size_t>(kv_b) * D + col, dk_acc[j][2] * kLn2,
             dk_acc[j][3] * kLn2);
      store2(dvp + static_cast<size_t>(kv_b) * D + col, dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// B3 with bf16 or fp16 tiles (Tt) on the tensor cores.  128 threads; warp w owns Q rows
// [16w, 16w + 16) of the block's 64-row Q tile; the loop walks 64-row KV
// tiles up to the diagonal.
// ---------------------------------------------------------------------------
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(128)
bwd_dq_mma(const Tin* __restrict__ q, const Tin* __restrict__ k,
           const Tin* __restrict__ v, const Tin* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           Tin* __restrict__ dq, int hq, int hkv, int sq, int skv, int kv_len,
           float qscale, float sm_scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tt* qs = reinterpret_cast<Tt*>(smem_raw);
  Tt* dos = qs + kDqRows * LD;
  Tt* ks = dos + kDqRows * LD;
  Tt* vs = ks + kDqKv * LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Causal tiles near the end of the sequence carry the most KV tiles.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const Tin* qp = q + static_cast<size_t>(bh) * sq * D;
  const Tin* dop = dout + static_cast<size_t>(bh) * sq * D;
  const Tin* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const Tin* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;

  stage_tile<Tt, Tin, D, kDqRows, LD, 128>(qs, qp, q0, sq, qscale);
  stage_tile<Tt, Tin, D, kDqRows, LD, 128>(dos, dop, q0, sq, 1.f);
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? row_b : row_a;
    lse2[i] = row < sq ? lse[static_cast<size_t>(bh) * sq + row] * kLog2e : 0.f;
    dd[i] = row < sq ? di[static_cast<size_t>(bh) * sq + row] : 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kDqRows) : kv_len;
  const int n_tiles = (kv_end + kDqKv - 1) / kDqKv;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kDqKv;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_tile<Tt, Tin, D, kDqKv, LD, 128>(ks, kp, k0, skv, 1.f);
    stage_tile<Tt, Tin, D, kDqKv, LD, 128>(vs, vp, k0, skv, 1.f);
    __syncthreads();

    float s[kDqKv / 8][4], dp[kDqKv / 8][4];
#pragma unroll
    for (int j = 0; j < kDqKv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qs + a_off(lane, LD, warp * 16, kk * 16));
      ldmatrix_x4(da, dos + a_off(lane, LD, warp * 16, kk * 16));
#pragma unroll
      for (int np = 0; np < kDqKv / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, ks + b_off_nk(lane, LD, np * 16, kk * 16));
        ldmatrix_x4(bv, vs + b_off_nk(lane, LD, np * 16, kk * 16));
        Tile<Tt>::mma(s[2 * np], qa, bk[0], bk[1]);
        Tile<Tt>::mma(s[2 * np + 1], qa, bk[2], bk[3]);
        Tile<Tt>::mma(dp[2 * np], da, bv[0], bv[1]);
        Tile<Tt>::mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    const bool need_mask =
        (k0 + kDqKv > kv_len) || (causal && k0 + kDqKv - 1 > q0);
#pragma unroll
    for (int j = 0; j < kDqKv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float p = exp2f(s[j][e] - lse2[e >> 1]);
        if (need_mask && (col >= kv_len || (causal && col > row))) p = 0.f;
        s[j][e] = p * (dp[j][e] - dd[e >> 1]);  // dS
      }
    }

    // dQ += dS K, K read transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kDqKv / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = Tile<Tt>::pack(s[2 * kk][0], s[2 * kk][1]);
      sa[1] = Tile<Tt>::pack(s[2 * kk][2], s[2 * kk][3]);
      sa[2] = Tile<Tt>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      sa[3] = Tile<Tt>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, ks + b_off_kn(lane, LD, dp2 * 16, kk * 16));
        Tile<Tt>::mma(acc[2 * dp2], sa, bk[0], bk[1]);
        Tile<Tt>::mma(acc[2 * dp2 + 1], sa, bk[2], bk[3]);
      }
    }
  }

  Tin* dqp = dq + static_cast<size_t>(bh) * sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (row_a < sq) {
      store2(dqp + static_cast<size_t>(row_a) * D + col, acc[j][0] * sm_scale,
             acc[j][1] * sm_scale);
    }
    if (row_b < sq) {
      store2(dqp + static_cast<size_t>(row_b) * D + col, acc[j][2] * sm_scale,
             acc[j][3] * sm_scale);
    }
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

// Raises the kernel's dynamic shared-memory limit to `smem` once per device
// (devices 0-63; others on every call).  `done` is a function-local static of
// the caller, so one per instantiation.
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

template <typename Tin, typename Tt, int D, bool FUSED>
cudaError_t launch_kv_mma(const Args& a) {
  constexpr int BQ = D == 128 ? 32 : 64;
  const size_t smem =
      (2 * kKvRows + 2 * BQ) * (D + 8) * sizeof(Tt) +
      (FUSED ? kKvRows * (BQ + 8) * sizeof(Tt) : 0) +
      2 * BQ * sizeof(float);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(bwd_kv_mma<Tin, Tt, D, FUSED>,
                                  static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + kKvRows - 1) / kKvRows, a.batch * a.hkv);
  bwd_kv_mma<Tin, Tt, D, FUSED><<<grid, 256, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.o),
      static_cast<const Tin*>(a.dout), a.lse, a.di, static_cast<Tin*>(a.dk),
      static_cast<Tin*>(a.dv), static_cast<float*>(a.dq), a.hq, a.hkv, a.sq,
      a.skv, a.kv_len, a.qscale, a.causal);
  return cudaGetLastError();
}

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

template <typename Tin, typename Tt, int D>
cudaError_t launch_dq_mma(const Args& a) {
  const size_t smem = (2 * kDqRows + 2 * kDqKv) * (D + 8) * sizeof(Tt);
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(bwd_dq_mma<Tin, Tt, D>,
                                  static_cast<int>(smem), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kDqRows - 1) / kDqRows, a.batch * a.hq);
  bwd_dq_mma<Tin, Tt, D><<<grid, 128, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout), a.lse,
      a.di, static_cast<Tin*>(a.dq), a.hq, a.hkv, a.sq, a.skv, a.kv_len,
      a.qscale, a.sm_scale, a.causal);
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

// The tensor-core instantiations of one input type and head dim: tiles 1
// is bf16, 2 fp16.
template <typename Tin, int D, bool FUSED>
int launch_kv_mma_tiles(const Args& a, int tiles) {
  return tiles == 1 ? launch_kv_mma<Tin, __nv_bfloat16, D, FUSED>(a)
                    : launch_kv_mma<Tin, __half, D, FUSED>(a);
}

template <typename Tin, int D>
int launch_dq_mma_tiles(const Args& a, int tiles) {
  return tiles == 1 ? launch_dq_mma<Tin, __nv_bfloat16, D>(a)
                    : launch_dq_mma<Tin, __half, D>(a);
}

// in_bf16: q/k/v/o/dO and the gradients are bf16 (else fp32).  tiles: 0
// fp32 on the FMA units (needs fp32 inputs), 1 bf16 or 2 fp16 on the tensor
// cores.
template <bool FUSED>
int dispatch_kv(const Args& a, int head_dim, int in_bf16, int tiles) {
  if (tiles == 1 || tiles == 2) {
    if (in_bf16) {
      if (head_dim == 64) return launch_kv_mma_tiles<__nv_bfloat16, 64, FUSED>(a, tiles);
      if (head_dim == 128) return launch_kv_mma_tiles<__nv_bfloat16, 128, FUSED>(a, tiles);
    } else {
      if (head_dim == 64) return launch_kv_mma_tiles<float, 64, FUSED>(a, tiles);
      if (head_dim == 128) return launch_kv_mma_tiles<float, 128, FUSED>(a, tiles);
    }
  } else if (tiles == 0 && !in_bf16) {
    if (head_dim == 64) return launch_kv_fp32<64, FUSED>(a);
    if (head_dim == 128) return launch_kv_fp32<128, FUSED>(a);
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

// B2.  q, o, dout [batch, hq, sq, head_dim]; k, v, dk, dv [batch, hkv, skv,
// head_dim]; lse [batch, hq, sq] fp32 (natural log); dq_part [batch, hq,
// ceil(skv / kv_tile), sq, head_dim] fp32, every element written.  All
// contiguous.  qscale = sm_scale * log2(e).  Returns a cudaError_t.
int cfa_fa2_backward_fused(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dk, void* dv, void* dq_part, int batch,
                           int hq, int hkv, int sq, int skv, int head_dim,
                           int kv_len, float qscale, int causal, int in_bf16,
                           int tiles, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), nullptr,
               dq_part, dk, dv, batch, hq, hkv, sq, skv, kv_len, qscale, 0.f,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch_kv<true>(a, head_dim, in_bf16, tiles);
}

// B4.  As B2 without o and dq_part, with di [batch, hq, sq] fp32 =
// rowsum(dO * O).
int cfa_fa2_backward_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dk, void* dv, int batch, int hq, int hkv,
                         int sq, int skv, int head_dim, int kv_len,
                         float qscale, int causal, int in_bf16, int tiles,
                         void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), nullptr, dk, dv, batch, hq, hkv,
               sq, skv, kv_len, qscale, 0.f, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch_kv<false>(a, head_dim, in_bf16, tiles);
}

// B3.  dq like q, scaled by sm_scale.
int cfa_fa2_backward_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, int batch, int hq, int hkv, int sq, int skv,
                        int head_dim, int kv_len, float qscale, float sm_scale,
                        int causal, int in_bf16, int tiles, void* stream) {
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, nullptr, batch, hq,
               hkv, sq, skv, kv_len, qscale, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (tiles == 1 || tiles == 2) {
    if (in_bf16) {
      if (head_dim == 64) return launch_dq_mma_tiles<__nv_bfloat16, 64>(a, tiles);
      if (head_dim == 128) return launch_dq_mma_tiles<__nv_bfloat16, 128>(a, tiles);
    } else {
      if (head_dim == 64) return launch_dq_mma_tiles<float, 64>(a, tiles);
      if (head_dim == 128) return launch_dq_mma_tiles<float, 128>(a, tiles);
    }
  } else if (tiles == 0 && !in_bf16) {
    if (head_dim == 64) return launch_dq_fp32<64>(a);
    if (head_dim == 128) return launch_dq_fp32<128>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_fa2_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
