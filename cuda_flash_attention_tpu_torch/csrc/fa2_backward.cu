// FlashAttention-2 backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three Pallas TPU kernels of
//   cuda_flash_attention_tpu/kernels/fa2_backward.py:
//   B2 fa2_backward_fused_aligned  (dK, dV and per-KV-tile dQ partials, one
//                                   recompute, D_i folded in)
//   B3 fa2_backward_dq_aligned     (dQ on a Q-major grid)
//   B4 fa2_backward_dkv_aligned    (dK, dV on a KV-major grid)
// They compute what _compute_p_ds and the three kernel bodies compute, with
// causal masking, a ragged KV tail (kv_len), GQA (query head h reads KV
// head h / (Hq / Hkv)), a sliding window (row - col < window; without
// causal masking a recency band whose offset may be <= 0), attention sinks
// (col < sinks kept besides) and segment ids (a row keeps only the keys of
// its own id; seg_stride in csrc/hopper.cuh).
//
// Windows: a Q-major block (B3) walks csrc/hopper.cuh KvWalk, the sink
// tiles and then its first row's window to the diagonal, as B1 does; a
// KV-major block (B2, B4) walks QWalk, the transpose: the Q tiles from the
// diagonal to the last row whose window reaches the KV tile, every Q tile
// for a tile holding a sink.  Each kernel's TMA producer and its consumers
// step through one such sequence.  A tile that a row's window edge
// crosses, and with segment ids every tile, is masked element by element;
// a masked P is selected to exactly 0 before any product (a dead row's
// lse is -inf or the mask value, where exp2 gives inf and inf * 0 is NaN),
// so a row that keeps no key gets dQ = 0 and adds nothing to dK or dV.
// B2's reduce adds, for each row, the slices of the KV tiles its own
// window walks (a subset of the slices B2 wrote for it), in KV-tile
// order.  Blocks are handed out longest walk first: B3's Q tiles from the
// last and B2's and B4's KV tiles from the first, and the other way round
// for a band (a row of the band keeps every later key).  Segment ids of the streamed side come with its
// stage (by TMA beside the row statistics or the K tile) in the wgmma
// bodies and through the read-only cache in the fp32 bodies; each thread
// holds its own rows' ids.
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
//     heads and the Q tiles of QWalk (under causal from the diagonal, under
//     a window to the last row it reaches); a KV tile wholly past kv_len
//     walks nothing.  Warpgroups 1 and 2
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
//     Q tiles a KV tile reaches are written, and only those of the KV tiles
//     the row's own window walks are read (a subset): a skipped slice
//     holds zeros or nothing, so the ordered sum is exact and bitwise the
//     same from run to run, with no atomicAdd;
//   * B3, `bwd_dq_wgmma`: one block per (128-row Q tile, b*Hq), 384
//     threads, the Q tiles handed out longest causal row first.  The
//     producer loads the block's Q_s and dO tiles and their lse and D_i
//     rows once, then streams 128-row (D = 64) or 64-row (D = 128) K and V
//     tiles through rings of their own; the walk (KvWalk) stops at the
//     causal diagonal and at kv_len and, under a window, starts at the
//     first row's oldest key after the sink tiles.  Each consumer owns 64
//     Q rows: S = Q_s K^T and
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
//
// Head dims 32, 64, 128 and 256 (CFA_HEAD_DIMS: this library 64 and 128,
// csrc/fa2_backward_d32.cu and fa2_backward_d256.cu the others).  At D = 32
// a 16-bit row is 64 bytes: the tiles take the 64-byte swizzle (Rows<32>:
// the tensor maps and the descriptors), the design is D = 64's (128-row Q
// steps; B3 on 64-row KV stages), and dV, dK and dQ are m64n32k16
// products.  At D = 256 a consumer
// holding dK and dV for its 64 KV rows would need 256 registers for them
// alone, and 128-row K and V tiles beside two stages of Q_s and dO would
// not fit the SM's shared memory: B2 and B4 run `bwd_fused_wgmma_wide`,
// 64-row KV tiles and Q steps, whose two consumers split dK, dV and dQ by
// columns (128 each) and share P^T and dS^T through shared memory (its
// note); B3 streams 32-row K and V tiles (DqLayout), dQ in two n128
// halves.  B2's dQ slices are then 64 KV rows (cfa_fa2_backward_kv_tile).
// The fp32 bodies take D = 32 on the FMA block's two-column layout and at
// D = 256 run `bwd_kv_fp32_wide` (dK and dV in column halves, one block
// each) and `bwd_dq_fp32_wide`, which keep two 64 KB tiles resident and
// stream the others through one slot.
//
// With fp32 tiles all three run on the FMA units (IEEE fp32, no TF32;
// exp2f), bound there by fp32 FLOPs (67 TFLOP/s), on the block of
// csrc/fma_block.cuh that B1's fp32 body and B10 run: 128 threads, 64-row
// tiles, 8 x 4 register tiles of the score products, 16-byte chunks of each
// row stored at chunk c ^ (row & 7) and read as float4 (about 10 FMAs per
// shared load instruction), cp.async into mbarrier rings.
//   * the prologue forms Q_s (the fp32 product), lse2 and D_i once per call
//     (cp.async copies bytes and cannot scale); its fp32 mode folds D_i as
//     four fmaf chains of D / 4 products added pairwise;
//   * B2 and B4 run `bwd_kv_fp32` (B2 with FUSED): one block per (64-row KV
//     tile, b*Hkv), K and V loaded once, the walk's Q_s, dO, lse2 and D_i
//     streamed through a one-stage ring (two blocks an SM at D = 64), S^T
//     and dP^T in registers, P^T and dS^T through shared memory into dV and
//     dK, which stay in registers over the whole walk; B2 also stores dS
//     q-major and forms its dQ slice from it and the K tile, 64 columns at a
//     time, and writes only the live slices;
//   * B3 runs `bwd_dq_fp32`: one block per (64-row Q tile, b*Hq), Q_s, dO
//     and the row statistics loaded once, K and V streamed through rings of
//     their own, dS written over the V stage that dP has read, dQ in
//     registers, stored once.
// Every sum runs in one fixed order (S^T, dP^T and S over d; dK and dV
// over the walk: head, Q tile, row; dQ over KV tiles, then keys), so the
// outputs are bitwise the same from run to run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "fma_block.cuh"  // includes hopper.cuh

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (D 32 and 256
// each in their own library, csrc/fa2_backward_d32.cu and _d256.cu, so
// that nvcc compiles the widths in parallel), and -DCFA_HEAD_DIM=<D> one
// (bench/autotune.py's tile variants).  The input types: fp32 and bf16
// here, fp16 alone with CFA_FP16_INPUTS (csrc/fa2_backward_fp16in.cu, every
// head dim).
#ifndef CFA_HEAD_DIMS
#ifdef CFA_HEAD_DIM
#define CFA_HEAD_DIMS(X) X(CFA_HEAD_DIM)
#else
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif
#endif

// bench/autotune.py's variants time bf16 inputs alone: -DCFA_BF16_INPUTS_ONLY
// leaves the fp32-input instantiations out of such a library.
#ifdef CFA_BF16_INPUTS_ONLY
#define CFA_FP32_INPUTS(...)
#else
#define CFA_FP32_INPUTS(...) __VA_ARGS__
#endif

namespace {

// Tile constants that a library built at one head dim may replace
// (bench/autotune.py's candidates): CFA_BWD_Q_ROWS (BwdLayout::BQ) for B2
// and B4, CFA_DQ_KV_ROWS (DqLayout::BN) and CFA_DQ_STAGES
// (DqLayout::kStages) for B3.  -DCFA_BWD_DKV_ONLY leaves B2 out, so that a
// B4 variant is not refused for B2's larger layout (its dS^T buffers).
constexpr int kKvRows = 128;  // KV rows per block of B2/B4 with bf16 tiles
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// KV rows per block of B2 and B4 with 16-bit tiles (the rows of one of B2's
// dQ slices): 128, and 64 at D = 256 (WideLayout).
constexpr int fused_kv_rows(int d) { return d > 128 ? 64 : kKvRows; }

// The 16-bit rows of a tile as TMA writes them: D / kBoxCols boxes of
// kRowBytes-byte rows, 128 bytes with the 128-byte swizzle (16-byte chunk c
// of row r at c ^ (r % 8)), or at D = 32 one box of 64-byte rows with the
// 64-byte swizzle (chunk c of row r at c ^ ((r / 2) % 4)); no column is
// padded.  A K-major k-step reads 32 bytes of each row, kSteps to a box.
template <int D>
struct Rows {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kSteps = kRowBytes / 32;
  static constexpr int kAtom = 8 * kRowBytes;  // a swizzle atom's bytes
  // A wgmma descriptor of this swizzle: 8-row groups one atom apart.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return kRowBytes == 128 ? sw128_desc(addr, lbo, kAtom) : sw64_desc(addr, lbo, kAtom);
  }
  // K-major k-step kk of a tile whose boxes are `box` bytes apart.
  static __device__ __forceinline__ uint64_t kstep(uint32_t addr, int kk, int box) {
    return desc(addr + (kk / kSteps) * box + (kk % kSteps) * 32, 16);
  }
};

// wgmma forms of the 16-bit tiles, with fp32 accumulators of 16 (N = 32),
// 32 (N = 64) or 64 (N = 128) registers.  ss: A and B both from shared
// memory, K-major.  ss_tt: both from shared memory, MN-major (the transpose
// bits).  ss_nt: A K-major, B MN-major.  rs: A from registers, B from
// shared memory, MN-major.  The scale-d predicate is 0 to overwrite the
// accumulators, 1 to add to them.
#define CFA_R16                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CFA_ACC16(d) CFA_ACC8(d, 0), CFA_ACC8(d, 8)
#define CFA_BWD_SS_N32(TY, TA, TB)                                           \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "            \
      "{" CFA_R16 "}, %16, %17, p, 1, 1, " TA ", " TB ";\n}\n"               \
      : CFA_ACC16(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define CFA_BWD_SS_N64(TY, TA, TB)                                           \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{" CFA_R32 "}, %32, %33, p, 1, 1, " TA ", " TB ";\n}\n"               \
      : CFA_ACC32(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define CFA_BWD_SS_N128(TY, TA, TB)                                          \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{" CFA_R64 "}, %64, %65, p, 1, 1, " TA ", " TB ";\n}\n"               \
      : CFA_ACC64(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define CFA_BWD_RS_N32(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "            \
      "{" CFA_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC16(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
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
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t desc_a, \
                                            uint64_t desc_b, int scale_d) {  \
    CFA_BWD_SS_N32(TY, "0", "0");                                            \
  }                                                                          \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, \
                                            uint64_t desc_b, int scale_d) {  \
    CFA_BWD_SS_N64(TY, "0", "0");                                            \
  }                                                                          \
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, \
                                            uint64_t desc_b, int scale_d) {  \
    CFA_BWD_SS_N128(TY, "0", "0");                                           \
  }                                                                          \
  static __device__ __forceinline__ void ss_tt(float (&d)[16],               \
                                               uint64_t desc_a,              \
                                               uint64_t desc_b, int scale_d) { \
    CFA_BWD_SS_N32(TY, "1", "1");                                            \
  }                                                                          \
  static __device__ __forceinline__ void ss_tt(float (&d)[32],               \
                                               uint64_t desc_a,              \
                                               uint64_t desc_b, int scale_d) { \
    CFA_BWD_SS_N64(TY, "1", "1");                                            \
  }                                                                          \
  static __device__ __forceinline__ void ss_tt(float (&d)[64],               \
                                               uint64_t desc_a,              \
                                               uint64_t desc_b, int scale_d) { \
    CFA_BWD_SS_N128(TY, "1", "1");                                           \
  }                                                                          \
  static __device__ __forceinline__ void ss_nt(float (&d)[64],               \
                                               uint64_t desc_a,              \
                                               uint64_t desc_b, int scale_d) { \
    CFA_BWD_SS_N128(TY, "0", "1");                                           \
  }                                                                          \
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t* a, \
                                            uint64_t desc_b) {               \
    CFA_BWD_RS_N32(TY);                                                      \
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

// exp2 on the special-function unit; results below 2^-126 flush to zero
// (B1's, csrc/fa2_forward.cu).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The prologue of every tile type (B2, B3, B4).
// ---------------------------------------------------------------------------
// Eight values of a row, times `scale`: in a 16-bit tile type, packed, or
// in fp32.
template <typename Tt>
__device__ __forceinline__ void store8(Tt* p, const float* x, float scale) {
  uint4 packed;
  packed.x = Tile<Tt>::pack(x[0] * scale, x[1] * scale);
  packed.y = Tile<Tt>::pack(x[2] * scale, x[3] * scale);
  packed.z = Tile<Tt>::pack(x[4] * scale, x[5] * scale);
  packed.w = Tile<Tt>::pack(x[6] * scale, x[7] * scale);
  *reinterpret_cast<uint4*>(p) = packed;
}

__device__ __forceinline__ void store8(float* p, const float* x, float scale) {
  reinterpret_cast<float4*>(p)[0] =
      make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  reinterpret_cast<float4*>(p)[1] =
      make_float4(x[4] * scale, x[5] * scale, x[6] * scale, x[7] * scale);
}

// Lanes per row of the prologue: D / 8 with 16-bit tiles, 8 contiguous
// values a lane; 4 with fp32 tiles, D / 4 contiguous values a lane, so that
// D_i is four fmaf chains of D / 4 products added pairwise, ((a0 + a1) +
// (a2 + a3)).
template <typename Tt, int D>
struct PrologueLanes {
  static constexpr int kLanes = std::is_same<Tt, float>::value ? 4 : D / 8;
};

// PrologueLanes lanes per row.  Rows [0, q_rows * sq_pad) are query rows
// (b*Hq + h, r): Q_s = round_tile(Q * qscale) with the fp32 multiply first,
// dO in the tile type (where dos is given), lse2 = lse * log2(e) and D_i,
// both 0 for rows r >= sq (the padding up to sq_pad).  D_i is rowsum(dO *
// O) in fp32 where o is given (B2), else the caller's di [q_rows, sq]
// copied (B3, B4).  The rows after them are K and V rows, cast to the tile
// type (where ks is given).  Every conversion rounds to nearest even, where
// the plain version rounds; with fp32 tiles Q_s is the fp32 product and
// only it and the planes are formed.
template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(256)
bwd_prologue(const Tin* __restrict__ q, const Tin* __restrict__ o,
             const Tin* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ di_in, const Tin* __restrict__ k,
             const Tin* __restrict__ v, Tt* __restrict__ qs,
             Tt* __restrict__ dos, Tt* __restrict__ ks, Tt* __restrict__ vs,
             float* __restrict__ lse2, float* __restrict__ di, int q_rows,
             int sq, int sq_pad, int kv_rows, float qscale) {
  constexpr int kLanes = PrologueLanes<Tt, D>::kLanes;
  constexpr int kPer = D / kLanes;
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
#pragma unroll 1
      for (int c = 0; c < kPer; c += 8) {
        const size_t at = (bhq * sq + r) * D + kPer * sub + c;
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
    }
  } else if (ks != nullptr && row - n_q < static_cast<size_t>(kv_rows)) {
#pragma unroll 1
    for (int c = 0; c < kPer; c += 8) {
      const size_t at = (row - n_q) * D + kPer * sub + c;
      float x[8];
      load8(k + at, x);
      store8(ks + at, x, 1.f);
      load8(v + at, x);
      store8(vs + at, x, 1.f);
    }
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

// ---------------------------------------------------------------------------
// fp32 tiles on the FMA units: the block of csrc/fma_block.cuh (128
// threads, 64-row tiles, 8 x 4 register tiles, swizzled rows read as
// float4, cp.async into mbarrier rings), after the prologue.
// ---------------------------------------------------------------------------
// Rows [q0, q0 + 64) of the lse2 and D_i planes ([rows, sq_pad] fp32, the
// prologue's, zeros past sq) into `dst` ([lse2 | D_i][64]) by cp.async:
// threads 0-15 copy lse2's 16 chunks, 16-31 D_i's.
__device__ __forceinline__ void copy_stats(float* dst, const float* lse2,
                                           const float* di, size_t at) {
  if (threadIdx.x < 32) {
    const int c = threadIdx.x & 15;
    const bool is_di = threadIdx.x >= 16;
    cp_async16(smem_addr(dst + (is_di ? kFmaTile : 0) + 4 * c),
               (is_di ? di : lse2) + at + 4 * c, true);
  }
}

// Shared memory of the KV-major fp32 kernel (B2 with FUSED, B4), in
// floats: the block's K and V tiles, kStages stages of [Q_s | dO | lse2 |
// D_i], the P^T and dS^T tiles ([64 kv][64 q]), with FUSED a dS tile ([64
// q][64 kv]), then one mbarrier for K and V and one per stage.  Every tile
// is swizzled (fma_swz).  One stage keeps two blocks (eight warps) on an
// SM at D = 64; two stages (one block) ran 1.22-1.33x slower on the H100.
template <int D, bool FUSED>
struct KvFp32 {
  static constexpr int kStages = 1;
  static constexpr int kTile = kFmaTile * D;
  static constexpr int kSquare = kFmaTile * kFmaTile;
  static constexpr int kStage = 2 * kTile + 2 * kFmaTile;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kPt = kQ + kStages * kStage;
  static constexpr int kDst = kPt + kSquare;
  static constexpr int kDs = kDst + kSquare;
  static constexpr int kFloats = kDs + (FUSED ? kSquare : 0);
  static constexpr int kSmem = kFloats * 4 + 8 * (1 + kStages);
  static constexpr int kBlocksPerSm = 233472 / (kSmem + 1024);
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// B4's fp32 body, and with FUSED B2's: one block per (64-row KV tile, b *
// Hkv).  K and V arrive once; the walk's Q_s and dO tiles with their lse2
// and D_i rows stream through the stage ring.  The walk covers the GQA
// group's query heads (gi outer) and the Q tiles of QWalk (under causal
// from the diagonal, under a window to the last row it reaches); a KV tile
// wholly past kv_len walks nothing and stores zeros.  Thread (ty, tx) holds S^T and dP^T rows (KV rows) ty + 8 r and
// columns (Q rows) tx + 16 j, and dK and dV rows ty + 8 r, columns 64 h + 4
// tx .. + 3, in registers for the whole walk.  Each step: S^T = K Q_s^T
// and dP^T = V dO^T (summed over d in order), P^T and dS^T = P^T (dP^T -
// D_i) into their tiles (FUSED: dS also q-major), then dV += P^T dO and dK +=
// dS^T Q_s, key by key in walk order, with B read by rows from the
// swizzled stage; FUSED adds this KV tile's dQ slice, dS K summed over its
// KV rows in order, 64 columns at a time, stored into dq_part[b, h, kt].
template <int D, bool FUSED>
__global__ void __launch_bounds__(kFmaThreads, KvFp32<D, FUSED>::kBlocksPerSm)
bwd_kv_fp32(const float* __restrict__ qs_plane, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse2, const float* __restrict__ di,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ dq_part, const int* __restrict__ q_seg,
            const int* __restrict__ kv_seg, int hq, int hkv, int sq,
            int sq_pad, int skv, int kv_len, int causal, int window,
            int sinks) {
  using L = KvFp32<D, FUSED>;
  extern __shared__ __align__(16) float smem[];
  const FmaThread th = fma_thread();
  const bool band = !causal && window < kNoWindow;
  const int kt = band ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int k0 = kt * kFmaTile;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const size_t kv_off = static_cast<size_t>(bh) * skv * D;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* pt = smem + L::kPt;
  float* dst = smem + L::kDst;
  float* dss = smem + L::kDs;
  const uint32_t kv_bar = smem_addr(smem + L::kFloats);
  const uint32_t q_bar = kv_bar + 8;  // stage s's at q_bar + 8 s

  const int n_q = (sq + kFmaTile - 1) / kFmaTile;
  const QWalk walk(k0, kFmaTile, n_q, kFmaTile, causal, window, sinks, kv_len);
  const int per_head = walk.n;
  const int n_steps = groups * per_head;
  const bool seg = q_seg != nullptr;
  const int* q_ids = seg ? q_seg + static_cast<size_t>(b) * seg_stride(sq) : nullptr;
  const int* kv_ids = seg ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 1 + L::kStages; ++s) mbar_init(kv_bar + 8 * s, kFmaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Step n of the walk: query head gi, Q tile qt, in stage n % kStages.
  auto head_of = [&](int n) {
    return static_cast<size_t>(b) * hq + hk * groups + n / per_head;
  };
  auto tile_of = [&](int n) { return walk.at(n % per_head); };
  auto stage = [&](int n) { return smem + L::kQ + (n % L::kStages) * L::kStage; };
  auto load = [&](int n) {
    const size_t bhq = head_of(n);
    const int qt = tile_of(n);
    float* sp = stage(n);
    fma_copy_tile<D, true>(sp, qs_plane + bhq * sq * D, qt, sq);
    fma_copy_tile<D, true>(sp + L::kTile, dout + bhq * sq * D, qt, sq);
    copy_stats(sp + 2 * L::kTile, lse2, di, bhq * sq_pad + qt * kFmaTile);
    cp_async_arrive(q_bar + 8 * (n % L::kStages));
  };
  if (n_steps > 0) {
    fma_copy_tile<D, true>(ks, k + kv_off, kt, skv);
    fma_copy_tile<D, true>(vs, v + kv_off, kt, skv);
    cp_async_arrive(kv_bar);
  }
  for (int n = 0; n < L::kStages && n < n_steps; ++n) load(n);

  float dk_acc[8][D / 16], dv_acc[8][D / 16];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }
  if (n_steps > 0) mbar_wait(kv_bar, 0);
  for (int n = 0; n < n_steps; ++n) {
    const int q0 = tile_of(n) * kFmaTile;
    const float* qs = stage(n);
    const float* dos = qs + L::kTile;
    const float* lse2_s = dos + L::kTile;
    const float* di_s = lse2_s + kFmaTile;
    mbar_wait(q_bar + 8 * (n % L::kStages), (n / L::kStages) & 1);
    // S^T and dP^T.  At D = 64 both stay in registers; at D = 128, where
    // a second score tile beside dK and dV spilled, and at D = 32, where
    // B4 runs three blocks an SM (168 registers), dP^T is formed after P^T
    // has gone to its tile, and P^T is read back for dS^T.
    constexpr bool kHold = D == 64;
    float s[8][4], dp[8][4];
    fma_scores<D>(ks, qs, th, s);
    if (kHold) fma_scores<D>(vs, dos, th, dp);
    // Masked element by element: the kv_len tail, the diagonal, a tile
    // some row's window edge crosses, every tile with segment ids.
    // (One body for both: a second, unmasked one spilled at D = 128.)
    const bool need_mask =
        seg || (k0 + kFmaTile > kv_len) || (causal && k0 + kFmaTile - 1 > q0) ||
        (q0 + kFmaTile - 1 - k0 >= window && k0 + kFmaTile > sinks);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = k0 + th.ty + 8 * r;
      const int kid = seg ? __ldg(kv_ids + row) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = th.tx + 16 * j;
        float p = exp2f(s[r][j] - lse2_s[c]);
        if (need_mask && (row >= kv_len || (causal && row > q0 + c) ||
                          !in_window(q0 + c, row, window, sinks) ||
                          (seg && __ldg(q_ids + q0 + c) != kid))) {
          p = 0.f;
        }
        s[r][j] = p;
        fma_store_p(pt, th, r, j, p);
      }
    }
    if (!kHold) fma_scores<D>(vs, dos, th, dp);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = th.ty + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = th.tx + 16 * j;
        const float p = kHold ? s[r][j] : pt[fma_p_at(th, r, j)];
        const float ds = p * (dp[r][j] - di_s[c]);
        fma_store_p(dst, th, r, j, ds);
        if (FUSED) dss[fma_swz<kFmaTile>(c, row >> 2) + (row & 3)] = ds;
      }
    }
    __syncthreads();  // P^T, dS^T (and dS) are in place
    fma_pv<D, true>(pt, dos, th, dv_acc);
    fma_pv<D, true>(dst, qs, th, dk_acc);
    if (FUSED) {
      float* dqp = dq_part + (head_of(n) * gridDim.x + kt) * static_cast<size_t>(sq) * D;
      const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
      if constexpr (D == 32) {  // two dQ columns a thread (fma_pv_d32)
        float dq[8][2] = {};
        fma_pv<D, true>(dss, ks, th, dq);
        fma_store_o<D>(dqp, q0, sq, th, dq, one);
      } else {
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          float dq[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) dq[r][c] = 0.f;
          }
          fma_pv<D, true, 1>(dss, ks, th, dq, h);
          fma_store_o<D, 1>(dqp, q0, sq, th, dq, one, h);
        }
      }
    }
    __syncthreads();  // the stage and the P^T, dS^T, dS tiles are read
    if (n + L::kStages < n_steps) load(n + L::kStages);
  }

  float ln2[8], one[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    ln2[r] = kLn2;
    one[r] = 1.f;
  }
  fma_store_o<D>(dk + kv_off, k0, skv, th, dk_acc, ln2);
  fma_store_o<D>(dv + kv_off, k0, skv, th, dv_acc, one);
}

// Shared memory of B3's fp32 kernel, in floats: kKStages K stages and
// kVStages V stages (FmaStages' rings), the Q_s and dO tiles, the lse2 and
// D_i rows; then the rings' mbarriers and one for the Q side.  At D = 64
// two K stages (two blocks an SM) ran 2-6% faster on the H100 than one
// (three blocks, whose 168-register cap spilled).  A tile's slot holds 64
// floats a row at D = 32 (fma_slot): dS is written over the V stage.
template <int D>
struct DqFp32 {
  static constexpr int kKStages = D <= 64 ? 2 : 1;
  static constexpr int kVStages = 1;
  static constexpr int kTile = kFmaTile * fma_slot(D);
  static constexpr int kV = kKStages * kTile;
  static constexpr int kQ = kV + kVStages * kTile;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kStats = kDO + kTile;
  static constexpr int kFloats = kStats + 2 * kFmaTile;
  static constexpr int kSmem = kFloats * 4 + 8 * (kKStages + kVStages + 1);
  static constexpr int kBlocksPerSm = 233472 / (kSmem + 1024);
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// B3's fp32 body: one block per (64-row Q tile, b * Hq), the tiles handed
// out from the last, so the longest causal rows start first (from the
// first for a band).  Q_s, dO and the tile's lse2 and D_i rows arrive once;
// K and V tiles of KvWalk stream through their rings (V swizzled: it is
// read as S's K is), to the causal diagonal and kv_len, from the window's
// oldest key after the sink tiles.  Thread (ty, tx) holds S and dP rows ty + 8 r, columns tx +
// 16 j, and dQ rows ty + 8 r, columns 64 h + 4 tx .. + 3, in registers for
// the whole walk.  Each tile: S = Q_s K^T and dP = dO V^T (over d in
// order), dS = P (dP - D_i) written over the V stage that dP has read, then
// dQ += dS K, key by key in order, with K read by rows from its swizzled
// stage.  dQ is stored once, times sm_scale.
template <int D>
__global__ void __launch_bounds__(kFmaThreads, DqFp32<D>::kBlocksPerSm)
bwd_dq_fp32(const float* __restrict__ qs_plane, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse2, const float* __restrict__ di,
            float* __restrict__ dq, const int* __restrict__ q_seg,
            const int* __restrict__ kv_seg, int hq, int hkv, int sq,
            int sq_pad, int skv, int kv_len, float sm_scale, int causal,
            int window, int sinks) {
  using L = DqFp32<D>;
  extern __shared__ __align__(16) float smem[];
  const FmaStages<L> st(smem);
  const FmaThread th = fma_thread();
  const bool band = !causal && window < kNoWindow;
  const int qt = band ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kFmaTile;
  const size_t bh = blockIdx.y;
  const int b = blockIdx.y / hq;
  const int hk = (blockIdx.y - b * hq) / (hq / hkv);
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const int kv_end = causal ? min(kv_len, q0 + kFmaTile) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, sinks, kFmaTile);
  const int n_kv = walk.n;
  const bool seg = q_seg != nullptr;
  const int* q_ids = seg ? q_seg + static_cast<size_t>(b) * seg_stride(sq) : nullptr;
  const int* kv_ids = seg ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;
  float* qs = smem + L::kQ;
  float* dos = smem + L::kDO;
  const float* stats = smem + L::kStats;
  const uint32_t q_bar = st.bar + 8 * (L::kKStages + L::kVStages);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, kFmaThreads);
    st.init();
  }
  __syncthreads();
  if (n_kv > 0) {
    fma_copy_tile<D, true>(qs, qs_plane + bh * sq * D, qt, sq);
    fma_copy_tile<D, true>(dos, dout + bh * sq * D, qt, sq);
    copy_stats(smem + L::kStats, lse2, di, bh * sq_pad + q0);
    cp_async_arrive(q_bar);
  }
  for (int t = 0; t < L::kKStages && t < n_kv; ++t) {
    fma_load_tile<D, true>(st.k(t), st.k_bar(t), kp, walk.at(t), skv);
  }
  for (int t = 0; t < L::kVStages && t < n_kv; ++t) {
    fma_load_tile<D, true>(st.v(t), st.v_bar(t), vp, walk.at(t), skv);
  }

  float lse2_r[8], di_r[8], acc[8][D / 16];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;
  }
  if (n_kv > 0) {
    mbar_wait(q_bar, 0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      lse2_r[r] = stats[th.ty + 8 * r];
      di_r[r] = stats[kFmaTile + th.ty + 8 * r];
    }
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = walk.at(t) * kFmaTile;
    st.wait_k(t);
    float s[8][4], dp[8][4];
    fma_scores<D>(qs, st.k(t), th, s);
    st.wait_v(t);
    fma_scores<D>(dos, st.v(t), th, dp);
    // Masked element by element: the kv_len tail, the diagonal, a tile
    // some row's window edge crosses, every tile with segment ids.
    // (An unmasked tile takes a body without the mask's code.)
    const bool need_mask =
        seg || (k0 + kFmaTile > kv_len) || (causal && k0 + kFmaTile - 1 > q0) ||
        (q0 + kFmaTile - 1 - k0 >= window && k0 + kFmaTile > sinks);
    auto ds_tile = [&](auto masked) {
      constexpr bool kMask = decltype(masked)::value;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + th.ty + 8 * r;
        const int qid = kMask && seg ? __ldg(q_ids + row) : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + th.tx + 16 * j;
          float p = exp2f(s[r][j] - lse2_r[r]);
          if (kMask && (col >= kv_len || (causal && col > row) ||
                        !in_window(row, col, window, sinks) ||
                        (seg && __ldg(kv_ids + col) != qid))) {
            p = 0.f;
          }
          s[r][j] = p * (dp[r][j] - di_r[r]);
        }
      }
    };
    if (need_mask) {
      ds_tile(std::true_type{});
    } else {
      ds_tile(std::false_type{});
    }
    float* dss = st.v(t);
    __syncthreads();  // V(t) is read: dS takes its stage
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) fma_store_p(dss, th, r, j, s[r][j]);
    }
    __syncthreads();  // dS is in place
    fma_pv<D, true>(dss, st.k(t), th, acc);
    __syncthreads();  // K(t) and dS are read: refill
    if (t + L::kKStages < n_kv) {
      fma_load_tile<D, true>(st.k(t + L::kKStages), st.k_bar(t + L::kKStages), kp,
                             walk.at(t + L::kKStages), skv);
    }
    if (t + L::kVStages < n_kv) {
      fma_load_tile<D, true>(st.v(t + L::kVStages), st.v_bar(t + L::kVStages), vp,
                             walk.at(t + L::kVStages), skv);
    }
  }

  float scale[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) scale[r] = sm_scale;
  fma_store_o<D>(dq + bh * sq * D, q0, sq, th, acc, scale);
}

// ---------------------------------------------------------------------------
// fp32 tiles at D = 256.  A 64 x 256 fp32 tile takes 64 KB, so the four
// tiles a step reads (K, V and Q_s, dO) would take 256 KB of the SM's 227:
// each kernel keeps two resident and streams the other two, one at a time,
// through a single 64 KB slot, loaded when the step needs it and waited for
// (no prefetch; one block of four warps an SM).
// ---------------------------------------------------------------------------
// Shared memory of the KV-major kernel at D = 256, in floats: K and V, the
// slot, the lse2 and D_i rows, the P^T and dS^T tiles ([64 kv][64 q],
// swizzled; with FUSED the P^T tile takes dS, q-major, once dV has read
// it), then the mbarriers of K/V and of the slot.
struct KvFp32Wide {
  static constexpr int kTile = kFmaTile * 256;
  static constexpr int kSquare = kFmaTile * kFmaTile;
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kSlot = 2 * kTile;
  static constexpr int kStats = kSlot + kTile;
  static constexpr int kPt = kStats + 2 * kFmaTile;
  static constexpr int kDst = kPt + kSquare;
  static constexpr int kFloats = kDst + kSquare;
  static constexpr int kSmem = kFloats * 4 + 16;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// B4's fp32 body at D = 256, and with FUSED B2's: one block per (64-row KV
// tile, b * Hkv, column half z).  A thread's dK and dV over all 256 columns
// would be 256 registers, so block z accumulates columns [128 z, 128 z +
// 128) of dK and dV (and of B2's dQ slices) and both halves form S^T and
// dP^T over the whole head dim.  The walk, the masks and the sums are
// bwd_kv_fp32's; each step loads Q_s, then dO, then Q_s again into the
// slot: S^T = K Q_s^T and P^T into its tile; dP^T = V dO^T and dS^T =
// P^T (dP^T - D_i) into its tile (P^T read back); dV += P^T dO; (FUSED) dS
// q-major over P^T; dK += dS^T Q_s; (FUSED) the dQ slice's half, dS K.
template <bool FUSED>
__global__ void __launch_bounds__(kFmaThreads, 1)
bwd_kv_fp32_wide(const float* __restrict__ qs_plane, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse2, const float* __restrict__ di,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dq_part, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, int hq, int hkv, int sq,
                 int sq_pad, int skv, int kv_len, int causal, int window,
                 int sinks) {
  constexpr int D = 256;
  using L = KvFp32Wide;
  extern __shared__ __align__(16) float smem[];
  const FmaThread th = fma_thread();
  const bool band = !causal && window < kNoWindow;
  const int kt = band ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int k0 = kt * kFmaTile;
  const int bh = blockIdx.y;
  const int z = blockIdx.z;  // this block's 128 columns of dK, dV and dQ
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const size_t kv_off = static_cast<size_t>(bh) * skv * D;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* slot = smem + L::kSlot;
  const float* lse2_s = smem + L::kStats;
  const float* di_s = lse2_s + kFmaTile;
  float* pt = smem + L::kPt;
  float* dst = smem + L::kDst;
  const uint32_t kv_bar = smem_addr(smem + L::kFloats);
  const uint32_t slot_bar = kv_bar + 8;

  const int n_q = (sq + kFmaTile - 1) / kFmaTile;
  const QWalk walk(k0, kFmaTile, n_q, kFmaTile, causal, window, sinks, kv_len);
  const int per_head = walk.n;
  const int n_steps = groups * per_head;
  const bool seg = q_seg != nullptr;
  const int* q_ids = seg ? q_seg + static_cast<size_t>(b) * seg_stride(sq) : nullptr;
  const int* kv_ids = seg ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, kFmaThreads);
    mbar_init(slot_bar, kFmaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int loads = 0;  // completed phases of the slot's barrier
  // Rows of query head n / per_head, Q tile walk.at(n % per_head), of
  // `plane` into the slot (with the tile's statistics), then the wait.
  auto fill = [&](int n, const float* plane, bool stats) {
    const size_t bhq = static_cast<size_t>(b) * hq + hk * groups + n / per_head;
    const int qt = walk.at(n % per_head);
    fma_copy_tile<D, true>(slot, plane + bhq * sq * D, qt, sq);
    if (stats) copy_stats(smem + L::kStats, lse2, di, bhq * sq_pad + qt * kFmaTile);
    cp_async_arrive(slot_bar);
    mbar_wait(slot_bar, loads & 1);
    ++loads;
  };
  if (n_steps > 0) {
    fma_copy_tile<D, true>(ks, k + kv_off, kt, skv);
    fma_copy_tile<D, true>(vs, v + kv_off, kt, skv);
    cp_async_arrive(kv_bar);
  }

  float dk_acc[8][8], dv_acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }
  if (n_steps > 0) mbar_wait(kv_bar, 0);
  for (int n = 0; n < n_steps; ++n) {
    const size_t bhq = static_cast<size_t>(b) * hq + hk * groups + n / per_head;
    const int q0 = walk.at(n % per_head) * kFmaTile;
    float s[8][4];
    fill(n, qs_plane, true);
    fma_scores<D>(ks, slot, th, s);
    const bool need_mask =
        seg || (k0 + kFmaTile > kv_len) || (causal && k0 + kFmaTile - 1 > q0) ||
        (q0 + kFmaTile - 1 - k0 >= window && k0 + kFmaTile > sinks);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = k0 + th.ty + 8 * r;
      const int kid = seg ? __ldg(kv_ids + row) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = th.tx + 16 * j;
        float p = exp2f(s[r][j] - lse2_s[c]);
        if (need_mask && (row >= kv_len || (causal && row > q0 + c) ||
                          !in_window(q0 + c, row, window, sinks) ||
                          (seg && __ldg(q_ids + q0 + c) != kid))) {
          p = 0.f;
        }
        fma_store_p(pt, th, r, j, p);
      }
    }
    __syncthreads();  // Q_s is read
    fill(n, dout, false);
    fma_scores<D>(vs, slot, th, s);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = th.tx + 16 * j;
        fma_store_p(dst, th, r, j, pt[fma_p_at(th, r, j)] * (s[r][j] - di_s[c]));
      }
    }
    __syncthreads();  // P^T and dS^T are in place
    fma_pv<D, true, 2>(pt, slot, th, dv_acc, 2 * z);
    __syncthreads();  // dO and P^T are read
    if (FUSED) {
      // dS, q-major, over the P^T tile: this thread's own dS^T values.
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = th.ty + 8 * r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = th.tx + 16 * j;
          pt[fma_swz<kFmaTile>(c, row >> 2) + (row & 3)] = dst[fma_p_at(th, r, j)];
        }
      }
      __syncthreads();  // dS is in place
    }
    fill(n, qs_plane, false);
    fma_pv<D, true, 2>(dst, slot, th, dk_acc, 2 * z);
    if (FUSED) {
      float* dqp = dq_part + (bhq * gridDim.x + kt) * static_cast<size_t>(sq) * D;
      const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
#pragma unroll 1
      for (int h = 2 * z; h < 2 * z + 2; ++h) {
        float dq[8][4] = {};
        fma_pv<D, true, 1>(pt, ks, th, dq, h);
        fma_store_o<D, 1>(dqp, q0, sq, th, dq, one, h);
      }
    }
    __syncthreads();  // the slot and the tiles are read
  }

  float ln2[8], one[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    ln2[r] = kLn2;
    one[r] = 1.f;
  }
  fma_store_o<D, 2>(dk + kv_off, k0, skv, th, dk_acc, ln2, 2 * z);
  fma_store_o<D, 2>(dv + kv_off, k0, skv, th, dv_acc, one, 2 * z);
}

// Shared memory of B3's fp32 kernel at D = 256, in floats: Q_s and dO, the
// slot, the lse2 and D_i rows, the dS tile ([64 q][64 kv], swizzled; dP
// first), then the mbarriers of the Q side and of the slot.
struct DqFp32Wide {
  static constexpr int kTile = kFmaTile * 256;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTile;
  static constexpr int kSlot = 2 * kTile;
  static constexpr int kStats = kSlot + kTile;
  static constexpr int kDs = kStats + 2 * kFmaTile;
  static constexpr int kFloats = kDs + kFmaTile * kFmaTile;
  static constexpr int kSmem = kFloats * 4 + 16;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// B3's fp32 body at D = 256: bwd_dq_fp32's blocks, walk, masks and sums,
// with Q_s and dO resident and each KV tile's V, then K, in the slot: dP =
// dO V^T into the dS tile; S = Q_s K^T and dS = P (dP - D_i) over it; dQ
// += dS K.  dQ (128 registers a thread) is stored once, times sm_scale.
template <int D>
__global__ void __launch_bounds__(kFmaThreads, 1)
bwd_dq_fp32_wide(const float* __restrict__ qs_plane, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse2, const float* __restrict__ di,
                 float* __restrict__ dq, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, int hq, int hkv, int sq,
                 int sq_pad, int skv, int kv_len, float sm_scale, int causal,
                 int window, int sinks) {
  static_assert(D == 256, "the D = 256 body");
  using L = DqFp32Wide;
  extern __shared__ __align__(16) float smem[];
  const FmaThread th = fma_thread();
  const bool band = !causal && window < kNoWindow;
  const int qt = band ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kFmaTile;
  const size_t bh = blockIdx.y;
  const int b = blockIdx.y / hq;
  const int hk = (blockIdx.y - b * hq) / (hq / hkv);
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const int kv_end = causal ? min(kv_len, q0 + kFmaTile) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, sinks, kFmaTile);
  const int n_kv = walk.n;
  const bool seg = q_seg != nullptr;
  const int* q_ids = seg ? q_seg + static_cast<size_t>(b) * seg_stride(sq) : nullptr;
  const int* kv_ids = seg ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;
  float* qs = smem + L::kQ;
  float* dos = smem + L::kDO;
  float* slot = smem + L::kSlot;
  const float* stats = smem + L::kStats;
  float* dss = smem + L::kDs;
  const uint32_t q_bar = smem_addr(smem + L::kFloats);
  const uint32_t slot_bar = q_bar + 8;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, kFmaThreads);
    mbar_init(slot_bar, kFmaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int loads = 0;  // completed phases of the slot's barrier
  auto fill = [&](const float* src, int t) {
    fma_copy_tile<D, true>(slot, src, walk.at(t), skv);
    cp_async_arrive(slot_bar);
    mbar_wait(slot_bar, loads & 1);
    ++loads;
  };
  if (n_kv > 0) {
    fma_copy_tile<D, true>(qs, qs_plane + bh * sq * D, qt, sq);
    fma_copy_tile<D, true>(dos, dout + bh * sq * D, qt, sq);
    copy_stats(smem + L::kStats, lse2, di, bh * sq_pad + q0);
    cp_async_arrive(q_bar);
  }

  float lse2_r[8], di_r[8], acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;
  }
  if (n_kv > 0) {
    mbar_wait(q_bar, 0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      lse2_r[r] = stats[th.ty + 8 * r];
      di_r[r] = stats[kFmaTile + th.ty + 8 * r];
    }
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = walk.at(t) * kFmaTile;
    float s[8][4];
    fill(vp, t);
    fma_scores<D>(dos, slot, th, s);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) fma_store_p(dss, th, r, j, s[r][j]);
    }
    __syncthreads();  // V(t) is read
    fill(kp, t);
    fma_scores<D>(qs, slot, th, s);
    const bool need_mask =
        seg || (k0 + kFmaTile > kv_len) || (causal && k0 + kFmaTile - 1 > q0) ||
        (q0 + kFmaTile - 1 - k0 >= window && k0 + kFmaTile > sinks);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + th.ty + 8 * r;
      const int qid = seg ? __ldg(q_ids + row) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + th.tx + 16 * j;
        float p = exp2f(s[r][j] - lse2_r[r]);
        if (need_mask && (col >= kv_len || (causal && col > row) ||
                          !in_window(row, col, window, sinks) ||
                          (seg && __ldg(kv_ids + col) != qid))) {
          p = 0.f;
        }
        const int at = fma_p_at(th, r, j);
        dss[at] = p * (dss[at] - di_r[r]);
      }
    }
    __syncthreads();  // dS is in place
    fma_pv<D, true>(dss, slot, th, acc);
    __syncthreads();  // K(t) and dS are read
  }

  float scale[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) scale[r] = sm_scale;
  fma_store_o<D>(dq + bh * sq * D, q0, sq, th, acc, scale);
}

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt): the KV-major wgmma kernel (B2 with DQ, B4
// without), B2's dQ reduce, and B3's Q-major wgmma kernel.
// ---------------------------------------------------------------------------
// Shared memory of the KV-major kernel (D <= 128), from a 1024-byte-aligned
// base: the block's K and V tiles, kStages stages of Q_s and of dO, with DQ
// two dS^T buffers, kStages stages of the row statistics ([lse2 | D_i |
// segment ids][BQ], fp32 and int32; the ids only with segments), then the
// mbarriers.  Without DQ (B4) a third stage in place of the dS^T
// buffers ran as fast as two, and 8% slower at a ragged S 1000 (timed by
// scripts/kernel_ab.py --kernel b4; PERF.md).  K, V, Q_s and dO arrive by
// TMA as boxes of R rows of Rows<D> (128-byte rows with the 128-byte
// swizzle; at D = 32 64-byte rows with the 64-byte swizzle).  dS^T [128
// kv][BQ q] is stored by the consumers with the 128-byte swizzle, as BQ /
// 64 atoms of 128 rows x 64 q columns.
template <int D, bool DQ>
struct BwdLayout {
#ifdef CFA_BWD_Q_ROWS
  static constexpr int BQ = CFA_BWD_Q_ROWS;
#else
  static constexpr int BQ = D == 128 ? 64 : 128;  // Q rows per step of the walk
#endif
  static_assert(BQ == 64 || BQ == 128, "Q rows a step: one or two 64-column dS^T atoms");
  static constexpr int kKv = kKvRows;
  static constexpr int kStages = 2;
  static constexpr int kBoxes = Rows<D>::kBoxes;
  static constexpr int kKVBox = kKvRows * Rows<D>::kRowBytes;
  static constexpr int kQBox = BQ * Rows<D>::kRowBytes;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kDsAtom = kKvRows * 128;
  static constexpr int kDsBytes = DQ ? kDsAtom * (BQ / 64) : 0;
  static constexpr int kStatBytes = 3 * BQ * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDs = kDO + kStages * kQBytes;
  static constexpr int kStats = kDs + 2 * kDsBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  // full K/V, full and empty of each stage, and alignment slack.
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// Shared memory of the KV-major kernel at D = 256 (B2 with DQ, B4
// without), from a 1024-byte-aligned base: the block's 64-row K and V
// tiles (32 KB each), two stages of 64-row Q_s and dO tiles (32 KB each),
// two P^T and two dS^T buffers ([64 kv][64 q], 8 KB each, 128-byte
// swizzle), two stages of the row statistics, then the mbarriers: 231,976
// bytes of the 232,448 a block may take.  128-row K and V tiles (128 KB)
// beside two stages of Q_s and dO would not fit.
template <bool DQ>
struct WideLayout {
  static constexpr int BQ = 64;
  static constexpr int kKv = fused_kv_rows(256);
  static constexpr int kStages = 2;
  static constexpr int kBoxes = 4;
  static constexpr int kKVBox = kKv * 128;
  static constexpr int kQBox = BQ * 128;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kSquare = kKv * 128;  // a [64 kv][64 q] 16-bit tile
  static constexpr int kStatBytes = 3 * BQ * 4;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kPt = kDO + kStages * kQBytes;
  static constexpr int kDst = kPt + 2 * kSquare;
  static constexpr int kStats = kDst + 2 * kSquare;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// Registers per thread after setmaxnreg: 128 x 24 + 256 x 240 = 64512 of
// the SM's 65536 (one block per SM).  Both wgmma kernels.
constexpr int kBwdThreads = 384;
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;

// The producer of the KV-major kernels (layout L, one thread): the block's
// K and V tiles once, then the walk's Q_s and dO tiles (the GQA group's
// query heads, gi outer) with their lse2 and D_i rows and, with segments,
// their ids into the stage ring.
template <typename L, int D>
__device__ __forceinline__ void produce_q_walk(
    uint32_t base, uint32_t full_kv, uint32_t full_q, uint32_t empty_q,
    const CUtensorMap* k_map, const CUtensorMap* v_map, const CUtensorMap* q_map,
    const CUtensorMap* do_map, const float* lse2, const float* di,
    const int* q_seg, const QWalk& walk, int k0, int bh, int b, int hk,
    int hq, int groups, int sq, int sq_pad) {
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  constexpr int kCols = Rows<D>::kBoxCols;
  const int per_head = walk.n;
  const int n_steps = groups * per_head;
  const bool seg = q_seg != nullptr;
  mbar_expect_tx(full_kv, 2 * L::kKVBytes);
#pragma unroll
  for (int box = 0; box < L::kBoxes; ++box) {
    tma_load_3d(base + L::kK + box * L::kKVBox, k_map, full_kv, box * kCols, k0, bh);
    tma_load_3d(base + L::kV + box * L::kKVBox, v_map, full_kv, box * kCols, k0, bh);
  }
  for (int j = 0; j < n_steps; ++j) {
    const int gi = j / per_head;
    const int q0 = walk.at(j - gi * per_head) * BQ;
    const int bhq = b * hq + hk * groups + gi;
    const int st = j % kStages;
    // The first pass over the ring finds every stage empty.
    mbar_wait(empty_q + 8 * st, ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(full_q + 8 * st, 2 * L::kQBytes + (seg ? 3 : 2) * BQ * 4);
#pragma unroll
    for (int box = 0; box < L::kBoxes; ++box) {
      tma_load_3d(base + L::kQ + st * L::kQBytes + box * L::kQBox, q_map,
                  full_q + 8 * st, box * kCols, q0, bhq);
      tma_load_3d(base + L::kDO + st * L::kQBytes + box * L::kQBox, do_map,
                  full_q + 8 * st, box * kCols, q0, bhq);
    }
    const size_t row = static_cast<size_t>(bhq) * sq_pad + q0;
    const uint32_t stats = base + L::kStats + st * L::kStatBytes;
    tma_load_1d(stats, lse2 + row, BQ * 4, full_q + 8 * st);
    tma_load_1d(stats + BQ * 4, di + row, BQ * 4, full_q + 8 * st);
    if (seg) {
      tma_load_1d(stats + 2 * BQ * 4,
                  q_seg + static_cast<size_t>(b) * seg_stride(sq) + q0, BQ * 4,
                  full_q + 8 * st);
    }
  }
}

// One block per (128-row KV tile, b * Hkv), D <= 128.  Warpgroup 0 is the
// producer (produce_q_walk).  Warpgroups 1 and 2 (consumer c) own KV rows
// [64 c, 64 c + 64) of the tile; warp w of a consumer holds rows 16 w + g
// and 16 w + g + 8 of every accumulator, columns 8 j + 2 t4 and 8 j + 2 t4
// + 1 of each 8-column group j.  With DQ (B2) each step also writes the
// tile's dQ slice; without it (B4) the block computes dK and dV only, and
// dq_part is not written.
template <typename Tin, typename Tt, int D, bool DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_fused_wgmma(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ lse2, const float* __restrict__ di,
                Tin* __restrict__ dk, Tin* __restrict__ dv,
                float* __restrict__ dq_part, const int* __restrict__ q_seg,
                const int* __restrict__ kv_seg, int hq, int hkv, int sq,
                int sq_pad, int skv, int kv_len, int causal, int window,
                int sinks) {
  using L = BwdLayout<D, DQ>;
  using R = Rows<D>;
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_kv = base + L::kBars;
  const uint32_t full_q = full_kv + 8;             // stage s at + 8 s
  const uint32_t empty_q = full_q + 8 * kStages;

  // Longest walks first: the first KV tiles under causal masking, the
  // last ones for a band.
  const int kt = !causal && window < kNoWindow ? gridDim.x - 1 - blockIdx.x
                                              : blockIdx.x;
  const int k0 = kt * kKvRows;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const int n_q = (sq + BQ - 1) / BQ;
  // Under causal the walk starts at the diagonal and under a window ends at
  // the last row it reaches; a KV tile wholly past kv_len walks nothing
  // (its dK and dV are zeros, its dQ slice is dead).
  const QWalk walk(k0, kKvRows, n_q, BQ, causal, window, sinks, kv_len);
  const int per_head = walk.n;
  const int n_steps = groups * per_head;
  const bool seg = q_seg != nullptr;

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
      produce_q_walk<L, D>(base, full_kv, full_q, empty_q, &k_map, &v_map, &q_map,
                           &do_map, lse2, di, q_seg, walk, k0, bh, b, hk, hq,
                           groups, sq, sq_pad);
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
  // This thread's KV rows' segment ids.
  int kid[2] = {0, 0};
  if (seg) {
    const int* ids = kv_seg + static_cast<size_t>(b) * seg_stride(skv);
    kid[0] = ids[kv_a];
    kid[1] = ids[kv_b];
  }
  // The consumer's share of each dQ tile (DQ): Q rows [qm, qm + 64) and
  // columns [dn, dn + kDqN), over all 128 KV rows of the tile.
  constexpr int kDqN = D == 128 ? 64 : D;
  const int qm = BQ == 128 ? 64 * c : 0;
  const int dn = D == 128 ? 64 * c : 0;
  const uint32_t ks = base + L::kK + 64 * c * R::kRowBytes;  // this consumer's K rows
  const uint32_t vs = base + L::kV + 64 * c * R::kRowBytes;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_steps > 0) mbar_wait(full_kv, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int gi = j / per_head;
    const int q0 = walk.at(j - gi * per_head) * BQ;
    const int bhq = b * hq + hk * groups + gi;
    const int st = j % kStages;
    const uint32_t qs = base + L::kQ + st * L::kQBytes;
    const uint32_t dos = base + L::kDO + st * L::kQBytes;
    const float* lse2_s =
        reinterpret_cast<const float*>(smem + L::kStats + st * L::kStatBytes);
    const float* di_s = lse2_s + BQ;
    const int* qid_s = reinterpret_cast<const int*>(di_s + BQ);
    mbar_wait(full_q + 8 * st, (j / kStages) & 1);

    // S^T = K Q_s^T and dP^T = V dO^T: D / 16 k-steps of 32 bytes, all
    // operands K-major.
    float st_acc[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Tile<Tt>::ss(st_acc, R::kstep(ks, kk, L::kKVBox), R::kstep(qs, kk, L::kQBox),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Tile<Tt>::ss(dpt, R::kstep(vs, kk, L::kKVBox), R::kstep(dos, kk, L::kQBox),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(st_acc);
    hold(dpt);

    // P^T = exp2(S^T - lse2), exactly 0 where masked; dS^T = P^T (dP^T -
    // D_i), both in fp32, then rounded to the tile type: the accumulators
    // of column groups 2 kk and 2 kk + 1 are exactly the register A
    // fragment of k-step kk.  Masked element by element: the kv_len tail,
    // the diagonal, a tile some row's window edge crosses, every tile with
    // segment ids.
    // (An unmasked tile takes a body without the mask's code, a tile
    // without segment ids one without theirs.)
    const bool need_mask =
        (k0 + kKvRows > kv_len) || (causal && k0 + kKvRows - 1 > q0) ||
        (q0 + BQ - 1 - k0 >= window && k0 + kKvRows > sinks);
    auto p_ds = [&](auto masked, auto segmented) {
      constexpr bool kMask = decltype(masked)::value;
      constexpr bool kSeg = decltype(segmented)::value;
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
          if (kMask && (row >= kv_len || (causal && row > q0 + col) ||
                        !in_window(q0 + col, row, window, sinks) ||
                        (kSeg && qid_s[col] != kid[e >> 1]))) {
            p = 0.f;
          }
          st_acc[4 * jj + e] = p;
          dpt[4 * jj + e] = p * (dpt[4 * jj + e] - di_s[col]);
        }
      }
    };
    if (seg) {
      p_ds(std::true_type{}, std::true_type{});
    } else if (need_mask) {
      p_ds(std::true_type{}, std::false_type{});
    } else {
      p_ds(std::false_type{}, std::false_type{});
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
    // kk + 16) of the stage, two 8-row groups an atom apart, MN-major; the
    // boxes are kQBox apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::rs(dv_acc, pa[kk], R::desc(dos + kk * 16 * R::kRowBytes, L::kQBox));
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::rs(dk_acc, sa[kk], R::desc(qs + kk * 16 * R::kRowBytes, L::kQBox));
    }
    wgmma_commit();

    float dq[kDqN / 2];
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
                        R::desc(kb + kk * 16 * R::kRowBytes, L::kKVBox), kk > 0);
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
      for (int jj = 0; jj < kDqN / 8; ++jj) {
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

// The KV-major kernel at D = 256 (B2 with DQ, B4 without): one block per
// (64-row KV tile, b * Hkv), the producer as above.  A consumer holding
// dK and dV of its KV rows over all 256 columns would need 256 registers
// for them alone, so the two consumers split the columns instead: each
// computes S^T and dP^T for all 64 KV rows and 32 of the step's 64 Q rows
// (c: Q rows [32 c, 32 c + 32)), forms P^T and dS^T there in fp32 and
// stores them, rounded, into the step's shared P^T and dS^T buffers
// ([64 kv][64 q], 128-byte swizzle); after a named barrier each
// accumulates columns [128 c, 128 c + 128) of dK and dV over the whole
// step (dV += P^T dO and dK += dS^T Q_s, A and B from shared memory) and
// with DQ those columns of the dQ slice (dS K, A = dS^T read MN-major).
// dK, dV and dQ take 64 registers each.  Buffer j % 2 was last read by the
// products of step j - 2, which both consumers waited for before step
// j - 1's barrier.  Warp w holds KV rows 16 w + g and 16 w + g + 8.
template <typename Tin, typename Tt, bool DQ>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_fused_wgmma_wide(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse2, const float* __restrict__ di,
                     Tin* __restrict__ dk, Tin* __restrict__ dv,
                     float* __restrict__ dq_part, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, int hq, int hkv, int sq,
                     int sq_pad, int skv, int kv_len, int causal, int window,
                     int sinks) {
  constexpr int D = 256;
  using L = WideLayout<DQ>;
  constexpr int BQ = L::BQ;
  constexpr int kKv = L::kKv;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_kv = base + L::kBars;
  const uint32_t full_q = full_kv + 8;             // stage s at + 8 s
  const uint32_t empty_q = full_q + 8 * kStages;

  const int kt = !causal && window < kNoWindow ? gridDim.x - 1 - blockIdx.x
                                              : blockIdx.x;
  const int k0 = kt * kKv;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv;
  const int hk = bh - b * hkv;
  const int groups = hq / hkv;
  const int n_q = (sq + BQ - 1) / BQ;
  const QWalk walk(k0, kKv, n_q, BQ, causal, window, sinks, kv_len);
  const int per_head = walk.n;
  const int n_steps = groups * per_head;
  const bool seg = q_seg != nullptr;

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
      produce_q_walk<L, D>(base, full_kv, full_q, empty_q, &k_map, &v_map, &q_map,
                           &do_map, lse2, di, q_seg, walk, k0, bh, b, hk, hq,
                           groups, sq, sq_pad);
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
  const int r_a = 16 * warp + g;  // this thread's rows of the KV tile
  const int r_b = r_a + 8;
  const int kv_a = k0 + r_a;
  const int kv_b = k0 + r_b;
  const int qc = 32 * c;  // this consumer's Q rows of a step (S^T, dP^T)
  int kid[2] = {0, 0};
  if (seg) {
    const int* ids = kv_seg + static_cast<size_t>(b) * seg_stride(skv);
    kid[0] = ids[kv_a];
    kid[1] = ids[kv_b];
  }

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_steps > 0) mbar_wait(full_kv, 0);

  for (int j = 0; j < n_steps; ++j) {
    const int gi = j / per_head;
    const int q0 = walk.at(j - gi * per_head) * BQ;
    const int bhq = b * hq + hk * groups + gi;
    const int st = j % kStages;
    const uint32_t qs = base + L::kQ + st * L::kQBytes;
    const uint32_t dos = base + L::kDO + st * L::kQBytes;
    const float* lse2_s =
        reinterpret_cast<const float*>(smem + L::kStats + st * L::kStatBytes);
    const float* di_s = lse2_s + BQ;
    const int* qid_s = reinterpret_cast<const int*>(di_s + BQ);
    mbar_wait(full_q + 8 * st, (j / kStages) & 1);

    // S^T and dP^T of Q rows [qc, qc + 32): 16 k-steps, K-major.
    float st_acc[16], dpt[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32 + qc * 128;
      Tile<Tt>::ss(st_acc, sw128_desc(base + L::kK + off, 16, 1024),
                   sw128_desc(qs + qoff, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kKVBox + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * L::kQBox + (kk % 4) * 32 + qc * 128;
      Tile<Tt>::ss(dpt, sw128_desc(base + L::kV + off, 16, 1024),
                   sw128_desc(dos + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    hold(st_acc);
    hold(dpt);

    // P^T and dS^T as bwd_fused_wgmma forms them (the masks over the whole
    // 64 x 64 tile), then rounded into this consumer's columns of the
    // step's buffers.
    const bool need_mask =
        (k0 + kKv > kv_len) || (causal && k0 + kKv - 1 > q0) ||
        (q0 + BQ - 1 - k0 >= window && k0 + kKv > sinks);
    auto p_ds = [&](auto masked, auto segmented) {
      constexpr bool kMask = decltype(masked)::value;
      constexpr bool kSeg = decltype(segmented)::value;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + jj * 8 + t4 * 2 + (e & 1);
          const int row = e < 2 ? kv_a : kv_b;
          const float x = st_acc[4 * jj + e] - lse2_s[col];
          float p = DQ ? exp2f(x) : exp2_ftz(x);
          if (kMask && (row >= kv_len || (causal && row > q0 + col) ||
                        !in_window(q0 + col, row, window, sinks) ||
                        (kSeg && qid_s[col] != kid[e >> 1]))) {
            p = 0.f;
          }
          st_acc[4 * jj + e] = p;
          dpt[4 * jj + e] = p * (dpt[4 * jj + e] - di_s[col]);
        }
      }
    };
    if (seg) {
      p_ds(std::true_type{}, std::true_type{});
    } else if (need_mask) {
      p_ds(std::true_type{}, std::false_type{});
    } else {
      p_ds(std::false_type{}, std::false_type{});
    }
    unsigned char* ptb = smem + L::kPt + (j & 1) * L::kSquare;
    unsigned char* dsb = smem + L::kDst + (j & 1) * L::kSquare;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int ch = 4 * c + jj;  // 16-byte chunk of Q columns qc + 8 jj
      const int at_a = r_a * 128 + ((ch ^ (r_a & 7)) * 16) + 4 * t4;
      const int at_b = r_b * 128 + ((ch ^ (r_b & 7)) * 16) + 4 * t4;
      *reinterpret_cast<uint32_t*>(ptb + at_a) =
          Tile<Tt>::pack(st_acc[4 * jj], st_acc[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(ptb + at_b) =
          Tile<Tt>::pack(st_acc[4 * jj + 2], st_acc[4 * jj + 3]);
      *reinterpret_cast<uint32_t*>(dsb + at_a) =
          Tile<Tt>::pack(dpt[4 * jj], dpt[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(dsb + at_b) =
          Tile<Tt>::pack(dpt[4 * jj + 2], dpt[4 * jj + 3]);
    }
    // Both consumers' halves visible to wgmma (the async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // dV += P^T dO and dK += dS^T Q_s over columns [128 c, 128 c + 128):
    // A K-major (k-step kk: Q rows [16 kk, 16 kk + 16)), B the stage's
    // boxes 2 c and 2 c + 1, MN-major.
    const uint32_t pta = smem_addr(ptb);
    const uint32_t dsa = smem_addr(dsb);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::ss_nt(dv_acc, sw128_desc(pta + kk * 32, 16, 1024),
                      sw128_desc(dos + 2 * c * L::kQBox + kk * 16 * 128, L::kQBox, 1024),
                      1);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      Tile<Tt>::ss_nt(dk_acc, sw128_desc(dsa + kk * 32, 16, 1024),
                      sw128_desc(qs + 2 * c * L::kQBox + kk * 16 * 128, L::kQBox, 1024),
                      1);
    }
    wgmma_commit();
    float dq[64];
    if constexpr (DQ) {
      // The dQ slice's columns [128 c, 128 c + 128): dS K over the tile's
      // 64 KV rows (4 k-steps), A = dS^T and B = the K tile's boxes 2 c
      // and 2 c + 1, both MN-major.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        Tile<Tt>::ss_tt(dq, sw128_desc(dsa + kk * 16 * 128, L::kSquare, 1024),
                        sw128_desc(base + L::kK + 2 * c * L::kKVBox + kk * 16 * 128,
                                   L::kKVBox, 1024),
                        kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    hold(dk_acc);
    hold(dv_acc);
    if constexpr (DQ) hold(dq);
    // Q_s, dO and the statistics of this stage are read.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_q + 8 * st);

    if constexpr (DQ) {
      float* dqp =
          dq_part + (static_cast<size_t>(bhq) * gridDim.x + kt) * sq * D;
      const int ra = q0 + 16 * warp + g;
      const int rb = ra + 8;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 128 * c + jj * 8 + t4 * 2;
        if (ra < sq) store2(dqp + static_cast<size_t>(ra) * D + col, dq[4 * jj], dq[4 * jj + 1]);
        if (rb < sq) store2(dqp + static_cast<size_t>(rb) * D + col, dq[4 * jj + 2], dq[4 * jj + 3]);
      }
    }
  }

  const size_t kv_off = static_cast<size_t>(bh) * skv * D;
  Tin* dkp = dk + kv_off;
  Tin* dvp = dv + kv_off;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = 128 * c + jj * 8 + t4 * 2;
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
// when it holds a key the row keeps: row r walks KvWalk from its window's
// oldest key (and the sink tiles) to kv_len or, under causal, to r.  B2
// wrote each of these slices for row r (QWalk reaches r's Q tile from
// every such KV tile); every other slice holds zeros or nothing, so
// skipping it leaves the ordered sum exact.  A row that keeps no key
// gets dQ = 0.
template <typename Tout>
__global__ void __launch_bounds__(256)
dq_reduce(const float* __restrict__ dq_part, Tout* __restrict__ dq, int sq,
          int d, int n_slices, int kv_len, int tile, int causal, int window,
          int sinks, float sm_scale) {
  // blockIdx.y is b * Hq + h; x walks that head's sq * d / 4 float4s.
  const size_t head = static_cast<size_t>(blockIdx.y) * sq * d;
  const float* src = dq_part + head * n_slices;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < sq * d / 4;
       i += gridDim.x * 256) {
    const int r = 4 * i / d;
    const KvWalk walk(r - window + 1, causal ? min(kv_len, r + 1) : kv_len,
                      sinks, tile);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < walk.n; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(walk.at(n)) * sq * d + 4 * i);
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
// each), the row statistics ([lse2 | D_i][BQ] fp32), each K stage's
// segment ids (BN int32, only with segments), then the mbarriers.
// Every tile is Rows<D>'s boxes of R rows.  BN is 128 at D = 64, 64 at D
// = 32 (with 128 rows the fp16-tile instantiation on fp32 inputs spilled 8
// bytes) and D = 128, and 32 at D = 256, where the Q_s and dO tiles alone
// take 128 KB and three stages of 32-row K and V tiles 96 KB (231,912
// bytes of the 232,448 a block may take); a consumer's dQ (128 registers
// a thread) then sits beside 32-column S and dP accumulators (16 each).
template <int D>
struct DqLayout {
  static constexpr int BQ = 128;  // Q rows per block
#ifdef CFA_DQ_KV_ROWS
  static constexpr int BN = CFA_DQ_KV_ROWS;
#else
  static constexpr int BN = D == 64 ? 128 : D == 256 ? 32 : 64;  // KV rows per ring stage
#endif
#ifdef CFA_DQ_STAGES
  static constexpr int kStages = CFA_DQ_STAGES;
#else
  static constexpr int kStages = 3;  // 1.08-1.23x faster than 2 (PERF.md)
#endif
  static constexpr int kBoxes = Rows<D>::kBoxes;
  static constexpr int kQBox = BQ * Rows<D>::kRowBytes;
  static constexpr int kKVBox = BN * Rows<D>::kRowBytes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kStatBytes = 2 * BQ * 4;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kStats = kV + kStages * kKVBytes;
  static constexpr int kSeg = kStats + kStatBytes;  // K stage s's ids
  static constexpr int kBars = kSeg + kStages * BN * 4;
  // full Q, full and empty of each K and V stage, and alignment slack.
  static constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// B3: one block per (128-row Q tile, b * Hq), the tiles handed out from the
// last, so the longest causal rows start first (from the first for a
// band).  Warpgroup 0 is the producer: one thread loads the block's Q_s
// and dO tiles and their lse2 and D_i rows once, then streams the K and V
// tiles of the walk (KvWalk: the sink tiles, then from the window's oldest
// key to the causal diagonal and kv_len) into their rings.  Warpgroups 1 and 2
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
             Tin* __restrict__ dq, const int* __restrict__ q_seg,
             const int* __restrict__ kv_seg, int hq, int hkv, int sq,
             int sq_pad, int skv, int kv_len, float sm_scale, int causal,
             int window, int sinks) {
  using L = DqLayout<D>;
  using R = Rows<D>;
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

  // Longest walks first: the last Q tiles, or the first ones for a band.
  const bool band = !causal && window < kNoWindow;
  const int q0 = (band ? blockIdx.x : gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;  // b * hq + query head
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  // Under causal the walk ends at the tile's last row before sq, under a
  // window it starts at its first row's oldest key (after the sink tiles);
  // a walk with no key loads nothing and stores zeros.
  const int kv_end = causal ? min(kv_len, min(sq, q0 + BQ)) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, sinks, BN);
  const int n_tiles = walk.n;
  const bool seg = q_seg != nullptr;

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
        tma_load_3d(base + L::kQ + box * L::kQBox, &q_map, full_q,
                    box * R::kBoxCols, q0, bh);
        tma_load_3d(base + L::kDO + box * L::kQBox, &do_map, full_q,
                    box * R::kBoxCols, q0, bh);
      }
      const size_t row = static_cast<size_t>(bh) * sq_pad + q0;
      tma_load_1d(base + L::kStats, lse2 + row, BQ * 4, full_q);
      tma_load_1d(base + L::kStats + BQ * 4, di + row, BQ * 4, full_q);
      const int kv_head = b * hkv + hk;
      const int* kv_ids =
          seg ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int k0 = walk.at(t) * BN;
        // The first pass over a ring finds every stage empty.  V goes
        // first: its stage is freed before K's (after dP, not after dQ).
        // K's stage carries the tile's segment ids.
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        mbar_wait(empty_v + 8 * st, parity);
        mbar_expect_tx(full_v + 8 * st, L::kKVBytes);
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(base + L::kV + st * L::kKVBytes + box * L::kKVBox,
                      &v_map, full_v + 8 * st, box * R::kBoxCols, k0, kv_head);
        }
        mbar_wait(empty_k + 8 * st, parity);
        mbar_expect_tx(full_k + 8 * st, L::kKVBytes + (seg ? BN * 4 : 0));
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(base + L::kK + st * L::kKVBytes + box * L::kKVBox,
                      &k_map, full_k + 8 * st, box * R::kBoxCols, k0, kv_head);
        }
        if (seg) {
          tma_load_1d(base + L::kSeg + st * BN * 4, kv_ids + k0, BN * 4,
                      full_k + 8 * st);
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
  const uint32_t qs = base + L::kQ + 64 * c * R::kRowBytes;  // this consumer's Q rows
  const uint32_t dos = base + L::kDO + 64 * c * R::kRowBytes;
  // This thread's rows' segment ids.
  int qid[2] = {0, 0};
  if (seg) {
    const int* ids = q_seg + static_cast<size_t>(b) * seg_stride(sq);
    qid[0] = ids[row_a];
    qid[1] = ids[row_b];
  }

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
  // for: D / 16 k-steps of 32 bytes, all operands K-major.
  auto issue_sdp = [&](int t) {
    const int st = t % kStages;
    mbar_wait(full_k + 8 * st, (t / kStages) & 1);
    mbar_wait(full_v + 8 * st, (t / kStages) & 1);
    const uint32_t ks = base + L::kK + st * L::kKVBytes;
    const uint32_t vs = base + L::kV + st * L::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Tile<Tt>::ss(s, R::kstep(qs, kk, L::kQBox), R::kstep(ks, kk, L::kKVBox), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Tile<Tt>::ss(dp, R::kstep(dos, kk, L::kQBox), R::kstep(vs, kk, L::kKVBox), kk > 0);
    }
    wgmma_commit();
  };
  // Issue dQ += dS K of tile t from sa, one group, not waited for: k-step
  // kk reads K rows [16 kk, 16 kk + 16) of the stage, two 8-row groups an
  // atom apart, MN-major (the transpose bit); the boxes are kKVBox apart.
  // At D = 256 each k-step is two n128 products, columns [0, 128) and
  // [128, 256) (boxes 0-1 and 2-3), into the two halves of dQ.
  auto issue_dq = [&](int t) {
    const uint32_t ks = base + L::kK + (t % kStages) * L::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t k_rows = ks + kk * 16 * R::kRowBytes;
      if constexpr (D > 128) {
        Tile<Tt>::rs(*reinterpret_cast<float(*)[64]>(&dq_acc[0]), sa[kk],
                     R::desc(k_rows, L::kKVBox));
        Tile<Tt>::rs(*reinterpret_cast<float(*)[64]>(&dq_acc[64]), sa[kk],
                     R::desc(k_rows + 2 * L::kKVBox, L::kKVBox));
      } else {
        Tile<Tt>::rs(dq_acc, sa[kk], R::desc(k_rows, L::kKVBox));
      }
    }
    wgmma_commit();
  };
  // P = exp2(S - lse2), exactly 0 where masked, and dS = P (dP - D_i) of
  // tile t in fp32, in place of S.  Masked element by element: the kv_len
  // tail, the diagonal, a tile some row's window edge crosses, every tile
  // with segment ids (K stage t's ids, held until dQ(t) has read the
  // stage).
  auto grads = [&](int t) {
    const int k0 = walk.at(t) * BN;
    const int* kid =
        reinterpret_cast<const int*>(smem + L::kSeg + (t % kStages) * BN * 4);
    auto tile = [&](auto masked, auto segmented) {
      constexpr bool kMask = decltype(masked)::value;
      constexpr bool kSeg = decltype(segmented)::value;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = jj * 8 + t4 * 2 + (e & 1);
          const int col = k0 + cc;
          const int row = e < 2 ? row_a : row_b;
          float p = exp2_ftz(s[4 * jj + e] - lse2_r[e >> 1]);
          if (kMask && (col >= kv_len || (causal && col > row) ||
                        !in_window(row, col, window, sinks) ||
                        (kSeg && kid[cc] != qid[e >> 1]))) {
            p = 0.f;
          }
          s[4 * jj + e] = p * (dp[4 * jj + e] - di_r[e >> 1]);
        }
      }
    };
    // An unmasked tile takes a body without the mask's code, a tile
    // without segment ids one without theirs.
    if (seg) {
      tile(std::true_type{}, std::true_type{});
    } else if ((k0 + BN > kv_len) || (causal && k0 + BN - 1 > qc0) ||
               (qc0 + 63 - k0 >= window && k0 + BN > sinks)) {
      tile(std::true_type{}, std::false_type{});
    } else {
      tile(std::false_type{}, std::false_type{});
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
  int causal, window, sinks;
  const int* q_seg;  // segment ids, both null for none
  const int* kv_seg;
  cudaStream_t stream;
};

// The prologue's workspace (B2, B3, B4): Q_s (and, where the inputs are
// not already in the tile type, dO, K and V) in the tile type of
// `tile_bytes` bytes (2, or 4 for fp32), then the lse2 and D_i planes
// [batch * hq, sq_pad] fp32, sq_pad = sq rounded up to 128.  Each part
// starts on a 256-byte boundary.
struct BwdWorkspace {
  size_t qs, dos, ks, vs, lse2, di, total;
};

size_t align256(size_t x) { return (x + 255) & ~size_t{255}; }

int sq_padded(int sq) { return (sq + kKvRows - 1) / kKvRows * kKvRows; }

BwdWorkspace bwd_workspace(int batch, int hq, int hkv, int sq, int skv, int d,
                           int tile_bytes, bool cast_in) {
  const size_t q_bytes = static_cast<size_t>(tile_bytes) * batch * hq * sq * d;
  const size_t kv_bytes = static_cast<size_t>(tile_bytes) * batch * hkv * skv * d;
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
// box_rows x 64 columns with the 128-byte swizzle (at d = 32 one box of 32
// columns with the 64-byte swizzle, Rows<32>); reads past seq give zeros.
int map_3d(CUtensorMap* map, const void* ptr, int tiles, int rows, int seq,
           int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(seq) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d < 64 ? d : 64),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tiles == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      d < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// What the prologue leaves for the kernels: Q_s, dO, K and V in the tile
// type (the inputs themselves where they are in it already), and the
// padded lse2 and D_i planes.
template <typename Tt>
struct Formed {
  const Tt* qs;
  const Tt* dos;
  const Tt* ks;
  const Tt* vs;
  const float* lse2;
  const float* di;
  int sq_pad;
};

// The prologue: D_i folded in from a.o for B2, a.di copied for B3 and B4.
template <typename Tin, typename Tt, int D>
int run_prologue(const Args& a, void* workspace, Formed<Tt>* f) {
  constexpr bool kCast = !std::is_same<Tin, Tt>::value;
  const BwdWorkspace w = bwd_workspace(a.batch, a.hq, a.hkv, a.sq, a.skv, D,
                                       sizeof(Tt), kCast);
  auto* ws = static_cast<unsigned char*>(workspace);
  Tt* qs = reinterpret_cast<Tt*>(ws + w.qs);
  Tt* dos = kCast ? reinterpret_cast<Tt*>(ws + w.dos) : nullptr;
  Tt* ks = kCast ? reinterpret_cast<Tt*>(ws + w.ks) : nullptr;
  Tt* vs = kCast ? reinterpret_cast<Tt*>(ws + w.vs) : nullptr;
  float* lse2 = reinterpret_cast<float*>(ws + w.lse2);
  float* di = reinterpret_cast<float*>(ws + w.di);
  f->sq_pad = sq_padded(a.sq);
  const int q_rows = a.batch * a.hq;
  const int kv_rows = kCast ? a.batch * a.hkv * a.skv : 0;
  const size_t rows = static_cast<size_t>(q_rows) * f->sq_pad + kv_rows;
  constexpr int kLanes = PrologueLanes<Tt, D>::kLanes;
  bwd_prologue<Tin, Tt, D><<<static_cast<unsigned>((rows * kLanes + 255) / 256),
                             256, 0, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.o),
      static_cast<const Tin*>(a.dout), a.lse, a.di,
      static_cast<const Tin*>(a.k), static_cast<const Tin*>(a.v), qs, dos, ks,
      vs, lse2, di, q_rows, a.sq, f->sq_pad, kv_rows, a.qscale);
  f->qs = qs;
  f->dos = kCast ? dos : static_cast<const Tt*>(a.dout);
  f->ks = kCast ? ks : static_cast<const Tt*>(a.k);
  f->vs = kCast ? vs : static_cast<const Tt*>(a.v);
  f->lse2 = lse2;
  f->di = di;
  return cudaGetLastError();
}

// What the wgmma kernels read: Q_s, dO, K and V as tensor maps, and the
// padded lse2 and D_i planes.
struct Planes {
  CUtensorMap q_map, do_map, k_map, v_map;
  const float* lse2;
  const float* di;
  int sq_pad;
};

// The prologue, then the four maps: Q_s and dO in boxes of q_box rows, K
// and V in boxes of kv_box rows.
template <typename Tin, typename Tt, int D>
int prepare(const Args& a, int tiles, void* workspace, int q_box, int kv_box,
            Planes* p) {
  Formed<Tt> f;
  int err = run_prologue<Tin, Tt, D>(a, workspace, &f);
  if (err != 0) return err;
  p->sq_pad = f.sq_pad;
  p->lse2 = f.lse2;
  p->di = f.di;
  const int kv_heads = a.batch * a.hkv;
  const int q_rows = a.batch * a.hq;
  err = map_3d(&p->k_map, f.ks, tiles, kv_heads, a.skv, D, kv_box);
  if (err == 0) err = map_3d(&p->v_map, f.vs, tiles, kv_heads, a.skv, D, kv_box);
  if (err == 0) err = map_3d(&p->q_map, f.qs, tiles, q_rows, a.sq, D, q_box);
  if (err == 0) err = map_3d(&p->do_map, f.dos, tiles, q_rows, a.sq, D, q_box);
  return err;
}

// B2 (FUSED) or B4 with fp32 tiles: the prologue, then the KV-major kernel
// (at D = 256 its column halves, bwd_kv_fp32_wide).
template <int D, bool FUSED>
int launch_kv_fp32(const Args& a, void* workspace) {
  Formed<float> f;
  const int err = run_prologue<float, float, D>(a, workspace, &f);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  if constexpr (D > 128) {
    const cudaError_t cerr = set_smem_once(bwd_kv_fp32_wide<FUSED>,
                                           KvFp32Wide::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid((a.skv + kFmaTile - 1) / kFmaTile, a.batch * a.hkv, 2);
    bwd_kv_fp32_wide<FUSED><<<grid, kFmaThreads, KvFp32Wide::kSmem, a.stream>>>(
        f.qs, f.ks, f.vs, f.dos, f.lse2, f.di, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), static_cast<float*>(a.dq), a.q_seg, a.kv_seg,
        a.hq, a.hkv, a.sq, f.sq_pad, a.skv, a.kv_len, a.causal, a.window,
        a.sinks);
  } else {
    using L = KvFp32<D, FUSED>;
    const cudaError_t cerr =
        set_smem_once(bwd_kv_fp32<D, FUSED>, L::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid((a.skv + kFmaTile - 1) / kFmaTile, a.batch * a.hkv);
    bwd_kv_fp32<D, FUSED><<<grid, kFmaThreads, L::kSmem, a.stream>>>(
        f.qs, f.ks, f.vs, f.dos, f.lse2, f.di, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), static_cast<float*>(a.dq), a.q_seg, a.kv_seg,
        a.hq, a.hkv, a.sq, f.sq_pad, a.skv, a.kv_len, a.causal, a.window,
        a.sinks);
  }
  return cudaGetLastError();
}

// B3 with fp32 tiles: the prologue, then the Q-major kernel (at D = 256
// bwd_dq_fp32_wide).
template <int D>
int launch_dq_fp32(const Args& a, void* workspace) {
  Formed<float> f;
  const int err = run_prologue<float, float, D>(a, workspace, &f);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  if constexpr (D > 128) {
    const cudaError_t cerr =
        set_smem_once(bwd_dq_fp32_wide<D>, DqFp32Wide::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid((a.sq + kFmaTile - 1) / kFmaTile, a.batch * a.hq);
    bwd_dq_fp32_wide<D><<<grid, kFmaThreads, DqFp32Wide::kSmem, a.stream>>>(
        f.qs, f.ks, f.vs, f.dos, f.lse2, f.di, static_cast<float*>(a.dq),
        a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, f.sq_pad, a.skv, a.kv_len,
        a.sm_scale, a.causal, a.window, a.sinks);
  } else {
    using L = DqFp32<D>;
    const cudaError_t cerr = set_smem_once(bwd_dq_fp32<D>, L::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid((a.sq + kFmaTile - 1) / kFmaTile, a.batch * a.hq);
    bwd_dq_fp32<D><<<grid, kFmaThreads, L::kSmem, a.stream>>>(
        f.qs, f.ks, f.vs, f.dos, f.lse2, f.di, static_cast<float*>(a.dq),
        a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, f.sq_pad, a.skv, a.kv_len,
        a.sm_scale, a.causal, a.window, a.sinks);
  }
  return cudaGetLastError();
}

// B2 (DQ) or B4: the prologue, then the KV-major kernel (at D = 256
// bwd_fused_wgmma_wide).
template <typename Tin, typename Tt, int D, bool DQ>
int launch_kv_wgmma(const Args& a, int tiles, void* workspace) {
  using L = std::conditional_t<(D > 128), WideLayout<DQ>, BwdLayout<D, DQ>>;
  Planes p;
  const int err = prepare<Tin, Tt, D>(a, tiles, workspace, L::BQ, L::kKv, &p);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  const dim3 grid((a.skv + L::kKv - 1) / L::kKv, a.batch * a.hkv);
  if constexpr (D > 128) {
    const cudaError_t cerr =
        set_smem_once(bwd_fused_wgmma_wide<Tin, Tt, DQ>, L::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    bwd_fused_wgmma_wide<Tin, Tt, DQ><<<grid, kBwdThreads, L::kSmem, a.stream>>>(
        p.k_map, p.v_map, p.q_map, p.do_map, p.lse2, p.di,
        static_cast<Tin*>(a.dk), static_cast<Tin*>(a.dv),
        static_cast<float*>(a.dq), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq,
        p.sq_pad, a.skv, a.kv_len, a.causal, a.window, a.sinks);
  } else {
    const cudaError_t cerr =
        set_smem_once(bwd_fused_wgmma<Tin, Tt, D, DQ>, L::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    bwd_fused_wgmma<Tin, Tt, D, DQ><<<grid, kBwdThreads, L::kSmem, a.stream>>>(
        p.k_map, p.v_map, p.q_map, p.do_map, p.lse2, p.di,
        static_cast<Tin*>(a.dk), static_cast<Tin*>(a.dv),
        static_cast<float*>(a.dq), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq,
        p.sq_pad, a.skv, a.kv_len, a.causal, a.window, a.sinks);
  }
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
      static_cast<Tin*>(a.dq), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, p.sq_pad,
      a.skv, a.kv_len, a.sm_scale, a.causal, a.window, a.sinks);
  return cudaGetLastError();
}

enum class BwdKernel { kFused, kDq, kDkv };  // B2, B3, B4

template <typename Tin, typename Tt, int D>
int launch_16bit(BwdKernel kernel, const Args& a, int tiles, void* workspace) {
  if (kernel == BwdKernel::kDq) return launch_dq_wgmma<Tin, Tt, D>(a, tiles, workspace);
  if (kernel == BwdKernel::kFused) {
#ifdef CFA_BWD_DKV_ONLY
    return static_cast<int>(cudaErrorInvalidValue);
#else
    return launch_kv_wgmma<Tin, Tt, D, true>(a, tiles, workspace);
#endif
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
int launch_fp32(BwdKernel kernel, const Args& a, void* workspace) {
  if (kernel == BwdKernel::kDq) return launch_dq_fp32<D>(a, workspace);
  if (kernel == BwdKernel::kFused) return launch_kv_fp32<D, true>(a, workspace);
  return launch_kv_fp32<D, false>(a, workspace);
}

// The instantiations of every kernel at this library's head dims
// (CFA_HEAD_DIMS) and input types.  in_type: q/k/v/o/dO and the gradients
// are 0 fp32, 1 bf16 or 2 fp16 (fp16 in csrc/fa2_backward_fp16in.cu).
// tiles: 0 fp32 on the FMA units (needs fp32 inputs), 1 bf16 or 2 fp16 on
// the tensor cores.
int dispatch(BwdKernel kernel, const Args& a, int head_dim, int in_type,
             int tiles, void* workspace) {
#ifdef CFA_FP16_INPUTS
#define CFA_CASE(D)                                                            \
  if (head_dim == D && in_type == 2 && (tiles == 1 || tiles == 2)) {           \
    return launch_tiles<__half, D>(kernel, a, tiles, workspace);               \
  }
#else
#define CFA_CASE(D)                                                            \
  if (head_dim == D) {                                                         \
    if (tiles == 1 || tiles == 2) {                                            \
      if (in_type == 1) {                                                      \
        return launch_tiles<__nv_bfloat16, D>(kernel, a, tiles, workspace);    \
      }                                                                        \
      CFA_FP32_INPUTS(if (in_type == 0) {                                      \
        return launch_tiles<float, D>(kernel, a, tiles, workspace);            \
      })                                                                       \
    }                                                                          \
    CFA_FP32_INPUTS(if (tiles == 0 && in_type == 0) {                          \
      return launch_fp32<D>(kernel, a, workspace);                             \
    })                                                                         \
  }
#endif
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Rows of the KV tile that owns one dQ slice in B2 for tile code `tiles`
// at `head_dim`: dq_part has ceil(skv / tile) slices.
int cfa_fa2_backward_kv_tile(int tiles, int head_dim) {
  return tiles ? fused_kv_rows(head_dim) : kFmaTile;
}

// 1: the entry points take the window, the sinks and segment ids (an
// earlier source without this symbol takes neither).
int cfa_fa2_backward_masks() { return 1; }

// Bytes of the workspace of B2, B3 and B4 for these shapes and types (0
// for a pair of them that no kernel takes).  dO, K and V get buffers of
// their own only where the inputs are not in the tile type already.
long long cfa_fa2_backward_workspace(int batch, int hq, int hkv, int sq,
                                     int skv, int head_dim, int in_type,
                                     int tiles) {
  if (tiles == 0 && in_type == 0) {
    return static_cast<long long>(
        bwd_workspace(batch, hq, hkv, sq, skv, head_dim, 4, false).total);
  }
  if (tiles != 1 && tiles != 2) return 0;
  return static_cast<long long>(
      bwd_workspace(batch, hq, hkv, sq, skv, head_dim, 2, in_type != tiles).total);
}

// B2.  q, o, dout [batch, hq, sq, head_dim]; k, v, dk, dv [batch, hkv, skv,
// head_dim]; lse [batch, hq, sq] fp32 (natural log); dq_part [batch, hq,
// ceil(skv / kv_tile), sq, head_dim] fp32, of which the kernel writes the
// slices of its walks (cfa_fa2_backward_dq_reduce reads a subset of
// them).  All contiguous and 16-byte aligned.  qscale = sm_scale *
// log2(e).  window (kNoWindow: none; without causal a band, any value)
// and sinks as cfa_fa2_forward's; q_seg [batch, seg_stride(sq)] and
// kv_seg [batch, seg_stride(skv)] int32 segment ids, or both null.
// workspace: cfa_fa2_backward_workspace bytes, 256-byte aligned.  Returns
// a cudaError_t, or an error of the tensor-map step.
int cfa_fa2_backward_fused(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* lse,
                           void* dk, void* dv, void* dq_part, int batch,
                           int hq, int hkv, int sq, int skv, int head_dim,
                           int kv_len, float qscale, int causal, int window,
                           int sinks, const void* q_seg, const void* kv_seg,
                           int in_type, int tiles, void* workspace,
                           void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), nullptr,
               dq_part, dk, dv, batch, hq, hkv, sq, skv, kv_len, qscale, 0.f,
               causal, window, sinks, static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kFused, a, head_dim, in_type, tiles, workspace);
}

// B2's dQ from its slices: dq [batch, hq, sq, head_dim] (out_type 0 fp32,
// 1 bf16, 2 fp16) = sm_scale * the ordered sum of the slices of dq_part
// that each row's walk reaches (tile code `tiles`, window and sinks as the
// fused launch's).  Returns a cudaError_t.
int cfa_fa2_backward_dq_reduce(const void* dq_part, void* dq, int batch, int hq,
                               int sq, int skv, int head_dim, int kv_len,
                               int causal, int window, int sinks,
                               float sm_scale, int out_type, int tiles,
                               void* stream) {
  const int tile = cfa_fa2_backward_kv_tile(tiles, head_dim);
  const int n_slices = (skv + tile - 1) / tile;
  const dim3 grid(std::min((sq * head_dim / 4 + 255) / 256, 64), batch * hq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const float*>(dq_part);
  const int kv = std::min(kv_len, skv);
#ifdef CFA_FP16_INPUTS
  if (out_type == 2) {
    dq_reduce<__half><<<grid, 256, 0, st>>>(
        src, static_cast<__half*>(dq), sq, head_dim, n_slices, kv, tile, causal,
        window, sinks, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#else
  if (out_type == 1) {
    dq_reduce<__nv_bfloat16><<<grid, 256, 0, st>>>(
        src, static_cast<__nv_bfloat16*>(dq), sq, head_dim, n_slices, kv, tile,
        causal, window, sinks, sm_scale);
  } else if (out_type != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    dq_reduce<float><<<grid, 256, 0, st>>>(
        src, static_cast<float*>(dq), sq, head_dim, n_slices, kv, tile, causal,
        window, sinks, sm_scale);
  }
#endif
  return cudaGetLastError();
}

// B4.  As B2 without o and dq_part, with di [batch, hq, sq] fp32 =
// rowsum(dO * O).
int cfa_fa2_backward_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* di,
                         void* dk, void* dv, int batch, int hq, int hkv,
                         int sq, int skv, int head_dim, int kv_len,
                         float qscale, int causal, int window, int sinks,
                         const void* q_seg, const void* kv_seg, int in_type,
                         int tiles, void* workspace, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), nullptr, dk, dv, batch, hq, hkv,
               sq, skv, kv_len, qscale, 0.f, causal, window, sinks,
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
               static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kDkv, a, head_dim, in_type, tiles, workspace);
}

// B3.  As B4, with dq like q, scaled by sm_scale.
int cfa_fa2_backward_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dq, int batch, int hq, int hkv, int sq, int skv,
                        int head_dim, int kv_len, float qscale, float sm_scale,
                        int causal, int window, int sinks, const void* q_seg,
                        const void* kv_seg, int in_type, int tiles,
                        void* workspace, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, nullptr, batch, hq,
               hkv, sq, skv, kv_len, qscale, sm_scale, causal, window, sinks,
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
               static_cast<cudaStream_t>(stream)};
  return dispatch(BwdKernel::kDq, a, head_dim, in_type, tiles, workspace);
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
