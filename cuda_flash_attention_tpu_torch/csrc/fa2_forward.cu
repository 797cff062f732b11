// FlashAttention-2 forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/fa2_forward.py::fa2_forward_aligned
//   (bodies _fa2_fwd_kernel and _single_kv_attention).
// It computes O = softmax(scale * Q K^T) V and the natural-log logsumexp per
// query row, with causal masking from the top-left corner, a ragged KV tail
// (kv_len) and GQA (query head h reads KV head h / (Hq / Hkv)), a sliding
// window (row - col < window; without causal masking a recency band whose
// offset may be <= 0), attention sinks (col < sinks kept besides) and
// segment ids (sequence packing: a row keeps only the keys whose id is its
// own; seg_stride in csrc/hopper.cuh).
//
// Windows (JAX fa2_forward.py :646-718, the compact span grid): a Q tile
// walks only its live KV tiles, the sink tiles and then the tiles from its
// first row's oldest kept column to its diagonal (csrc/hopper.cuh KvWalk,
// one sequence that the producer's TMA loop and both consumers step
// through, so the mbarrier ring stays in step); a tile in both ranges is
// walked once.  A tile is masked element by element where it crosses the
// diagonal, the kv_len tail or a row's window edge, so under a window the
// cost is O(S * window).  A row that keeps no key (a band with an offset
// <= 0, causal rows past kv_len + window, a segment with no key) writes
// O = 0 and the lse the JAX forward gives on its own tiles for the call,
// which the caller passes (DeadRows).
//
// Segment ids: every tile is masked element by element.  The wgmma body
// takes each KV tile's ids by TMA into its K stage (held until the tile's
// softmax has read them) and each consumer thread its two rows' ids once;
// the fp32 body takes each KV tile's ids by cp.async with its K stage and
// the Q tile's once, into shared memory after the block's (FmaIds).
// Without ids neither the walk nor the masking moves.
//
// What bounds it on the H100: tensor-core FLOPs, and at D = 64 the exp2s
// as much.  Per query head, causal prefill does ~2*S^2*D FLOPs against
// ~6*S*D bytes in bf16 (Q and O, plus K and V shared by the two heads of a
// GQA group): ~S/3 FLOPs per byte, so the serving and training shapes (Hq
// 16, Hkv 8, S 1024-2048, D 64) sit above the card's ~295 FLOP/byte ridge,
// and the roofline there is the 989 TFLOP/s of bf16 wgmma.  Only wgmma,
// whose operands come from shared memory without passing through
// registers, reaches that rate, and only if no K/V load stalls it.  And a
// 128 x 128 score tile at D = 64 costs as many SM cycles of exp2 on the
// special-function unit (16 a cycle) as of wgmma, so the softmax has to
// run while the tensor cores work.  The 16-bit-tile body is built for
// that:
//   * one block per (128-row Q tile, b*Hq), 384 threads in three
//     warpgroups; Q tiles are handed out longest-causal-row first;
//   * warpgroup 0 is the producer: after `setmaxnreg.dec` one thread
//     streams 128-row K and V tiles with TMA (`cp.async.bulk.tensor`, 3-D
//     maps over [B*Hkv, Skv, D], so a box never crosses into the next head
//     and rows past Skv arrive as zeros) into two rings of shared-memory
//     stages (3 at D = 64, 2 at D = 128), K(t + 1) before V(t) as the
//     consumers take them.  Each stage has a "full" mbarrier armed with its
//     byte count and an "empty" one that the 8 consumer warps arrive on
//     once the wgmma that read the stage has completed;
//   * warpgroups 1 and 2 are the consumers, 64 Q rows each, with
//     `setmaxnreg.inc`.  Each stages its Q once: loaded in the input type,
//     scaled by sm_scale*log2(e) in fp32, rounded to the tile type and
//     stored with the 128-byte swizzle that TMA gives K and V;
//   * S = Q K^T is `wgmma.mma_async` m64n128k16 with both operands in
//     shared memory (K-major) and fp32 accumulators; the accumulators hold,
//     per warp, rows g and g+8 and columns 2t, 2t+1 of every 8-column
//     group, so the online softmax (fp32, exp2 domain) keeps m and l per
//     row with quad shuffles, and masks only on the diagonal and kv_len
//     tail tiles;
//   * O += P V is wgmma with A = P from registers (the S accumulators,
//     rounded to the tile type, are exactly the A fragments) and B = the V
//     tile read MN-major through the transpose bit; O stays fp32 in
//     registers and is divided by l once at the end;
//   * the softmax of tile t + 1 runs while P V(t) is on the tensor cores
//     (S(t + 1) is issued first and waited for with wait_group 1), and the
//     two consumers take turns to issue their products (named barriers),
//     so that one's softmax overlaps the other's wgmma.
// Head dims 32, 64, 128 and 256 (CFA_HEAD_DIMS: this library 64 and 128,
// csrc/fa2_forward_d32.cu and fa2_forward_d256.cu the others).  At D = 32 a
// 16-bit row is 64 bytes: the Q, K and V tiles take the 64-byte swizzle (in
// the tensor maps, the wgmma descriptors' layout type 2 and stage_q), so no
// column is padded, S is m64n128k16 over two k-steps and P V m64n32k16.  At
// D = 256 a ring stage holds 64 KV rows (Layout<D>::kTileN): two consumers'
// Q tiles (64 KB) and two stages of 128-row K and V tiles (256 KB) would not
// fit, and a consumer's O accumulator alone takes 128 fp32 registers a
// thread, beside which a 64-column S (32) and its P fragments (16) fit the
// 232 a consumer has; S is m64n64k16 and P V two m64n128k16 halves a k-step.
// The fp32 body keeps csrc/fma_block.cuh's block: two O columns a thread at
// D = 32, sixteen at D = 256 (one block of four warps an SM).
// fp32 inputs with 16-bit tiles: TMA copies bytes and cannot convert, so
// the wrapper casts K and V to the tile type before the launch (round to
// nearest even, the rounding the plain version applies too); Q is still
// rounded here after its scaling.
//
// fp32 tiles (tile code 0) run on the fp32 FMA units (no TF32), held to
// IEEE fp32, bound by their 67 TFLOP/s.  What stays from the first body
// is FA2's function and arithmetic: Q scaled by sm_scale * log2(e)
// once in fp32, exp2-domain online softmax with O divided by l once at the
// end (l == 0 guarded), causal loop to the diagonal with only the diagonal
// and kv_len tail tiles masked (masked P exactly 0), GQA, lse = m ln 2 +
// log l, longest causal rows first, each output element's P V summed over
// keys in order.  What changed is the block: csrc/fma_block.cuh's,
// shared with B10 (128 threads a block for one Q tile, 8 x 4 register tiles
// read with 128-bit loads, cp.async K/V rings, three blocks an SM at D =
// 64, two at D = 128), in place of 256 threads with 4 x 4 scalar tiles
// that staged K and V between two barriers.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "fma_block.cuh"  // the fp32 body's block; includes hopper.cuh

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (D 32 and 256
// each in their own library, so that nvcc compiles the widths in parallel).
#ifndef CFA_HEAD_DIMS
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif

namespace {

constexpr int kBlockM = 64;  // fp32 body: Q rows per block (csrc/fma_block.cuh)
constexpr int kBlockN = 64;  // fp32 body: KV rows per loop iteration
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr float kLn2 = 0.6931471805599453f;

// 16-bit tiles: the block's Q rows and its consumers' Q rows (the KV rows
// of a ring stage and a swizzle atom's columns are Layout<D>'s).
constexpr int kTileM = 128;
constexpr int kConsumerM = 64;
constexpr int kThreads = 384;
// Registers per thread after setmaxnreg: 128 x 40 + 256 x 232 = 64512 of
// the SM's 65536 (one block per SM).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// ---------------------------------------------------------------------------
// wgmma.  Operand lists of the 64- and 128-column fp32 accumulators.
// ---------------------------------------------------------------------------
#define CFA_R16                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CFA_ACC16(d) CFA_ACC8(d, 0), CFA_ACC8(d, 8)
// d[32] (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major).
#define CFA_WGMMA_SS_N64(TY)                                                 \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{" CFA_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                         \
      : CFA_ACC32(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d[64] (+)= A (64x16, shared, K-major) * B (16x128, shared, K-major).
#define CFA_WGMMA_SS_N128(TY)                                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{" CFA_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                         \
      : CFA_ACC64(d)                                                         \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))
// d += A (64x16, registers) * B (16xN, shared, MN-major: transpose bit).
#define CFA_WGMMA_RS_N32(TY)                                                 \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "            \
      "{" CFA_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC16(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define CFA_WGMMA_RS_N64(TY)                                                 \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{" CFA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC32(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))
#define CFA_WGMMA_RS_N128(TY)                                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{" CFA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"           \
      : CFA_ACC64(d)                                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// The two 16-bit tile types: packing two fp32 values (round to nearest
// even) and the two products with fp32 accumulation.
template <typename Tt>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void qk(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    CFA_WGMMA_SS_N128("bf16");
  }
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    CFA_WGMMA_SS_N64("bf16");
  }
  static __device__ __forceinline__ void pv(float (&d)[16], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N32("bf16");
  }
  static __device__ __forceinline__ void pv(float (&d)[32], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N64("bf16");
  }
  static __device__ __forceinline__ void pv(float (&d)[64], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N128("bf16");
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
  static __device__ __forceinline__ void qk(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    CFA_WGMMA_SS_N128("f16");
  }
  static __device__ __forceinline__ void qk(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    CFA_WGMMA_SS_N64("f16");
  }
  static __device__ __forceinline__ void pv(float (&d)[16], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N32("f16");
  }
  static __device__ __forceinline__ void pv(float (&d)[32], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N64("f16");
  }
  static __device__ __forceinline__ void pv(float (&d)[64], const uint32_t* a,
                                            uint64_t desc_b) {
    CFA_WGMMA_RS_N128("f16");
  }
};

// ---------------------------------------------------------------------------
// bf16 or fp16 tiles (Tt) on wgmma.  Shared memory, from a 1024-byte-aligned
// base: two consumers' Q tiles, then kStages K tiles, then kStages V tiles,
// then each K stage's segment ids and the mbarriers.  A tile of R rows is
// D / kBoxCols boxes of R rows x kRowBytes, each swizzled as TMA writes it:
// 128-byte rows (D >= 64) with the 128-byte swizzle (16-byte chunk c of row
// r at c ^ (r % 8)), or at D = 32 one box of 64-byte rows with the 64-byte
// swizzle (chunk c of row r at c ^ ((r / 2) % 4)); no column is padded.
// At D = 256 a ring stage holds 64 KV rows, not 128: the Q tiles (64 KB) and
// two stages of 128-row K and V tiles (256 KB) would not fit the SM's 227
// KB, and each consumer's O accumulator (128 fp32 registers a thread) leaves
// room for a 64-column S (32) and its P fragments (16), not a 128-column one.
// ---------------------------------------------------------------------------
template <int D>
struct Layout {
  static constexpr int kTileN = D > 128 ? 64 : 128;   // KV rows of a stage
  static constexpr int kBoxCols = D < 64 ? D : 64;     // columns of a box row
  static constexpr int kRowBytes = 2 * kBoxCols;       // 128, or 64 at D = 32
  static constexpr int kChunks = kRowBytes / 16;       // 16-byte chunks a box row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kAtom = 8 * kRowBytes;          // a swizzle atom's bytes
  static constexpr int kStages = D > 64 ? 2 : 3;
  static constexpr int kQBox = kConsumerM * kRowBytes;  // bytes of one Q box
  static constexpr int kKVBox = kTileN * kRowBytes;     // bytes of one K or V box
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSeg = kV + kStages * kKVBytes;  // K stage s's ids
  static constexpr int kBars = kSeg + kStages * kTileN * 4;
  // full and empty barriers of each K and V stage, and alignment slack.
  static constexpr int kSmem = kBars + 4 * 8 * kStages + 1024;
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");

  // Where 16-byte chunk c of row r of a box sits in that row.
  static __device__ __forceinline__ int chunk_at(int r, int c) {
    return kRowBytes == 128 ? c ^ (r % 8) : c ^ ((r / 2) % 4);
  }
  // A wgmma descriptor of this swizzle: 8-row groups one atom apart.
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
    return kRowBytes == 128 ? sw128_desc(addr, lbo, kAtom) : sw64_desc(addr, lbo, kAtom);
  }
};

// A consumer's 64 Q rows [row0, row0 + 64) of a [nrows, D] matrix, scaled
// by `scale` in fp32 and rounded to Tt, into the swizzled Q tile.  Rows
// past nrows are zero.
template <typename Tt, typename Tin, int D>
__device__ __forceinline__ void stage_q(unsigned char* dst, const Tin* src,
                                        int row0, int nrows, float scale,
                                        int tid) {
  using L = Layout<D>;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < kConsumerM * kChunks / 128; ++it) {
    const int i = tid + it * 128;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    float x[8];
    if (row0 + r < nrows) {
      load8(src + static_cast<size_t>(row0 + r) * D + c * 8, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    uint4 packed;
    packed.x = Tile<Tt>::pack(x[0] * scale, x[1] * scale);
    packed.y = Tile<Tt>::pack(x[2] * scale, x[3] * scale);
    packed.z = Tile<Tt>::pack(x[4] * scale, x[5] * scale);
    packed.w = Tile<Tt>::pack(x[6] * scale, x[7] * scale);
    const int box = c / L::kChunks;
    const int chunk = L::chunk_at(r, c % L::kChunks);
    *reinterpret_cast<uint4*>(dst + box * L::kQBox + r * L::kRowBytes +
                              chunk * 16) = packed;
  }
}

// exp2 on the special-function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue S = Q K^T (not waited for): D / 16 k-steps of 32 bytes, kRowBytes /
// 32 to a box, both operands K-major.
template <typename Tt, int D>
__device__ __forceinline__ void issue_qk(float (&s)[Layout<D>::kTileN / 2],
                                         uint32_t qs, uint32_t ks) {
  using L = Layout<D>;
  constexpr int kSteps = L::kRowBytes / 32;  // k-steps a box
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % kSteps) * 32;
    Tile<Tt>::qk(s, L::desc(qs + (kk / kSteps) * L::kQBox + off, 16),
                 L::desc(ks + (kk / kSteps) * L::kKVBox + off, 16), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (not waited for): k-step kk reads V rows [16 kk, 16 kk +
// 16), two 8-row groups an atom apart, MN-major; the boxes are kKVBox apart.
// At D = 256 each k-step is two n128 products, columns [0, 128) and [128,
// 256) (boxes 0-1 and 2-3), into the two halves of the accumulator.
template <typename Tt, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[Layout<D>::kTileN / 16][4],
                                         uint32_t vs) {
  using L = Layout<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kTileN / 16; ++kk) {
    const uint32_t v = vs + kk * 16 * L::kRowBytes;
    if constexpr (D > 128) {
      Tile<Tt>::pv(*reinterpret_cast<float(*)[64]>(&acc[0]), pa[kk], L::desc(v, L::kKVBox));
      Tile<Tt>::pv(*reinterpret_cast<float(*)[64]>(&acc[64]), pa[kk],
                   L::desc(v + 2 * L::kKVBox, L::kKVBox));
    } else {
      Tile<Tt>::pv(acc, pa[kk], L::desc(v, L::kKVBox));
    }
  }
  wgmma_commit();
}

// The lse of a row that keeps no key (its O is 0), as the JAX forward gives
// it on its own tiles for the call, dead_bq x dead_bk rows
// (kernels/common.py dead_row_lse): -inf where the row's Q tile walks no
// KV tile of a padded KV (skv) longer than one tile, else the mask value
// times ln 2.
struct DeadRows {
  int skv, causal, window, sinks, bq, bk;
  __device__ __forceinline__ float lse(int row) const {
    const int q0 = row / bq * bq;
    const int end = causal ? min(skv, q0 + bq) : skv;
    return skv / bk > 1 && KvWalk(q0 - window + 1, end, sinks, bk).n == 0
               ? -INFINITY
               : kMaskValue * kLn2;
  }
};

// The online softmax of one S tile in place (fp32, exp2 domain): with
// kMask, scores of columns at or past kv_len, (causal) past the row or
// outside its window and sinks take kMaskValue first.  Updates m and this
// thread's share of l, sets alpha = exp2(m_old - m_new) and leaves P in s,
// masked entries exactly 0.
// With segment ids (kSeg; kid: the K stage's ids) a column of another id
// than its row's (qid) is masked too.  Each combination is its own body,
// so a tile without ids (or without any mask) runs none of their code.
template <bool kMask, bool kSeg, int kTileN>
__device__ __forceinline__ void online_softmax(float (&s)[kTileN / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2], int k0,
                                               int row_a, int kv_len,
                                               int causal, int window,
                                               int sinks, int t4,
                                               const int* kid,
                                               const int (&qid)[2]) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + t4 * 2 + (e & 1);
        const int col = k0 + c;
        const int row = e < 2 ? row_a : row_a + 8;
        if (col >= kv_len || (causal && col > row) ||
            !in_window(row, col, window, sinks) ||
            (kSeg && kid[c] != qid[e >> 1])) {
          s[4 * j + e] = kMaskValue;
        }
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2_ftz(m_run[i] - m_new);
    m_run[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(s[4 * j + e] - m_run[e >> 1]);
      // Exact zero for masked entries (a row masked so far has m equal to
      // the mask value, where exp2 alone would give 1).
      if (kMask && s[4 * j + e] == kMaskValue) p = 0.f;
      rs[e >> 1] += p;
      s[4 * j + e] = p;
    }
  }
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// P in the tile type: the accumulators of column groups 2 kk and 2 kk + 1
// are exactly the register A fragment of k-step kk.
template <typename Tt, int kTileN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kTileN / 16][4],
                                       const float (&s)[kTileN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    pa[kk][0] = Tile<Tt>::pack(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = Tile<Tt>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = Tile<Tt>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = Tile<Tt>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <typename Tin, typename Tt, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa2_fwd_wgmma(const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const Tin* __restrict__ q, Tin* __restrict__ o,
              float* __restrict__ lse, const int* __restrict__ q_seg,
              const int* __restrict__ kv_seg, int hq, int hkv, int sq,
              int kv_len, float qscale, int causal, int window, int sinks,
              DeadRows dead) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  constexpr int kTileN = L::kTileN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_k = base + L::kBars;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  // Causal tiles near the end of the sequence carry the most KV tiles:
  // hand them out first so the short ones fill the tail of the grid.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  // The KV tiles the block walks: to the diagonal under causal masking,
  // from its first row's window (and the sink tiles).
  const int kv_end = causal ? min(kv_len, q0 + kTileM) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, sinks, kTileN);
  const int n_tiles = walk.n;

  if (threadIdx.x == 0) {
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
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&v_map))
                   : "memory");
      const int kv_head = b * hkv + hk;
      const int* kv_ids =
          kv_seg == nullptr ? nullptr : kv_seg + static_cast<size_t>(b) * seg_stride(dead.skv);
      // Walk step t of K or V into its ring (K with its tile's segment ids,
      // `ids`); the first pass over a ring finds every stage empty.
      auto load = [&](const CUtensorMap* map, uint32_t ring, uint32_t full,
                      uint32_t empty, int t, const int* ids) {
        const int st = t % kStages;
        mbar_wait(empty + 8 * st, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kKVBytes + (ids ? kTileN * 4 : 0));
#pragma unroll
        for (int box = 0; box < L::kBoxes; ++box) {
          tma_load_3d(ring + st * L::kKVBytes + box * L::kKVBox, map,
                      full + 8 * st, box * L::kBoxCols, walk.at(t) * kTileN,
                      kv_head);
        }
        if (ids) {
          tma_load_1d(base + L::kSeg + st * kTileN * 4, ids + walk.at(t) * kTileN,
                      kTileN * 4, full + 8 * st);
        }
      };
      // The consumers take K(t + 1) before V(t); so does the producer.
      if (n_tiles > 0) load(&k_map, base + L::kK, full_k, empty_k, 0, kv_ids);
      for (int t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
          load(&k_map, base + L::kK, full_k, empty_k, t + 1, kv_ids);
        }
        load(&v_map, base + L::kV, full_v, empty_v, t, nullptr);
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
    stage_q<Tt, Tin, D>(smem + c * L::kQBytes,
                        q + static_cast<size_t>(bh) * sq * D, qc0, sq, qscale,
                        tid);
    // Q's generic-proxy stores must be visible to wgmma (the async proxy)
    // and complete in all four warps before the first product.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    const uint32_t qs = base + c * L::kQBytes;

    const int row_a = qc0 + warp * 16 + g;
    // This thread's rows' segment ids (rows past sq read padding).
    const bool seg = q_seg != nullptr;
    int qid[2] = {0, 0};
    if (seg) {
      const int* ids = q_seg + static_cast<size_t>(b) * seg_stride(sq);
      qid[0] = ids[row_a];
      qid[1] = ids[row_a + 8];
    }
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float s[kTileN / 2];
    uint32_t pa[kTileN / 16][4];
    auto scores = [&](int t) {
      const int st = t % kStages;
      mbar_wait(full_k + 8 * st, (t / kStages) & 1);
      issue_qk<Tt, D>(s, qs, base + L::kK + st * L::kKVBytes);
    };
    auto softmax = [&](int t) {
      const int k0 = walk.at(t) * kTileN;
      const int* kid = seg ? reinterpret_cast<const int*>(
                                 smem + L::kSeg + (t % kStages) * kTileN * 4)
                           : nullptr;
      // Masked element by element: the kv_len tail, the diagonal, a tile
      // some row's window edge crosses, and every tile with segment ids.
      if (seg) {
        online_softmax<true, true, kTileN>(s, m_run, l_run, alpha, k0, row_a, kv_len,
                                   causal, window, sinks, t4, kid, qid);
      } else if ((k0 + kTileN > kv_len) || (causal && k0 + kTileN - 1 > qc0) ||
                 qc0 + kConsumerM - 1 - k0 >= window) {
        online_softmax<true, false, kTileN>(s, m_run, l_run, alpha, k0, row_a, kv_len,
                                    causal, window, sinks, t4, kid, qid);
      } else {
        online_softmax<false, false, kTileN>(s, m_run, l_run, alpha, k0, row_a, kv_len,
                                     causal, window, sinks, t4, kid, qid);
      }
    };

    // Tile t's P V runs on the tensor cores while the softmax of tile
    // t + 1 runs on the other units: S(t + 1) is issued before P V(t) and
    // waited for (wait_group 1) before it.  Every pass of the loop issues
    // the same two groups (the last tile's P V is peeled off), so ptxas
    // can pipeline them.
    //
    // The two consumers take turns to issue their products (named
    // barriers 3 and 4, 256 threads: one consumer waits, the other
    // arrives), so that one's softmax runs while the other's products hold
    // the tensor cores.  Consumer 0 has the first turn.
    auto take_turn = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
    };
    auto pass_turn = [&] {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
    };
    if (c == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    // A K or V stage is free once this warp's product that read it has
    // completed.
    auto release = [&](uint32_t empty, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
    };
    auto finish_pv = [&](int t) {
      wgmma_wait<0>();
      hold(acc);
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) hold(pa[kk]);
      release(empty_v, t);
    };
    // A K stage is free once S has read it; with segment ids once the
    // softmax has read its ids too.
    if (n_tiles > 0) {
      take_turn();
      scores(0);
      pass_turn();
      wgmma_wait<0>();
      hold(s);
      if (!seg) release(empty_k, 0);
      softmax(0);
      if (seg) release(empty_k, 0);
      pack_p<Tt, kTileN>(pa, s);
    }
    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int st = t % kStages;
      take_turn();
      scores(t + 1);
      mbar_wait(full_v + 8 * st, (t / kStages) & 1);
      issue_pv<Tt, D>(acc, pa, base + L::kV + st * L::kKVBytes);
      pass_turn();
      wgmma_wait<1>();
      hold(s);
      if (!seg) release(empty_k, t + 1);
      softmax(t + 1);
      if (seg) release(empty_k, t + 1);
      finish_pv(t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_p<Tt, kTileN>(pa, s);
    }
    if (n_tiles > 0) {
      const int t = n_tiles - 1;
      const int st = t % kStages;
      take_turn();
      mbar_wait(full_v + 8 * st, (t / kStages) & 1);
      issue_pv<Tt, D>(acc, pa, base + L::kV + st * L::kKVBytes);
      pass_turn();
      finish_pv(t);
    }
    const int row_b = row_a + 8;

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
        store2(op + static_cast<size_t>(row_a) * D + col, acc[4 * j] * inv_a,
               acc[4 * j + 1] * inv_a);
      }
      if (row_b < sq) {
        store2(op + static_cast<size_t>(row_b) * D + col,
               acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
      }
    }
    if (t4 == 0) {
      float* lp = lse + static_cast<size_t>(bh) * sq;
      if (row_a < sq) {
        lp[row_a] = l_run[0] == 0.f ? dead.lse(row_a)
                                    : m_run[0] * kLn2 + logf(l_run[0]);
      }
      if (row_b < sq) {
        lp[row_b] = l_run[1] == 0.f ? dead.lse(row_b)
                                    : m_run[1] * kLn2 + logf(l_run[1]);
      }
    }
  }
}

// Segment ids of the fp32 body, in shared memory after the block's own
// (FmaBlock<D>::kSmem, rounded up to 16 bytes): one row of kBlockN key ids
// per K stage, then the Q tile's kBlockM ids.
template <int D>
struct FmaIds {
  static constexpr int kOffset = (FmaBlock<D>::kSmem + 15) & ~15;
  static constexpr int kSmem =
      kOffset + 4 * (FmaBlock<D>::kKStages * kBlockN + kBlockM);
};

// ---------------------------------------------------------------------------
// fp32 tiles on the FMA units (tile code 0): the block of csrc/fma_block.cuh
// (thread layout, K and V rings, loads and the two products), with FA2's
// function and edges around it.  One block per (64-row Q tile, b * Hq);
// query head h reads KV head h / (Hq / Hkv).  blockIdx.x runs over the Q
// tiles from the last, so the longest causal rows start first.  SEG: with
// segment ids (their masking and ids held in registers would spill at
// three blocks an SM, D = 64, so that instantiation runs two).
// ---------------------------------------------------------------------------
template <int D, bool SEG>
__global__ void __launch_bounds__(kFmaThreads,
                                  SEG && FmaBlock<D>::kBlocksPerSm > 2
                                      ? 2
                                      : FmaBlock<D>::kBlocksPerSm)
fa2_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, const int* __restrict__ q_seg,
             const int* __restrict__ kv_seg, int hq, int hkv, int sq, int skv,
             int kv_len, float qscale, int causal, int window, int sinks,
             DeadRows dead) {
  using L = FmaBlock<D>;
  constexpr int DO = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const FmaStages<L> st(smem);
  const FmaThread th = fma_thread();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const size_t bh = blockIdx.y;
  const int b = blockIdx.y / hq;
  const int hk = (blockIdx.y - b * hq) / (hq / hkv);
  const float* kp = k + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  const float* vp = v + (static_cast<size_t>(b) * hkv + hk) * skv * D;
  // KV tiles to visit: to the diagonal under causal masking, from the
  // first row's window (and the sink tiles); walk step t is tile walk.at(t)
  // in ring stage t.
  const int kv_end = causal ? min(kv_len, q0 + kBlockM) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, sinks, kBlockN);
  const int n_kv = walk.n;
  constexpr bool seg = SEG;
  int* kid_ring = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(smem) +
                                         FmaIds<D>::kOffset);
  int* qid_s = kid_ring + L::kKStages * kBlockN;
  float* qs = st.q();
  // K tile t with (segment ids) its keys' ids, in K stage t.
  auto load_k = [&](int t) {
    fma_copy_tile<D, true>(st.k(t), kp, walk.at(t), skv);
    if (seg && threadIdx.x < kBlockN / 4) {
      cp_async16(smem_addr(kid_ring + (t % L::kKStages) * kBlockN + 4 * threadIdx.x),
                 kv_seg + static_cast<size_t>(b) * seg_stride(skv) +
                     walk.at(t) * kBlockN + 4 * threadIdx.x,
                 true);
    }
    cp_async_arrive(st.k_bar(t));
  };
  auto load_v = [&](int t) {
    fma_load_tile<D, false>(st.v(t), st.v_bar(t), vp, walk.at(t), skv);
  };

  if (threadIdx.x == 0) st.init();
  // Q scaled by sm_scale * log2(e) once, in fp32.
  fma_load_q<D>(qs, q + bh * sq * D, q0, sq, qscale);
  if (seg && threadIdx.x < kBlockM) {
    qid_s[threadIdx.x] = q_seg[static_cast<size_t>(b) * seg_stride(sq) + q0 + threadIdx.x];
  }
  __syncthreads();
  for (int t = 0; t < L::kKStages && t < n_kv; ++t) load_k(t);
  for (int t = 0; t < L::kVStages && t < n_kv; ++t) load_v(t);

  float m_run[8], l_run[8], acc[8][DO];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = walk.at(t) * kBlockN;
    st.wait_k(t);
    float s[8][4];
    fma_scores<D>(qs, st.k(t), th, s);
    float* ps = st.k(t);
    __syncthreads();  // K(t) is read: P takes its stage

    // Online softmax in the exp2 domain; only the diagonal, kv_len tail
    // and window-edge tiles, and every tile with segment ids, are masked
    // (masked P exactly 0).  l_run is this thread's share of the row sum,
    // added across the row once at the end.
    const bool need_mask = seg || (k0 + kBlockN > kv_len) ||
                           (causal && k0 + kBlockN - 1 > q0) ||
                           q0 + kBlockM - 1 - k0 >= window;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + th.ty + 8 * r;
      if (need_mask) {
        const int* kid = kid_ring + (t % L::kKStages) * kBlockN;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + th.tx + 16 * j;
          if (col >= kv_len || (causal && col > row) ||
              !in_window(row, col, window, sinks) ||
              (seg && kid[th.tx + 16 * j] != qid_s[th.ty + 8 * r])) {
            s[r][j] = kMaskValue;
          }
        }
      }
      const float mx = fma_row_max(
          fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[r][j] - m_new);
        if (need_mask && s[r][j] == kMaskValue) p = 0.f;
        rs += p;
        fma_store_p(ps, th, r, j, p);
      }
      l_run[r] = l_run[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < DO; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // P is in place
    st.wait_v(t);
    fma_pv<D>(ps, st.v(t), th, acc);
    __syncthreads();  // K(t), V(t) and P are read: refill
    if (t + L::kKStages < n_kv) load_k(t + L::kKStages);
    if (t + L::kVStages < n_kv) load_v(t + L::kVStages);
  }

  // O = acc / l (l == 0 guarded) and lse = m ln 2 + log l.
  float inv[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    l[r] = fma_row_sum(l_run[r]);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
  fma_store_o<D>(o + bh * sq * D, q0, sq, th, acc, inv);
  if (th.tx == 0) {
    float* lp = lse + bh * sq;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + th.ty + 8 * r;
      if (row < sq) {
        lp[row] = l[r] == 0.f ? dead.lse(row) : m_run[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

// Everything a launch takes besides its tensors' types.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  const int* q_seg;
  const int* kv_seg;
  int batch, hq, hkv, sq, skv, kv_len;
  float qscale;
  int causal, window, sinks, dead_bq, dead_bk;
  cudaStream_t stream;

  DeadRows dead() const {
    return DeadRows{skv, causal, window, sinks, dead_bq, dead_bk};
  }
};

template <int D, bool SEG>
cudaError_t launch_fp32_seg(const Args& a) {
  constexpr int kSmem = SEG ? FmaIds<D>::kSmem : FmaBlock<D>::kSmem;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(fa2_fwd_fp32<D, SEG>, kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch * a.hq);
  fa2_fwd_fp32<D, SEG><<<grid, kFmaThreads, kSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, a.skv,
      a.kv_len, a.qscale, a.causal, a.window, a.sinks, a.dead());
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fp32(const Args& a) {
  return a.q_seg != nullptr ? launch_fp32_seg<D, true>(a)
                            : launch_fp32_seg<D, false>(a);
}
// A 3-D map over a contiguous 16-bit [rows, skv, d] K or V: boxes of
// Layout<D>::kTileN rows x kBoxCols columns with the 128-byte swizzle (the
// 64-byte one at D = 32, whose rows are 64 bytes); reads past skv give
// zeros.
template <int D>
int kv_map(CUtensorMap* map, const void* ptr, int tiles, int rows, int skv) {
  using L = Layout<D>;
  constexpr int d = D;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(skv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(skv) * d * 2};
  const cuuint32_t box[3] = {L::kBoxCols, L::kTileN, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, tiles == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename Tin, typename Tt, int D>
int launch_wgmma(const Args& a, int tiles) {
  CUtensorMap k_map, v_map;
  int err = kv_map<D>(&k_map, a.k, tiles, a.batch * a.hkv, a.skv);
  if (err == 0) err = kv_map<D>(&v_map, a.v, tiles, a.batch * a.hkv, a.skv);
  if (err != 0) return err;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t cerr = set_smem_once(fa2_fwd_wgmma<Tin, Tt, D>,
                                   Layout<D>::kSmem, smem_set);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((a.sq + kTileM - 1) / kTileM, a.batch * a.hq);
  fa2_fwd_wgmma<Tin, Tt, D><<<grid, kThreads, Layout<D>::kSmem, a.stream>>>(
      k_map, v_map, static_cast<const Tin*>(a.q), static_cast<Tin*>(a.o),
      static_cast<float*>(a.lse), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq,
      a.kv_len, a.qscale, a.causal, a.window, a.sinks, a.dead());
  return cudaGetLastError();
}

template <typename Tin, int D>
int launch_tiles(int tiles, const Args& a) {
  return tiles == 1 ? launch_wgmma<Tin, __nv_bfloat16, D>(a, tiles)
                    : launch_wgmma<Tin, __half, D>(a, tiles);
}

}  // namespace

extern "C" {

// q [batch, hq, sq, head_dim]; k, v [batch, hkv, skv, head_dim]; o like q;
// lse [batch, hq, sq] fp32.  All contiguous and 16-byte aligned.  q_seg
// [batch, seg_stride(sq)] and kv_seg [batch, seg_stride(skv)] int32
// segment ids, or both null.  in_bf16: q and o are bf16 (else fp32).
// tiles: 0 fp32 on the FMA units (k and v fp32 too), 1 bf16 or 2 fp16 on
// the tensor cores, with k and v already in the tile type.  qscale =
// sm_scale * log2(e).  window: a row keeps keys with row - col < window
// (kNoWindow: no window; without causal a band, any value); sinks:
// columns below it are kept besides.  dead_bq x dead_bk: the tiles whose
// walk sets a dead row's lse.  Returns a cudaError_t, or an error of the
// tensor-map step (cfa_fa2_forward_error_string names it).
int cfa_fa2_forward(const void* q, const void* k, const void* v, void* o,
                    void* lse, const void* q_seg, const void* kv_seg,
                    int batch, int hq, int hkv, int sq, int skv, int head_dim,
                    int kv_len, float qscale, int causal, int window,
                    int sinks, int dead_bq, int dead_bk, int in_bf16,
                    int tiles, void* stream) {
  if ((q_seg == nullptr) != (kv_seg == nullptr) || dead_bq < 1 || dead_bk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, lse, static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg), batch, hq, hkv, sq, skv,
               kv_len, qscale, causal, window, sinks, dead_bq, dead_bk,
               static_cast<cudaStream_t>(stream)};
  // This library's head dims (CFA_HEAD_DIMS; csrc/fa2_forward_d32.cu and
  // fa2_forward_d256.cu build the others).
#define CFA_CASE(D)                                                          \
  if (head_dim == D) {                                                       \
    if (tiles == 1 || tiles == 2) {                                          \
      return in_bf16 ? launch_tiles<__nv_bfloat16, D>(tiles, a)             \
                     : launch_tiles<float, D>(tiles, a);                     \
    }                                                                        \
    if (tiles == 0 && !in_bf16) return launch_fp32<D>(a);                    \
  }
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_fa2_forward_error_string(int err) {
  if (err == kErrNoEncoder) {
    return "libcuda.so.1 has no cuTensorMapEncodeTiled";
  }
  if (err == kErrEncode) {
    return "cuTensorMapEncodeTiled refused the K/V tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
