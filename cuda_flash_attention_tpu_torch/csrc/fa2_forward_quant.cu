// FlashAttention-2 forward over quantized K/V for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/fa2_forward_quant.py::
//   fa2_forward_quant_aligned (body _fa2_fwd_quant_kernel).
// K and V are stored as int8, fp8 e4m3 / e5m2 [B, Hkv, S, D] or packed int4
// [B, Hkv, S, D/2] (split-half: byte j holds element j in the low nibble and
// element j + D/2 in the high one), each row with one fp32 scale
// ([B, Hkv, S], contiguous).  The kernel computes what the TPU kernel does:
//   Q is scaled by sm_scale * log2(e) in fp32 and rounded to the compute
//   type; K is converted to it with no scale; S = Q K^T in fp32, then
//   S *= k_scale[col] and the causal / KV-tail mask; an online exp2 softmax
//   in fp32; P * v_scale[col] is rounded to the compute type before P V;
//   O = acc / l (l == 0 guarded), lse = m ln2 + log(l).
// GQA is native: query head h reads KV head h / (Hq / Hkv).  A sliding
// window (row - col < window; without causal masking a recency band whose
// offset may be <= 0; JAX :91-92, :193-207) and segment ids (a row keeps
// only the keys of its own id; JAX :223-260) as the TPU kernel takes them;
// no sinks, which it has none of.  Both bodies walk only the KV tiles
// some row of the Q tile keeps (csrc/hopper.cuh KvWalk, one sequence for
// the producer, the converters and the consumers of the wgmma body) and
// mask element by element the tiles a window edge, the diagonal or the
// kv_len tail crosses, and every tile with segment ids.  A row that keeps
// no key writes O = 0 and the lse the JAX kernel gives it on its own tiles
// (QuantDead).
//
// What bounds it on the H100: tensor-core operations at the prefill shapes
// (B4 Hq16 Hkv8 S2048 D64 causal does ~2.2e11 FLOPs against ~25 MB moved),
// as B1; the point of 1-byte K/V is the bytes of long contexts and of the
// cache, which this kernel reads at a quarter (int4: an eighth) of fp32's.
// The function rules out the fp8 tensor-core product (Q and P * v_scale are
// rounded to bf16), so the products stay bf16 x bf16 into fp32, and every
// stored element has to become bf16 in shared memory first: wgmma reads its
// B operand only from there in the operand type, and TMA copies bytes
// without widening them.  int8, int4, e4m3 and e5m2 are all exact in bf16.
//
// bf16 compute, B1's design (csrc/fa2_forward.cu) with a conversion stage:
//   * one block per (128-row Q tile, b * Hq), longest causal tiles first,
//     384 threads: two consumer warpgroups of 64 Q rows each after
//     `setmaxnreg.inc` and a producer warpgroup after `setmaxnreg.dec`;
//   * one producer thread streams the stored-width K and V tiles (128 rows)
//     by TMA (3-D byte maps over [B * Hkv, Skv, row bytes]; rows past Skv
//     arrive as zeros, a finite code in every storage) into a ring of byte
//     stages on "full" mbarriers, in the order the consumers take them
//     (K(t + 1) before V(t));
//   * all four producer warps convert each landed byte stage once, into the
//     bf16 K or V ring: 128-byte-swizzled, exactly the layout TMA writes for
//     B1, so B1's wgmma descriptors and consumer loop apply unchanged.  int8
//     and int4 go by the 2^23 magic number (csrc/paged_kv.cuh), fp8 by the
//     card's exact fp8x2 conversion, each float packed to bf16 (exact).
//     With K(t) they store tile t's K and V scales beside the bf16 K stage
//     (plain loads: no alignment of Skv needed), then `fence.proxy.async`
//     (wgmma reads the stage through the async proxy) and the stage's full
//     barrier; a named barrier among the four warps frees the byte stage for
//     the next TMA load;
//   * the consumers run B1's loop: S = Q K^T by wgmma; after its wait, S *=
//     k_scale[col], the mask (kMaskValue, P exactly 0 where masked), the
//     exp2 online softmax in fp32, P *= v_scale[col], P rounded to bf16 into
//     A fragments, P V by wgmma against the bf16 V stage.  A K stage (and
//     its scales) is released after that softmax; the two consumers take
//     turns to issue their products.
// Against the earlier mma.sync body (128 threads per 64-row tile, K/V
// copied between two barriers, each of the four warps converting every
// element of both tiles for itself, int8 by I2F): each element is converted
// once a block, by warps that run beside the tensor cores.
//
// fp32 compute runs on the fp32 FMA units, held to IEEE fp32, on the FMA
// block of B1's fp32 body (csrc/fma_block.cuh: 128 threads per 64-row Q
// tile, 8 x 4 register tiles read with swizzled float4 loads, P over the K
// stage just read), fed by the stored-width ring of csrc/paged_kv.cuh
// (FmaRaw: 64-row K/V tiles and their scales by cp.async, each landed tile
// decoded once into the block's fp32 K and V stages, V swizzled as K).  Q is
// scaled by sm_scale * log2(e) in fp32, S summed over d in order, P V over
// the tile's keys in order, exp2 softmax; K's scale on S's columns and V's on
// P as above.
//
// Head dims 32, 64, 128 and 256 (CFA_HEAD_DIMS: this library 64 and 128,
// csrc/fa2_forward_quant_d32.cu and _d256.cu the others).  The bf16 body
// takes B1's designs for them (csrc/fa2_forward.cu Layout): at D = 32 a
// bf16 row is 64 bytes, so Q and the K/V stages are one box of 64-byte
// rows with the 64-byte swizzle (the converters write that layout, the
// wgmma descriptors read it), S is m64n128k16 over two k-steps and P V
// m64n32k16; an int4 row is then 16 bytes, the byte map's least box width.
// At D = 256 a stage holds 64 KV rows (Layout::kTileN): two consumers' Q
// tiles (64 KB) and two stages of 64-row bf16 K and V (128 KB) leave room
// for two byte stages (32 KB at one byte an element), and a consumer's O
// accumulator (128 fp32 registers a thread) leaves room for a 64-column S
// (32) and its P fragments (16): S is m64n64k16 and P V two m64n128k16
// halves a k-step.  The fp32 body takes D = 32 and 256 on the FMA block as
// it is (FmaRaw: 64-float slots at D = 32; at D = 256 the three fp32 tiles
// take 192 KB and leave one byte stage at one byte an element, two for
// int4, so a tile's decode waits for its load).  A dead row's lse is
// QuantDead's at every head dim: it follows the JAX kernel's tiles, not
// the port's.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "paged_kv.cuh"  // storage types and decodes; the FMA block and its ring

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (D 32 and 256
// each in their own library, so that nvcc compiles the widths in parallel).
#ifndef CFA_HEAD_DIMS
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif

namespace {

constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr float kLn2 = 0.6931471805599453f;

// bf16 compute: the block's Q rows and its consumers' Q rows (the KV rows of
// a stage and a box's columns are Layout's).
constexpr int kTileM = 128;
constexpr int kConsumerM = 64;
constexpr int kThreads = 384;
// Registers per thread after setmaxnreg: 128 x 40 + 256 x 232 = 64512, the
// 168 a thread that 384 threads start with (one block per SM).  The
// converters keep one 16-byte piece and its 8 bf16 pairs live at a time.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The lse of a row that keeps no key (its O is 0), as the JAX kernel gives
// it on its own tiles (bq x bk, the call's block_q and block_k fitted to the
// padded lengths): -inf where the row's Q tile runs no KV tile (its m never
// leaves -inf), else the mask value times ln 2.  Unlike B1's dead rows
// (csrc/fa2_forward.cu DeadRows) there is no exception for a KV of one
// tile: the quantized kernel has no one-tile body.  kernels/common.py
// dead_row_lse(single_tile_body=False) is its twin.
struct QuantDead {
  int skv, causal, window, bq, bk;
  __device__ __forceinline__ float lse(int row) const {
    const int q0 = row / bq * bq;
    const int end = causal ? min(skv, q0 + bq) : skv;
    return KvWalk(q0 - window + 1, end, 0, bk).n == 0 ? -INFINITY : kMaskValue * kLn2;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// wgmma (bf16, fp32 accumulators).  Operand lists of the 32-column
// accumulator (D = 32's P V; the 64- and 128-column ones are hopper.cuh's).
// ---------------------------------------------------------------------------
#define CFA_R16                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define CFA_ACC16(d) CFA_ACC8(d, 0), CFA_ACC8(d, 8)
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

// d[32] (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major).
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" CFA_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CFA_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A (64x16, registers) * B (16xN, shared, MN-major: transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" CFA_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : CFA_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" CFA_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CFA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" CFA_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CFA_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Shared memory of the bf16 body, from a 1024-byte-aligned base: the two
// consumers' Q tiles, kStages bf16 K tiles, kStages bf16 V tiles (a tile of
// R rows is D / kBoxCols boxes of R rows x kRowBytes, swizzled as TMA writes
// B1's: 128-byte rows (D >= 64) with the 128-byte swizzle, 16-byte chunk c
// of row r at c ^ (r % 8), or at D = 32 one box of 64-byte rows with the
// 64-byte swizzle, chunk c of row r at c ^ ((r / 2) % 4)), kRawStages
// stored tiles (rows of kRow bytes, as TMA writes them unswizzled), each K
// stage's scales ([kStages][K, V][kTileN] fp32) and segment ids ([kStages]
// [kTileN] int32), then the mbarriers: full and empty of each K and V
// stage, full of each byte stage.  D 128: 32 + 128 + 48 + 3 KB; D 256:
// 64 + 128 + 32 (int8) + 1.5 KB.
template <typename Tc, int D>
struct Layout {
  static constexpr int kTileN = D > 128 ? 64 : 128;   // KV rows of a stage
  static constexpr int kBoxCols = D < 64 ? D : 64;     // columns of a box row
  static constexpr int kRowBytes = 2 * kBoxCols;       // 128, or 64 at D = 32
  static constexpr int kChunks = kRowBytes / 16;       // 16-byte chunks a box row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kAtom = 8 * kRowBytes;          // a swizzle atom's bytes
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kRawStages = D <= 64 ? 4 : D <= 128 ? 3 : 2;
  static constexpr int kRow = kRowBytesOf<Tc, D>;
  static constexpr int kRawTile = kTileN * kRow;
  static constexpr int kQBox = kConsumerM * kRowBytes;
  static constexpr int kKVBox = kTileN * kRowBytes;
  static constexpr int kQBytes = kQBox * kBoxes;
  static constexpr int kKVBytes = kKVBox * kBoxes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kRaw = kV + kStages * kKVBytes;
  static constexpr int kScl = kRaw + kRawStages * kRawTile;
  static constexpr int kSid = kScl + kStages * 2 * kTileN * 4;
  static constexpr int kBars = kSid + kStages * kTileN * 4;
  static constexpr int kSmem = kBars + 8 * (4 * kStages + kRawStages) + 1024;
  static_assert(kRawTile % 1024 == 0, "byte stages keep 1024-byte alignment");
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
// by `scale` in fp32 and rounded to bf16, into the swizzled Q tile.  Rows
// past nrows are zero.
template <typename Tin, int D, typename L>
__device__ __forceinline__ void stage_q(unsigned char* dst, const Tin* src,
                                        int row0, int nrows, float scale,
                                        int tid) {
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
    const int chunk = L::chunk_at(r, c % L::kChunks);
    *reinterpret_cast<uint4*>(dst + (c / L::kChunks) * L::kQBox + r * L::kRowBytes +
                              chunk * 16) =
        make_uint4(pack_bf16(x[0] * scale, x[1] * scale),
                   pack_bf16(x[2] * scale, x[3] * scale),
                   pack_bf16(x[4] * scale, x[5] * scale),
                   pack_bf16(x[6] * scale, x[7] * scale));
  }
}

// One landed byte stage (kTileN stored rows) converted into a bf16 stage of
// the K or V ring (swizzled as TMA writes B1's): thread `tid` of the 128
// producer threads, one 16-byte piece at a time.  put's c is a 16-byte
// (8-element) chunk of the whole row.
template <typename Tc, int D, typename L>
__device__ __forceinline__ void convert_tile(unsigned char* dst,
                                             const unsigned char* src, int tid) {
  constexpr int kVec = L::kRow / 16;
  auto put = [&](int r, int c, uint32_t a, uint32_t b, uint32_t x, uint32_t y) {
    *reinterpret_cast<uint4*>(dst + (c / L::kChunks) * L::kKVBox + r * L::kRowBytes +
                              (L::chunk_at(r, c % L::kChunks) << 4)) =
        make_uint4(a, b, x, y);
  };
#pragma unroll 1
  for (int i = tid; i < L::kTileN * kVec; i += 128) {
    const int r = i / kVec;
    const int cb = (i - r * kVec) * 16;  // stored byte of the row
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * L::kRow + cb);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (kPacked<Tc>) {
      // Byte j of the row: element j (low nibble) and j + D / 2 (high).
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float l4[4], h4[4];
        int4x8_to_float(w[k], l4, h4);
        lo[2 * k] = pack_bf16(l4[0], l4[1]);
        lo[2 * k + 1] = pack_bf16(l4[2], l4[3]);
        hi[2 * k] = pack_bf16(h4[0], h4[1]);
        hi[2 * k + 1] = pack_bf16(h4[2], h4[3]);
      }
      put(r, cb / 8, lo[0], lo[1], lo[2], lo[3]);
      put(r, cb / 8 + 1, lo[4], lo[5], lo[6], lo[7]);
      put(r, (D / 2 + cb) / 8, hi[0], hi[1], hi[2], hi[3]);
      put(r, (D / 2 + cb) / 8 + 1, hi[4], hi[5], hi[6], hi[7]);
    } else {
      uint32_t o[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[4];
        decode4<Tc>(w[k], f);
        o[2 * k] = pack_bf16(f[0], f[1]);
        o[2 * k + 1] = pack_bf16(f[2], f[3]);
      }
      put(r, cb / 8, o[0], o[1], o[2], o[3]);
      put(r, cb / 8 + 1, o[4], o[5], o[6], o[7]);
    }
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
template <typename L, int D>
__device__ __forceinline__ void issue_qk(float (&s)[L::kTileN / 2], uint32_t qs,
                                         uint32_t ks) {
  constexpr int kSteps = L::kRowBytes / 32;  // k-steps a box
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % kSteps) * 32;
    wgmma_qk(s, L::desc(qs + (kk / kSteps) * L::kQBox + off, 16),
             L::desc(ks + (kk / kSteps) * L::kKVBox + off, 16), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (not waited for): k-step kk reads V rows [16 kk, 16 kk +
// 16), two 8-row groups an atom apart, MN-major; the boxes are kKVBox
// apart.  At D = 256 each k-step is two n128 products, columns [0, 128)
// and [128, 256) (boxes 0-1 and 2-3), into the two halves of the
// accumulator.
template <typename L, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[L::kTileN / 16][4],
                                         uint32_t vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kTileN / 16; ++kk) {
    const uint32_t v = vs + kk * 16 * L::kRowBytes;
    if constexpr (D > 128) {
      wgmma_pv(*reinterpret_cast<float(*)[64]>(&acc[0]), pa[kk], L::desc(v, L::kKVBox));
      wgmma_pv(*reinterpret_cast<float(*)[64]>(&acc[64]), pa[kk],
               L::desc(v + 2 * L::kKVBox, L::kKVBox));
    } else {
      wgmma_pv(acc, pa[kk], L::desc(v, L::kKVBox));
    }
  }
  wgmma_commit();
}

// The online softmax of one S tile in place (fp32, exp2 domain), B7's: S
// times K's scale of its column first; with kMask, scores of columns at or
// past kv_len, (causal) past the row or outside its window take kMaskValue,
// and with kSeg also those whose id (kid, the stage's ids) is not the row's
// (qid).  Updates m and this thread's share of l, sets alpha =
// exp2(m_old - m_new) and leaves P times V's scale of its column in s,
// masked entries exactly 0.  `sc` holds the tile's K scales, then its V
// scales.
template <bool kMask, bool kSeg, int kTileN>
__device__ __forceinline__ void quant_softmax(float (&s)[kTileN / 2], const float* sc,
                                              float (&m_run)[2], float (&l_run)[2],
                                              float (&alpha)[2], int k0, int row_a,
                                              int kv_len, int causal, int window, int t4,
                                              const int* kid, const int (&qid)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const float2 kc = *reinterpret_cast<const float2*>(sc + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] *= (e & 1) ? kc.y : kc.x;
      if (kMask) {
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_a + 8;
        if (col >= kv_len || (causal && col > row) || row - col >= window ||
            (kSeg && kid[col - k0] != qid[e >> 1])) {
          s[4 * j + e] = kMaskValue;
        }
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
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
    const float2 vc = *reinterpret_cast<const float2*>(sc + kTileN + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(s[4 * j + e] - m_run[e >> 1]);
      // Exact zero for masked entries (a row masked so far has m equal to
      // the mask value, where exp2 alone would give 1).
      if (kMask && s[4 * j + e] == kMaskValue) p = 0.f;
      rs[e >> 1] += p;
      s[4 * j + e] = p * ((e & 1) ? vc.y : vc.x);  // rounded to bf16 in pack_p
    }
  }
  l_run[0] = l_run[0] * alpha[0] + rs[0];
  l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// P * v_scale in bf16: the accumulators of column groups 2 kk and 2 kk + 1
// are exactly the register A fragment of k-step kk.
template <int kTileN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kTileN / 16][4],
                                       const float (&s)[kTileN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kTileN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Tile t of job j in the order the consumers take K and V: K(0), then for
// each t, K(t + 1) (if any) and V(t).  Sets is_k.
__device__ __forceinline__ int job_tile(int j, int n_tiles, bool& is_k) {
  if (j == 0) {
    is_k = true;
    return 0;
  }
  if (j == 2 * n_tiles - 1) {
    is_k = false;
    return n_tiles - 1;
  }
  const int t = (j - 1) >> 1;
  is_k = ((j - 1) & 1) == 0;
  return is_k ? t + 1 : t;
}

template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa2_fwd_quant_wgmma(const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const Tq* __restrict__ q, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, Tq* __restrict__ o,
                    float* __restrict__ lse, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, int hq, int hkv, int sq, int skv,
                    int kv_len, float qscale, int causal, int window, QuantDead dead) {
  using L = Layout<Tc, D>;
  constexpr int kStages = L::kStages;
  constexpr int kRawStages = L::kRawStages;
  constexpr int kTileN = L::kTileN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  float* scl = reinterpret_cast<float*>(smem + L::kScl);
  int* sid = reinterpret_cast<int*>(smem + L::kSid);
  const uint32_t full_k = base + L::kBars;  // stage s at + 8 s
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t full_raw = empty_v + 8 * kStages;

  // Causal tiles near the end of the sequence carry the most KV tiles:
  // hand them out first so the short ones fill the tail of the grid.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  // The KV tiles the block walks: to the diagonal under causal masking,
  // from its first row's window; walk step t is tile walk.at(t).
  const int kv_end = causal ? min(kv_len, q0 + kTileM) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, 0, kTileN);
  const int n_tiles = walk.n;
  const bool seg = q_seg != nullptr;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 4);  // one arrival per producer warp
      mbar_init(full_v + 8 * s, 4);
      mbar_init(empty_k + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(empty_v + 8 * s, 8);
    }
#pragma unroll
    for (int s = 0; s < kRawStages; ++s) mbar_init(full_raw + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: thread 0 keeps the byte ring full; all four warps convert.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tid = threadIdx.x;
    const int kv_head = b * hkv + hk;
    const int n_jobs = 2 * n_tiles;
    auto issue = [&](int j) {
      bool is_k;
      const int t = job_tile(j, n_tiles, is_k);
      const int rs = j % kRawStages;
      mbar_expect_tx(full_raw + 8 * rs, L::kRawTile);
      tma_load_3d(base + L::kRaw + rs * L::kRawTile, is_k ? &k_map : &v_map,
                  full_raw + 8 * rs, 0, walk.at(t) * kTileN, kv_head);
    };
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&k_map))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&v_map))
                   : "memory");
      for (int j = 0; j < kRawStages && j < n_jobs; ++j) issue(j);
    }
    const size_t scale0 = static_cast<size_t>(kv_head) * skv;
    for (int j = 0; j < n_jobs; ++j) {
      bool is_k;
      const int t = job_tile(j, n_tiles, is_k);
      const int st = t % kStages;
      // A K job carries tile t's K and V scales (and segment ids), one row
      // per thread (of the first kTileN).
      float ksv = 0.f, vsv = 0.f;
      int idv = 0;
      const int row = walk.at(t) * kTileN + tid;
      const bool row_thread = kTileN == 128 || tid < kTileN;
      if (is_k && row_thread && row < skv) {
        ksv = k_scales[scale0 + row];
        vsv = v_scales[scale0 + row];
        if (seg) idv = kv_seg[static_cast<size_t>(b) * seg_stride(skv) + row];
      }
      // The bf16 stage is free once the consumers released it (the first
      // pass finds every stage empty), and the byte stage has landed.
      mbar_wait((is_k ? empty_k : empty_v) + 8 * st, ((t / kStages) & 1) ^ 1);
      const int rs = j % kRawStages;
      mbar_wait(full_raw + 8 * rs, (j / kRawStages) & 1);
      convert_tile<Tc, D, L>(smem + (is_k ? L::kK : L::kV) + st * L::kKVBytes,
                             smem + L::kRaw + rs * L::kRawTile, tid);
      if (is_k && row_thread) {
        scl[st * 2 * kTileN + tid] = ksv;
        scl[st * 2 * kTileN + kTileN + tid] = vsv;
        sid[st * kTileN + tid] = idv;
      }
      // The converted stage is read by wgmma, through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive((is_k ? full_k : full_v) + 8 * st);
      // Byte stage rs is read by all four warps: refill it.
      asm volatile("bar.sync 5, 128;\n" ::: "memory");
      if (tid == 0 && j + kRawStages < n_jobs) issue(j + kRawStages);
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
    stage_q<Tq, D, L>(smem + c * L::kQBytes, q + static_cast<size_t>(bh) * sq * D,
                      qc0, sq, qscale, tid);
    // Q's generic-proxy stores must be visible to wgmma (the async proxy)
    // and complete in all four warps before the first product.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
    const uint32_t qs = base + c * L::kQBytes;

    const int row_a = qc0 + warp * 16 + g;
    // This thread's rows' segment ids (rows past sq read padding).
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
      issue_qk<L, D>(s, qs, base + L::kK + st * L::kKVBytes);
    };
    // A K or V stage is free once this warp's product that read it has
    // completed (and, for K, its scales have been read).
    auto release = [&](uint32_t empty, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (t % kStages));
    };
    auto softmax = [&](int t) {
      const int k0 = walk.at(t) * kTileN;
      const float* sc = scl + (t % kStages) * 2 * kTileN;
      const int* kid = sid + (t % kStages) * kTileN;
      // Masked element by element: the kv_len tail, the diagonal, a tile
      // some row's window edge crosses, and every tile with segment ids.
      if (seg) {
        quant_softmax<true, true, kTileN>(s, sc, m_run, l_run, alpha, k0, row_a, kv_len, causal,
                                  window, t4, kid, qid);
      } else if ((k0 + kTileN > kv_len) || (causal && k0 + kTileN - 1 > qc0) ||
                 qc0 + kConsumerM - 1 - k0 >= window) {
        quant_softmax<true, false, kTileN>(s, sc, m_run, l_run, alpha, k0, row_a, kv_len, causal,
                                   window, t4, kid, qid);
      } else {
        quant_softmax<false, false, kTileN>(s, sc, m_run, l_run, alpha, k0, row_a, kv_len, causal,
                                    window, t4, kid, qid);
      }
      release(empty_k, t);
    };

    // B1's schedule: tile t's P V runs on the tensor cores while the
    // softmax of tile t + 1 runs on the other units (S(t + 1) is issued
    // before P V(t) and waited for with wait_group 1), every pass issuing
    // the same two groups; the two consumers take turns to issue their
    // products (named barriers 3 and 4), consumer 0 first.
    auto take_turn = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
    };
    auto pass_turn = [&] {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
    };
    if (c == 0) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    auto finish_pv = [&](int t) {
      wgmma_wait<0>();
      hold(acc);
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) hold(pa[kk]);
      release(empty_v, t);
    };
    if (n_tiles > 0) {
      take_turn();
      scores(0);
      pass_turn();
      wgmma_wait<0>();
      hold(s);
      softmax(0);
      pack_p<kTileN>(pa, s);
    }
    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int st = t % kStages;
      take_turn();
      scores(t + 1);
      mbar_wait(full_v + 8 * st, (t / kStages) & 1);
      issue_pv<L, D>(acc, pa, base + L::kV + st * L::kKVBytes);
      pass_turn();
      wgmma_wait<1>();
      hold(s);
      softmax(t + 1);
      finish_pv(t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      pack_p<kTileN>(pa, s);
    }
    if (n_tiles > 0) {
      const int t = n_tiles - 1;
      const int st = t % kStages;
      take_turn();
      mbar_wait(full_v + 8 * st, (t / kStages) & 1);
      issue_pv<L, D>(acc, pa, base + L::kV + st * L::kKVBytes);
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
    Tq* op = o + static_cast<size_t>(bh) * sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (row_a < sq) {
        store2(op + static_cast<size_t>(row_a) * D + col, acc[4 * j] * inv_a,
               acc[4 * j + 1] * inv_a);
      }
      if (row_b < sq) {
        store2(op + static_cast<size_t>(row_b) * D + col, acc[4 * j + 2] * inv_b,
               acc[4 * j + 3] * inv_b);
      }
    }
    if (t4 == 0) {
      float* lp = lse + static_cast<size_t>(bh) * sq;
      if (row_a < sq) {
        lp[row_a] = l_run[0] == 0.f ? dead.lse(row_a) : m_run[0] * kLn2 + logf(l_run[0]);
      }
      if (row_b < sq) {
        lp[row_b] = l_run[1] == 0.f ? dead.lse(row_b) : m_run[1] * kLn2 + logf(l_run[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 compute on the FMA units: the block of csrc/fma_block.cuh over the
// stored-width ring of csrc/paged_kv.cuh (FmaRaw).  One block per (64-row Q
// tile, b * Hq), longest causal tiles first.  Per KV tile: wait for its
// stage, decode K and V into the fp32 stages and read this thread's four K
// and four V scales, barrier (the stage refills with tile t + kStages), S,
// barrier (P over K), the softmax, barrier, P V, barrier.  The walk is
// KvWalk's over 64-row tiles.  SEG: with segment ids, each thread's four
// key ids a tile and eight row ids in registers (at most two blocks an SM,
// which leaves them room).
// ---------------------------------------------------------------------------
template <typename Tq, typename Tc, int D, bool SEG>
__global__ void __launch_bounds__(kFmaThreads,
                                  SEG && FmaRaw<Tc, D>::kBlocksPerSm > 2
                                      ? 2
                                      : FmaRaw<Tc, D>::kBlocksPerSm)
fa2_fwd_quant_fp32(const Tq* __restrict__ q, const uint8_t* __restrict__ k,
                   const float* __restrict__ k_scales, const uint8_t* __restrict__ v,
                   const float* __restrict__ v_scales, Tq* __restrict__ o,
                   float* __restrict__ lse, const int* __restrict__ q_seg,
                   const int* __restrict__ kv_seg, int hq, int hkv, int sq, int skv,
                   int kv_len, float qscale, int causal, int window, QuantDead dead) {
  using R = FmaRaw<Tc, D>;
  constexpr int DO = D / 16;  // output columns per thread
  constexpr int kN = kFmaTile;
  extern __shared__ __align__(16) float smem[];
  unsigned char* bytes = reinterpret_cast<unsigned char*>(smem);
  float* kf = smem + R::kK;
  float* vf = smem + R::kV;
  float* qs = smem + R::kQ;
  const uint32_t bar0 = smem_addr(bytes + R::kBar);
  const FmaThread th = fma_thread();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kN;
  const size_t bh = blockIdx.y;
  const int b = blockIdx.y / hq;
  const int hk = (blockIdx.y - b * hq) / (hq / hkv);
  const size_t kv_head = static_cast<size_t>(b) * hkv + hk;
  const uint8_t* kp = k + kv_head * skv * R::kRow;
  const uint8_t* vp = v + kv_head * skv * R::kRow;
  const float* ksp = k_scales + kv_head * skv;
  const float* vsp = v_scales + kv_head * skv;
  const int kv_end = causal ? min(kv_len, q0 + kN) : kv_len;
  const KvWalk walk(q0 - window + 1, kv_end, 0, kN);  // step t is tile walk.at(t)
  const int n_kv = walk.n;
  const int* kv_ids = SEG ? kv_seg + static_cast<size_t>(b) * seg_stride(skv) : nullptr;
  int qid[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if constexpr (SEG) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      qid[r] = q_seg[static_cast<size_t>(b) * seg_stride(sq) + q0 + th.ty + 8 * r];
    }
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) mbar_init(bar0 + 8 * s, kFmaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q scaled by sm_scale * log2(e) once, in fp32.
  fma_load_q<D>(qs, q + bh * sq * D, q0, sq, qscale);
  __syncthreads();
  auto issue = [&](int t) {
    const int k0 = walk.at(t) * kN;
    fma_raw_issue<Tc, D>(bytes + R::kRaw + (t % R::kStages) * R::kStage,
                         bar0 + 8 * (t % R::kStages), kp + static_cast<size_t>(k0) * R::kRow,
                         vp + static_cast<size_t>(k0) * R::kRow, ksp + k0, vsp + k0,
                         min(kN, skv - k0));
  };
  for (int t = 0; t < R::kStages && t < n_kv; ++t) issue(t);

  float m_run[8], l_run[8], acc[8][DO];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[r][c] = 0.f;
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = walk.at(t) * kN;
    const unsigned char* stage = bytes + R::kRaw + (t % R::kStages) * R::kStage;
    int kid[4] = {0, 0, 0, 0};
    if constexpr (SEG) {
#pragma unroll
      for (int j = 0; j < 4; ++j) kid[j] = kv_ids[k0 + th.tx + 16 * j];
    }
    mbar_wait(bar0 + 8 * (t % R::kStages), (t / R::kStages) & 1);
    fma_decode_tile<Tc, D>(kf, stage);
    fma_decode_tile<Tc, D>(vf, stage + R::kTile);
    const float* sc = reinterpret_cast<const float*>(stage + 2 * R::kTile);
    float ksc[4], vsc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ksc[j] = sc[th.tx + 16 * j];
      vsc[j] = sc[kN + th.tx + 16 * j];
    }
    __syncthreads();  // K, V decoded; the stage is free
    if (t + R::kStages < n_kv) issue(t + R::kStages);
    float s[8][4];
    fma_scores<D>(qs, kf, th, s);
    float* ps = kf;
    __syncthreads();  // K(t) is read: P takes its stage

    // S times K's scale of its column, the mask on the diagonal, kv_len
    // tail and window-edge tiles and on every tile with segment ids (masked
    // P exactly 0), the exp2 online softmax; P times V's scale.  l_run is
    // this thread's share of the row sum.
    const bool need_mask = SEG || (k0 + kN > kv_len) || (causal && k0 + kN - 1 > q0) ||
                           q0 + kN - 1 - k0 >= window;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + th.ty + 8 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] *= ksc[j];
        if (need_mask) {
          const int col = k0 + th.tx + 16 * j;
          if (col >= kv_len || (causal && col > row) || row - col >= window ||
              (SEG && kid[j] != qid[r])) {
            s[r][j] = kMaskValue;
          }
        }
      }
      const float mx = fma_row_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(s[r][j] - m_new);
        if (need_mask && s[r][j] == kMaskValue) p = 0.f;
        rs += p;
        fma_store_p(ps, th, r, j, p * vsc[j]);
      }
      l_run[r] = l_run[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < DO; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // P is in place
    fma_pv<D, true>(ps, vf, th, acc);
    __syncthreads();  // P and V(t) are read
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
    // A row keeps no key (QuantDead's lse) only under a window or segment
    // ids.  The global call's loop has no dead-row select: with one, nvcc
    // fuses m ln 2 + log l into one FFMA in other rows than without, and
    // the lse moves by an ulp.
    if (SEG || window < kNoWindow) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + th.ty + 8 * r;
        if (row < sq) lp[row] = l[r] == 0.f ? dead.lse(row) : m_run[r] * kLn2 + logf(l[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = q0 + th.ty + 8 * r;
        if (row < sq) lp[row] = m_run[r] * kLn2 + logf(l[r] == 0.f ? 1.f : l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *k_scales, *v, *v_scales;
  void *o, *lse;
  const int *q_seg, *kv_seg;
  int batch, hq, hkv, sq, skv, kv_len;
  float qscale;
  int causal, window, dead_bq, dead_bk;

  QuantDead dead() const { return QuantDead{skv, causal, window, dead_bq, dead_bk}; }
};

// A 3-D byte map over a contiguous stored [rows, skv, row_bytes] K or V:
// boxes of tile_rows whole rows, unswizzled; reads past skv give zeros.
int raw_map(CUtensorMap* map, const void* ptr, int rows, int skv, int row_bytes,
            int tile_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(skv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(skv) * row_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(row_bytes),
                             static_cast<cuuint32_t>(tile_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <typename Tq, typename Tc, int D, bool SEG>
int launch_fp32(const Args& a, cudaStream_t stream) {
  using R = FmaRaw<Tc, D>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t cerr = set_smem_once(fa2_fwd_quant_fp32<Tq, Tc, D, SEG>, R::kSmem, smem_set);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid((a.sq + kFmaTile - 1) / kFmaTile, a.batch * a.hq);
  fa2_fwd_quant_fp32<Tq, Tc, D, SEG><<<grid, kFmaThreads, R::kSmem, stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const float*>(a.k_scales), static_cast<const uint8_t*>(a.v),
      static_cast<const float*>(a.v_scales), static_cast<Tq*>(a.o),
      static_cast<float*>(a.lse), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, a.skv,
      a.kv_len, a.qscale, a.causal, a.window, a.dead());
  return cudaGetLastError();
}

template <typename Tq, typename Tc, int D>
int launch(const Args& a, bool bf16_compute, cudaStream_t stream) {
  const auto* ks = static_cast<const float*>(a.k_scales);
  const auto* vs = static_cast<const float*>(a.v_scales);
  if (bf16_compute) {
    using L = Layout<Tc, D>;
    CUtensorMap k_map, v_map;
    int err = raw_map(&k_map, a.k, a.batch * a.hkv, a.skv, L::kRow, L::kTileN);
    if (err == 0) err = raw_map(&v_map, a.v, a.batch * a.hkv, a.skv, L::kRow, L::kTileN);
    if (err != 0) return err;
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t cerr = set_smem_once(fa2_fwd_quant_wgmma<Tq, Tc, D>, L::kSmem, smem_set);
    if (cerr != cudaSuccess) return cerr;
    const dim3 grid((a.sq + kTileM - 1) / kTileM, a.batch * a.hq);
    fa2_fwd_quant_wgmma<Tq, Tc, D><<<grid, kThreads, L::kSmem, stream>>>(
        k_map, v_map, static_cast<const Tq*>(a.q), ks, vs, static_cast<Tq*>(a.o),
        static_cast<float*>(a.lse), a.q_seg, a.kv_seg, a.hq, a.hkv, a.sq, a.skv,
        a.kv_len, a.qscale, a.causal, a.window, a.dead());
  } else if (a.q_seg != nullptr) {
    return launch_fp32<Tq, Tc, D, true>(a, stream);
  } else {
    return launch_fp32<Tq, Tc, D, false>(a, stream);
  }
  return cudaGetLastError();
}

// This library's head dims (CFA_HEAD_DIMS).
template <typename Tq, typename Tc>
int launch_d(int head_dim, const Args& a, bool bf16c, cudaStream_t st) {
#define CFA_CASE(D) \
  if (head_dim == D) return launch<Tq, Tc, D>(a, bf16c, st);
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return cudaErrorInvalidValue;
}

template <typename Tq>
int launch_storage(int storage, int head_dim, const Args& a, bool bf16c,
                   cudaStream_t st) {
  switch (storage) {
    case 0: return launch_d<Tq, int8_t>(head_dim, a, bf16c, st);
    case 1: return launch_d<Tq, __nv_fp8_e4m3>(head_dim, a, bf16c, st);
    case 2: return launch_d<Tq, __nv_fp8_e5m2>(head_dim, a, bf16c, st);
    case 3: return launch_d<Tq, Int4x2>(head_dim, a, bf16c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [batch, hq, sq, head_dim] (fp32, or bf16 when q_bf16; head_dim one of
// this library's, CFA_HEAD_DIMS); o like q; lse
// [batch, hq, sq] fp32.  k, v [batch, hkv, skv, row] of storage 0 = int8,
// 1 = fp8 e4m3, 2 = fp8 e5m2 (row = head_dim bytes) or 3 = int4 split-half
// (row = head_dim / 2 bytes); k_scales, v_scales [batch, hkv, skv] fp32.  All
// contiguous, k and v 16-byte aligned.  q_seg [batch, seg_stride(sq)] and
// kv_seg [batch, seg_stride(skv)] int32 segment ids, or both null.  window:
// a row keeps keys with row - col < window (kNoWindow: none; without
// causal a band, any value).  dead_bq x dead_bk: the JAX call's tiles,
// whose walk sets a dead row's lse.  bf16_compute: bf16 on the tensor cores
// (else fp32 on FMA).  qscale = sm_scale * log2(e).  Returns a cudaError_t,
// or an error of the tensor-map step (cfa_fa2_forward_quant_error_string
// names it).
int cfa_fa2_forward_quant(const void* q, const void* k, const void* k_scales,
                          const void* v, const void* v_scales, void* o, void* lse,
                          const void* q_seg, const void* kv_seg, int batch, int hq,
                          int hkv, int sq, int skv, int head_dim, int kv_len,
                          float qscale, int causal, int window, int dead_bq,
                          int dead_bk, int q_bf16, int storage, int bf16_compute,
                          void* stream) {
  if (hkv < 1 || hq % hkv != 0 || batch * hq > 65535 ||
      (q_seg == nullptr) != (kv_seg == nullptr) || dead_bq < 1 || dead_bk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,      k,       k_scales, v,       v_scales,
               o,      lse,     static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg), batch, hq, hkv, sq, skv,
               kv_len, qscale,  causal,   window,  dead_bq, dead_bk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return launch_storage<__nv_bfloat16>(storage, head_dim, a, bf16_compute != 0, st);
  }
  return launch_storage<float>(storage, head_dim, a, bf16_compute != 0, st);
}

const char* cfa_fa2_forward_quant_error_string(int err) {
  if (err == kErrNoEncoder) return "libcuda.so.1 has no cuTensorMapEncodeTiled";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused the K/V byte map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
