// Paged chunk attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/decode/attention.py::paged_chunk_attention
//   (body _chunk_kernel).
// T consecutive queries per sequence slot (speculative verification, chunked
// and prefix-suffix prefill) attend over that slot's pages of the paged KV
// cache, into which the chunk's own K/V was written first.  q and out are
// [n, T, Hq, D]; pages [Hkv, P, page, D] of int8, fp8 (e4m3 / e5m2), bf16 or
// fp32, or packed int4 [Hkv, P, page, D/2] (split-half: byte j holds element
// j low and element j + D/2 high), with fp32
// per-token scales [Hkv, P, page]; the page table [n, pages_per_seq] maps a
// slot's logical pages to physical ones; lengths [n] is each slot's TOTAL
// length, the chunk included (0 for an inactive slot, whose output is
// zeros).  Query t sits at position length - T + t and sees cached columns
// col <= length - T + t: that one bound is also the chunk's own causality.
// With a sliding window it keeps only col > pos - window of those, and, as
// attention sinks, col < sinks besides (JAX attention.py :294-329,
// :388-408): the oldest column any query keeps is length - T - window + 1.
// Every body walks only the live columns of its rows (csrc/hopper.cuh
// KvWalk: the sink chunks, then from its first row's window start to its
// last row's position), so a table entry behind the window is never read
// (the engine recycles those pages to other slots).
// The K scale multiplies the score columns, the V scale multiplies P before
// P is rounded to the compute type; the softmax is an fp32 online softmax
// with natural exp, as the TPU kernel computes it.
//
// Rows: inside a KV head the T * group query rows are ordered t-major (row
// r is query t = r / group, head hk * group + r % group), as the TPU kernel
// lays them out.
//
// What bounds it on the H100 depends on T.  At speculation's T <= 5 each
// cached K/V element serves T * group rows (10 at the base model's group 2),
// ~20 FLOPs per int8 byte against a ~295 FLOP/byte ridge: bytes, as B5, and
// at serving's batch the latency of walking a long slot's pages.  At
// chunked prefill's T = 512 a K/V element serves up to 1024 rows: tensor-
// core operations, as the FA2 forward.  So the wrapper picks one of two
// bodies from the shapes alone (T * group, never a length):
//
// (a) T * group <= kSplitRows (64; speculation's verify): B5's split-KV
//     flash-decoding (csrc/paged_decode.cu) with rows in place of heads.
//     The grid is (split, slot, KV head x row tile), a row tile at most 16
//     of the t-major rows, and a block walks its split's contiguous run of
//     the slot's live pages; the wrapper picks the split count from shapes
//     alone (decode/attention.py::chunk_split_plan), so the launch reads no
//     length on the host and can be captured in a CUDA graph.  Under a
//     window the splits share out the row tile's live chunk walk, planned
//     over the window + T - 1 columns' pages (live_page_span).  128-token
//     chunks of K and V with their scales arrive by cp.async into a ring of
//     up to three stages on mbarriers (tokens no row of the tile attends
//     are zero-filled, not read), and the next page id is read while a
//     chunk is scored.  Each warp owns 32 tokens of a chunk and keeps its
//     own fp32 online softmax for every row of the tile, row t bounded at
//     length - T + t.  bf16 compute runs the warp's 16 x 32 S and 16 x D
//     P V on mma.sync m16n8k16 (each lane decodes its token's K and V rows
//     into bf16 beside the warp: fp8 by the card's exact conversion, int8
//     and int4 by the 2^23 magic number; Q, the decoded K/V and P * v_scale
//     are rounded to bf16 as the plain version rounds them); fp32 compute
//     stays IEEE fp32 on the FMA units, lane per token as B5, decoding in
//     registers.  The block folds its warps in warp order, and the last
//     block to arrive at the (slot, KV head, row tile) counter folds the
//     live splits in split order and resets the counter.  A row can have
//     columns in one split and none in the next (the splits near the
//     slot's end): such a partial has l = 0 and is left out of both folds,
//     so exp(-inf - -inf) is never formed.  One launch a call, bitwise the
//     same run to run, no memset.
//
// (b) T * group > kSplitRows (chunked prefill, prefix suffixes), bf16
//     compute: one block per 64-row tile of the (t, g) rows, four warps of
//     16 rows on mma.sync m16n8k16 with fp32 accumulators, P going from
//     the S accumulators into A fragments.  64-token chunks of K and V in
//     their stored width, with their scales, arrive by cp.async into a
//     ring of two or three stages on mbarriers; the block decodes a landed
//     stage into one of two bf16 tiles (int8 and int4 by the magic number)
//     while the next stages land, and one barrier a tile separates that
//     decode from the products of the tile before.  Blocks are handed out
//     longest first: the chunk's last row tiles first, and among slots the
//     longest first (each block ranks the slots by length on the card;
//     under a window a walk still grows with the slot's length, up to the
//     window's cap, so the rank by length stays the rank by walk).
//     The softmax runs in the exp2 domain (the K scale carries sm_scale
//     log2(e)) and masks only the tiles that reach past the row tile's
//     first position.  wgmma is not used: TMA cannot widen int8/fp8/int4,
//     so every tile needs this conversion pass before a tensor-core
//     product.
//
// Head dims 32, 64, 128 and 256 (CFA_HEAD_DIMS; csrc/paged_chunk_d32.cu and
// _d256.cu build 32 and 256), every body.  At D = 256 the bf16 bodies read
// Q's A fragments from shared memory per k-step (held, their 64 registers
// and the 128 O accumulators would spill), the split body decodes a warp's
// K rows and then its V rows into one bf16 buffer and the tile body keeps
// one bf16 K/V pair (two would not fit beside the ring); the fp32 tile body
// holds sixteen O columns a thread (one block an SM) and, where no stored-
// width stage fits beside its fp32 tiles (bf16 rows), decodes each tile
// from device memory (FmaRaw::kStages 0).  An fp32 cache at D = 256 (1 KB
// rows): the split body's stage holds a chunk's K alone and each warp lands
// its V rows over its K rows once read (kVOverK), the bf16 tile body's raw
// stage holds 32 tokens, two a tile (kParts), and the fp32 tile body
// streams fp32 K and V straight into its fp32 stages, as at every width.
// At D = 32 a lane of the split body owns one output column and the FMA
// block's threads two.
//
// (c) T * group > kSplitRows with fp32 compute: IEEE fp32 on the FMA units,
//     bound by their 67 TFLOP/s at chunked prefill's T.  The block is the
//     fp32 FMA block of B1's fp32 body (csrc/fma_block.cuh): 128 threads per
//     64-row tile of the (t, g) rows, 8 x 4 register tiles of S and O read
//     with swizzled float4 loads, P over the K stage just read; one block
//     per (row tile, slot, KV head) in the bf16 tile body's order (the
//     chunk's last row tiles of the longest slots, the longest walks,
//     first).  An fp32 cache streams by cp.async straight into the block's
//     fp32 K and V stages (B1's fp32 rings); any other cache arrives in its
//     stored width with its scales in the ring of csrc/paged_kv.cuh
//     (FmaRaw, shared with B7's fp32 body), and each landed tile is decoded
//     once into the fp32 stages (int8 and int4 by the magic number, fp8 by
//     the card's conversion, bf16 by a shift), instead of once per reading
//     thread.  The function is the first body's: S over d in order, K's
//     scale times sm_scale on every column a row attends and kMaskValue
//     past its position, the natural-exp online softmax, P * v_scale, P V
//     over the tile's keys in order, zeros where l == 0.  It replaces 256
//     threads of 4 x 4 scalar tiles with K/V staged in fp32 between two
//     barriers.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

#include "paged_kv.cuh"  // includes the FMA block (csrc/fma_block.cuh)

// The head dims this library is built for: 64 and 128 here; a source that
// includes this one with CFA_HEAD_DIMS defined builds others (D 32 and 256
// each in their own library, so that nvcc compiles the widths in parallel).
#ifndef CFA_HEAD_DIMS
#define CFA_HEAD_DIMS(X) X(64) X(128)
#endif

namespace {

constexpr int kSplitRows = 64;  // T * group up to this: the split-KV body
constexpr int kRowTile = 16;    // split body: rows of a block (its row tile)
constexpr int kThreads = 128;   // split body: tokens a chunk, one per lane
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr int kRingBudget = 140 * 1024;  // split body: shared bytes of the ring
constexpr int kBlockM = 64;  // tile bodies: (t, g) rows per thread block
constexpr int kBlockN = 64;  // tile bodies: cached tokens per loop iteration
constexpr int kRawBudget = 96 * 1024;  // bf16 tile body: bytes of the raw ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tensor-core and decode helpers of the bf16 bodies.

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

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Decode 16 stored bytes (row r, byte cb of a raw tile) into the bf16 tile
// `dst` (row stride LD): the compute type's values, exact for every code
// but an fp32 cache's, which rounds to bf16.
template <typename Tc, int D, int LD>
__device__ __forceinline__ void decode16(__nv_bfloat16* dst, const unsigned char* src,
                                         int r, int cb) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (kPacked<Tc>) {
    uint32_t lo_w[8], hi_w[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float lo[4], hi[4];
      int4x8_to_float(w[k], lo, hi);
      lo_w[2 * k] = pack_bf16(lo[0], lo[1]);
      lo_w[2 * k + 1] = pack_bf16(lo[2], lo[3]);
      hi_w[2 * k] = pack_bf16(hi[0], hi[1]);
      hi_w[2 * k + 1] = pack_bf16(hi[2], hi[3]);
    }
    uint4* dl = reinterpret_cast<uint4*>(dst + r * LD + cb);
    uint4* dh = reinterpret_cast<uint4*>(dst + r * LD + cb + D / 2);
    dl[0] = make_uint4(lo_w[0], lo_w[1], lo_w[2], lo_w[3]);
    dl[1] = make_uint4(lo_w[4], lo_w[5], lo_w[6], lo_w[7]);
    dh[0] = make_uint4(hi_w[0], hi_w[1], hi_w[2], hi_w[3]);
    dh[1] = make_uint4(hi_w[4], hi_w[5], hi_w[6], hi_w[7]);
  } else if constexpr (std::is_same<Tc, int8_t>::value) {
    uint32_t o[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float f[4];
      int8x4_to_float(w[k], f);
      o[2 * k] = pack_bf16(f[0], f[1]);
      o[2 * k + 1] = pack_bf16(f[2], f[3]);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + cb);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else if constexpr (std::is_same<Tc, __nv_bfloat16>::value) {
    *reinterpret_cast<uint4*>(dst + r * LD + cb / 2) = raw;
  } else {
    constexpr int kE = 16 / static_cast<int>(sizeof(Tc));
    alignas(16) Tc e[kE];
    *reinterpret_cast<uint4*>(e) = raw;
    uint32_t o[kE / 2];
#pragma unroll
    for (int j = 0; j < kE / 2; ++j) {
      o[j] = pack_bf16(to_float(e[2 * j]), to_float(e[2 * j + 1]));
    }
    __nv_bfloat16* d = dst + r * LD + cb / static_cast<int>(sizeof(Tc));
    if constexpr (kE == 16) {
      reinterpret_cast<uint4*>(d)[0] = make_uint4(o[0], o[1], o[2], o[3]);
      reinterpret_cast<uint4*>(d)[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {  // fp32: four values
      *reinterpret_cast<uint2*>(d) = make_uint2(o[0], o[1]);
    }
  }
}


// ===========================================================================
// (a) The split-KV body.  MMA: bf16 compute on the tensor cores, one 16-row
// tile; otherwise fp32 compute on the FMA units, lane per token.
// ===========================================================================

// Shared memory of a block, in bytes: the ring (kStages stages of a K
// chunk, a V chunk and their scales; rows padded by 16 bytes, so lane t's
// 16-byte reads of row t are conflict-free), Q (fp32 [RT][D], or with MMA
// bf16 [RT][D + 8]), each row's position [RT], the warps' P ([kWarps][RT]
// [32] fp32, or with MMA each warp's 32 K and V rows in bf16, [kWarps][2]
// [32][D + 8]) and one mbarrier per stage; RT = kRowTile.  The warps'
// states are folded through the ring once it is drained.  At D = 256 a
// warp's K rows and then its V rows take one bf16 buffer in turn (kKVBufs
// 1): two would not fit beside a bf16 cache's 136 KB chunk.  An fp32
// chunk's K and V (266 KB) fit no block: with kVOverK a stage holds the K
// chunk alone, and each warp lands its 32 V rows over its 32 K rows once
// it has read them (B5's remedy, csrc/paged_decode.cu load_warp_v).
template <typename Tc, int D, bool MMA>
struct SplitLayout {
  static constexpr int RT = kRowTile;
  static constexpr int kRowBytes = kRowBytesOf<Tc, D>;
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kTileBytes = kThreads * kStride;
  static constexpr bool kVOverK = kRowBytes > 512;
  static constexpr int kVOff = kVOverK ? 0 : kTileBytes;
  static constexpr int kScaleOff = (kVOverK ? 1 : 2) * kTileBytes;
  static constexpr int kStageBytes = kScaleOff + 2 * kThreads * 4;
  static constexpr int kLD = D + 8;  // bf16 row stride: conflict-free ldmatrix
  static constexpr int kKVBufs = D > 128 ? 1 : 2;
  static constexpr int kQBytes = MMA ? RT * kLD * 2 : RT * D * 4;
  static constexpr int kPBytes =
      MMA ? kWarps * kKVBufs * 32 * kLD * 2 : kWarps * RT * 32 * 4;
  static constexpr int kStages =
      std::min(3, std::max(1, (kRingBudget - (MMA ? kPBytes / 2 : 0)) / kStageBytes));
  static constexpr int kQOff = kStages * kStageBytes;
  static constexpr int kPosOff = kQOff + kQBytes;
  static constexpr int kPOff = kPosOff + RT * 4;
  static constexpr int kBarOff = kPOff + kPBytes;
  static constexpr int kSmem = kBarOff + 8 * kStages;
  static_assert(kRowBytes % 16 == 0, "rows are copied 16 bytes at a time");
  static_assert(kPOff % 16 == 0, "P and the bf16 rows are read 16 bytes at a time");
  static_assert(kWarps * RT * (D + 2) * 4 <= kQOff,
                "the warps' states fit the drained ring");
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// Chunk `row0` (128 rows of one KV head's page, contiguous) of K and V and
// their scales into `stage` by cp.async, rows at or past `n_valid`
// zero-filled and not read: this thread's share, then its arrival on `bar`.
template <typename L>
__device__ __forceinline__ void load_split_chunk(unsigned char* stage, uint32_t bar,
                                                 const unsigned char* k_pages,
                                                 const unsigned char* v_pages,
                                                 const float* k_scales,
                                                 const float* v_scales, size_t row0,
                                                 int n_valid) {
  constexpr int kVec = L::kRowBytes / 16;
  const unsigned char* ksrc = k_pages + row0 * L::kRowBytes;
  const unsigned char* vsrc = v_pages + row0 * L::kRowBytes;
  for (int i = threadIdx.x; i < kThreads * kVec; i += kThreads) {
    const int r = i / kVec;
    const int cb = (i - r * kVec) * 16;
    const bool full = r < n_valid;
    cp_async16(smem_addr(stage + r * L::kStride + cb), ksrc + static_cast<size_t>(i) * 16,
               full);
    if constexpr (!L::kVOverK) {
      cp_async16(smem_addr(stage + L::kTileBytes + r * L::kStride + cb),
                 vsrc + static_cast<size_t>(i) * 16, full);
    }
  }
  const int t = threadIdx.x;
  if (t < 32) {
    cp_async16(smem_addr(stage + L::kScaleOff + 16 * t), k_scales + row0 + 4 * t,
               4 * t < n_valid);
  } else if (t < 64) {
    cp_async16(smem_addr(stage + L::kScaleOff + kThreads * 4 + 16 * (t - 32)),
               v_scales + row0 + 4 * (t - 32), 4 * (t - 32) < n_valid);
  }
  cp_async_arrive(bar);
}

// kVOverK: warp `warp`'s 32 V rows of the chunk at token tok0 of page
// `pid` (KV head hk; rows at or past n_valid zero-filled, not read) into
// its 32 K rows of `stage`, which its lanes have read; the warp waits for
// them.
template <typename L>
__device__ __forceinline__ void load_warp_v(unsigned char* stage,
                                            const unsigned char* v_pages, int hk,
                                            int num_pages, int pid, int page_size,
                                            int tok0, int n_valid, int warp, int lane) {
  constexpr int kVec = L::kRowBytes / 16;
  const size_t row0 = (static_cast<size_t>(hk) * num_pages + pid) * page_size +
                      tok0 % page_size;
  const unsigned char* vsrc = v_pages + (row0 + warp * 32) * L::kRowBytes;
  unsigned char* dst = stage + warp * 32 * L::kStride;
  __syncwarp();  // every lane has read its K row
  for (int i = lane; i < 32 * kVec; i += 32) {
    const int r = i / kVec;
    cp_async16(smem_addr(dst + r * L::kStride + (i - r * kVec) * 16),
               vsrc + static_cast<size_t>(i) * 16, warp * 32 + r < n_valid);
  }
  cp_async_wait_all();
  __syncwarp();  // the warp's V rows have landed
}

// s[r] += Q[r][d0 + j] K[row][d0 + j] for j < 4, in order, for the tile's
// rows (RT at most, n_rows of them).
template <int RT>
__device__ __forceinline__ void fma4(const float* qf, int D, int d0, int n_rows,
                                     const float (&kv)[4], float (&s)[RT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < n_rows) {
      const float4 q4 = *reinterpret_cast<const float4*>(qf + r * D + d0);
      s[r] = fmaf(q4.x, kv[0], s[r]);
      s[r] = fmaf(q4.y, kv[1], s[r]);
      s[r] = fmaf(q4.z, kv[2], s[r]);
      s[r] = fmaf(q4.w, kv[3], s[r]);
    }
  }
}

// s[r] = sum over d, in order, of Q[r][d] K[row][d] for the tile's rows
// (int4: byte by byte, its low nibble, element j, before its high one,
// element j + D/2), in fp32.
template <typename Tc, int D, int RT>
__device__ __forceinline__ void score_row(const unsigned char* krow,
                                          const float* qf, int n_rows,
                                          float (&s)[RT]) {
#pragma unroll 1
  for (int b0 = 0; b0 < kRowBytesOf<Tc, D>; b0 += 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + b0);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (kPacked<Tc>) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float lo[4], hi[4];
        int4x8_to_float(w[k], lo, hi);
        const int j = b0 + 4 * k;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < n_rows) {
            const float4 ql = *reinterpret_cast<const float4*>(qf + r * D + j);
            const float4 qh = *reinterpret_cast<const float4*>(qf + r * D + j + D / 2);
            s[r] = fmaf(ql.x, lo[0], s[r]);
            s[r] = fmaf(qh.x, hi[0], s[r]);
            s[r] = fmaf(ql.y, lo[1], s[r]);
            s[r] = fmaf(qh.y, hi[1], s[r]);
            s[r] = fmaf(ql.z, lo[2], s[r]);
            s[r] = fmaf(qh.z, hi[2], s[r]);
            s[r] = fmaf(ql.w, lo[3], s[r]);
            s[r] = fmaf(qh.w, hi[3], s[r]);
          }
        }
      }
    } else if constexpr (sizeof(Tc) == 1 && D > 128) {
      // int8 and fp8 at D = 256: one 4-byte word at a time (the 128
      // accumulators leave room for no more values in flight).
#pragma unroll 1
      for (int k = 0; k < 4; ++k) {
        float kv[4];
        decode4<Tc>(*reinterpret_cast<const uint32_t*>(krow + b0 + 4 * k), kv);
        fma4<RT>(qf, D, b0 + 4 * k, n_rows, kv, s);
      }
    } else if constexpr (std::is_same<Tc, int8_t>::value) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float kv[4];
        int8x4_to_float(w[k], kv);
        fma4<RT>(qf, D, b0 + 4 * k, n_rows, kv, s);
      }
    } else {
      constexpr int kE = 16 / static_cast<int>(sizeof(Tc));
      alignas(16) Tc e[kE];
      *reinterpret_cast<uint4*>(e) = raw;
      const int d0 = b0 / static_cast<int>(sizeof(Tc));
#pragma unroll
      for (int j = 0; j < kE; j += 4) {
        float kv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) kv[u] = to_float(e[j + u]);
        fma4<RT>(qf, D, d0 + j, n_rows, kv, s);
      }
    }
  }
}

// Lane `lane`'s D/32 elements [lane D/32, (lane + 1) D/32) of a staged V
// row, as fp32.
template <typename Tc, int D>
__device__ __forceinline__ void v_elems(const unsigned char* vrow, int lane,
                                        float (&vv)[D / 32]) {
  constexpr int kE = D / 32;
  if constexpr (sizeof(Tc) == 1 && kE > 4) {
    // kE bytes (D = 256: 8) of int8, fp8 or int4 as 4-byte words, each
    // decoded in registers (int4 as below; fp8 by the card's exact
    // conversion, not through a local array).
    const int off = kPacked<Tc> ? (lane * kE) % (D / 2) : lane * kE;
    const bool high = kPacked<Tc> && lane * kE >= D / 2;
#pragma unroll
    for (int h = 0; h < kE / 4; ++h) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(vrow + off + 4 * h);
      float lo[4], hi[4];
      if constexpr (kPacked<Tc>) {
        int4x8_to_float(w, lo, hi);
      } else {
        decode4<Tc>(w, lo);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[4 * h + i] = high ? hi[i] : lo[i];
    }
  } else if constexpr (kPacked<Tc> || std::is_same<Tc, int8_t>::value) {
    // kE bytes: int8 elements, or int4 pairs of which this lane takes the
    // low nibbles (elements below D/2) or the high ones.
    const int off = kPacked<Tc> ? (lane * kE) % (D / 2) : lane * kE;
    const uint32_t w = *reinterpret_cast<const typename Bytes<kE>::T*>(vrow + off);
    float lo[4], hi[4];
    if constexpr (kPacked<Tc>) {
      int4x8_to_float(w, lo, hi);
    } else {
      int8x4_to_float(w, lo);
    }
    const bool high = kPacked<Tc> && lane * kE >= D / 2;
#pragma unroll
    for (int i = 0; i < kE; ++i) vv[i] = high ? hi[i] : lo[i];
  } else {
    constexpr int kN = kE * static_cast<int>(sizeof(Tc));
    alignas(16) Tc e[kE];
    *reinterpret_cast<typename Bytes<kN>::T*>(e) =
        *reinterpret_cast<const typename Bytes<kN>::T*>(vrow + lane * kN);
#pragma unroll
    for (int i = 0; i < kE; ++i) vv[i] = to_float(e[i]);
  }
}

// A block holds one row tile of at most kRowTile rows.  MMA is the bf16
// compute type: Q, the decoded K/V and P * v_scale are rounded
// to bf16, the products run on mma.sync m16n8k16 with fp32 accumulators.
// Otherwise the compute type is fp32 (IEEE, on the FMA units).  The
// launch bounds promise one block an SM: without that, ptxas held some
// instantiations to 128 registers and spilled the window's bounds.
template <typename Tq, typename Tc, int D, bool MMA>
__global__ void __launch_bounds__(kThreads, 1)
paged_chunk_split(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                  const float* __restrict__ k_scales, const Tc* __restrict__ v_pages,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ page_table, const int* __restrict__ lengths,
                  Tq* __restrict__ out, float* __restrict__ partial,
                  int* __restrict__ counters, int chunk, int n_heads, int n_kv,
                  int num_pages, int page_size, int pages_per_seq,
                  int pages_per_split, float sm_scale, int window, int sinks) {
  using L = SplitLayout<Tc, D, MMA>;
  constexpr int RT = kRowTile;
  constexpr int kE = D / 32;  // scalar P V: output columns per lane
  constexpr int S = L::kStages;
  constexpr int LD = L::kLD;
  extern __shared__ __align__(16) unsigned char smem[];
  int* pos_s = reinterpret_cast<int*>(smem + L::kPosOff);
  const uint32_t bar0 = smem_addr(smem + L::kBarOff);
  __shared__ int last_block;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int slot = blockIdx.y;
  const int group = n_heads / n_kv;
  const int rows = chunk * group;
  const int n_tiles = (rows + RT - 1) / RT;
  const int hk = blockIdx.z / n_tiles;
  const int tile = blockIdx.z - hk * n_tiles;
  const int r0 = tile * RT;
  const int n_rows = min(RT, rows - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // MMA: this thread's rows g and g + 8
  const int t4 = lane & 3;
  const int base = lengths[slot] - chunk;  // position of query 0
  // Columns that some row of the tile attends: to its last row's position,
  // from its first row's window start (and the sinks), in 128-token chunks
  // (each holding a column some row keeps); a split walks
  // chunks_per_split of them.  Splits holding such a chunk; split 0 also
  // answers a tile with none (zeros).  The others have nothing to do.
  const int kv_end = max(0, base + (r0 + n_rows - 1) / group + 1);
  const KvWalk walk(base + r0 / group - window + 1, kv_end, sinks, kThreads);
  const int chunks_per_split = pages_per_split * (page_size / kThreads);
  const int n_live = max(1, (walk.n + chunks_per_split - 1) / chunks_per_split);
  if (split >= n_live) return;
  // Element offset in q / out of the tile's row r.
  auto row_off = [&](int r) {
    const int rr = r0 + r;
    const int t = rr / group;
    return ((static_cast<size_t>(slot) * chunk + t) * n_heads + hk * group + rr -
            t * group) * D;
  };

  // This split's walk steps [step0, step0 + n_chunks).
  const int step0 = split * chunks_per_split;
  const int n_chunks = max(0, min(walk.n - step0, chunks_per_split));
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pages);
  auto tok_of = [&](int c) { return walk.at(step0 + c) * kThreads; };
  auto page_of = [&](int c) {
    return page_table[static_cast<size_t>(slot) * pages_per_seq + tok_of(c) / page_size];
  };
  auto issue = [&](int c, int pid) {
    const int tok0 = tok_of(c);
    const int page = tok0 / page_size;
    const size_t row0 = (static_cast<size_t>(hk) * num_pages + pid) * page_size +
                        (tok0 - page * page_size);
    load_split_chunk<L>(smem + (c % S) * L::kStageBytes, bar0 + 8 * (c % S), kp, vp,
                        k_scales, v_scales, row0, kv_end - tok0);
  };

  // Scalar state: RT rows a thread; MMA state: rows g and g + 8 of the
  // m16n8 accumulators (columns 8 j + 2 t4 and + 1 of each n-tile j).
  constexpr int kSR = MMA ? 1 : RT;
  constexpr int kSE = MMA ? 1 : kE;
  float m_run[kSR], l_part[kSR], acc[kSR][kSE];
  float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f};
  float acc2[MMA ? D / 8 : 1][4];
#pragma unroll
  for (int r = 0; r < kSR; ++r) {
    m_run[r] = -INFINITY;
    l_part[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kSE; ++e) acc[r][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < (MMA ? D / 8 : 1); ++j) {
    acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
  }

  if (n_chunks > 0) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, kThreads);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialised
    for (int c = 0; c < S && c < n_chunks; ++c) issue(c, page_of(c));
    if constexpr (MMA) {
      // Q rounded to bf16, rows past n_rows zero.
      __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + L::kQOff);
      for (int i = tid; i < RT * (D / 8); i += kThreads) {
        const int r = i / (D / 8);
        const int c = (i - r * (D / 8)) * 8;
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = r < n_rows ? to_float(q[row_off(r) + c + j]) : 0.f;
        *reinterpret_cast<uint4*>(qb + r * LD + c) =
            make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                       pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
      }
    } else {
      float* qf = reinterpret_cast<float*>(smem + L::kQOff);
      for (int i = tid; i < n_rows * D; i += kThreads) {
        const int r = i / D;
        qf[i] = to_float(q[row_off(r) + (i - r * D)]);
      }
    }
    if (tid < n_rows) pos_s[tid] = base + (r0 + tid) / group;
    __syncthreads();  // Q and the positions are staged

    // Q's A fragments, held for the whole walk (at D = 256 read again from
    // shared memory per k-step: held, they and the 128 O accumulators would
    // spill).
    constexpr bool kHoldQ = D <= 128;
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(smem + L::kQOff);
    auto q_frag = [&](uint32_t (&f)[4], int kk) {
      ldmatrix_x4(f, qb + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
    };
    uint32_t qa[MMA && kHoldQ ? D / 16 : 1][4];
    int pos_a = -1, pos_b = -1;
    if constexpr (MMA) {
      if constexpr (kHoldQ) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) q_frag(qa[kk], kk);
      }
      if (g < n_rows) pos_a = pos_s[g];
      if (g + 8 < n_rows) pos_b = pos_s[g + 8];
    }

    for (int c = 0; c < n_chunks; ++c) {
      // The page that refills this stage, read while the chunk is computed.
      const int next_pid = c + S < n_chunks ? page_of(c + S) : 0;
      const unsigned char* stage = smem + (c % S) * L::kStageBytes;
      mbar_wait(bar0 + 8 * (c % S), (c / S) & 1);
      const int tok0 = tok_of(c);
      const float* ksc = reinterpret_cast<const float*>(stage + L::kScaleOff);
      const float* vsc = ksc + kThreads;
      if (tok0 + warp * 32 < kv_end) {  // the warp holds a token before kv_end
        const int t = warp * 32 + lane;
        if constexpr (MMA) {
          // This warp's 32 K and V rows in bf16 (lane decodes its token's
          // rows), then S = Q K^T and O += P V on the tensor cores.
          __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(smem + L::kPOff) +
                               warp * L::kKVBufs * 32 * LD;
          __nv_bfloat16* vst = kst + (L::kKVBufs - 1) * 32 * LD;
#pragma unroll
          for (int cb = 0; cb < L::kRowBytes; cb += 16) {
            decode16<Tc, D, LD>(kst, stage + t * L::kStride + cb, lane, cb);
            if constexpr (L::kKVBufs == 2) {
              decode16<Tc, D, LD>(vst, stage + L::kTileBytes + t * L::kStride + cb, lane, cb);
            }
          }
          if constexpr (L::kVOverK) {
            load_warp_v<L>(smem + (c % S) * L::kStageBytes, vp, hk, num_pages, page_of(c),
                           page_size, tok0, kv_end - tok0, warp, lane);
          }
          __syncwarp();
          float s[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t qf[4];
            if constexpr (!kHoldQ) q_frag(qf, kk);
            const uint32_t* qk = kHoldQ ? qa[kHoldQ ? kk : 0] : qf;
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t bf[4];
              ldmatrix_x4(bf, kst + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
              mma_bf16(s[2 * np], qk, bf[0], bf[1]);
              mma_bf16(s[2 * np + 1], qk, bf[2], bf[3]);
            }
          }
          if constexpr (L::kKVBufs == 1) {
            // The warp's K rows are read: its V rows take their buffer.
            __syncwarp();
#pragma unroll
            for (int cb = 0; cb < L::kRowBytes; cb += 16) {
              decode16<Tc, D, LD>(vst, stage + L::kVOff + t * L::kStride + cb, lane, cb);
            }
            __syncwarp();
          }
          // Scale the score columns, mask past each row's position, online
          // softmax over the warp's 32 columns (rows g and g + 8).
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tl = warp * 32 + j * 8 + 2 * t4 + (e & 1);
              const int pos = e < 2 ? pos_a : pos_b;
              const bool keep = tok0 + tl <= pos && in_window(pos, tok0 + tl, window, sinks);
              s[j][e] = keep ? s[j][e] * (ksc[tl] * sm_scale) : kMaskValue;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
          }
          float alpha[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            const float m_new = fmaxf(m2[i], mx[i]);
            alpha[i] = expf(m2[i] - m_new);
            m2[i] = m_new;
          }
          float rs[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tl = warp * 32 + j * 8 + 2 * t4 + (e & 1);
              const int pos = e < 2 ? pos_a : pos_b;
              const bool keep = tok0 + tl <= pos && in_window(pos, tok0 + tl, window, sinks);
              const float p = keep ? expf(s[j][e] - m2[e >> 1]) : 0.f;
              rs[e >> 1] += p;
              s[j][e] = keep ? p * vsc[tl] : 0.f;  // rounded to bf16 below
            }
          }
          l2[0] = l2[0] * alpha[0] + rs[0];
          l2[1] = l2[1] * alpha[1] + rs[1];
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc2[j][0] *= alpha[0];
            acc2[j][1] *= alpha[0];
            acc2[j][2] *= alpha[1];
            acc2[j][3] *= alpha[1];
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dp = 0; dp < D / 16; ++dp) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                        dp * 16 + (lane >> 4) * 8);
              mma_bf16(acc2[2 * dp], pa, bf[0], bf[1]);
              mma_bf16(acc2[2 * dp + 1], pa, bf[2], bf[3]);
            }
          }
        } else {
          const int tok = tok0 + t;
          const float* qf = reinterpret_cast<const float*>(smem + L::kQOff);
          float* pw = reinterpret_cast<float*>(smem + L::kPOff) + warp * RT * 32;
          float s[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) s[r] = 0.f;
          score_row<Tc, D, RT>(stage + t * L::kStride, qf, n_rows, s);
          if constexpr (L::kVOverK) {
            load_warp_v<L>(smem + (c % S) * L::kStageBytes, vp, hk, num_pages, page_of(c),
                           page_size, tok0, kv_end - tok0, warp, lane);
          }
          const float col_scale = ksc[t] * sm_scale;
          const float v_scale = vsc[t];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            if (r < n_rows) {
              const bool valid = tok <= pos_s[r] && in_window(pos_s[r], tok, window, sinks);
              const float sr = valid ? s[r] * col_scale : kMaskValue;
              float mx = sr;
#pragma unroll
              for (int off = 16; off > 0; off >>= 1) {
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
              }
              const float m_new = fmaxf(m_run[r], mx);
              const float alpha = expf(m_run[r] - m_new);
              m_run[r] = m_new;
              const float p = valid ? expf(sr - m_new) : 0.f;
              l_part[r] = l_part[r] * alpha + p;
              pw[r * 32 + lane] = valid ? p * v_scale : 0.f;
#pragma unroll
              for (int e = 0; e < kE; ++e) acc[r][e] *= alpha;
            }
          }
          __syncwarp();
          // P V over the warp's 32 tokens, in order, four at a time: the
          // four V rows' elements once, then each row's four P values.
          const unsigned char* vbase = stage + L::kVOff + warp * 32 * L::kStride;
#pragma unroll 1
          for (int t0 = 0; t0 < 32; t0 += 4) {
            if constexpr (kE > 4) {
              // D = 256: one V row at a time (four rows' 32 values beside the
              // 128 accumulators would spill); each element still sums the
              // keys in order.
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                float vv[kE];
                v_elems<Tc, D>(vbase + (t0 + u) * L::kStride, lane, vv);
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                  if (r < n_rows) {
                    const float p = pw[r * 32 + t0 + u];
#pragma unroll
                    for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
                  }
                }
              }
            } else {
              float vv[4][kE];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                v_elems<Tc, D>(vbase + (t0 + u) * L::kStride, lane, vv[u]);
              }
#pragma unroll
              for (int r = 0; r < RT; ++r) {
                if (r < n_rows) {
                  const float4 p4 = *reinterpret_cast<const float4*>(pw + r * 32 + t0);
#pragma unroll
                  for (int e = 0; e < kE; ++e) {
                    float a = fmaf(p4.x, vv[0][e], acc[r][e]);
                    a = fmaf(p4.y, vv[1][e], a);
                    a = fmaf(p4.z, vv[2][e], a);
                    acc[r][e] = fmaf(p4.w, vv[3][e], a);
                  }
                }
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the stage and its P or rows
      if (c + S < n_chunks) issue(c + S, next_pid);
    }
  }

  // Fold the four warps' states in warp order (through the drained ring);
  // a warp that saw no column of a row has l = 0 there and is left out.
  float* red_acc = reinterpret_cast<float*>(smem);      // [kWarps][RT][D]
  float* red_m = red_acc + kWarps * RT * D;             // [kWarps][RT]
  float* red_l = red_m + kWarps * RT;
  if constexpr (MMA) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i;
      float l = l2[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(red_acc + (warp * RT + r) * D + j * 8 + 2 * t4) =
            make_float2(acc2[j][2 * i], acc2[j][2 * i + 1]);
      }
      if (t4 == 0) {
        red_m[warp * RT + r] = m2[i];
        red_l[warp * RT + r] = l;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < n_rows) {
        float l = l_part[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          red_acc[(warp * RT + r) * D + lane * kE + e] = acc[r][e];
        }
        if (lane == 0) {
          red_m[warp * RT + r] = m_run[r];
          red_l[warp * RT + r] = l;
        }
      }
    }
  }
  __syncthreads();
  // The split's partials: (acc [rows, D], then (m, l) [rows]) for each
  // (slot, KV head, split), rows of the whole KV head.
  const size_t part = ((static_cast<size_t>(slot) * n_kv + hk) * n_splits + split) * rows;
  float2* part_ml = reinterpret_cast<float2*>(
      partial + static_cast<size_t>(gridDim.y) * n_kv * n_splits * rows * D);
  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      if (red_l[w * RT + r] > 0.f) m = fmaxf(m, red_m[w * RT + r]);
    }
    float a = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lw = red_l[w * RT + r];
      if (lw > 0.f) {
        const float f = expf(red_m[w * RT + r] - m);
        a = fmaf(red_acc[(w * RT + r) * D + d], f, a);
        l = fmaf(lw, f, l);
      }
    }
    if (n_live == 1) {
      store(out + row_off(r) + d, a * (l == 0.f ? 0.f : 1.f / l));
    } else {
      partial[(part + r0 + r) * D + d] = a;
      if (d == 0) part_ml[part + r0 + r] = make_float2(m, l);
    }
  }
  if (n_live == 1) return;

  // The last live split of this (slot, KV head, row tile) to arrive folds
  // all of them in split order, leaving out a row's partials with l = 0.
  int* counter = counters + (static_cast<size_t>(slot) * n_kv + hk) * n_tiles + tile;
  __threadfence();  // this block's partials are visible before its arrival
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const size_t part0 = (static_cast<size_t>(slot) * n_kv + hk) * n_splits * rows;
  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D;
    const int rr = r0 + r;
    float m = -INFINITY;
#pragma unroll 2
    for (int s = 0; s < n_live; ++s) {
      const float2 ml = __ldcg(part_ml + part0 + s * rows + rr);
      if (ml.y > 0.f) m = fmaxf(m, ml.x);
    }
    float a = 0.f, l = 0.f;
#pragma unroll 2
    for (int s = 0; s < n_live; ++s) {
      const float2 ml = __ldcg(part_ml + part0 + s * rows + rr);
      if (ml.y > 0.f) {
        const float f = expf(ml.x - m);
        a = fmaf(__ldcg(partial + (part0 + s * rows + rr) * D + (i - r * D)), f, a);
        l = fmaf(ml.y, f, l);
      }
    }
    store(out + row_off(r) + (i - r * D), a * (l == 0.f ? 0.f : 1.f / l));
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// ===========================================================================
// (b) The bf16 tile body: mma.sync on 64-row tiles, fed by a cp.async ring.
// ===========================================================================

// Shared memory of the bf16 tile body, in bytes: the raw ring (kStages
// stages of a 64-token K chunk and V chunk in their stored width, rows
// contiguous, and their scales), two bf16 K/V tiles (row stride D + 8:
// conflict-free ldmatrix) with their scales (K's times sm_scale, zero past
// the block's columns), the Q tile and one mbarrier per raw stage.  At D =
// 256 the block keeps one bf16 K/V tile pair (kBufs; a barrier separates
// a tile's decode from the products of the tile before), a bf16 cache one
// raw stage, and the warps read Q's fragments from shared memory per
// k-step: two pairs (135 KB) and the Q tile (34 KB) would not fit beside
// the ring, nor Q's fragments (64 registers) beside the 128 O accumulators.
// An fp32 cache's 64-token stage at D = 256 (257 KB) fits no block: its
// raw stages hold kRawN = 32 tokens, a tile lands in kParts = 2 of them.
template <typename Tc, int D>
struct TileLayout {
  static constexpr int kRowBytes = kRowBytesOf<Tc, D>;
  static constexpr int kRawN = kRowBytes > 512 ? 32 : kBlockN;  // tokens a raw stage
  static constexpr int kParts = kBlockN / kRawN;
  static constexpr int kRawTile = kRawN * kRowBytes;
  static constexpr int kRawStage = 2 * kRawTile + 2 * kRawN * 4;
  static constexpr int kStages =
      std::min(3, std::max(D > 128 ? 1 : 2, kRawBudget / kRawStage));
  static constexpr int kBufs = D > 128 ? 1 : 2;
  static constexpr int LD = D + 8;
  static constexpr int kBfTile = kBlockN * LD * 2;  // bytes of one bf16 tile
  static constexpr int kBf = kStages * kRawStage;   // [kBufs][K, V] bf16 tiles
  static constexpr int kScl = kBf + 2 * kBufs * kBfTile;  // [2][K, V][kBlockN] fp32
  static constexpr int kQ = kScl + 4 * kBlockN * 4;
  static constexpr int kBar = kQ + kBlockM * LD * 2;
  static constexpr int kSmem = kBar + 8 * kStages;
  static_assert(kRowBytes % 16 == 0, "rows are copied 16 bytes at a time");
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// exp2 on the special-function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 16 x 64 S tile of a warp in place, in the exp2
// domain (ksc holds K's scale times sm_scale log2(e)): with kMask, columns
// past a row's position or outside its window and sinks take kMaskValue and
// P exactly 0 (a row masked so
// far has m equal to the mask value, where exp2 alone would give 1).
// Rescales acc and this thread's share of l, and leaves P * v_scale in s.
template <bool kMask, int NJ>
__device__ __forceinline__ void tile_softmax(float (&s)[kBlockN / 8][4], const float* ksc,
                                             const float* vsc, float (&m_run)[2],
                                             float (&l_run)[2], float (&acc)[NJ][4],
                                             int c0, int pos_a, int pos_b, int window,
                                             int sinks, int t4) {
  float2 kc[kBlockN / 8];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    kc[j] = *reinterpret_cast<const float2*>(ksc + j * 8 + t4 * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= (e & 1) ? kc[j].y : kc[j].x;
      if (kMask) {
        const int col = c0 + j * 8 + t4 * 2 + (e & 1);
        const int pos = e < 2 ? pos_a : pos_b;
        if (col > pos || !in_window(pos, col, window, sinks)) s[j][e] = kMaskValue;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2_ftz(m_run[i] - m_new);
    m_run[i] = m_new;
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const float2 vc = *reinterpret_cast<const float2*>(vsc + j * 8 + t4 * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(s[j][e] - m_run[e >> 1]);
      if (kMask && s[j][e] == kMaskValue) p = 0.f;
      rsum[e >> 1] += p;
      s[j][e] = p * ((e & 1) ? vc.y : vc.x);  // P times the V scale, rounded later
    }
  }
  l_run[0] = l_run[0] * alpha[0] + rsum[0];
  l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// The tile bodies' order: block b runs row tile n_row_tiles - 1 - b /
// (num_seqs n_kv) of the slot ranked (b / n_kv) % num_seqs by length,
// longest first (ties by index), for KV head b % n_kv: the chunk's last rows
// of the longest slots, which walk the most columns, are handed out first.
// Sets hk and r0; the block's threads find the slot into *slot_s (read it
// after a barrier).
__device__ __forceinline__ void chunk_tile_order(int b, int rows, int num_seqs, int n_kv,
                                                 const int* lengths, int* slot_s,
                                                 int& hk, int& r0) {
  const int n_row_tiles = (rows + kBlockM - 1) / kBlockM;
  hk = b % n_kv;
  const int rank = (b / n_kv) % num_seqs;
  r0 = (n_row_tiles - 1 - b / (n_kv * num_seqs)) * kBlockM;
  for (int i = threadIdx.x; i < num_seqs; i += blockDim.x) {
    const int li = lengths[i];
    int above = 0;
    for (int j = 0; j < num_seqs; ++j) {
      const int lj = lengths[j];
      above += lj > li || (lj == li && j < i);
    }
    if (above == rank) *slot_s = i;
  }
}

template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(128)
paged_chunk_mma(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                const float* __restrict__ k_scales, const Tc* __restrict__ v_pages,
                const float* __restrict__ v_scales,
                const int* __restrict__ page_table, const int* __restrict__ lengths,
                Tq* __restrict__ out, int num_seqs, int chunk, int n_heads, int n_kv,
                int num_pages, int page_size, int pages_per_seq, float sm_scale,
                int window, int sinks) {
  using L = TileLayout<Tc, D>;
  constexpr int LD = L::LD;
  constexpr int S = L::kStages;
  constexpr int kVec = L::kRowBytes / 16;  // 16-byte pieces of a stored row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  const uint32_t bar0 = smem_addr(smem + L::kBar);
  __shared__ int slot_s;

  const int group = n_heads / n_kv;
  const int rows = chunk * group;
  int hk, r0;
  chunk_tile_order(blockIdx.x, rows, num_seqs, n_kv, lengths, &slot_s, hk, r0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the slot is known, the barriers are initialised
  const int slot = slot_s;
  const int base = lengths[slot] - chunk;  // position of query 0
  const int r_last = min(r0 + kBlockM, rows) - 1;
  const int kv_end = max(0, base + r_last / group + 1);
  const int pos_first = base + r0 / group;  // the tile's smallest position
  const int pos_last = base + r_last / group;
  // The 64-token tiles the rows attend: the sink tiles, then from the first
  // row's window start to the last row's position; step it is tile
  // walk.at(it), in raw stage it % S.
  const KvWalk walk(pos_first - window + 1, kv_end, sinks, kBlockN);
  const int n_it = walk.n;
  constexpr int P = L::kParts;  // raw steps u = it P + part a tile
  constexpr int kRawN = L::kRawN;
  const int n_u = n_it * P;
  const size_t pt_row = static_cast<size_t>(slot) * pages_per_seq;
  auto qrow = [&](int r) {  // element offset of the tile's row r in q / out
    const int rr = r0 + r;
    const int t = rr / group;
    return ((static_cast<size_t>(slot) * chunk + t) * n_heads + hk * group + rr -
            t * group) * D;
  };
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pages);
  auto page_of = [&](int it) {
    return page_table[pt_row + walk.at(it) * kBlockN / page_size];
  };
  // Raw step `u` (kRawN tokens of one page: part u % P of tile u / P) into
  // raw stage u % S; tokens at or past kv_end are zero-filled and not read.
  auto issue = [&](int u, int pid) {
    const int c0 = walk.at(u / P) * kBlockN + (u % P) * kRawN;
    const int page = c0 / page_size;
    const size_t row0 = (static_cast<size_t>(hk) * num_pages + pid) * page_size +
                        (c0 - page * page_size);
    const int valid = kv_end - c0;
    unsigned char* stage = smem + (u % S) * L::kRawStage;
    for (int i = tid; i < kRawN * kVec; i += 128) {
      const bool full = i / kVec < valid;
      cp_async16(smem_addr(stage + 16 * i), kp + row0 * L::kRowBytes + 16 * static_cast<size_t>(i),
                 full);
      cp_async16(smem_addr(stage + L::kRawTile + 16 * i),
                 vp + row0 * L::kRowBytes + 16 * static_cast<size_t>(i), full);
    }
    if (tid < kRawN / 4) {
      cp_async16(smem_addr(stage + 2 * L::kRawTile + 16 * tid), k_scales + row0 + 4 * tid,
                 4 * tid < valid);
    } else if (tid < kRawN / 2) {
      const int j = tid - kRawN / 4;
      cp_async16(smem_addr(stage + 2 * L::kRawTile + kRawN * 4 + 16 * j),
                 v_scales + row0 + 4 * j, 4 * j < valid);
    }
    cp_async_arrive(bar0 + 8 * (u % S));
  };
  for (int u = 0; u < S && u < n_u; ++u) issue(u, page_of(u / P));

  // Q tile, rounded to bf16 (no scale: sm_scale goes on the scores).
  for (int i = tid; i < kBlockM * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    float x[8];
    if (r0 + r < rows) {
      const Tq* src = q + qrow(r) + c;
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = to_float(src[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    *reinterpret_cast<uint4*>(qs + r * LD + c) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                   pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
  __syncthreads();
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  constexpr bool kHoldQ = D <= 128;  // TileLayout: read per k-step at D = 256
  auto q_frag = [&](uint32_t (&f)[4], int kk) {
    ldmatrix_x4(f, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  };
  uint32_t qa[kHoldQ ? D / 16 : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(qa[kk], kk);
  }
  // Positions of this thread's rows g and g + 8 (-1: past the last row).
  auto pos_of = [&](int r) { return r0 + r < rows ? base + (r0 + r) / group : -1; };
  const int pos_a = pos_of(warp * 16 + g);
  const int pos_b = pos_of(warp * 16 + g + 8);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int c0 = walk.at(it) * kBlockN;
    const int buf = L::kBufs == 1 ? 0 : it & 1;
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kBf + buf * 2 * L::kBfTile);
    __nv_bfloat16* vs = ks + kBlockN * LD;
    float* ksc = reinterpret_cast<float*>(smem + L::kScl) + buf * 2 * kBlockN;
    float* vsc = ksc + kBlockN;
#pragma unroll
    for (int part = 0; part < P; ++part) {
      const int u = it * P + part;
      // The page that refills this raw stage, read before the wait.
      const int next_pid = u + S < n_u ? page_of((u + S) / P) : 0;
      const unsigned char* raw = smem + (u % S) * L::kRawStage;
      mbar_wait(bar0 + 8 * (u % S), (u / S) & 1);
      // One pair: tile it - 1's products read it until here.
      if constexpr (L::kBufs == 1) {
        if (part == 0) __syncthreads();
      }
      // Decode the landed stage into rows [part kRawN, (part + 1) kRawN)
      // of bf16 tile it & 1, whose last readers (tile it - 2's products)
      // passed the barrier of tile it - 1.
      for (int i = tid; i < kRawN * kVec; i += 128) {
        const int r = i / kVec;
        const int cb = (i - r * kVec) * 16;
        decode16<Tc, D, LD>(ks, raw + 16 * i, part * kRawN + r, cb);
        decode16<Tc, D, LD>(vs, raw + L::kRawTile + 16 * i, part * kRawN + r, cb);
      }
      if (tid < kRawN) {
        const float* rs = reinterpret_cast<const float*>(raw + 2 * L::kRawTile);
        const int col = part * kRawN + tid;
        const bool in = c0 + col < kv_end;
        ksc[col] = in ? rs[tid] * sm_scale * kLog2e : 0.f;
        vsc[col] = in ? rs[kRawN + tid] : 0.f;
      }
      __syncthreads();  // the part is decoded; raw stage u % S is free
      if (u + S < n_u) issue(u + S, next_pid);
    }

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4];
      if constexpr (!kHoldQ) q_frag(qf, kk);
      const uint32_t* qk = kHoldQ ? qa[kHoldQ ? kk : 0] : qf;
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qk, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qk, bf[2], bf[3]);
      }
    }

    // Scale the score columns (the K scale times sm_scale log2(e)), mask
    // past each row's position on the tiles that reach past the tile's
    // first row (the diagonal and the kv_end tail) and on those some row's
    // window edge crosses, online softmax in the exp2 domain.
    if (c0 + kBlockN - 1 > pos_first || pos_last - c0 >= window) {
      tile_softmax<true>(s, ksc, vsc, m_run, l_run, acc, c0, pos_a, pos_b, window, sinks,
                         t4);
    } else {
      tile_softmax<false>(s, ksc, vsc, m_run, l_run, acc, c0, pos_a, pos_b, window, sinks,
                          t4);
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of k-step kk; V is read transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv_a = l_run[0] == 0.f ? 0.f : 1.f / l_run[0];
  const float inv_b = l_run[1] == 0.f ? 0.f : 1.f / l_run[1];
  const int ra = warp * 16 + g;
  const int rb = ra + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (r0 + ra < rows) {
      store2(out + qrow(ra) + col, acc[j][0] * inv_a, acc[j][1] * inv_a);
    }
    if (r0 + rb < rows) {
      store2(out + qrow(rb) + col, acc[j][2] * inv_b, acc[j][3] * inv_b);
    }
  }
}

// ===========================================================================
// (c) The fp32 tile body: the fp32 FMA block (csrc/fma_block.cuh).
// ===========================================================================

// Where a block's rows are (slot, KV head, first row r0 of the (t, g)
// rows, from chunk_tile_order) and how far its page loop runs.
struct Tile {
  int slot, hk, group, rows, r0, base, kv_end, n_tiles;
  KvWalk walk;    // step it is cached tile walk.at(it)
  size_t pt_row;  // page_table offset of the slot's row

  __device__ Tile(int slot_, int hk_, int r0_, int chunk, int n_heads, int n_kv,
                  const int* lengths, int pages_per_seq, int window, int sinks)
      : slot(slot_), hk(hk_), r0(r0_), walk(0, 0, 0, kBlockN) {
    group = n_heads / n_kv;
    rows = chunk * group;
    const int length = lengths[slot];
    base = length - chunk;  // position of query t = 0
    const int r_last = min(r0 + kBlockM, rows) - 1;
    // The last row attends columns < base + t_last + 1 (<= length); the
    // first keeps none before its window start but the sinks.
    kv_end = max(0, base + r_last / group + 1);
    walk = KvWalk(base + r0 / group - window + 1, kv_end, sinks, kBlockN);
    n_tiles = walk.n;
    pt_row = static_cast<size_t>(slot) * pages_per_seq;
  }

  // Position of row r of the tile (r0 + r), or -1 (nothing kept) past the
  // last row.
  __device__ __forceinline__ int pos(int r) const {
    const int rr = r0 + r;
    return rr < rows ? base + rr / group : -1;
  }

  // Element offset of row r in q / out.
  __device__ __forceinline__ size_t qrow(int r, int chunk, int n_heads,
                                         int d) const {
    const int rr = r0 + r;
    const int t = rr / group;
    const int h = hk * group + (rr - t * group);
    return ((static_cast<size_t>(slot) * chunk + t) * n_heads + h) * d;
  }

  // First cache row (a row index, in rows of one token) of the kBlockN
  // tokens from c0, which never cross a page.
  __device__ __forceinline__ size_t cache_row(const int* page_table, int c0,
                                              int num_pages,
                                              int page_size) const {
    const int page = c0 / page_size;
    const int pid = page_table[pt_row + page];
    return (static_cast<size_t>(hk) * num_pages + pid) * page_size +
           (c0 - page * page_size);
  }

  // Tokens of the tile from c0 that some row of the block attends.
  __device__ __forceinline__ int valid_cols(int c0) const {
    return min(kBlockN, kv_end - c0);
  }
};

// Shared memory and blocks an SM of the fp32 tile body: an fp32 cache takes
// B1's fp32 rings (FmaBlock: K by cp.async straight into its fp32 stages,
// two at D 64), every other cache the stored-width ring (FmaRaw).
template <typename Tc, int D>
struct ChunkFp32 {
  static constexpr bool kDirect = std::is_same<Tc, float>::value;
  static constexpr int kSmem =
      kDirect ? FmaBlock<D>::kSmem + 2 * kBlockN * 4 : FmaRaw<Tc, D>::kSmem;
  // No stored-width stage fits (FmaRaw::kStages 0): tiles decoded from
  // device memory, the scales after the fp32 tiles.
  static constexpr bool kGlobal = !kDirect && FmaRaw<Tc, D>::kStages == 0;
  static constexpr int kBlocksPerSm =
      kDirect ? FmaBlock<D>::kBlocksPerSm : FmaRaw<Tc, D>::kBlocksPerSm;
};

// One block per (64-row tile of the t-major rows, slot, KV head), in
// chunk_tile_order (the longest walks first): 128 threads, thread (ty, tx)
// holding S rows ty + 8 r and columns tx + 16 j (fma_block.cuh).  Q is
// loaded once (fp32, no scale); per cached tile of 64 tokens: S over d in
// order, S * (K's scale * sm_scale) on every column at or before the row's
// position and kMaskValue past it, the natural-exp online softmax, P * V's
// scale over the K stage, P V over the tile's keys in order.  An fp32 cache
// streams into FmaBlock's rings, its scales into a scale tile after them as
// the tile starts; any other cache arrives in its stored width with its
// scales in FmaRaw's ring, each tile decoded once into the fp32 K and V
// stages (V swizzled as K), its stage refilled once the softmax has read
// the scales.  Rows' positions sit in shared memory, not registers.
template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(kFmaThreads, ChunkFp32<Tc, D>::kBlocksPerSm)
paged_chunk_fp32(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                 const float* __restrict__ k_scales,
                 const Tc* __restrict__ v_pages,
                 const float* __restrict__ v_scales,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths, Tq* __restrict__ out,
                 int num_seqs, int chunk, int n_heads, int n_kv, int num_pages,
                 int page_size, int pages_per_seq, float sm_scale, int window,
                 int sinks) {
  constexpr bool kDirect = ChunkFp32<Tc, D>::kDirect;
  using B = FmaBlock<D>;
  using R = FmaRaw<Tc, D>;
  constexpr int DO = D / 16;  // output columns per thread
  constexpr int kRow = kRowBytesOf<Tc, D>;
  extern __shared__ __align__(16) unsigned char bytes[];
  __shared__ int pos_s[kBlockM];  // each row's position (-1 past the last)
  __shared__ int slot_s;
  float* smem = reinterpret_cast<float*>(bytes);
  const FmaStages<B> st(smem);
  const uint32_t raw_bar = smem_addr(bytes + R::kBar);
  float* qs = kDirect ? st.q() : smem + R::kQ;
  int hk, r0;
  chunk_tile_order(blockIdx.x, chunk * (n_heads / n_kv), num_seqs, n_kv, lengths, &slot_s,
                   hk, r0);
  __syncthreads();
  const Tile tile(slot_s, hk, r0, chunk, n_heads, n_kv, lengths, pages_per_seq, window,
                  sinks);
  const FmaThread th = fma_thread();
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v_pages);

  if (threadIdx.x == 0) {
    if constexpr (kDirect) {
      st.init();
    } else {
      for (int s = 0; s < R::kStages; ++s) mbar_init(raw_bar + 8 * s, kFmaThreads);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  if (threadIdx.x < kBlockM) pos_s[threadIdx.x] = tile.pos(threadIdx.x);
  // Q rows (fp32, no scale: sm_scale goes on the K scale), swizzled.
  for (int i = threadIdx.x; i < kBlockM * (D / 4); i += kFmaThreads) {
    const int r = i / (D / 4);
    const int c = i - r * (D / 4);
    const float4 x = tile.r0 + r < tile.rows
                         ? fma_load4(q + tile.qrow(r, chunk, n_heads, D) + 4 * c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + fma_swz<D>(r, c)) = x;
  }
  __syncthreads();
  const int n_it = tile.n_tiles;
  auto col_of = [&](int it) { return tile.walk.at(it) * kBlockN; };
  auto row_of = [&](int it) {
    return tile.cache_row(page_table, col_of(it), num_pages, page_size);
  };
  // Cached tile `it` (tokens at or past kv_end zero-filled and not read):
  // an fp32 cache's K or V into its fp32 stage, any other cache's K, V and
  // scales into the stored-width ring, from cache row row0.
  auto load_f32 = [&](float* dst, uint32_t bar, const unsigned char* pages, int it) {
    fma_load_tile<D, true>(dst, bar, reinterpret_cast<const float*>(pages) + row_of(it) * D,
                           0, tile.valid_cols(col_of(it)));
  };
  constexpr int RS = R::kStages > 0 ? R::kStages : 1;  // no ring: never read
  auto issue = [&](int it, size_t row0) {
    fma_raw_issue<Tc, D>(bytes + R::kRaw + (it % RS) * R::kStage,
                         raw_bar + 8 * (it % RS), kb + row0 * kRow,
                         vb + row0 * kRow, k_scales + row0, v_scales + row0,
                         tile.valid_cols(col_of(it)));
  };
  constexpr bool kGlobal = ChunkFp32<Tc, D>::kGlobal;
  if constexpr (kDirect) {
    for (int it = 0; it < B::kKStages && it < n_it; ++it) load_f32(st.k(it), st.k_bar(it), kb, it);
    for (int it = 0; it < B::kVStages && it < n_it; ++it) load_f32(st.v(it), st.v_bar(it), vb, it);
  } else if constexpr (!kGlobal) {
    for (int it = 0; it < R::kStages && it < n_it; ++it) issue(it, row_of(it));
  }

  float m_run[8], l_run[8], acc[8][DO];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DO; ++c) acc[r][c] = 0.f;
  }
  for (int it = 0; it < n_it; ++it) {
    const int c0 = col_of(it);
    float* kf;
    const float* vf;
    const float* sc;  // the tile's K scales, then its V scales
    if constexpr (kDirect) {
      // One scale per thread into the block's scale tile, read after the
      // barrier that follows S (the previous tile's were read before the
      // barrier that preceded its P V).
      float* scl = reinterpret_cast<float*>(bytes + B::kSmem);
      const int col = threadIdx.x & (kBlockN - 1);
      const float* src = threadIdx.x < kBlockN ? k_scales : v_scales;
      scl[threadIdx.x] = col < tile.valid_cols(c0) ? src[row_of(it) + col] : 0.f;
      sc = scl;
      st.wait_k(it);
      kf = st.k(it);
      vf = st.v(it);
    } else if constexpr (kGlobal) {
      // Tile it - 1's P V read the tiles and scales before the loop's last
      // barrier.
      float* scl = smem + R::kRaw / 4;
      const int valid = tile.valid_cols(c0);
      const size_t row0 = row_of(it);
      const int col = threadIdx.x & (kBlockN - 1);
      const float* src = threadIdx.x < kBlockN ? k_scales : v_scales;
      scl[threadIdx.x] = col < valid ? src[row0 + col] : 0.f;
      sc = scl;
      kf = smem + R::kK;
      vf = smem + R::kV;
      fma_decode_global<Tc, D>(kf, kb + row0 * kRow, valid);
      fma_decode_global<Tc, D>(smem + R::kV, vb + row0 * kRow, valid);
      __syncthreads();  // K, V decoded
    } else {
      const unsigned char* stage = bytes + R::kRaw + (it % RS) * R::kStage;
      kf = smem + R::kK;
      vf = smem + R::kV;
      sc = reinterpret_cast<const float*>(stage + 2 * R::kTile);
      mbar_wait(raw_bar + 8 * (it % RS), (it / RS) & 1);
      fma_decode_tile<Tc, D>(kf, stage);
      fma_decode_tile<Tc, D>(smem + R::kV, stage + R::kTile);
      __syncthreads();  // K, V decoded
    }
    float s[8][4];
    fma_scores<D>(qs, kf, th, s);
    float* ps = kf;
    __syncthreads();  // K(it) is read: P takes its stage

    // Scale the columns each row attends, kMaskValue past its position;
    // natural-exp online softmax; P times V's scale.  l_run is this
    // thread's share of the row sum.
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int pos = pos_s[th.ty + 8 * r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + th.tx + 16 * j;
        s[r][j] = col <= pos && in_window(pos, col, window, sinks)
                      ? s[r][j] * (sc[th.tx + 16 * j] * sm_scale)
                      : kMaskValue;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = fma_row_max(mx);
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + th.tx + 16 * j;
        const float p =
            col <= pos && in_window(pos, col, window, sinks) ? expf(s[r][j] - m_new) : 0.f;
        rs += p;
        fma_store_p(ps, th, r, j, p * sc[kBlockN + th.tx + 16 * j]);
      }
      l_run[r] = l_run[r] * alpha + rs;
#pragma unroll
      for (int c = 0; c < DO; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // P is in place; the scales are read
    if constexpr (kDirect) {
      st.wait_v(it);
    } else if constexpr (!kGlobal) {
      if (it + R::kStages < n_it) {  // the stage refills with tile it + kStages
        issue(it + R::kStages, row_of(it + R::kStages));
      }
    }
    fma_pv<D, true>(ps, vf, th, acc);
    __syncthreads();  // P and V(it) are read
    if constexpr (kDirect) {  // refill the stages tile it used
      if (it + B::kKStages < n_it) {
        load_f32(st.k(it + B::kKStages), st.k_bar(it + B::kKStages), kb, it + B::kKStages);
      }
      if (it + B::kVStages < n_it) {
        load_f32(st.v(it + B::kVStages), st.v_bar(it + B::kVStages), vb, it + B::kVStages);
      }
    }
  }

  // out = acc / l, zeros where l == 0 (no column: an inactive slot).
  float inv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float l = fma_row_sum(l_run[r]);
    inv[r] = l == 0.f ? 0.f : 1.f / l;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int rr = th.ty + 8 * r;
    if (tile.r0 + rr >= tile.rows) continue;
    fma_store_cols<D>(out + tile.qrow(rr, chunk, n_heads, D), th, acc[r], inv[r]);
  }
}

// ===========================================================================
// Host side.
// ===========================================================================

struct Args {
  const void *q, *k_pages, *k_scales, *v_pages, *v_scales, *page_table,
      *lengths;
  void* out;
  float* partial;
  int* counters;
  int num_seqs, chunk, n_heads, n_kv_heads, num_pages, page_size,
      pages_per_seq, n_splits;
  float sm_scale;
  bool bf16_compute;
  int window, sinks;
  cudaStream_t stream;
};

template <typename Tq, typename Tc, int D, bool MMA>
cudaError_t launch_split(const Args& a) {
  using L = SplitLayout<Tc, D, MMA>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      set_smem_once(paged_chunk_split<Tq, Tc, D, MMA>, L::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = a.chunk * (a.n_heads / a.n_kv_heads);
  const int span = live_page_span(a.pages_per_seq, a.page_size, a.window + a.chunk - 1, a.sinks);
  const int pages_per_split = (span + a.n_splits - 1) / a.n_splits;
  const dim3 grid(a.n_splits, a.num_seqs, a.n_kv_heads * ((rows + kRowTile - 1) / kRowTile));
  paged_chunk_split<Tq, Tc, D, MMA><<<grid, kThreads, L::kSmem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
      static_cast<const float*>(a.k_scales), static_cast<const Tc*>(a.v_pages),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.partial,
      a.counters, a.chunk, a.n_heads, a.n_kv_heads, a.num_pages, a.page_size,
      a.pages_per_seq, pages_per_split, a.sm_scale, a.window, a.sinks);
  return cudaGetLastError();
}

// The split body: bf16 compute on the tensor cores, fp32 compute on the FMA
// units, in ceil(T * group / kRowTile) row tiles a KV head
// (decode/attention.py::chunk_row_tiles).
template <typename Tq, typename Tc, int D>
cudaError_t launch(const Args& a) {
  const int rows = a.chunk * (a.n_heads / a.n_kv_heads);
  if (rows <= kSplitRows) {
    return a.bf16_compute ? launch_split<Tq, Tc, D, true>(a)
                          : launch_split<Tq, Tc, D, false>(a);
  }
  const int row_tiles = (rows + kBlockM - 1) / kBlockM;
  if (a.bf16_compute) {
    using L = TileLayout<Tc, D>;
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(paged_chunk_mma<Tq, Tc, D>, L::kSmem, smem_set);
    if (err != cudaSuccess) return err;
    paged_chunk_mma<Tq, Tc, D><<<row_tiles * a.num_seqs * a.n_kv_heads, 128, L::kSmem,
                                 a.stream>>>(
        static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
        static_cast<const float*>(a.k_scales), static_cast<const Tc*>(a.v_pages),
        static_cast<const float*>(a.v_scales), static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.num_seqs,
        a.chunk, a.n_heads, a.n_kv_heads, a.num_pages, a.page_size, a.pages_per_seq,
        a.sm_scale, a.window, a.sinks);
  } else {
    constexpr int kSmem = ChunkFp32<Tc, D>::kSmem;
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(paged_chunk_fp32<Tq, Tc, D>, kSmem, smem_set);
    if (err != cudaSuccess) return err;
    paged_chunk_fp32<Tq, Tc, D><<<row_tiles * a.num_seqs * a.n_kv_heads, kFmaThreads,
                                  kSmem, a.stream>>>(
        static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
        static_cast<const float*>(a.k_scales), static_cast<const Tc*>(a.v_pages),
        static_cast<const float*>(a.v_scales), static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.num_seqs,
        a.chunk, a.n_heads, a.n_kv_heads, a.num_pages, a.page_size, a.pages_per_seq,
        a.sm_scale, a.window, a.sinks);
  }
  return cudaGetLastError();
}

template <typename Tq, typename Tc>
cudaError_t launch_d(int head_dim, const Args& a) {
#define CFA_CASE(D) \
  if (head_dim == D) return launch<Tq, Tc, D>(a);
  CFA_HEAD_DIMS(CFA_CASE)
#undef CFA_CASE
  return cudaErrorInvalidValue;
}

template <typename Tq>
cudaError_t launch_cache(int cache_dtype, int head_dim, const Args& a) {
  switch (cache_dtype) {
    case 0:
      return launch_d<Tq, float>(head_dim, a);
    case 1:
      return launch_d<Tq, __nv_bfloat16>(head_dim, a);
    case 2:
      return launch_d<Tq, int8_t>(head_dim, a);
    case 3:
      return launch_d<Tq, __nv_fp8_e4m3>(head_dim, a);
    case 4:
      return launch_d<Tq, __nv_fp8_e5m2>(head_dim, a);
    case 5:
      return launch_d<Tq, Int4x2>(head_dim, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of the workspace that a call with n_splits > 1 takes (the split
// body only, T * group <= 64): each split's (acc [rows, D], then (m, l)
// [rows]) for every (slot, KV head), rows = T * group.
long long cfa_paged_chunk_workspace_floats(int num_seqs, int chunk, int n_heads,
                                           int n_kv_heads, int head_dim,
                                           int n_splits) {
  const bool split_body = chunk * (n_heads / n_kv_heads) <= kSplitRows;
  return split_body && n_splits > 1
             ? static_cast<long long>(num_seqs) * n_splits * chunk * n_heads *
                   (head_dim + 2)
             : 0;
}

// q, out [num_seqs, chunk, n_heads, head_dim] (fp32, or bf16 when q_bf16);
// k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim] of
// cache_dtype 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8 e4m3, 4 = fp8 e5m2, or
// 5 = int4 [.., head_dim / 2] split-half; k_scales, v_scales
// [n_kv_heads, num_pages, page_size] fp32; page_table [num_seqs,
// pages_per_seq] int32; lengths [num_seqs] int32, the total length with the
// chunk.  page_size is a multiple of 128 and n_heads / n_kv_heads <= 8.
// window (>= 1; kNoWindow: none) and sinks: query t at position pos =
// length - chunk + t keeps col > pos - window and col < sinks.
// chunk * group <= 64 takes the split body: the n_splits (at most
// live_page_span(pages_per_seq, page_size, window + chunk - 1, sinks))
// share out each row tile's live walk, p = ceil(that span / n_splits)
// pages' worth of chunks each, and with
// n_splits > 1 workspace holds cfa_paged_chunk_workspace_floats fp32 values
// and counters num_seqs * n_kv_heads * ceil(chunk * group / 16) int32
// zeros, which the call leaves zero.  A larger chunk * group takes a tile body and n_splits 1.
// Returns a cudaError_t.
int cfa_paged_chunk(const void* q, const void* k_pages, const void* k_scales,
                    const void* v_pages, const void* v_scales,
                    const void* page_table, const void* lengths, void* out,
                    int num_seqs, int chunk, int n_heads, int n_kv_heads,
                    int num_pages, int page_size, int pages_per_seq,
                    int head_dim, float sm_scale, int q_bf16, int cache_dtype,
                    int bf16_compute, int window, int sinks, int n_splits,
                    void* workspace, void* counters, void* stream) {
  if (page_size % 128 != 0 || n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroup || chunk < 1 || num_seqs < 1 ||
      window < 1 || window > kNoWindow || sinks < 0 || n_splits < 1 ||
      n_splits > live_page_span(pages_per_seq, page_size, window + chunk - 1, sinks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool split_body = chunk * (n_heads / n_kv_heads) <= kSplitRows;
  if ((!split_body && n_splits != 1) ||
      (n_splits > 1 && (workspace == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,          k_pages,  k_scales,  v_pages,
               v_scales,   page_table, lengths, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               num_seqs,   chunk,    n_heads,   n_kv_heads,
               num_pages,  page_size, pages_per_seq, n_splits,
               sm_scale,   bf16_compute != 0, window,   sinks,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16) {
    return static_cast<int>(launch_cache<__nv_bfloat16>(cache_dtype, head_dim, a));
  }
  return static_cast<int>(launch_cache<float>(cache_dtype, head_dim, a));
}

const char* cfa_paged_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
