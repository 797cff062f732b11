// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/decode/attention.py::paged_decode_attention
//   (body _decode_kernel).
// One query token per sequence slot attends over that slot's pages of the
// paged KV cache: pages [Hkv, P, page, D] of int8, fp8 (e4m3 / e5m2), bf16
// or fp32, or packed int4 [Hkv, P, page, D/2] (split-half: byte j holds
// element j in the low nibble and element j + D/2 in the high one), with
// fp32 per-token scales [Hkv, P, page]; the page table [n, pages_per_seq] maps the
// slot's logical pages to physical ones; lengths [n] gives each slot's
// token count (0 for an inactive slot, whose output is zeros).
//
// What bounds it on the H100: bytes.  Each live K/V element is read once and
// used by the `group` query heads that share its KV head (2 at the base
// model), so the kernel does ~2 * group FLOPs per cached byte against a
// ~295 FLOP/byte ridge; the floor is the live pages' bytes (K and V plus
// their scales) at 3.35 TB/s, which fp8 keeps at int8's and int4 halves.
// At serving's batch (8 slots x 8 KV heads) one block per (slot, KV head)
// leaves most SMs idle and walks a long slot's pages one after another, so
// the time is the latency of that walk, not the bytes.  The design:
//   * flash-decoding's split-KV: the grid is (split, slot, KV head), and a
//     block walks its split's contiguous run of the slot's pages (the
//     wrapper picks the split count from shapes alone, so the launch reads
//     no length on the host and can be captured in a CUDA graph).  A block
//     visits only live pages (p * page < length): a dead table entry is
//     never dereferenced and no dead byte is moved;
//   * inside a block, 128-token chunks of K and V with their scales arrive
//     by cp.async into a ring of up to three stages, each completing on its
//     own mbarrier, so the next chunks land while one is scored; a chunk is
//     copied in its stored width and decoded in registers (fp8 by the
//     card's exact conversion, int8 and int4 by the 2^23 magic number, as
//     integer-to-float conversions run at a quarter of the FMA rate); the
//     K scale multiplies the score column and the V scale multiplies P, as
//     the TPU kernel does; no dequantized page is ever written; a block
//     reads the page id of the chunk that refills a stage while it
//     computes the chunk before;
//   * each warp owns 32 tokens of a chunk and keeps its own fp32 online
//     softmax (natural exp, as the TPU kernel) for all `group` query heads
//     of the KV head: lane t scores token t, then the warp forms P V with
//     lane l owning output columns [l D/32, (l + 1) D/32), so a chunk needs
//     one block barrier (the stage is free) and no block-wide max or sum;
//   * the block folds its four warps' states in warp order.  A split with
//     no live page returns at once (split 0 of an empty slot writes its
//     zeros), and a slot whose live pages fit one split writes its output
//     from that block.  Otherwise every live split stores (m, l, acc) in
//     fp32 to a workspace; the block that arrives last at its (slot, KV
//     head) counter folds the live splits in split order, writes the
//     output and resets the counter to 0.  So one launch does the whole
//     call, results are bitwise the same run to run, and no memset is
//     needed between calls.  The counters are one buffer per device shared
//     by every call: two calls running at once on two streams would race
//     on them (the serving engine uses one stream);
//   * the kernel is instantiated for groups of at most 2 (the base model's)
//     and of at most 8, so the common case keeps no dead per-head state.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"
#include "paged_kv.cuh"

namespace {

constexpr int kThreads = 128;  // tokens per chunk: one lane per token in S
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;   // query heads per KV head
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr int kRingBudget = 140 * 1024;  // shared bytes the ring may take

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Value of a cache element in the compute type, as fp32.  int8, int4, fp8
// and bf16 are exact in bf16; an fp32 cache read with bf16 compute rounds.
template <typename Tc>
__device__ __forceinline__ float cache_value(Tc x, bool bf16_compute) {
  const float f = to_float(x);
  if constexpr (std::is_same<Tc, float>::value) return bf16_compute ? round_bf16(f) : f;
  return f;
}

// Shared memory of a block, in bytes: the ring (kStages stages of a K
// chunk, a V chunk and their scales; rows padded by 16 bytes, so lane t's
// 16-byte reads of row t are conflict-free), Q [kMaxGroup][D] fp32, the
// warps' P [kWarps][kMaxGroup][32] fp32 and one mbarrier per stage.  The
// warps' states are folded through the ring once it is drained.
template <typename Tc, int D>
struct DecodeLayout {
  static constexpr int kRowBytes = kRowBytesOf<Tc, D>;
  static constexpr int kStride = kRowBytes + 16;
  static constexpr int kTileBytes = kThreads * kStride;
  static constexpr int kScaleOff = 2 * kTileBytes;
  static constexpr int kStageBytes = kScaleOff + 2 * kThreads * 4;
  static constexpr int kStages =
      std::min(3, std::max(1, kRingBudget / kStageBytes));
  static constexpr int kQOff = kStages * kStageBytes;
  static constexpr int kPOff = kQOff + kMaxGroup * D * 4;
  static constexpr int kBarOff = kPOff + kWarps * kMaxGroup * 32 * 4;
  static constexpr int kSmem = kBarOff + 8 * kStages;
  static_assert(kRowBytes % 16 == 0, "rows are copied 16 bytes at a time");
  static_assert(kWarps * kMaxGroup * (D + 2) * 4 <= kQOff,
                "the warps' states fit the drained ring");
  static_assert(kSmem <= 232448, "one block must fit the SM's 227 KB");
};

// Chunk `row0` (128 rows of one KV head's page, contiguous) of K and V and
// their scales into `stage` by cp.async: this thread's share, then its
// arrival on `bar`.  Every thread calls it for every chunk it waits on.
template <typename Tc, int D>
__device__ __forceinline__ void load_chunk(unsigned char* stage, uint32_t bar,
                                           const unsigned char* k_pages,
                                           const unsigned char* v_pages,
                                           const float* k_scales,
                                           const float* v_scales, size_t row0) {
  using L = DecodeLayout<Tc, D>;
  constexpr int kVec = L::kRowBytes / 16;
  const unsigned char* ksrc = k_pages + row0 * L::kRowBytes;
  const unsigned char* vsrc = v_pages + row0 * L::kRowBytes;
  for (int i = threadIdx.x; i < kThreads * kVec; i += kThreads) {
    const int r = i / kVec;
    const int cb = (i - r * kVec) * 16;
    cp_async16(smem_addr(stage + r * L::kStride + cb), ksrc + static_cast<size_t>(i) * 16,
               true);
    cp_async16(smem_addr(stage + L::kTileBytes + r * L::kStride + cb),
               vsrc + static_cast<size_t>(i) * 16, true);
  }
  const int t = threadIdx.x;
  if (t < 32) {
    cp_async16(smem_addr(stage + L::kScaleOff + 16 * t), k_scales + row0 + 4 * t, true);
  } else if (t < 64) {
    cp_async16(smem_addr(stage + L::kScaleOff + kThreads * 4 + 16 * (t - 32)),
               v_scales + row0 + 4 * (t - 32), true);
  }
  cp_async_arrive(bar);
}

// s[g] += Q[g][d0 + j] K[row][d0 + j] for j < 4, in order, for the
// group's heads (G at most, `group` of them).
template <int G>
__device__ __forceinline__ void fma4(const float* qf, int D, int d0, int group,
                                     const float (&kv)[4], float (&s)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      const float4 q4 = *reinterpret_cast<const float4*>(qf + g * D + d0);
      s[g] = fmaf(q4.x, kv[0], s[g]);
      s[g] = fmaf(q4.y, kv[1], s[g]);
      s[g] = fmaf(q4.z, kv[2], s[g]);
      s[g] = fmaf(q4.w, kv[3], s[g]);
    }
  }
}

// s[g] = sum over d, in order, of Q[g][d] K[row][d] for the group's heads
// (int4: byte by byte, its low nibble, element j, before its high one,
// element j + D/2).
template <typename Tc, int D, int G>
__device__ __forceinline__ void score_row(const unsigned char* krow,
                                          const float* qf, int group, bool bf16c,
                                          float (&s)[G]) {
#pragma unroll(G > 2 ? 1 : 2)
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
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float4 ql = *reinterpret_cast<const float4*>(qf + g * D + j);
            const float4 qh = *reinterpret_cast<const float4*>(qf + g * D + j + D / 2);
            s[g] = fmaf(ql.x, lo[0], s[g]);
            s[g] = fmaf(qh.x, hi[0], s[g]);
            s[g] = fmaf(ql.y, lo[1], s[g]);
            s[g] = fmaf(qh.y, hi[1], s[g]);
            s[g] = fmaf(ql.z, lo[2], s[g]);
            s[g] = fmaf(qh.z, hi[2], s[g]);
            s[g] = fmaf(ql.w, lo[3], s[g]);
            s[g] = fmaf(qh.w, hi[3], s[g]);
          }
        }
      }
    } else if constexpr (std::is_same<Tc, int8_t>::value) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float kv[4];
        int8x4_to_float(w[k], kv);
        fma4<G>(qf, D, b0 + 4 * k, group, kv, s);
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
        for (int u = 0; u < 4; ++u) kv[u] = cache_value(e[j + u], bf16c);
        fma4<G>(qf, D, d0 + j, group, kv, s);
      }
    }
  }
}

// Lane `lane`'s D/32 elements [lane D/32, (lane + 1) D/32) of a staged V
// row, in the compute type as fp32.
template <typename Tc, int D>
__device__ __forceinline__ void v_elems(const unsigned char* vrow, int lane,
                                        bool bf16c, float (&vv)[D / 32]) {
  constexpr int kE = D / 32;
  if constexpr (kPacked<Tc> || std::is_same<Tc, int8_t>::value) {
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
    for (int i = 0; i < kE; ++i) vv[i] = cache_value(e[i], bf16c);
  }
}

// G is the group's upper bound (2, or kMaxGroup): the kernel keeps G
// heads' states, so the base model's group of 2 holds no dead registers.
template <typename Tq, typename Tc, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                    const float* __restrict__ k_scales,
                    const Tc* __restrict__ v_pages,
                    const float* __restrict__ v_scales,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, Tq* __restrict__ out,
                    float* __restrict__ partial, int* __restrict__ counters,
                    int n_heads, int num_pages, int page_size, int pages_per_seq,
                    int pages_per_split, float sm_scale, int bf16_compute) {
  using L = DecodeLayout<Tc, D>;
  constexpr int kE = D / 32;  // output columns per lane in P V
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem + L::kQOff);
  float* ps = reinterpret_cast<float*>(smem + L::kPOff);
  const uint32_t bar0 = smem_addr(smem + L::kBarOff);
  __shared__ int last_block;

  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int slot = blockIdx.y;
  const int hk = blockIdx.z;
  const int n_kv = gridDim.z;
  const int group = n_heads / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bf16c = bf16_compute != 0;
  const int length = lengths[slot];
  // Splits holding a live page; split 0 also answers an empty slot (zeros).
  // The others have nothing to do.
  const int live_pages = (length + page_size - 1) / page_size;
  const int n_live = max(1, (live_pages + pages_per_split - 1) / pages_per_split);
  if (split >= n_live) return;
  const size_t q_base = (static_cast<size_t>(slot) * n_heads + hk * group) * D;

  // This split's tokens: its pages' tokens before `length`.
  const int tok_begin = split * pages_per_split * page_size;
  const int tok_end =
      min(length, min(pages_per_seq, (split + 1) * pages_per_split) * page_size);
  const int n_chunks = tok_end > tok_begin ? (tok_end - tok_begin + kThreads - 1) / kThreads : 0;
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pages);
  // Chunk c's physical page, and its copy into stage c % S.
  auto page_of = [&](int c) {
    return page_table[static_cast<size_t>(slot) * pages_per_seq +
                      (tok_begin + c * kThreads) / page_size];
  };
  auto issue = [&](int c, int pid) {
    const int tok0 = tok_begin + c * kThreads;
    const int page = tok0 / page_size;
    const size_t row0 = (static_cast<size_t>(hk) * num_pages + pid) * page_size +
                        (tok0 - page * page_size);
    load_chunk<Tc, D>(smem + (c % S) * L::kStageBytes, bar0 + 8 * (c % S), kp, vp,
                      k_scales, v_scales, row0);
  };

  float m_run[G], l_part[G], acc[G][kE];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_part[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  if (n_chunks > 0) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bar0 + 8 * s, kThreads);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barriers are initialised
    for (int c = 0; c < S && c < n_chunks; ++c) issue(c, page_of(c));
    for (int i = tid; i < group * D; i += kThreads) {
      const float x = to_float(q[q_base + i]);
      qf[i] = bf16c ? round_bf16(x) : x;
    }
    __syncthreads();  // Q is staged

    float* pw = ps + warp * kMaxGroup * 32;
    for (int c = 0; c < n_chunks; ++c) {
      // The page that refills this stage, read while the chunk is computed.
      const int next_pid = c + S < n_chunks ? page_of(c + S) : 0;
      const unsigned char* stage = smem + (c % S) * L::kStageBytes;
      mbar_wait(bar0 + 8 * (c % S), (c / S) & 1);
      const int tok0 = tok_begin + c * kThreads;
      if (tok0 + warp * 32 < length) {  // the warp holds a live token
        const int t = warp * 32 + lane;
        const bool valid = tok0 + t < length;
        const float* ksc = reinterpret_cast<const float*>(stage + L::kScaleOff);
        const float* vsc = ksc + kThreads;
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = 0.f;
        score_row<Tc, D, G>(stage + t * L::kStride, qf, group, bf16c, s);
        const float col_scale = ksc[t] * sm_scale;
        const float v_scale = vsc[t];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group) {
            const float sg = valid ? s[g] * col_scale : kMaskValue;
            float mx = sg;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            }
            const float m_new = fmaxf(m_run[g], mx);
            const float alpha = expf(m_run[g] - m_new);
            m_run[g] = m_new;
            const float p = valid ? expf(sg - m_new) : 0.f;
            l_part[g] = l_part[g] * alpha + p;
            pw[g * 32 + lane] = bf16c ? round_bf16(p * v_scale) : p * v_scale;
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
          }
        }
        __syncwarp();
        // P V over the warp's 32 tokens, in order (four at a time; two such
        // steps in flight where the group is small, one where it is not,
        // which kept fp32 pages at D 64 from spilling).
        const unsigned char* vbase = stage + L::kTileBytes + warp * 32 * L::kStride;
#pragma unroll(G > 2 ? 1 : 2)
        for (int t0 = 0; t0 < 32; t0 += 4) {
          float4 p4[G];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g < group) p4[g] = *reinterpret_cast<const float4*>(pw + g * 32 + t0);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float vv[kE];
            v_elems<Tc, D>(vbase + (t0 + u) * L::kStride, lane, bf16c, vv);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (g < group) {
                const float p = u == 0 ? p4[g].x : u == 1 ? p4[g].y : u == 2 ? p4[g].z
                                                                             : p4[g].w;
#pragma unroll
                for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with the stage and its P
      if (c + S < n_chunks) issue(c + S, next_pid);
    }
  }

  // Fold the four warps' states in warp order (through the drained ring);
  // a warp that saw no live token has l = 0 and is left out.
  float* red_acc = reinterpret_cast<float*>(smem);          // [kWarps][kMaxGroup][D]
  float* red_m = red_acc + kWarps * kMaxGroup * D;           // [kWarps][kMaxGroup]
  float* red_l = red_m + kWarps * kMaxGroup;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      float l = l_part[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        red_acc[(warp * kMaxGroup + g) * D + lane * kE + e] = acc[g][e];
      }
      if (lane == 0) {
        red_m[warp * kMaxGroup + g] = m_run[g];
        red_l[warp * kMaxGroup + g] = l;
      }
    }
  }
  __syncthreads();
  const size_t part = (static_cast<size_t>(slot) * n_kv + hk) * n_splits;
  float* part_acc = partial;                                          // [.., group, D]
  float2* part_ml = reinterpret_cast<float2*>(
      partial + static_cast<size_t>(gridDim.y) * n_heads * n_splits * D);  // [.., group]
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      if (red_l[w * kMaxGroup + g] > 0.f) m = fmaxf(m, red_m[w * kMaxGroup + g]);
    }
    float a = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float lw = red_l[w * kMaxGroup + g];
      if (lw > 0.f) {
        const float f = expf(red_m[w * kMaxGroup + g] - m);
        a = fmaf(red_acc[(w * kMaxGroup + g) * D + (i - g * D)], f, a);
        l = fmaf(lw, f, l);
      }
    }
    if (n_live == 1) {
      store(out + q_base + i, a * (l == 0.f ? 0.f : 1.f / l));
    } else {
      part_acc[(part + split) * group * D + i] = a;
      if (i - g * D == 0) part_ml[(part + split) * group + g] = make_float2(m, l);
    }
  }
  if (n_live == 1) return;

  // The last live split of this (slot, KV head) to arrive folds all of
  // them, in split order (each holds a live token, so l > 0).
  __threadfence();  // this block's partial is visible before its arrival
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(counters + slot * n_kv + hk, 1) == n_live - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < group * D; i += kThreads) {
    const int g = i / D;
    float m = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      m = fmaxf(m, __ldcg(part_ml + (part + s) * group + g).x);
    }
    float a = 0.f, l = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_live; ++s) {
      const float2 ml = __ldcg(part_ml + (part + s) * group + g);
      const float f = expf(ml.x - m);
      a = fmaf(__ldcg(part_acc + (part + s) * group * D + i), f, a);
      l = fmaf(ml.y, f, l);
    }
    store(out + q_base + i, a * (1.f / l));
  }
  if (tid == 0) counters[slot * n_kv + hk] = 0;  // ready for the next call
}

struct Args {
  const void *q, *k_pages, *k_scales, *v_pages, *v_scales, *page_table, *lengths;
  void* out;
  float* partial;
  int* counters;
  int num_seqs, n_heads, n_kv_heads, num_pages, page_size, pages_per_seq,
      n_splits;
  float sm_scale;
  int bf16_compute;
  cudaStream_t stream;
};

template <typename Tq, typename Tc, int D, int G>
cudaError_t launch_g(const Args& a) {
  using L = DecodeLayout<Tc, D>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err =
      set_smem_once(paged_decode_kernel<Tq, Tc, D, G>, L::kSmem, smem_set);
  if (err != cudaSuccess) return err;
  const int pages_per_split = (a.pages_per_seq + a.n_splits - 1) / a.n_splits;
  const dim3 grid(a.n_splits, a.num_seqs, a.n_kv_heads);
  paged_decode_kernel<Tq, Tc, D, G><<<grid, kThreads, L::kSmem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
      static_cast<const float*>(a.k_scales), static_cast<const Tc*>(a.v_pages),
      static_cast<const float*>(a.v_scales), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.partial,
      a.counters, a.n_heads, a.num_pages, a.page_size, a.pages_per_seq,
      pages_per_split, a.sm_scale, a.bf16_compute);
  return cudaGetLastError();
}

template <typename Tq, typename Tc, int D>
cudaError_t launch(const Args& a) {
  return a.n_heads / a.n_kv_heads <= 2 ? launch_g<Tq, Tc, D, 2>(a)
                                       : launch_g<Tq, Tc, D, kMaxGroup>(a);
}

template <typename Tq, typename Tc>
cudaError_t launch_d(int head_dim, const Args& a) {
  if (head_dim == 64) return launch<Tq, Tc, 64>(a);
  if (head_dim == 128) return launch<Tq, Tc, 128>(a);
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

// Floats of the workspace that a call with n_splits > 1 takes: each split's
// (acc [group, D], then (m, l)) for every (slot, query head).
long long cfa_paged_decode_workspace_floats(int num_seqs, int n_heads,
                                            int head_dim, int n_splits) {
  return n_splits > 1
             ? static_cast<long long>(num_seqs) * n_heads * n_splits * (head_dim + 2)
             : 0;
}

// q, out [num_seqs, n_heads, head_dim] (fp32, or bf16 when q_bf16);
// k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim] of
// cache_dtype 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8 e4m3, 4 = fp8 e5m2, or
// 5 = int4 [.., head_dim / 2] split-half; k_scales, v_scales
// [n_kv_heads, num_pages, page_size] fp32; page_table [num_seqs,
// pages_per_seq] int32; lengths [num_seqs] int32.  page_size is a multiple
// of 128 and n_heads / n_kv_heads <= 8.  Split s of the n_splits walks
// pages [s p, (s + 1) p), p = ceil(pages_per_seq / n_splits).  With
// n_splits > 1, workspace holds cfa_paged_decode_workspace_floats fp32
// values and counters num_seqs * n_kv_heads int32 zeros, which the call
// leaves zero.  Returns a cudaError_t.
int cfa_paged_decode(const void* q, const void* k_pages, const void* k_scales,
                     const void* v_pages, const void* v_scales,
                     const void* page_table, const void* lengths, void* out,
                     int num_seqs, int n_heads, int n_kv_heads, int num_pages,
                     int page_size, int pages_per_seq, int head_dim,
                     float sm_scale, int q_bf16, int cache_dtype,
                     int bf16_compute, int n_splits, void* workspace,
                     void* counters, void* stream) {
  if (page_size % kThreads != 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroup || n_splits < 1 ||
      n_splits > pages_per_seq ||
      (n_splits > 1 && (workspace == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k_pages, k_scales, v_pages, v_scales, page_table, lengths, out,
               static_cast<float*>(workspace), static_cast<int*>(counters),
               num_seqs, n_heads, n_kv_heads, num_pages, page_size,
               pages_per_seq, n_splits, sm_scale, bf16_compute,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16) {
    return static_cast<int>(launch_cache<__nv_bfloat16>(cache_dtype, head_dim, a));
  }
  return static_cast<int>(launch_cache<float>(cache_dtype, head_dim, a));
}

const char* cfa_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
