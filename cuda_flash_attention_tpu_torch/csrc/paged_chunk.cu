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
// ~20 FLOPs per int8 byte against a ~295 FLOP/byte ridge: bytes, as B5.  At
// chunked prefill's T = 512 a K/V element serves up to 1024 rows: tensor-
// core operations, as the FA2 forward.  What the design does about it:
//   * one thread block per (64-row tile of the (t, g) rows, slot, KV head):
//     at T = 512 that is 16 tiles per (slot, head), enough blocks to fill
//     the card; at T <= 5 one tile holds all rows, so each live K/V byte is
//     read once per (slot, head), as in B5;
//   * the block reads its own live page ids from the table and its page
//     loop stops at its last row's position (the causal skip, as B1 stops
//     at the diagonal), so no dead page and no column past the tile's bound
//     is moved;
//   * 64-token K and V tiles (never crossing a page: pages are multiples of
//     128) are staged in shared memory with 16-byte loads of their stored
//     width and decoded in registers on the way (fp8 by the card's exact
//     conversion, int4 by nibble sign-extension; the scales are applied to
//     S and P, not here); no dequantized page is ever written;
//   * bf16 compute runs the tensor cores (mma.sync m16n8k16, fp32
//     accumulate), P going from the S accumulators into A fragments; fp32
//     compute runs the FMA units (no TF32).
// wgmma, TMA, a pipelined K/V ring and a split of long caches across blocks
// (the speculation shape has n * Hkv = 64 blocks on 132 SMs) are later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBlockM = 64;  // (t, g) rows per thread block
constexpr int kBlockN = 64;  // cached tokens per loop iteration
constexpr int kMaxGroup = 8;
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// A byte of packed int4 pages: two sign-extended nibbles.
struct Int4x2 {
  int8_t b;
};

template <typename Tc>
constexpr bool kPacked = std::is_same<Tc, Int4x2>::value;
// Stored bytes of one cached row of D elements.
template <typename Tc, int D>
constexpr int kRowBytesOf = kPacked<Tc> ? D / 2 : D * static_cast<int>(sizeof(Tc));

// The 16 stored bytes at p of an int4 row as 32 floats: x[j] is element
// c + j (the low nibble of byte j), x[16 + j] element c + D/2 + j.
__device__ __forceinline__ void unpack16_int4(const unsigned char* p, float* x) {
  alignas(16) uint8_t e[16];
  *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint8_t top = static_cast<uint8_t>(e[j] << 4);
    x[j] = static_cast<float>(static_cast<int8_t>(top) >> 4);
    x[16 + j] = static_cast<float>(static_cast<int8_t>(e[j]) >> 4);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 bytes at p as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* x) {
  constexpr int kVec = 16 / sizeof(T);
  alignas(16) T e[kVec];
  *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = to_float(e[j]);
}

// Stage a [kBlockN, D] tile of the cache (rows of kRowBytesOf<Tc, D> stored
// bytes from src) into shared memory as bf16 with leading dimension LD,
// reading 16 bytes per thread and step.  Rows at or past `valid` are zero:
// their P is 0 and a stale NaN there would poison the PV product.
template <typename Tc, int D, int LD, int NTHREADS>
__device__ __forceinline__ void stage_kv_bf16(__nv_bfloat16* dst,
                                              const unsigned char* src,
                                              int valid) {
  constexpr int kRow = kRowBytesOf<Tc, D>;
  constexpr int kPerRow = kRow / 16;
  for (int i = threadIdx.x; i < kBlockN * kPerRow; i += NTHREADS) {
    const int r = i / kPerRow;
    const int cb = (i - r * kPerRow) * 16;  // byte offset in the row
    if constexpr (kPacked<Tc>) {
      float x[32];
      if (r < valid) {
        unpack16_int4(src + static_cast<size_t>(r) * kRow + cb, x);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* xh = x + 16 * h;
        __nv_bfloat16* d = dst + r * LD + cb + h * (D / 2);
        reinterpret_cast<uint4*>(d)[0] = make_uint4(
            pack_bf16(xh[0], xh[1]), pack_bf16(xh[2], xh[3]),
            pack_bf16(xh[4], xh[5]), pack_bf16(xh[6], xh[7]));
        reinterpret_cast<uint4*>(d)[1] = make_uint4(
            pack_bf16(xh[8], xh[9]), pack_bf16(xh[10], xh[11]),
            pack_bf16(xh[12], xh[13]), pack_bf16(xh[14], xh[15]));
      }
    } else {
      constexpr int kVec = 16 / sizeof(Tc);
      const int c = cb / static_cast<int>(sizeof(Tc));
      float x[kVec];
      if (r < valid) {
        load16(reinterpret_cast<const Tc*>(src + static_cast<size_t>(r) * kRow + cb), x);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = 0.f;
      }
      uint32_t w[kVec / 2];
#pragma unroll
      for (int j = 0; j < kVec / 2; ++j) w[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
      __nv_bfloat16* d = dst + r * LD + c;
      if constexpr (kVec == 16) {
        reinterpret_cast<uint4*>(d)[0] = make_uint4(w[0], w[1], w[2], w[3]);
        reinterpret_cast<uint4*>(d)[1] = make_uint4(w[4], w[5], w[6], w[7]);
      } else if constexpr (kVec == 8) {
        *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
      }
    }
  }
}

// The same into fp32 shared memory (leading dimension LD, any alignment).
template <typename Tc, int D, int LD, int NTHREADS>
__device__ __forceinline__ void stage_kv_fp32(float* dst,
                                              const unsigned char* src,
                                              int valid) {
  constexpr int kRow = kRowBytesOf<Tc, D>;
  constexpr int kPerRow = kRow / 16;
  for (int i = threadIdx.x; i < kBlockN * kPerRow; i += NTHREADS) {
    const int r = i / kPerRow;
    const int cb = (i - r * kPerRow) * 16;
    if constexpr (kPacked<Tc>) {
      float x[32];
      if (r < valid) {
        unpack16_int4(src + static_cast<size_t>(r) * kRow + cb, x);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dst[r * LD + cb + j] = x[j];
        dst[r * LD + cb + D / 2 + j] = x[16 + j];
      }
    } else {
      constexpr int kVec = 16 / sizeof(Tc);
      const int c = cb / static_cast<int>(sizeof(Tc));
      float x[kVec];
      if (r < valid) {
        load16(reinterpret_cast<const Tc*>(src + static_cast<size_t>(r) * kRow + cb), x);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[r * LD + c + j] = x[j];
    }
  }
}

// Where a block's rows are and how far its page loop runs.
struct Tile {
  int slot, hk, group, rows, r0, base, kv_end, n_tiles;
  size_t pt_row;  // page_table offset of the slot's row

  __device__ Tile(int chunk, int n_heads, int n_kv, const int* lengths,
                  int pages_per_seq) {
    r0 = blockIdx.x * kBlockM;
    slot = blockIdx.y;
    hk = blockIdx.z;
    group = n_heads / n_kv;
    rows = chunk * group;
    const int length = lengths[slot];
    base = length - chunk;  // position of query t = 0
    const int r_last = min(r0 + kBlockM, rows) - 1;
    // The last row attends columns < base + t_last + 1 (<= length).
    kv_end = max(0, base + r_last / group + 1);
    n_tiles = (kv_end + kBlockN - 1) / kBlockN;
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

// ---------------------------------------------------------------------------
// bf16 compute on the tensor cores.  128 threads; warp w owns rows
// [16w, 16w + 16) of the tile.  mma.m16n8k16 layouts: thread (g = lane / 4,
// t = lane % 4) holds accumulator elements (row g, cols 2t, 2t+1) and
// (row g + 8, cols 2t, 2t+1) of each 8-column n-tile.
// ---------------------------------------------------------------------------
template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(128)
paged_chunk_mma(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                const float* __restrict__ k_scales,
                const Tc* __restrict__ v_pages,
                const float* __restrict__ v_scales,
                const int* __restrict__ page_table,
                const int* __restrict__ lengths, Tq* __restrict__ out,
                int chunk, int n_heads, int num_pages, int page_size,
                int pages_per_seq, float sm_scale) {
  constexpr int LD = D + 8;  // 16-byte row padding: conflict-free ldmatrix
  constexpr int kRow = kRowBytesOf<Tc, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * LD;
  __nv_bfloat16* vs = ks + kBlockN * LD;
  float* ksc = reinterpret_cast<float*>(vs + kBlockN * LD);
  float* vsc = ksc + kBlockN;

  const Tile tile(chunk, n_heads, gridDim.z, lengths, pages_per_seq);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // Q tile, rounded to bf16 (no scale: sm_scale goes on the scores).
  for (int i = threadIdx.x; i < kBlockM * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    float x[8];
    if (tile.r0 + r < tile.rows) {
      const Tq* src = q + tile.qrow(r, chunk, n_heads, D) + c;
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
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
  }

  const int pos_a = tile.pos(warp * 16 + g);
  const int pos_b = tile.pos(warp * 16 + g + 8);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int it = 0; it < tile.n_tiles; ++it) {
    const int c0 = it * kBlockN;
    const size_t row0 = tile.cache_row(page_table, c0, num_pages, page_size);
    const int valid = tile.valid_cols(c0);
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_kv_bf16<Tc, D, LD, 128>(
        ks, reinterpret_cast<const unsigned char*>(k_pages) + row0 * kRow, valid);
    stage_kv_bf16<Tc, D, LD, 128>(
        vs, reinterpret_cast<const unsigned char*>(v_pages) + row0 * kRow, valid);
    if (threadIdx.x < kBlockN) {
      const bool in = threadIdx.x < valid;
      ksc[threadIdx.x] = in ? k_scales[row0 + threadIdx.x] * sm_scale : 0.f;
      vsc[threadIdx.x] = in ? v_scales[row0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
      }
    }

    // Scale the score columns, mask past each row's position, online softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + t4 * 2 + (e & 1);
        const bool keep = c0 + cl <= (e < 2 ? pos_a : pos_b);
        s[j][e] = keep ? s[j][e] * ksc[cl] : kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + t4 * 2 + (e & 1);
        const bool keep = c0 + cl <= (e < 2 ? pos_a : pos_b);
        // Exactly 0 where masked: a row masked so far has m equal to the
        // mask value, where exp alone would give 1.
        const float p = keep ? expf(s[j][e] - m_run[e >> 1]) : 0.f;
        rs[e >> 1] += p;
        s[j][e] = p * vsc[cl];  // P times the V scale, rounded below
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
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
        ldmatrix_x4_trans(
            bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
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
    if (tile.r0 + ra < tile.rows) {
      store2(out + tile.qrow(ra, chunk, n_heads, D) + col, acc[j][0] * inv_a,
             acc[j][1] * inv_a);
    }
    if (tile.r0 + rb < tile.rows) {
      store2(out + tile.qrow(rb, chunk, n_heads, D) + col, acc[j][2] * inv_b,
             acc[j][3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 compute on the FMA units.  256 threads as 16 x 16: thread (ty, tx)
// owns rows 4ty..4ty+3 and columns tx + 16j of each S tile, and the same
// rows and columns tx + 16j of O.  A row's 16 threads are 16 neighbouring
// lanes, so row reductions are four shuffles.
// ---------------------------------------------------------------------------
template <typename Tq, typename Tc, int D>
__global__ void __launch_bounds__(256)
paged_chunk_fp32(const Tq* __restrict__ q, const Tc* __restrict__ k_pages,
                 const float* __restrict__ k_scales,
                 const Tc* __restrict__ v_pages,
                 const float* __restrict__ v_scales,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths, Tq* __restrict__ out,
                 int chunk, int n_heads, int num_pages, int page_size,
                 int pages_per_seq, float sm_scale) {
  constexpr int LDQ = D + 1;  // odd strides: conflict-free column reads
  constexpr int LDK = D + 1;
  constexpr int LDV = D;
  constexpr int LDP = kBlockN + 1;
  constexpr int DJ = D / 16;
  constexpr int kRow = kRowBytesOf<Tc, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockM * LDQ;
  float* vs = ks + kBlockN * LDK;
  float* ps = vs + kBlockN * LDV;
  float* ksc = ps + kBlockM * LDP;
  float* vsc = ksc + kBlockN;

  const Tile tile(chunk, n_heads, gridDim.z, lengths, pages_per_seq);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int i = threadIdx.x; i < kBlockM * D; i += 256) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r * LDQ + c] = tile.r0 + r < tile.rows
                          ? to_float(q[tile.qrow(r, chunk, n_heads, D) + c])
                          : 0.f;
  }

  int pos[4];
  float m_run[4], l_run[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = tile.pos(ty * 4 + i);
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < tile.n_tiles; ++it) {
    const int c0 = it * kBlockN;
    const size_t row0 = tile.cache_row(page_table, c0, num_pages, page_size);
    const int valid = tile.valid_cols(c0);
    __syncthreads();
    stage_kv_fp32<Tc, D, LDK, 256>(
        ks, reinterpret_cast<const unsigned char*>(k_pages) + row0 * kRow, valid);
    stage_kv_fp32<Tc, D, LDV, 256>(
        vs, reinterpret_cast<const unsigned char*>(v_pages) + row0 * kRow, valid);
    if (threadIdx.x < kBlockN) {
      const bool in = threadIdx.x < valid;
      ksc[threadIdx.x] = in ? k_scales[row0 + threadIdx.x] * sm_scale : 0.f;
      vsc[threadIdx.x] = in ? v_scales[row0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        s[i][j] = c0 + cl <= pos[i] ? s[i][j] * ksc[cl] : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const float p = c0 + cl <= pos[i] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[(ty * 4 + i) * LDP + cl] = p * vsc[cl];
      }
      l_run[i] = l_run[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    const int r = ty * 4 + i;
    if (tile.r0 + r >= tile.rows) continue;
    const float inv = l == 0.f ? 0.f : 1.f / l;
    Tq* op = out + tile.qrow(r, chunk, n_heads, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store1(op + tx + 16 * j, acc[i][j] * inv);
    }
  }
}

// Raises the kernel's dynamic shared-memory limit to `smem` once per device
// (devices 0-63; others on every call) instead of on every launch.  `done`
// is a function-local static of the caller, so one per instantiation.
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

struct Args {
  const void *q, *k_pages, *k_scales, *v_pages, *v_scales, *page_table,
      *lengths;
  void* out;
  int num_seqs, chunk, n_heads, n_kv_heads, num_pages, page_size,
      pages_per_seq;
  float sm_scale;
};

template <typename Tq, typename Tc, int D>
cudaError_t launch(const Args& a, bool bf16_compute, cudaStream_t stream) {
  const dim3 grid((a.chunk * (a.n_heads / a.n_kv_heads) + kBlockM - 1) / kBlockM,
                  a.num_seqs, a.n_kv_heads);
  if (bf16_compute) {
    const size_t smem = (kBlockM + 2 * kBlockN) * (D + 8) * sizeof(__nv_bfloat16) +
                        2 * kBlockN * sizeof(float);
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(paged_chunk_mma<Tq, Tc, D>,
                                    static_cast<int>(smem), smem_set);
    if (err != cudaSuccess) return err;
    paged_chunk_mma<Tq, Tc, D><<<grid, 128, smem, stream>>>(
        static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
        static_cast<const float*>(a.k_scales),
        static_cast<const Tc*>(a.v_pages),
        static_cast<const float*>(a.v_scales),
        static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.chunk,
        a.n_heads, a.num_pages, a.page_size, a.pages_per_seq, a.sm_scale);
  } else {
    const size_t smem = (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
                         kBlockM * (kBlockN + 1) + 2 * kBlockN) *
                        sizeof(float);
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(paged_chunk_fp32<Tq, Tc, D>,
                                    static_cast<int>(smem), smem_set);
    if (err != cudaSuccess) return err;
    paged_chunk_fp32<Tq, Tc, D><<<grid, 256, smem, stream>>>(
        static_cast<const Tq*>(a.q), static_cast<const Tc*>(a.k_pages),
        static_cast<const float*>(a.k_scales),
        static_cast<const Tc*>(a.v_pages),
        static_cast<const float*>(a.v_scales),
        static_cast<const int*>(a.page_table),
        static_cast<const int*>(a.lengths), static_cast<Tq*>(a.out), a.chunk,
        a.n_heads, a.num_pages, a.page_size, a.pages_per_seq, a.sm_scale);
  }
  return cudaGetLastError();
}

template <typename Tq, typename Tc>
cudaError_t launch_d(int head_dim, const Args& a, bool bf16_compute,
                     cudaStream_t st) {
  if (head_dim == 64) return launch<Tq, Tc, 64>(a, bf16_compute, st);
  if (head_dim == 128) return launch<Tq, Tc, 128>(a, bf16_compute, st);
  return cudaErrorInvalidValue;
}

template <typename Tq>
cudaError_t launch_cache(int cache_dtype, int head_dim, const Args& a,
                         bool bf16_compute, cudaStream_t st) {
  switch (cache_dtype) {
    case 0:
      return launch_d<Tq, float>(head_dim, a, bf16_compute, st);
    case 1:
      return launch_d<Tq, __nv_bfloat16>(head_dim, a, bf16_compute, st);
    case 2:
      return launch_d<Tq, int8_t>(head_dim, a, bf16_compute, st);
    case 3:
      return launch_d<Tq, __nv_fp8_e4m3>(head_dim, a, bf16_compute, st);
    case 4:
      return launch_d<Tq, __nv_fp8_e5m2>(head_dim, a, bf16_compute, st);
    case 5:
      return launch_d<Tq, Int4x2>(head_dim, a, bf16_compute, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out [num_seqs, chunk, n_heads, head_dim] (fp32, or bf16 when q_bf16);
// k_pages, v_pages [n_kv_heads, num_pages, page_size, head_dim] of
// cache_dtype 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8 e4m3, 4 = fp8 e5m2, or
// 5 = int4 [.., head_dim / 2] split-half; k_scales, v_scales
// [n_kv_heads, num_pages, page_size] fp32; page_table [num_seqs,
// pages_per_seq] int32; lengths [num_seqs] int32, the total length with the
// chunk.  page_size is a multiple of 128 and n_heads / n_kv_heads <= 8.
// Returns a cudaError_t.
int cfa_paged_chunk(const void* q, const void* k_pages, const void* k_scales,
                    const void* v_pages, const void* v_scales,
                    const void* page_table, const void* lengths, void* out,
                    int num_seqs, int chunk, int n_heads, int n_kv_heads,
                    int num_pages, int page_size, int pages_per_seq,
                    int head_dim, float sm_scale, int q_bf16, int cache_dtype,
                    int bf16_compute, void* stream) {
  if (page_size % 128 != 0 || n_heads % n_kv_heads != 0 ||
      n_heads / n_kv_heads > kMaxGroup || chunk < 1 || num_seqs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,        k_pages,  k_scales,   v_pages,   v_scales,
               page_table, lengths, out,       num_seqs,  chunk,
               n_heads,  n_kv_heads, num_pages, page_size, pages_per_seq,
               sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return static_cast<int>(launch_cache<__nv_bfloat16>(
        cache_dtype, head_dim, a, bf16_compute != 0, st));
  }
  return static_cast<int>(
      launch_cache<float>(cache_dtype, head_dim, a, bf16_compute != 0, st));
}

const char* cfa_paged_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
