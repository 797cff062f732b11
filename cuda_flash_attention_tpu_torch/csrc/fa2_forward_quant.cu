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
// GQA is native: query head h reads KV head h / (Hq / Hkv).
//
// What bounds it on the H100: tensor-core operations at the prefill shapes
// (B4 Hq16 Hkv8 S2048 D64 causal does ~2.2e11 FLOPs against ~25 MB moved),
// as B1; the point of 1-byte K/V is the bytes of long contexts and of the
// cache, which this kernel reads at a quarter (int4: an eighth) of fp32's.
// The design is B1's (csrc/fa2_forward.cu): one block per (64-row Q tile,
// b * Hq), Q in mma.sync A fragments for the whole loop, a KV loop that stops
// at the diagonal, P from the S accumulators straight into A fragments, m and
// l in fp32.  What differs:
//   * K and V stay 1 byte per element in shared memory (int4 is unpacked to
//     int8 on the way in); each thread converts the byte pairs of its own
//     B fragments to bf16 pairs just before the mma.  int8, int4, e4m3 and
//     e5m2 are all exact in bf16, so the conversion loses nothing (fp8 goes
//     through the card's fp8x2 -> f16x2 convert);
//   * the two scales are one fp32 multiply each, on S's columns and on P;
//     no dequantized tile exists anywhere;
//   * fp32 compute runs B1's FMA path with K and V converted to fp32 in
//     shared memory (exact), held to IEEE fp32.
// wgmma, TMA, fp8 tensor-core products and a swizzled byte layout are later
// work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBlockM = 64;  // Q rows per thread block
constexpr int kBlockN = 64;  // KV rows per loop iteration
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE
constexpr float kLn2 = 0.6931471805599453f;

// Storage types of K and V.
struct Int8 {};
struct E4M3 {};
struct E5M2 {};
struct Int4 {};  // packed split-half; unpacked to int8 in shared memory

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 fp8x2_to_float2(uint16_t two,
                                                  __nv_fp8_interpretation_t t) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), t);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// One stored byte as float, and two neighbouring ones (lo = the lower
// index) as a bf16 pair, per storage type.  Shared memory holds int8 for
// both int8 and int4.
template <typename S>
struct Conv {
  static __device__ __forceinline__ float one(uint8_t b) {
    return static_cast<float>(static_cast<int8_t>(b));
  }
  static __device__ __forceinline__ uint32_t two(uint16_t p) {
    return pack_bf16(static_cast<float>(static_cast<int8_t>(p & 0xff)),
                     static_cast<float>(static_cast<int8_t>(p >> 8)));
  }
};

template <>
struct Conv<E4M3> {
  static __device__ __forceinline__ float one(uint8_t b) {
    return fp8x2_to_float2(b, __NV_E4M3).x;
  }
  static __device__ __forceinline__ uint32_t two(uint16_t p) {
    const float2 f = fp8x2_to_float2(p, __NV_E4M3);
    return pack_bf16(f.x, f.y);
  }
};

template <>
struct Conv<E5M2> {
  static __device__ __forceinline__ float one(uint8_t b) {
    return fp8x2_to_float2(b, __NV_E5M2).x;
  }
  static __device__ __forceinline__ uint32_t two(uint16_t p) {
    const float2 f = fp8x2_to_float2(p, __NV_E5M2);
    return pack_bf16(f.x, f.y);
  }
};

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes per stored row.
template <typename S, int D>
constexpr int kRowBytes = std::is_same<S, Int4>::value ? D / 2 : D;

// Copy rows [k0, k0 + kBlockN) of a stored [skv, kRowBytes] matrix into a
// byte tile of shared memory [kBlockN][LDB] holding one byte per element
// (int4 rows unpacked to sign-extended int8).  Rows at or past skv are
// zero, a finite code in every storage type.
template <typename S, int D, int LDB, int NTHREADS>
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int k0, int skv) {
  constexpr int kRow = kRowBytes<S, D>;
  constexpr int kVecs = kRow / 16;
  for (int i = threadIdx.x; i < kBlockN * kVecs; i += NTHREADS) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 16;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (k0 + r < skv) {
      raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(k0 + r) * kRow + c);
    }
    if constexpr (std::is_same<S, Int4>::value) {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      alignas(16) uint8_t lo[16], hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // Sign-extend each nibble: the low one shifted to the top first.
        const int8_t low_top = static_cast<int8_t>(static_cast<uint8_t>(b[j] << 4));
        lo[j] = static_cast<uint8_t>(low_top >> 4);
        hi[j] = static_cast<uint8_t>(static_cast<int8_t>(b[j]) >> 4);
      }
      *reinterpret_cast<uint4*>(dst + r * LDB + c) =
          *reinterpret_cast<const uint4*>(lo);
      *reinterpret_cast<uint4*>(dst + r * LDB + c + D / 2) =
          *reinterpret_cast<const uint4*>(hi);
    } else {
      *reinterpret_cast<uint4*>(dst + r * LDB + c) = raw;
    }
  }
}

__device__ __forceinline__ uint16_t byte_pair(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// ---------------------------------------------------------------------------
// bf16 compute on the tensor cores.  128 threads; warp w owns Q rows
// [16w, 16w + 16).  mma.m16n8k16 layouts: thread (g = lane / 4, t = lane % 4)
// holds accumulator elements (row g, cols 2t, 2t+1) and (row g + 8, same
// cols) of each 8-column n-tile; its B fragment of an n-tile is
// b0 = {B[2t][g], B[2t+1][g]}, b1 = {B[2t+8][g], B[2t+9][g]}.  For S = Q K^T
// B[k][n] = K[n][k]: two neighbouring bytes of key row g.  For O += P V
// B[k][n] = V[k][n]: one byte of each of two neighbouring key rows.
// ---------------------------------------------------------------------------
template <typename Tq, typename S, int D>
__global__ void __launch_bounds__(128)
fa2_fwd_quant_mma(const Tq* __restrict__ q, const uint8_t* __restrict__ k,
                  const float* __restrict__ k_scales,
                  const uint8_t* __restrict__ v,
                  const float* __restrict__ v_scales, Tq* __restrict__ o,
                  float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                  int kv_len, float qscale, int causal) {
  constexpr int LDQ = D + 8;    // bf16 elements: conflict-free ldmatrix
  constexpr int LDB = D + 16;   // bytes: conflict-free fragment loads
  constexpr int kRow = kRowBytes<S, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  uint8_t* ks = reinterpret_cast<uint8_t*>(qs + kBlockM * LDQ);
  uint8_t* vs = ks + kBlockN * LDB;
  float* ksc = reinterpret_cast<float*>(vs + kBlockN * LDB);
  float* vsc = ksc + kBlockN;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // Causal tiles near the end carry the most KV tiles: hand them out first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const size_t kv_head = static_cast<size_t>(b) * hkv + hk;
  const Tq* qp = q + static_cast<size_t>(bh) * sq * D;
  const uint8_t* kp = k + kv_head * skv * kRow;
  const uint8_t* vp = v + kv_head * skv * kRow;
  const float* ksp = k_scales + kv_head * skv;
  const float* vsp = v_scales + kv_head * skv;

  // Q tile: scaled in fp32, rounded to bf16.
  for (int i = threadIdx.x; i < kBlockM * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    float x[8];
    if (q0 + r < sq) {
      load8(qp + static_cast<size_t>(q0 + r) * D + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    *reinterpret_cast<uint4*>(qs + r * LDQ + c) = make_uint4(
        pack_bf16(x[0] * qscale, x[1] * qscale),
        pack_bf16(x[2] * qscale, x[3] * qscale),
        pack_bf16(x[4] * qscale, x[5] * qscale),
        pack_bf16(x[6] * qscale, x[7] * qscale));
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * LDQ + kk * 16 +
                            (lane >> 4) * 8);
  }

  const int kv_end = causal ? min(kv_len, q0 + kBlockM) : kv_len;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    stage_bytes<S, D, LDB, 128>(ks, kp, k0, skv);
    stage_bytes<S, D, LDB, 128>(vs, vp, k0, skv);
    if (threadIdx.x < kBlockN) {
      const bool in = k0 + threadIdx.x < skv;
      ksc[threadIdx.x] = in ? ksp[k0 + threadIdx.x] : 0.f;
      vsc[threadIdx.x] = in ? vsp[k0 + threadIdx.x] : 0.f;
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
      for (int j = 0; j < kBlockN / 8; ++j) {
        const uint8_t* kr = ks + (j * 8 + g) * LDB + kk * 16 + 2 * t4;
        mma_bf16(s[j], qa[kk], Conv<S>::two(byte_pair(kr)),
                 Conv<S>::two(byte_pair(kr + 8)));
      }
    }

    // K's scale on the score columns, then the mask.
    const bool need_mask =
        (k0 + kBlockN > kv_len) || (causal && k0 + kBlockN - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + t4 * 2 + (e & 1);
        s[j][e] *= ksc[cl];
        if (need_mask) {
          const int col = k0 + cl;
          const int row = e < 2 ? row_a : row_b;
          if (col >= kv_len || (causal && col > row)) s[j][e] = kMaskValue;
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
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] - m_run[e >> 1]);
        // Exact zero for masked entries (a row masked so far has m equal
        // to the mask value, where exp2 alone would give 1).
        if (need_mask && s[j][e] == kMaskValue) p = 0.f;
        rs[e >> 1] += p;
        s[j][e] = p * vsc[j * 8 + t4 * 2 + (e & 1)];  // rounded below
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

    // O += (P * v_scale) V: the S accumulators of n-tiles 2kk and 2kk+1 are
    // the A fragment of key step kk.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint8_t* v0 = vs + (kk * 16 + 2 * t4) * LDB + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint8_t* vr = v0 + dn * 8;
        const uint16_t p0 = vr[0] | (static_cast<uint16_t>(vr[LDB]) << 8);
        const uint16_t p1 =
            vr[8 * LDB] | (static_cast<uint16_t>(vr[9 * LDB]) << 8);
        mma_bf16(acc[dn], pa, Conv<S>::two(p0), Conv<S>::two(p1));
      }
    }
  }

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
      store2(op + static_cast<size_t>(row_a) * D + col, acc[j][0] * inv_a,
             acc[j][1] * inv_a);
    }
    if (row_b < sq) {
      store2(op + static_cast<size_t>(row_b) * D + col, acc[j][2] * inv_b,
             acc[j][3] * inv_b);
    }
  }
  if (t4 == 0) {
    float* lp = lse + static_cast<size_t>(bh) * sq;
    if (row_a < sq) {
      lp[row_a] = m_run[0] * kLn2 + logf(l_run[0] == 0.f ? 1.f : l_run[0]);
    }
    if (row_b < sq) {
      lp[row_b] = m_run[1] * kLn2 + logf(l_run[1] == 0.f ? 1.f : l_run[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 compute on the FMA units, as B1's fp32 path: 256 threads as 16 x 16,
// thread (ty, tx) owns rows 4ty..4ty+3 and columns tx + 16j.  K and V are
// staged bytes first, then converted to fp32 (exact) in shared memory.
// ---------------------------------------------------------------------------
template <typename Tq, typename S, int D>
__global__ void __launch_bounds__(256)
fa2_fwd_quant_fp32(const Tq* __restrict__ q, const uint8_t* __restrict__ k,
                   const float* __restrict__ k_scales,
                   const uint8_t* __restrict__ v,
                   const float* __restrict__ v_scales, Tq* __restrict__ o,
                   float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                   int kv_len, float qscale, int causal) {
  constexpr int LDQ = D + 1;  // odd strides: conflict-free column reads
  constexpr int LDK = D + 1;
  constexpr int LDV = D;
  constexpr int LDP = kBlockN + 1;
  constexpr int LDB = D + 16;
  constexpr int DJ = D / 16;
  constexpr int kRow = kRowBytes<S, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* kf = qs + kBlockM * LDQ;
  float* vf = kf + kBlockN * LDK;
  float* ps = vf + kBlockN * LDV;
  float* ksc = ps + kBlockM * LDP;
  float* vsc = ksc + kBlockN;
  uint8_t* kb = reinterpret_cast<uint8_t*>(vsc + kBlockN);
  uint8_t* vb = kb + kBlockN * LDB;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int hk = (bh - b * hq) / (hq / hkv);
  const size_t kv_head = static_cast<size_t>(b) * hkv + hk;
  const Tq* qp = q + static_cast<size_t>(bh) * sq * D;
  const uint8_t* kp = k + kv_head * skv * kRow;
  const uint8_t* vp = v + kv_head * skv * kRow;
  const float* ksp = k_scales + kv_head * skv;
  const float* vsp = v_scales + kv_head * skv;

  for (int i = threadIdx.x; i < kBlockM * D; i += 256) {
    const int r = i / D;
    const int c = i - r * D;
    qs[r * LDQ + c] =
        q0 + r < sq ? to_float(qp[static_cast<size_t>(q0 + r) * D + c]) * qscale
                    : 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kBlockM) : kv_len;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
  float m_run[4], l_run[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();
    stage_bytes<S, D, LDB, 256>(kb, kp, k0, skv);
    stage_bytes<S, D, LDB, 256>(vb, vp, k0, skv);
    if (threadIdx.x < kBlockN) {
      const bool in = k0 + threadIdx.x < skv;
      ksc[threadIdx.x] = in ? ksp[k0 + threadIdx.x] : 0.f;
      vsc[threadIdx.x] = in ? vsp[k0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockN * D; i += 256) {
      const int r = i / D;
      const int c = i - r * D;
      kf[r * LDK + c] = Conv<S>::one(kb[r * LDB + c]);
      vf[r * LDV + c] = Conv<S>::one(vb[r * LDB + c]);
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
      for (int j = 0; j < 4; ++j) kv[j] = kf[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

    const bool need_mask =
        (k0 + kBlockN > kv_len) || (causal && k0 + kBlockN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        s[i][j] *= ksc[cl];
        if (need_mask) {
          const int col = k0 + cl;
          if (col >= kv_len || (causal && col > row)) s[i][j] = kMaskValue;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        float p = exp2f(s[i][j] - m_new);
        if (need_mask && s[i][j] == kMaskValue) p = 0.f;
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
      for (int j = 0; j < DJ; ++j) vv[j] = vf[c * LDV + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  Tq* op = o + static_cast<size_t>(bh) * sq * D;
  float* lp = lse + static_cast<size_t>(bh) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store1(op + static_cast<size_t>(row) * D + tx + 16 * j, acc[i][j] * inv);
    }
    if (tx == 0) lp[row] = m_run[i] * kLn2 + logf(l == 0.f ? 1.f : l);
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
  const void *q, *k, *k_scales, *v, *v_scales;
  void *o, *lse;
  int batch, hq, hkv, sq, skv, kv_len;
  float qscale;
  int causal;
};

template <typename Tq, typename S, int D>
cudaError_t launch(const Args& a, bool bf16_compute, cudaStream_t stream) {
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.batch * a.hq);
  const auto* k = static_cast<const uint8_t*>(a.k);
  const auto* v = static_cast<const uint8_t*>(a.v);
  const auto* ks = static_cast<const float*>(a.k_scales);
  const auto* vs = static_cast<const float*>(a.v_scales);
  if (bf16_compute) {
    const size_t smem = kBlockM * (D + 8) * sizeof(__nv_bfloat16) +
                        2 * kBlockN * (D + 16) + 2 * kBlockN * sizeof(float);
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(fa2_fwd_quant_mma<Tq, S, D>,
                                    static_cast<int>(smem), smem_set);
    if (err != cudaSuccess) return err;
    fa2_fwd_quant_mma<Tq, S, D><<<grid, 128, smem, stream>>>(
        static_cast<const Tq*>(a.q), k, ks, v, vs, static_cast<Tq*>(a.o),
        static_cast<float*>(a.lse), a.hq, a.hkv, a.sq, a.skv, a.kv_len,
        a.qscale, a.causal);
  } else {
    const size_t smem = (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D +
                         kBlockM * (kBlockN + 1) + 2 * kBlockN) *
                            sizeof(float) +
                        2 * kBlockN * (D + 16);
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = set_smem_once(fa2_fwd_quant_fp32<Tq, S, D>,
                                    static_cast<int>(smem), smem_set);
    if (err != cudaSuccess) return err;
    fa2_fwd_quant_fp32<Tq, S, D><<<grid, 256, smem, stream>>>(
        static_cast<const Tq*>(a.q), k, ks, v, vs, static_cast<Tq*>(a.o),
        static_cast<float*>(a.lse), a.hq, a.hkv, a.sq, a.skv, a.kv_len,
        a.qscale, a.causal);
  }
  return cudaGetLastError();
}

template <typename Tq, typename S>
cudaError_t launch_d(int head_dim, const Args& a, bool bf16c, cudaStream_t st) {
  if (head_dim == 64) return launch<Tq, S, 64>(a, bf16c, st);
  if (head_dim == 128) return launch<Tq, S, 128>(a, bf16c, st);
  return cudaErrorInvalidValue;
}

template <typename Tq>
cudaError_t launch_storage(int storage, int head_dim, const Args& a,
                           bool bf16c, cudaStream_t st) {
  switch (storage) {
    case 0: return launch_d<Tq, Int8>(head_dim, a, bf16c, st);
    case 1: return launch_d<Tq, E4M3>(head_dim, a, bf16c, st);
    case 2: return launch_d<Tq, E5M2>(head_dim, a, bf16c, st);
    case 3: return launch_d<Tq, Int4>(head_dim, a, bf16c, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [batch, hq, sq, head_dim] (fp32, or bf16 when q_bf16); o like q; lse
// [batch, hq, sq] fp32.  k, v [batch, hkv, skv, row] of storage 0 = int8,
// 1 = fp8 e4m3, 2 = fp8 e5m2 (row = head_dim bytes) or 3 = int4 split-half
// (row = head_dim / 2 bytes); k_scales, v_scales [batch, hkv, skv] fp32.  All
// contiguous.  bf16_compute: bf16 on the tensor cores (else fp32 on FMA).
// qscale = sm_scale * log2(e).  Returns a cudaError_t.
int cfa_fa2_forward_quant(const void* q, const void* k, const void* k_scales,
                          const void* v, const void* v_scales, void* o,
                          void* lse, int batch, int hq, int hkv, int sq,
                          int skv, int head_dim, int kv_len, float qscale,
                          int causal, int q_bf16, int storage,
                          int bf16_compute, void* stream) {
  if (hkv < 1 || hq % hkv != 0 || batch * hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,     k,   k_scales, v,  v_scales, o,      lse,    batch,
               hq,    hkv, sq,       skv, kv_len,  qscale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return static_cast<int>(launch_storage<__nv_bfloat16>(
        storage, head_dim, a, bf16_compute != 0, st));
  }
  return static_cast<int>(
      launch_storage<float>(storage, head_dim, a, bf16_compute != 0, st));
}

const char* cfa_fa2_forward_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
