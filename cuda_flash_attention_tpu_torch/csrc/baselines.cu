// The two baseline attention kernels of the reference suite on Hopper
// (sm_90a), plain C interface for ctypes.  Both are forward-only, fp32-only
// and non-causal, as the reference's; their schedules are what they measure,
// so they are kept, not tuned.
//
// B9 FlashAttention-1 replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/baselines.py::_fa1_aligned
//   (body _fa1_kernel).
//   One thread block per (batch, head), as the reference's f-attn.cu.  The
//   loop over 64-row KV tiles is OUTER and the loop over 64-row Q tiles is
//   INNER, and the running output O and the row statistics m and l live in
//   device memory: every (KV tile, Q tile) pair reads them, rescales O by
//   l_prev * alpha / l_new, adds P V / l_new, and writes all three back.
//
// B10 naive FlashAttention-2 replaces the Pallas TPU kernel
//   cuda_flash_attention_tpu/kernels/baselines.py::_naive_fa2_aligned
//   (body _naive_fa2_kernel).
//   The FA2 schedule without its tuning: one block per (64-row Q tile,
//   batch * head), the KV loop inside the block over fixed 64-row tiles, and
//   the output renormalised eagerly at every tile (acc * l_prev * alpha /
//   l_new + P V / l_new) instead of one division at the end.  No cp.async
//   pipelining, no causal skip.
//
// What bounds them on the H100: fp32 FLOPs on the FMA units (4 * S^2 * D per
// head, 67 TFLOP/s), and for FA1 also its own schedule's traffic: O, m and l
// cross device memory once per (KV tile, Q tile) pair, S / 32 times the
// output's size at S = 2048.  Both keep S and P in shared memory and
// registers; scores are natural-log (exp, not exp2), scaled by sm_scale
// after the product, as in the TPU kernels.  KV tiles wholly past kv_len
// are not visited.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTile = 64;  // Q and KV rows per tile
constexpr float kMaskValue = -0.7f * 3.40282347e38f;  // DEFAULT_MASK_VALUE

// Rows [row0, row0 + kTile) of a [nrows, D] matrix into shared memory with
// leading dimension LD; rows past nrows are zero.
template <int D, int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int nrows) {
  for (int i = threadIdx.x; i < kTile * D; i += 256) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * LD + c] =
        row0 + r < nrows ? src[static_cast<size_t>(row0 + r) * D + c] : 0.f;
  }
}

// The score tile shared by both kernels.  256 threads as 16 x 16: thread
// (ty, tx) owns rows 4ty..4ty+3 and columns tx + 16j of the 64 x 64 tile S
// = sm_scale * Q K^T, with columns at or past kv_len set to the mask value.
// Then, per row, the running max and sum are updated from (m_prev, l_prev),
// P = exp(S - m_new) is written to ps, and the two output scales
// l_prev * alpha / l_new (old output) and 1 / l_new (P V) are returned.
template <int D>
__device__ __forceinline__ void score_tile(const float* qs, const float* ks,
                                           float* ps, int k0, int kv_len,
                                           float sm_scale, const float* m_prev,
                                           const float* l_prev, float* m_new,
                                           float* l_new, float* scale_old,
                                           float* scale_pv) {
  constexpr int LDK = D + 1;
  constexpr int LDP = kTile + 1;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
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
    for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LDK + d];
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
      s[i][j] = k0 + tx + 16 * j < kv_len ? s[i][j] * sm_scale : kMaskValue;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    m_new[i] = fmaxf(m_prev[i], mx);
    const float alpha = expf(m_prev[i] - m_new[i]);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - m_new[i]);
      rs += p;
      ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    }
    l_new[i] = alpha * l_prev[i] + rs;
    scale_pv[i] = l_new[i] == 0.f ? 1.f : 1.f / l_new[i];
    scale_old[i] = l_prev[i] * alpha * scale_pv[i];
  }
}

// pv[i][j] = sum_c P[4ty + i][c] V[c][tx + 16j] over the tile.
template <int D>
__device__ __forceinline__ void pv_tile(const float* ps, const float* vs,
                                        float (*pv)[D / 16]) {
  constexpr int LDP = kTile + 1;
  constexpr int DJ = D / 16;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) pv[i][j] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float vv[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ps[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) pv[i][j] = fmaf(p, vv[j], pv[i][j]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
fa1_fp32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ o,
         float* __restrict__ m, float* __restrict__ l, int sq, int skv,
         int kv_len, float sm_scale) {
  constexpr int LDK = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile * LDK;
  float* qs = vs + kTile * D;
  float* ps = qs + kTile * LDK;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t bh = blockIdx.x;
  const float* qp = q + bh * sq * D;
  const float* kp = k + bh * skv * D;
  const float* vp = v + bh * skv * D;
  float* op = o + bh * sq * D;
  float* mp = m + bh * sq;
  float* lp = l + bh * sq;
  const int n_kv = (kv_len + kTile - 1) / kTile;
  const int n_q = (sq + kTile - 1) / kTile;

  for (int t = 0; t < n_kv; ++t) {  // KV tiles: the outer loop
    __syncthreads();  // the previous pair is done with K and V
    stage<D, LDK>(ks, kp, t * kTile, skv);
    stage<D, D>(vs, vp, t * kTile, skv);
    for (int qt = 0; qt < n_q; ++qt) {  // Q tiles: the inner loop
      const int q0 = qt * kTile;
      __syncthreads();  // K/V staged; the previous pair is done with Q and P
      stage<D, LDK>(qs, qp, q0, sq);
      __syncthreads();
      // O, m and l of these rows come back from device memory.
      float m_prev[4], l_prev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        const bool live = t > 0 && row < sq;
        m_prev[i] = live ? mp[row] : -INFINITY;
        l_prev[i] = live ? lp[row] : 0.f;
      }
      float m_new[4], l_new[4], scale_old[4], scale_pv[4];
      score_tile<D>(qs, ks, ps, t * kTile, kv_len, sm_scale, m_prev, l_prev,
                    m_new, l_new, scale_old, scale_pv);
      __syncthreads();
      float pv[4][DJ];
      pv_tile<D>(ps, vs, pv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= sq) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const size_t at = static_cast<size_t>(row) * D + tx + 16 * j;
          const float o_prev = t > 0 ? op[at] : 0.f;
          op[at] = scale_old[i] * o_prev + scale_pv[i] * pv[i][j];
        }
        if (tx == 0) {
          mp[row] = m_new[i];
          lp[row] = l_new[i];
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
naive_fa2_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int sq,
               int skv, int kv_len, float sm_scale) {
  constexpr int LDK = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile * LDK;
  float* qs = vs + kTile * D;
  float* ps = qs + kTile * LDK;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const size_t bh = blockIdx.y;
  const float* kp = k + bh * skv * D;
  const float* vp = v + bh * skv * D;
  stage<D, LDK>(qs, q + bh * sq * D, q0, sq);

  float m_run[4], l_run[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kv = (kv_len + kTile - 1) / kTile;
  for (int t = 0; t < n_kv; ++t) {
    __syncthreads();  // Q staged; the previous tile is done with K, V and P
    stage<D, LDK>(ks, kp, t * kTile, skv);
    stage<D, D>(vs, vp, t * kTile, skv);
    __syncthreads();
    float m_new[4], l_new[4], scale_old[4], scale_pv[4];
    score_tile<D>(qs, ks, ps, t * kTile, kv_len, sm_scale, m_run, l_run,
                  m_new, l_new, scale_old, scale_pv);
    __syncthreads();
    float pv[4][DJ];
    pv_tile<D>(ps, vs, pv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        acc[i][j] = acc[i][j] * scale_old[i] + pv[i][j] * scale_pv[i];
      }
      m_run[i] = m_new[i];
      l_run[i] = l_new[i];
    }
  }
  float* op = o + bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      op[static_cast<size_t>(row) * D + tx + 16 * j] = acc[i][j];
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

template <int D>
constexpr int smem_bytes() {
  return (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D>
cudaError_t launch_fa1(const float* q, const float* k, const float* v,
                       float* o, float* m, float* l, int bh, int sq, int skv,
                       int kv_len, float sm_scale, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(fa1_fp32<D>, smem_bytes<D>(), smem_set);
  if (err != cudaSuccess) return err;
  fa1_fp32<D><<<bh, 256, smem_bytes<D>(), stream>>>(q, k, v, o, m, l, sq, skv,
                                                     kv_len, sm_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_naive(const float* q, const float* k, const float* v,
                         float* o, int bh, int sq, int skv, int kv_len,
                         float sm_scale, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(naive_fa2_fp32<D>, smem_bytes<D>(), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kTile - 1) / kTile, bh);
  naive_fa2_fp32<D><<<grid, 256, smem_bytes<D>(), stream>>>(q, k, v, o, sq,
                                                            skv, kv_len,
                                                            sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B9.  q, o [bh, sq, head_dim]; k, v [bh, skv, head_dim]; m, l [bh, sq]
// fp32 scratch (the running max and sum, written by the kernel).  All fp32
// and contiguous.  Keys at or past kv_len are masked.  Returns a
// cudaError_t.
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
  if (head_dim == 64) {
    return launch_fa1<64>(qf, kf, vf, of, mf, lf, bh, sq, skv, kv_len, sm_scale,
                          st);
  }
  if (head_dim == 128) {
    return launch_fa1<128>(qf, kf, vf, of, mf, lf, bh, sq, skv, kv_len,
                           sm_scale, st);
  }
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
  if (head_dim == 64) {
    return launch_naive<64>(qf, kf, vf, of, bh, sq, skv, kv_len, sm_scale, st);
  }
  if (head_dim == 128) {
    return launch_naive<128>(qf, kf, vf, of, bh, sq, skv, kv_len, sm_scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cfa_baselines_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
