// Flash-attention forward for Hopper (sm_90a): self-attention by blockwise
// online softmax, O and the per-row logsumexp.
//
// Replaces the TPU kernel `_fwd_kernel` driven by `_flash_forward_lse`
// (jen1_tpu/ops/flash_attention.py:45-167). What it computes is the same:
// S = Q K^T * sm_scale with fp32 running max m, sum l and accumulator, key
// columns >= N masked, an optional causal mask (col <= row), O = acc / l in
// q's dtype and lse = m + log(l) in fp32. What it does not carry over: the
// TPU kernel's sequential third grid axis over K/V tiles and its padded
// copies of q/k/v. Here one CTA owns one (batch*head, ROWS-row q tile) and
// loops over K/V tiles staged in shared memory; the ragged edge is masked
// in place, and causal CTAs stop at the diagonal tile.
//
// Layout: q, k, v, o are contiguous (B*H, N, D); lse is (B*H, N) fp32.
// D is one of 16, 32, 64, 128, 256: the wrapper zero-pads other head dims
// up to the next of these and passes the original D^-1/2 as sm_scale.
// Thread mapping: TPR threads share one query row; thread s of the row owns
// the head dims d = s + TPR*i, so a warp reading one K/V row from shared
// memory touches consecutive banks. The row's partial dot products are
// summed with warp shuffles. The K/V tile is dynamic shared memory; above
// 48 KB (D = 256) the launch first raises the kernel's limit, and a launch
// that still does not fit fails and is reported, never run.
//
// Bound at the generation slice's shape (B*H = 16, N = 1125, D = 16, bf16,
// two launches per UNet forward): 4*B*H*N^2*D = 1.30 GFLOP -> 1.31 us at
// 989 TFLOP/s bf16, against 2.37 MB of q/k/v/O/lse -> 0.71 us at 3.35 TB/s,
// so it is compute-bound at 1.31 us per call. At that size the launch itself
// (several us) is expected to dominate. This first version multiplies with
// scalar fp32 FMAs, not tensor cores, so its own ceiling is the 67 TFLOP/s
// fp32 rate; a wgmma/TMA redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tiling per head dim: TPR threads per row, ROWS rows per CTA (ROWS*TPR
// threads), BLOCK_K keys per shared-memory tile.
template <int D>
struct Tiles {
  static constexpr int TPR = D >= 256 ? 16 : (D >= 128 ? 8 : (D >= 64 ? 4 : 2));
  static constexpr int ROWS = D >= 256 ? 32 : 64;
  static constexpr int BLOCK_K = D >= 128 ? 32 : 64;
};

template <typename T, int D, int TPR, int ROWS, int BLOCK_K>
__global__ void __launch_bounds__(ROWS * TPR)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, float scale_log2, int causal) {
  constexpr int DPT = D / TPR;  // head dims per thread
  constexpr int NT = ROWS * TPR;
  extern __shared__ float smem[];
  float (*ks)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(smem + BLOCK_K * D);

  const int tid = threadIdx.x;
  const int s = tid % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int row = q0 + tid / TPR;
  const size_t base = (size_t)blockIdx.y * n * D;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < n ? to_f32(q[base + (size_t)row * D + s + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  // m is kept in log2 units: scores are pre-multiplied by log2(e).
  float m = -INFINITY, l = 0.f;

  const int k_end = causal ? min(n, q0 + ROWS) : n;
  for (int k0 = 0; k0 < k_end; k0 += BLOCK_K) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BLOCK_K * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int col = k0 + j;
      const size_t off = base + (size_t)col * D + d;
      ks[j][d] = col < n ? to_f32(k[off]) : 0.f;
      vs[j][d] = col < n ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[BLOCK_K];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], ks[j][s + TPR * i], part);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int col = k0 + j;
      const bool live = col < n && (!causal || col <= row);
      sc[j] = live ? part * scale_log2 : -INFINITY;
      m_tile = fmaxf(m_tile, sc[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    // a row with no live key so far keeps acc = l = 0 instead of NaN
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m - m_use);
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = exp2f(sc[j] - m_use);
      p_sum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[j][s + TPR * i], acc[i]);
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (row < n) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      o[base + (size_t)row * D + s + TPR * i] = from_f32<T>(acc[i] * inv);
    if (s == 0) lse[(size_t)blockIdx.y * n + row] = m * LN2 + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int n, int causal, float sm_scale, cudaStream_t stream) {
  using Tl = Tiles<D>;
  auto kernel = flash_fwd_kernel<T, D, Tl::TPR, Tl::ROWS, Tl::BLOCK_K>;
  const int smem = 2 * Tl::BLOCK_K * D * (int)sizeof(float);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + Tl::ROWS - 1) / Tl::ROWS, bh);
  kernel<<<grid, Tl::ROWS * Tl::TPR, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), n, sm_scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int n, int d, int causal, float sm_scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise. dtype: 0 = float32, 1 = bfloat16. sm_scale multiplies
// the logits (D^-1/2 of the head dim before any padding).
extern "C" int jen1_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int bh, int n, int d,
                                        int dtype, int causal, float sm_scale,
                                        void* stream) {
  if (bh < 1 || bh > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, lse, bh, n, d, causal, sm_scale, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
