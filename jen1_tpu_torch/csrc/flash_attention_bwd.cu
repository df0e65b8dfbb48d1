// Flash-attention backward for Hopper (sm_90a): the two recompute kernels
// of the flash-attention gradient, dq (K2) and dk/dv (K3).
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` driven by
// `_flash_backward` (jen1_tpu/ops/flash_attention.py:173-351). What they
// compute is the same: with the forward's per-row logsumexp lse and
// delta_i = sum_d dO_id O_id (computed outside the kernels, in fp32),
//   S = Q K^T * sm_scale,  P = exp(S - lse)  (no second softmax),
//   dP = dO V^T,           dS = P o (dP - delta) * sm_scale,
//   dq = dS K,  dk = dS^T Q,  dv = P^T dO,
// with padded key columns and padded query rows masked and an optional
// causal mask (col <= row). Outputs are written in q's dtype; every sum is
// fp32. What they do not carry over: the TPU kernels' sequential third grid
// axis with its dq/dk/dv scratch, and the padded copies of every input.
//
// K2: one CTA owns one (batch*head, ROWS-row q tile) and loops over K/V
// tiles staged in shared memory; dq stays in registers across the loop.
// Key columns >= N are masked in place; causal CTAs stop at the diagonal.
// K3: one CTA owns one (batch*head, ROWS-row k tile) and loops over Q/dO
// tiles (with their lse and delta) staged in shared memory; dk and dv stay
// in registers. Query rows >= N are masked, since dk and dv sum over
// queries; causal CTAs start at the diagonal tile. Each output element is
// written by exactly one thread, so no atomics are needed.
//
// Layout: q, k, v, dO, dq, dk, dv contiguous (B*H, N, D); lse, delta
// (B*H, N) fp32. D is one of 16, 32, 64, 128, 256 (the wrapper zero-pads
// other head dims, which is exact, and passes the original D^-1/2 as
// sm_scale). Thread mapping as in the forward: TPR threads share one row
// and own its head dims d = s + TPR*i; each of the row's two dot products
// per partner (S and dP) is summed with warp shuffles. Tiles live in
// dynamic shared memory; above 48 KB (D = 256) the launch raises the
// kernel's limit first, and a launch that does not fit fails and is
// reported.
//
// Bound at the training shape (B*H = 32, N = 1125, D = 16, bf16,
// non-causal): K2 does 6*B*H*N^2*D = 3.89 GFLOP -> 3.9 us at 989 TFLOP/s,
// against ~6.0 MB of q/k/v/dO/lse/delta/dq -> 1.8 us at 3.35 TB/s; K3 does
// 8*B*H*N^2*D = 5.18 GFLOP -> 5.2 us against ~7.2 MB -> 2.1 us. Both are
// bound by operations. Like the forward, this first version uses scalar
// fp32 FMAs (its own ceiling is the 67 TFLOP/s fp32 rate, ~15x the bound);
// tensor cores (mma.sync/wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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

// Tiling per head dim: TPR threads per row, ROWS owned rows per CTA
// (ROWS*TPR threads), BLOCK streamed rows per shared-memory tile.
template <int D>
struct Tiles {
  static constexpr int TPR = D >= 256 ? 16 : (D >= 128 ? 8 : (D >= 64 ? 4 : 2));
  static constexpr int ROWS = D >= 256 ? 32 : 64;
  static constexpr int BLOCK = D >= 128 ? 32 : 64;
};

// Sum of a partial value over the TPR threads of one row.
template <int TPR>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

// K2: dq for one q tile, streaming K/V tiles.
template <typename T, int D, int TPR, int ROWS, int BLOCK>
__global__ void __launch_bounds__(ROWS * TPR)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n, float sm_scale, int causal) {
  constexpr int DPT = D / TPR;
  constexpr int NT = ROWS * TPR;
  extern __shared__ float smem[];
  float (*ks)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(smem + BLOCK * D);

  const int tid = threadIdx.x;
  const int s = tid % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int row = q0 + tid / TPR;
  const bool row_live = row < n;
  const size_t base = (size_t)blockIdx.y * n * D;
  const float scale_log2 = sm_scale * LOG2E;

  float qr[DPT], dor[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const size_t off = base + (size_t)row * D + s + TPR * i;
    qr[i] = row_live ? to_f32(q[off]) : 0.f;
    dor[i] = row_live ? to_f32(dout[off]) : 0.f;
    acc[i] = 0.f;
  }
  const size_t r = (size_t)blockIdx.y * n + row;
  const float lse_r = row_live ? lse[r] * LOG2E : 0.f;
  const float delta_r = row_live ? delta[r] : 0.f;

  const int k_end = causal ? min(n, q0 + ROWS) : n;
  for (int k0 = 0; k0 < k_end; k0 += BLOCK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BLOCK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      const int col = k0 + j;
      const size_t off = base + (size_t)col * D + d;
      ks[j][d] = col < n ? to_f32(k[off]) : 0.f;
      vs[j][d] = col < n ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BLOCK; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sp = fmaf(qr[i], ks[j][s + TPR * i], sp);
        dpp = fmaf(dor[i], vs[j][s + TPR * i], dpp);
      }
      sp = row_sum<TPR>(sp);
      dpp = row_sum<TPR>(dpp);
      const int col = k0 + j;
      const bool live = row_live && col < n && (!causal || col <= row);
      const float p = live ? exp2f(sp * scale_log2 - lse_r) : 0.f;
      const float ds = p * (dpp - delta_r) * sm_scale;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, ks[j][s + TPR * i], acc[i]);
    }
  }

  if (row_live) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[base + (size_t)row * D + s + TPR * i] = from_f32<T>(acc[i]);
  }
}

// K3: dk and dv for one k tile, streaming Q/dO tiles with their lse, delta.
template <typename T, int D, int TPR, int ROWS, int BLOCK>
__global__ void __launch_bounds__(ROWS * TPR)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n, float sm_scale,
                     int causal) {
  constexpr int DPT = D / TPR;
  constexpr int NT = ROWS * TPR;
  extern __shared__ float smem[];
  float (*qs)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*dos)[D] = reinterpret_cast<float (*)[D]>(smem + BLOCK * D);
  float* lse_s = smem + 2 * BLOCK * D;
  float* delta_s = lse_s + BLOCK;

  const int tid = threadIdx.x;
  const int s = tid % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int col = k0 + tid / TPR;
  const bool col_live = col < n;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t row_base = (size_t)blockIdx.y * n;
  const float scale_log2 = sm_scale * LOG2E;

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const size_t off = base + (size_t)col * D + s + TPR * i;
    kr[i] = col_live ? to_f32(k[off]) : 0.f;
    vr[i] = col_live ? to_f32(v[off]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  // causal: q tiles that end above this k tile's first column add nothing
  const int q_start = causal ? (k0 / BLOCK) * BLOCK : 0;
  for (int q0 = q_start; q0 < n; q0 += BLOCK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BLOCK * D; idx += NT) {
      const int i = idx / D, d = idx % D;
      const int row = q0 + i;
      const size_t off = base + (size_t)row * D + d;
      qs[i][d] = row < n ? to_f32(q[off]) : 0.f;
      dos[i][d] = row < n ? to_f32(dout[off]) : 0.f;
    }
    for (int i = tid; i < BLOCK; i += NT) {
      const int row = q0 + i;
      lse_s[i] = row < n ? lse[row_base + row] * LOG2E : 0.f;
      delta_s[i] = row < n ? delta[row_base + row] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BLOCK; ++i) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        sp = fmaf(kr[e], qs[i][s + TPR * e], sp);
        dpp = fmaf(vr[e], dos[i][s + TPR * e], dpp);
      }
      sp = row_sum<TPR>(sp);
      dpp = row_sum<TPR>(dpp);
      const int row = q0 + i;
      // padded query rows must be masked: dk and dv sum over queries
      const bool live = col_live && row < n && (!causal || col <= row);
      const float p = live ? exp2f(sp * scale_log2 - lse_s[i]) : 0.f;
      const float ds = p * (dpp - delta_s[i]) * sm_scale;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        dv_acc[e] = fmaf(p, dos[i][s + TPR * e], dv_acc[e]);
        dk_acc[e] = fmaf(ds, qs[i][s + TPR * e], dk_acc[e]);
      }
    }
  }

  if (col_live) {
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const size_t off = base + (size_t)col * D + s + TPR * e;
      dk[off] = from_f32<T>(dk_acc[e]);
      dv[off] = from_f32<T>(dv_acc[e]);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit where the tile needs more
// than the default 48 KB; the launch after it reports what still does not fit.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, n, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  using Tl = Tiles<D>;
  auto kernel = flash_bwd_dq_kernel<T, D, Tl::TPR, Tl::ROWS, Tl::BLOCK>;
  const int smem = 2 * Tl::BLOCK * D * (int)sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + Tl::ROWS - 1) / Tl::ROWS, a.bh);
  kernel<<<grid, Tl::ROWS * Tl::TPR, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.n, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  using Tl = Tiles<D>;
  auto kernel = flash_bwd_dkv_kernel<T, D, Tl::TPR, Tl::ROWS, Tl::BLOCK>;
  const int smem = (2 * Tl::BLOCK * D + 2 * Tl::BLOCK) * (int)sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + Tl::ROWS - 1) / Tl::ROWS, a.bh);
  kernel<<<grid, Tl::ROWS * Tl::TPR, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.n, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch_d(const Args& a, int d) {
  switch (d) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256: return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(const Args& a, int d, int dtype) {
  if (a.bh < 1 || a.bh > 65535 || a.n < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_d<DQ, float>(a, d);
  if (dtype == 1) return (int)dispatch_d<DQ, __nv_bfloat16>(a, d);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success);
// neither synchronises. dtype: 0 = float32, 1 = bfloat16. sm_scale is the
// forward's logit scale (D^-1/2 of the head dim before any padding).
extern "C" int jen1_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int bh, int n,
                                           int d, int dtype, int causal, float sm_scale,
                                           void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               bh, n, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, dtype);
}

extern "C" int jen1_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int bh,
                                            int n, int d, int dtype, int causal,
                                            float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               bh, n, causal, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, dtype);
}
