// int8 weight-only matrix product for Hopper (sm_90a): out = (bf16(x) @ w8)
// * scale, the sum in fp32 and the per-column scale applied after it.
//
// Replaces the TPU kernel `_kernel` driven by `matmul_int8w`
// (jen1_tpu/ops/int8_matmul.py:48-139). What it computes is the same:
// acc[m, n] = sum_k bf16(x[m, k]) * float(w8[k, n]) in fp32 (each product
// is exact in fp32: an 8-bit significand times a 7-bit integer), then
// out[m, n] = acc[m, n] * scale[n], fp32. An fp32 x is rounded to bf16 on
// load (round to nearest even, as `x.astype(bfloat16)`). What it does not
// carry over: the TPU kernel keeps the whole K extent of x resident in VMEM
// and walks K as a sequential grid axis with the sum in scratch. Blocks on
// Hopper run in no order, so this kernel splits K across blocks instead and
// sums the splits in a second, fixed-order pass: no float atomics, and the
// result is the same from run to run.
//
// Layout: x (M, K) row-major bf16 or fp32, w8 (K, N) row-major int8, scale
// (N,) fp32, out (M, N) fp32; any M, K, N >= 1.
// Pass 1, grid (ceil(N/64), ceil(M/BM), splits), 256 threads: a block owns
// 64 columns, BM = 8, 16 or 32 rows and `chunk` rows of K. Per 64-row step
// of K it stages a 64 x 64 int8 weight tile in shared memory (one 16-byte
// load a thread where N and the pointer allow it, byte loads at the ragged
// edge) and the x tile as fp32, transposed to [k][m]. Thread t owns column
// t % 64 and rows (t / 64) * RPT ... + RPT - 1, and keeps their sums in
// registers. With one split it writes out = acc * scale directly; with
// more it writes fp32 partials (splits, M, N) to a workspace.
// Pass 2 (only with splits > 1): out[m, n] = scale[n] * sum over splits in
// split order.
//
// Bound at the flagship shapes (M = 6 or 10 rows of a CFG-doubled batch,
// K = 1024-6144, N = 1024): the weight bytes dominate (3 MB int8 at
// (10, 3072, 1024)), so it is bound by bytes at 3.35 TB/s (~0.9 us there),
// far below the launch cost. The M x N grid alone is 16 blocks on 132 SMs;
// the split over K (chosen by the wrapper, ~264 blocks) spreads the weight
// stream over the whole card. This first version multiplies with scalar
// fp32 FMAs; tensor cores (int8 -> bf16 into wgmma) and a pipelined weight
// stream are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int ROW_GROUPS = THREADS / BN;  // 4

__device__ __forceinline__ float to_bf16_f32(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float to_bf16_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS)
int8w_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ dst, int m,
                    int k, int n, int chunk, int direct) {
  constexpr int BM = ROW_GROUPS * RPT;
  __shared__ float xs[BK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ __align__(16) int8_t ws[BK][BN];

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int row0 = (tid / BN) * RPT;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k, k_begin + chunk);
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (n % 16 == 0);
  // this thread's 16-byte slice of the weight tile
  const int w_row = tid / (BN / 16);
  const int w_col = (tid % (BN / 16)) * 16;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK, kk = idx % BK;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < m && gk < k_end) ? to_bf16_f32(x[(size_t)gm * k + gk]) : 0.f;
    }
    {
      const int gk = k0 + w_row, gn = n0 + w_col;
      int4 v = make_int4(0, 0, 0, 0);
      if (gk < k_end) {
        const int8_t* src = w + (size_t)gk * n + gn;
        if (vec && gn + 16 <= n) {
          v = *reinterpret_cast<const int4*>(src);
        } else {
          int8_t* b = reinterpret_cast<int8_t*>(&v);
#pragma unroll
          for (int j = 0; j < 16; ++j) b[j] = gn + j < n ? src[j] : (int8_t)0;
        }
      }
      *reinterpret_cast<int4*>(&ws[w_row][w_col]) = v;
    }
    __syncthreads();
    // rows of K past k_end and columns past N were staged as zeros
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float wv = (float)ws[kk][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(xs[kk][row0 + i], wv, acc[i]);
    }
  }

  const int gn = n0 + col;
  if (gn >= n) return;
  const float s = direct ? scale[gn] : 0.f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gm = m0 + row0 + i;
    if (gm >= m) break;
    if (direct)
      dst[(size_t)gm * n + gn] = acc[i] * s;
    else
      dst[((size_t)blockIdx.z * m + gm) * n + gn] = acc[i];
  }
}

__global__ void int8w_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ scale, float* __restrict__ out,
                                    int m, int n, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)m * n;
  if (idx >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[s * mn + idx];
  out[idx] = sum * scale[idx % n];
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scale, void* work, void* out,
                   int m, int k, int n, int splits, int chunk, cudaStream_t stream) {
  const int rpt = m <= 8 ? 2 : (m <= 16 ? 4 : 8);
  const int bm = ROW_GROUPS * rpt;
  const dim3 grid((n + BN - 1) / BN, (m + bm - 1) / bm, splits);
  if (grid.y > 65535 || splits > 65535) return cudaErrorInvalidValue;
  const int direct = splits == 1;
  float* dst = static_cast<float*>(direct ? out : work);
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* st = static_cast<const float*>(scale);
  switch (rpt) {
    case 2: int8w_matmul_kernel<T, 2><<<grid, THREADS, 0, stream>>>(xt, wt, st, dst, m, k, n, chunk, direct); break;
    case 4: int8w_matmul_kernel<T, 4><<<grid, THREADS, 0, stream>>>(xt, wt, st, dst, m, k, n, chunk, direct); break;
    default: int8w_matmul_kernel<T, 8><<<grid, THREADS, 0, stream>>>(xt, wt, st, dst, m, k, n, chunk, direct); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const size_t mn = (size_t)m * n;
  const int threads = 256;
  int8w_reduce_kernel<<<(unsigned)((mn + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(work), st, static_cast<float*>(out), m, n, splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise. dtype of x: 0 = float32, 1 = bfloat16. `splits` blocks
// share K, each `chunk` rows of it (a multiple of 64, with
// (splits - 1) * chunk < k <= splits * chunk); with splits > 1 `work` holds
// (splits, m, n) fp32 partials, else it is unused.
extern "C" int jen1_int8w_matmul(const void* x, const void* w, const void* scale, void* work,
                                 void* out, int m, int k, int n, int dtype, int splits,
                                 int chunk, void* stream) {
  if (m < 1 || k < 1 || n < 1 || splits < 1 || chunk < 1 || chunk % BK != 0 ||
      (long long)(splits - 1) * chunk >= k || (long long)splits * chunk < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, scale, work, out, m, k, n, splits, chunk, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, scale, work, out, m, k, n, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
