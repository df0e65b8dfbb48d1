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
// Layout: q, k, v, dO, dq, dk, dv contiguous (B*H, N, D); lse, delta
// (B*H, N) fp32. D is one of 16, 32, 64, 128, 256 (the wrapper zero-pads
// other head dims, which is exact, and passes the original D^-1/2 as
// sm_scale).
//
// K2 and K3 in fp32: scalar fp32 FMAs. One CTA owns one
// (batch*head, ROWS-row tile): K2 a q tile streaming K/V tiles, dq in
// registers, key columns >= N masked, causal CTAs stop at the diagonal;
// K3 a k tile streaming Q/dO tiles (with lse, delta), dk and dv in
// registers, query rows >= N masked (dk and dv sum over queries), causal
// CTAs start at the diagonal. TPR threads share one row and own its head
// dims d = s + TPR*i; each of the row's two dot products per partner (S
// and dP) is summed with warp shuffles. Tiles live in dynamic shared
// memory; above 48 KB (D = 256) the launch raises the kernel's limit
// first, and a launch that does not fit fails and is reported.
//
// K2 in bf16: `flash_bwd_dq_mma_kernel`, tensor cores, the K1 design
// (flash_attention_fwd.cu) turned to the gradient. A CTA is 4 warps and a
// 64-row q tile, 16 rows per warp, whose Q and dO A fragments stay in
// registers (ldmatrix once), with lse log2(e) and delta of the thread's two
// rows: (ceil(N/64), B*H) CTAs, 576 at the train shape. It loops over key
// tiles of 64, K and V double-buffered by cp.async (rows >= N zero-filled),
// in four chunks of 16 keys: S = Q K^T and dP = dO V^T (K and V read by
// ldmatrix), P = 2^(S sm_scale log2(e) - lse log2(e)) with key columns
// >= N and the causal mask applied only on the ragged and the diagonal
// tile, dS = P o (dP - delta); then dq += dS K (K by ldmatrix.trans), dS
// going from its C fragments straight to an A fragment as bf16 hi + lo, for
// the reason given for K3 below (JAX multiplies dS in fp32, :212-215).
// Causal CTAs stop at the diagonal. sm_scale multiplies dq once at the end;
// each dq element has one writer. Every bf16 head dim takes this route.
//
// K3 in bf16: `flash_bwd_dkv_mma_kernel`, tensor cores (mma.sync.m16n8k16,
// bf16 in, fp32 accumulate; see flash_mma.cuh). A CTA is 4 warps and a
// 64-key tile, 16 keys per warp, whose K and V A fragments stay in
// registers: (ceil(N/64), B*H) CTAs, 576 at the train shape. It loops over
// q tiles of 64, Q and dO double-buffered in shared memory by cp.async
// (rows >= N zero-filled) with lse and delta beside them, in four chunks
// of 16 queries: S^T = K Q^T and dP^T = V dO^T (Q and dO read by
// ldmatrix), P^T = 2^(S^T sm_scale log2(e) - lse log2(e)) with query rows
// >= N and the causal mask applied only on the ragged and the diagonal
// tile, dS^T = P^T o (dP^T - delta); then dV += P^T dO and dK += dS^T Q (dO
// and Q by ldmatrix.trans), P^T and dS^T going from their C fragments
// straight to A fragments as bf16 hi + lo: JAX multiplies them in fp32
// (:262-271), and one bf16 copy would be off by up to 2^-9 of each term.
// sm_scale multiplies dK once at the end. Each dk/dv element is written by
// one thread: no atomics, the same result on every run. All bf16 head dims
// take this route; D = 128 and 256 spill registers (-Xptxas -v). fp32
// stays scalar: a TF32 (10-bit) product would miss the fp32 bar (1e-4 of
// max|ref|).
//
// Bound at the training shape (B*H = 32, N = 1125, D = 16, bf16,
// non-causal): K2 does 6*B*H*N^2*D = 3.89 GFLOP -> 3.9 us at 989 TFLOP/s,
// against ~6.0 MB of q/k/v/dO/lse/delta/dq -> 1.8 us at 3.35 TB/s; K3 does
// 8*B*H*N^2*D = 5.18 GFLOP -> 5.2 us against ~7.2 MB -> 2.1 us. At D = 16
// the exponentials bound both instead: B*H*N^2 = 40.5 M ex2 at 16 per
// clock per SM are ~9.7 us on 132 SMs at 1.98 GHz. K3's tensor-core route
// runs per score one FFMA, one ex2, the dS product and two hi + lo splits
// against 1.5 mma, so, as in K1, the instruction rate of each scheduler
// with the ex2 and tensor pipes paces it (PERF.md). K2's tensor-core route
// runs one FFMA, one ex2, the dS product and one split per score against
// 1.5 mma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// K3, bf16 route: dk and dv for one 64-key tile on tensor cores, streaming
// 64-query tiles of Q/dO (double-buffered) with their lse and delta.
template <int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, float sm_scale,
                         int causal) {
  using namespace flash_mma;
  using L = Layout<D>;
  constexpr int KSTEPS = L::KSTEPS, NTILES = L::NTILES;
  // per stage: Q tile, dO tile, lse and delta (TILE floats each)
  constexpr int STAGE_BYTES = 2 * L::TILE_BYTES + 2 * TILE * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [K][V], then two stages of [Q][dO][lse][delta]
  const uint32_t ks = smem_addr(smem_raw), vs = ks + L::TILE_BYTES;
  const uint32_t stage0 = ks + 2 * L::TILE_BYTES;
  const unsigned char* stage0_ptr = smem_raw + 2 * L::TILE_BYTES;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16 *qg = q + base, *dog = dout + base;
  // threads 0..63 stage lse, 64..127 delta: one value each per q tile
  const float* vec = (threadIdx.x < TILE ? lse : delta) + (size_t)blockIdx.y * n;
  const uint32_t vec_dst = 2 * L::TILE_BYTES + threadIdx.x * 4;
  const int vec_row = threadIdx.x % TILE;
  const Stager<D> stage_tile(threadIdx.x);
  const Lanes<D> lanes(lane);
  // the two keys of this thread's C fragments
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale_log2 = sm_scale * LOG2E;

  auto stage_q_tile = [&](uint32_t stage, int q0) {
    stage_tile(stage, qg, q0, n);
    stage_tile(stage + L::TILE_BYTES, dog, q0, n);
    const bool live = q0 + vec_row < n;
    cp_async_4(stage + vec_dst, live ? vec + q0 + vec_row : vec, live ? 4 : 0);
  };

  // causal: q tiles that end above this k tile's first key add nothing
  const int q_start = causal ? k0 : 0;
  const int tiles = (n - q_start + TILE - 1) / TILE;
  stage_tile(ks, k + base, k0, n);
  stage_tile(vs, v + base, k0, n);
  stage_q_tile(stage0, q_start);
  cp_async_commit();

  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  // dK / sm_scale and dV; at D <= 32 (few n8 tiles, so long chains of
  // dependent mma per tile) the hi and lo products go to separate halves
  constexpr int HALVES = D <= 32 ? 2 : 1;
  float dk_acc[HALVES][NTILES][4], dv_acc[HALVES][NTILES][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int dt = 0; dt < NTILES; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[h][dt][e] = dv_acc[h][dt][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int q0 = q_start + t * TILE;
    const uint32_t qt = stage0 + (t & 1) * STAGE_BYTES, dot = qt + L::TILE_BYTES;
    const float* lt =
        reinterpret_cast<const float*>(stage0_ptr + (t & 1) * STAGE_BYTES + 2 * L::TILE_BYTES);
    const float* delt = lt + TILE;
    if (t + 1 < tiles) {
      stage_q_tile(stage0 + ((t + 1) & 1) * STAGE_BYTES, q0 + TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ldmatrix_x4(kf[kk], ks + lanes.a + L::at(warp * 16, kk * 16));
        ldmatrix_x4(vf[kk], vs + lanes.a + L::at(warp * 16, kk * 16));
      }
    }
    // query rows >= n on the ragged tile; col > row on the diagonal one
    const bool masked = q0 + TILE > n || (causal && q0 == k0);

#pragma unroll
    for (int ch = 0; ch < TILE; ch += 16) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries, two n8 tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, qt + lanes.b_rows + L::at(ch, kk * 16));
        mma(s[0], kf[kk], b[0], b[1]);
        mma(s[1], kf[kk], b[2], b[3]);
        ldmatrix_x4(b, dot + lanes.b_rows + L::at(ch, kk * 16));
        mma(dp[0], vf[kk], b[0], b[1]);
        mma(dp[1], vf[kk], b[2], b[3]);
      }

      // P^T and dS^T as bf16 hi + lo A fragments (k = the 16 queries)
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = ch + j * 8 + 2 * c;  // query of e = 0, 2; qi + 1 for e = 1, 3
        const float2 lq = *reinterpret_cast<const float2*>(lt + qi);
        const float2 dl = *reinterpret_cast<const float2*>(delt + qi);
        const float lse2[2] = {lq.x * LOG2E, lq.y * LOG2E};
        const float del[2] = {dl.x, dl.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(fmaf(s[j][e], scale_log2, -lse2[e & 1]));
          if (masked) {
            const int row = q0 + qi + (e & 1);
            if (row >= n || (causal && keys[e / 2] > row)) p[e] = 0.f;
          }
          ds[e] = p[e] * (dp[j][e] - del[e & 1]);  // sm_scale is applied to dK at the end
        }
        split(p[0], p[1], p_hi[2 * j], p_lo[2 * j]);
        split(p[2], p[3], p_hi[2 * j + 1], p_lo[2 * j + 1]);
        split(ds[0], ds[1], ds_hi[2 * j], ds_lo[2 * j]);
        split(ds[2], ds[3], ds_hi[2 * j + 1], ds_lo[2 * j + 1]);
      }

      // dV += P^T dO and dK += dS^T Q over the chunk's 16 queries
#pragma unroll
      for (int dt = 0; dt < NTILES; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dot + lanes.b_trans + L::at(ch, dt * 8));
        mma(dv_acc[0][dt], p_hi, b[0], b[1]);
        mma(dv_acc[HALVES - 1][dt], p_lo, b[0], b[1]);
        mma(dv_acc[0][dt + 1], p_hi, b[2], b[3]);
        mma(dv_acc[HALVES - 1][dt + 1], p_lo, b[2], b[3]);
        ldmatrix_x4_trans(b, qt + lanes.b_trans + L::at(ch, dt * 8));
        mma(dk_acc[0][dt], ds_hi, b[0], b[1]);
        mma(dk_acc[HALVES - 1][dt], ds_lo, b[0], b[1]);
        mma(dk_acc[0][dt + 1], ds_hi, b[2], b[3]);
        mma(dk_acc[HALVES - 1][dt + 1], ds_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next prefetch refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= n) continue;
    const size_t off = base + (size_t)keys[r] * D + 2 * c;
#pragma unroll
    for (int dt = 0; dt < NTILES; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8) =
          __floats2bfloat162_rn(total(dk_acc, dt, 2 * r) * sm_scale,
                                total(dk_acc, dt, 2 * r + 1) * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8) =
          __floats2bfloat162_rn(total(dv_acc, dt, 2 * r), total(dv_acc, dt, 2 * r + 1));
    }
  }
}

// K2, bf16 route: dq for one 64-row q tile on tensor cores, streaming
// 64-key tiles of K/V (double-buffered).
template <int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, float sm_scale, int causal) {
  using namespace flash_mma;
  using L = Layout<D>;
  constexpr int KSTEPS = L::KSTEPS, NTILES = L::NTILES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q and dO tiles, then two stages of K and V tiles: [Q][dO][K0][V0][K1][V1]
  const uint32_t qs = smem_addr(smem_raw), dos = qs + L::TILE_BYTES;
  const uint32_t kv0 = qs + 2 * L::TILE_BYTES;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16 *kg = k + base, *vg = v + base;
  const Stager<D> stage_tile(threadIdx.x);
  const Lanes<D> lanes(lane);
  // the two query rows of this thread's C fragments, their lse (log2
  // units) and delta; rows >= n read 0 and are never written
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = rows[r] < n;
    const size_t i = (size_t)blockIdx.y * n + rows[r];
    lse2[r] = live ? lse[i] * LOG2E : 0.f;
    del[r] = live ? delta[i] : 0.f;
  }
  const float scale_log2 = sm_scale * LOG2E;

  const int k_end = causal ? min(n, q0 + TILE) : n;
  const int tiles = (k_end + TILE - 1) / TILE;
  stage_tile(qs, q + base, q0, n);
  stage_tile(dos, dout + base, q0, n);
  stage_tile(kv0, kg, 0, n);
  stage_tile(kv0 + L::TILE_BYTES, vg, 0, n);
  cp_async_commit();

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  // dq / sm_scale; at D <= 32 the hi and lo products go to separate halves
  constexpr int HALVES = D <= 32 ? 2 : 1;
  float acc[HALVES][NTILES][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int dt = 0; dt < NTILES; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][dt][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const uint32_t kt = kv0 + (t & 1) * 2 * L::TILE_BYTES, vt = kt + L::TILE_BYTES;
    if (t + 1 < tiles) {
      const uint32_t next = kv0 + ((t + 1) & 1) * 2 * L::TILE_BYTES;
      stage_tile(next, kg, (t + 1) * TILE, n);
      stage_tile(next + L::TILE_BYTES, vg, (t + 1) * TILE, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ldmatrix_x4(qf[kk], qs + lanes.a + L::at(warp * 16, kk * 16));
        ldmatrix_x4(dof[kk], dos + lanes.a + L::at(warp * 16, kk * 16));
      }
    }
    // key columns >= n on the ragged tile; col > row on the diagonal one
    const int k0 = t * TILE;
    const bool masked = k0 + TILE > n || (causal && k0 + TILE > q0);

#pragma unroll
    for (int ch = 0; ch < TILE; ch += 16) {
      // S = Q K^T and dP = dO V^T: 16 rows x 16 keys, two n8 tiles
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + lanes.b_rows + L::at(ch, kk * 16));
        mma(s[0], qf[kk], b[0], b[1]);
        mma(s[1], qf[kk], b[2], b[3]);
        ldmatrix_x4(b, vt + lanes.b_rows + L::at(ch, kk * 16));
        mma(dp[0], dof[kk], b[0], b[1]);
        mma(dp[1], dof[kk], b[2], b[3]);
      }

      // dS as a bf16 hi + lo A fragment (k = the 16 keys)
      uint32_t ds_hi[4], ds_lo[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(s[j][e], scale_log2, -lse2[e / 2]));
          if (masked) {
            const int col = k0 + ch + j * 8 + 2 * c + (e & 1);
            if (col >= n || (causal && col > rows[e / 2])) p = 0.f;
          }
          ds[e] = p * (dp[j][e] - del[e / 2]);  // sm_scale is applied to dq at the end
        }
        split(ds[0], ds[1], ds_hi[2 * j], ds_lo[2 * j]);
        split(ds[2], ds[3], ds_hi[2 * j + 1], ds_lo[2 * j + 1]);
      }

      // dq += dS K over the chunk's 16 keys
#pragma unroll
      for (int dt = 0; dt < NTILES; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kt + lanes.b_trans + L::at(ch, dt * 8));
        mma(acc[0][dt], ds_hi, b[0], b[1]);
        mma(acc[HALVES - 1][dt], ds_lo, b[0], b[1]);
        mma(acc[0][dt + 1], ds_hi, b[2], b[3]);
        mma(acc[HALVES - 1][dt + 1], ds_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next prefetch refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= n) continue;
    bf16* row = dq + base + (size_t)rows[r] * D + 2 * c;
#pragma unroll
    for (int dt = 0; dt < NTILES; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) =
          __floats2bfloat162_rn(total(acc, dt, 2 * r) * sm_scale,
                                total(acc, dt, 2 * r + 1) * sm_scale);
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

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  using flash_mma::TILE;
  auto kernel = flash_bwd_dq_mma_kernel<D>;
  // Q and dO tiles, two stages of K and V tiles
  const int smem = 6 * flash_mma::Layout<D>::TILE_BYTES;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + TILE - 1) / TILE, a.bh);
  kernel<<<grid, flash_mma::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.n, a.sm_scale, a.causal);
  return cudaGetLastError();
}

// K2: bf16 takes the tensor-core kernel, fp32 the scalar one.
template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dq_mma<D>(a);
  } else {
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
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  using flash_mma::TILE;
  auto kernel = flash_bwd_dkv_mma_kernel<D>;
  // K and V tiles, two stages of Q and dO tiles, two of lse and delta
  const int smem = 6 * flash_mma::Layout<D>::TILE_BYTES + 4 * TILE * (int)sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + TILE - 1) / TILE, a.bh);
  kernel<<<grid, flash_mma::THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, a.sm_scale, a.causal);
  return cudaGetLastError();
}

// K3: bf16 takes the tensor-core kernel, fp32 the scalar one.
template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkv_mma<D>(a);
  } else {
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
  if (dtype == 1) return (int)dispatch_d<DQ, bf16>(a, d);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success);
// neither synchronises. dtype: 0 = float32, 1 = bfloat16 (the tensor-core
// routes: every pointer 16-byte aligned). sm_scale is the
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
