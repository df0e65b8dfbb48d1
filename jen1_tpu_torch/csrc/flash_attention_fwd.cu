// Flash-attention forward for Hopper (sm_90a), K1: self-attention by
// blockwise online softmax, O and the per-row logsumexp.
//
// Replaces the TPU kernel `_fwd_kernel` driven by `_flash_forward_lse`
// (jen1_tpu/ops/flash_attention.py:45-167). What it computes is the same:
// S = Q K^T * sm_scale with fp32 running max m, sum l and accumulator, key
// columns >= N masked, an optional causal mask (col <= row), O = acc / l in
// q's dtype and lse = m + log(l) in fp32. What it does not carry over: the
// TPU kernel's sequential third grid axis over K/V tiles and its padded
// copies of q/k/v. Here one CTA owns one (batch*head, 64-row q tile) and
// loops over K/V tiles; the ragged edge is masked in place, and causal CTAs
// stop at the diagonal tile.
//
// Layout: q, k, v, o are contiguous (B*H, N, D); lse is (B*H, N) fp32.
// D is one of 16, 32, 64, 128, 256: the wrapper zero-pads other head dims
// up to the next of these and passes the original D^-1/2 as sm_scale.
//
// Two routes, chosen by dtype alone (ops/flash_attention.py
// `tensor_core_route` states the same rule):
//  * bf16 -> `flash_fwd_mma_kernel`, tensor cores (mma.sync.m16n8k16, bf16
//    in, fp32 accumulate; flash_mma.cuh). A CTA is 4 warps and a 64-row q
//    tile, 16 rows per warp, so (ceil(N/64), B*H) CTAs: 288 at the
//    generation shape, all resident at once. Q's A fragments stay in
//    registers; K/V tiles of 64 keys are double-buffered in shared memory
//    by cp.async (rows >= N zero-filled) and read by ldmatrix (V with
//    .trans). The online softmax runs on the C fragments in registers (a
//    tree max and two quad shuffles per row, the row sum reduced once at
//    the end), with sm_scale*log2(e) folded into the FMA before ex2, and
//    the masks applied only on the diagonal and the ragged tile; causal
//    CTAs stop at the diagonal. P feeds P V straight from its C fragments
//    as bf16 hi + lo: JAX multiplies an fp32 P by V (:93-95), and one bf16
//    P would be off by up to 2^-9 of each term, several times the bf16 O
//    bar (chip_smoke.py prints by how much). bf16 x bf16 products are exact
//    in fp32, so S matches JAX's fp32 dot of the bf16 inputs up to the
//    summation order. All bf16 head dims take this route; at D = 256 it
//    spills a few registers (-Xptxas -v), which costs time, not accuracy.
//  * fp32 -> `flash_fwd_kernel`, scalar fp32 FMAs. A TF32 (10-bit) product
//    of fp32 q and k would miss the fp32 bars (lse 1e-4, O 2e-3), and three
//    bf16 products per fp32 product would cost more than the scalar loop.
//
// Bound at the generation slice's shape (B*H = 16, N = 1125, D = 16, bf16,
// two launches per UNet forward): 4*B*H*N^2*D = 1.30 GFLOP -> 1.31 us at
// 989 TFLOP/s bf16, against 2.37 MB of q/k/v/O/lse -> 0.71 us at 3.35 TB/s.
// At D = 16 the exponentials bound it instead: B*H*N^2 = 20.25 M ex2 on the
// special-function unit, 16 per clock per SM, are ~4.8 us on 132 SMs at
// 1.98 GHz. What paces this kernel is neither: per score it runs one FFMA,
// one ex2, a max, a sum and three instructions of the hi + lo split
// against 3/4 of an mma, so the instruction rate of each scheduler and the
// ex2 and tensor pipes together hold it at ~4x the ex2 bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash_mma.cuh"

namespace {

using flash_mma::bf16;

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;

// Raise the kernel's dynamic shared-memory limit where the tile needs more
// than the default 48 KB; the launch after it reports what still does not fit.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= STATIC_SMEM_LIMIT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------- fp32 route

// Tiling per head dim: TPR threads share one query row and own its head
// dims d = s + TPR*i (a warp reading one K/V row from shared memory touches
// consecutive banks); ROWS rows per CTA, BLOCK_K keys per shared tile.
template <int D>
struct Tiles {
  static constexpr int TPR = D >= 256 ? 16 : (D >= 128 ? 8 : (D >= 64 ? 4 : 2));
  static constexpr int ROWS = D >= 256 ? 32 : 64;
  static constexpr int BLOCK_K = D >= 128 ? 32 : 64;
};

template <int D, int TPR, int ROWS, int BLOCK_K>
__global__ void __launch_bounds__(ROWS * TPR)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
    qr[i] = row < n ? q[base + (size_t)row * D + s + TPR * i] : 0.f;
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
      ks[j][d] = col < n ? k[off] : 0.f;
      vs[j][d] = col < n ? v[off] : 0.f;
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
    for (int i = 0; i < DPT; ++i) o[base + (size_t)row * D + s + TPR * i] = acc[i] * inv;
    if (s == 0) lse[(size_t)blockIdx.y * n + row] = m * LN2 + logf(l_safe);
  }
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v, void* o, void* lse,
                          int bh, int n, int causal, float sm_scale, cudaStream_t stream) {
  using Tl = Tiles<D>;
  auto kernel = flash_fwd_kernel<D, Tl::TPR, Tl::ROWS, Tl::BLOCK_K>;
  const int smem = 2 * Tl::BLOCK_K * D * (int)sizeof(float);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + Tl::ROWS - 1) / Tl::ROWS, bh);
  kernel<<<grid, Tl::ROWS * Tl::TPR, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), n, sm_scale * LOG2E, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 route

template <int D>
__global__ void __launch_bounds__(flash_mma::THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, float scale_log2, int causal) {
  using namespace flash_mma;
  using L = Layout<D>;
  constexpr int KSTEPS = L::KSTEPS, NTILES = L::NTILES;
  constexpr int KEY_TILES = TILE / 8;  // n8 score tiles per K tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q tile, then two stages of K and V tiles: [Q][K0][V0][K1][V1]
  const uint32_t qs = smem_addr(smem_raw);
  const uint32_t kv0 = qs + L::TILE_BYTES;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const bf16 *kg = k + base, *vg = v + base;
  const Stager<D> stage_tile(threadIdx.x);
  const Lanes<D> lanes(lane);
  // the two query rows of this thread's C fragments
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const int k_end = causal ? min(n, q0 + TILE) : n;
  const int tiles = (k_end + TILE - 1) / TILE;
  stage_tile(qs, q + base, q0, n);
  stage_tile(kv0, kg, 0, n);
  stage_tile(kv0 + L::TILE_BYTES, vg, 0, n);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  // O's accumulator; at D <= 32 (few n8 tiles, so long chains of dependent
  // mma per tile) the hi and lo products of P V go to separate halves
  constexpr int HALVES = D <= 32 ? 2 : 1;
  float acc[HALVES][NTILES][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int dt = 0; dt < NTILES; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][dt][e] = 0.f;
  // per row: running max in log2 units, and this thread's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], qs + lanes.a + L::at(warp * 16, kk * 16));
    }

    // S = Q K^T for this warp's 16 rows x 64 keys, raw (unscaled) fp32
    float s[KEY_TILES][4];
#pragma unroll
    for (int j = 0; j < KEY_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KEY_TILES; j += 2)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + lanes.b_rows + L::at(j * 8, kk * 16));
        mma(s[j], qf[kk], b[0], b[1]);
        mma(s[j + 1], qf[kk], b[2], b[3]);
      }

    // masks: key columns >= n on the ragged tile, col > row on the diagonal
    const int k0 = t * TILE;
    if (k0 + TILE > n || (causal && k0 + TILE > q0)) {
#pragma unroll
      for (int j = 0; j < KEY_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * c + (e & 1);
          if (col >= n || (causal && col > rows[e / 2])) s[j][e] = -INFINITY;
        }
    }

    // online softmax: new row max (quad shuffles), rescale, P = 2^(s*c - m)
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = tile_max<KEY_TILES>(s, r);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      // a row with no live key so far keeps acc = l = 0 instead of NaN
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_approx(m[r] - m_use[r]);
      l[r] *= alpha;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int dt = 0; dt < NTILES; ++dt) {
          acc[h][dt][2 * r] *= alpha;
          acc[h][dt][2 * r + 1] *= alpha;
        }
      m[r] = m_new;
    }

    // P as bf16 hi + lo A fragments: n8 tiles 2kk and 2kk+1 are k16 step kk
    uint32_t p_hi[KEY_TILES / 2][4], p_lo[KEY_TILES / 2][4];
#pragma unroll
    for (int j = 0; j < KEY_TILES; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2_approx(fmaf(s[j][e], scale_log2, -m_use[e / 2]));
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      const int kk = j / 2, h = (j % 2) * 2;
      split(p[0], p[1], p_hi[kk][h], p_lo[kk][h]);
      split(p[2], p[3], p_hi[kk][h + 1], p_lo[kk][h + 1]);
    }

    // O += P V, V read transposed from its [key][d] tile
#pragma unroll
    for (int kk = 0; kk < KEY_TILES / 2; ++kk)
#pragma unroll
      for (int dt = 0; dt < NTILES; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + lanes.b_trans + L::at(kk * 16, dt * 8));
        mma(acc[0][dt], p_hi[kk], b[0], b[1]);
        mma(acc[HALVES - 1][dt], p_lo[kk], b[0], b[1]);
        mma(acc[0][dt + 1], p_hi[kk], b[2], b[3]);
        mma(acc[HALVES - 1][dt + 1], p_lo[kk], b[2], b[3]);
      }
    __syncthreads();  // this stage is consumed before the next prefetch refills it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = rows[r];
    if (row < n) {
      const float l_safe = fmaxf(sum, 1e-30f);
      const float inv = 1.f / l_safe;
      bf16* orow = o + base + (size_t)row * D + 2 * c;
#pragma unroll
      for (int dt = 0; dt < NTILES; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(total(acc, dt, 2 * r) * inv, total(acc, dt, 2 * r + 1) * inv);
      if (c == 0) lse[(size_t)blockIdx.y * n + row] = m[r] * LN2 + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int n, int causal, float sm_scale, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<D>;
  // Q tile plus two stages of K and V tiles
  const int smem = 5 * flash_mma::Layout<D>::TILE_BYTES;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + flash_mma::TILE - 1) / flash_mma::TILE, bh);
  kernel<<<grid, flash_mma::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, sm_scale * LOG2E, causal);
  return cudaGetLastError();
}

template <bool MMA>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int n, int d, int causal, float sm_scale, cudaStream_t stream) {
#define JEN1_FWD_CASE(D)                                                            \
  case D:                                                                           \
    return MMA ? launch_mma<D>(q, k, v, o, lse, bh, n, causal, sm_scale, stream)    \
               : launch_scalar<D>(q, k, v, o, lse, bh, n, causal, sm_scale, stream);
  switch (d) {
    JEN1_FWD_CASE(16)
    JEN1_FWD_CASE(32)
    JEN1_FWD_CASE(64)
    JEN1_FWD_CASE(128)
    JEN1_FWD_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef JEN1_FWD_CASE
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronise. dtype: 0 = float32 (scalar route), 1 = bfloat16
// (tensor-core route; every pointer 16-byte aligned). sm_scale multiplies
// the logits (D^-1/2 of the head dim before any padding).
extern "C" int jen1_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int bh, int n, int d,
                                        int dtype, int causal, float sm_scale,
                                        void* stream) {
  if (bh < 1 || bh > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<false>(q, k, v, o, lse, bh, n, d, causal, sm_scale, st);
  if (dtype == 1)
    return (int)dispatch_d<true>(q, k, v, o, lse, bh, n, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
