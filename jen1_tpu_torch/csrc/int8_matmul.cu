// int8 weight-only matrix product for Hopper (sm_90a): out = (bf16(x) @ w8)
// * scale, the sum in fp32 and the per-column scale applied after it.
//
// Replaces the TPU kernel `_kernel` driven by `matmul_int8w`
// (jen1_tpu/ops/int8_matmul.py:48-139). What it computes is the same:
// acc[m, n] = sum_k bf16(x[m, k]) * float(w8[k, n]) in fp32, then
// out[m, n] = acc[m, n] * scale[n], fp32. An fp32 x is rounded to bf16 on
// load (round to nearest even, as `x.astype(bfloat16)`). An int8 value is
// exact in bf16, so bf16 x bf16 products into an fp32 accumulator
// (mma.sync.m16n8k16) are exactly the JAX kernel's products; only the order
// of the sum differs. What it does not carry over: the TPU kernel keeps the
// whole K extent of x in VMEM and walks K as a sequential grid axis with the
// sum in scratch. Blocks on Hopper run in no order, so K is split across the
// blocks of one thread-block cluster instead, and the cluster sums its
// partials through distributed shared memory in rank order inside the one
// launch: no float atomics, no second kernel, no workspace, and the same
// result on every run.
//
// Layout: x (M, K) row-major bf16 or fp32, w8 (K, N) row-major int8 (the
// JAX layout), scale (N,) fp32, out (M, N) fp32; any M, K, N >= 1.
//
// Bound. At the flagship shapes (M = 6-72 rows of a CFG-doubled batch,
// K = 1024-6144, N = 512-1024) the int8 weights are 1-6 MB per product and
// x at most 1.2 MB: the weight bytes bound it (0.74 us mean over the 52
// products of a UNet forward at 3.35 TB/s), and the work per byte (2 M
// operations) is far below the tensor cores' rate. The design:
//   * Grid (ceil(N/64), ceil(M/BM), splits), clusters of (1, 1, splits),
//     splits <= 8 (the portable cluster size), chosen by the wrapper for
//     >= 128 blocks where 8 splits allow it (all flagship shapes but the
//     18-row one, which gets 64). A block of four warps owns 64 columns, 16
//     a warp, BM = 8, 16, 24 or 32 rows (M > 32 tiles over grid.y) and
//     `chunk` rows of K.
//   * The block's weight rows stream through a ring of STAGES = 8 slots of
//     128 x 64 bytes by cp.async, 16 bytes a thread, four neighbouring lanes
//     on one row: 7 tiles are in flight before the first product, at the
//     flagship shapes all or most of a block's 8-48 KB slice. Shared memory
//     is sized to the block's K range, so small blocks pack several to an
//     SM and a cluster finds room. Rows are padded by 16 bytes, so the
//     ldmatrix phases below hit distinct banks.
//   * Swap-AB on tensor cores: out^T (N x M) = w8^T x^T. The weights fill the
//     16-row A side and x the n8 B side, so M is padded to 8 and not to 16.
//     One ldmatrix.x4.trans of an int8 tile [k][n] yields, per thread, the
//     bytes (k = 2c, 2c+1) x (n = 2g, 2g+1) of four 8-row k blocks; A row g
//     takes column 2g and row g + 8 column 2g + 1 (the order of A's rows is
//     free, the epilogue follows it). int8 -> bf16 is exact by a magic
//     exponent: byte ^ 0x80 = x + 128 goes under the fp32 exponent of 2^23
//     (prmt), one FADD of -(2^23 + 128) leaves x, and the upper 16 bits of
//     that fp32 are its bf16 (|x| <= 128 has at most 8 significant bits).
//   * x is staged as bf16 in shared memory in passes of up to 24 / MT k
//     tiles; one pass covers a block's whole K range at every flagship
//     shape. A bf16 x with 16-byte rows (the flagship's im2col) goes by
//     cp.async in the group of the first weight tile; any other x (fp32,
//     converted on the way, or any alignment) by ordinary loads. B fragments
//     come from it by ldmatrix.
// Alternatives measured on the card and found slower on the flagship mix
// (PERF.md): 32-column blocks (more blocks, x read twice as often), 12- and
// 16-slot rings, a bulk copy (TMA) per weight row or a 2D TMA box per tile
// instead of cp.async, and eight warps per block.
// Weights stream by cp.async only where every row starts on 16 bytes (w8 is
// 16-byte aligned, which the wrapper checks, and N % 16 == 0); other N take
// the same ring with ordinary byte loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using flash_mma::bf16;
using flash_mma::cp_async_16;
using flash_mma::cp_async_commit;
using flash_mma::cp_async_wait;
using flash_mma::ldmatrix_x4;
using flash_mma::ldmatrix_x4_trans;
using flash_mma::mma;
using flash_mma::smem_addr;

constexpr int BN = 64;                // output columns per block, 16 per warp
constexpr int BK = 128;               // rows of K per ring stage
constexpr int STAGES = 8;             // ring depth
constexpr int LDW = BN + 16;          // bytes per staged weight row
constexpr int STAGE_BYTES = BK * LDW;
constexpr int THREADS = 128;
constexpr int MAX_SPLITS = 8;

// Shared memory of a block of BM rows whose K range spans `ctiles` tiles:
// ring slots and x pass (at most 24 * 8 / BM tiles, ~48 KB) both sized to
// what the range needs, so that small blocks pack several to an SM and a
// cluster finds room. The partial sums (BM x BN fp32) take less than the
// x pass alone.
struct Smem {
  int slots, xtiles, ldx, bytes;
  __host__ __device__ Smem(int ctiles, int bm)
      : slots(ctiles < STAGES ? ctiles : STAGES),
        xtiles(ctiles < 24 * 8 / bm ? ctiles : 24 * 8 / bm),
        ldx(xtiles * BK + 8),  // bf16 per x row, 16 bytes of padding
        bytes(slots * STAGE_BYTES + bm * ldx * 2) {}
};

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }

// Two int8 (bytes lo and hi of u, which holds the bytes ^ 0x80) as a bf16
// pair, lower k in the low half.
__device__ __forceinline__ uint32_t int8_pair_to_bf16(uint32_t u, int lo, int hi) {
  const float magic = 8388736.f;  // 2^23 + 128
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | lo)) - magic;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | hi)) - magic;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS)
int8w_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out, int m, int k,
                    int n, int chunk) {
  constexpr int BM = 8 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [ring slots of weight tiles][x pass]; the partial sums reuse both
  const uint32_t ring = smem_addr(smem_raw);
  const Smem sm(chunk / BK, BM);
  const int xtiles = sm.xtiles, xk = xtiles * BK, ldx = sm.ldx;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + sm.slots * STAGE_BYTES);
  const uint32_t xs_addr = ring + sm.slots * STAGE_BYTES;
  float* part = reinterpret_cast<float*>(smem_raw);  // [BM][BN]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k, k_begin + chunk);
  const int tiles = (k_end - k_begin + BK - 1) / BK;
  const bool async_w = n % 16 == 0;  // the wrapper checked w's alignment

  // weight tile t into ring slot t % STAGES. cp.async: 16-byte chunk
  // tid + i THREADS, so four neighbouring lanes read one row's 64 bytes;
  // ordinary loads: thread tid owns row tid
  auto load_w = [&](int t) {
    if (async_w) {
      const int row = tid / 4, col = 16 * (tid % 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + i * (THREADS / 4), gk = k_begin + t * BK + r;
        const bool live = gk < k_end && n0 + col < n;
        cp_async_16(ring + (t % STAGES) * STAGE_BYTES + r * LDW + col,
                    live ? w + (size_t)gk * n + n0 + col : w, live ? 16 : 0);
      }
    } else {
      const int gk = k_begin + t * BK + tid;
      const int8_t* src = w + (size_t)gk * n + n0;
      uint32_t v[BN / 4];
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = 4 * j + b;
          const uint32_t byte =
              gk < k_end && n0 + col < n ? (uint32_t)(uint8_t)src[col] : 0u;
          word |= byte << (8 * b);
        }
        v[j] = word;
      }
      uint4* d = reinterpret_cast<uint4*>(smem_raw + (t % STAGES) * STAGE_BYTES + tid * LDW);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        d[j] = make_uint4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  };

  // x rows m0.., the columns of pass p that its tiles read, as bf16; zero
  // outside (M, [k_begin, k_end)). An aligned bf16 x goes by cp.async (the
  // caller commits), anything else by ordinary loads.
  const bool async_x = std::is_same<T, bf16>::value && k % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto stage_x = [&](int p) {
    const int kp = k_begin + p * xk;
    const int width = min(xk, k_end - kp);
    const int rows = min(BM, m - m0);
    const int chunks = (width + BK - 1) / BK * (BK / 8);  // 8-column chunks per row
#pragma unroll 4
    for (int idx = tid; idx < BM * chunks; idx += THREADS) {
      const int r = idx / chunks, col = (idx % chunks) * 8;
      const T* src = x + (size_t)(m0 + r) * k + kp + col;
      bf16* dst = xs + r * ldx + col;
      if (async_x) {
        const bool live = r < rows && col < width;
        cp_async_16(smem_addr(dst), live ? static_cast<const void*>(src) : x, live ? 16 : 0);
      } else {
        __align__(16) bf16 vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          vals[j] = r < rows && col + j < width ? to_bf16(src[j]) : to_bf16(0.f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
      }
    }
  };

  // the ring's first STAGES - 1 tiles, x's first pass in the group of tile 0
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load_w(s);
    if (s == 0 && async_x) stage_x(0);
    cp_async_commit();
  }
  if (!async_x) stage_x(0);

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  // per-lane ldmatrix offsets: weight row kb + lane of this warp's 16
  // columns; x row lane % 8 at k column 8 (lane / 8)
  const uint32_t w_lane = lane * LDW + 16 * warp;
  const uint32_t x_lane = ((lane % 8) * ldx + 8 * (lane / 8)) * 2;

  for (int t = 0; t < tiles; ++t) {
    if (t > 0 && t % xtiles == 0) {
      __syncthreads();  // every warp is done with the previous pass
      stage_x(t / xtiles);
      cp_async_commit();
      cp_async_wait<0>();  // drains the ring once per pass
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < tiles) load_w(t + STAGES - 1);  // the slot consumed at t - 1
    cp_async_commit();

    const uint32_t slot = ring + (t % STAGES) * STAGE_BYTES;
    const int xcol = (t % xtiles) * BK;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {  // 32 rows: two k16 steps
      uint32_t r[4];
      ldmatrix_x4_trans(r, slot + kb * LDW + w_lane);
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t lo = r[2 * s] ^ 0x80808080u, hi = r[2 * s + 1] ^ 0x80808080u;
        a[s][0] = int8_pair_to_bf16(lo, 0, 2);  // column 2g, k 2c and 2c + 1
        a[s][1] = int8_pair_to_bf16(lo, 1, 3);  // column 2g + 1
        a[s][2] = int8_pair_to_bf16(hi, 0, 2);  // the same at k + 8
        a[s][3] = int8_pair_to_bf16(hi, 1, 3);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t b[4];
        ldmatrix_x4(b, xs_addr + x_lane + ((mt * 8) * ldx + xcol + kb) * 2);
        mma(acc[mt], a[0], b[0], b[1]);
        mma(acc[mt], a[1], b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // ring and x are free: they take the partial sums

  // c0, c1: column 2g, rows 2c, 2c + 1; c2, c3: column 2g + 1
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mt * 8 + 2 * c + (e & 1), col = 16 * warp + 2 * g + (e >> 1);
      part[row * BN + col] = acc[mt][e];
    }

  // each rank of the cluster sums a slice of the block's outputs over the
  // ranks' partials in rank order, then applies the scale
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  constexpr int OUTS = BM * BN;
  const int per = (OUTS + splits - 1) / splits;
  const int end = min(OUTS, (rank + 1) * per);
  for (int i = rank * per + tid; i < end; i += THREADS) {
    const int row = m0 + i / BN, col = n0 + i % BN;
    if (row >= m || col >= n) continue;
    // all remote loads first, then the sum in rank order
    float parts[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) parts[r] = cluster.map_shared_rank(part, r)[i];
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) sum += parts[r];
    out[(size_t)row * n + col] = sum * scale[col];
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <typename T, int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int m, int k,
                   int n, int splits, int chunk, cudaStream_t stream) {
  auto kernel = int8w_matmul_kernel<T, MT>;
  const int smem = Smem(chunk / BK, 8 * MT).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid_y = (unsigned)((m + 8 * MT - 1) / (8 * MT));
  if (grid_y > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + BN - 1) / BN, grid_y, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const int8_t*>(w),
                           static_cast<const float*>(scale), static_cast<float*>(out), m, k, n,
                           chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_m(const void* x, const void* w, const void* scale, void* out, int m, int k,
                     int n, int splits, int chunk, cudaStream_t stream) {
  switch (m >= 32 ? 4 : (m + 7) / 8) {
    case 1: return launch<T, 1>(x, w, scale, out, m, k, n, splits, chunk, stream);
    case 2: return launch<T, 2>(x, w, scale, out, m, k, n, splits, chunk, stream);
    case 3: return launch<T, 3>(x, w, scale, out, m, k, n, splits, chunk, stream);
    default: return launch<T, 4>(x, w, scale, out, m, k, n, splits, chunk, stream);
  }
}

}  // namespace

// Launches on `stream` and returns the launch's error (0 on success); does
// not synchronise. dtype of x: 0 = float32, 1 = bfloat16. `splits` blocks of
// one cluster (1-8) share K, each `chunk` rows of it (a multiple of 128, with
// (splits - 1) * chunk < k <= splits * chunk). w must be 16-byte aligned.
extern "C" int jen1_int8w_matmul(const void* x, const void* w, const void* scale, void* out,
                                 int m, int k, int n, int dtype, int splits, int chunk,
                                 void* stream) {
  if (m < 1 || k < 1 || n < 1 || splits < 1 || splits > MAX_SPLITS || chunk < 1 ||
      chunk % BK != 0 || (long long)(splits - 1) * chunk >= k ||
      (long long)splits * chunk < k || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_m<float>(x, w, scale, out, m, k, n, splits, chunk, st);
  if (dtype == 1) return (int)launch_m<bf16>(x, w, scale, out, m, k, n, splits, chunk, st);
  return (int)cudaErrorInvalidValue;
}
