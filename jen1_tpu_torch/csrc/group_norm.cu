// Channels-last GroupNorm with an optional FiLM and an optional SiLU for
// Hopper (sm_90a): K5.
//
// Replaces no TPU kernel. The JAX package's GroupNorm
// (jen1_tpu/ops/norm.py:14-39) and the conv block's FiLM and SiLU
// (jen1_tpu/models/blocks.py:44-52) are plain jnp, which XLA fuses into the
// neighbouring work in the (B, L, C) layout. PyTorch's CUDA GroupNorm has
// no channels-last form: it makes its input (B, C, L)-contiguous, takes one
// block per (example, group) row for its moments, and runs the
// normalisation, the fp32 casts around it, the FiLM and the SiLU as
// separate kernels on transposed views; the conv after it then gets a
// (B, C, L) tensor and cuDNN transposes it back. This kernel reads and
// writes (B, L, C) and does all of it in one pass over the data (two at
// long rows), so the conv block stays channels-last from end to end.
//
// What it computes (ops/norm.py::group_norm_act_plain is its plain
// version, and it rounds where that rounds):
//   y = T(x * a[c] + b[c]), a = rstd[g] * gamma[c], b = beta[c] - a * mean[g]
//   with FiLM:  y = T(T(y * T(scale[c] + 1)) + shift[c])
//   with SiLU:  y = T(y / (1 + exp(-y)))
// where T() rounds to x's dtype (bf16 or fp32) and every product and sum
// is one fp32 operation, never fused into an FMA, as PyTorch's separate
// elementwise kernels do them. mean and rstd = rsqrt(var + eps) (biased
// variance) are taken in fp32 over the example's L rows and the group's
// C / G channels: each thread keeps Welford moments of its channels over
// its rows, the threads of one channel are merged by Chan's formula, and a
// group's channels (equal counts) by the exact merge of means and centred
// sums of squares; or, where a block holds a group's values in registers,
// two passes: the mean, then the sum of squared deviations from it. No sum
// of squares of raw values is formed.
//
// Layout: x (B, L, C) with its (L, C) dense and any batch stride; out
// (B, L, C) contiguous; gamma, beta (C,) fp32; scale, shift rows (C,) of
// x's dtype at their own batch strides, or null; partial (B, splits, G, 3)
// fp32 scratch (count, mean, centred sum of squares of a block's rows) of
// the two-launch shape.
//
// Bound. Normalisation does about ten operations per element, far below the
// card's 295 operations per byte: bytes bound it, one read and one write of
// x, and at the UNet's deep levels (a few frames) the launch itself. So:
//   * Loads and stores of 16 bytes a thread along C (8 bf16 or 4 fp32),
//     neighbouring threads on neighbouring addresses, all of a thread's
//     loads in flight before the arithmetic that reads them; scalar
//     accesses where C or an address does not allow 16 bytes (C = 257 at
//     the UNet's input).
//   * Two launch shapes, which the wrapper picks from B, L, C and the groups.
//     One launch (most of the UNet's 125 calls a forward): each block takes
//     one example's rows of a slice of whole groups (the groups split the
//     channels so that the grid fills the SMs; a slice is at least 32 bytes
//     of a row) and holds them in registers, at most RES rows a thread: the
//     group sums, the mean, the centred sums of squares and the output from
//     one read of x. gamma, beta and the FiLM rows are loaded before x, so
//     their latency hides behind it.
//   * Two launches (long rows: 4500 frames at level 0): each example's rows
//     are split over `splits` blocks so that the grid fills the 132 SMs
//     (RowwiseMoments gets 8 or 64 rows there). A block covers `ct` channel
//     vectors by `r` rows (more than 512 vectors a row in several passes).
//     A statistics launch writes each block's group partials (Welford per
//     thread, Chan across them); the apply launch merges its example's
//     partials (Chan) and writes its rows, its second read of x from L2
//     (9.2 MB at level 0, in a 50 MB L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// The grid and blocks are planned by ops/norm.py::launch_plan, whose
// RESIDENT_ROWS and MAX_THREADS are RES and MAX_THREADS here; launch()
// only checks the plan.
constexpr int UNROLL = 4;        // loads in flight per thread
constexpr int MAX_THREADS = 512;  // 128 registers a thread
constexpr int RES = 8;  // rows a thread holds in registers (one launch)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v stored in T and read back: where the plain version keeps a T tensor
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* x;
  void* out;
  long long x_bstride;  // elements between examples of x
  const float* gamma;
  const float* beta;
  const void* scale;  // FiLM rows, or null
  const void* shift;
  long long scale_bstride, shift_bstride;
  float* partial;  // (B, splits, G, 3), two launches
  int length, channels, groups;
  int rows;    // rows of an example per block, two launches
  int splits;  // blocks per example along L, two launches
  int silu;
  float eps;
  int slices;  // blocks per example along C, one launch
  int ct, r;  // channel vectors and rows a block covers at once
};

// The output of one element from x: the normalisation (mul, add), the FiLM
// (s1 = T(scale + 1), s2 = shift; 1 and 0 without it) and the SiLU, with the
// plain version's roundings.
template <typename T>
__device__ __forceinline__ T film_act(float x, float mul, float add, bool film, float s1,
                                      float s2, bool silu) {
  float y = round_t<T>(fmaf(x, mul, add));
  if (film) {
    y = round_t<T>(__fmul_rn(y, s1));
    y = round_t<T>(__fadd_rn(y, s2));
  }
  if (silu) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
  return from_f<T>(y);
}

// ch_mean[c], ch_m2[c]: channel c's mean and centred sum of squares over
// the rows [row0, row1) of the example at xb. Every thread of the block
// calls it; it ends with the block synchronised.
template <typename T, int VEC>
__device__ void channel_moments(const Args& a, const T* xb, int row0, int row1, float* ch_mean,
                                float* ch_m2, float* red) {
  const int cv = a.channels / VEC;
  const int tid = threadIdx.x, j = tid % a.ct, r = tid / a.ct;
  const int step = a.r * UNROLL;
  float* red_mean = red;
  float* red_m2 = red + blockDim.x * VEC;
  float* red_n = red_m2 + blockDim.x * VEC;
  for (int cb = 0; cb < cv; cb += a.ct) {
    const int col = cb + j;
    float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
    if (r < a.r && col < cv) {
      const T* p = xb + (size_t)col * VEC;
      for (int l = row0 + r; l < row1; l += step) {
        Pack<T, VEC> v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (l + u * a.r < row1)
            v[u] = *reinterpret_cast<const Pack<T, VEC>*>(p + (size_t)(l + u * a.r) * a.channels);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (l + u * a.r < row1) {
            n += 1.f;
            const float inv = 1.f / n;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float xv = to_f(v[u].v[k]);
              const float d = xv - mean[k];
              mean[k] += d * inv;
              m2[k] += d * (xv - mean[k]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      red_mean[tid * VEC + k] = mean[k];
      red_m2[tid * VEC + k] = m2[k];
    }
    if (j == 0 && r < a.r) red_n[r] = n;
    __syncthreads();
    // the a.r row lanes of each channel of this pass, merged in order
    const int width = a.ct * VEC;
    for (int c = tid; c < width; c += blockDim.x) {
      const int ch = cb * VEC + c;
      if (ch >= a.channels) break;
      float cnt = 0.f, mu = 0.f, s = 0.f;
      for (int q = 0; q < a.r; ++q) {
        const float nb = red_n[q];
        if (nb == 0.f) continue;
        const float mb = red_mean[q * width + c], sb = red_m2[q * width + c];
        const float tot = cnt + nb, d = mb - mu;
        mu += d * (nb / tot);
        s += sb + d * d * (cnt * nb / tot);
        cnt = tot;
      }
      ch_mean[ch] = mu;
      ch_m2[ch] = s;
    }
    __syncthreads();
  }
}

// For each group g, emit(g, mean, M2) over `n` rows of its channels (one
// warp a group; lane 0 emits). The channel moments all count n rows, so the
// group's mean is the mean of theirs and its M2 adds n (mean_c - mean)^2.
template <typename Emit>
__device__ void group_moments(const Args& a, float n, const float* ch_mean, const float* ch_m2,
                              Emit emit) {
  const int cg = a.channels / a.groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g = warp; g < a.groups; g += warps) {
    const float* gm = ch_mean + (size_t)g * cg;
    const float* gs = ch_m2 + (size_t)g * cg;
    float s = 0.f;
    for (int c = lane; c < cg; c += 32) s += gm[c];
    const float mean = warp_sum(s) / cg;
    float q = 0.f;
    for (int c = lane; c < cg; c += 32) {
      const float d = gm[c] - mean;
      q += gs[c] + n * d * d;
    }
    q = warp_sum(q);
    if (lane == 0) emit(g, mean, q);
  }
}

__device__ __forceinline__ float inv_std(float m2, float count, float eps) {
  return rsqrtf(fmaxf(m2 / count, 0.f) + eps);
}

// out rows [row0, row1) of example b from the group statistics.
template <typename T, int VEC>
__device__ void apply_rows(const Args& a, int b, const T* xb, int row0, int row1,
                           const float* g_mean, const float* g_rstd) {
  const int cv = a.channels / VEC, cg = a.channels / a.groups;
  const int tid = threadIdx.x, j = tid % a.ct, r = tid / a.ct;
  if (r >= a.r) return;
  T* ob = static_cast<T*>(a.out) + (size_t)b * a.length * a.channels;
  const T* sc = a.scale ? static_cast<const T*>(a.scale) + b * a.scale_bstride : nullptr;
  const T* sh = a.shift ? static_cast<const T*>(a.shift) + b * a.shift_bstride : nullptr;
  const int step = a.r * UNROLL;
  for (int col = j; col < cv; col += a.ct) {
    float mul[VEC], add[VEC], s1[VEC], s2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = col * VEC + k, g = c / cg;
      mul[k] = __fmul_rn(g_rstd[g], a.gamma[c]);
      add[k] = fmaf(-mul[k], g_mean[g], a.beta[c]);
      s1[k] = sc ? round_t<T>(__fadd_rn(to_f(sc[c]), 1.f)) : 1.f;
      s2[k] = sh ? to_f(sh[c]) : 0.f;
    }
    const T* p = xb + (size_t)col * VEC;
    T* o = ob + (size_t)col * VEC;
    for (int l = row0 + r; l < row1; l += step) {
      Pack<T, VEC> v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (l + u * a.r < row1)
          v[u] = *reinterpret_cast<const Pack<T, VEC>*>(p + (size_t)(l + u * a.r) * a.channels);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (l + u * a.r >= row1) continue;
        Pack<T, VEC> w;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          w.v[k] = film_act<T>(to_f(v[u].v[k]), mul[k], add[k], sc != nullptr, s1[k], s2[k],
                               a.silu);
        *reinterpret_cast<Pack<T, VEC>*>(o + (size_t)(l + u * a.r) * a.channels) = w;
      }
    }
  }
}

// Dynamic shared memory of the statistics: channel moments, the row lanes'
// moments of one pass, their counts.
template <int VEC>
size_t stats_floats(int channels, int threads, int r) {
  return 2 * (size_t)channels + 2 * (size_t)threads * VEC + r;
}

// One launch: block (z, b) holds example b's rows of channel slice z (whole
// groups) in registers, thread (row lane rl, vector column col) rows rl,
// rl + r, ... (at most RES), and writes their output. red[] holds each
// thread's partial sum; one warp a group adds its threads'.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) gn_resident_kernel(Args a) {
  extern __shared__ float smem[];
  const int z = blockIdx.x, b = blockIdx.y;
  const int cw = a.channels / a.slices, cg = a.channels / a.groups;
  const int cpg = cg / VEC, gl = cw / cg;  // vector columns a group; groups a block
  float* red = smem;
  float* g_mean = smem + blockDim.x;
  float* g_rstd = g_mean + gl;
  const int tid = threadIdx.x, col = tid % a.ct, rl = tid / a.ct;
  const bool active = rl < a.r;
  const int c = z * cw + col * VEC;  // this thread's first channel
  const T* sc = a.scale ? static_cast<const T*>(a.scale) + b * a.scale_bstride : nullptr;
  const T* sh = a.shift ? static_cast<const T*>(a.shift) + b * a.shift_bstride : nullptr;
  float gamma[VEC], beta[VEC], s1[VEC], s2[VEC];
  Pack<T, VEC> v[RES];
  float s = 0.f;
  if (active) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      gamma[k] = a.gamma[c + k];
      beta[k] = a.beta[c + k];
      s1[k] = sc ? round_t<T>(__fadd_rn(to_f(sc[c + k]), 1.f)) : 1.f;
      s2[k] = sh ? to_f(sh[c + k]) : 0.f;
    }
    const T* p = static_cast<const T*>(a.x) + b * a.x_bstride + c;
#pragma unroll
    for (int i = 0; i < RES; ++i)
      if (rl + i * a.r < a.length)
        v[i] = *reinterpret_cast<const Pack<T, VEC>*>(p + (size_t)(rl + i * a.r) * a.channels);
#pragma unroll
    for (int i = 0; i < RES; ++i)
      if (rl + i * a.r < a.length)
#pragma unroll
        for (int k = 0; k < VEC; ++k) s += to_f(v[i].v[k]);
  }
  const float count = (float)a.length * cg;
  const int warp = tid / 32, lane = tid % 32, warps = blockDim.x / 32;
  // per local group, the sum of red[] over its threads, to out[g] = f(sum)
  auto group_sums = [&](float* out, auto f) {
    __syncthreads();
    const int n = cpg * a.r;
    for (int g = warp; g < gl; g += warps) {
      float t = 0.f;
      for (int e = lane; e < n; e += 32) t += red[(e / cpg) * a.ct + g * cpg + e % cpg];
      t = warp_sum(t);
      if (lane == 0) out[g] = f(t);
    }
    __syncthreads();
  };
  red[tid] = s;
  group_sums(g_mean, [&](float t) { return t / count; });
  const int g = col / cpg;
  float q = 0.f;
  if (active) {
    const float mean = g_mean[g];
#pragma unroll
    for (int i = 0; i < RES; ++i)
      if (rl + i * a.r < a.length)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float d = to_f(v[i].v[k]) - mean;
          q += d * d;
        }
  }
  red[tid] = q;
  group_sums(g_rstd, [&](float t) { return inv_std(t, count, a.eps); });
  if (!active) return;
  float mul[VEC], add[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mul[k] = __fmul_rn(g_rstd[g], gamma[k]);
    add[k] = fmaf(-mul[k], g_mean[g], beta[k]);
  }
  T* o = static_cast<T*>(a.out) + ((size_t)b * a.length) * a.channels + c;
#pragma unroll
  for (int i = 0; i < RES; ++i) {
    if (rl + i * a.r >= a.length) continue;
    Pack<T, VEC> w;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      w.v[k] = film_act<T>(to_f(v[i].v[k]), mul[k], add[k], sc != nullptr, s1[k], s2[k],
                           a.silu);
    *reinterpret_cast<Pack<T, VEC>*>(o + (size_t)(rl + i * a.r) * a.channels) = w;
  }
}

// Long rows, first launch: the group partials of block (split, b)'s rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) gn_stats_kernel(Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, b = blockIdx.y;
  const int row0 = s * a.rows, row1 = min(a.length, row0 + a.rows);
  const T* xb = static_cast<const T*>(a.x) + b * a.x_bstride;
  float* ch_mean = smem;
  float* ch_m2 = smem + a.channels;
  channel_moments<T, VEC>(a, xb, row0, row1, ch_mean, ch_m2, smem + 2 * a.channels);
  const float n = (float)(row1 - row0), count = n * (a.channels / a.groups);
  float* part = a.partial + ((size_t)b * a.splits + s) * a.groups * 3;
  group_moments(a, n, ch_mean, ch_m2, [&](int g, float mean, float m2) {
    part[g * 3 + 0] = count;
    part[g * 3 + 1] = mean;
    part[g * 3 + 2] = m2;
  });
}

// Long rows, second launch: merge example b's partials (one warp a group,
// lanes over the splits: the count-weighted mean, then the centred sums)
// and write block (split, b)'s rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) gn_apply_kernel(Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, b = blockIdx.y;
  float* g_mean = smem;
  float* g_rstd = smem + a.groups;
  const float* part = a.partial + (size_t)b * a.splits * a.groups * 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int g = warp; g < a.groups; g += warps) {
    float cnt = 0.f, wsum = 0.f;
    for (int i = lane; i < a.splits; i += 32) {
      const float* p = part + ((size_t)i * a.groups + g) * 3;
      cnt += p[0];
      wsum += p[0] * p[1];
    }
    cnt = warp_sum(cnt);
    const float mean = warp_sum(wsum) / cnt;
    float q = 0.f;
    for (int i = lane; i < a.splits; i += 32) {
      const float* p = part + ((size_t)i * a.groups + g) * 3;
      const float d = p[1] - mean;
      q += p[2] + p[0] * d * d;
    }
    q = warp_sum(q);
    if (lane == 0) {
      g_mean[g] = mean;
      g_rstd[g] = inv_std(q, cnt, a.eps);
    }
  }
  __syncthreads();
  const int row0 = s * a.rows, row1 = min(a.length, row0 + a.rows);
  apply_rows<T, VEC>(a, b, static_cast<const T*>(a.x) + b * a.x_bstride, row0, row1, g_mean,
                     g_rstd);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int VEC>
cudaError_t launch(Args a, int batch, bool resident, cudaStream_t st) {
  cudaError_t err;
  if (a.ct < 1 || a.r < 1 || (long long)a.ct * a.r > MAX_THREADS) return cudaErrorInvalidValue;
  const int threads = (a.ct * a.r + 31) / 32 * 32;
  if (resident) {
    // a thread for each vector of a slice's row, RES rows a thread
    if (a.ct * VEC * a.slices != a.channels || (a.channels / a.groups) % VEC != 0 ||
        a.length > a.r * RES)
      return cudaErrorInvalidValue;
    const size_t smem = (threads + 2 * (size_t)(a.groups / a.slices)) * sizeof(float);
    gn_resident_kernel<T, VEC><<<dim3(a.slices, batch), threads, smem, st>>>(a);
    return cudaGetLastError();
  }
  if (a.ct > a.channels / VEC) return cudaErrorInvalidValue;
  const size_t stats = stats_floats<VEC>(a.channels, threads, a.r) * sizeof(float);
  const size_t group = 2 * (size_t)a.groups * sizeof(float);
  if (stats > 227 * 1024 || group > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(a.splits, batch);
  if ((err = allow_smem(gn_stats_kernel<T, VEC>, stats)) != cudaSuccess) return err;
  gn_stats_kernel<T, VEC><<<grid, threads, stats, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(gn_apply_kernel<T, VEC>, group)) != cudaSuccess) return err;
  gn_apply_kernel<T, VEC><<<grid, threads, group, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype 0: fp32, 1: bf16. vec 1 (scalar accesses) or 16 bytes' worth
// (4 fp32, 8 bf16), which needs x, out and every row of both on 16 bytes.
// resident: the one-launch shape over `slices` channel slices (whole
// groups) an example; else the two-launch shape over `splits` blocks of
// `rows` rows an example, with partial holding batch * splits * groups * 3
// floats. Each block runs `ct` channel vectors by `r` row lanes at once.
// Returns a CUDA error code, 0 when the launches were accepted.
extern "C" int jen1_group_norm(const void* x, void* out, long long x_bstride, const void* gamma,
                               const void* beta, const void* scale, const void* shift,
                               long long scale_bstride, long long shift_bstride, void* partial,
                               int batch, int length, int channels, int groups, int resident,
                               int slices, int rows, int splits, int ct, int r, int dtype,
                               int vec, int silu, float eps, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (batch < 1 || batch > 65535 || length < 1 || channels < 1 || groups < 1 ||
      channels % groups != 0 || (scale == nullptr) != (shift == nullptr) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (resident ? (slices < 1 || slices > 65535 || groups % slices != 0)
               : (splits < 1 || splits > 65535 || rows < 1 || (long long)splits * rows < length ||
                  (long long)(splits - 1) * rows >= length || partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec * elem != 16 || channels % vec != 0 || !aligned16(x) || !aligned16(out) ||
                   (x_bstride * elem) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  Args a{x, out, x_bstride, static_cast<const float*>(gamma), static_cast<const float*>(beta),
         scale, shift, scale_bstride, shift_bstride, static_cast<float*>(partial), length,
         channels, groups, rows, splits, silu, eps, resident ? slices : 1, ct, r};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = resident != 0;
  if (dtype == 0)
    return (int)(vec == 1 ? launch<float, 1>(a, batch, res, st)
                          : launch<float, 4>(a, batch, res, st));
  return (int)(vec == 1 ? launch<bf16, 1>(a, batch, res, st) : launch<bf16, 8>(a, batch, res, st));
}
