// Warp-level building blocks of the tensor-core flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): cp.async staging,
// ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 with fp32
// accumulation, and the bf16 hi + lo split of an fp32 operand.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and c = lane % 4:
//   A (16 x 16, row): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//                     a3 = (g+8, 2c+8..); two bf16 per register, low half
//                     the lower column.
//   B (16 x 8, col):  b0 = (rows 2c..2c+1, col g), b1 = (rows 2c+8.., col g).
//   C (16 x 8, fp32): c0, c1 = (g, 2c..2c+1), c2, c3 = (g+8, 2c..2c+1).
// So two n8 C tiles side by side hold exactly one k16 A operand: the C
// fragment of a product is the A fragment of the next with no shuffle.
//
// Shared-memory tiles are rows of D bf16 padded to D + 8 (16 bytes more):
// the eight 16-byte row segments one ldmatrix phase reads then fall in
// eight distinct groups of four banks for every D in 16..256.
//
// At head dim 16 the kernels run few products per score, so the rate at
// which each scheduler dispatches instructions, as much as the tensor cores
// or the ex2 unit, sets their pace (the SASS of a first version spent a
// large share of its loop recomputing staging and ldmatrix addresses).
// Hence every per-thread copy position and per-lane ldmatrix offset below
// is computed once per CTA, and a tile's loads differ from the next only by
// constants the compiler folds into the instructions.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 64;  // rows owned by a CTA, and rows per streamed tile

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // padded row, in bf16 elements
  static constexpr int TILE_BYTES = TILE * LD * 2;
  static constexpr int KSTEPS = D / 16;  // k16 steps over the head dim
  static constexpr int NTILES = D / 8;  // n8 tiles over the head dim

  // byte offset of element (row, col) of a tile
  __host__ __device__ static constexpr uint32_t at(int row, int col) {
    return (row * LD + col) * 2;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes = 0 nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of staging rows [r0, r0 + TILE) of a row-major (n, D)
// bf16 matrix into a [TILE][D + 8] shared tile, with THREADS threads of
// index `tid`: CPT 16-byte chunks in one column, ROW_STEP rows apart. Rows
// >= n are zero-filled by cp.async (their source address is clamped to the
// matrix start and never read).
template <int D>
struct Stager {
  static constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static constexpr int ROW_STEP = THREADS / CHUNKS;
  static constexpr int CPT = TILE * CHUNKS / THREADS;
  static_assert(CPT >= 1 && TILE * CHUNKS % THREADS == 0, "whole chunks per thread");
  int row, col;
  uint32_t dst;  // byte offset of (row, col) in a tile

  __device__ __forceinline__ explicit Stager(int tid)
      : row(tid / CHUNKS),
        col((tid % CHUNKS) * 8),
        dst(Layout<D>::at(tid / CHUNKS, (tid % CHUNKS) * 8)) {}

  __device__ __forceinline__ void operator()(uint32_t tile, const bf16* src, int r0,
                                             int n) const {
    const bf16* p = src + (size_t)(r0 + row) * D + col;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const bool live = r0 + row + j * ROW_STEP < n;
      cp_async_16(tile + dst + Layout<D>::at(j * ROW_STEP, 0),
                  live ? p + (size_t)j * ROW_STEP * D : src, live ? 16 : 0);
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Per-lane byte offsets of the three ldmatrix.x4 patterns into a tile; a
// load adds the tile's address and Layout::at of its first element.
template <int D>
struct Lanes {
  // A fragments of 16 rows, one k16 step: at (row0, 16 kk)
  uint32_t a;
  // B fragments of two n8 tiles for a product against the tile's rows
  // (B = tile^T, k over the head dim): {b0, b1} of rows n0..n0+7 and
  // {b2, b3} of n0+8..n0+15, at (n0, 16 kk)
  uint32_t b_rows;
  // B fragments for a product against the tile itself (B = tile, k over
  // its rows k0..k0+15), head dims d0..d0+7 and d0+8..d0+15: at (k0, d0)
  uint32_t b_trans;

  __device__ __forceinline__ explicit Lanes(int lane)
      : a(Layout<D>::at(lane % 16, (lane / 16) * 8)),
        b_rows(Layout<D>::at(lane % 8 + (lane / 16) * 8, ((lane / 8) % 2) * 8)),
        b_trans(Layout<D>::at(lane % 8 + ((lane / 8) % 2) * 8, (lane / 16) * 8)) {}
};

// c += a * b, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi and lo with hi + lo = x to 2^-16 of x: hi keeps
// the upper 16 bits of each fp32 (a truncation: one byte permute, no
// conversion), lo = x - hi is exact in fp32 (|lo| < 2^-7 |x|) and is
// rounded to bf16. Two bf16 products into one fp32 accumulator then stand
// for the product with the fp32 operand.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = bits(__floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xffff0000u),
                                  x1 - __uint_as_float(u1 & 0xffff0000u)));
}

// Max over this thread's two columns of row r (0: g, 1: g + 8) in N n8
// score tiles, as a tree rather than a dependent chain.
template <int N>
__device__ __forceinline__ float tile_max(const float (&s)[N][4], int r) {
  float m[N];
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int j = 0; j + w < N; j += 2 * w) m[j] = fmaxf(m[j], m[j + w]);
  return m[0];
}

// Element e of n8 tile dt of an accumulator kept in H halves, summed.
template <int H, int N>
__device__ __forceinline__ float total(const float (&acc)[H][N][4], int dt, int e) {
  float sum = acc[0][dt][e];
#pragma unroll
  for (int h = 1; h < H; ++h) sum += acc[h][dt][e];
  return sum;
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flash_mma
