// Building blocks of the port's tensor-core kernels for Hopper (sm_90a):
// warp-level bf16 products with f32 sums (mma.sync m16n8k16), operands
// moved from shared memory into registers by ldmatrix, tiles copied from
// device memory into shared memory by cp.async, and an XOR swizzle of the
// tiles' 16-byte chunks that keeps ldmatrix free of bank conflicts.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A, 16 x 16 bf16, 4 registers of 2 values:
//     a0 = (row g,     cols 2t, 2t+1)    a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, 2t+9)  a3 = (row g + 8, cols 2t+8, 2t+9)
//   B, 16 x 8 bf16 (k x n), 2 registers:
//     b0 = (rows 2t, 2t+1, col g)        b1 = (rows 2t+8, 2t+9, col g)
//   C, 16 x 8 f32, 4 registers:
//     c0, c1 = (row g, cols 2t, 2t+1)    c2, c3 = (row g + 8, cols 2t, 2t+1)
// The first value of each pair sits in the low 16 bits.
//
// Tiles in shared memory are [rows][DP] bf16, DP a multiple of 16 (a head
// width padded with zeros), each row DP / 8 chunks of 16 bytes; chunk c of
// row r is stored at chunk swz<DP>(r, c). Every helper here takes
// (row, chunk) coordinates and applies the swizzle itself.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

// Physical chunk of logical chunk `c` in row `r` of a tile DP bf16 wide.
// ldmatrix reads one 16-byte chunk from each of 8 consecutive rows; the 32
// banks are 8 chunks wide. Rows of 8 or more chunks (DP >= 64: 128- and
// 256-byte rows) flip the chunk's low 3 bits with the row's; narrower rows
// share a 128-byte bank line between 8 / (DP / 8) rows and flip by the line
// number. Either way the 8 rows of one ldmatrix hit 8 distinct chunk slots.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = DP / 8;                 // chunks per row
  constexpr int ROWS_PER_LINE = CPR >= 8 ? 1 : 8 / CPR;
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return c ^ ((r / ROWS_PER_LINE) & MASK);
}

// Offset in elements of (row r, chunk c) of a [rows][DP] tile.
template <int DP>
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * DP + swz<DP>(r, c) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- copies --

// 16 bytes from device memory to shared memory, asynchronously; with
// `full` false nothing is read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes, the same way.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups of this thread's copies are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major bf16 matrix with row stride `ld`
// elements into a swizzled [ROWS][DP] tile: rows >= n_rows and columns >= D
// are zeros. With `vec`, D % 8 == 0 and every row start is 16-byte aligned,
// and the copy is asynchronous (cp.async, the caller commits and waits);
// otherwise it is element-wise and synchronous. Each of the NT threads of
// the block takes a share.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int n_rows, size_t ld, int D, bool vec) {
  constexpr int CPR = DP / 8;
  if (vec) {
#pragma unroll
    for (int j = 0; j < (ROWS * CPR + NT - 1) / NT; ++j) {
      const int i = threadIdx.x + j * NT;
      const int r = i / CPR, c = i % CPR, row = r0 + r;
      const bool full = row < n_rows && c * 8 < D;
      const __nv_bfloat16* s = full ? src + static_cast<size_t>(row) * ld + c * 8 : src;
      if (i < ROWS * CPR) cp_async16(dst + tile_off<DP>(r, c), s, full);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, col = i % DP, row = r0 + r;
      const __nv_bfloat16 x = row < n_rows && col < D
                                  ? src[static_cast<size_t>(row) * ld + col]
                                  : __float2bfloat16_rn(0.f);
      dst[tile_off<DP>(r, col / 8) + col % 8] = x;
    }
  }
}

// One warp writes rows [t0, t0 + 16) of a swizzled [rows][DP] tile to rows
// [row0, row0 + 16) of a row-major bf16 matrix (row stride `ld`), leaving
// out rows >= n_rows and columns >= D; 16-byte stores with `vec` (as in
// load_tile), element-wise ones otherwise.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const __nv_bfloat16* tile, int t0, int row0,
                                           int n_rows, size_t ld, int D, bool vec, int lane) {
  constexpr int CPR = DP / 8;
  if (vec) {
#pragma unroll
    for (int j = 0; j < (16 * CPR + 31) / 32; ++j) {
      const int i = lane + 32 * j;
      const int r = i / CPR, c = i % CPR, row = row0 + r;
      if (i < 16 * CPR && row < n_rows && c * 8 < D)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row) * ld + c * 8) =
            *reinterpret_cast<const uint4*>(tile + tile_off<DP>(t0 + r, c));
    }
  } else {
    for (int i = lane; i < 16 * DP; i += 32) {
      const int r = i / DP, col = i % DP, row = row0 + r;
      if (row < n_rows && col < D)
        dst[static_cast<size_t>(row) * ld + col] = tile[tile_off<DP>(t0 + r, col / 8) + col % 8];
    }
  }
}

// ------------------------------------------------------------- registers --

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i in the A/B fragment layout.
// `addr` is a shared-memory address (smem_u32).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b: A 16x16 row-major, B 16x8 "col" (k-major pairs), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 block taken from two 16x8 accumulators, the
// block's columns 0-7 (`c0`) and 8-15 (`c1`): a product's f32 result stays in
// registers as the bf16 left operand of the next product.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The fragment addresses below are shared-memory addresses (32 bits: half
// the registers of a generic pointer) of a tile that starts at `tile`. Row
// offsets r0, n0, k0 are multiples of 8, so the swizzle depends on the lane
// and the chunk only.

// Per-lane address of an ldmatrix_x4 that loads the A fragment of rows
// [r0, r0 + 16) x chunks {c0, c0 + 1} of a tile (16 x 16 values).
template <int DP>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t tile, int r0, int c0, int lane) {
  return tile + 2 * tile_off<DP>(r0 + (lane & 15), c0 + (lane >> 4));
}

// Per-lane address of an ldmatrix_x4 that loads, for a B operand that is
// the tile's rows transposed (B[k][n] = tile[n][k]: keys as columns of
// Q.K^T), the b0, b1 of n-tile rows [n0, n0 + 8) and then of [n0 + 8, n0 +
// 16), over chunks {c0, c0 + 1} (k 16 deep).
template <int DP>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t tile, int n0, int c0, int lane) {
  return tile + 2 * tile_off<DP>(n0 + (lane & 7) + ((lane >> 4) << 3), c0 + ((lane >> 3) & 1));
}

// Per-lane address of an ldmatrix_x4_trans that loads, for a B operand that
// is the tile itself (B[k][n] = tile[k][n]: V in P.V), the b0, b1 of columns
// chunk c0 and then of chunk c0 + 1, over rows [k0, k0 + 16).
template <int DP>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t tile, int k0, int c0, int lane) {
  return tile + 2 * tile_off<DP>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), c0 + (lane >> 4));
}

}  // namespace mma_tile
