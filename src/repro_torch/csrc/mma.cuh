// PTX building blocks of the port's tensor-core kernels (the bf16 paths of
// flash_attention, lora_matmul and gram): cp.async copies into shared
// memory, ldmatrix fragment loads, the m16n8k16 bf16 mma, the XOR swizzle
// of shared-memory tiles that keeps ldmatrix free of bank conflicts, and
// the loaders that stage a bf16 tile into that swizzled layout.
#pragma once

#include "common.cuh"

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; zero-filled
// when !valid (src is then never read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Offset (in elements) of 16-byte chunk c of row r in a swizzled bf16 tile
// whose rows hold ROW elements (ROW / 8 chunks).  Chunk c is stored at
// chunk c ^ f(r), with f chosen so that the 8 rows one ldmatrix phase reads
// at one logical chunk land in 8 distinct 16-byte bank groups: f(r) = r & 7
// for rows of 128 bytes or more, and for a row of 64 or 32 bytes the rows
// that share a 128-byte line are told apart by the bits above them.  A
// 16-byte row needs no swizzle: 8 rows already span all 32 banks.  A row
// of 128 bytes or more may hold any multiple of 8 chunks (MLA's 192- and
// 576-wide rows): the XOR keeps c within its aligned group of 8.
//
// A row of 8 n + 4 chunks, n >= 1 (dh 96: 12 chunks, 192 bytes), is not
// padded: its first 8 n chunks swizzle as above and its last 4 as a
// 64-byte row does, c = 8 n + ((c - 8 n) ^ ((r >> 1) & 3)).  Row r starts
// at bank group 4 r mod 8, so over 8 rows read at one chunk the first
// groups hit (c ^ r) ^ 4 (r & 1), a permutation of 0..7, and the last 4
// hit 4 (r & 1) + (c' ^ (r >> 1 & 3)), which tells the 4 even rows apart
// by the XOR and them from the odd ones by the 4: both are free of bank
// conflicts.  The other widths compile exactly as before (the branch is
// resolved at compile time).
template <int ROW>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = ROW / 8;
  static_assert(ROW % 8 == 0 &&
                    ((CH & (CH - 1)) == 0 || CH % 8 == 0 || (CH > 8 && CH % 8 == 4)),
                "rows of 2^n 16-byte chunks, of a multiple of 8, or of 8 n + 4");
  if constexpr (CH > 8 && CH % 8 == 4) {
    constexpr int HEAD = CH - 4;                      // chunks in whole groups of 8
    return (r * CH + (c < HEAD ? c ^ (r & 7) : HEAD + ((c - HEAD) ^ ((r >> 1) & 3)))) * 8;
  } else {
    constexpr int MASK = (CH < 8 ? CH : 8) - 1;
    constexpr int SHIFT = CH >= 8 ? 0 : CH == 4 ? 1 : CH == 2 ? 2 : 3;
    return (r * CH + (c ^ ((r >> SHIFT) & MASK))) * 8;
  }
}

// Stage ROWS x COLS of a bf16 matrix into a swizzled shared tile, with
// THREADS threads: tile element (i, j) is element (r0 + i, c0 + j) of an
// nrows x ncols matrix with row stride s_row and unit column stride, 0 past
// its edge.  Whole 16-byte chunks by cp.async (the caller checks that every
// row is 16-byte aligned and ncols % 8 == 0); a fixed number a thread, so
// the loop unrolls into straight-line code.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_chunks(__nv_bfloat16* __restrict__ dst,
                                             const __nv_bfloat16* __restrict__ src, int r0,
                                             int c0, int nrows, int ncols, long long s_row,
                                             int tid) {
  constexpr int CH = COLS / 8, PER = ROWS * CH / THREADS;
  static_assert(PER * THREADS == ROWS * CH, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * THREADS, rr = i / CH, c = i % CH;
    const int gr = r0 + rr, gc = c0 + 8 * c;
    const bool ok = gr < nrows && gc < ncols;
    cp_async16(dst + swz<COLS>(rr, c), ok ? src + gr * s_row + gc : src, ok);
  }
}

// The same tile element by element, with strides (s_row, s_col): for a
// matrix whose rows are not whole aligned chunks.  Out of line, so the
// caller's main loop stays small.
template <int ROWS, int COLS, int THREADS>
__device__ __noinline__ void stage_elems(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                         int c0, int nrows, int ncols, long long s_row,
                                         long long s_col, int tid) {
  for (int i = tid; i < ROWS * COLS; i += THREADS) {
    const int rr = i / COLS, cc = i % COLS, gr = r0 + rr, gc = c0 + cc;
    dst[swz<COLS>(rr, cc / 8) + cc % 8] =
        gr < nrows && gc < ncols ? src[gr * s_row + gc * s_col] : __float2bfloat16(0.f);
  }
}

template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int c0, int nrows, int ncols,
                                           long long s_row, long long s_col, bool vec,
                                           int tid) {
  if (vec)
    stage_chunks<ROWS, COLS, THREADS>(dst, src, r0, c0, nrows, ncols, s_row, tid);
  else
    stage_elems<ROWS, COLS, THREADS>(dst, src, r0, c0, nrows, ncols, s_row, s_col, tid);
}

}  // namespace repro
