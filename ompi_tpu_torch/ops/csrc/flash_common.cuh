// Fragment and copy helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): bf16 tensor-core tiles through mma.sync
// m16n8k16 with f32 accumulation, ldmatrix for transposed B fragments,
// and 16-byte cp.async copies from global into shared memory.
//
// Fragment layouts of m16n8k16 (g = lane / 4, c2 = (lane % 4) * 2):
//   A (16x16, row-major): a0 = (row g, cols c2, c2+1), a1 = (row g+8, the
//     same cols), a2 = (row g, cols c2+8, c2+9), a3 = (row g+8, cols c2+8,
//     c2+9);
//   B (16x8, col-major): b0 = (k rows c2, c2+1; col g), b1 = (k rows
//     c2+8, c2+9; col g);
//   C (16x8): c0, c1 = (row g, cols c2, c2+1), c2, c3 = (row g+8, the same
//     cols).
// So the accumulators of two neighbouring 8-column C tiles are, rounded
// to bf16, the A fragment of the 16-wide product that follows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG = -1e30f;   // masked score, as in the reference

using bf16 = __nv_bfloat16;

// c += a * b for one 16x8 tile; a: 16x16 bf16 (row), b: 16x8 bf16 (col).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 b16 tile in shared memory: four 8x8 matrices
// (thread t gives the address of row t % 16, column (t / 16) * 8 of the
// tile).  Being volatile asm, it is not hoisted out of a loop, where
// holding a loop-invariant tile's fragments would cost registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Four 8x8 b16 matrices from shared memory, transposed on the way (thread
// t gives the address of row t % 8 of matrix t / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// 16 bytes global -> shared without passing through registers; bytes = 0
// writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Number of K/V tiles of `bk` keys `bq` query rows from q0 must
// visit: with a causal mask, tiles past the last key any of its rows may
// see are wholly masked and skipped.
__device__ __forceinline__ int live_tiles(int q0, int bq, int bk, int tq,
                                          int tk, int causal, int q_offset,
                                          int k_offset) {
  const int n_tiles = (tk + bk - 1) / bk;
  if (!causal) return n_tiles;
  const int span = q_offset + min(q0 + bq, tq) - 1 - k_offset;
  return span < 0 ? 0 : min(n_tiles, span / bk + 1);
}

// Two f32 values rounded to nearest-even bf16, the lower column in the
// low half (the fragment order).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace flash
