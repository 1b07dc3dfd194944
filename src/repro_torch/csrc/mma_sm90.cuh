// Warp-level tensor-core and async-copy primitives shared by the port's
// tensor-core kernels (flash_attention.cu, ecc_qmatmul.cu,
// chunked_attention.cu): cp.async with zero fill, ldmatrix (plain and
// transposed) and mma.sync for bf16 -> f32 (m16n8k16), s8 -> s32
// (m16n8k32) and b1 AND-popcount (m16n8k256).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16 bf16 or 16 x 32 s8, row-major): a0 row g, a1 row g + 8,
//     a2 row g (second half of k), a3 row g + 8 (second half of k); each
//     register holds 2 bf16 (k = 2t, 2t + 1) or 4 s8 (k = 4t .. 4t + 3).
//   B (16 x 8 bf16 or 32 x 8 s8, "col"): b0 k = 2t, 2t + 1 (s8: 4t .. 4t+3)
//     of column g; b1 the same 8 (s8: 16) rows further down.
//   C/D (16 x 8 f32 or s32): c0, c1 row g, columns 2t, 2t + 1; c2, c3 row
//     g + 8.
// ldmatrix.x4 gives four 8 x 8 b16 matrices, lanes 8i .. 8i + 7 naming the
// rows of matrix i; without .trans lane l receives row l / 4, elements
// 2(l % 4), 2(l % 4) + 1 of each, which is an A fragment (rows 0-15 x
// k 0-7 | 8-15) or a B fragment read from a [n][k] tile; with .trans it
// receives the transpose, a B fragment read from a [k][n] tile.
#pragma once
#include <cstdint>

namespace mma_sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte (cg: L2 only), 8- or 4-byte (ca) async copy; `in` false fills zeros
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a @ b: bf16 inputs (products exact), f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b: s8 inputs, s32 accumulator (exact; wraps on overflow)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3},"
      " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += popc(a & b) per (row, column): 256-bit rows of a against 256-bit
// columns of b (binary MMA; a register holds 32 consecutive bits)
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0, %1, "
      "%2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, packed low = x, high = y
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(y), "f"(x));
  return r;
}

}  // namespace mma_sm90
