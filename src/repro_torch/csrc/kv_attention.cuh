// Pieces shared by the two paged-attention kernels of the port
// (paged_attention.cu, chunked_attention.cu): value conversions, warp
// reductions, the page-table walk and the last-CTA-done reduction of the
// per-CTA (corrected, DUE) cells into the flags output.
//
// The KV pool of one layer is (P, page_size, KV, hd) uint8 with
// (P, page_size) f32 scales and, for parity-zero, (P, page_size, KV, hd/8)
// check bytes. Token t of batch row b sits at page table[b, t / page_size],
// slot t % page_size. A NULL table is the identity over one page per row
// (page b holds the whole row): the strip entry points view their (B, S,
// KV, hd) strips as such a pool.
#pragma once
#include <cuda_bf16.h>
#include <cstdint>

namespace kv_attention {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}
// x rounded to the query's type and back to f32
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four per-lane partials a0..a3 (one per token) summed over the warp's 32
// lanes with 6 shuffles: the pairs are those of warp_sum's butterfly
// (lanes l and l^16, then l^8, l^4, l^2, l^1), so each total is the same
// f32 value warp_sum gives; lanes 8j .. 8j + 7 receive the total of aj.
__device__ __forceinline__ float reduce4(float a0, float a1, float a2,
                                         float a3) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool h16 = lane & 16, h8 = lane & 8;
  float k0 = h16 ? a2 : a0, k1 = h16 ? a3 : a1;
  k0 += __shfl_xor_sync(full, h16 ? a0 : a2, 16);
  k1 += __shfl_xor_sync(full, h16 ? a1 : a3, 16);
  float k = h8 ? k1 : k0;
  k += __shfl_xor_sync(full, h8 ? k0 : k1, 8);
  k += __shfl_xor_sync(full, k, 4);
  k += __shfl_xor_sync(full, k, 2);
  k += __shfl_xor_sync(full, k, 1);
  return k;
}

// The same for eight partials a[0..7] with 9 shuffles; lanes 4j .. 4j + 3
// receive the total of a[j].
__device__ __forceinline__ float reduce8(const float (&a)[8]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k[i] = h16 ? a[4 + i] : a[i];
    k[i] += __shfl_xor_sync(full, h16 ? a[i] : a[4 + i], 16);
  }
  float m0 = h8 ? k[2] : k[0], m1 = h8 ? k[3] : k[1];
  m0 += __shfl_xor_sync(full, h8 ? k[0] : k[2], 8);
  m1 += __shfl_xor_sync(full, h8 ? k[1] : k[3], 8);
  float t = h4 ? m1 : m0;
  t += __shfl_xor_sync(full, h4 ? m0 : m1, 4);
  t += __shfl_xor_sync(full, t, 2);
  t += __shfl_xor_sync(full, t, 1);
  return t;
}

// Byte e of a word whose bytes were XORed with 0x80 (int8 -> offset
// binary), as the exact f32 of its int8 through the 2^23 magic number (no
// I2F: type conversions are quarter-rate on sm_90).
__device__ __forceinline__ float i8f(uint32_t u, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e)),
                   8388736.f);
}
// The same times scale, rounded once: the plain version's
// `q.float() * scale`.
__device__ __forceinline__ float dequant(uint32_t u, int e, float scale) {
  return __fmul_rn(i8f(u, e), scale);
}

// The in-place code's sign restore on one 32-bit half of a block (half 1
// holds bytes 4..7; byte 7 carries no check bit): bit 6 of bytes 0..6
// takes bit 7. Idempotent, so a block the exact decode already restored
// may be restored again.
__device__ __forceinline__ uint32_t restore_half(uint32_t w, int half) {
  const uint32_t m = half ? 0x00404040u : 0x40404040u;
  return (w & ~m) | ((w >> 1) & m);  // one shift and one LOP3
}

// A page id read from the table, checked against the pool's P pages: an
// id outside [0, P) (an allocator fault) traps, so the launch fails with a
// CUDA error as the gather it replaces did, instead of reading outside the
// pool.
__device__ __forceinline__ int checked_page(int page, int P) {
  if ((unsigned)page >= (unsigned)P) __trap();
  return page;
}

// Flat (page * page_size + slot) index of token t of row b.
__device__ __forceinline__ int64_t token_slot(const int* __restrict__ table,
                                              int b, int npg, int ps, int P,
                                              int t) {
  const int page =
      table ? checked_page(__ldg(table + (int64_t)b * npg + t / ps), P) : b;
  return (int64_t)page * ps + t % ps;
}

// Every CTA calls this once with all of its threads, after thread 0 wrote
// the CTA's (corrected, DUE) cell at cells[2 * cta]; the cells of row b
// are the n_cta / B consecutive ones from b * n_cta / B. The last CTA to
// arrive (an integer ticket on *counter, which it resets to 0 for the next
// launch) sums every cell into flags: (2,) totals, or (2, B) rows with
// per_slot. Integer sums, so the result does not depend on which CTA is
// last. The counter must be 0 at launch and no other launch may use it
// meanwhile: the wrapper keeps one buffer per (device, stream), and
// launches on one stream run one after another.
__device__ void finish_flags(const int* cells, int* counter, int* flags,
                             int n_cta, int B, int per_slot) {
  __shared__ int last;
  __shared__ int tot[2];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_cta - 1;
  if (threadIdx.x < 2) tot[threadIdx.x] = 0;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (per_slot) {
    const int per_row = n_cta / B;
    for (int b = warp; b < B; b += nw) {
      int c = 0, d = 0;
      for (int i = lane; i < per_row; i += 32) {
        const int64_t k = 2 * ((int64_t)b * per_row + i);
        c += __ldcg(cells + k);
        d += __ldcg(cells + k + 1);
      }
      c = warp_sum(c);
      d = warp_sum(d);
      if (lane == 0) {
        flags[b] = c;
        flags[B + b] = d;
      }
    }
  } else {
    int c = 0, d = 0;
    for (int i = threadIdx.x; i < n_cta; i += blockDim.x) {
      c += __ldcg(cells + 2 * (int64_t)i);
      d += __ldcg(cells + 2 * (int64_t)i + 1);
    }
    c = warp_sum(c);
    d = warp_sum(d);
    if (lane == 0) {
      atomicAdd(&tot[0], c);
      atomicAdd(&tot[1], d);
    }
    __syncthreads();
    if (threadIdx.x < 2) flags[threadIdx.x] = tot[threadIdx.x];
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace kv_attention
