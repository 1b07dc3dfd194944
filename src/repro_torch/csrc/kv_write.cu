// Fused KV write: one launch quantizes a layer's new K and V per token,
// WOT-throttles them (in-place scheme), encodes them and stores them into
// the paged pool through the page table, in place.
//
// Replaces, on the serve paths, what the TPU reference computes as
// serving/kvcache.py::_encode_kv + _write_token / _write_pages: the
// per-token quantize, the WOT clamp of the TPU kernel
// repro/kernels/throttle.py::throttle (the reference's KV path runs it as
// the plain wot.throttle_q), the scheme's encode and the page scatter.
//
// For each token and each of K, V (one CTA per (token, K|V): a grid of
// (B * T, 2)):
//   1. scale = max(amax |x| over (kv, hd), 1e-12) / 127, an IEEE division;
//      the amax is an exact max (an integer max on the bit pattern of |x|,
//      warp shuffles, then shared memory), so its order does not matter;
//   2. q = clip(rint(x / scale), -127, 127), a true division;
//   3. in-place: the byte clamp of wot8.cuh, then secded64::encode;
//      parity-zero: the check byte of parity8::check_byte; faulty: the
//      bytes as they are;
//   4. phys = table[b, pos / ps], slot = pos % ps (pos = the token's
//      position: pos[b] for a decode token, t for a prefill from position
//      0); a position past the table or a page id outside [0, P) traps,
//      as the paged-attention kernels do, instead of writing outside the
//      pool;
//   5. pages[phys, slot] (one 8-byte store per block), checks[phys, slot]
//      and scales[phys, slot], and, when asked, a contiguous copy of the
//      encoded token, its checks and its scale (the prefill decodes them
//      again to feed the flash kernel).
//
// What bounds it: the launch. A decode step at batch 4 moves 64 KB in and
// about 32 KB out per layer (0.03 us at 3.35 TB/s), so the design's only
// gain is to be one launch where the route it replaces paid about forty
// (the plain quantize, the throttle and encode kernels, the index puts). A
// prefill of 4 x 2,048 tokens is bound by device memory: 16-byte loads,
// neighbouring threads on neighbouring blocks, a thread's first block kept
// in registers between the two passes (the only block at D <= 4,096; any
// further block is read again, from L1/L2), quantize, clamp and encode in
// registers.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

#include "parity8.cuh"
#include "secded64.cuh"
#include "wot8.cuh"

namespace {

// kernels/paged_attention.py SCHEME_IDS (0 is faulty: the bytes as they are)
constexpr int kInPlace = 1, kParityZero = 2;
constexpr int kMaxThreads = 512;

struct Side {  // K or V of one launch
  const void* x;        // (B, T, D) new tokens, bf16 or f32
  uint8_t* pages;       // (P, ps, D) pool
  uint8_t* checks;      // (P, ps, D / 8) parity planes, or NULL
  float* scales;        // (P, ps) per-token scales
  uint8_t* enc_out;     // (B, T, D) copy of the encoded tokens, or NULL
  uint8_t* checks_out;  // (B, T, D / 8), or NULL
  float* scale_out;     // (B, T), or NULL
};

// Block blk (8 values) of x as f32: one 16-byte load of bf16 (a bf16 is the
// upper half of its f32, so the widening is exact), two of f32.
template <bool kBf16>
__device__ __forceinline__ void load_block(const void* x, int64_t blk,
                                           float v[8]) {
  if constexpr (kBf16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + blk);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + 2 * blk);
    const float4 b = __ldg(reinterpret_cast<const float4*>(x) + 2 * blk + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

__device__ __forceinline__ uint64_t quant_byte(float x, float scale, int e) {
  const float r = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
  return (uint64_t)(uint8_t)(int8_t)(int)r << (8 * e);
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
    kv_write_kernel(Side k, Side v, const int* __restrict__ table,
                    const int* __restrict__ pos, int T, int npg, int ps,
                    int P, int D, int scheme) {
  const Side s = blockIdx.y ? v : k;
  const int tok = blockIdx.x;  // b * T + t
  const int b = tok / T;
  const int nblk = D / 8;
  const int64_t src = (int64_t)tok * nblk;  // the token's first block
  // The thread's first block is loaded before the token's position and
  // page id, so its DRAM round trip overlaps theirs (pos, then the page
  // id that depends on it); the page is needed only by the stores, and
  // the block stays in registers for the second pass.
  float x0[8];
  const bool has0 = threadIdx.x < nblk;
  if (has0) load_block<kBf16>(s.x, src + threadIdx.x, x0);
  const int p = pos ? __ldg(pos + b) : tok - b * T;
  if (p < 0 || p / ps >= npg) __trap();
  const int page = __ldg(table + (int64_t)b * npg + p / ps);

  uint32_t m = 0;
  if (has0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) m = max(m, __float_as_uint(fabsf(x0[e])));
  }
  for (int j = threadIdx.x + blockDim.x; j < nblk; j += blockDim.x) {
    float x[8];
    load_block<kBf16>(s.x, src + j, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = max(m, __float_as_uint(fabsf(x[e])));
  }
  __shared__ uint32_t warp_max[kMaxThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  // every warp reduces the per-warp maxima itself: no second barrier
  m = lane < (int)(blockDim.x / 32) ? warp_max[lane] : 0u;
  m = __reduce_max_sync(0xffffffffu, m);
  const float scale = fmaxf(__uint_as_float(m), 1e-12f) / 127.f;
  if ((unsigned)page >= (unsigned)P) __trap();
  const int64_t row = (int64_t)page * ps + p % ps;  // the pool's token row

  uint64_t* pages = reinterpret_cast<uint64_t*>(s.pages);
  uint64_t* enc_out = reinterpret_cast<uint64_t*>(s.enc_out);
  for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
    float x[8];
    if (j == threadIdx.x) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = x0[e];
    } else {
      load_block<kBf16>(s.x, src + j, x);
    }
    uint64_t q = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) q |= quant_byte(x[e], scale, e);
    uint32_t c = 0;
    if (scheme == kInPlace)
      q = secded64::encode(wot8::clamp(q));
    else if (scheme == kParityZero)
      c = parity8::check_byte(q);
    pages[row * nblk + j] = q;
    if (s.checks) s.checks[row * nblk + j] = (uint8_t)c;
    if (enc_out) enc_out[src + j] = q;
    if (s.checks_out) s.checks_out[src + j] = (uint8_t)c;
  }
  if (threadIdx.x == 0) {
    s.scales[row] = scale;
    if (s.scale_out) s.scale_out[tok] = scale;
  }
}

}  // namespace

// k, v: (B, T, D) bf16 (bf16 != 0) or f32, 16-byte aligned, D = kv * hd a
// multiple of 8; pools: (P, ps, D) uint8 and (P, ps) f32 per side, checks
// (P, ps, D / 8) uint8 for parity-zero else NULL; the *_out copies (B, T,
// D), (B, T, D / 8) and (B, T), or NULL; table (B, npg) int32; pos (B,)
// int32 with T = 1, or NULL for a prefill of T tokens from position 0
// (T <= npg * ps). scheme: 0 faulty, 1 in-place, 2 parity-zero.
extern "C" int kv_write_launch(const void* k, const void* v, void* k_pages,
                               void* k_checks, void* k_scales, void* v_pages,
                               void* v_checks, void* v_scales,
                               void* k_enc_out, void* k_checks_out,
                               void* k_scale_out, void* v_enc_out,
                               void* v_checks_out, void* v_scale_out,
                               const void* table, const void* pos, int B,
                               int T, int npg, int ps, int P, int D,
                               int scheme, int bf16, void* stream) {
  const Side ks{k, (uint8_t*)k_pages, (uint8_t*)k_checks, (float*)k_scales,
                (uint8_t*)k_enc_out, (uint8_t*)k_checks_out,
                (float*)k_scale_out};
  const Side vs{v, (uint8_t*)v_pages, (uint8_t*)v_checks, (float*)v_scales,
                (uint8_t*)v_enc_out, (uint8_t*)v_checks_out,
                (float*)v_scale_out};
  const int nblk = D / 8;
  int threads = (nblk + 31) / 32 * 32;
  threads = threads < kMaxThreads ? threads : kMaxThreads;
  const dim3 grid(B * T, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    kv_write_kernel<true><<<grid, threads, 0, s>>>(
        ks, vs, (const int*)table, (const int*)pos, T, npg, ps, P, D, scheme);
  else
    kv_write_kernel<false><<<grid, threads, 0, s>>>(
        ks, vs, (const int*)table, (const int*)pos, T, npg, ps, P, D, scheme);
  return (int)cudaGetLastError();
}
