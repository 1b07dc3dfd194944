// Fused in-place-ECC decode + matmul, float path:
//   out (M,N) f32 = a (M,K) @ dequant(decode(w_enc (K,N) uint8)) ,
// with (corrected, DUE) counts over every weight block.
//
// Replaces the float path of the TPU kernel
// repro/kernels/ecc_qmatmul.py::ecc_qmatmul (its `path == "float"` branch).
// At decode batch (M = 4) the product does ~2 flops per weight byte, so
// the kernel is bound by reading the encoded weight once from device
// memory (K*N bytes); decoding in shared memory keeps decoded weights out
// of device memory, so protection adds no traffic.
//
// Design: each CTA owns a strip of BN = 64 output columns (8 whole ECC
// blocks per weight row) and all of K. It walks K in BK-row tiles: the
// encoded tile is read as 64-bit words, decoded (secded64.cuh), dequantized
// to float(q) * w_scale and rounded to the activation's type as the
// reference does, and stored in shared memory; the activation tile is
// staged beside it; every thread then accumulates its column for a quarter
// of the rows in f32 registers, in K order. The output is written once.
// Rows are processed in chunks of MC = 4 * RPT, where the host picks the
// smallest RPT in {1, 2, 4, 8} whose chunk holds all of M, so at decode
// batch (M = 4, RPT = 1) no thread computes a padded row. For M <= 32 there
// is one chunk and every weight block is decoded exactly once per launch.
// For M > 32 the chunks are passes over the whole of K: each pass reads and
// decodes the weight again (flags are counted only in the first pass, so
// they never depend on M); the serve path never takes this branch. Flag
// totals go to the (2,) int32 output with integer atomics; there are no
// float atomics, so the result is deterministic. Edge tiles are masked
// (rows past K read as 0, blocks past N are skipped), so only N % 8 == 0
// is required.
//
// Known limit, kept for a later change: N = 4096 gives 64 CTAs for 132 SMs.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "secded64.cuh"

namespace {

constexpr int BN = 64;       // output columns per CTA (8 ECC blocks)
constexpr int BK = 64;       // weight rows per K tile
constexpr int THREADS = 256; // 64 columns x 4 row groups
constexpr int RG = THREADS / BN;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round a float to the activation type, as `.astype(a.dtype)` does
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// RPT: rows per thread per chunk; a chunk is MC = RG * RPT rows
template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const T* __restrict__ a, const uint8_t* __restrict__ w_enc,
               const float* __restrict__ w_scale, float* __restrict__ out,
               int* __restrict__ flags, int M, int N, int K) {
  constexpr int MC = RG * RPT;
  __shared__ float wtile[BK][BN];
  __shared__ float atile[MC][BK];
  __shared__ int cnt[2];
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const float scale = *w_scale;
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();

  for (int mc0 = 0; mc0 < M; mc0 += MC) {
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      // decode + dequantize the (BK, BN) weight tile: BK*8 blocks
      for (int b = tid; b < BK * (BN / 8); b += THREADS) {
        const int kr = b / (BN / 8), jb = b % (BN / 8);
        const int k = k0 + kr, n = n0 + 8 * jb;
        const bool valid = k < K && n < N;
        uint64_t w = valid ? *reinterpret_cast<const uint64_t*>(
                                 w_enc + (int64_t)k * N + n)
                           : 0ull;
        uint32_t f;
        w = secded64::decode(w, &f);
        if (valid && mc0 == 0 && f) {
          if (f & 1u) atomicAdd(&cnt[0], 1);
          if (f & 2u) atomicAdd(&cnt[1], 1);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int8_t q = (int8_t)((w >> (8 * e)) & 0xFFull);
          wtile[kr][8 * jb + e] = round_to((float)q * scale, a);
        }
      }
      // stage the (MC, BK) activation tile
      for (int idx = tid; idx < MC * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK;
        const int m = mc0 + r, k = k0 + c;
        atile[r][c] = (m < M && k < K) ? to_float(a[(int64_t)m * K + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float wv = wtile[kk][col];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          acc[j] = fmaf(atile[rg + RG * j][kk], wv, acc[j]);
      }
      __syncthreads();
    }
    const int n = n0 + col;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int m = mc0 + rg + RG * j;
        if (m < M) out[(int64_t)m * N + n] = acc[j];
      }
    }
  }
  __syncthreads();
  if (tid < 2 && cnt[tid]) atomicAdd(&flags[tid], cnt[tid]);
}

template <typename T, int RPT>
void launch(const void* a, const void* w_enc, const void* w_scale, void* out,
            void* flags, int M, int N, int K, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN);
  qmatmul_kernel<T, RPT><<<grid, THREADS, 0, s>>>(
      (const T*)a, (const uint8_t*)w_enc, (const float*)w_scale, (float*)out,
      (int*)flags, M, N, K);
}

template <typename T>
void launch_rows(const void* a, const void* w_enc, const void* w_scale,
                 void* out, void* flags, int M, int N, int K, cudaStream_t s) {
  if (M <= RG)
    launch<T, 1>(a, w_enc, w_scale, out, flags, M, N, K, s);
  else if (M <= 2 * RG)
    launch<T, 2>(a, w_enc, w_scale, out, flags, M, N, K, s);
  else if (M <= 4 * RG)
    launch<T, 4>(a, w_enc, w_scale, out, flags, M, N, K, s);
  else
    launch<T, 8>(a, w_enc, w_scale, out, flags, M, N, K, s);
}

}  // namespace

// a_bf16: 1 when `a` is bfloat16, 0 when it is float32.
extern "C" int ecc_qmatmul_float_launch(const void* a, const void* w_enc,
                                        const void* w_scale, void* out,
                                        void* flags, int M, int N, int K,
                                        int a_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a_bf16)
    launch_rows<__nv_bfloat16>(a, w_enc, w_scale, out, flags, M, N, K, s);
  else
    launch_rows<float>(a, w_enc, w_scale, out, flags, M, N, K, s);
  return (int)cudaGetLastError();
}
