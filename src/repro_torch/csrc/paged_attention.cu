// Fused ECC page decode + single-token attention over gathered KV strips.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention.py::fused_page_attention (the strip
// kernel). Per (batch, KV group) it reads the encoded K and V strips once
// (2*S*hd bytes) and does ~4*rep*S*hd flops, so it is bound by device
// memory; decoding inside the CTA keeps the decoded cache out of device
// memory.
//
// Design: grid (B, KV), one CTA per (batch row, KV group). The CTA decodes
// its K and V strips (secded64.cuh; the faulty scheme passes bytes
// through), dequantizes each token with its scale in f32 and rounds to the
// query's type, and keeps both strips in shared memory. It then mirrors the
// op order of the reference (repro/kernels/paged_attention.py:105-131, and
// layers.decode_attention it is held to): the score dot accumulates in f32
// and is rounded to the query's type, then multiplied by 1/sqrt(hd) in f32;
// tokens past pos score -1e30; softmax runs in f32; probabilities are
// rounded to the query's type before the PV dot, whose f32 sum is rounded
// once. Flags (corrected, DUE) count valid tokens (<= pos) of both strips
// and are written to the CTA's own (2,) cell of the (B, KV, 2) output.
// Shared memory holds 2*S*hd decoded values plus rep*S scores; the wrapper
// raises above the card's limit (long contexts are the chunked kernel's).
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "secded64.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__device__ void decode_strip(const uint8_t* __restrict__ enc,
                             const float* __restrict__ sc, T* dst, int b,
                             int g, int S, int KV, int hd, int pos,
                             int scheme, int* cnt) {
  const int nb = hd / 8;
  for (int i = threadIdx.x; i < S * nb; i += blockDim.x) {
    const int s = i / nb, j = i % nb;
    uint64_t w = *reinterpret_cast<const uint64_t*>(
        enc + (((int64_t)b * S + s) * KV + g) * hd + 8 * j);
    uint32_t f = 0;
    if (scheme == 1) w = secded64::decode(w, &f);
    if (f && s <= pos) {
      if (f & 1u) atomicAdd(&cnt[0], 1);
      if (f & 2u) atomicAdd(&cnt[1], 1);
    }
    const float scale = sc[(int64_t)b * S + s];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int8_t q = (int8_t)((w >> (8 * e)) & 0xFFull);
      from_float((float)q * scale, &dst[s * hd + 8 * j + e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
page_attention_kernel(const T* __restrict__ q, const uint8_t* __restrict__ ke,
                      const float* __restrict__ ksc,
                      const uint8_t* __restrict__ ve,
                      const float* __restrict__ vsc,
                      const int* __restrict__ pos_arr, T* __restrict__ out,
                      int* __restrict__ flags, int S, int KV, int H, int hd,
                      int scheme, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)S * hd;
  float* sc = reinterpret_cast<float*>(vs + (size_t)S * hd);
  __shared__ int cnt[2];
  const int b = blockIdx.x, g = blockIdx.y;
  const int rep = H / KV;
  const int pos = pos_arr[b];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = blockDim.x / 32;
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();

  decode_strip(ke, ksc, ks, b, g, S, KV, hd, pos, scheme, cnt);
  decode_strip(ve, vsc, vs, b, g, S, KV, hd, pos, scheme, cnt);
  __syncthreads();

  // scores: one warp per (head r, token s)
  for (int pr = warp; pr < rep * S; pr += nwarps) {
    const int r = pr / S, s = pr % S;
    const T* qrow = q + ((int64_t)b * H + g * rep + r) * hd;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32)
      acc = fmaf(to_float(qrow[d]), to_float(ks[s * hd + d]), acc);
    acc = warp_sum(acc);
    if (lane == 0)
      sc[r * S + s] = s <= pos ? round_to(acc, q) * sm_scale : -1e30f;
  }
  __syncthreads();

  // softmax in f32, one warp per head; probabilities rounded to T
  for (int r = warp; r < rep; r += nwarps) {
    float* row = sc + r * S;
    float mx = -3.4e38f;  // every row has token 0 valid, so mx ends finite
    for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) sum += expf(row[s] - mx);
    sum = warp_sum(sum);
    __syncwarp();
    for (int s = lane; s < S; s += 32) row[s] = round_to(expf(row[s] - mx) / sum, q);
  }
  __syncthreads();

  // PV: one thread per (head r, dim d)
  for (int o = tid; o < rep * hd; o += blockDim.x) {
    const int r = o / hd, d = o % hd;
    const float* row = sc + r * S;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc = fmaf(row[s], to_float(vs[s * hd + d]), acc);
    from_float(acc, &out[((int64_t)b * H + g * rep + r) * hd + d]);
  }
  if (tid < 2) flags[((int64_t)b * KV + g) * 2 + tid] = cnt[tid];
}

template <typename T>
int launch(const void* q, const void* ke, const void* ksc, const void* ve,
           const void* vsc, const void* pos, void* out, void* flags, int B,
           int S, int KV, int H, int hd, int scheme, float sm_scale,
           size_t smem, cudaStream_t stream) {
  auto kern = page_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, KV), THREADS, smem, stream>>>(
      (const T*)q, (const uint8_t*)ke, (const float*)ksc, (const uint8_t*)ve,
      (const float*)vsc, (const int*)pos, (T*)out, (int*)flags, S, KV, H, hd,
      scheme, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_bf16: 1 when q/out are bfloat16, 0 when float32. scheme: 0 faulty
// (bytes pass through), 1 in-place. smem: dynamic shared bytes, computed
// by the wrapper as 2*S*hd*sizeof(T) + rep*S*4.
extern "C" int fused_page_attention_launch(
    const void* q, const void* ke, const void* ksc, const void* ve,
    const void* vsc, const void* pos, void* out, void* flags, int B, int S,
    int KV, int H, int hd, int scheme, float sm_scale, long long smem,
    int q_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return launch<__nv_bfloat16>(q, ke, ksc, ve, vsc, pos, out, flags, B, S,
                                 KV, H, hd, scheme, sm_scale, (size_t)smem, s);
  return launch<float>(q, ke, ksc, ve, vsc, pos, out, flags, B, S, KV, H, hd,
                       scheme, sm_scale, (size_t)smem, s);
}
