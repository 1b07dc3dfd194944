// Fused quantize + WOT throttle of an f32 weight (the QATT inner step).
//
// Replaces the TPU kernel repro/kernels/quant_throttle.py::quantize_throttle
// (pass 1 _absmax_kernel, pass 2 _qt_kernel). Input (nblk, 8) f32 blocks;
// output (nblk, 8) int8 with positions 0..6 of every block clamped to
// [-64, 63], and the per-tensor scale max(absmax, 1e-12) / 127.
//
// Bound by device memory: pass 1 reads 4 bytes per value, pass 2 reads 4
// and writes 1 (9 bytes per value in all). The TPU carries the running max
// through its sequential grid; CUDA blocks run in no order, so pass 1
// reduces each block in registers and shared memory and merges the blocks
// with one integer atomicMax on the bit pattern of |w| (for non-negative
// floats the bit order is the value order, so the max is exact and the
// result does not depend on the order). Pass 2 reads the max, computes the
// scale on the device (no host round trip) and quantizes one 8-value block
// per thread: two 16-byte loads, one 8-byte store.
//
// Rounding follows jnp.round: rintf (half to even) of a true IEEE division
// w / scale (no reciprocal multiply, no fast math).
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void absmax_kernel(const float4* __restrict__ w, int64_t n4,
                              unsigned int* __restrict__ out) {
  unsigned int m = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 v = w[i];
    m = max(m, __float_as_uint(fabsf(v.x)));
    m = max(m, __float_as_uint(fabsf(v.y)));
    m = max(m, __float_as_uint(fabsf(v.z)));
    m = max(m, __float_as_uint(fabsf(v.w)));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(out, m);
  }
}

__device__ __forceinline__ int quant(float w, float scale) {
  const float r = rintf(w / scale);
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ int wot_clamp(int q) {
  return min(max(q, -64), 63);
}

__global__ void qt_kernel(const float4* __restrict__ w,
                          const unsigned int* __restrict__ amax,
                          uint64_t* __restrict__ q,
                          float* __restrict__ scale_out, int64_t nblk) {
  const float scale = fmaxf(__uint_as_float(*amax), 1e-12f) / 127.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 a = w[2 * i], b = w[2 * i + 1];
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint64_t packed = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int v = k < 7 ? wot_clamp(quant(x[k], scale)) : quant(x[k], scale);
      packed |= (uint64_t)(uint8_t)(int8_t)v << (8 * k);
    }
    q[i] = packed;
  }
}

int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill an H100
  return (int)(g < cap ? (g > 0 ? g : 1) : cap);
}

}  // namespace

// w: (nblk, 8) f32, 16-byte aligned; q: (nblk, 8) int8, 8-byte aligned;
// amax: one uint32 of scratch; scale: one f32.
extern "C" int quantize_throttle_launch(const void* w, void* q, void* amax,
                                        void* scale, long long nblk,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
  absmax_kernel<<<grid_for(2 * nblk, kThreads), kThreads, 0, s>>>(
      (const float4*)w, 2 * nblk, (unsigned int*)amax);
  qt_kernel<<<grid_for(nblk, kThreads), kThreads, 0, s>>>(
      (const float4*)w, (const unsigned int*)amax, (uint64_t*)q,
      (float*)scale, nblk);
  return (int)cudaGetLastError();
}
