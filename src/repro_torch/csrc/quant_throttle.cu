// Fused quantize + WOT throttle of an f32 weight (the QATT inner step),
// optionally writing the moved values back into the f32 masters in place.
//
// Replaces the TPU kernel repro/kernels/quant_throttle.py::quantize_throttle
// (pass 1 _absmax_kernel, pass 2 _qt_kernel). Input: n f32 values, read as
// 8-value blocks (a ragged last block is masked here, so no padded copy is
// needed). Per-tensor scale max(absmax, 1e-12) / 127; q = the quantized
// values with positions 0..6 of every block clamped to [-64, 63].
//
// Two outputs, each optional:
// * q (int8, n values): the deploy's quantize-throttle;
// * write_back: every master whose q the clamp moved becomes qt * scale
//   (__fmul_rn), every other master is left untouched -- bit for bit the
//   reference's core/wot.py::throttle_tensor, where(q == qt, w, qt * scale),
//   with no second pass over the masters in PyTorch.
//
// Bound by device memory: pass 1 reads 4 bytes per value, pass 2 reads 4
// more, writes 4 per moved value and 1 per value when q is asked for (9
// bytes per value for the deploy, ~8 for the train step's write-back). The
// TPU carries the running max through its sequential grid; CUDA blocks run
// in no order, so pass 1 reduces each block in registers and shared memory
// and merges the blocks with one integer atomicMax on the bit pattern of
// |w| (for non-negative floats the bit order is the value order, so the
// max is exact and the result does not depend on the order). Pass 2 reads
// the max, computes the scale on the device (no host round trip) and
// quantizes one 8-value block per thread: two 16-byte loads, the byte
// clamp of wot8.cuh on the packed block, one 8-byte store of q, and a
// 4-byte store only for each value the clamp moved.
//
// Rounding follows jnp.round: rintf (half to even) of a true IEEE division
// w / scale (no reciprocal multiply, no fast math).
//
// On a sharded tensor the scale is the global one: the second entry point
// runs one pass at a time (1: absmax into amax; 2: quantize and clamp with
// the amax it is given), so the caller can all-reduce the amax (MAX over
// the bit patterns, which order as the values do) between the passes.
//
// Plain C interface for ctypes: the entry points launch on the given
// stream, allocate nothing, and return cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

#include "wot8.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void absmax_kernel(const float* __restrict__ w, int64_t n,
                              unsigned int* __restrict__ out) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int64_t n4 = n / 4;
  unsigned int m = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 v = w4[i];
    m = max(m, __float_as_uint(fabsf(v.x)));
    m = max(m, __float_as_uint(fabsf(v.y)));
    m = max(m, __float_as_uint(fabsf(v.z)));
    m = max(m, __float_as_uint(fabsf(v.w)));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)  // the last n % 4 values
    m = max(m, __float_as_uint(fabsf(w[4 * n4 + threadIdx.x])));
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

__device__ __forceinline__ uint64_t quant_byte(float w, float scale, int k) {
  const float r = fminf(fmaxf(rintf(w / scale), -127.f), 127.f);
  return (uint64_t)(uint8_t)(int8_t)(int)r << (8 * k);
}

__global__ void qt_kernel(float* __restrict__ w,
                          const unsigned int* __restrict__ amax,
                          int8_t* __restrict__ q_out,
                          float* __restrict__ scale_out, int64_t n,
                          int write_back) {
  const float scale = fmaxf(__uint_as_float(*amax), 1e-12f) / 127.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t nfull = n / 8, nblk = (n + 7) / 8;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    float x[8];
    const bool full = i < nfull;
    if (full) {
      const float4 a = reinterpret_cast<const float4*>(w)[2 * i];
      const float4 b = reinterpret_cast<const float4*>(w)[2 * i + 1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {  // the ragged last block: absent values quantize to 0
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = 8 * i + k < n ? w[8 * i + k] : 0.f;
    }
    uint64_t q = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) q |= quant_byte(x[k], scale, k);
    const uint64_t qt = wot8::clamp(q);
    if (write_back && qt != q) {  // a rare block: store only what moved
#pragma unroll
      for (int k = 0; k < 7; ++k)
        if (((q ^ qt) >> (8 * k)) & 0xFFu)
          w[8 * i + k] = __fmul_rn((float)(int8_t)(qt >> (8 * k)), scale);
    }
    if (q_out == nullptr) continue;
    if (full) {
      reinterpret_cast<uint64_t*>(q_out)[i] = qt;
    } else {
      for (int k = 0; k < 8 && 8 * i + k < n; ++k)
        q_out[8 * i + k] = (int8_t)(qt >> (8 * k));
    }
  }
}

int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill an H100
  return (int)(g < cap ? (g > 0 ? g : 1) : cap);
}

}  // namespace

// w: n f32 values, 16-byte aligned (written in place with write_back);
// q: n int8 values, 8-byte aligned, or NULL; amax: one uint32 of scratch;
// scale: one f32.
extern "C" int quantize_throttle_launch(void* w, void* q, void* amax,
                                        void* scale, long long n,
                                        int write_back, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
  absmax_kernel<<<grid_for((n + 3) / 4, kThreads), kThreads, 0, s>>>(
      (const float*)w, n, (unsigned int*)amax);
  qt_kernel<<<grid_for((n + 7) / 8, kThreads), kThreads, 0, s>>>(
      (float*)w, (const unsigned int*)amax, (int8_t*)q, (float*)scale, n,
      write_back);
  return (int)cudaGetLastError();
}

// One pass of quantize_throttle_launch: which == 1 zeroes amax and runs
// pass 1 (absmax), which == 2 runs pass 2 against the amax in place.
extern "C" int quantize_throttle_pass_launch(void* w, void* q, void* amax,
                                             void* scale, long long n,
                                             int write_back, int which,
                                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 1) {
    cudaMemsetAsync(amax, 0, sizeof(unsigned int), s);
    absmax_kernel<<<grid_for((n + 3) / 4, kThreads), kThreads, 0, s>>>(
        (const float*)w, n, (unsigned int*)amax);
  } else {
    qt_kernel<<<grid_for((n + 7) / 8, kThreads), kThreads, 0, s>>>(
        (float*)w, (const unsigned int*)amax, (int8_t*)q, (float*)scale, n,
        write_back);
  }
  return (int)cudaGetLastError();
}
