// WOT throttle of int8 weights: positions 0..6 of every 8-value block
// clamped to [-64, 63], position 7 kept.
//
// Replaces the TPU kernel repro/kernels/throttle.py::throttle. Bound by
// device memory: 1 byte read and 1 written per value, a few SIMD
// instructions in between. One 8-byte block per thread: one 64-bit load,
// the byte clamp of wot8.cuh (two per-byte signed max/min pairs), one
// 64-bit store. Any nblk: the grid-stride loop stops at the last block, so
// a ragged edge needs no padding (the TPU kernel asserts whole tiles).
//
// The serve paths no longer launch it: their KV write runs the same clamp
// inside kv_write.cu.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

#include "wot8.cuh"

namespace {

__global__ void throttle_kernel(const uint2* __restrict__ in,
                                uint2* __restrict__ out, int64_t nblk) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint2 v = in[i];
    v.x = wot8::clamp_lo(v.x);
    v.y = wot8::clamp_hi(v.y);
    out[i] = v;
  }
}

int grid_for(int64_t n, int threads) {
  int64_t g = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // enough resident blocks to fill an H100
  return (int)(g < cap ? (g > 0 ? g : 1) : cap);
}

}  // namespace

// in, out: (nblk, 8) int8, 8-byte aligned.
extern "C" int throttle_launch(const void* in, void* out, long long nblk,
                               void* stream) {
  const int threads = 256;
  throttle_kernel<<<grid_for(nblk, threads), threads, 0,
                    (cudaStream_t)stream>>>((const uint2*)in, (uint2*)out,
                                            nblk);
  return (int)cudaGetLastError();
}
