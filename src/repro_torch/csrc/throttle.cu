// WOT throttle of int8 weights: positions 0..6 of every 8-value block
// clamped to [-64, 63], position 7 kept.
//
// Replaces the TPU kernel repro/kernels/throttle.py::throttle. Bound by
// device memory: 1 byte read and 1 written per value, a few SIMD
// instructions in between. One 8-byte block per thread: one 64-bit load,
// two per-byte signed max/min pairs (__vmaxs4/__vmins4, one per 32-bit
// half; the bounds of byte 7 are the full int8 range), one 64-bit store.
// Any nblk: the grid-stride loop stops at the last block, so a ragged
// edge needs no padding (the TPU kernel asserts whole tiles).
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void throttle_kernel(const uint2* __restrict__ in,
                                uint2* __restrict__ out, int64_t nblk) {
  // little endian: byte k of a block is byte k % 4 of word k / 4
  constexpr unsigned int lo0 = 0xC0C0C0C0u, hi0 = 0x3F3F3F3Fu;  // -64, 63
  constexpr unsigned int lo1 = 0x80C0C0C0u, hi1 = 0x7F3F3F3Fu;  // byte 7 free
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint2 v = in[i];
    v.x = __vmins4(__vmaxs4(v.x, lo0), hi0);
    v.y = __vmins4(__vmaxs4(v.y, lo1), hi1);
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
