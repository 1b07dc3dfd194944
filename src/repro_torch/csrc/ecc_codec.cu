// Block decode and encode of the in-place SEC-DED (64,57,1) code.
//
// Replaces the TPU kernels repro/kernels/ecc_decode.py::ecc_decode and
// repro/kernels/ecc_encode.py::ecc_encode. Both are bound by device memory:
// decode reads 8 bytes and writes 8 + 1 per block (encode 8 and 8), a few
// dozen integer operations in between. The design therefore moves each
// block as one 64-bit load and store, one block per thread in a
// grid-stride loop, with the code tables in constant memory.
//
// Plain C interface for ctypes: every entry point launches on the given
// stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

#include "secded64.cuh"

namespace {

__global__ void decode_kernel(const uint64_t* __restrict__ enc,
                              uint64_t* __restrict__ dec,
                              uint8_t* __restrict__ flags, int64_t nblk) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t f;
    dec[i] = secded64::decode(enc[i], &f);
    flags[i] = (uint8_t)f;
  }
}

__global__ void encode_kernel(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out, int64_t nblk) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < nblk;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[i] = secded64::encode(in[i]);
  }
}

int grid_for(int64_t nblk, int threads) {
  int64_t g = (nblk + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // enough resident blocks to fill an H100
  return (int)(g < cap ? (g > 0 ? g : 1) : cap);
}

}  // namespace

extern "C" int ecc_decode_launch(const void* enc, void* dec, void* flags,
                                 long long nblk, void* stream) {
  const int threads = 256;
  decode_kernel<<<grid_for(nblk, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)enc, (uint64_t*)dec, (uint8_t*)flags, nblk);
  return (int)cudaGetLastError();
}

extern "C" int ecc_encode_launch(const void* in, void* out, long long nblk,
                                 void* stream) {
  const int threads = 256;
  encode_kernel<<<grid_for(nblk, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, nblk);
  return (int)cudaGetLastError();
}
