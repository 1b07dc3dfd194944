// Parity-per-byte ("Parity Zero") decode of one 8-byte block, shared by the
// paged-attention kernels of the port.
//
// The block is loaded as one little-endian uint64_t (byte e at bits
// 8e..8e+7); its check byte c holds the stored parity of byte e in bit e
// (repro_torch.core.ecc.encode_parity8). A byte whose parity differs from
// its stored bit decodes to 0 and counts as one bad byte: the scheme
// detects and zeroes, it never corrects and never reports a DUE.
#pragma once
#include <cstdint>

namespace parity8 {

// -> the block with every bad byte zeroed; *bad = the number of bad bytes.
__device__ __forceinline__ uint64_t decode(uint64_t w, uint32_t c, int* bad) {
  uint64_t x = w ^ (w >> 4);  // after three folds bit 8e holds the parity
  x ^= x >> 2;                // of byte e (only bits of byte e reach it)
  x ^= x >> 1;
  uint64_t keep = 0;
  int n = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (((uint32_t)(x >> (8 * e)) ^ (c >> e)) & 1u)
      ++n;
    else
      keep |= 0xFFull << (8 * e);
  }
  *bad = n;
  return w & keep;
}

}  // namespace parity8
