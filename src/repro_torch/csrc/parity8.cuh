// Parity-per-byte ("Parity Zero") encode and decode of one 8-byte block,
// shared by the paged-attention kernels and the KV write of the port.
//
// The block is loaded as one little-endian uint64_t (byte e at bits
// 8e..8e+7); its check byte c holds the stored parity of byte e in bit e
// (repro_torch.core.ecc.encode_parity8). A byte whose parity differs from
// its stored bit decodes to 0 and counts as one bad byte: the scheme
// detects and zeroes, it never corrects and never reports a DUE.
#pragma once
#include <cstdint>

namespace parity8 {

// The check byte of block w (the encode): bit e is the parity of byte e.
// Three folds leave byte e's parity in bit 8e, and one multiply gathers
// bit 8e into bit 56 + e (the partial products land on distinct bits, so
// nothing carries).
__device__ __forceinline__ uint32_t check_byte(uint64_t w) {
  uint64_t x = w ^ (w >> 4);
  x ^= x >> 2;
  x ^= x >> 1;
  return (uint32_t)(((x & 0x0101010101010101ull) * 0x0102040810204080ull) >>
                    56);
}

// The bad bytes of block w under check byte c, as a mask (bit e: byte e).
__device__ __forceinline__ uint32_t bad_mask(uint64_t w, uint32_t c) {
  return (check_byte(w) ^ c) & 0xFFu;
}

// -> the block with every bad byte zeroed; *bad = the number of bad bytes.
// A clean block (the common case) costs the mask alone.
__device__ __forceinline__ uint64_t decode(uint64_t w, uint32_t c, int* bad) {
  const uint32_t m = bad_mask(w, c);
  *bad = __popc(m);
  if (!m) return w;
  uint64_t keep = ~0ull;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if ((m >> e) & 1u) keep &= ~(0xFFull << (8 * e));
  return w & keep;
}

}  // namespace parity8
