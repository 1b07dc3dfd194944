// The WOT byte clamp of one 8-value int8 block, shared by every kernel of
// the port that throttles (throttle.cu, quant_throttle.cu, kv_write.cu).
//
// Positions 0..6 of a block are clamped to [-64, 63]; position 7 keeps the
// full int8 range. A block is 8 bytes loaded as one little-endian word:
// byte k sits in byte k % 4 of 32-bit half k / 4, so two per-byte signed
// max/min pairs (__vmaxs4/__vmins4) clamp it; the bounds of byte 7 are
// -128 and 127, which leave it as it is.
#pragma once
#include <cstdint>

namespace wot8 {

__device__ __forceinline__ uint32_t clamp_lo(uint32_t w) {  // bytes 0..3
  return __vmins4(__vmaxs4(w, 0xC0C0C0C0u), 0x3F3F3F3Fu);   // -64, 63
}

__device__ __forceinline__ uint32_t clamp_hi(uint32_t w) {  // bytes 4..7
  return __vmins4(__vmaxs4(w, 0x80C0C0C0u), 0x7F3F3F3Fu);   // byte 7 free
}

__device__ __forceinline__ uint64_t clamp(uint64_t w) {
  return (uint64_t)clamp_lo((uint32_t)w) |
         ((uint64_t)clamp_hi((uint32_t)(w >> 32)) << 32);
}

}  // namespace wot8
