// In-place SEC-DED (64,57,1) block codec, shared by every kernel of the port.
//
// A block is 8 bytes loaded as one little-endian uint64_t: byte j sits at
// bits 8j..8j+7. Syndrome bit k is the parity of (word & ROWMASK[k]); an
// odd-weight syndrome names the one bit to flip (SYN2BIT), an even nonzero
// syndrome is a detected-uncorrectable double error (DUE). After correction
// bit 6 of bytes 0..6 is restored from bit 7 (the check bits sit there).
//
// The tables are the packed forms of repro_torch.core.ecc.ROWMASK64 and
// SYN2BIT; tests/test_torch_ecc.py parses this file and holds them equal.
#pragma once
#include <cstdint>

namespace secded64 {

__constant__ uint64_t ROWMASK[7] = {
    0x96349a32ad193977ull, 0xaa952a95352ada9bull, 0xcca6331999ccacadull,
    0xf0b83c1e5e0f0f0eull, 0xff003fe01fb00fb0ull, 0xffbfc0001fbfb000ull,
    0xffffbfbfa0000000ull};

// syndrome -> global bit to flip; 255 where the syndrome is not a column
__constant__ uint8_t SYN2BIT[128] = {
    255, 6, 14, 255, 22, 255, 255, 0, 30, 255, 255, 1, 255, 2, 3, 255,
    38, 255, 255, 4, 255, 5, 7, 255, 255, 8, 9, 255, 10, 255, 255, 11,
    46, 255, 255, 12, 255, 13, 15, 255, 255, 16, 17, 255, 18, 255, 255, 19,
    255, 20, 21, 255, 23, 255, 255, 24, 25, 255, 255, 26, 255, 27, 28, 255,
    54, 255, 255, 29, 255, 31, 32, 255, 255, 33, 34, 255, 35, 255, 255, 36,
    255, 37, 39, 255, 40, 255, 255, 41, 42, 255, 255, 43, 255, 44, 45, 255,
    255, 47, 48, 255, 49, 255, 255, 50, 51, 255, 255, 52, 255, 53, 55, 255,
    56, 255, 255, 57, 255, 58, 59, 255, 255, 60, 61, 255, 62, 255, 255, 63};

// bit 6 of bytes 0..6: where the check bits live
constexpr uint64_t CHECK_MASK = 0x0040404040404040ull;

// The seven check parities parity(w & ROWMASK[k]), each computed as the
// parity of the xor of the two masked 32-bit halves (one popcount per check
// bit: popc is a quarter-rate instruction on sm_90, and the fused matmul
// decodes every weight block once per use). Popcounts of 32 bits are at
// most 32, so they are summed into 6-bit fields without carries: parity k
// is bit 6k of *p03 (k = 0..3) or bit 6(k-4) of *p46 (k = 4..6).
__device__ __forceinline__ void parities(uint64_t w, uint32_t* p03,
                                         uint32_t* p46) {
  const uint32_t lo = (uint32_t)w, hi = (uint32_t)(w >> 32);
  uint32_t c[7];
#pragma unroll
  for (int k = 0; k < 7; ++k)
    c[k] = __popc((lo & (uint32_t)ROWMASK[k]) ^
                  (hi & (uint32_t)(ROWMASK[k] >> 32)));
  *p03 = c[0] + (c[1] << 6) + (c[2] << 12) + (c[3] << 18);
  *p46 = c[4] + (c[5] << 6) + (c[6] << 12);
}

// bit 0 of every 6-bit field: nonzero iff the syndrome is
constexpr uint32_t PARITY_BITS = 0x41041u;

// the 7-bit syndrome from the packed parities
__device__ __forceinline__ uint32_t pack_syndrome(uint32_t a, uint32_t b) {
  return (a & 1u) | ((a >> 5) & 2u) | ((a >> 10) & 4u) | ((a >> 15) & 8u) |
         ((b << 4) & 16u) | ((b >> 1) & 32u) | ((b >> 6) & 64u);
}

__device__ __forceinline__ uint32_t syndrome(uint64_t w) {
  uint32_t a, b;
  parities(w, &a, &b);
  return pack_syndrome(a, b);
}

__device__ __forceinline__ uint64_t restore_sign(uint64_t w) {
  return (w & ~CHECK_MASK) | ((w >> 1) & CHECK_MASK);
}

// Decode one block: corrected + sign-restored word; flags bit0 = single
// corrected, bit1 = DUE. A zero syndrome (the common case) is tested on
// the packed parities; the syndrome itself is assembled only for a fault.
__device__ __forceinline__ uint64_t decode(uint64_t w, uint32_t* flags) {
  uint32_t a, b;
  parities(w, &a, &b);
  uint32_t f = 0;
  if ((a | b) & PARITY_BITS) {
    const uint32_t s = pack_syndrome(a, b);
    const uint32_t single = __popc(s) & 1u;
    if (single) w ^= 1ull << SYN2BIT[s];
    f = single ? 1u : 2u;
  }
  *flags = f;
  return restore_sign(w);
}

// Encode one WOT-compliant block: zero bit 6 of bytes 0..6, then write the
// syndrome's bit i into bit 6 of byte i.
__device__ __forceinline__ uint64_t encode(uint64_t w) {
  w &= ~CHECK_MASK;
  uint32_t s = syndrome(w);
  uint64_t checks = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) checks |= (uint64_t)((s >> i) & 1u) << (8 * i + 6);
  return w | checks;
}

}  // namespace secded64
