// Fused in-place-ECC decode + matmul, every path of the TPU kernel
// repro/kernels/ecc_qmatmul.py::ecc_qmatmul:
//   float    out (M,N) f32   = a (M,K) f32|bf16 @ dequant(decode(w_enc)),
//   int8     out (M,N) int32 = a (M,K) int8 @ decode(w_enc)  (exact),
//   requant  out (M,N) f32|bf16|f16 = float(acc [+ bias]) * (a_scale*w_scale),
// with (corrected, DUE) counts over every weight block, and optionally the
// ABFT checksum pair (row sums of the accumulator against a @ rowsum(w),
// column sums against colsum(a) @ w), an activation-range clamp of the f32
// epilogue output with hits counted per row, and `fault_bits` XORed into
// accumulator element (0, 0) after the full-K accumulation.
//
// Bounds on the H100: at decode batch (M <= 32) the product does ~2M
// operations per weight byte, so it is bound by reading the encoded weight
// once (K*N bytes at 3.35 TB/s); at prefill batch (M in the thousands) it
// is bound by its 2MKN operations (989 TFLOP/s bf16, 1,979 TOP/s int8).
// Decoding in shared memory keeps decoded weights out of device memory, so
// protection adds no traffic in either regime.
//
// The wrapper (kernels/ecc_qmatmul.py::plan_launch) picks one of three
// regimes, a pure function of (M, N, K, a.dtype), and passes it here:
//
// * TC_SMALL, bf16 / int8 activations, M <= 32 (decode, burst): CTA tiles
//   of 16 (M <= 16; 3 stages, four CTAs an SM) or 32 (4 stages) rows x 128
//   columns, 4 warps (each all rows x 32 columns), split over K: at least
//   264 CTAs (2 per SM), then the split count that minimizes the busiest
//   SM's K tiles; e.g. (4, 4096, 4096): 32 strips x 16 splits. The encoded
//   tiles (64 K rows x 128 columns, 8 KB) stream through the cp.async ring
//   of 16-byte copies.
// * TC_LARGE, bf16 / int8 activations, M > 32 (prefill, calibration, int8
//   prefill): CTA tiles of 128 x 128 outputs (8 warps, each 64 x 32) over
//   64-row K tiles, in a 3-stage cp.async ring for both the encoded weight
//   tile and the activation tile; split over K too where the M x N tiles
//   alone leave the card unbalanced.
// * FMA, f32 activations (any M): the CUDA-core template (tensor cores
//   have no exact f32 path; TF32 stays off): a 256-thread CTA per strip of
//   64 columns and chunk of 4*RPT rows (RPT in {1, 2, 4, 8}) walks all of
//   K, staging the decoded tile as f32 and accumulating with FMAs.
//
// Tensor-core regimes, per K tile: cp.async lands the encoded tile and the
// activation tile, and every 64-bit block is decoded once into shared
// memory, in three steps per warp. (1) The syndrome test runs on the
// tensor cores: a binary mma.sync m16n8k256 .and.popc of 16 rows of 4
// blocks against the 7 check masks gives popc(block & ROWMASK[k]) for 64
// blocks in 4 instructions; the integer pipe, which bounds the decode at
// decode batch, would need 7 quarter-rate popcounts per block. (2) Every
// codeword (no odd count) has its sign bits restored with no branch: the
// float path stores the value dequantized and rounded to bf16 (the plain
// version's `(q * w_scale).to(a.dtype)`, so the MMA inputs are exactly the
// plain version's values; int8 -> float is exact through the 2^23
// magic-number trick), the int paths store int8 back in place and then
// transpose it to words of four K rows ([K/4][N] words, the s8 B
// fragment's layout). (3) Rarely, a warp with a flagged block runs the
// exact decode (secded64.cuh) on it, which corrects and counts it. Then
// mma.sync m16n8k16 bf16 -> f32 (A from ldmatrix, B from ldmatrix.trans)
// or m16n8k32 s8 -> s32 (exact, so every int path is byte-equal to the
// plain version). Shared-memory rows are padded to an odd number of
// 16-byte units (bank-conflict-free ldmatrix).
//
// Split-K is deterministic: each split writes its raw accumulator tile to
// its slice of an (splits, M, N) workspace the wrapper allocates, and the
// finish pass adds the slices in split order (f32: fixed order, so a
// repeated launch is bit-equal; int32: exact). No f32 atomics touch the
// output. The finish pass also runs everything that needs the full-K sum:
// `fault_bits`, the accumulator's ABFT row and column sums, + bias, the
// requantize (scale product first, every step rounded to nearest with
// __fmul_rn: no FMA contraction), the clamp and its hit counts, and the
// round-to-nearest-even cast. Without any of those and with one split the
// main kernel writes the f32 / int32 output directly.
//
// Flags: a weight block is decoded by every CTA of its column strip and K
// range, but counted only by the CTAs of the first M tile, and the K
// ranges partition [0, K) in whole 64-row tiles, so (corrected, DUE) never
// depends on M or on the plan. With a finish pass each counting CTA stores
// its sums in its own slot and the finish pass adds them, so an unguarded
// call is two launches (no zeroing launch); without one they are added
// into zeroed flags with integer atomics.
//
// ABFT: the reference sums a @ rowsum(w) and colsum(a) @ w (and, on the
// float path, |a| @ |w| beside them) are linear, so every CTA adds its
// tile's partials per K tile and flushes them once: f32 partials added
// across CTAs in f64 (order noise far below the 1e-4 tolerance), int
// partials in `unsigned`, which wraps modulo 2^32 (defined, order-free)
// like the reference's int32 arithmetic. The finish pass adds the
// accumulator's row and column sums the same way; a last launch compares:
// rows into rows[:, 0], mismatched columns counted into col_mm.
//
// Edge tiles are masked (rows past K and blocks past N load as zeros,
// which decode to 0 with no flag; activation rows past M are 0), so only
// N % 8 == 0 is required; rows of `a` or `w_enc` that are not 16-byte
// aligned are copied 8 bytes (weight) or one element (activation) at a
// time.
//
// Known limits, kept for later: mma.sync, not wgmma with TMA; the decode
// and the MMA of one CTA alternate (two to four CTAs an SM overlap them);
// at prefill every M tile decodes its weight tiles again (64 times at
// M = 8,192), and the 64 x 32 warp tiles re-read shared memory more than
// larger ones would; the f32 route runs on CUDA cores.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "mma_sm90.cuh"
#include "secded64.cuh"

namespace {

using namespace mma_sm90;

constexpr int TK = 64;  // weight rows per K tile (split-K ranges are whole tiles)
constexpr double ABFT_RTOL = 1e-4;  // repro/kernels/ecc_qmatmul.py:82-83
constexpr double ABFT_ATOL = 1e-6;

enum AKind { A_F32 = 0, A_BF16 = 1, A_I8 = 2 };
enum OutKind { OUT_F32 = 0, OUT_I32 = 1, OUT_BF16 = 2, OUT_F16 = 3 };
enum Regime { FMA = 0, TC_SMALL = 1, TC_LARGE = 2 };

struct Args {
  const void* a;
  const uint8_t* w_enc;
  const float* w_scale;   // f32 scalar (unused on the raw int8 path)
  const float* a_scale;   // requantize: (M,) (stride 1) or scalar (stride 0)
  int a_scale_stride;
  const int* bias;        // (N,) int32 or null
  const float* clamp;     // f32 scalar or null
  void* out;
  int out_kind;
  int* flags;             // (2,) int32
  int* rows;              // (M, 2) int32 or null
  void* rbuf;             // ABFT row sums or null
  void* cbuf;             // ABFT column sums
  void* part;             // (splits, M, N) accumulators, or null: write out
  int* flag_part;         // per counting CTA (corrected, DUE), or null: atomics
  int flag_n;             // entries of flag_part
  int fin_rows;           // rows per CTA of the finish pass
  int M, N, K;
  int splits;
  int a_vec;              // rows of a are 16-byte aligned
  int w_vec;              // rows of w_enc are 16-byte aligned
  unsigned fault_bits;
};

template <bool INT>
using AccT = typename std::conditional<INT, int, float>::type;
// checksum partials: unsigned (wrapping) or f32
template <bool INT>
using ChkT = typename std::conditional<INT, unsigned, float>::type;

// this CTA's K tiles [t0, t1) of split `s`: the splits partition the tiles
__device__ __forceinline__ void k_tiles(const Args& p, int s, int* t0,
                                        int* t1) {
  const int nt = (p.K + TK - 1) / TK;
  *t0 = (int)((int64_t)s * nt / p.splits);
  *t1 = (int)((int64_t)(s + 1) * nt / p.splits);
}

// add this CTA's reference checksum partials (row m, column n; -1: none)
template <bool INT>
__device__ __forceinline__ void flush_ref_sums(const Args& p, int m, int n,
                                               ChkT<INT> rref, float rsc,
                                               ChkT<INT> cref, float csc) {
  if constexpr (INT) {
    if (m >= 0) atomicAdd(&static_cast<unsigned*>(p.rbuf)[p.M + m], rref);
    if (n >= 0) atomicAdd(&static_cast<unsigned*>(p.cbuf)[p.N + n], cref);
  } else {
    double* rb = static_cast<double*>(p.rbuf);
    double* cb = static_cast<double*>(p.cbuf);
    if (m >= 0) {
      atomicAdd(&rb[p.M + m], (double)rref);
      atomicAdd(&rb[2 * p.M + m], (double)rsc);
    }
    if (n >= 0) {
      atomicAdd(&cb[p.N + n], (double)cref);
      atomicAdd(&cb[2 * p.N + n], (double)csc);
    }
  }
}

// (corrected, DUE) counted per thread: added once per warp into the zeroed
// flags, or (flag_part) summed over the CTA and stored in its slot, which
// the finish pass adds up (the output then needs no zeroing launch)
__device__ __forceinline__ void flush_flags(const Args& p, int c1, int c2) {
  c1 = __reduce_add_sync(0xffffffffu, c1);
  c2 = __reduce_add_sync(0xffffffffu, c2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p.flag_part == nullptr) {
    if (lane == 0) {
      if (c1) atomicAdd(&p.flags[0], c1);
      if (c2) atomicAdd(&p.flags[1], c2);
    }
    return;
  }
  __shared__ int part[2][32];
  if (lane == 0) {
    part[0][warp] = c1;
    part[1][warp] = c2;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    int s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += part[threadIdx.x][w];
    p.flag_part[2 * (blockIdx.z * gridDim.x + blockIdx.x) + threadIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// tensor-core regimes (bf16 and int8 activations)
// ---------------------------------------------------------------------------

template <int AK, int BM, int WM, int WN, int STAGES, int MINB>
struct Tc {
  static constexpr bool INT = AK == A_I8;
  static constexpr int TN = 128;                 // output columns per CTA
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WARPS = WM * WN;
  static constexpr int WTM = BM / WM, WTN = TN / WN;  // one warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // its m16 / n8 tiles
  static constexpr int ES = INT ? 1 : 2;         // bytes per activation
  static constexpr int A_LD = TK + 16 / ES;      // padded row, elements
  static constexpr int A_BYTES = BM * A_LD * ES;
  static constexpr int ENC_BYTES = TK * TN;      // encoded tile, unpadded
  static constexpr int STAGE_BYTES = ENC_BYTES + A_BYTES;
  // decoded tile: bf16 [TK][W_LD], or int8 words of 4 K rows [TK/4][W_LD]
  static constexpr int W_LD = TN + 8;
  static constexpr int W_BYTES = INT ? (TK / 4) * W_LD * 4 : TK * W_LD * 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + W_BYTES;
  // the weight-tile loops have fixed trip counts
  static_assert(TK * TN / 16 % THREADS == 0 && (TK / 4) % WARPS == 0,
                "THREADS must divide the tile's copies and row-groups");
};

// float(q) * scale for the int8 in byte e of u (bytes pre-biased by 0x80):
// 0x4B0000uu is 2^23 + u exactly, so the subtraction is exact
__device__ __forceinline__ float dequant(uint32_t u, int e, float scale) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | e));
  return __fmul_rn(__fsub_rn(f, 8388736.f), scale);
}

template <int AK, int BM, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB) tc_kernel(Args p) {
  using C = Tc<AK, BM, WM, WN, STAGES, MINB>;
  constexpr bool INT = C::INT;
  constexpr int TN = C::TN, THREADS = C::THREADS;
  using Acc = AccT<INT>;
  using Chk = ChkT<INT>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Wd = smem + STAGES * C::STAGE_BYTES;
  __shared__ Acc wsum[TK], asum[TK];    // per-tile row sums of w, col sums of a
  __shared__ float wabs[TK], aabs[TK];

  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
  int t0, t1;
  k_tiles(p, blockIdx.z, &t0, &t1);
  const int ntiles = t1 - t0;
  const bool abft = p.rbuf != nullptr;
  const float scale = INT ? 0.f : *p.w_scale;

  // every loop over a tile has a fixed trip count (THREADS divides it),
  // so each thread's offsets inside the tile are loop-invariant
  auto load = [&](int t, int st) {
    const int k0 = (t0 + t) * TK;
    unsigned char* e = smem + st * C::STAGE_BYTES;
    if (p.w_vec) {
      constexpr int CPR = TN / 16;  // 16-byte copies per row
#pragma unroll
      for (int j = 0; j < TK * CPR / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / CPR, c = i % CPR;
        const int k = k0 + r, n = n0 + 16 * c;
        const bool in = k < K && n < N;
        cp_async16(e + r * TN + 16 * c,
                   in ? p.w_enc + (int64_t)k * N + n : p.w_enc, in);
      }
    } else {
      constexpr int CPR = TN / 8;   // 8-byte copies per row
#pragma unroll
      for (int j = 0; j < TK * CPR / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / CPR, c = i % CPR;
        const int k = k0 + r, n = n0 + 8 * c;
        const bool in = k < K && n < N;
        cp_async8(e + r * TN + 8 * c,
                  in ? p.w_enc + (int64_t)k * N + n : p.w_enc, in);
      }
    }
    unsigned char* as = e + C::ENC_BYTES;
    const unsigned char* A = static_cast<const unsigned char*>(p.a);
    if (p.a_vec) {
      constexpr int PER = 16 / C::ES;  // activations per 16-byte copy
      constexpr int CPR = TK / PER;
      constexpr int COPIES = BM * CPR;   // may be fewer than THREADS
#pragma unroll
      for (int j = 0; j < (COPIES + THREADS - 1) / THREADS; ++j) {
        const int i = tid + j * THREADS;
        if (COPIES % THREADS != 0 && i >= COPIES) break;
        const int r = i / CPR, c = i % CPR;
        const int m = m0 + r, k = k0 + PER * c;
        const bool in = m < M && k < K;
        cp_async16(as + (r * C::A_LD + PER * c) * C::ES,
                   in ? A + ((int64_t)m * K + k) * C::ES : A, in);
      }
    } else {  // unaligned rows: element by element, synchronously
      for (int i = tid; i < BM * TK; i += THREADS) {
        const int r = i / TK, c = i % TK;
        const int m = m0 + r, k = k0 + c;
        const bool in = m < M && k < K;
        if constexpr (INT)
          as[r * C::A_LD + c] = in ? A[(int64_t)m * K + k] : 0;
        else
          reinterpret_cast<uint16_t*>(as)[r * C::A_LD + c] =
              in ? reinterpret_cast<const uint16_t*>(A)[(int64_t)m * K + k]
                 : 0;
      }
    }
  };

  // The syndrome test on the tensor cores: a row-group is 4 tile rows x
  // 16 blocks = 64 blocks, read as 16 rows of 256 bits (4 blocks each);
  // mma m16n8k256 .b1 .and.popc against 32 columns (mask k at 64-bit slot
  // p: 7 masks + one zero column, 4 slots) gives popc(block & ROWMASK[k])
  // for every block. Lane (g, t) receives the 8 counts of blocks
  // 64*rg + lane (rows g) and 64*rg + 32 + lane (rows g + 8); a block with
  // no odd count is a codeword, and only the others take the exact decode
  // (secded64.cuh), which corrects and counts them.
  uint32_t bm0[4], bm1[4];  // the B fragments: column g, bits 32*t4 .. +31
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 2 * j + (g & 1), slot = g >> 1;
    const uint64_t mk = k < 7 ? secded64::ROWMASK[k] : 0ull;
    const uint32_t word = (t4 & 1) ? (uint32_t)(mk >> 32) : (uint32_t)mk;
    bm0[j] = (t4 >> 1) == slot ? word : 0u;
    bm1[j] = 2 + (t4 >> 1) == slot ? word : 0u;
  }
  int c1 = 0, c2 = 0;
  constexpr int NRG = TK / 4 / C::WARPS;  // row-groups per warp and tile
  // one decoded block into the decoded tile (float: dequantized bf16) or
  // back in place (int: transposed below)
  auto put = [&](unsigned char* e, int blk, uint64_t w) {
    const int kr = blk >> 4, jb = blk & 15;
    if constexpr (INT) {
      *reinterpret_cast<uint64_t*>(e + kr * TN + 8 * jb) = w;
    } else {
      const uint32_t lo = (uint32_t)w ^ 0x80808080u;
      const uint32_t hi = (uint32_t)(w >> 32) ^ 0x80808080u;
      uint4 v;
      v.x = pack_bf16(dequant(lo, 0, scale), dequant(lo, 1, scale));
      v.y = pack_bf16(dequant(lo, 2, scale), dequant(lo, 3, scale));
      v.z = pack_bf16(dequant(hi, 0, scale), dequant(hi, 1, scale));
      v.w = pack_bf16(dequant(hi, 2, scale), dequant(hi, 3, scale));
      *reinterpret_cast<uint4*>(Wd + (kr * C::W_LD + 8 * jb) * 2) = v;
    }
  };
  auto decode_tile = [&](unsigned char* e) {
    // 1. the syndrome test of this warp's row-groups
    unsigned odd = 0;  // bit 2i + h: block 64*rg_i + 32*h + lane
#pragma unroll
    for (int i = 0; i < NRG; ++i) {
      const int rg = warp + i * C::WARPS;
      uint32_t a[4];
      ldmatrix_x4(a, e + (16 * rg + (lane & 15)) * 32 + (lane >> 4) * 16);
      int d[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
        mma_b1(d[j], a, bm0[j], bm1[j]);
      }
      odd |= (unsigned)((d[0][0] | d[0][1] | d[1][0] | d[1][1] | d[2][0] |
                         d[2][1] | d[3][0] | d[3][1]) & 1) << (2 * i);
      odd |= (unsigned)((d[0][2] | d[0][3] | d[1][2] | d[1][3] | d[2][2] |
                         d[2][3] | d[3][2] | d[3][3]) & 1) << (2 * i + 1);
    }
    // 2. every codeword: restore the sign bits (no branch); a flagged
    //    block is left for 3 (int: its encoded word stays in place)
#pragma unroll
    for (int i = 0; i < NRG; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int blk = 64 * (warp + i * C::WARPS) + 32 * h + lane;
        const uint64_t w = secded64::restore_sign(
            *reinterpret_cast<const uint64_t*>(e + (blk >> 4) * TN +
                                               8 * (blk & 15)));
        if (!INT || !((odd >> (2 * i + h)) & 1)) put(e, blk, w);
      }
    // 3. rare: the exact decode corrects and counts the flagged blocks
    if (__any_sync(0xffffffffu, odd)) {
      for (int i = 0; i < NRG; ++i)
        for (int h = 0; h < 2; ++h) {
          if (!((odd >> (2 * i + h)) & 1)) continue;
          const int blk = 64 * (warp + i * C::WARPS) + 32 * h + lane;
          uint32_t f;
          const uint64_t w = secded64::decode(
              *reinterpret_cast<const uint64_t*>(e + (blk >> 4) * TN +
                                                 8 * (blk & 15)),
              &f);
          c1 += f & 1u;
          c2 += f >> 1;
          put(e, blk, w);
        }
    }
    if constexpr (INT) {
      // transpose rows 4rg .. 4rg+3 into words of 4 K rows: lane (half,
      // jb) takes bytes 4*half .. 4*half+3 of block column jb, so column
      // c's word holds its 4 K rows, lowest row in the lowest byte
      __syncwarp();
      const int jb = lane & 15, half = lane >> 4;
#pragma unroll
      for (int i = 0; i < NRG; ++i) {
        const int rg = warp + i * C::WARPS;
        uint32_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          r[q] = *reinterpret_cast<const uint32_t*>(
              e + (4 * rg + q) * TN + 8 * jb + 4 * half);
        const uint32_t a01 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t a23 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t b01 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t b23 = __byte_perm(r[2], r[3], 0x7362);
        const uint4 x = {__byte_perm(a01, a23, 0x5410),
                         __byte_perm(a01, a23, 0x7632),
                         __byte_perm(b01, b23, 0x5410),
                         __byte_perm(b01, b23, 0x7632)};
        *reinterpret_cast<uint4*>(reinterpret_cast<uint32_t*>(Wd) +
                                  rg * C::W_LD + 8 * jb + 4 * half) = x;
      }
    }
  };
  auto wval = [&](int kr, int c) -> Acc {
    if constexpr (INT)
      return (int)(int8_t)(reinterpret_cast<const uint32_t*>(
                               Wd)[(kr >> 2) * C::W_LD + c] >>
                           (8 * (kr & 3)));
    else
      return __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(Wd)[kr * C::W_LD + c]);
  };
  auto aval = [&](const unsigned char* as, int r, int kk) -> Acc {
    if constexpr (INT)
      return (int)(int8_t)as[r * C::A_LD + kk];
    else
      return __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(as)[r * C::A_LD + kk]);
  };

  Acc acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  Chk rref = 0, cref = 0;      // thread tid < BM: row; tid < TN: column
  float rsc = 0.f, csc = 0.f;  // float path: the |a| @ |w| scales

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t-1
    if (t + STAGES - 1 < ntiles)
      load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    unsigned char* e = smem + (t % STAGES) * C::STAGE_BYTES;
    const unsigned char* as = e + C::ENC_BYTES;
    decode_tile(e);
    __syncthreads();
    if (abft) {
      if (tid < TK) {
        Acc s = 0, u = 0;
        float sa = 0.f, ua = 0.f;
        for (int i = 0; i < TN; ++i) {
          const Acc v = wval(tid, (i + tid) & (TN - 1));  // rotate banks
          s += v;
          if constexpr (!INT) sa += fabsf(v);
        }
        for (int r = 0; r < BM; ++r) {
          const Acc v = aval(as, r, tid);
          u += v;
          if constexpr (!INT) ua += fabsf(v);
        }
        wsum[tid] = s;
        asum[tid] = u;
        wabs[tid] = sa;
        aabs[tid] = ua;
      }
      __syncthreads();
      if (tid < BM) {
        for (int i = 0; i < TK; ++i) {
          const int kk = (i + tid) & (TK - 1);
          const Acc av = aval(as, tid, kk);
          if constexpr (INT) {
            rref += (unsigned)(av * wsum[kk]);  // |.| < 2^22: no overflow
          } else {
            rref = fmaf(av, wsum[kk], rref);
            rsc = fmaf(fabsf(av), wabs[kk], rsc);
          }
        }
      }
      if (tid < TN) {
        for (int kk = 0; kk < TK; ++kk) {
          const Acc wv = wval(kk, tid);
          if constexpr (INT) {
            cref += (unsigned)(asum[kk] * wv);  // |.| < 2^22
          } else {
            cref = fmaf(asum[kk], wv, cref);
            csc = fmaf(aabs[kk], fabsf(wv), csc);
          }
        }
      }
    }
    if constexpr (INT) {
      const uint32_t* wi = reinterpret_cast<const uint32_t*>(Wd);
#pragma unroll
      for (int ks = 0; ks < TK / 32; ++ks) {
        uint32_t af[C::MT][4];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
          ldmatrix_x4(af[i], as + (wm * C::WTM + i * 16 + (lane & 15)) *
                                      C::A_LD +
                                  ks * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          const int n = wn * C::WTN + j * 8 + g;
          const uint32_t b0 = wi[(ks * 8 + t4) * C::W_LD + n];
          const uint32_t b1 = wi[(ks * 8 + 4 + t4) * C::W_LD + n];
#pragma unroll
          for (int i = 0; i < C::MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
        }
      }
    } else {
      const __nv_bfloat16* wd = reinterpret_cast<const __nv_bfloat16*>(Wd);
      const __nv_bfloat16* a16 = reinterpret_cast<const __nv_bfloat16*>(as);
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        uint32_t af[C::MT][4];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
          ldmatrix_x4(af[i], a16 + (wm * C::WTM + i * 16 + (lane & 15)) *
                                       C::A_LD +
                                   ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j2 = 0; j2 < C::NT / 2; ++j2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, wd + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          C::W_LD +
                     wn * C::WTN + j2 * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            mma_bf16(acc[i][2 * j2], af[i], b[0], b[1]);
            mma_bf16(acc[i][2 * j2 + 1], af[i], b[2], b[3]);
          }
        }
      }
    }
  }

  // the raw accumulator: to `out` (one split, no epilogue) or to this
  // split's slice of the workspace
  Acc* dst = p.part ? static_cast<Acc*>(p.part) +
                          (int64_t)blockIdx.z * M * N
                    : static_cast<Acc*>(p.out);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::WTM + i * 16 + g + 8 * h;
        const int n = n0 + wn * C::WTN + j * 8 + 2 * t4;
        if (m < M && n < N) {  // N % 8 == 0: n + 1 < N too
          using Acc2 = typename std::conditional<INT, int2, float2>::type;
          *reinterpret_cast<Acc2*>(dst + (int64_t)m * N + n) =
              Acc2{acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        }
      }
  if (abft)
    flush_ref_sums<INT>(p, tid < BM && m0 + tid < M ? m0 + tid : -1,
                        tid < TN && n0 + tid < N ? n0 + tid : -1, rref, rsc,
                        cref, csc);
  if (blockIdx.y == 0) flush_flags(p, c1, c2);
}

// ---------------------------------------------------------------------------
// FMA regime (f32 activations)
// ---------------------------------------------------------------------------

constexpr int FMA_BN = 64;        // output columns per CTA (8 ECC blocks)
constexpr int FMA_THREADS = 256;  // 64 columns x 4 row groups
constexpr int FMA_RG = FMA_THREADS / FMA_BN;

template <int RPT>
__global__ void __launch_bounds__(FMA_THREADS) fma_kernel(Args p) {
  constexpr int MC = FMA_RG * RPT;
  constexpr int BN = FMA_BN;
  __shared__ float wf[TK * BN];   // decoded, dequantized weight tile
  __shared__ float af[MC * TK];   // activation tile
  __shared__ float wsum[TK], asum[TK], wabs[TK], aabs[TK];
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int mc0 = blockIdx.y * MC;
  const bool abft = p.rbuf != nullptr;
  const float* A = static_cast<const float*>(p.a);
  const float scale = *p.w_scale;

  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  float rref = 0.f, cref = 0.f;  // thread tid < MC: row; tid < BN: column
  float rsc = 0.f, csc = 0.f;    // the |a| @ |w| scales
  int c1 = 0, c2 = 0;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // decode the (TK, BN) weight tile: TK*8 blocks
    for (int b = tid; b < TK * (BN / 8); b += FMA_THREADS) {
      const int kr = b / (BN / 8), jb = b % (BN / 8);
      const int k = k0 + kr, n = n0 + 8 * jb;
      const bool valid = k < K && n < N;
      uint64_t w = valid ? *reinterpret_cast<const uint64_t*>(
                               p.w_enc + (int64_t)k * N + n)
                         : 0ull;
      uint32_t f;
      w = secded64::decode(w, &f);
      c1 += f & 1u;
      c2 += f >> 1;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        wf[kr * BN + 8 * jb + e] =
            (float)(int8_t)((w >> (8 * e)) & 0xFFull) * scale;
    }
    // stage the (MC, TK) activation tile; rows past M and K read as 0
    for (int idx = tid; idx < MC * TK; idx += FMA_THREADS) {
      const int r = idx / TK, c = idx % TK;
      const int m = mc0 + r, k = k0 + c;
      af[r * TK + c] = (m < M && k < K) ? A[(int64_t)m * K + k] : 0.f;
    }
    __syncthreads();
    if (abft) {
      if (tid < TK) {
        float s = 0.f, t = 0.f, sa = 0.f, ta = 0.f;
        for (int i = 0; i < BN; ++i) {
          const float v = wf[tid * BN + ((i + tid) & (BN - 1))];
          s += v;
          sa += fabsf(v);
        }
        for (int r = 0; r < MC; ++r) {
          const float v = af[r * TK + tid];
          t += v;
          ta += fabsf(v);
        }
        wsum[tid] = s;
        asum[tid] = t;
        wabs[tid] = sa;
        aabs[tid] = ta;
      }
      __syncthreads();
      if (tid < MC) {
        for (int i = 0; i < TK; ++i) {
          const int kk = (i + tid) & (TK - 1);
          const float av = af[tid * TK + kk];
          rref = fmaf(av, wsum[kk], rref);
          rsc = fmaf(fabsf(av), wabs[kk], rsc);
        }
      }
      if (tid < BN) {
        for (int kk = 0; kk < TK; ++kk) {
          const float wv = wf[kk * BN + tid];
          cref = fmaf(asum[kk], wv, cref);
          csc = fmaf(aabs[kk], fabsf(wv), csc);
        }
      }
    }
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      const float wv = wf[kk * BN + col];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        acc[j] = fmaf(af[(rg + FMA_RG * j) * TK + kk], wv, acc[j]);
    }
    __syncthreads();
  }

  float* dst = static_cast<float*>(p.part ? p.part : p.out);
  const int n = n0 + col;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = mc0 + rg + FMA_RG * j;
    if (m < M && n < N) dst[(int64_t)m * N + n] = acc[j];
  }
  if (abft)
    flush_ref_sums<false>(p, tid < MC && mc0 + tid < M ? mc0 + tid : -1,
                          tid < BN && n0 + tid < N ? n0 + tid : -1, rref, rsc,
                          cref, csc);
  if (blockIdx.y == 0) flush_flags(p, c1, c2);
}

// ---------------------------------------------------------------------------
// finish pass: the split sum and everything after the full-K accumulation
// ---------------------------------------------------------------------------

constexpr int FIN_THREADS = 256;  // one column each
constexpr int FIN_ROWS = 32;      // rows per CTA

template <bool INT>
__global__ void __launch_bounds__(FIN_THREADS) finish_kernel(Args p) {
  using Acc = AccT<INT>;
  using Chk = ChkT<INT>;
  __shared__ Chk rpart[FIN_THREADS / 32][FIN_ROWS];
  __shared__ int hits[FIN_ROWS];
  const int M = p.M, N = p.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * FIN_THREADS + tid;
  const int m0 = blockIdx.y * p.fin_rows;
  const int nrows = min(p.fin_rows, M - m0);
  const bool ncol = n < N;
  const bool abft = p.rbuf != nullptr;
  const bool requant = INT && p.a_scale != nullptr;
  const bool has_clamp = p.clamp != nullptr;
  const float c = has_clamp ? *p.clamp : 0.f;
  const float ws = requant ? *p.w_scale : 0.f;
  const int bias = (requant && p.bias != nullptr && ncol) ? p.bias[n] : 0;
  const Acc* part = static_cast<const Acc*>(p.part);
  const int64_t slice = (int64_t)M * N;
  if (tid < FIN_ROWS) hits[tid] = 0;
  __syncthreads();
  Chk csum = 0;
  for (int r = 0; r < nrows; ++r) {
    const int m = m0 + r;
    const int64_t o = (int64_t)m * N + n;
    Acc acc = 0;
    if (ncol) {  // the splits in order: a fixed f32 sum, an exact int sum
      if constexpr (INT) {
        unsigned u = 0;
        for (int s = 0; s < p.splits; ++s) u += (unsigned)part[s * slice + o];
        acc = (int)u;
      } else {
        acc = part[o];
        for (int s = 1; s < p.splits; ++s) acc += part[s * slice + o];
      }
    }
    // an injected fault in accumulator element (0, 0), before every check
    if (p.fault_bits && m == 0 && n == 0) {
      if constexpr (INT)
        acc = (int)((unsigned)acc ^ p.fault_bits);
      else
        acc = __int_as_float(__float_as_int(acc) ^ (int)p.fault_bits);
    }
    if (abft) {
      csum += (Chk)acc;
      Chk rs = (Chk)acc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) rpart[warp][r] = rs;
    }
    if (INT && !requant) {  // uniform
      if (ncol) static_cast<int*>(p.out)[o] = (int)acc;
      continue;
    }
    float res;
    if constexpr (INT) {
      const int v = (int)((unsigned)acc + (unsigned)bias);
      const float s = __fmul_rn(p.a_scale[(int64_t)m * p.a_scale_stride], ws);
      res = __fmul_rn(__int2float_rn(v), s);
    } else {
      res = acc;
    }
    if (has_clamp) {
      const bool hit = ncol && fabsf(res) > c;  // NaN: no hit, kept
      if (hit) res = res > 0.f ? c : -c;
      const int h = __reduce_add_sync(0xffffffffu, hit ? 1 : 0);
      if (lane == 0 && h) atomicAdd(&hits[r], h);
    }
    if (!ncol) continue;
    switch (p.out_kind) {
      case OUT_BF16:
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(res);
        break;
      case OUT_F16:
        static_cast<__half*>(p.out)[o] = __float2half_rn(res);
        break;
      default:
        static_cast<float*>(p.out)[o] = res;
    }
  }
  __syncthreads();
  if (abft) {
    Chk s = 0;
    if (tid < nrows)
      for (int w = 0; w < FIN_THREADS / 32; ++w) s += rpart[w][tid];
    if constexpr (INT) {
      if (ncol) atomicAdd(&static_cast<unsigned*>(p.cbuf)[n], csum);
      if (tid < nrows) atomicAdd(&static_cast<unsigned*>(p.rbuf)[m0 + tid], s);
    } else {
      if (ncol) atomicAdd(&static_cast<double*>(p.cbuf)[n], (double)csum);
      if (tid < nrows)
        atomicAdd(&static_cast<double*>(p.rbuf)[m0 + tid], (double)s);
    }
  }
  if (has_clamp && tid < nrows && hits[tid])
    atomicAdd(&p.rows[2 * (m0 + tid) + 1], hits[tid]);
  if (p.flag_part != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
    __shared__ int fsum[2][FIN_THREADS / 32];
    int f1 = 0, f2 = 0;
    for (int i = tid; i < p.flag_n / 2; i += FIN_THREADS) {
      f1 += p.flag_part[2 * i];
      f2 += p.flag_part[2 * i + 1];
    }
    f1 = __reduce_add_sync(0xffffffffu, f1);
    f2 = __reduce_add_sync(0xffffffffu, f2);
    if (lane == 0) {
      fsum[0][warp] = f1;
      fsum[1][warp] = f2;
    }
    __syncthreads();
    if (tid < 2) {
      int s = 0;
      for (int w = 0; w < FIN_THREADS / 32; ++w) s += fsum[tid][w];
      p.flags[tid] = s;
    }
  }
}

// compare the summed checksums: rows[:, 0] per row, mismatched columns
// counted into *col_mm
template <bool INT>
__global__ void abft_compare_kernel(const void* rbuf, const void* cbuf,
                                    int* rows, int* col_mm, int M, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  auto bad = [&](const void* buf, int len, int idx) -> bool {
    if constexpr (INT) {
      const unsigned* b = static_cast<const unsigned*>(buf);
      return b[idx] != b[len + idx];
    } else {
      const double* b = static_cast<const double*>(buf);
      return fabs(b[idx] - b[len + idx]) > ABFT_ATOL + ABFT_RTOL * b[2 * len + idx];
    }
  };
  if (i < M) rows[2 * i] = bad(rbuf, M, i) ? 1 : 0;
  if (i < N && bad(cbuf, N, i)) atomicAdd(col_mm, 1);
}

template <int AK, int BM, int WM, int WN, int STAGES, int MINB>
cudaError_t launch_tc(const Args& p, cudaStream_t s) {
  using C = Tc<AK, BM, WM, WN, STAGES, MINB>;
  static_assert(C::THREADS >= BM && C::THREADS >= C::TN && C::THREADS >= TK,
                "the ABFT sums take a row, a column and a K row a thread");
  auto kern = tc_kernel<AK, BM, WM, WN, STAGES, MINB>;
  static bool attr = false;  // set once per instantiation and process
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((p.N + C::TN - 1) / C::TN, (p.M + BM - 1) / BM, p.splits);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(p);
  return cudaSuccess;
}

template <int AK>
cudaError_t launch_regime(const Args& p, int regime, cudaStream_t s) {
  if (regime == TC_SMALL && p.M <= 16)
    return launch_tc<AK, 16, 1, 4, 3, 4>(p, s);
  if (regime == TC_SMALL) return launch_tc<AK, 32, 1, 4, 4, 3>(p, s);
  return launch_tc<AK, 128, 2, 4, 3, 2>(p, s);
}

template <int RPT>
void launch_fma(const Args& p, cudaStream_t s) {
  constexpr int MC = FMA_RG * RPT;
  dim3 grid((p.N + FMA_BN - 1) / FMA_BN, (p.M + MC - 1) / MC);
  fma_kernel<RPT><<<grid, FMA_THREADS, 0, s>>>(p);
}

}  // namespace

// a_kind: AKind; out_kind: OutKind; regime: Regime (FMA iff a_kind is
// f32); splits: K splits (1 .. ceil(K/64); 1 for FMA). a_scale, bias,
// clamp, rows, rbuf, cbuf and col_mm may be null (rbuf/cbuf/col_mm
// together: ABFT off). rbuf/cbuf hold 2*M / 2*N unsigned (int paths) or
// 3*M / 3*N doubles (float path), zeroed; flags, rows and col_mm are zeroed
// by the caller. part: a (splits, M, N) f32 (float) or int32 (int paths)
// workspace, non-null exactly when splits > 1 or a_scale, rbuf, clamp or
// fault_bits is set (the finish pass runs); flag_part: 2 * ceil(N/128) *
// splits int32, non-null exactly when the finish pass runs on a tensor-core
// regime (the finish pass then writes flags, which need no zeroing).
extern "C" int ecc_qmatmul_launch(const void* a, int a_kind, const void* w_enc,
                                  const void* w_scale, const void* a_scale,
                                  int a_scale_stride, const void* bias,
                                  const void* clamp, void* out, int out_kind,
                                  void* flags, void* rows, void* rbuf,
                                  void* cbuf, void* col_mm, int M, int N,
                                  int K, unsigned fault_bits, int regime,
                                  int splits, void* part, void* flag_part,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ktiles = (K + TK - 1) / TK;
  const bool finish = splits > 1 || a_scale != nullptr || rbuf != nullptr ||
                      clamp != nullptr || fault_bits != 0;
  const bool fma = a_kind == A_F32;
  if (M < 1 || N < 1 || K < 0 || N % 8 || splits < 1 ||
      splits > (ktiles > 1 ? ktiles : 1) || finish != (part != nullptr) ||
      (finish && !fma) != (flag_part != nullptr) ||
      fma != (regime == FMA) || (fma && splits != 1) ||
      (regime != FMA && regime != TC_SMALL && regime != TC_LARGE))
    return (int)cudaErrorInvalidValue;
  const int fin_rows = M <= 64 ? 1 : FIN_ROWS;  // small M: a wide grid
  Args p{a, (const uint8_t*)w_enc, (const float*)w_scale,
         (const float*)a_scale, a_scale_stride, (const int*)bias,
         (const float*)clamp, out, out_kind, (int*)flags, (int*)rows,
         rbuf, cbuf, part, (int*)flag_part, 2 * ((N + 127) / 128) * splits,
         fin_rows, M, N, K, splits,
         (K % (a_kind == A_I8 ? 16 : 8) == 0) && ((uintptr_t)a % 16 == 0),
         (N % 16 == 0) && ((uintptr_t)w_enc % 16 == 0), fault_bits};
  cudaError_t err = cudaSuccess;
  if (fma) {
    if (M <= FMA_RG)
      launch_fma<1>(p, s);
    else if (M <= 2 * FMA_RG)
      launch_fma<2>(p, s);
    else if (M <= 4 * FMA_RG)
      launch_fma<4>(p, s);
    else
      launch_fma<8>(p, s);
  } else if (a_kind == A_I8) {
    err = launch_regime<A_I8>(p, regime, s);
  } else {
    err = launch_regime<A_BF16>(p, regime, s);
  }
  if (err != cudaSuccess) return (int)err;
  if (finish) {
    const dim3 grid((N + FIN_THREADS - 1) / FIN_THREADS,
                    (M + fin_rows - 1) / fin_rows);
    if (a_kind == A_I8)
      finish_kernel<true><<<grid, FIN_THREADS, 0, s>>>(p);
    else
      finish_kernel<false><<<grid, FIN_THREADS, 0, s>>>(p);
  }
  if (rbuf != nullptr) {
    const int n = M > N ? M : N;
    const int blocks = (n + 255) / 256;
    if (a_kind == A_I8)
      abft_compare_kernel<true><<<blocks, 256, 0, s>>>(rbuf, cbuf, (int*)rows,
                                                      (int*)col_mm, M, N);
    else
      abft_compare_kernel<false><<<blocks, 256, 0, s>>>(rbuf, cbuf, (int*)rows,
                                                       (int*)col_mm, M, N);
  }
  return (int)cudaGetLastError();
}
