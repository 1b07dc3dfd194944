// Causal flash attention (online softmax) for the prefill, optionally over
// a sliding window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its _kernel and the _norm_kernel second pass). q, k: (BH, S, DQK), v,
// out: (BH, S, DV), row-major; DQK = DV in {16, 32, 64, 128, 256}, or the
// MLA head split (DQK, DV) = (192, 128) of DeepSeek-V2/V3 (queries and keys
// carry 128 nope + 64 rope dims, values 128). At prefill shapes it does
// BH*S^2*(DQK + DV) flops over the causal triangle against
// 2*BH*S*(DQK + DV)*sizeof(T) bytes, so it is bound by its operations
// (H100: 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 on
// the CUDA cores); keeping the score
// tile and the (m, l, o) state on chip keeps the S^2 scores out of device
// memory, which is what the kernel is for.
//
// Both routes share the grid and the arithmetic: grid (ceil(S/64), BH),
// one CTA per (query tile of BQ = 64 rows, batch-head), the CTAs of the
// late, heavy query tiles launched first. The TPU's sequential key-tile
// axis is a loop inside the CTA over key tiles of BK = 64 up to and
// including the diagonal tile; tiles past it are never loaded, and only
// the diagonal tile is masked. Per key tile the op order is the plain
// version's: s = q.k with f32 accumulation (bf16 products are exact in
// f32), s * (1/sqrt(DQK)) after the dot, -1e30 where the key is after the
// query; m_new = max(m, rowmax); p = exp(s - m_new) (expf, no exp2 fold);
// alpha = exp(m - m_new); l = l*alpha + sum p; o = o*alpha + round(p, T) @ v
// in f32. At the end out = o / max(l, 1e-30), rounded once to T: one
// kernel computes what the TPU's two passes compute. A ragged S is masked:
// key rows past S load as 0 and are causally invisible to every real
// query; query rows past S are not written.
//
// Sliding window (window > 0; the hybrid family's local attention): key j
// is visible to query q iff 0 <= q - j < window. The key-tile loop then
// starts at the tile of the oldest key visible to the CTA's first query
// row, (max(0, q0 - window + 1) / 64), so a CTA visits about window / 64
// + 1 tiles, not all tiles up to the diagonal. Besides the diagonal tile,
// the low edge tiles (those holding a key at least `window` older than
// the CTA's last row) are masked. A row whose first visible key lies past
// the CTA's first tile sees a wholly masked tile first: m stays -1e30, p
// = exp(0) = 1 and l, o take those values, until its first visible tile,
// where alpha = exp(-1e30 - m_new) is exactly 0 in f32 and wipes them.
// The plain version walks the same tiles, so both take that path on the
// same rows. The window is a template flag: window = 0 instantiates the
// causal kernel exactly as it was.
//
// Routes by dtype:
// * bf16 (tensor cores, FlashAttention-2 layout): 4 warps, each owning 16
//   query rows; S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 in, f32
//   accumulator). Q, K and V stay bf16 in shared memory, rows padded by 16
//   bytes (an odd number of 16-byte units per row, so the 8 row addresses
//   of each ldmatrix hit distinct banks); K and V in a 2-stage ring filled
//   by cp.async, so tile t+1 loads while tile t computes. Q fragments stay
//   in registers for DQK <= 128 and are re-read with ldmatrix per tile at
//   DQK = 192 and 256 (register budget: o alone is DV/2 f32 registers a
//   thread).
//   m, l and alpha are computed on the accumulator fragments; a row's 64
//   scores live in the quad of lanes that shares it, so row reductions are
//   two xor shuffles. P is rounded to bf16 in registers (the plain
//   version's p.to(v.dtype)) and fed as the A operand of P V, with V read
//   by ldmatrix.trans. Unlike the plain version, P V accumulates into the
//   alpha-scaled o directly (no separate pv sum), so only the order of the
//   f32 sums differs. Shared memory: Q and 2 stages of K in rows of DQK + 8
//   bf16, 2 stages of V in rows of DV + 8: 87,040 bytes at D = 128 (two
//   CTAs per SM), 168,960 at D = 256, 111,616 at (192, 128).
// * f32 (CUDA cores; the tensor cores have no exact f32 path and the port
//   keeps TF32 off): 256 threads, each a 4x4 micro-tile of the 64x64 score
//   tile (rows ty+16i, keys tx+16j) and a 4x(DV/16) micro-tile of the
//   output in registers; Q, K, V staged in shared memory as f32 rows of
//   DQK + 1 (DV + 1) floats; row reductions over the 16 lanes of a
//   half-warp. 214,016 bytes of shared memory at D = 256, 148,480 at
//   (192, 128).
//
// Known limits, kept for later: mma.sync, not wgmma with TMA; no warp
// specialisation (loads are issued by the compute warps); at D = 256 one
// CTA per SM; GQA callers repeat K and V per head beforehand.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps x 16 query rows

template <int DQK, int DV>
constexpr size_t tc_smem_bytes() {
  return ((size_t)(BQ + 2 * BK) * (DQK + 8) + (size_t)2 * BK * (DV + 8)) *
         sizeof(__nv_bfloat16);
}

template <int DQK, int DV, bool WIN>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int S, float sm_scale,
                int window) {
  constexpr int LD = DQK + 8;    // padded Q and K row, in bf16
  constexpr int LDV = DV + 8;    // padded V row
  constexpr int CH = DQK / 8;    // 16-byte chunks per Q or K row
  constexpr int CHV = DV / 8;    // per V row
  constexpr int KS = DQK / 16;   // k-steps of Q K^T
  constexpr int NO = DV / 8;     // n8 tiles of the output
  constexpr bool Q_REGS = DQK <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // 2 stages x BK x LD
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // 2 stages x BK x LDV

  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int q0 = qt * BQ;
  const int64_t base = (int64_t)blockIdx.y * S * DQK;   // q and k
  const int64_t vbase = (int64_t)blockIdx.y * S * DV;   // v and out
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (int i = tid; i < BQ * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = q0 + r < S;
    cp_async16(Qs + r * LD + c * 8,
               q + base + (int64_t)(in ? q0 + r : 0) * DQK + c * 8, in);
  }
  // V rides in the K loop when DQK = DV and has its own loop only at the
  // MLA split: the separate loop for every pair costs 1.5-7% on the card
  // (H100 80GB HBM3, 700 W; chip_smoke.py check_flash, both versions in
  // one call: hd 128 +2.4%, hd 64 +7%, windowed hd 256 +1.5%)
  auto load_kv = [&](int kt, int st) {
    const int k0 = kt * BK;
    __nv_bfloat16* kd = Ks + st * BK * LD;
    __nv_bfloat16* vd = Vs + st * BK * LDV;
    for (int i = tid; i < BK * CH; i += TC_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < S;
      const int64_t row = in ? k0 + r : 0;
      cp_async16(kd + r * LD + c * 8, k + base + row * DQK + c * 8, in);
      if constexpr (DQK == DV)
        cp_async16(vd + r * LDV + c * 8, v + vbase + row * DV + c * 8, in);
    }
    if constexpr (DQK != DV) {
      for (int i = tid; i < BK * CHV; i += TC_THREADS) {
        const int r = i / CHV, c = i % CHV;
        const bool in = k0 + r < S;
        const int64_t row = in ? k0 + r : 0;
        cp_async16(vd + r * LDV + c * 8, v + vbase + row * DV + c * 8, in);
      }
    }
  };
  // the first key tile: 0, or with a window the tile of the oldest key
  // visible to the CTA's first row
  const int kt0 = WIN ? max(0, q0 - window + 1) / BK : 0;
  load_kv(kt0, kt0 & 1);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  uint32_t qf[Q_REGS ? KS : 1][4];
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * LD +
                              (lane >> 4) * 8;

  for (int kt = kt0; kt <= qt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    if (kt < qt) load_kv(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    if constexpr (Q_REGS) {
      if (kt == kt0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }
    const __nv_bfloat16* Kt = Ks + (kt & 1) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (kt & 1) * BK * LDV;

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {  // 16 keys per ldmatrix.x4
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (j2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], a, b[0], b[1]);
        mma_bf16(s[2 * j2 + 1], a, b[2], b[3]);
      }
    }

    // online softmax on the fragments: s[j][e] is row row0 + 8*(e >> 1),
    // key kt*64 + 8j + 2*t4 + (e & 1)
    const bool diag = kt == qt;
    // with a window, a tile holding a key `window` or more older than the
    // CTA's last row is masked too
    const bool low = WIN && q0 + BQ - 1 - kt * BK >= window;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sm_scale;
        const int key = kt * BK + 8 * j + 2 * t4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if constexpr (WIN) {
          if ((diag || low) && (key > row || row - key >= window)) x = NEG;
        } else {
          if (diag && key > row) x = NEG;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = __fadd_rn(__fmul_rn(l_r[r], alpha[r]), sum[r]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += round(P, bf16) V: the score fragments of keys 16kk .. 16kk+15
    // are the A fragment of the k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j2 = 0; j2 < NO / 2; ++j2) {  // 16 head dims per ldmatrix
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                   j2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * j2], a, b[0], b[1]);
        mma_bf16(o[2 * j2 + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_r[r], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + vbase +
                                                (int64_t)row * DV + 2 * t4);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      dst[4 * j] = pack_bf16(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PLD = BK + 1;       // row stride of the probability tile

// reductions over the 16 lanes of a half-warp (one query row's keys)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DQK, int DV>
constexpr size_t f32_smem_bytes() {
  return ((size_t)(BQ + BK) * (DQK + 1) + (size_t)BK * (DV + 1) +
          (size_t)BQ * PLD) * sizeof(float);
}

template <int DQK, int DV, bool WIN>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 float sm_scale, int window) {
  constexpr int LD = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int DJ = DV / 16;
  extern __shared__ float sm[];
  float* Qs = sm;              // BQ x LD
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LDV
  float* Ps = Vs + BK * LDV;   // BQ x PLD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int64_t base = (int64_t)blockIdx.y * S * DQK;   // q and k
  const int64_t vbase = (int64_t)blockIdx.y * S * DV;   // v and out
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * DQK; i += F32_THREADS) {
    const int r = i / DQK, d = i % DQK;
    Qs[r * LD + d] = q0 + r < S ? q[base + (int64_t)(q0 + r) * DQK + d] : 0.f;
  }
  float o[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) o[i][jj] = 0.f;
  }

  const int last_row = min(q0 + BQ - 1, S - 1);
  const int k_first = WIN ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_first; k0 <= last_row; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    // V in the K loop when DQK = DV, as in flash_tc_kernel (its own loop
    // for every pair costs hd 256 +7% on the card)
    for (int i = tid; i < BK * DQK; i += F32_THREADS) {
      const int r = i / DQK, d = i % DQK;
      const bool in = k0 + r < S;
      const int64_t g = base + (int64_t)(k0 + r) * DQK + d;
      Ks[r * LD + d] = in ? k[g] : 0.f;
      if constexpr (DQK == DV) Vs[r * LDV + d] = in ? v[g] : 0.f;
    }
    if constexpr (DQK != DV) {
      for (int i = tid; i < BK * DV; i += F32_THREADS) {
        const int r = i / DV, d = i % DV;
        const bool in = k0 + r < S;
        Vs[r * LDV + d] = in ? v[vbase + (int64_t)(k0 + r) * DV + d] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool vis = WIN ? row >= key && row - key < window : row >= key;
        s[i][j] = vis ? s[i][j] * sm_scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
      alpha[i] = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), half_sum(sum));
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) pv[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vb[jj] = Vs[c * LDV + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          pv[i][jj] = fmaf(pa[i], vb[jj], pv[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        o[i][jj] = __fadd_rn(__fmul_rn(o[i][jj], alpha[i]), pv[i][jj]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      out[vbase + (int64_t)row * DV + tx + 16 * jj] = o[i][jj] / denom;
  }
}

template <int DQK, int DV, bool WIN>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, float sm_scale, int is_bf16, int window,
           cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, BH);
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = tc_smem_bytes<DQK, DV>();
    err = cudaFuncSetAttribute(flash_tc_kernel<DQK, DV, WIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_tc_kernel<DQK, DV, WIN><<<grid, TC_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, sm_scale, window);
  } else {
    constexpr size_t smem = f32_smem_bytes<DQK, DV>();
    err = cudaFuncSetAttribute(flash_f32_kernel<DQK, DV, WIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_f32_kernel<DQK, DV, WIN><<<grid, F32_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, S,
        sm_scale, window);
  }
  return (int)cudaGetLastError();
}

template <int DQK, int DV = DQK>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, float sm_scale, int is_bf16, int window,
             cudaStream_t stream) {
  return window > 0
             ? launch<DQK, DV, true>(q, k, v, out, BH, S, sm_scale, is_bf16,
                                     window, stream)
             : launch<DQK, DV, false>(q, k, v, out, BH, S, sm_scale, is_bf16,
                                      0, stream);
}

}  // namespace

// q/k: (BH, S, D), v/out: (BH, S, DV), contiguous; is_bf16: 1 for bfloat16
// (tensor cores), 0 for float32 (CUDA cores). DV = D in {16, 32, 64, 128,
// 256}, or (D, DV) = (192, 128); BH <= 65535. window: 0 for causal
// attention, else the sliding window (key j visible to query q iff
// 0 <= q - j < window).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int D, int DV, float sm_scale,
                                      int is_bf16, int window, void* stream) {
  if (BH < 1 || BH > 65535 || S < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (DV != D) {
    if (D == 192 && DV == 128)
      return launch_d<192, 128>(q, k, v, out, BH, S, sm_scale, is_bf16,
                                window, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
    case 16:
      return launch_d<16>(q, k, v, out, BH, S, sm_scale, is_bf16, window, s);
    case 32:
      return launch_d<32>(q, k, v, out, BH, S, sm_scale, is_bf16, window, s);
    case 64:
      return launch_d<64>(q, k, v, out, BH, S, sm_scale, is_bf16, window, s);
    case 128:
      return launch_d<128>(q, k, v, out, BH, S, sm_scale, is_bf16, window, s);
    case 256:
      return launch_d<256>(q, k, v, out, BH, S, sm_scale, is_bf16, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
