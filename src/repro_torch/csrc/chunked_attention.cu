// Split-KV online-softmax decode-at-use attention over the paged KV pool,
// read through the page table (the chunked kernel).
//
// Replaces the TPU kernel
// repro/kernels/paged_attention.py::chunked_page_attention (its body
// _chunked_kernel). Per (batch row, KV group) it reads the encoded K and V
// of tokens 0..pos once (2*n*hd bytes; n*hd/4 more check bytes under
// parity-zero) and does ~4*rep*n*hd flops, so it is bound by device memory
// (at B 4, a 2,064-token context and deepseek-7b widths: 67.6 MB, 20.2 us
// at 3.35 TB/s). Under the in-place scheme a second bound sits beside it:
// the 8.45 M SEC-DED blocks of that launch need seven popcounts each for
// their syndromes, about 15 us of the quarter-rate popcount pipe over 132
// SMs. Shared memory holds a few pages per warp, never a whole strip, so
// the context is bounded by device memory only.
//
// Design:
// * Grid (B, KV, splits). The wrapper's plan (paged_attention.plan_splits)
//   picks the split count from (B, KV, S, SM count) so that the card holds
//   all CTAs at once, about five per SM, at any batch (B 1 at a 16,384-token
//   context is 32 (b, g) pairs). Each CTA takes a run of whole 32-token
//   tiles (whole pages at the presets' page size): split s of a row of ntl
//   tiles takes tiles [s*ntl/splits, (s+1)*ntl/splits) and reads their
//   tokens 0..pos, so every live token is read exactly once, tokens past
//   pos never.
// * Four warps per CTA, each an independent pipeline over 8 tokens of every
//   tile: a ring of NST stages in shared memory per warp, filled by 16-byte
//   cp.async copies (8 when hd % 16 != 0) of K and V rows, their scales and
//   check bytes, addressed through the CTA's slice of the page table (read
//   once into shared memory, beside pos). NST - 1 stages are in flight
//   while the warp decodes and computes the oldest one; no CTA barrier in
//   the loop. Scores reduce over the warp with reduce8 (9 shuffles for 8
//   tokens), and each lane then owns one token's softmax step.
// * Decode in shared memory. In-place: the syndrome test runs on the tensor
//   cores, as in ecc_qmatmul.cu: a binary mma.sync m16n8k256 .and.popc of 16
//   rows of 4 blocks against the seven ROWMASK columns gives
//   popc(block & ROWMASK[k]) for 64 blocks in four instructions; only a
//   block with an odd count takes the exact decode (secded64.cuh), which
//   corrects and counts it and writes it back; every block's sign bits are
//   restored as it is read (the restore is idempotent). Parity-zero:
//   parity8.cuh per block, bad bytes zeroed and counted. Faulty: bytes pass
//   through. Values are dequantized with the 2^23 magic number (no I2F).
// * Each warp keeps its own online softmax (m, l, acc per head, f32) over
//   its tokens; at the end the CTA merges its warps in warp order. With one
//   split it writes the output; otherwise it writes (m, l, acc) partials to
//   the wrapper's workspace, and the last CTA of each (b, g) to finish (an
//   integer ticket) merges the splits in split order. No float atomics, so
//   a repeated launch gives the same bits.
// * Flags: per-lane integer counts of valid tokens, one shared-memory
//   atomic per warp, one cell per CTA, summed into (2,) or (2, B) by the
//   last CTA of the launch (kv_attention.cuh). One launch per call.
// Numerics: f32 from end to end in the steps of chunked_page_attention_plain
// (scores q.k * 1/sqrt(hd), exp(s - m), l = alpha*l + sum p, acc = acc*alpha
// + p @ v, out = acc / l rounded once to q's type). The kernel takes each
// token's scale out of its sums (the score is (q . k8) * k_scale * 1/sqrt(hd),
// the PV weight p * v_scale on the int8 values), takes exp through
// ex2.approx (__expf) in the loop, sums in another order and runs the online
// softmax over other tiles, so the two agree to f32 rounding
// (chip_smoke.py's CHUNKED_RTOL / CHUNKED_ATOL, and the fp64 oracle).
//
// Known limits (chip_smoke.py on an H100 80GB HBM3 at 700 W): at B 4, S
// 2,064 a launch takes ~57 us against the 20 us bytes bound, a little under
// SDPA over pre-decoded bf16 strips. The ring streams at about 2 TB/s (128-
// byte rows, 4 KB apart); the int8 -> f32 conversion costs two integer-
// and float-pipe instructions per element beside its FMA; and each launch
// pays ~10 us of dependent latency that no split hides: pos and the table
// slice, the first pages, the split merge and the flag reduction (fences
// and tickets). Short contexts (B 8, S 128) are bound by that latency.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "kv_attention.cuh"
#include "mma_sm90.cuh"
#include "parity8.cuh"
#include "secded64.cuh"

namespace {

using namespace kv_attention;
using namespace mma_sm90;

constexpr int NW = 4;            // warps per CTA
constexpr int THREADS = 32 * NW;
constexpr int WT = 8;            // tokens per warp and tile
constexpr int TILE = NW * WT;    // tokens per CTA tile
constexpr int NST = 4;           // ring stages per warp

struct Args {
  const void* q;
  const uint8_t* kp;
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vp;
  const uint8_t* vc;
  const float* vs;
  const int* table;
  const int* pos;
  void* out;
  int* cells;
  int* counter;
  int* flags;
  float* ws;
  int B, P, npg, ps, KV, H, hd, per_slot, tab_max, vec, ps_shift;
  float sm_scale;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// bytes of one ring stage: K and V rows (padded to whole 512-byte
// syndrome row-groups), 2*WT scales, and the check bytes under scheme 2
__host__ __device__ inline int stage_bytes(int hd, int scheme) {
  return 2 * round_up(WT * hd, 512) + 8 * WT +
         (scheme == 2 ? 2 * round_up(WT * (hd / 8), 16) : 0);
}
// dynamic shared memory of one CTA, in the kernel's order; equal to
// paged_attention.chunked_smem_bytes
inline size_t smem_layout_bytes(int hd, int rep, int scheme, int tab_max) {
  return (size_t)NW * NST * stage_bytes(hd, scheme) + 4 * (size_t)rep * hd +
         4 * (size_t)NW * rep * hd + 8 * (size_t)NW * rep +
         4 * (size_t)tab_max;
}

template <typename T, int SCHEME>
__global__ void __launch_bounds__(THREADS) chunked_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd, KV = p.KV, rep = p.H / KV, nb = hd / 8;
  const int S = p.npg * p.ps, ps = p.ps;
  const int b = blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z, bg = b * KV + g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = round_up(WT * hd, 512);
  const int cb = SCHEME == 2 ? round_up(WT * nb, 16) : 0;
  const int stage = stage_bytes(hd, SCHEME);
  unsigned char* ring = smem + warp * NST * stage;
  float* qs = reinterpret_cast<float*>(smem + NW * NST * stage);  // rep x hd
  float* wacc = qs + rep * hd;      // NW x rep x hd
  float* wm = wacc + NW * rep * hd;  // NW x rep
  float* wl = wm + NW * rep;         // NW x rep
  int* tab = reinterpret_cast<int*>(wl + NW * rep);
  __shared__ int cnt[2];
  __shared__ int last_bg;

  // this CTA's run of tiles of the S-token row, and the page-table entries
  // it spans (loaded beside pos: the run does not depend on it); of the
  // run, only tokens 0..pos are read
  const int ntl = (S + TILE - 1) / TILE;
  const int c0 = (int)((int64_t)split * ntl / splits);
  const int c1 = (int)((int64_t)(split + 1) * ntl / splits);
  const int pg0 = c0 * TILE / ps;
  if (p.table && c1 > c0)
    for (int i = tid; i <= min(c1 * TILE - 1, S - 1) / ps - pg0 &&
                      i < p.tab_max;
         i += THREADS)
      tab[i] = checked_page(__ldg(p.table + (int64_t)b * p.npg + pg0 + i),
                            p.P);
  const int n = min(p.pos[b], S - 1) + 1;
  const int t_end = min(c1 * TILE, n);
  const T* q = static_cast<const T*>(p.q) + ((int64_t)b * p.H + g * rep) * hd;
  for (int i = tid; i < rep * hd; i += THREADS) qs[i] = to_float(q[i]);
  for (int i = tid; i < NW * rep * hd; i += THREADS) wacc[i] = 0.f;
  for (int i = tid; i < NW * rep; i += THREADS) {
    wm[i] = -1e30f;
    wl[i] = 0.f;
  }
  if (tid < 2) cnt[tid] = 0;
  __syncthreads();

  // flat (page * ps + slot) of token t of this CTA's range
  auto slot = [&](int t) -> int64_t {
    if (!p.table) return (int64_t)b * ps + t;  // strips: page b
    const int pi = p.ps_shift >= 0 ? t >> p.ps_shift : t / ps;
    const int si = p.ps_shift >= 0 ? t & (ps - 1) : t % ps;
    return (int64_t)tab[pi - pg0] * ps + si;
  };
  // this lane's copy units of a warp tile: unit lane + 32i is token
  // uj + i*dj, byte column uc (when a row's units divide 32; else uc per
  // unit)
  const int upr = hd / p.vec, nunits = WT * upr;  // nunits <= 256
  const bool even = 32 % upr == 0;
  const int uj = lane / upr, uc = lane % upr * p.vec, dj = even ? 32 / upr : 0;
  // copy the warp's tokens of tile c0 + it into ring stage it % NST (tokens
  // past the range are zero-filled: codewords under every scheme), then
  // commit one group, empty past the last tile
  auto issue = [&](int it) {
    unsigned char* st = ring + (it % NST) * stage;
    if (c0 + it < c1) {
      const int base = (c0 + it) * TILE + warp * WT;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (lane + 32 * i < nunits) {
          const int u = lane + 32 * i;
          const int j = even ? uj + i * dj : u / upr;
          const int c = even ? uc : u % upr * p.vec;
          const int t = base + j;
          const bool in = t < t_end;
          const int64_t off = (in ? slot(t) * KV + g : 0) * hd + c;
          unsigned char* dk = st + j * hd + c;
          if (p.vec == 16) {
            cp_async16(dk, p.kp + off, in);
            cp_async16(dk + kb, p.vp + off, in);
          } else {
            cp_async8(dk, p.kp + off, in);
            cp_async8(dk + kb, p.vp + off, in);
          }
        }
      }
      if (lane < 2 * WT) {  // lanes 0..WT-1: K scales, WT..2WT-1: V scales
        const int t = base + lane % WT;
        const bool in = t < t_end;
        cp_async4(st + 2 * kb + 4 * lane,
                  (lane < WT ? p.ks : p.vs) + (in ? slot(t) : 0), in);
      }
      if (SCHEME == 2) {  // WT rows of nb check bytes each, K then V
        unsigned char* dc = st + 2 * kb + 8 * WT;
        if (nb % 4 == 0) {
          const int upr4 = nb / 4;
          for (int u = lane; u < 2 * WT * upr4; u += 32) {
            const int kv = u / (WT * upr4), r = u % (WT * upr4);
            const int j = r / upr4, c = r % upr4, t = base + j;
            const bool in = t < t_end;
            const int64_t off = (in ? slot(t) * KV + g : 0) * nb + 4 * c;
            cp_async4(dc + kv * cb + j * nb + 4 * c,
                      (kv ? p.vc : p.kc) + off, in);
          }
        } else {  // rows of 1 or 2 (or 3, 5, ...) bytes: plain loads
          for (int u = lane; u < 2 * WT * nb; u += 32) {
            const int kv = u / (WT * nb), r = u % (WT * nb);
            const int j = r / nb, c = r % nb, t = base + j;
            dc[kv * cb + r] =
                t < t_end ? (kv ? p.vc : p.kc)[(slot(t) * KV + g) * nb + c]
                          : 0;
          }
        }
      }
    }
    cp_async_commit();
  };

  // the B fragments of the syndrome test: column g4 holds mask 2j + (g4 & 1)
  // at 64-bit slot g4 >> 1 (see ecc_qmatmul.cu)
  uint32_t bm0[4], bm1[4];
  {
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 2 * j + (g4 & 1), sl = g4 >> 1;
      const uint64_t mk = k < 7 ? secded64::ROWMASK[k] : 0ull;
      const uint32_t word = (t4 & 1) ? (uint32_t)(mk >> 32) : (uint32_t)mk;
      bm0[j] = (t4 >> 1) == sl ? word : 0u;
      bm1[j] = 2 + (t4 >> 1) == sl ? word : 0u;
    }
  }

  int n_cor = 0, n_due = 0;
  const unsigned full = 0xffffffffu;
  const int nblk = WT * nb;  // blocks of the K (and of the V) rows
  const int nw4 = hd / 4;
  const int jme = lane >> 2;  // the token whose score reduce8 leaves here
  const int iters = max(0, min(c1, (n + TILE - 1) / TILE) - c0);
  for (int i = 0; i < NST - 1; ++i) issue(i);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<NST - 2>();
    __syncwarp();
    issue(it + NST - 1);  // into the stage consumed last iteration
    __syncwarp();
    unsigned char* st = ring + (it % NST) * stage;
    const int base = (c0 + it) * TILE + warp * WT;

    // decode: rewrite only corrected / zeroed blocks in place
    if (SCHEME == 1) {
      for (int rg = 0; rg < 2 * kb / 512; ++rg) {
        unsigned char* e = st + 512 * rg;  // K row-groups, then V's
        uint32_t a[4];
        ldmatrix_x4(a, e + (lane & 15) * 32 + (lane >> 4) * 16);
        int d[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
          mma_b1(d[j], a, bm0[j], bm1[j]);
        }
        const int odd0 = (d[0][0] | d[0][1] | d[1][0] | d[1][1] | d[2][0] |
                          d[2][1] | d[3][0] | d[3][1]) & 1;
        const int odd1 = (d[0][2] | d[0][3] | d[1][2] | d[1][3] | d[2][2] |
                          d[2][3] | d[3][2] | d[3][3]) & 1;
        if (__any_sync(full, odd0 | odd1)) {
          const int blk_base = 64 * (rg % (kb / 512));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int blk = blk_base + 32 * h + lane;
            if ((h ? odd1 : odd0) && blk < nblk) {
              uint64_t* wp =
                  reinterpret_cast<uint64_t*>(e + 256 * h + 8 * lane);
              uint32_t f;
              *wp = secded64::decode(*wp, &f);
              n_cor += f & 1u;
              n_due += f >> 1;
            }
          }
        }
      }
    } else if (SCHEME == 2) {
      const unsigned char* dc = st + 2 * kb + 8 * WT;
      for (int blk = lane; blk < 2 * nblk; blk += 32) {
        const int kv = blk / nblk, i = blk % nblk;
        uint64_t* wp = reinterpret_cast<uint64_t*>(st + kv * kb + 8 * i);
        int bad;
        const uint64_t w = parity8::decode(*wp, dc[kv * cb + i], &bad);
        if (bad) {
          *wp = w;
          n_cor += bad;  // parity-zero counts bad BYTES, never a DUE
        }
      }
    }
    __syncwarp();

    // online softmax over this warp's WT tokens, head by head. Scores are
    // q . k8 over the int8 values, then times the token's scale and
    // 1/sqrt(hd); PV weights are p * v_scale times the int8 values.
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kb);
    const float* vsc = ksc + WT;
    const bool vme = base + jme < t_end;
    const float k_s = ksc[jme], v_s = vsc[jme];
    for (int r = 0; r < rep; ++r) {
      float a[WT];
#pragma unroll
      for (int j = 0; j < WT; ++j) a[j] = 0.f;
      for (int w = lane; w < nw4; w += 32) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + r * hd + 4 * w);
#pragma unroll
        for (int j = 0; j < WT; ++j) {
          uint32_t kw = *reinterpret_cast<const uint32_t*>(st + j * hd + 4 * w);
          if (SCHEME == 1) kw = restore_half(kw, w & 1);
          kw ^= 0x80808080u;
          a[j] = fmaf(qv.x, i8f(kw, 0), a[j]);
          a[j] = fmaf(qv.y, i8f(kw, 1), a[j]);
          a[j] = fmaf(qv.z, i8f(kw, 2), a[j]);
          a[j] = fmaf(qv.w, i8f(kw, 3), a[j]);
        }
      }
      const float dot = reduce8(a);
      const float s = vme ? __fmul_rn(__fmul_rn(dot, k_s), p.sm_scale)
                          : -1e30f;
      float mx = fmaxf(s, __shfl_xor_sync(full, s, 4));
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(full, mx, 16));
      const int sidx = warp * rep + r;
      const float m_old = wm[sidx], m_new = fmaxf(m_old, mx);
      const float alpha = __expf(m_old - m_new);
      const float pme = vme ? __expf(s - m_new) : 0.f;
      float psum = pme + __shfl_xor_sync(full, pme, 4);
      psum += __shfl_xor_sync(full, psum, 8);
      psum += __shfl_xor_sync(full, psum, 16);
      const float wme = pme * v_s;
      float wj[WT];
#pragma unroll
      for (int j = 0; j < WT; ++j) wj[j] = __shfl_sync(full, wme, 4 * j);
      float* acc = wacc + sidx * hd;
      for (int w = lane; w < nw4; w += 32) {
        float4 av = *reinterpret_cast<float4*>(acc + 4 * w);
        av.x *= alpha;
        av.y *= alpha;
        av.z *= alpha;
        av.w *= alpha;
#pragma unroll
        for (int j = 0; j < WT; ++j) {
          uint32_t vw =
              *reinterpret_cast<const uint32_t*>(st + kb + j * hd + 4 * w);
          if (SCHEME == 1) vw = restore_half(vw, w & 1);
          vw ^= 0x80808080u;
          av.x = fmaf(wj[j], i8f(vw, 0), av.x);
          av.y = fmaf(wj[j], i8f(vw, 1), av.y);
          av.z = fmaf(wj[j], i8f(vw, 2), av.z);
          av.w = fmaf(wj[j], i8f(vw, 3), av.w);
        }
        *reinterpret_cast<float4*>(acc + 4 * w) = av;
      }
      __syncwarp();  // every lane has read m_old and l before lane 0 writes
      if (lane == 0) {
        wm[sidx] = m_new;
        wl[sidx] = __fadd_rn(__fmul_rn(alpha, wl[sidx]), psum);
      }
    }
  }
  cp_async_wait<0>();
  n_cor = warp_sum(n_cor);
  n_due = warp_sum(n_due);
  if (lane == 0 && (n_cor | n_due)) {
    atomicAdd(&cnt[0], n_cor);
    atomicAdd(&cnt[1], n_due);
  }
  __syncthreads();

  // merge the warps in warp order: this split's (m, l, acc), or the output
  T* out = static_cast<T*>(p.out) + ((int64_t)b * p.H + g * rep) * hd;
  const int64_t nparts = (int64_t)p.B * KV * splits;
  float* ws_acc = p.ws;                          // nparts x rep x hd
  float* ws_m = ws_acc + nparts * rep * hd;      // nparts x rep
  float* ws_l = ws_m + nparts * rep;             // nparts x rep
  const int64_t part = (int64_t)bg * splits + split;
  for (int o = tid; o < rep * hd; o += THREADS) {
    const int r = o / hd;
    float M = -1e30f;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * rep + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = expf(wm[w * rep + r] - M);
      L = __fadd_rn(L, __fmul_rn(wl[w * rep + r], e));
      A = __fadd_rn(A, __fmul_rn(wacc[(w * rep + r) * hd + o % hd], e));
    }
    if (splits == 1) {
      from_float(A / L, &out[o]);
    } else {
      ws_acc[part * rep * hd + o] = A;
      if (o % hd == 0) {
        ws_m[part * rep + r] = M;
        ws_l[part * rep + r] = L;
      }
    }
  }
  if (tid == 0) {
    const int64_t cell = 2 * part;  // cells of row b are consecutive
    p.cells[cell] = cnt[0];
    p.cells[cell + 1] = cnt[1];
  }
  if (splits > 1) {  // the last split of (b, g) to finish merges them all
    __threadfence();
    __syncthreads();
    if (tid == 0) last_bg = atomicAdd(p.counter + 1 + bg, 1) == splits - 1;
    __syncthreads();
    if (last_bg) {
      __threadfence();
      const int64_t p0 = (int64_t)bg * splits;
      for (int o = tid; o < rep * hd; o += THREADS) {
        const int r = o / hd;
        float M = -1e30f;
        for (int s = 0; s < splits; ++s)
          M = fmaxf(M, __ldcg(ws_m + (p0 + s) * rep + r));
        float L = 0.f, A = 0.f;
        for (int s = 0; s < splits; ++s) {
          const float e = expf(__ldcg(ws_m + (p0 + s) * rep + r) - M);
          L = __fadd_rn(L, __fmul_rn(__ldcg(ws_l + (p0 + s) * rep + r), e));
          A = __fadd_rn(A, __fmul_rn(__ldcg(ws_acc + ((p0 + s) * rep) * hd + o),
                                     e));
        }
        from_float(A / L, &out[o]);
      }
      if (tid == 0) p.counter[1 + bg] = 0;
    }
  }
  finish_flags(p.cells, p.counter, p.flags, (int)nparts, p.B, p.per_slot);
}

template <typename T, int SCHEME>
int launch(const Args& a, int splits, size_t smem, cudaStream_t stream) {
  auto kern = chunked_kernel<T, SCHEME>;
  static size_t opted = 48 * 1024;  // per instantiation
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  kern<<<dim3(a.B, a.KV, splits), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_scheme(const Args& a, int scheme, int splits, size_t smem,
              cudaStream_t s) {
  if (scheme == 1) return launch<T, 1>(a, splits, smem, s);
  if (scheme == 2) return launch<T, 2>(a, splits, smem, s);
  return launch<T, 0>(a, splits, smem, s);
}

}  // namespace

// The pool of one layer as in fused_page_attention_launch (paged_attention.cu):
// kp/vp (P, ps, KV, hd) uint8, ks/vs (P, ps) f32, kc/vc check bytes (scheme
// 2) or NULL, table (B, npg) int32 page ids in [0, P) (the kernel traps on
// any other) or NULL for the identity over one page per row, pos (B,)
// int32; q/out (B, H, hd). cells (B, KV, splits, 2) int32 scratch;
// counter: 1 + B*KV int32 that are 0 before the launch and 0 again after
// it, used by no launch on another stream meanwhile (single-stream
// contract: the wrapper keeps one buffer per (device, stream)); flags (2,)
// or (2, B) int32; ws: B*KV*splits*rep*(hd + 2) f32 scratch (unused with
// one split). tab_max: page-table entries one CTA's tiles may span (0
// without a table). smem must equal the layout above.
extern "C" int chunked_page_attention_launch(
    const void* q, const void* kp, const void* kc, const void* ks,
    const void* vp, const void* vc, const void* vs, const void* table,
    const void* pos, void* out, void* cells, void* counter, void* flags,
    void* ws, int B, int P, int npg, int ps, int KV, int H, int hd,
    int splits, int tab_max, int scheme, float sm_scale, long long smem,
    int q_bf16, int per_slot, void* stream) {
  if (B < 1 || P < 1 || npg < 1 || ps < 1 || KV < 1 || hd < 8 || hd % 8 ||
      H % KV || splits < 1 || scheme < 0 || scheme > 2 ||
      (scheme == 2 && (!kc || !vc)) || (!table && npg != 1) ||
      (table && tab_max < 1) || (splits > 1 && !ws) ||
      (size_t)smem != smem_layout_bytes(hd, H / KV, scheme, tab_max))
    return (int)cudaErrorInvalidValue;
  const uintptr_t al = (uintptr_t)kp | (uintptr_t)vp;
  const int vec = hd % 16 == 0 && al % 16 == 0 ? 16 : 8;
  if (WT * hd / vec > 256) return (int)cudaErrorInvalidValue;  // hd > 512
  if (al % 8 || (uintptr_t)ks % 4 || (uintptr_t)vs % 4 ||
      (scheme == 2 && (hd / 8) % 4 == 0 &&
       ((uintptr_t)kc | (uintptr_t)vc) % 4))
    return (int)cudaErrorMisalignedAddress;
  int ps_shift = -1;  // page size a power of two: shifts, not divisions
  for (int k = 0; k < 31; ++k)
    if (ps == 1 << k) ps_shift = k;
  const Args a{q, (const uint8_t*)kp, (const uint8_t*)kc, (const float*)ks,
               (const uint8_t*)vp, (const uint8_t*)vc, (const float*)vs,
               (const int*)table, (const int*)pos, out, (int*)cells,
               (int*)counter, (int*)flags, (float*)ws, B, P, npg, ps, KV, H,
               hd, per_slot, tab_max, vec, ps_shift, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return by_scheme<__nv_bfloat16>(a, scheme, splits, (size_t)smem, s);
  return by_scheme<float>(a, scheme, splits, (size_t)smem, s);
}
