// Fused ECC page decode + single-token attention over the paged KV pool,
// read through the page table (the strip kernel).
//
// Replaces the TPU kernel
// repro/kernels/paged_attention.py::fused_page_attention. Per (batch row,
// KV group) it reads the encoded K and V of tokens 0..pos once (2*n*hd
// bytes, plus n*hd/4 check bytes under parity-zero) and does ~4*rep*n*hd
// flops, so its bound is bytes; at the serve shapes (n <= 128 tokens, a
// few KB per CTA) that bound is a few microseconds and the kernel is bound
// by latency instead: dependent DRAM round trips, barriers and the launch.
//
// Design: grid (B, KV), 256 threads (8 warps), one launch per call.
//   1. The CTA's position, its page-table entries and then every 16-byte
//      (8 when hd % 16 != 0) unit of K and V of tokens 0..pos are loaded at
//      once, several per thread (each lane owns whole 8-byte blocks), with
//      their per-token scales and check bytes: two dependent round trips
//      (table, then data; one with the identity table of the strip entry
//      points). Tokens past pos are never read.
//   2. Each thread decodes its blocks in registers (scheme 1, in-place:
//      secded64.cuh; scheme 2, parity-zero: parity8.cuh, each bad byte
//      zeroed and counted as corrected; scheme 0, faulty: bytes pass
//      through), counts (corrected, DUE) in registers and stores int8 to
//      shared memory; one shared-memory atomic per warp sums the counts.
//   3. Scores: warps over tokens, lanes over 4-byte words of hd.
//   4. Softmax over the CTA, head by head (block reductions).
//   5. PV: each warp sums its own tokens (lanes over words), then the eight
//      warp partials are added in warp order.
//   6. Flags: the CTA writes its (corrected, DUE) cell; the last CTA to
//      finish (an integer ticket the kernel resets itself) sums the cells
//      into (2,) totals or (2, B) per-slot rows, so a call is one launch.
// Numerics mirror fused_page_attention_plain (and the reference's
// repro/kernels/paged_attention.py:105-131): K and V are dequantized in
// f32 and rounded to q's type; the score dot accumulates in f32, is
// rounded to q's type, then multiplied by 1/sqrt(hd) in f32; softmax in
// f32 (exp(s - max) / sum); probabilities rounded to q's type; the f32 PV
// sum rounded once. Only the f32 summation order differs, and the
// roundings absorb it (bit-equal in bf16 on the card).
// Shared memory holds the decoded int8 strips (2*S*hd), their scales, the
// scores (rep*S f32) and the warp partials; the wrapper computes the size
// (paged_attention.smem_bytes) and raises above the card's limit.
//
// Known limits (chip_smoke.py on an H100 80GB HBM3 at 700 W): ~13 us a
// launch at B 4, S 64, where SDPA over pre-decoded strips takes ~9.5: the
// floor is the launch, two dependent DRAM round trips (pos and the table,
// then the pages), four barriers, and the flag reduction's fence and
// ticket, none of which SDPA pays.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "kv_attention.cuh"
#include "parity8.cuh"
#include "secded64.cuh"

namespace {

using namespace kv_attention;

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int U = 4;  // K and V units loaded per thread per round

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
  int B, P, npg, ps, KV, H, hd, per_slot;
  float sm_scale;
};

template <int VEC> struct Unit;
template <> struct Unit<16> {
  using W = uint4;
  __device__ static uint64_t block(const W& w, int i) {
    return i ? ((uint64_t)w.w << 32 | w.z) : ((uint64_t)w.y << 32 | w.x);
  }
  __device__ static void set(W& w, int i, uint64_t v) {
    if (i) { w.z = (uint32_t)v; w.w = (uint32_t)(v >> 32); }
    else { w.x = (uint32_t)v; w.y = (uint32_t)(v >> 32); }
  }
};
template <> struct Unit<8> {
  using W = uint2;
  __device__ static uint64_t block(const W& w, int) {
    return (uint64_t)w.y << 32 | w.x;
  }
  __device__ static void set(W& w, int, uint64_t v) {
    w.x = (uint32_t)v;
    w.y = (uint32_t)(v >> 32);
  }
};

// decode the blocks of one unit in registers, counting into c1 / c2
template <int SCHEME, int VEC>
__device__ __forceinline__ void decode_unit(typename Unit<VEC>::W& w,
                                            uint32_t checks, int& c1,
                                            int& c2) {
  if (SCHEME == 0) return;
#pragma unroll
  for (int i = 0; i < VEC / 8; ++i) {
    uint64_t x = Unit<VEC>::block(w, i);
    if (SCHEME == 1) {
      uint32_t f;
      x = secded64::decode(x, &f);
      c1 += f & 1u;
      c2 += f >> 1;
    } else {
      int bad;
      x = parity8::decode(x, (checks >> (8 * i)) & 0xFFu, &bad);
      c1 += bad;  // parity-zero counts bad BYTES, never a DUE
    }
    Unit<VEC>::set(w, i, x);
  }
}

__host__ __device__ inline size_t r16(size_t x) { return (x + 15) & ~(size_t)15; }

// dynamic shared memory of one CTA, in the kernel's order; equal to
// paged_attention.smem_bytes
__host__ __device__ inline size_t smem_layout_bytes(int S, int hd, int rep) {
  return 2 * r16((size_t)S * hd) + 2 * r16(4 * (size_t)S) +
         4 * (size_t)rep * hd + r16(4 * (size_t)rep * S) +
         4 * (size_t)NW * rep * hd + 8 * (size_t)NW * rep;
}

template <typename T, int SCHEME, int VEC>
__global__ void __launch_bounds__(THREADS) strip_kernel(Args p) {
  using W = typename Unit<VEC>::W;
  constexpr int BPU = VEC / 8;  // blocks (and check bytes) per unit
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.npg * p.ps, hd = p.hd, KV = p.KV, rep = p.H / KV;
  const int nb = hd / 8, nw4 = hd / 4;
  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint8_t* kq = smem;
  uint8_t* vq = kq + r16((size_t)S * hd);
  float* kscs = reinterpret_cast<float*>(vq + r16((size_t)S * hd));
  float* vscs = kscs + r16(4 * (size_t)S) / 4;
  float* qs = vscs + r16(4 * (size_t)S) / 4;
  float* sc = qs + rep * hd;                        // rep x S
  float* part = sc + r16(4 * (size_t)rep * S) / 4;  // NW x rep x hd
  float* wmax = part + NW * rep * hd;               // NW x rep
  float* wsum = wmax + NW * rep;                    // NW x rep
  __shared__ int cnt[2];
  const T* q = static_cast<const T*>(p.q) + ((int64_t)b * p.H + g * rep) * hd;
  T* out = static_cast<T*>(p.out) + ((int64_t)b * p.H + g * rep) * hd;

  const int n = min(p.pos[b], S - 1) + 1;  // tokens 0..pos are read
  if (tid < 2) cnt[tid] = 0;
  for (int i = tid; i < rep * hd; i += THREADS) qs[i] = to_float(q[i]);

  // 1-2. every unit of tokens 0..pos and their scales in one round of
  // loads per thread (the table entries load beside pos), decoded in
  // registers
  int c1 = 0, c2 = 0;
  const int upr = hd / VEC;
  const int nunits = n * upr;
  int u0 = 0;
  do {
    int64_t slot[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {  // no dependence on pos: overlaps its load
      const int t = min((u0 + j * THREADS + tid) / upr, S - 1);
      slot[j] = token_slot(p.table, b, p.npg, p.ps, p.P, t);
    }
    W kw[U], vw[U];
    uint32_t kcb[U], vcb[U];
    float ksr[U], vsr[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = u0 + j * THREADS + tid;
      kcb[j] = vcb[j] = 0;
      if (u < nunits) {
        const int c = u % upr;
        const int64_t row = slot[j] * KV + g;
        kw[j] = *reinterpret_cast<const W*>(p.kp + row * hd + c * VEC);
        vw[j] = *reinterpret_cast<const W*>(p.vp + row * hd + c * VEC);
        if (SCHEME == 2) {
          const int64_t o = row * nb + c * BPU;
          if (BPU == 2) {
            kcb[j] = *reinterpret_cast<const uint16_t*>(p.kc + o);
            vcb[j] = *reinterpret_cast<const uint16_t*>(p.vc + o);
          } else {
            kcb[j] = p.kc[o];
            vcb[j] = p.vc[o];
          }
        }
        if (c == 0) {
          ksr[j] = p.ks[slot[j]];
          vsr[j] = p.vs[slot[j]];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int u = u0 + j * THREADS + tid;
      if (u < nunits) {
        const int t = u / upr, c = u % upr;
        decode_unit<SCHEME, VEC>(kw[j], kcb[j], c1, c2);
        decode_unit<SCHEME, VEC>(vw[j], vcb[j], c1, c2);
        *reinterpret_cast<W*>(kq + (size_t)t * hd + c * VEC) = kw[j];
        *reinterpret_cast<W*>(vq + (size_t)t * hd + c * VEC) = vw[j];
        if (c == 0) {
          kscs[t] = ksr[j];
          vscs[t] = vsr[j];
        }
      }
    }
    u0 += THREADS * U;
  } while (u0 < nunits);
  __syncthreads();  // (cnt is zeroed before this barrier)
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0 && (c1 | c2)) {
    atomicAdd(&cnt[0], c1);
    atomicAdd(&cnt[1], c2);
  }

  // The f32 sums below run in a fixed order that
  // paged_attention.fused_page_attention_plain repeats step for step, so
  // the two are equal bit for bit (products of bf16 values are exact):
  // 3. scores: warp w takes tokens w, w + NW, ..., four at a time; lane l
  //    sums its words l, l + 32, ... (4 elements each, in order), the lanes
  //    add in warp_sum's butterfly (reduce4); rounded to q's type, times
  //    1/sqrt(hd). Each warp keeps the max of its scores per head.
  for (int r = 0; r < rep; ++r) {
    float mx = -3.4e38f;
    for (int i0 = 0; warp + NW * i0 < n; i0 += 4) {
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = min(warp + NW * (i0 + j), n - 1);
        const float kscale = kscs[t];
        a[j] = 0.f;
        for (int w = lane; w < nw4; w += 32) {
          const uint32_t kw = *reinterpret_cast<const uint32_t*>(
                                  kq + (size_t)t * hd + 4 * w) ^
                              0x80808080u;
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + r * hd + 4 * w);
          a[j] = fmaf(qv.x, round_to(dequant(kw, 0, kscale), q), a[j]);
          a[j] = fmaf(qv.y, round_to(dequant(kw, 1, kscale), q), a[j]);
          a[j] = fmaf(qv.z, round_to(dequant(kw, 2, kscale), q), a[j]);
          a[j] = fmaf(qv.w, round_to(dequant(kw, 3, kscale), q), a[j]);
        }
      }
      const float tot = reduce4(a[0], a[1], a[2], a[3]);
      const int t = warp + NW * (i0 + (lane >> 3));
      const float s = __fmul_rn(round_to(tot, q), p.sm_scale);
      if (t < n) {
        mx = fmaxf(mx, s);
        if ((lane & 7) == 0) sc[r * S + t] = s;
      }
    }
    mx = warp_max(mx);
    if (lane == 0) wmax[warp * rep + r] = mx;
  }
  __syncthreads();

  // 4. softmax: e = exp(s - max); lane l of warp w sums e of tokens
  //    w + NW*(l + 32k) in k order, the lanes in the butterfly, the warps in
  //    warp order; p = e / sum rounded to q's type
  for (int r = 0; r < rep; ++r) {
    float mx = wmax[r];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, wmax[w * rep + r]);
    float ps = 0.f;
    for (int t = warp + NW * lane; t < n; t += NW * 32) {
      const float e = expf(sc[r * S + t] - mx);
      sc[r * S + t] = e;
      ps += e;
    }
    ps = warp_sum(ps);
    if (lane == 0) wsum[warp * rep + r] = ps;
  }
  __syncthreads();
  for (int r = 0; r < rep; ++r) {
    float sum = wsum[r];
#pragma unroll
    for (int w = 1; w < NW; ++w) sum += wsum[w * rep + r];
    for (int t = warp + NW * lane; t < n; t += NW * 32)
      sc[r * S + t] = round_to(sc[r * S + t] / sum, q);
  }
  __syncwarp();  // each warp reads back only its own tokens' p

  // 5. PV: warp w over its tokens w, w + NW, ... in order (lanes over
  //    words); then the warp partials in warp order, rounded once
  for (int r = 0; r < rep; ++r)
    for (int w = lane; w < nw4; w += 32) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int t = warp; t < n; t += NW) {
        const float pr = sc[r * S + t], vscale = vscs[t];
        const uint32_t vw =
            *reinterpret_cast<const uint32_t*>(vq + (size_t)t * hd + 4 * w) ^
            0x80808080u;
        a0 = fmaf(pr, round_to(dequant(vw, 0, vscale), q), a0);
        a1 = fmaf(pr, round_to(dequant(vw, 1, vscale), q), a1);
        a2 = fmaf(pr, round_to(dequant(vw, 2, vscale), q), a2);
        a3 = fmaf(pr, round_to(dequant(vw, 3, vscale), q), a3);
      }
      *reinterpret_cast<float4*>(part + (warp * rep + r) * hd + 4 * w) =
          make_float4(a0, a1, a2, a3);
    }
  __syncthreads();
  for (int o = tid; o < rep * hd; o += THREADS) {
    float a = part[o];
#pragma unroll
    for (int w = 1; w < NW; ++w) a += part[w * rep * hd + o];
    from_float(a, &out[o]);
  }

  // 6. flags: this CTA's cell, then the last CTA reduces them all
  if (tid == 0) {
    const int64_t cell = 2 * ((int64_t)b * KV + g);
    p.cells[cell] = cnt[0];
    p.cells[cell + 1] = cnt[1];
  }
  finish_flags(p.cells, p.counter, p.flags, gridDim.x * gridDim.y, p.B,
               p.per_slot);
}

template <typename T, int SCHEME, int VEC>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kern = strip_kernel<T, SCHEME, VEC>;
  static size_t opted = 48 * 1024;  // per instantiation
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  kern<<<dim3(a.B, a.KV), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int by_scheme(const Args& a, int scheme, size_t smem, cudaStream_t s) {
  if (scheme == 1) return launch<T, 1, VEC>(a, smem, s);
  if (scheme == 2) return launch<T, 2, VEC>(a, smem, s);
  return launch<T, 0, VEC>(a, smem, s);
}

}  // namespace

// The pool of one layer: kp/vp (P, ps, KV, hd) uint8, ks/vs (P, ps) f32,
// kc/vc (P, ps, KV, hd/8) uint8 check bytes (scheme 2; NULL otherwise);
// table (B, npg) int32 page ids in [0, P) (the kernel traps on any other),
// or NULL for the identity over one page per row (P = B, npg = 1, ps = S:
// the strip entry points); pos (B,) int32. q/out (B, H, hd), bfloat16 when
// q_bf16 else float32. cells (B, KV, 2) int32 scratch; counter: one int32
// that is 0 before the launch and is 0 again after it, used by no launch
// on another stream meanwhile (single-stream contract: the wrapper keeps
// one per (device, stream)); flags (2,) or, with per_slot, (2, B) int32.
// scheme: 0 faulty, 1 in-place, 2 parity-zero. smem must equal the layout
// above.
extern "C" int fused_page_attention_launch(
    const void* q, const void* kp, const void* kc, const void* ks,
    const void* vp, const void* vc, const void* vs, const void* table,
    const void* pos, void* out, void* cells, void* counter, void* flags,
    int B, int P, int npg, int ps, int KV, int H, int hd, int scheme,
    float sm_scale, long long smem, int q_bf16, int per_slot, void* stream) {
  if (B < 1 || P < 1 || npg < 1 || ps < 1 || KV < 1 || hd < 8 || hd % 8 ||
      H % KV || scheme < 0 || scheme > 2 || (scheme == 2 && (!kc || !vc)) ||
      (!table && npg != 1) ||
      (size_t)smem != smem_layout_bytes(npg * ps, hd, H / KV))
    return (int)cudaErrorInvalidValue;
  const Args a{q, (const uint8_t*)kp, (const uint8_t*)kc, (const float*)ks,
               (const uint8_t*)vp, (const uint8_t*)vc, (const float*)vs,
               (const int*)table, (const int*)pos, out, (int*)cells,
               (int*)counter, (int*)flags, B, P, npg, ps, KV, H, hd, per_slot,
               sm_scale};
  const uintptr_t al = (uintptr_t)kp | (uintptr_t)vp;
  const bool vec16 = hd % 16 == 0 && al % 16 == 0;
  if (!vec16 && al % 8) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t sm = (size_t)smem;
  if (q_bf16)
    return vec16 ? by_scheme<__nv_bfloat16, 16>(a, scheme, sm, s)
                 : by_scheme<__nv_bfloat16, 8>(a, scheme, sm, s);
  return vec16 ? by_scheme<float, 16>(a, scheme, sm, s)
               : by_scheme<float, 8>(a, scheme, sm, s);
}
