// Page-chunked online-softmax decode-at-use attention over gathered KV
// strips.
//
// Replaces the TPU kernel
// repro/kernels/paged_attention.py::chunked_page_attention (its body
// _chunked_kernel). Per (batch, KV group) it reads the encoded K and V
// strips once (2*S*hd bytes) and does ~4*rep*S*hd flops, so it is bound by
// device memory. Unlike the strip kernel (paged_attention.cu) it never
// holds a whole strip: shared memory is bounded by the chunk, so the
// context is bounded by device memory only.
//
// Design: grid (B, KV), one CTA per (batch row, KV group); the TPU's
// sequential chunk axis is a loop inside the CTA, and chunks wholly past
// pos are never read. Per chunk the CTA
//   1. loads the chunk's encoded K and V blocks as 64-bit words (four
//      loads in flight per thread), decodes them into int8 in shared
//      memory (scheme 1, in-place: secded64.cuh, flags per block; scheme
//      2, parity-zero: parity8.cuh with the block's check byte from the
//      (B, S, KV, hd/8) check strips, each bad byte zeroed and counted as
//      corrected; scheme 0, faulty, passes bytes through), and counts
//      (corrected, DUE) over valid tokens (<= pos) in registers;
//   2. scores: one warp per (head, token), lanes over hd, the f32 dot of
//      q (f32) with float(k) * k_scale, times 1/sqrt(hd); tokens past pos
//      (or past S) score -1e30;
//   3. online softmax per head (one warp per head): m_new = max(m, rowmax),
//      alpha = exp(m - m_new), p = exp(s - m_new) and 0 past pos,
//      l = alpha*l + sum p;
//   4. acc = acc*alpha + p @ (float(v) * v_scale), one thread per (head,
//      dim), in token order.
// Everything is f32 with no rounding to the query's type until the end:
// out = acc / l. The op order is that of the reference kernel and of
// chunked_page_attention_plain; the sums run in another order, so the two
// agree to f32 rounding. Flags: per-thread integer counts, summed with
// shared-memory integer atomics and written once per CTA to its own (2,)
// cell of the (B, KV, 2) output: no float atomics, so results are
// deterministic.
//
// Shared memory (dynamic), in this order, as
// paged_attention.chunked_smem_bytes computes it: int8 K and V chunks
// (2*chunk*hd), their scales (2*chunk f32), scores (rep*chunk f32), q and
// acc (2*rep*hd f32), m, l, alpha (3*rep f32). The launch refuses any
// other size.
//
// Known limits, kept for later: B*KV CTAs (32 at batch 1 for deepseek-7b)
// leave most SMs idle at small batch (a split-KV grid would fix it); loads
// are not overlapped with compute (cp.async); no tensor cores.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "parity8.cuh"
#include "secded64.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int UNROLL = 4;  // block loads in flight per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_layout_bytes(int chunk, int hd, int rep) {
  return 2 * (size_t)chunk * hd + 2 * (size_t)chunk * 4 +
         (size_t)rep * chunk * 4 + 2 * (size_t)rep * hd * 4 +
         3 * (size_t)rep * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunked_attention_kernel(const T* __restrict__ q,
                         const uint8_t* __restrict__ ke,
                         const uint8_t* __restrict__ kch,
                         const float* __restrict__ ksc,
                         const uint8_t* __restrict__ ve,
                         const uint8_t* __restrict__ vch,
                         const float* __restrict__ vsc,
                         const int* __restrict__ pos_arr, T* __restrict__ out,
                         int* __restrict__ flags, int S, int KV, int H, int hd,
                         int chunk, int scheme, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / KV;
  uint8_t* kq = smem;
  uint8_t* vq = kq + (size_t)chunk * hd;
  float* ks = reinterpret_cast<float*>(vq + (size_t)chunk * hd);
  float* vs = ks + chunk;
  float* sc = vs + chunk;                  // rep x chunk
  float* qs = sc + (size_t)rep * chunk;    // rep x hd
  float* acc = qs + (size_t)rep * hd;      // rep x hd
  float* m = acc + (size_t)rep * hd;       // rep
  float* l = m + rep;
  float* alpha = l + rep;
  __shared__ int cnt[2];

  const int b = blockIdx.x, g = blockIdx.y;
  const int pos = pos_arr[b];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nb = hd / 8;
  if (tid < 2) cnt[tid] = 0;
  for (int i = tid; i < rep * hd; i += THREADS) {
    qs[i] = to_float(q[((int64_t)b * H + g * rep) * hd + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += THREADS) {
    m[r] = -1e30f;
    l[r] = 0.f;
  }
  int my_cor = 0, my_due = 0;
  __syncthreads();

  const int last = min(pos, S - 1);  // the last valid token
  for (int base = 0; base <= last; base += chunk) {
    const int n = min(chunk, S - base);  // tokens of this chunk in the strip
    const int nblk = n * nb;
    // 1. load and decode the chunk's K and V blocks
    for (int i0 = tid; i0 < nblk; i0 += THREADS * UNROLL) {
      uint64_t wk[UNROLL], wv[UNROLL];
      uint32_t ck[UNROLL], cv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < nblk) {
          const int t = i / nb, j = i % nb;
          const int64_t tok = ((int64_t)b * S + base + t) * KV + g;
          wk[u] = *reinterpret_cast<const uint64_t*>(ke + tok * hd + 8 * j);
          wv[u] = *reinterpret_cast<const uint64_t*>(ve + tok * hd + 8 * j);
          if (scheme == 2) {
            ck[u] = kch[tok * nb + j];
            cv[u] = vch[tok * nb + j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < nblk) {
          const int t = i / nb, j = i % nb;
          uint64_t k = wk[u], v = wv[u];
          if (scheme == 1) {
            uint32_t fk, fv;
            k = secded64::decode(k, &fk);
            v = secded64::decode(v, &fv);
            if (base + t <= pos) {
              my_cor += (int)((fk & 1u) + (fv & 1u));
              my_due += (int)((fk >> 1) + (fv >> 1));
            }
          } else if (scheme == 2) {
            int bk, bv;  // parity-zero counts bad BYTES, never a DUE
            k = parity8::decode(k, ck[u], &bk);
            v = parity8::decode(v, cv[u], &bv);
            if (base + t <= pos) my_cor += bk + bv;
          }
          *reinterpret_cast<uint64_t*>(kq + (size_t)t * hd + 8 * j) = k;
          *reinterpret_cast<uint64_t*>(vq + (size_t)t * hd + 8 * j) = v;
        }
      }
    }
    for (int t = tid; t < n; t += THREADS) {
      ks[t] = ksc[(int64_t)b * S + base + t];
      vs[t] = vsc[(int64_t)b * S + base + t];
    }
    __syncthreads();

    // 2. scores: one warp per (head r, token t), lanes over 4-byte words
    for (int pr = warp; pr < rep * chunk; pr += NWARPS) {
      const int r = pr / chunk, t = pr % chunk;
      float a = 0.f;
      if (t < n) {
        const float kscale = ks[t];
        const float* qr = qs + (size_t)r * hd;
        for (int d4 = lane; d4 < hd / 4; d4 += 32) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(kq + (size_t)t * hd + 4 * d4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kf = (float)(int8_t)((w >> (8 * e)) & 0xFFu) * kscale;
            a = fmaf(qr[4 * d4 + e], kf, a);
          }
        }
      }
      a = warp_sum(a);
      if (lane == 0)
        sc[(size_t)r * chunk + t] =
            (t < n && base + t <= pos) ? a * sm_scale : -1e30f;
    }
    __syncthreads();

    // 3. online-softmax update, one warp per head
    for (int r = warp; r < rep; r += NWARPS) {
      float* row = sc + (size_t)r * chunk;
      float mx = -1e30f;
      for (int t = lane; t < chunk; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < chunk; t += 32) {
        const float p = (t < n && base + t <= pos) ? expf(row[t] - m_cur) : 0.f;
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_cur);
        alpha[r] = al;
        l[r] = __fadd_rn(__fmul_rn(al, l[r]), sum);  // no FMA contraction
        m[r] = m_cur;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ v, one thread per (head r, dim d)
    for (int o = tid; o < rep * hd; o += THREADS) {
      const int r = o / hd, d = o % hd;
      const float* prow = sc + (size_t)r * chunk;
      float pv = 0.f;
      for (int t = 0; t < n; ++t)
        pv = fmaf(prow[t], (float)(int8_t)vq[(size_t)t * hd + d] * vs[t], pv);
      acc[o] = __fadd_rn(__fmul_rn(acc[o], alpha[r]), pv);
    }
    __syncthreads();
  }

  if (my_cor) atomicAdd(&cnt[0], my_cor);
  if (my_due) atomicAdd(&cnt[1], my_due);
  __syncthreads();
  for (int o = tid; o < rep * hd; o += THREADS)
    from_float(acc[o] / l[o / hd], &out[((int64_t)b * H + g * rep) * hd + o]);
  if (tid < 2) flags[((int64_t)b * KV + g) * 2 + tid] = cnt[tid];
}

template <typename T>
int launch(const void* q, const void* ke, const void* kch, const void* ksc,
           const void* ve, const void* vch, const void* vsc, const void* pos,
           void* out, void* flags, int B, int S, int KV, int H, int hd,
           int chunk, int scheme, float sm_scale, size_t smem,
           cudaStream_t stream) {
  auto kern = chunked_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, KV), THREADS, smem, stream>>>(
      (const T*)q, (const uint8_t*)ke, (const uint8_t*)kch, (const float*)ksc,
      (const uint8_t*)ve, (const uint8_t*)vch, (const float*)vsc,
      (const int*)pos, (T*)out, (int*)flags, S, KV, H, hd, chunk, scheme,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q_bf16: 1 when q/out are bfloat16, 0 when float32. scheme: 0 faulty
// (bytes pass through), 1 in-place, 2 parity-zero (kch/vch: the (B, S, KV,
// hd/8) check strips; NULL for the other schemes). chunk: tokens per chunk
// (<= S). smem: dynamic shared bytes; must equal the layout above.
extern "C" int chunked_page_attention_launch(
    const void* q, const void* ke, const void* kch, const void* ksc,
    const void* ve, const void* vch, const void* vsc, const void* pos,
    void* out, void* flags, int B, int S, int KV, int H, int hd, int chunk,
    int scheme, float sm_scale, long long smem, int q_bf16, void* stream) {
  if (chunk < 1 || hd % 8 || H % KV || scheme < 0 || scheme > 2 ||
      (scheme == 2 && (!kch || !vch)) ||
      (size_t)smem != smem_layout_bytes(chunk, hd, H / KV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return launch<__nv_bfloat16>(q, ke, kch, ksc, ve, vch, vsc, pos, out,
                                 flags, B, S, KV, H, hd, chunk, scheme,
                                 sm_scale, (size_t)smem, s);
  return launch<float>(q, ke, kch, ksc, ve, vch, vsc, pos, out, flags, B, S,
                       KV, H, hd, chunk, scheme, sm_scale, (size_t)smem, s);
}
