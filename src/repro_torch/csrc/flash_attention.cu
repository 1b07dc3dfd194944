// Causal flash attention (online softmax) for the prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its _kernel and the _norm_kernel second pass). q, k, v, out: (BH, S, D)
// row-major. At prefill shapes it does 2*BH*S^2*D flops over the causal
// triangle against 4*BH*S*D*sizeof(T) bytes, so it is bound by its
// operations; keeping the score tile and the (m, l, o) state on chip keeps
// the S^2 scores out of device memory, which is what the kernel is for.
//
// Design: grid (ceil(S/64), BH), one CTA of 256 threads per (query tile of
// BQ = 64 rows, batch-head); the CTAs of the late, heavy query tiles are
// launched first. The TPU's sequential key-tile axis is a loop inside the
// CTA that stops at the causal diagonal: key tile kt runs while
// kt*BK <= last query row. Per key tile (BK = 64 keys) the CTA stages K and
// V in shared memory as f32 (rows padded to D+1 floats, so column reads hit
// distinct banks); each thread owns a 4x4 micro-tile of the 64x64 score
// tile (rows ty+16i, keys tx+16j) and a 4x(D/16) micro-tile of the output
// (rows ty+16i, dims tx+16j) in registers. It mirrors the reference's op
// order: s = q.k with f32 accumulation (bf16 products are exact in f32) and
// no rounding, times 1/sqrt(D), -1e30 where the key is after the query;
// m_new = max(m, rowmax); p = exp(s - m_new); alpha = exp(m - m_new);
// l = l*alpha + sum p; pv = round(p, T) @ v in f32; o = o*alpha + pv. The
// row reductions run over the 16 lanes of a half-warp. At the end
// out = o / max(l, 1e-30), rounded once to T: one kernel computes what the
// TPU's two passes compute. A ragged S is masked: key rows past S load as
// 0 and are causally invisible to every real query; query rows past S are
// not written.
//
// Known limits, kept for later: CUDA-core FMAs (no mma.sync / wgmma, no
// TMA), one CTA per SM at D = 128 (115 KB of shared memory), no overlap of
// tile loads with compute.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PLD = BK + 1;   // row stride of the probability tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}
// round a float to the value type, as `p.astype(v.dtype)` does
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

template <int D>
constexpr size_t smem_bytes() {
  return ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PLD) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S,
             float sm_scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;              // BQ x LD
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ps = Vs + BK * LD;    // BQ x PLD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int64_t base = (int64_t)blockIdx.y * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[r * LD + d] =
        q0 + r < S ? to_float(q[base + (int64_t)(q0 + r) * D + d]) : 0.f;
  }
  float o[4][DJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) o[i][jj] = 0.f;
  }

  const int last_row = min(q0 + BQ - 1, S - 1);
  for (int k0 = 0; k0 <= last_row; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < S;
      const int64_t g = base + (int64_t)(k0 + r) * D + d;
      Ks[r * LD + d] = in ? to_float(k[g]) : 0.f;
      Vs[r * LD + d] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
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
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = row >= key ? s[i][j] * sm_scale : -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to(p, v);
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
      for (int jj = 0; jj < DJ; ++jj) vb[jj] = Vs[c * LD + tx + 16 * jj];
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
      from_float(o[i][jj] / denom,
                 &out[base + (int64_t)row * D + tx + 16 * jj]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, float sm_scale, cudaStream_t stream) {
  auto kern = flash_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((S + BQ - 1) / BQ, BH), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int BH,
               int S, int D, float sm_scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, BH, S, sm_scale, s);
    case 32: return launch<T, 32>(q, k, v, out, BH, S, sm_scale, s);
    case 64: return launch<T, 64>(q, k, v, out, BH, S, sm_scale, s);
    case 128: return launch<T, 128>(q, k, v, out, BH, S, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out: (BH, S, D) contiguous; is_bf16: 1 for bfloat16, 0 for float32.
// D in {16, 32, 64, 128}; BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int D, float sm_scale, int is_bf16,
                                      void* stream) {
  if (BH < 1 || BH > 65535 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_dim<__nv_bfloat16>(q, k, v, out, BH, S, D, sm_scale, s);
  return launch_dim<float>(q, k, v, out, BH, S, D, sm_scale, s);
}
