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
// At decode batch (M = 4) the product does ~2 operations per weight byte,
// so the kernel is bound by reading the encoded weight once from device
// memory (K*N bytes); decoding in shared memory keeps decoded weights out
// of device memory, so protection adds no traffic.
//
// Design: each CTA owns a strip of BN = 64 output columns (8 whole ECC
// blocks per weight row), all of K, and a chunk of MC = 4 * RPT rows
// (grid: N strips x M chunks; the host picks the smallest RPT in
// {1, 2, 4, 8} whose chunk holds all of M, so at decode batch there is one
// chunk and every weight block is decoded exactly once per launch; for
// M > 32 each chunk's CTA decodes its strip again, and flags are counted
// only by the first chunk, so they never depend on M). It walks K in
// BK-row tiles: the encoded tile is read as 64-bit words, decoded
// (secded64.cuh) and stored in shared memory, as the dequantized float
// rounded to the activation's type (float path) or as int8 packed four K
// rows to a word (int paths); the activation tile is staged beside it.
// Every thread accumulates its column for RPT rows in K order: f32 FMAs on
// the float path, __dp4a (four exact int8 products into an int32) on the
// int paths. The output is written once.
//
// ABFT: per tile, each CTA adds a @ rowsum_strip(w) for its rows and
// colsum_chunk(a) @ w for its columns; after the K loop it sums its
// accumulator tile by row and by column and adds both pairs into (M,) and
// (N,) device buffers. The int paths add in `unsigned`, which wraps modulo
// 2^32 (defined, order-free, deterministic), matching the reference's
// int32 arithmetic; the float path sums in f32 per strip and adds across
// strips and chunks in f64 (order noise far below the 1e-4 tolerance),
// with |a| @ |w| beside it. A second launch compares the buffers: rows
// into rows[:, 0], mismatched columns counted into col_mm. Clamp hits are
// reduced per warp (a warp shares a row) and added into rows[:, 1].
//
// Requantize: res = float(acc [+ bias]) * (a_scale_row * w_scale), the
// scale product first, every step rounded to nearest (__fmul_rn: no FMA
// contraction), then the clamp, then a round-to-nearest-even cast.
//
// Edge tiles are masked (rows past K read as 0, blocks past N are skipped,
// activation rows past M are 0), so only N % 8 == 0 is required.
//
// Known limits, kept for a later change: N = 4096 gives 64 CTAs for 132
// SMs at decode batch; no tensor cores and no copy pipelining.
//
// Plain C interface for ctypes; launches on the given stream, allocates
// nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "secded64.cuh"

namespace {

constexpr int BN = 64;       // output columns per CTA (8 ECC blocks)
constexpr int BK = 64;       // weight rows per K tile
constexpr int THREADS = 256; // 64 columns x 4 row groups
constexpr int RG = THREADS / BN;
constexpr double ABFT_RTOL = 1e-4;  // repro/kernels/ecc_qmatmul.py:82-83
constexpr double ABFT_ATOL = 1e-6;

enum AKind { A_F32 = 0, A_BF16 = 1, A_I8 = 2 };
enum OutKind { OUT_F32 = 0, OUT_I32 = 1, OUT_BF16 = 2, OUT_F16 = 3 };

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
  int M, N, K;
  unsigned fault_bits;
};

__device__ __forceinline__ float load_a(const float* a, int64_t i) {
  return a[i];
}
__device__ __forceinline__ float load_a(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
// round a float to the activation type, as `.astype(a.dtype)` does
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int AK, int RPT>
__global__ void __launch_bounds__(THREADS) qmatmul_kernel(Args p) {
  constexpr bool INT = AK == A_I8;
  constexpr int MC = RG * RPT;
  using AT = typename std::conditional<AK == A_BF16, __nv_bfloat16,
                                       typename std::conditional<
                                           INT, int8_t, float>::type>::type;
  using Acc = typename std::conditional<INT, int, float>::type;
  // row / column checksum partials: unsigned (wrapping) or f32
  using Chk = typename std::conditional<INT, unsigned, float>::type;
  // weight tile: f32 [BK][BN], or int8 as words of 4 K rows [BK/4][BN];
  // activation tile: f32 [MC][BK], or int8 as words of 4 K [MC][BK/4]
  __shared__ __align__(16) unsigned char wsm[INT ? BK * BN : 4 * BK * BN];
  __shared__ __align__(16) unsigned char ash[INT ? MC * BK : 4 * MC * BK];
  __shared__ Acc acct[MC][BN];        // the accumulator tile, for ABFT
  __shared__ Acc wsum[BK], asum[BK];  // per-tile row sums of w, col sums of a
  __shared__ float wabs[BK], aabs[BK];
  __shared__ int cnt[2];
  const int M = p.M, N = p.N, K = p.K;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int mc0 = blockIdx.y * MC;
  const bool count = blockIdx.y == 0;
  const bool abft = p.rbuf != nullptr;
  const AT* A = static_cast<const AT*>(p.a);
  const float scale = INT ? 0.f : *p.w_scale;
  float* wf = reinterpret_cast<float*>(wsm);
  float* af = reinterpret_cast<float*>(ash);
  const int* wp = reinterpret_cast<const int*>(wsm);
  const int* ap = reinterpret_cast<const int*>(ash);
  auto wval = [&](int kr, int c) -> Acc {
    if constexpr (INT) {
      return (int)(int8_t)wsm[((kr >> 2) * BN + c) * 4 + (kr & 3)];
    } else {
      return wf[kr * BN + c];
    }
  };
  auto aval = [&](int r, int kk) -> Acc {
    if constexpr (INT) {
      return (int)(int8_t)ash[r * BK + kk];
    } else {
      return af[r * BK + kk];
    }
  };
  if (tid < 2) cnt[tid] = 0;

  Acc acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0;
  Chk rref = 0, cref = 0;    // thread tid < MC: row; tid < BN: column
  float rsc = 0.f, csc = 0.f;  // float path: the |a| @ |w| scales
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    // decode the (BK, BN) weight tile: BK*8 blocks
    for (int b = tid; b < BK * (BN / 8); b += THREADS) {
      const int kr = b / (BN / 8), jb = b % (BN / 8);
      const int k = k0 + kr, n = n0 + 8 * jb;
      const bool valid = k < K && n < N;
      uint64_t w = valid ? *reinterpret_cast<const uint64_t*>(
                               p.w_enc + (int64_t)k * N + n)
                         : 0ull;
      uint32_t f;
      w = secded64::decode(w, &f);
      if (valid && count && f) {
        if (f & 1u) atomicAdd(&cnt[0], 1);
        if (f & 2u) atomicAdd(&cnt[1], 1);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint8_t byte = (uint8_t)((w >> (8 * e)) & 0xFFull);
        if constexpr (INT) {
          wsm[((kr >> 2) * BN + 8 * jb + e) * 4 + (kr & 3)] = byte;
        } else {
          wf[kr * BN + 8 * jb + e] =
              round_to((float)(int8_t)byte * scale, A);
        }
      }
    }
    // stage the (MC, BK) activation tile; rows past M and K read as 0
    if constexpr (INT) {
      for (int idx = tid; idx < MC * (BK / 4); idx += THREADS) {
        const int r = idx / (BK / 4), c4 = idx % (BK / 4);
        const int m = mc0 + r;
        unsigned v = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + 4 * c4 + e;
          if (m < M && k < K)
            v |= (unsigned)(uint8_t)A[(int64_t)m * K + k] << (8 * e);
        }
        reinterpret_cast<unsigned*>(ash)[r * (BK / 4) + c4] = v;
      }
    } else {
      for (int idx = tid; idx < MC * BK; idx += THREADS) {
        const int r = idx / BK, c = idx % BK;
        const int m = mc0 + r, k = k0 + c;
        af[r * BK + c] = (m < M && k < K) ? load_a(A, (int64_t)m * K + k)
                                          : 0.f;
      }
    }
    __syncthreads();
    if (abft) {
      if (tid < BK) {
        Acc s = 0, t = 0;
        float sa = 0.f, ta = 0.f;
        for (int i = 0; i < BN; ++i) {
          const Acc v = wval(tid, (i + tid) & (BN - 1));  // rotate banks
          s += v;
          if constexpr (!INT) sa += fabsf(v);
        }
        for (int r = 0; r < MC; ++r) {
          const Acc v = aval(r, tid);
          t += v;
          if constexpr (!INT) ta += fabsf(v);
        }
        wsum[tid] = s;
        asum[tid] = t;
        wabs[tid] = sa;
        aabs[tid] = ta;
      }
      __syncthreads();
      if (tid < MC) {
        for (int i = 0; i < BK; ++i) {
          const int kk = (i + tid) & (BK - 1);
          const Acc av = aval(tid, kk);
          if constexpr (INT) {
            rref += (unsigned)(av * wsum[kk]);  // |.| <= 2^20: no overflow
          } else {
            rref = fmaf(av, wsum[kk], rref);
            rsc = fmaf(fabsf(av), wabs[kk], rsc);
          }
        }
      }
      if (tid < BN) {
        for (int kk = 0; kk < BK; ++kk) {
          const Acc wv = wval(kk, tid);
          if constexpr (INT) {
            cref += (unsigned)(asum[kk] * wv);  // |.| <= 2^19
          } else {
            cref = fmaf(asum[kk], wv, cref);
            csc = fmaf(aabs[kk], fabsf(wv), csc);
          }
        }
      }
    }
    if constexpr (INT) {
#pragma unroll 4
      for (int k4 = 0; k4 < BK / 4; ++k4) {
        const int wv = wp[k4 * BN + col];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          acc[j] = __dp4a(ap[(rg + RG * j) * (BK / 4) + k4], wv, acc[j]);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float wv = wf[kk * BN + col];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          acc[j] = fmaf(af[(rg + RG * j) * BK + kk], wv, acc[j]);
      }
    }
    __syncthreads();
  }

  // an injected fault in accumulator element (0, 0), before every check
  if (p.fault_bits && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    if constexpr (INT)
      acc[0] = (int)((unsigned)acc[0] ^ p.fault_bits);
    else
      acc[0] = __int_as_float(__float_as_int(acc[0]) ^ (int)p.fault_bits);
  }

  if (abft) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) acct[rg + RG * j][col] = acc[j];
    __syncthreads();
    if (tid < MC && mc0 + tid < M) {
      const int m = mc0 + tid;
      Chk s = 0;
      for (int i = 0; i < BN; ++i) {
        const int c = (i + tid) & (BN - 1);
        if (n0 + c < N) s += (Chk)acct[tid][c];
      }
      if constexpr (INT) {
        unsigned* rb = static_cast<unsigned*>(p.rbuf);
        atomicAdd(&rb[m], s);
        atomicAdd(&rb[M + m], rref);
      } else {
        double* rb = static_cast<double*>(p.rbuf);
        atomicAdd(&rb[m], (double)s);
        atomicAdd(&rb[M + m], (double)rref);
        atomicAdd(&rb[2 * M + m], (double)rsc);
      }
    }
    if (tid < BN && n0 + tid < N) {
      const int n = n0 + tid;
      Chk s = 0;
      for (int r = 0; r < MC; ++r)
        if (mc0 + r < M) s += (Chk)acct[r][tid];
      if constexpr (INT) {
        unsigned* cb = static_cast<unsigned*>(p.cbuf);
        atomicAdd(&cb[n], s);
        atomicAdd(&cb[N + n], cref);
      } else {
        double* cb = static_cast<double*>(p.cbuf);
        atomicAdd(&cb[n], (double)s);
        atomicAdd(&cb[N + n], (double)cref);
        atomicAdd(&cb[2 * N + n], (double)csc);
      }
    }
  }

  // epilogue: every branch below is uniform across a warp except `n < N`
  const int n = n0 + col;
  const bool ncol = n < N;
  const bool requant = INT && p.a_scale != nullptr;
  const bool has_clamp = p.clamp != nullptr;
  const float c = has_clamp ? *p.clamp : 0.f;
  const float ws = requant ? *p.w_scale : 0.f;
  const int bias = (requant && p.bias != nullptr && ncol) ? p.bias[n] : 0;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = mc0 + rg + RG * j;
    if (m >= M) continue;  // uniform: a warp shares rg
    const int64_t o = (int64_t)m * N + n;
    if (INT && !requant) {
      if (ncol) static_cast<int*>(p.out)[o] = (int)acc[j];
      continue;
    }
    float r;
    if constexpr (INT) {
      const int v = (int)((unsigned)acc[j] + (unsigned)bias);
      const float s = __fmul_rn(p.a_scale[(int64_t)m * p.a_scale_stride], ws);
      r = __fmul_rn(__int2float_rn(v), s);
    } else {
      r = acc[j];
    }
    if (has_clamp) {
      const bool hit = ncol && fabsf(r) > c;  // NaN: no hit, kept
      if (hit) r = r > 0.f ? c : -c;
      const int hits = __reduce_add_sync(0xffffffffu, hit ? 1 : 0);
      if ((tid & 31) == 0 && hits) atomicAdd(&p.rows[2 * m + 1], hits);
    }
    if (!ncol) continue;
    switch (p.out_kind) {
      case OUT_BF16:
        static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(r);
        break;
      case OUT_F16:
        static_cast<__half*>(p.out)[o] = __float2half_rn(r);
        break;
      default:
        static_cast<float*>(p.out)[o] = r;
    }
  }
  __syncthreads();
  if (tid < 2 && cnt[tid]) atomicAdd(&p.flags[tid], cnt[tid]);
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

template <int AK, int RPT>
void launch(const Args& p, cudaStream_t s) {
  constexpr int MC = RG * RPT;
  dim3 grid((p.N + BN - 1) / BN, (p.M + MC - 1) / MC);
  qmatmul_kernel<AK, RPT><<<grid, THREADS, 0, s>>>(p);
}

template <int AK>
void launch_rows(const Args& p, cudaStream_t s) {
  if (p.M <= RG)
    launch<AK, 1>(p, s);
  else if (p.M <= 2 * RG)
    launch<AK, 2>(p, s);
  else if (p.M <= 4 * RG)
    launch<AK, 4>(p, s);
  else
    launch<AK, 8>(p, s);
}

}  // namespace

// a_kind: AKind; out_kind: OutKind. a_scale, bias, clamp, rows, rbuf, cbuf
// and col_mm may be null (rbuf/cbuf/col_mm together: ABFT off). rbuf/cbuf
// hold 2*M / 2*N unsigned (int paths) or 3*M / 3*N doubles (float path),
// zeroed; flags, rows and col_mm are zeroed by the caller.
extern "C" int ecc_qmatmul_launch(const void* a, int a_kind, const void* w_enc,
                                  const void* w_scale, const void* a_scale,
                                  int a_scale_stride, const void* bias,
                                  const void* clamp, void* out, int out_kind,
                                  void* flags, void* rows, void* rbuf,
                                  void* cbuf, void* col_mm, int M, int N,
                                  int K, unsigned fault_bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Args p{a, (const uint8_t*)w_enc, (const float*)w_scale,
         (const float*)a_scale, a_scale_stride, (const int*)bias,
         (const float*)clamp, out, out_kind, (int*)flags, (int*)rows,
         rbuf, cbuf, M, N, K, fault_bits};
  if (a_kind == A_I8)
    launch_rows<A_I8>(p, s);
  else if (a_kind == A_BF16)
    launch_rows<A_BF16>(p, s);
  else
    launch_rows<A_F32>(p, s);
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
