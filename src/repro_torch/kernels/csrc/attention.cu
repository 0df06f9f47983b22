// Single-head fused attention with an online softmax (K7) for Hopper.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention.py:74): o = softmax(q k^T / sqrt(D))
// v for q (Sq, D) and k, v (Sk, D), fp32, bf16 or fp16, with the causal
// mask aligned to the ends (query i sees keys j <= i + Sk - Sq). Scores,
// softmax statistics and the accumulator are fp32, as in the reference,
// which casts its tiles to fp32 before both products; the output is
// rounded to q's type once, at the end.
//
// The Pallas kernel runs a (q tiles, kv tiles) grid whose kv axis goes in
// order, carrying the running max, normaliser and accumulator across grid
// steps in VMEM scratch. CUDA blocks run in no order, so here that axis is
// a loop inside one block per 64-query tile: the block keeps its Q tile
// in shared memory and its 64 x D accumulator in registers (4 rows x D/16
// columns a thread), and stages each 64-key K and V tile in shared memory,
// converted to fp32. Per kv tile:
//   1. scores: each thread 4 x 4 of the 64 x 64 tile, fp32 FMAs over D
//      (rows ty + 16 i, columns tx + 16 j; the Q and K rows are padded by
//      one float so neither read conflicts on a bank);
//   2. the reference's update, four threads per row: s = dot * scale,
//      s = -1e30 where masked, m' = max(m, max s), alpha = exp(m - m'),
//      p = exp(s - m') and 0 where masked, l' = alpha l + sum p;
//   3. acc = alpha acc + p v.
// At the end o = acc / max(l, 1e-30). The finite -1e30 and the clamp are
// the reference's (flash_attention.py:25, :68): a row that sees no key
// (Sq > Sk, causal) comes out 0, where -inf would give exp(-inf + inf) =
// NaN. Kv tiles wholly past a q tile's last visible key are skipped:
// in the reference they leave m, l and acc as they were (alpha = 1,
// p = 0), so the numbers are the same.
// The card's kernel picks its own tiles (64 x 64): the wrapper's bq and
// bk are the Pallas kernel's, and other tiles change only the order of
// the float sums.
// Shared memory: (64 (D'+1) x 2 + 64 D' + 64 x 65 + 3 x 64) x 4 bytes
// for D' = D rounded up to 64, 128 or 256 (214,528 bytes at D' = 256),
// above the 48 KB default, so each instantiation raises its limit with
// cudaFuncSetAttribute once.
// Bound: 4 Sq Sk D operations (2 Sq Sk D causal, about half the tiles)
// at the card's rate for the input type (fp32 on CUDA cores here, so 67
// TFLOP/s; bf16 counts at the tensor cores' 989), or q, k, v and o moved
// once, whichever is longer. This first version uses fp32 FMAs on the
// CUDA cores for every input type: no tensor cores.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

constexpr int kBQ = 64;               // queries per block
constexpr int kBK = 64;               // keys per kv tile
constexpr int kAttnThreads = 256;     // 16 x 16 threads
constexpr float kNegBig = -1e30f;     // the reference's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__host__ __device__ constexpr size_t attn_smem_bytes(int dp) {
  return (static_cast<size_t>(kBQ) * (dp + 1) +
          static_cast<size_t>(kBK) * (dp + 1) +
          static_cast<size_t>(kBK) * dp + static_cast<size_t>(kBQ) *
          (kBK + 1) + 3 * kBQ) * sizeof(float);
}

// load rows [r0, r0 + rows) of a (n, d) matrix into a (rows, stride)
// fp32 tile, zero past row n (columns past d are never read)
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int n,
                                          int d, int r0, int rows,
                                          float* dst, int stride) {
  for (int idx = threadIdx.x; idx < rows * d; idx += kAttnThreads) {
    const int r = idx / d, c = idx - r * d;
    const int g = r0 + r;
    dst[r * stride + c] =
        g < n ? to_f(src[static_cast<size_t>(g) * d + c]) : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kAttnThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
            int d, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int QS = DP + 1;          // padded row stride of Q and K
  constexpr int PS = kBK + 1;         // padded row stride of P
  constexpr int NJ = DP / 16;         // accumulator columns a thread
  float* sQ = smem;
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sV + kBK * DP;
  float* sM = sP + kBQ * PS;
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int shift = sk - sq;          // query i sees keys j <= i + shift

  load_tile(q, sq, d, q0, kBQ, sQ, QS);
  if (tid < kBQ) {
    sM[tid] = kNegBig;
    sL[tid] = 0.0f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  // keys past the tile's last query's limit are masked for every row
  int kend = sk;
  if (causal) kend = min(sk, min(q0 + kBQ, sq) + shift);

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                  // the last tile's reads are done
    load_tile(k, sk, d, k0, kBK, sK, QS);
    load_tile(v, sk, d, k0, kBK, sV, DP);
    __syncthreads();

    // 1. scores
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        const bool ok = kj < sk && (!causal || kj <= q0 + r + shift);
        sP[r * PS + c] = ok ? __fmul_rn(s[i][j], scale) : kNegBig;
      }
    }
    __syncthreads();

    // 2. the online-softmax update, four threads per row
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = sP + r * PS + part * 16;
      float mx = kNegBig;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_prev = sM[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_cur);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int kj = k0 + part * 16 + c;
        const bool ok = kj < sk && (!causal || kj <= q0 + r + shift);
        const float p = ok ? expf(row[c] - m_cur) : 0.0f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      __syncwarp();
      if (part == 0) {
        sM[r] = m_cur;
        sL[r] = alpha * sL[r] + sum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = alpha acc + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    const int kn = min(kBK, kend - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = sV[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) o[static_cast<size_t>(qi) * d + c] = from_f<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int sq,
           int sk, int d, float scale, int causal, cudaStream_t st) {
  constexpr size_t bytes = attn_smem_bytes(DP);
  static bool raised = false;         // the smem limit, once per kernel
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int grid = (sq + kBQ - 1) / kBQ;
  attn_kernel<T, DP><<<grid, kAttnThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int sq,
             int sk, int d, float scale, int causal, cudaStream_t st) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, sq, sk, d, scale, causal, st);
  if (d <= 128) {
    return launch<T, 128>(q, k, v, o, sq, sk, d, scale, causal, st);
  }
  return launch<T, 256>(q, k, v, o, sq, sk, d, scale, causal, st);
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16. d: a multiple of 8 in [8, 256].
EXPORT int flash_attention(int dtype, const void* q, const void* k,
                           const void* v, void* o, int sq, int sk, int d,
                           float scale, int causal, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, sq, sk, d, scale, causal, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, sq, sk, d, scale, causal,
                                     st);
    case 2:
      return launch_d<__half>(q, k, v, o, sq, sk, d, scale, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
