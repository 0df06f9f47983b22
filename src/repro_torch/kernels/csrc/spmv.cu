// Masked-semiring SpMV row kernel (K4) for Hopper.
//
// Replaces the TPU kernel semiring_ell_kernel
// (src/repro/kernels/semiring_spmv.py:56) together with the ELL pack and
// the COO-overflow merge of its wrapper (src/repro/kernels/ops.py:143-217).
// One warp per row reads the CSR directly, so no per-call ELL pack exists,
// and folds the row exactly as the reference's hybrid sweep
// (src/repro/linalg/ops.py:113-141):
//   * the first `width` edges by the pairwise halving tree over pow2(width)
//     lanes, padded with the ⊕-identity: leaf j sits in lane j % 32, slot
//     j / 32; the levels of stride ≥ 32 fold within a thread's registers,
//     the last five by __shfl_down_sync;
//   * the edges past `width` one at a time in ascending edge order: the
//     warp loads 32 products at once, every lane takes all 32 by shuffles,
//     then folds them in order (the heavy-row overflow sits inside the
//     kernel, deterministically — an atomic index_add_ adds in no fixed
//     order). This ordered fold is the one serial chain of the kernel: a
//     row of d edges costs d dependent adds;
//   * empty and masked-out rows get the ⊕-identity.
// Products and sums use __fmul_rn / __fadd_rn (and the build passes
// -fmad=false), so no multiply-add is contracted: each product and each
// sum rounds as PyTorch's separate operations do.
// Bound by bytes: per edge a 4-byte column read (coalesced, plus 4 bytes
// of value when weighted), x read once (4 bytes per vertex: 16.8 MB at
// rmat scale 22, which the 50 MB L2 holds), per row 4 bytes of offsets
// and 4 of output. The per-edge random gathers of x go through L2. Rows
// shorter than 32 leave lanes idle; the gather, not the lanes, is the
// cost.
#include "common.cuh"

namespace {

// semiring codes, the order of repro_torch.linalg.semiring.SEMIRINGS
enum { kPlusTimes = 0, kMinPlus = 1, kOrAnd = 2, kMaxMin = 3, kPlusAnd = 4 };

template <int SR>
struct Ring;

template <>
struct Ring<kPlusTimes> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <>
struct Ring<kMinPlus> {
  static __device__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ float add(float a, float b) { return fminf(a, b); }
  static __device__ float mul(float a, float b) { return __fadd_rn(a, b); }
};
template <>
struct Ring<kOrAnd> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
};
template <>
struct Ring<kMaxMin> {
  static __device__ float zero() { return __int_as_float(0xff800000); }
  static __device__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
};
template <>
struct Ring<kPlusAnd> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
};

// C = pow2(width) / 32 leaves per lane (1 when pow2(width) <= 32)
template <int SR, int C>
__global__ void spmv_rows(const int* __restrict__ offsets,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const float* __restrict__ x, int nx,
                          const unsigned char* __restrict__ mask, int n,
                          int width, int wp, float* __restrict__ y) {
  using R = Ring<SR>;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;                       // uniform across the warp
  const int start = offsets[row];
  const int deg = offsets[row + 1] - start;
  if (deg == 0 || (mask != nullptr && !mask[row])) {
    if (lane == 0) y[row] = R::zero();
    return;
  }
  const int lim = min(deg, width);
  float q[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = lane + 32 * i;
    float p = R::zero();
    if (j < lim) {
      const int e = start + j;
      const float xv = x[min(max(cols[e], 0), nx - 1)];
      p = vals != nullptr ? R::mul(vals[e], xv) : xv;
    }
    q[i] = p;
  }
  // halving levels of stride >= 32: leaf i*32+lane meets (i+h)*32+lane
#pragma unroll
  for (int h = C / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) q[i] = R::add(q[i], q[i + h]);
  }
  float v = q[0];
  for (int k = min(wp, 32) / 2; k >= 1; k >>= 1) {
    v = R::add(v, __shfl_down_sync(kFull, v, k));
  }
  if (deg > width) {
    v = __shfl_sync(kFull, v, 0);             // lane 0 holds the tree
    const int end = start + deg;
    for (int e0 = start + width; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      float p = R::zero();
      if (e < end) {
        const float xv = x[cols[e]];
        p = vals != nullptr ? R::mul(vals[e], xv) : xv;
      }
      // gather the chunk's 32 products first (independent shuffles), so
      // the dependent chain holds only the adds
      float chunk[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) chunk[t] = __shfl_sync(kFull, p, t);
      const int cnt = min(32, end - e0);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t < cnt) v = R::add(v, chunk[t]);
      }
    }
  }
  if (lane == 0) y[row] = v;
}

template <int SR>
int launch(int c, const int* offsets, const int* cols, const float* vals,
           const float* x, int nx, const unsigned char* mask, int n,
           int width, int wp, float* y, cudaStream_t st) {
  const int rows_per_block = kThreads / 32;
  const int grid = (n + rows_per_block - 1) / rows_per_block;
#define REPRO_SPMV_CASE(CC)                                               \
  case CC:                                                                \
    spmv_rows<SR, CC><<<grid, kThreads, 0, st>>>(offsets, cols, vals, x,  \
                                                 nx, mask, n, width, wp, y); \
    break;
  switch (c) {
    REPRO_SPMV_CASE(1)
    REPRO_SPMV_CASE(2)
    REPRO_SPMV_CASE(4)
    REPRO_SPMV_CASE(8)
    REPRO_SPMV_CASE(16)
    REPRO_SPMV_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMV_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT int spmv(int semiring, const int* offsets, const int* cols,
                const float* vals, const float* x, int nx,
                const unsigned char* mask, int n, int width, float* y,
                void* stream) {
  if (n == 0) return 0;
  int wp = 1;
  while (wp < width) wp *= 2;
  const int c = wp > 32 ? wp / 32 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kPlusTimes:
      return launch<kPlusTimes>(c, offsets, cols, vals, x, nx, mask, n,
                                width, wp, y, st);
    case kMinPlus:
      return launch<kMinPlus>(c, offsets, cols, vals, x, nx, mask, n, width,
                              wp, y, st);
    case kOrAnd:
      return launch<kOrAnd>(c, offsets, cols, vals, x, nx, mask, n, width,
                            wp, y, st);
    case kMaxMin:
      return launch<kMaxMin>(c, offsets, cols, vals, x, nx, mask, n, width,
                             wp, y, st);
    case kPlusAnd:
      return launch<kPlusAnd>(c, offsets, cols, vals, x, nx, mask, n, width,
                              wp, y, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
