// Masked-semiring SpMV (K4) and SpMM (K4m) row kernels for Hopper.
//
// ---- K4, spmv: one dense column -------------------------------------
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
//
// ---- K4m, spmm: a dense (nx, k) block --------------------------------
//
// Replaces the same TPU kernel, semiring_ell_kernel
// (src/repro/kernels/semiring_spmv.py:56), as its k-column wrapper
// semiring_spmm (src/repro/kernels/ops.py:143) runs it on a (k, tiles)
// grid, with that wrapper's ELL pack and its COO-overflow segment reduce
// over all m edges x k columns: Y<mask>[i, c] = (+)_{e in row i}
// vals[e] (x) X[cols[e], c], X row-major float32, the (+)-identity on
// empty and masked-out rows. Reach runs it with or_and at k = B sources,
// label propagation with plus_times at k = 32 one-hot label columns.
//  * One warp per (row, 32-column chunk): lanes split into G = 32 / KP
//    edge groups x KP columns, KP = pow2(k) capped at 32 (one group of 32
//    columns when k >= 32). The warp reads 32 of the row's columns (and
//    values) at once, coalesced; group g then takes edges g, g + G, ...
//    of the chunk by shuffles, so its lanes read KP consecutive floats of
//    one row of X and issue KP independent loads per chunk (32 at
//    k >= 32); the next chunk's columns are loaded before this chunk's
//    rows of X.
//  * Heavy rows: a row of d edges costs one warp d / 32 chunk steps, and
//    the hubs of a power-law graph (9,699 edges at rmat scale 16, 163,558
//    at 22) would leave one warp running long after the rest of the grid.
//    A row of more than kHeavy edges is split over the block's 8 warps
//    instead, one contiguous share each.
//  * Each group folds its edges in ascending order starting from the
//    fold's identity (0 for plus, as the reference's segment_sum starts
//    there; -inf for or_and's max, so a row's result is the max of its
//    own products, as segment_max gives it); the groups merge by a fixed
//    shuffle tree, a heavy row's shares in warp order. Every output is
//    folded in one fixed order: the kernel is deterministic. At k >= 32,
//    on rows of at most kHeavy edges, the fold IS the ascending edge
//    order of the plain version (index_add_ on the CPU). For min, max
//    and plus over integer values below 2^24 any order gives the same
//    bits, which covers reach (0/1) and label propagation (vote counts
//    at most the degree).
//  * Indices are int32: the wrapper refuses n*k or nx*k past 2^31.
// Bound by bytes: per edge a 4-byte column (plus 4 of value) and k*4
// bytes of X gathered (through L2 where X fits its 50 MB), per row 4 of
// offsets, 1 of mask and k*4 of output.
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

// the fold's starting value: the (+)-identity, but -inf for or_and's max
// (segment_max covers a row's own products only)
template <int SR>
__device__ __forceinline__ float fold_init() {
  return SR == kOrAnd ? __int_as_float(0xff800000) : Ring<SR>::zero();
}

// rows longer than this are split over the block's warps
constexpr int kHeavy = 1024;

// One warp's fold of column c over the edges [start, end) of one row:
// lanes split into 32 / KP edge groups x KP columns, group g takes edges
// g, g + G, ... of each 32-edge chunk in ascending order, then the groups
// merge by a fixed shuffle tree. The result is valid in group 0's lanes.
// KP = columns per edge group (a power of two, at most 32).
template <int SR, int KP>
__device__ __forceinline__ float fold_range(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, int nx, int k, int c, bool col_ok,
    int start, int end) {
  using R = Ring<SR>;
  constexpr int G = 32 / KP;                  // edge groups per warp
  const int lane = threadIdx.x & 31;
  const int g = lane / KP;
  float v = fold_init<SR>();
  // lane l holds edge e0 + l of the current chunk; the next chunk's
  // column and value are loaded before this one's X rows, so the column
  // load's latency overlaps the gathers
  int nxt_col = 0;
  float nxt_val = 0.0f;
  if (start + lane < end) {
    nxt_col = cols[start + lane];
    if (vals != nullptr) nxt_val = vals[start + lane];
  }
  for (int e0 = start; e0 < end; e0 += 32) {
    const int cnt = min(32, end - e0);
    const int my_col = min(max(nxt_col, 0), nx - 1);
    const float my_val = nxt_val;
    if (e0 + 32 + lane < end) {
      nxt_col = cols[e0 + 32 + lane];
      if (vals != nullptr) nxt_val = vals[e0 + 32 + lane];
    }
    float p[KP];
#pragma unroll
    for (int t = 0; t < KP; ++t) {            // independent loads first
      const int j = t * G + g;
      const int col = __shfl_sync(kFull, my_col, j);
      const float a = __shfl_sync(kFull, my_val, j);
      const float xv = (j < cnt && col_ok) ? x[col * k + c] : 0.0f;
      p[t] = vals != nullptr ? R::mul(a, xv) : xv;
    }
#pragma unroll
    for (int t = 0; t < KP; ++t) {            // then the ordered fold
      if (t * G + g < cnt) v = R::add(v, p[t]);
    }
  }
  // merge the groups: lane l takes lane l + off, a fixed tree
#pragma unroll
  for (int off = 16; off >= KP; off >>= 1) {
    v = R::add(v, __shfl_down_sync(kFull, v, off));
  }
  return v;
}

// Warp w of the grid owns (row, 32-column chunk) w. A row of at most
// kHeavy edges is folded by its warp alone; a longer one by all the
// block's warps, each over one contiguous share of the row, the shares'
// partials then folded in warp order through shared memory.
template <int SR, int KP>
__global__ void spmm_rows(const int* __restrict__ offsets,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const float* __restrict__ x, int nx, int k,
                          const unsigned char* __restrict__ mask, int n,
                          int nchunk, float* __restrict__ y) {
  using R = Ring<SR>;
  __shared__ int heavy_row[kWarps];           // -1 = none
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / KP;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const bool have = w < static_cast<long long>(n) * nchunk;
  const int row = have ? static_cast<int>(w / nchunk) : 0;
  const int c = (have ? static_cast<int>(w % nchunk) : 0) * 32 + lane % KP;
  const bool col_ok = c < k;
  int start = 0, end = 0;
  bool live = false;
  if (have) {                                 // warp-uniform
    start = offsets[row];
    end = offsets[row + 1];
    live = end > start && (mask == nullptr || mask[row]);
  }
  const bool heavy = live && end - start > kHeavy;
  if (lane == 0) heavy_row[warp] = heavy ? row : -1;
  if (have && !heavy) {
    float v = R::zero();
    if (live) v = fold_range<SR, KP>(cols, vals, x, nx, k, c, col_ok, start,
                                     end);
    if (g == 0 && col_ok) y[row * k + c] = v;
  }
  __syncthreads();
  for (int h = 0; h < kWarps; ++h) {          // block-uniform loop
    const int hrow = heavy_row[h];
    if (hrow < 0) continue;
    const long long wh = static_cast<long long>(blockIdx.x) * kWarps + h;
    const int hc = static_cast<int>(wh % nchunk) * 32 + lane % KP;
    const int hs = offsets[hrow], he = offsets[hrow + 1];
    const int share = (he - hs + kWarps * 32 - 1) / (kWarps * 32) * 32;
    const int s0 = min(hs + warp * share, he);
    const float pv = fold_range<SR, KP>(cols, vals, x, nx, k, hc, hc < k,
                                        s0, min(s0 + share, he));
    if (g == 0) part[warp][lane] = pv;
    __syncthreads();
    if (warp == h && g == 0 && hc < k) {
      float t = part[0][lane];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) t = R::add(t, part[q][lane]);
      y[hrow * k + hc] = t;
    }
    __syncthreads();
  }
}

template <int SR>
int launch_mm(const int* offsets, const int* cols, const float* vals,
              const float* x, int nx, int k, const unsigned char* mask,
              int n, float* y, cudaStream_t st) {
  int kp = 1;
  while (kp < k && kp < 32) kp *= 2;
  const int nchunk = (k + 31) / 32;
  const long long warps = static_cast<long long>(n) * nchunk;
  const int grid = static_cast<int>((warps + kWarps - 1) / kWarps);
#define REPRO_SPMM_CASE(KK)                                               \
  case KK:                                                                \
    spmm_rows<SR, KK><<<grid, kThreads, 0, st>>>(offsets, cols, vals, x,  \
                                                 nx, k, mask, n, nchunk,  \
                                                 y);                      \
    break;
  switch (kp) {
    REPRO_SPMM_CASE(1)
    REPRO_SPMM_CASE(2)
    REPRO_SPMM_CASE(4)
    REPRO_SPMM_CASE(8)
    REPRO_SPMM_CASE(16)
    REPRO_SPMM_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT int spmm(int semiring, const int* offsets, const int* cols,
                const float* vals, const float* x, int nx, int k,
                const unsigned char* mask, int n, float* y, void* stream) {
  if (n == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kPlusTimes:
      return launch_mm<kPlusTimes>(offsets, cols, vals, x, nx, k, mask, n,
                                   y, st);
    case kMinPlus:
      return launch_mm<kMinPlus>(offsets, cols, vals, x, nx, k, mask, n, y,
                                 st);
    case kOrAnd:
      return launch_mm<kOrAnd>(offsets, cols, vals, x, nx, k, mask, n, y,
                               st);
    case kMaxMin:
      return launch_mm<kMaxMin>(offsets, cols, vals, x, nx, k, mask, n, y,
                                st);
    case kPlusAnd:
      return launch_mm<kPlusAnd>(offsets, cols, vals, x, nx, k, mask, n, y,
                                 st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
