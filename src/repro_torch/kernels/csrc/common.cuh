// Shared device helpers of the graph kernels (sm_90a, plain C interface).
//
// Every launcher is an `extern "C"` function taking raw device pointers,
// sizes and PyTorch's current stream; it launches, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <climits>

#define EXPORT extern "C" __attribute__((visibility("default")))

// Threads per block where the launcher takes no block size (spmm,
// scan_rows has its own 1024); the tuned launchers take `threads`, one of
// kBlockSizes, from the wrapper (repro_torch.kernels.tuner, whose untuned
// default is this same 256).
constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr bool valid_threads(int t) {
  return t >= 64 && t <= 1024 && (t & (t - 1)) == 0;
}

// Instantiates CALL(T) for the block size `threads` (64 ... 1024) and
// returns cudaErrorInvalidValue for any other.
#define REPRO_FOR_THREADS(threads, CALL)                                  \
  switch (threads) {                                                      \
    case 64: CALL(64); break;                                             \
    case 128: CALL(128); break;                                           \
    case 256: CALL(256); break;                                           \
    case 512: CALL(512); break;                                           \
    case 1024: CALL(1024); break;                                         \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

EXPORT const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Load-balanced expansion search, the reference's `_lb_body`
// (repro/kernels/advance_fused.py:67-82): the upper bound of `slot` in the
// exclusive degree scan offs[0..cap_in), as a bounded binary search of at
// most `iters` steps, clamped to a valid input lane.
__device__ __forceinline__ int lb_search(const int* __restrict__ offs,
                                         int cap_in, int slot, int iters) {
  int lo = 0, hi = cap_in;
  for (int it = 0; it < iters && lo < hi; ++it) {
    const int mid = lo + ((hi - lo) >> 1);
    if (offs[mid] <= slot) lo = mid + 1; else hi = mid;
  }
  return max(min(lo - 1, cap_in - 1), 0);
}

// Exclusive rank of `flag` among the flagged threads of the block (in
// thread order) and the block's flag count, for a block of W warps. Every
// thread of the block must call it; `warp_sums` is shared memory of W
// ints.
template <int W>
__device__ __forceinline__ int block_rank(bool flag, int* warp_sums,
                                          int* total) {
  const unsigned ballot = __ballot_sync(kFull, flag);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int c = warp_sums[w];
    before += (w < warp) ? c : 0;
    all += c;
  }
  __syncthreads();                        // warp_sums may be reused
  *total = all;
  return before + rank;
}

// Exclusive scan of each row of counts (rows × nblk) into offs, one block
// of 1024 threads per row; writes the row total and, when `lengths` is
// given, min(total, clamp).
__global__ void scan_rows(const int* __restrict__ counts, int nblk,
                          int* __restrict__ offs, int* __restrict__ totals,
                          int* __restrict__ lengths, int clamp) {
  __shared__ int buf[1024];
  const size_t row = blockIdx.x;
  const int* c = counts + row * nblk;
  int* o = offs + row * nblk;
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, nblk);
  const int end = min(beg + per, nblk);
  int s = 0;
  for (int i = beg; i < end; ++i) s += c[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int v = threadIdx.x >= d ? buf[threadIdx.x - d] : 0;
    __syncthreads();
    buf[threadIdx.x] += v;
    __syncthreads();
  }
  int run = buf[threadIdx.x] - s;
  for (int i = beg; i < end; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (threadIdx.x == blockDim.x - 1) {
    const int total = buf[threadIdx.x];
    totals[row] = total;
    if (lengths != nullptr) lengths[row] = min(total, clamp);
  }
}
