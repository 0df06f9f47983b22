// Stable batched stream compaction (K2) for Hopper.
//
// Replaces the TPU kernel filter_compact_kernel
// (src/repro/kernels/filter_compact.py:42), which the reference vmaps over
// the lanes of a batch (src/repro/core/frontier.py:309). This one takes the
// (B, cap) batch directly: packed[b] = values[b][mask[b]] in order, -1
// after the last kept entry, totals[b] = number kept. Three launches:
//   1. cp_count:  per-block kept counts (warp ballot + popc);
//   2. scan_rows: exclusive scan of the block counts per lane → totals;
//   3. cp_emit:   kept entries land at block offset + in-block rank, and
//                 the tail [total, cap) is filled with -1.
// Bound by bytes: it reads 1 byte of mask and writes 4 bytes per entry and
// reads 4 bytes per kept entry. The TPU kernel's one-hot matrix "scatter"
// (O(tile²) compares) becomes a ballot and a direct store: every read and
// write is coalesced, and the mask is read twice (the second time from L2).
// `values` may be one row broadcast over the batch (row stride 0). The
// block size comes from the wrapper (the tuner's op "compact"); the
// block scan is instantiated for each of 64 ... 1024 threads.
#include "common.cuh"

namespace {

template <int T>
__global__ void cp_count(const unsigned char* __restrict__ mask, int cap,
                         int* __restrict__ bcount) {
  __shared__ int warp_sums[T / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const bool keep = i < cap && mask[b * cap + i];
  int count;
  block_rank<T / 32>(keep, warp_sums, &count);
  if (threadIdx.x == 0) bcount[b * gridDim.x + blockIdx.x] = count;
}

template <int T>
__global__ void cp_emit(const int* __restrict__ values, long long vstride,
                        const unsigned char* __restrict__ mask, int cap,
                        const int* __restrict__ boff,
                        const int* __restrict__ totals,
                        int* __restrict__ packed) {
  __shared__ int warp_sums[T / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const bool keep = i < cap && mask[b * cap + i];
  int count;
  const int r = block_rank<T / 32>(keep, warp_sums, &count);
  if (keep) {
    packed[b * cap + boff[b * gridDim.x + blockIdx.x] + r] =
        values[b * vstride + i];
  }
  const int stride = gridDim.x * blockDim.x;
  for (int j = totals[b] + i; j < cap; j += stride) packed[b * cap + j] = -1;
}

}  // namespace

EXPORT int compact_batch(const int* values, long long vstride,
                         const unsigned char* mask, int batch, int cap,
                         int* bcount, int* boff, int* packed, int* totals,
                         int threads, void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (cap + threads - 1) / threads;
  const dim3 grid(nblk, batch);
#define REPRO_CP_COUNT(T) cp_count<T><<<grid, T, 0, st>>>(mask, cap, bcount)
  REPRO_FOR_THREADS(threads, REPRO_CP_COUNT)
#undef REPRO_CP_COUNT
  scan_rows<<<batch, 1024, 0, st>>>(bcount, nblk, boff, totals, nullptr, 0);
#define REPRO_CP_EMIT(T)                                                  \
  cp_emit<T><<<grid, T, 0, st>>>(values, vstride, mask, cap, boff, totals, \
                                 packed)
  REPRO_FOR_THREADS(threads, REPRO_CP_EMIT)
#undef REPRO_CP_EMIT
  return static_cast<int>(cudaGetLastError());
}
