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
// `values` may be one row broadcast over the batch (row stride 0).
#include "common.cuh"

namespace {

__global__ void cp_count(const unsigned char* __restrict__ mask, int cap,
                         int* __restrict__ bcount) {
  __shared__ int warp_sums[kWarps];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const bool keep = i < cap && mask[b * cap + i];
  int count;
  block_rank(keep, warp_sums, &count);
  if (threadIdx.x == 0) bcount[b * gridDim.x + blockIdx.x] = count;
}

__global__ void cp_emit(const int* __restrict__ values, long long vstride,
                        const unsigned char* __restrict__ mask, int cap,
                        const int* __restrict__ boff,
                        const int* __restrict__ totals,
                        int* __restrict__ packed) {
  __shared__ int warp_sums[kWarps];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const bool keep = i < cap && mask[b * cap + i];
  int count;
  const int r = block_rank(keep, warp_sums, &count);
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
                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (cap + kThreads - 1) / kThreads;
  const dim3 grid(nblk, batch);
  cp_count<<<grid, kThreads, 0, st>>>(mask, cap, bcount);
  scan_rows<<<batch, 1024, 0, st>>>(bcount, nblk, boff, totals, nullptr, 0);
  cp_emit<<<grid, kThreads, 0, st>>>(values, vstride, mask, cap, boff,
                                     totals, packed);
  return static_cast<int>(cudaGetLastError());
}
