// Stable batched stream compaction (K2) for Hopper.
//
// Replaces the TPU kernel filter_compact_kernel
// (src/repro/kernels/filter_compact.py:42), which the reference vmaps over
// the lanes of a batch (src/repro/core/frontier.py:309). This one takes the
// (B, cap) batch directly: packed[b] = values[b][mask[b]] in order, -1
// after the last kept entry, totals[b] = number kept. One launch, a
// single-pass ordered compaction with decoupled look-back (common.cuh):
// one persistent grid takes the tiles of T·16 entries of every lane, lane
// after lane, in ticket order from one counter; each thread reads its 16 mask bytes as one 16-byte load (byte loads
// where the row is not 16-byte aligned or at its ragged end), the block
// ranks the kept entries, the tile's prefix comes from its predecessors'
// statuses, the kept entries' positions are staged in shared memory and
// their values are read (only those) and stored in order, coalesced, at
// tile prefix + in-tile rank. A lane's last tile writes its total; once
// every tile is taken, each block waits for each lane's total in turn and
// fills its contiguous part of that lane's tail [total, cap) with -1. Bound by bytes: 1 byte of mask and 4
// of output per entry, 4 per kept value. The TPU kernel's one-hot matrix
// "scatter" (O(tile²) compares) becomes a ballot-free popcount rank and a
// direct store. `values` may be one row broadcast over the batch (row
// stride 0). The block size comes from the wrapper (the tuner's op
// "compact"); blocks of any size give the same outputs.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kItems = 16;               // mask bytes a thread

// Bit q set where byte q of the 16 mask bytes is nonzero.
__device__ __forceinline__ unsigned mask_bits(uint4 w) {
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned y = __vcmpne4(x[q], 0u);      // 0xff per nonzero byte
    bits |= ((y & 1u) | ((y >> 7) & 2u) | ((y >> 14) & 4u) |
             ((y >> 21) & 8u)) << (4 * q);
  }
  return bits;
}

template <int T>
__global__ void __launch_bounds__(T)
cp_kernel(const int* __restrict__ values, long long vstride,
          const unsigned char* __restrict__ mask, int batch, int cap,
          u64* counter, u64* status, unsigned epoch, int* __restrict__ packed,
          int* __restrict__ totals) {
  constexpr int S = T * kItems;
  __shared__ unsigned short stage[S];
  __shared__ int warp_buf[T / 32];
  __shared__ int s_ticket, s_prefix, s_total;
  const int ntiles = cap > 0 ? (cap - 1) / S + 1 : 0;
  const long long all = static_cast<long long>(batch) * ntiles;
  u64 tag = 0;
  if (threadIdx.x == 0) tag = enter_epoch(counter, epoch);
  for (;;) {
    if (threadIdx.x == 0) s_ticket = next_ticket(counter, tag);
    __syncthreads();
    const int t = s_ticket;
    if (t >= all) break;
    const int b = t / ntiles, j = t - b * ntiles;
    const unsigned char* mrow = mask + static_cast<size_t>(b) * cap;
    const long long i0 = static_cast<long long>(j) * S + threadIdx.x * kItems;
    unsigned bits = 0;
    if ((reinterpret_cast<uintptr_t>(mrow) & 15) == 0 && i0 + kItems <= cap) {
      bits = mask_bits(*reinterpret_cast<const uint4*>(mrow + i0));
    } else {
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        if (i0 + q < cap && mrow[i0 + q]) bits |= 1u << q;
      }
    }
    int count;
    int r = block_excl_sum<T>(__popc(bits), warp_buf, &count);
    if (threadIdx.x < 32) {
      const int prefix = tile_prefix(status + static_cast<size_t>(b) * ntiles,
                                     j, epoch, count);
      if (threadIdx.x == 0) {
        s_prefix = prefix;
        if (j == ntiles - 1) totals[b] = prefix + count;
      }
    }
    for (unsigned bb = bits; bb; bb &= bb - 1) {
      stage[r++] = static_cast<unsigned short>(threadIdx.x * kItems +
                                               __ffs(bb) - 1);
    }
    __syncthreads();
    const int* vt = values + b * vstride + static_cast<long long>(j) * S;
    int* ot = packed + static_cast<size_t>(b) * cap + s_prefix;
    for (int i = threadIdx.x; i < count; i += T) ot[i] = vt[stage[i]];
    __syncthreads();
  }
  // every tile is taken: each lane's tail once its last tile is done
  for (int b = 0; b < batch; ++b) {
    if (threadIdx.x == 0) {
      s_total = ntiles > 0
          ? wait_prefix(status + static_cast<size_t>(b) * ntiles + ntiles - 1,
                        epoch)
          : 0;
      if (ntiles == 0 && blockIdx.x == 0) totals[b] = 0;
    }
    __syncthreads();
    fill_tail(packed + static_cast<size_t>(b) * cap, s_total, cap);
    __syncthreads();
  }
}

template <int T>
int cp_launch(const int* values, long long vstride, const unsigned char* mask,
              int batch, int cap, u64* counters, u64* status,
              long long status_cap, unsigned epoch, int* packed, int* totals,
              cudaStream_t st) {
  constexpr int S = T * kItems;
  const long long tiles = batch * (cap > 0 ? (cap - 1LL) / S + 1 : 0);
  if (tiles > status_cap || tiles >= INT_MAX || epoch >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int x = static_cast<int>(std::max<long long>(
      1, std::min<long long>(tiles, resident_blocks(cp_kernel<T>, T))));
  cp_kernel<T><<<x, T, 0, st>>>(values, vstride, mask, batch, cap,
                                counters, status, epoch, packed, totals);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT int compact_batch(const int* values, long long vstride,
                         const unsigned char* mask, int batch, int cap,
                         u64* counters, u64* status, long long status_cap,
                         unsigned epoch, int* packed, int* totals,
                         int threads, void* stream) {
  if (!valid_threads(threads) || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CP(T)                                                        \
  return cp_launch<T>(values, vstride, mask, batch, cap, counters, status, \
                      status_cap, epoch, packed, totals, st)
  REPRO_FOR_THREADS(threads, REPRO_CP)
#undef REPRO_CP
  return static_cast<int>(cudaErrorInvalidValue);
}
