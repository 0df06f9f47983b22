// Load-balanced advance (K3) and fused advance+filter (K1) for Hopper.
//
// K3 advance_batch replaces the TPU kernel advance_fused_batch_kernel
// (src/repro/kernels/advance_fused.py:210; its single-lane form
// advance_fused_kernel, :134, is a launch with B = 1). One thread per
// (lane, output slot): the LB upper-bound search over the lane's degree
// scan, then the CSR gathers, writing (src, dst, edge_id, in_pos, rank,
// valid). Bound by bytes: it writes 21 bytes per slot and reads ~8 (the
// column and row-offset gathers; the search's probes hit L1/L2 because
// neighbouring slots walk the same path). The design keeps every write
// coalesced (slot-major rows) and skips the search on dead slots, whose
// outputs are constants.
//
// K1 advance_filter_batch replaces advance_filter_fused_batch_kernel
// (src/repro/kernels/advance_filter_fused.py:196; advance_filter_fused_
// kernel, :117, is a launch with B = 1). The TPU kernel culls duplicates
// exactly by walking its grid in order with the bitmap carried across
// tiles; CUDA blocks run concurrently, so this is the reference's XLA
// algorithm in four launches:
//   1. af_expand: search + gathers + visited test; a kept slot does
//      atomicMin(first[b, dst], slot) and records (dst, src);
//   2. af_count:  a slot survives iff first[b, dst] == slot; per-block
//      survivor counts (warp ballot + popc);
//   3. scan_rows: exclusive scan of the block counts per lane → totals,
//      lengths = min(total, cap_front);
//   4. af_emit:   survivors land at block offset + in-block rank — in
//      ascending slot order, clamped at cap_front — each survivor resets
//      first[b, dst] to INT_MAX (work ∝ frontier, not B·n), and the tail
//      of ids/srcs is filled with -1.
// `first` is a (B, n) table the caller keeps filled with INT_MAX between
// calls. Both launchers take their threads per block from the wrapper
// (the tuner's ops "advance" and "advance_filter"); blocks of any size
// give the same outputs. Bound by bytes: ~8 bytes of gathers plus 16
// bytes of scratch traffic per slot, and random 4-byte atomics into
// `first`.
//
// Column storage (the graph's storage plan, repro_torch/core/storage.py).
// Both kernels are templates on how they read a column, as the TPU
// kernels' `_lb_body` reads it (src/repro/kernels/advance_fused.py:48-97,
// advance_filter_fused.py:97-108):
//   * DenseCols<T>: a dense array of int16, int32 or int64 ids, widened
//     to int32 after the gather (2, 4 or 8 bytes a slot);
//   * DeltaCols: the anchored-delta stream, dst = anchor[src] + delta[e]
//     with delta uint16 and `src` the row the LB search just produced
//     (2 bytes a slot plus a 4-byte anchor gather that neighbouring slots
//     of one row share).
// A delta stream with escapes (a delta past 0xFFFE, kept in a side list)
// never reaches a kernel: the wrapper hands it the decoded dense view, as
// the reference's `_split_store` does. The launchers take the storage as
// `kind` (kColInt32, kColInt16, kColInt64, kColDelta) and the pointers
// `cols` and `anchor` (anchor only for kColDelta).
#include "common.cuh"

namespace {

enum { kColInt32 = 0, kColInt16 = 1, kColInt64 = 2, kColDelta = 3 };

template <typename T>
struct DenseCols {
  const T* __restrict__ cols;
  __device__ __forceinline__ int at(int e, int) const {
    return static_cast<int>(cols[e]);
  }
};

struct DeltaCols {
  const unsigned short* __restrict__ delta;
  const int* __restrict__ anchor;
  __device__ __forceinline__ int at(int e, int src) const {
    return anchor[src] + static_cast<int>(delta[e]);
  }
};

template <typename Cols>
__global__ void adv_kernel(const int* __restrict__ offsets,
                           const int* __restrict__ base,
                           const int* __restrict__ row_offsets,
                           const Cols cols, int cap_in,
                           int cap_out, int m, int iters,
                           int* __restrict__ src, int* __restrict__ dst,
                           int* __restrict__ eid, int* __restrict__ in_pos,
                           int* __restrict__ rank,
                           unsigned char* __restrict__ valid) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= cap_out) return;
  const size_t b = blockIdx.y;
  const int* offs = offsets + b * (cap_in + 1);
  const size_t o = b * cap_out + slot;
  const int total = offs[cap_in];
  if (slot >= total) {
    // every probe of a dead slot goes right: the search ends on the last
    // input lane, and the masked outputs are constants
    src[o] = -1;
    dst[o] = -1;
    eid[o] = -1;
    in_pos[o] = max(cap_in - 1, 0);
    rank[o] = 0;
    valid[o] = 0;
    return;
  }
  const int pos = lb_search(offs, cap_in, slot, iters);
  const int rk = slot - offs[pos];
  const int s = base[b * cap_in + pos];
  const int e = row_offsets[s] + rk;
  src[o] = s;
  dst[o] = cols.at(min(max(e, 0), m - 1), s);
  eid[o] = e;
  in_pos[o] = pos;
  rank[o] = rk;
  valid[o] = 1;
}

template <typename Cols>
__global__ void af_expand(const int* __restrict__ offsets,
                          const int* __restrict__ base,
                          const int* __restrict__ row_offsets,
                          const Cols cols,
                          const unsigned char* __restrict__ visited, int n,
                          int cap_in, int cap_out, int m, int iters,
                          int* __restrict__ first, int* __restrict__ kdst,
                          int* __restrict__ ksrc) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= cap_out) return;
  const size_t b = blockIdx.y;
  const int* offs = offsets + b * (cap_in + 1);
  int d = -1, s = -1;
  if (slot < offs[cap_in]) {
    const int pos = lb_search(offs, cap_in, slot, iters);
    s = base[b * cap_in + pos];
    const int e = row_offsets[s] + (slot - offs[pos]);
    const int v = cols.at(min(max(e, 0), m - 1), s);
    if (!visited[b * n + v]) {
      d = v;
      atomicMin(first + b * n + v, slot);
    }
  }
  kdst[b * cap_out + slot] = d;
  ksrc[b * cap_out + slot] = s;
}

template <int T>
__global__ void af_count(const int* __restrict__ first, int n, int cap_out,
                         int* __restrict__ kdst, int* __restrict__ bcount) {
  __shared__ int warp_sums[T / 32];
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  bool survive = false;
  if (slot < cap_out) {
    const size_t o = b * cap_out + slot;
    const int d = kdst[o];
    if (d >= 0) {
      survive = first[b * n + d] == slot;
      if (!survive) kdst[o] = -1;
    }
  }
  int count;
  block_rank<T / 32>(survive, warp_sums, &count);
  if (threadIdx.x == 0) bcount[b * gridDim.x + blockIdx.x] = count;
}

template <int T>
__global__ void af_emit(const int* __restrict__ kdst,
                        const int* __restrict__ ksrc,
                        const int* __restrict__ boff,
                        const int* __restrict__ lengths, int n, int cap_out,
                        int cap_front, int* __restrict__ first,
                        int* __restrict__ ids, int* __restrict__ srcs) {
  __shared__ int warp_sums[T / 32];
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  const int d = slot < cap_out ? kdst[b * cap_out + slot] : -1;
  int count;
  const int r = block_rank<T / 32>(d >= 0, warp_sums, &count);
  if (d >= 0) {
    const int pos = boff[b * gridDim.x + blockIdx.x] + r;
    if (pos < cap_front) {
      ids[b * cap_front + pos] = d;
      srcs[b * cap_front + pos] = ksrc[b * cap_out + slot];
    }
    first[b * n + d] = INT_MAX;
  }
  const int stride = gridDim.x * blockDim.x;
  for (int j = lengths[b] + slot; j < cap_front; j += stride) {
    ids[b * cap_front + j] = -1;
    srcs[b * cap_front + j] = -1;
  }
}

// Calls LAUNCH(cols) with the column reader of `kind`; any other kind
// returns cudaErrorInvalidValue.
#define REPRO_FOR_COLS(kind, cols, anchor, LAUNCH)                         \
  switch (kind) {                                                          \
    case kColInt32:                                                        \
      LAUNCH((DenseCols<int>{static_cast<const int*>(cols)}));             \
      break;                                                               \
    case kColInt16:                                                        \
      LAUNCH((DenseCols<short>{static_cast<const short*>(cols)}));         \
      break;                                                               \
    case kColInt64:                                                        \
      LAUNCH((DenseCols<long long>{static_cast<const long long*>(cols)})); \
      break;                                                               \
    case kColDelta:                                                        \
      LAUNCH((DeltaCols{static_cast<const unsigned short*>(cols),          \
                        anchor}));                                         \
      break;                                                               \
    default:                                                               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
  }

}  // namespace

EXPORT int advance_batch(const int* offsets, const int* base,
                         const int* row_offsets, const void* cols,
                         const int* anchor, int kind, int batch, int cap_in,
                         int cap_out, int m, int iters, int* src, int* dst,
                         int* eid, int* in_pos, int* rank,
                         unsigned char* valid, int threads, void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((cap_out + threads - 1) / threads, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ADV(C)                                                        \
  adv_kernel<<<grid, threads, 0, st>>>(offsets, base, row_offsets, C,      \
                                       cap_in, cap_out, m, iters, src, dst, \
                                       eid, in_pos, rank, valid)
  REPRO_FOR_COLS(kind, cols, anchor, REPRO_ADV)
#undef REPRO_ADV
  return static_cast<int>(cudaGetLastError());
}

EXPORT int advance_filter_batch(const int* offsets, const int* base,
                                const int* row_offsets, const void* cols,
                                const int* anchor, int kind,
                                const unsigned char* visited, int batch,
                                int n, int cap_in, int cap_out, int m,
                                int iters, int cap_front, int* first,
                                int* kdst, int* ksrc, int* bcount, int* boff,
                                int* ids, int* srcs, int* lengths,
                                int* totals, int threads, void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (cap_out + threads - 1) / threads;
  const dim3 grid(nblk, batch);
#define REPRO_AF_EXPAND(C)                                                 \
  af_expand<<<grid, threads, 0, st>>>(offsets, base, row_offsets, C,      \
                                      visited, n, cap_in, cap_out, m,     \
                                      iters, first, kdst, ksrc)
  REPRO_FOR_COLS(kind, cols, anchor, REPRO_AF_EXPAND)
#undef REPRO_AF_EXPAND
#define REPRO_AF_COUNT(T) \
  af_count<T><<<grid, T, 0, st>>>(first, n, cap_out, kdst, bcount)
  REPRO_FOR_THREADS(threads, REPRO_AF_COUNT)
#undef REPRO_AF_COUNT
  scan_rows<<<batch, 1024, 0, st>>>(bcount, nblk, boff, totals, lengths,
                                    cap_front);
#define REPRO_AF_EMIT(T)                                                 \
  af_emit<T><<<grid, T, 0, st>>>(kdst, ksrc, boff, lengths, n, cap_out,  \
                                 cap_front, first, ids, srcs)
  REPRO_FOR_THREADS(threads, REPRO_AF_EMIT)
#undef REPRO_AF_EMIT
  return static_cast<int>(cudaGetLastError());
}
