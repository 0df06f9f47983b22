// Load-balanced advance (K3) and fused advance+filter (K1) for Hopper.
//
// K3 advance_batch replaces the TPU kernel advance_fused_batch_kernel
// (src/repro/kernels/advance_fused.py:210; its single-lane form
// advance_fused_kernel, :134, is a launch with B = 1, and so is mxm's
// expansion). It writes, for every (lane, output slot), (src, dst,
// edge_id, in_pos, rank, valid): 21 bytes a slot, live or dead, against
// 4 a lane's size and the column bytes of a live slot, so its bound is
// the bytes it writes. Two launches (lb_tiles.cuh): the int32 offsets
// scan K1 runs, which also writes the totals, and lb_expand_tiles, which
// walks only the live slots in tiles whose lanes are staged in shared
// memory (no per-slot search), stores each output row coalesced with
// evict-first stores, and fills each lane's dead tail with its constants
// in 16-byte stores. No PyTorch op runs between or after them.
//
// K1 advance_filter_batch replaces advance_filter_fused_batch_kernel
// (src/repro/kernels/advance_filter_fused.py:196; advance_filter_fused_
// kernel, :117, is a launch with B = 1). The TPU kernel culls duplicates
// exactly by walking its grid in order with the bitmap carried across
// tiles; CUDA blocks run concurrently, so the winner of each destination
// is its smallest unvisited slot (atomicMin into `first`), as in the
// reference's XLA algorithm. Three launches:
//   1. lb_offsets (lb_tiles.cuh): the exclusive degree scans in one
//      single-pass int32 scan (decoupled look-back, common.cuh); with
//      them each live input lane's edge base, each slot tile's first
//      input lane (Gunrock's load-balanced search, done once a tile by
//      the scan tile that holds the tile's first slot) and each lane's
//      live end;
//   2. af_expand:  an unvisited slot that reads a larger first[b, dst]
//      lowers it to its slot (no atomic when a smaller slot already
//      holds it) and sets its bit in a one-bit-a-slot candidate mask;
//   3. af_emit:    only a candidate can hold first[b, dst]; a slot
//      survives iff it does. Survivors land at tile prefix (look-back)
//      + in-tile rank, in ascending slot order, clamped at cap_front;
//      each survivor resets first[b, dst] to INT_MAX; the last tile
//      writes totals and lengths, and then the lane's blocks fill the
//      tail of ids / srcs with -1.
// Both passes walk only the live slots, min(offs[cap_in], cap_out) of
// each lane, in tiles of T·V slots (kTileSlots at most) on a persistent
// grid. A tile stages the start, source, edge base (and anchor) of each
// input lane it spans in shared memory and gives each slot its lane by
// a running maximum; its threads then take the slots in stride T, so
// column reads stay coalesced along a row. Pass 3 recomputes (dst, src)
// that way, only for candidates and only in tiles that have one, in
// place of (B, cap_out) scratch. `first` is a (B, n) table the caller
// keeps filled with INT_MAX between calls.
//
// Bound: bytes, 4 an input lane (its size), 8 a live one (base, row
// offset), the column bytes and 1 bitmap byte a live slot, and 8 an
// output slot. In practice the random accesses set the time: a bitmap
// byte a live slot, a first read a kept slot (then an atomic where it
// is smaller), a first read a candidate and a reset a survivor. They go
// through L2, which holds a lane's table (16 MB at n = 4M) while the
// persistent grid works through that lane's tiles.
// The launchers take their threads per block from the wrapper (the
// tuner's ops "advance" for K3, "advance_filter" for K1); blocks of any
// size give the same outputs.
//
// Column storage (the graph's storage plan, repro_torch/core/storage.py).
// Both kernels are templates on how they read a column, as the TPU
// kernels' `_lb_body` reads it (src/repro/kernels/advance_fused.py:48-97,
// advance_filter_fused.py:97-108):
//   * DenseCols<T>: a dense array of int16, int32 or int64 ids, widened
//     to int32 after the gather (2, 4 or 8 bytes a slot);
//   * DeltaCols: the anchored-delta stream, dst = anchor[src] + delta[e]
//     with delta uint16 and `src` the row of the slot's input lane
//     (2 bytes a slot plus a 4-byte anchor gather that neighbouring slots
//     of one row share).
// A delta stream with escapes (a delta past 0xFFFE, kept in a side list)
// never reaches a kernel: the wrapper hands it the decoded dense view, as
// the reference's `_split_store` does. The launchers take the storage as
// `kind` (kColInt32, kColInt16, kColInt64, kColDelta) and the pointers
// `cols` and `anchor` (anchor only for kColDelta).
#include "lb_tiles.cuh"

namespace {

enum { kColInt32 = 0, kColInt16 = 1, kColInt64 = 2, kColDelta = 3 };

// A column reader: row(src) is what the row contributes to every id of
// it (the anchor of a delta row, nothing for a dense one), at(e, row) the
// id at edge e.
template <typename T>
struct DenseCols {
  static constexpr bool kRows = false;
  const T* __restrict__ cols;
  __device__ __forceinline__ int row(int) const { return 0; }
  __device__ __forceinline__ int at(int e, int) const {
    return static_cast<int>(cols[e]);
  }
};

struct DeltaCols {
  static constexpr bool kRows = true;
  const unsigned short* __restrict__ delta;
  const int* __restrict__ anchor;
  __device__ __forceinline__ int row(int src) const { return anchor[src]; }
  __device__ __forceinline__ int at(int e, int a) const {
    return a + static_cast<int>(delta[e]);
  }
};

// ---- K1 ------------------------------------------------------------------

// The destination of tile slot i (slot s0 + i, live).
template <typename Cols, typename Sh>
__device__ __forceinline__ int slot_dst(const Sh& sh, const Cols& cols,
                                        int i, int slot, int m) {
  const int q = sh.mark[pad32(i)];
  const int e = sh.ebase[q] + slot;
  int r = 0;
  if constexpr (Cols::kRows) r = sh.row[q];
  return cols.at(min(max(e, 0), m - 1), r);
}

template <int T, typename Cols>
__global__ void __launch_bounds__(T, kMinThreads / T)
af_expand(const int* __restrict__ sizes, const int* __restrict__ offsets,
          const int* __restrict__ base,
          const int* __restrict__ ebase, const int* __restrict__ tile_lane,
          const Cols cols, const unsigned char* __restrict__ visited, int n,
          int cap_in, int cap_out, int m, int slot_tiles,
          const u64* __restrict__ live_end, unsigned scan_epoch,
          int* __restrict__ first, unsigned* __restrict__ cand) {
  constexpr int V = Tile<T>::V, S = Tile<T>::kSlots;
  __shared__ TileLanes<S, true, Cols::kRows, false> sh;
  const Lane ln = lane_of(sizes, offsets, base, ebase, tile_lane,
                          live_end, scan_epoch, cap_in, cap_out,
                          slot_tiles);
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* vis = visited + b * n;
  int* fst = first + b * n;
  unsigned* cw = cand + b * (static_cast<size_t>(slot_tiles) * (S / 32));
  const int ntiles = tiles_of<S>(ln.live);
  for (int j = blockIdx.x; j < ntiles; j += gridDim.x) {
    const int s0 = j * S;
    const int s_end = s0 + min(S, ln.live - s0);
    lb_partition<T, V>(sh, ln, cols, j, s0, s_end);
    int d[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x + k * T, slot = s0 + i;
      d[k] = slot < s_end ? slot_dst(sh, cols, i, slot, m) : -1;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (d[k] >= 0 && __ldg(vis + d[k])) d[k] = -1;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int slot = s0 + threadIdx.x + k * T;
      // a candidate read a larger first: only it can end up holding it
      const bool c = d[k] >= 0 && slot < __ldcg(fst + d[k]);
      if (c) atomicMin(fst + d[k], slot);
      const unsigned w = __ballot_sync(kFull, c);
      if (lane == 0) cw[(s0 + k * T) / 32 + warp] = w;
    }
    __syncthreads();
  }
}

template <int T, typename Cols>
__global__ void __launch_bounds__(T, kMinThreads / T)
af_emit(const int* __restrict__ sizes, const int* __restrict__ offsets,
        const int* __restrict__ base,
        const int* __restrict__ ebase, const int* __restrict__ tile_lane,
        const Cols cols, int n, int cap_in, int cap_out, int m,
        int slot_tiles, const u64* __restrict__ live_end,
        unsigned scan_epoch, int cap_front, u64* counters, u64* status,
        unsigned epoch, int* __restrict__ first,
        const unsigned* __restrict__ cand, int* __restrict__ ids,
        int* __restrict__ srcs, int* __restrict__ lengths,
        int* __restrict__ totals) {
  constexpr int V = Tile<T>::V, S = Tile<T>::kSlots, W = T / 32;
  __shared__ TileLanes<S, true, Cols::kRows, false> sh;
  __shared__ int counts[V * W];
  __shared__ int s_ticket, s_prefix, s_total;
  const Lane ln = lane_of(sizes, offsets, base, ebase, tile_lane,
                          live_end, scan_epoch, cap_in, cap_out,
                          slot_tiles);
  const size_t b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* fst = first + b * n;
  int* ids_b = ids + b * cap_front;
  int* srcs_b = srcs + b * cap_front;
  u64* st = status + b * slot_tiles;
  const unsigned* cw =
      cand + b * (static_cast<size_t>(slot_tiles) * (S / 32));
  const int ntiles = tiles_of<S>(ln.live);
  u64 tag = 0;
  if (threadIdx.x == 0) tag = enter_epoch(counters + b, epoch);
  for (;;) {
    if (threadIdx.x == 0) s_ticket = next_ticket(counters + b, tag);
    __syncthreads();
    const int j = s_ticket;
    if (j >= ntiles) break;
    const int s0 = j * S;
    const int s_end = s0 + min(S, ln.live - s0);
    // only a candidate of the expand pass (it read a larger first) can
    // hold first[b, dst]; a tile without one needs no partition
    unsigned word[V];
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      word[k] = cw[(s0 + k * T) / 32 + warp];
      any |= ((word[k] >> lane) & 1u) != 0;
    }
    if (__syncthreads_or(any)) lb_partition<T, V>(sh, ln, cols, j, s0, s_end);
    int d[V];
    unsigned bal[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x + k * T, slot = s0 + i;
      d[k] = ((word[k] >> lane) & 1u) ? slot_dst(sh, cols, i, slot, m) : -1;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int slot = s0 + threadIdx.x + k * T;
      bal[k] = __ballot_sync(kFull, d[k] >= 0 && fst[d[k]] == slot);
      if (lane == 0) counts[k * W + warp] = __popc(bal[k]);
    }
    __syncthreads();
    if (warp == 0) {                 // exclusive scan of the V·W counts
      int carry = 0;
      for (int c0 = 0; c0 < V * W; c0 += 32) {
        const int c = c0 + lane < V * W ? counts[c0 + lane] : 0;
        int x = c;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int y = __shfl_up_sync(kFull, x, dd);
          if (lane >= dd) x += y;
        }
        if (c0 + lane < V * W) counts[c0 + lane] = carry + x - c;
        carry += __shfl_sync(kFull, x, 31);
      }
      const int prefix = tile_prefix(st, j, epoch, carry);
      if (lane == 0) {
        s_prefix = prefix;
        if (j == ntiles - 1) {
          totals[b] = prefix + carry;
          lengths[b] = min(prefix + carry, cap_front);
        }
      }
    }
    __syncthreads();
    const int prefix = s_prefix;
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if ((bal[k] >> lane) & 1u) {
        const int pos = prefix + counts[k * W + warp] + __popc(bal[k] & lt);
        if (pos < cap_front) {
          ids_b[pos] = d[k];
          srcs_b[pos] = sh.src[sh.mark[pad32(threadIdx.x + k * T)]];
        }
        fst[d[k]] = INT_MAX;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s_total = ntiles > 0 ? wait_prefix(st + ntiles - 1, epoch) : 0;
    if (ntiles == 0 && blockIdx.x == 0) {
      totals[b] = 0;
      lengths[b] = 0;
    }
  }
  __syncthreads();
  const int len = min(s_total, cap_front);
  fill_tail(ids_b, len, cap_front);
  fill_tail(srcs_b, len, cap_front);
}

template <int T, typename Cols>
int af_launch(const Cols& cols, const int* sizes, const int* base,
              const int* row_offsets, const unsigned char* visited,
              int batch, int n, int cap_in, int cap_out, int m,
              int cap_front, int* first, int* offsets, int* ebase,
              int* tile_lane, long long tile_lane_cap, unsigned* cand,
              long long cand_cap, u64* counters,
              u64* live_end, u64* status, long long status_cap,
              unsigned epoch, int* ids, int* srcs, int* lengths,
              int* totals, cudaStream_t st) {
  constexpr int S = Tile<T>::kSlots;
  const long long scan_tiles = cap_in > 0 ? (cap_in - 1LL) / kScanTile + 1
                                          : 1;
  const long long slot_tiles = cap_out > 0 ? (cap_out - 1LL) / S + 1 : 1;
  const long long fill_tiles = (cap_front - 1LL) / kFillChunk + 1;
  if (batch * std::max(scan_tiles, slot_tiles) > status_cap ||
      batch * (slot_tiles + 1) > tile_lane_cap ||
      batch * slot_tiles * (S / 32) > cand_cap ||
      epoch + 1 >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = static_cast<int>(slot_tiles);
  lb_offsets<<<dim3(static_cast<unsigned>(scan_tiles), batch),
               kScanThreads, 0, st>>>(sizes, base, row_offsets, cap_in, S,
                                      nt, offsets, ebase, tile_lane,
                                      counters, live_end, status, epoch,
                                      nullptr);
  const int x1 = static_cast<int>(std::min<long long>(
      slot_tiles, resident_blocks(af_expand<T, Cols>, T)));
  af_expand<T, Cols><<<dim3(x1, batch), T, 0, st>>>(
      sizes, offsets, base, ebase, tile_lane, cols, visited, n, cap_in, cap_out,
      m, nt, live_end, epoch, first, cand);
  const int x2 = static_cast<int>(std::min<long long>(
      std::max(slot_tiles, fill_tiles),
      resident_blocks(af_emit<T, Cols>, T)));
  af_emit<T, Cols><<<dim3(x2, batch), T, 0, st>>>(
      sizes, offsets, base, ebase, tile_lane, cols, n, cap_in, cap_out, m, nt,
      live_end, epoch, cap_front, counters, status, epoch + 1, first, cand,
      ids, srcs, lengths, totals);
  return static_cast<int>(cudaGetLastError());
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

EXPORT int advance_batch(const int* sizes, const int* base,
                         const int* row_offsets, const void* cols,
                         const int* anchor, int kind, int batch, int cap_in,
                         int cap_out, int m, int* offsets, int* ebase,
                         int* tile_lane, long long tile_lane_cap,
                         u64* counters, u64* live_end, u64* status,
                         long long status_cap, unsigned epoch, int* src,
                         int* dst, int* eid, int* in_pos, int* rank,
                         unsigned char* valid, int* totals, int threads,
                         void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ADV(C)                                                       \
  return lb_tiles_launch<T, true>(                                         \
      C, sizes, base, row_offsets, batch, cap_in, cap_out, m, offsets,     \
      ebase, tile_lane, tile_lane_cap, counters, live_end, status,         \
      status_cap, epoch, src, dst, eid, in_pos, rank, valid, totals, st)
#define REPRO_ADV_T(TT)                                                    \
  {                                                                        \
    constexpr int T = TT;                                                  \
    REPRO_FOR_COLS(kind, cols, anchor, REPRO_ADV)                          \
  }
  REPRO_FOR_THREADS(threads, REPRO_ADV_T)
#undef REPRO_ADV_T
#undef REPRO_ADV
  return static_cast<int>(cudaErrorInvalidValue);
}

EXPORT int advance_filter_batch(const int* sizes, const int* base,
                                const int* row_offsets, const void* cols,
                                const int* anchor, int kind,
                                const unsigned char* visited, int batch,
                                int n, int cap_in, int cap_out, int m,
                                int cap_front, int* first, int* offsets,
                                int* ebase, int* tile_lane,
                                long long tile_lane_cap, unsigned* cand,
                                long long cand_cap, u64* counters,
                                u64* live_end, u64* status,
                                long long status_cap, unsigned epoch,
                                int* ids, int* srcs, int* lengths,
                                int* totals, int threads, void* stream) {
  if (!valid_threads(threads) || cap_front < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_AF(C)                                                        \
  return af_launch<T>(C, sizes, base, row_offsets, visited, batch, n,      \
                      cap_in, cap_out, m, cap_front, first, offsets,       \
                      ebase, tile_lane, tile_lane_cap, cand, cand_cap,     \
                      counters, live_end,                                  \
                      status, status_cap, epoch, ids, srcs, lengths,       \
                      totals, st)
#define REPRO_AF_T(TT)                                                     \
  {                                                                        \
    constexpr int T = TT;                                                  \
    REPRO_FOR_COLS(kind, cols, anchor, REPRO_AF)                           \
  }
  REPRO_FOR_THREADS(threads, REPRO_AF_T)
#undef REPRO_AF_T
#undef REPRO_AF
  return static_cast<int>(cudaErrorInvalidValue);
}
