// Load-balanced expansion over live-slot tiles: the scan and the tile
// partition K1 (advance_filter_batch), K3 (advance_batch) and K6
// (lb_expand) share, and the expand pass of K3 and K6.
//
// A lane's input lanes i have sizes[i] slots each; slot s of the lane
// belongs to the last input lane whose exclusive start is <= s (the
// reference's upper-bound search, src/repro/kernels/advance_fused.py:
// 67-82 and lb_expand.py:34-45). No slot searches: the scan finds each
// slot tile's first input lane once, and a tile marks the starts of the
// lanes it spans in shared memory and gives each slot its lane by a
// running maximum.
//   1. lb_offsets: the (B, cap_in) exclusive degree scans in one
//      single-pass int32 scan (decoupled look-back, common.cuh) that
//      saturates at INT_MAX, written only at non-empty lanes and at
//      saturated ones (the passes read no other), with each
//      lane's total at offsets[b][cap_in] (and in `totals` when given);
//      each non-empty lane's edge base, each slot tile's first lane and
//      each lane's live end;
//   2. the passes walk the live slots, min(total, cap_out) of a lane, in
//      tiles of T·V slots (kTileSlots at most) on a persistent grid;
//      lb_partition stages each tile's lanes. K1's passes are in
//      advance.cu; lb_expand_tiles (K3 with the CSR gathers, K6 without)
//      writes each live slot's outputs with no search, then fills the
//      lane's dead tail with its constants in 16-byte stores.
#pragma once

#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;
constexpr int kScanTile = kScanThreads * kScanItems;   // sizes a scan tile
constexpr int kTileSlots = 2048;         // slots a tile, at most
constexpr int kFillChunk = 8192;         // tail entries a block, at least
constexpr int kMinThreads = 1536;        // resident threads an SM, at least
// The outputs of K3 and K6 are written once and not read again by the
// kernel: stores that evict first keep the offsets, row offsets and
// columns the passes read in L2.
constexpr bool kStreamOut = true;

// Slots a thread takes in a tile of T threads: 8, fewer where the tile
// would pass kTileSlots.
template <int T>
struct Tile {
  static constexpr int V = (8 * T <= kTileSlots) ? 8 : kTileSlots / T;
  static constexpr int kSlots = T * V;
};

__device__ __forceinline__ int lane_end(u64 w, unsigned epoch) {
  return static_cast<unsigned>(w >> 32) == epoch
             ? static_cast<int>(static_cast<unsigned>(w)) : 0;
}

// One tile of kScanTile sizes a block, tiles in ticket order with
// decoupled look-back:
//   offsets[b][i] = the exclusive scan of sizes[b] at every non-empty
//     input lane i and every lane where the scan has saturated (other
//     entries are not written), offsets[b][cap_in] = the lane's total,
//     and totals[b] the same when `totals` is given. The sums saturate at
//     INT_MAX: a frontier of duplicates can hold more slots than int32
//     counts (the reference's scan wraps there), and every slot below
//     cap_out <= INT_MAX still gets its true lane;
//   ebase[b][i] = row_offsets[base[b][i]] - offsets[b][i] for every
//     non-empty input lane i (slot s of lane i reads edge ebase + s), when
//     `ebase` is given;
//   tile_lane[b][k] = the input lane that holds slot k * slot_tile, for
//     k <= slot_tiles and k * slot_tile < total (a binary search of the
//     scan tile's inclusive sums in shared memory);
//   live_end[b] lifted to (epoch << 32 | one past the last non-empty
//     lane).
__global__ void __launch_bounds__(kScanThreads)
lb_offsets(const int* __restrict__ sizes, const int* __restrict__ base,
           const int* __restrict__ row_offsets, int cap_in, int slot_tile,
           int slot_tiles, int* __restrict__ offsets,
           int* __restrict__ ebase, int* __restrict__ tile_lane,
           u64* counters, u64* live_end, u64* status, unsigned epoch,
           int* __restrict__ totals) {
  __shared__ int buf[kScanTile + kScanTile / 32];
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int s_ticket, s_last, s_prefix;
  const size_t b = blockIdx.y;
  const int t = threadIdx.x;
  if (t == 0) {
    s_ticket = next_ticket(counters + b, enter_epoch(counters + b, epoch));
    s_last = -1;
  }
  __syncthreads();
  const int j = s_ticket;
  const long long first = static_cast<long long>(j) * kScanTile;
  const int* row = sizes + b * cap_in;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const long long i = first + t + k * kScanThreads;
    buf[pad32(t + k * kScanThreads)] = i < cap_in ? row[i] : 0;
  }
  __syncthreads();
  int run[kScanItems];
  int sum = 0, last = -1;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int v = buf[pad32(t * kScanItems + k)];
    sum = sat_add(sum, v);
    run[k] = sum;
    if (v != 0) last = t * kScanItems + k;
  }
  if (last >= 0) atomicMax(&s_last, last);
  int tile_sum;
  const int before =
      block_excl_sum<kScanThreads>(sum, warp_sums, &tile_sum);
  if (t < 32) {
    const int prefix =
        tile_prefix(status + b * gridDim.x, j, epoch, tile_sum);
    if (t == 0) {
      s_prefix = prefix;
      if (s_last >= 0) {
        atomicMax(live_end + b, (static_cast<u64>(epoch) << 32) |
                                    static_cast<u64>(first + s_last + 1));
      }
    }
  }
  __syncthreads();
  const int start = s_prefix;
  const int off = sat_add(start, before);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    buf[pad32(t * kScanItems + k)] = sat_add(off, run[k]);
  }
  __syncthreads();
  int* offs = offsets + b * (static_cast<size_t>(cap_in) + 1);
  const int* bs = base + b * cap_in;
#pragma unroll 4
  for (int k = 0; k < kScanItems; ++k) {
    const int i = t + k * kScanThreads;
    if (first + i < cap_in) {
      const int inc = buf[pad32(i)];
      const int exc = i > 0 ? buf[pad32(i - 1)] : start;
      if (inc != exc || exc == INT_MAX) {
        offs[first + i] = exc;
        if (ebase != nullptr) {
          // past the saturation point an empty lane is written too, and
          // its frontier id may be -1 (padding): it expands no slot, so
          // its edge base is never read, and row_offsets[-1] must not be
          const int s = bs[first + i];
          ebase[b * cap_in + first + i] = (s >= 0 ? row_offsets[s] : 0) - exc;
        }
      }
    }
  }
  if (j == static_cast<int>(gridDim.x) - 1 && t == 0) {
    offs[cap_in] = sat_add(start, tile_sum);
    if (totals != nullptr) totals[b] = sat_add(start, tile_sum);
  }
  if (tile_sum != 0) {
    // the slot tiles that start inside this scan tile
    const long long lo = (static_cast<long long>(start) + slot_tile - 1) /
                         slot_tile;
    const long long hi =
        min((static_cast<long long>(start) + tile_sum - 1) / slot_tile,
            static_cast<long long>(slot_tiles));
    int* tl = tile_lane + b * (static_cast<size_t>(slot_tiles) + 1);
    for (long long k = lo + t; k <= hi; k += kScanThreads) {
      const long long s = k * slot_tile;
      int a = 0, z = kScanTile - 1;           // the first inclusive sum > s
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (buf[pad32(mid)] > s) z = mid; else a = mid + 1;
      }
      tl[k] = static_cast<int>(first + a);
    }
  }
}

// The shared memory of one tile of S slots. At a lane's start position p
// in the tile: src / ebase / row (kSrc: the CSR gathers of K1 and K3;
// kRows: the delta anchor) and its lane index (kLanes: K3's and K6's
// in_pos); r0 = s0 less the start of the tile's first lane (a lane that
// starts inside the tile at p has rank i - p at tile slot i).
template <int S, bool kSrc_, bool kRows_, bool kLanes_>
struct TileLanes {
  static constexpr bool kSrc = kSrc_, kRows = kRows_, kLanes = kLanes_;
  int mark[S + S / 32];    // lane start at its slot, then its running max
  int src[kSrc ? S : 1];
  int ebase[kSrc ? S : 1];
  int row[kRows ? S : 1];
  int lane[kLanes ? S : 1];
  int warp_buf[32];
  int r0;
};

// What a pass knows of its lane: the scan's outputs for it.
struct Lane {
  const int* sizes;        // sizes[b]
  const int* offs;         // offsets[b]
  const int* base;         // base[b]
  const int* ebase;        // ebase[b]
  const int* tile_lane;    // tile_lane[b]
  int total, live, le;
};

template <typename Sh, typename Cols>
__device__ __forceinline__ void stage_lane(Sh& sh, const Lane& ln,
                                           const Cols& cols, int p, int l) {
  if constexpr (Sh::kSrc) {
    const int s = ln.base[l];
    sh.src[p] = s;
    sh.ebase[p] = ln.ebase[l];
    if constexpr (Sh::kRows) sh.row[p] = cols.row(s);
  }
  if constexpr (Sh::kLanes) sh.lane[p] = l;
}

// Partitions tile j, slots [s0, s_end) of a lane: afterwards
// sh.mark[pad32(i)] is the tile position where the input lane of slot
// s0 + i starts (0 for the lane that holds s0), and the staged fields at
// that position describe the lane. The input lanes come from the scan's
// tile_lane (the lane of s0; the lane of the next tile's first slot, or
// the live end, bounds the walk). The caller synchronises before reusing
// sh.
template <int T, int V, typename Cols, typename Sh>
__device__ __forceinline__ void lb_partition(Sh& sh, const Lane& ln,
                                             const Cols& cols, int j,
                                             int s0, int s_end) {
  constexpr int S = T * V;
  const int p0 = ln.tile_lane[j];
  const int p1 = static_cast<long long>(j + 1) * S < ln.total
                     ? ln.tile_lane[j + 1] : ln.le - 1;
#pragma unroll
  for (int k = 0; k < V; ++k) sh.mark[pad32(threadIdx.x + k * T)] = -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.mark[0] = 0;
    stage_lane(sh, ln, cols, 0, p0);
    if constexpr (Sh::kLanes) sh.r0 = s0 - ln.offs[p0];
  }
  // the non-empty lanes after p0 that start inside the tile (offs > s0)
  for (int l = p0 + 1 + threadIdx.x; l <= p1; l += T) {
    if (ln.sizes[l] != 0) {
      const int o = ln.offs[l];
      if (o < s_end) {
        const int p = o - s0;
        sh.mark[pad32(p)] = p;
        stage_lane(sh, ln, cols, p, l);
      }
    }
  }
  __syncthreads();
  int run[V];
  int mx = -1;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mx = max(mx, sh.mark[pad32(threadIdx.x * V + k)]);
    run[k] = mx;
  }
  const int before = block_excl_max<T>(mx, sh.warp_buf);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh.mark[pad32(threadIdx.x * V + k)] = max(before, run[k]);
  }
  __syncthreads();
}

__device__ __forceinline__ Lane lane_of(
    const int* sizes, const int* offsets, const int* base, const int* ebase,
    const int* tile_lane, const u64* live_end, unsigned scan_epoch,
    int cap_in, int cap_out, int slot_tiles) {
  const size_t b = blockIdx.y;
  Lane ln;
  ln.sizes = sizes + b * cap_in;
  ln.offs = offsets + b * (static_cast<size_t>(cap_in) + 1);
  ln.base = base + b * cap_in;
  ln.ebase = ebase + b * cap_in;
  ln.tile_lane = tile_lane + b * (static_cast<size_t>(slot_tiles) + 1);
  ln.total = ln.offs[cap_in];
  ln.live = max(min(ln.total, cap_out), 0);
  ln.le = lane_end(live_end[b], scan_epoch);
  return ln;
}

// Tiles of a lane with `live` slots: ceil(live / S).
template <int S>
__device__ __forceinline__ int tiles_of(int live) {
  return live > 0 ? (live - 1) / S + 1 : 0;
}

// This block's part of [lo, hi) when the lane's gridDim.x blocks split it
// in contiguous parts.
__device__ __forceinline__ void block_part(long long lo, long long hi,
                                           long long* a, long long* z) {
  const long long part = hi > lo ? (hi - lo + gridDim.x - 1) / gridDim.x : 0;
  *a = min(hi, lo + part * blockIdx.x);
  *z = min(hi, *a + part);
}

// A reader of no columns: K6's expansion gathers nothing.
struct NoCols {
  static constexpr bool kRows = false;
};

// The expand pass of K3 (kGather: the CSR gathers) and K6 (without):
// each live slot of tile j writes, with no search,
//   in_pos = its lane, rank = slot - the lane's start, and (kGather)
//   src = base[lane], eid = ebase[lane] + slot, dst = the column at the
//   clamped edge;
// threads take the tile's slots in stride T, so each output row is stored
// coalesced. Then the lane's blocks fill, each its contiguous part,
// valid[0, live) = 1, valid[live, cap_out) = 0 and the dead tail:
// in_pos = max(cap_in - 1, 0) and (kGather) src = dst = eid = -1, rank = 0
// or (K6) rank = slot - offsets[cap_in - 1] (slot when cap_in = 0), which
// is what the reference's search gives a slot past the total.
template <int T, typename Cols, bool kGather>
__global__ void __launch_bounds__(T, kMinThreads / T)
lb_expand_tiles(const int* __restrict__ sizes,
                const int* __restrict__ offsets, const int* __restrict__ base,
                const int* __restrict__ ebase,
                const int* __restrict__ tile_lane, const Cols cols,
                int cap_in, int cap_out, int m, int slot_tiles,
                const u64* __restrict__ live_end, unsigned scan_epoch,
                int* __restrict__ src, int* __restrict__ dst,
                int* __restrict__ eid, int* __restrict__ in_pos,
                int* __restrict__ rank, unsigned char* __restrict__ valid) {
  constexpr int V = Tile<T>::V, S = Tile<T>::kSlots;
  __shared__ TileLanes<S, kGather, kGather && Cols::kRows, true> sh;
  const Lane ln = lane_of(sizes, offsets, base, ebase, tile_lane, live_end,
                          scan_epoch, cap_in, cap_out, slot_tiles);
  const size_t row = blockIdx.y * static_cast<size_t>(cap_out);
  int* ip = in_pos + row;
  int* rk = rank + row;
  const int ntiles = tiles_of<S>(ln.live);
  for (int j = blockIdx.x; j < ntiles; j += gridDim.x) {
    const int s0 = j * S;
    const int n = min(S, ln.live - s0);
    lb_partition<T, V>(sh, ln, cols, j, s0, s0 + n);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = threadIdx.x + k * T;
      if (i < n) {
        const int slot = s0 + i;
        const int q = sh.mark[pad32(i)];
        store<kStreamOut>(ip + slot, sh.lane[q]);
        store<kStreamOut>(rk + slot, i - q + (q == 0 ? sh.r0 : 0));
        if constexpr (kGather) {
          const int s = sh.src[q], e = sh.ebase[q] + slot;
          int r = 0;
          if constexpr (Cols::kRows) r = sh.row[q];
          store<kStreamOut>(src + row + slot, s);
          store<kStreamOut>(eid + row + slot, e);
          store<kStreamOut>(dst + row + slot,
                            cols.at(min(max(e, 0), m - 1), r));
        }
      }
    }
    __syncthreads();
  }
  long long a, z;
  block_part(0, cap_out, &a, &z);
  const long long live = ln.live;
  fill_bytes<kStreamOut>(valid + row, a, min(z, live), 1, threadIdx.x, T);
  fill_bytes<kStreamOut>(valid + row, max(a, live), z, 0, threadIdx.x, T);
  block_part(live, cap_out, &a, &z);
  fill_run<kStreamOut>(ip, a, z, max(cap_in - 1, 0), 0, threadIdx.x, T);
  if constexpr (kGather) {
    fill_run<kStreamOut>(src + row, a, z, -1, 0, threadIdx.x, T);
    fill_run<kStreamOut>(dst + row, a, z, -1, 0, threadIdx.x, T);
    fill_run<kStreamOut>(eid + row, a, z, -1, 0, threadIdx.x, T);
    fill_run<kStreamOut>(rk, a, z, 0, 0, threadIdx.x, T);
  } else {
    // the last lane's exclusive start (written when it is non-empty)
    const int last = cap_in > 0 ? (ln.sizes[cap_in - 1] != 0
                                       ? ln.offs[cap_in - 1] : ln.total)
                                : 0;
    fill_run<kStreamOut>(rk, a, z, -last, 1, threadIdx.x, T);
  }
}

// K3 / K6: the scan, then the expand pass (two launches). Scratch from
// the wrapper: offsets (B, cap_in + 1), ebase (B, cap_in; kGather only),
// tile_lane (B, slot_tiles + 1); the look-back words; one fresh epoch.
template <int T, bool kGather, typename Cols>
int lb_tiles_launch(const Cols& cols, const int* sizes, const int* base,
                    const int* row_offsets, int batch, int cap_in,
                    int cap_out, int m, int* offsets, int* ebase,
                    int* tile_lane, long long tile_lane_cap, u64* counters,
                    u64* live_end, u64* status, long long status_cap,
                    unsigned epoch, int* src, int* dst, int* eid,
                    int* in_pos, int* rank, unsigned char* valid,
                    int* totals, cudaStream_t st) {
  constexpr int S = Tile<T>::kSlots;
  const long long scan_tiles = cap_in > 0 ? (cap_in - 1LL) / kScanTile + 1
                                          : 1;
  const long long slot_tiles = cap_out > 0 ? (cap_out - 1LL) / S + 1 : 1;
  const long long fill_tiles =
      cap_out > 0 ? (cap_out - 1LL) / kFillChunk + 1 : 1;
  if (batch < 1 || batch * scan_tiles > status_cap ||
      batch * (slot_tiles + 1) > tile_lane_cap || epoch >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = static_cast<int>(slot_tiles);
  lb_offsets<<<dim3(static_cast<unsigned>(scan_tiles), batch),
               kScanThreads, 0, st>>>(sizes, base, row_offsets, cap_in, S,
                                      nt, offsets, ebase, tile_lane,
                                      counters, live_end, status, epoch,
                                      totals);
  const int x = static_cast<int>(std::min<long long>(
      std::max(slot_tiles, fill_tiles),
      resident_blocks(lb_expand_tiles<T, Cols, kGather>, T)));
  lb_expand_tiles<T, Cols, kGather><<<dim3(x, batch), T, 0, st>>>(
      sizes, offsets, base, ebase, tile_lane, cols, cap_in, cap_out, m, nt,
      live_end, epoch, src, dst, eid, in_pos, rank, valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
