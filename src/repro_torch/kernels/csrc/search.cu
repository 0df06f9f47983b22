// Bounded segmented binary search (K5) for Hopper, in both of its modes.
//
// Replaces the TPU kernel segment_search_kernel
// (src/repro/kernels/segment_search.py:52): for each lane i, the lower
// bound l of needles[i] in haystack[lo[i]:hi[i]), found by the
// reference's steps (mid = lo + (hi - lo) / 2, read at mid clamped to
// [0, m - 1]); `found` mode writes 1 where l < hi[i] and the haystack
// holds the needle at clamp(l) (else 0), `locate` mode l there (else -1).
// It is the SmallLarge probe of segmented intersection and of subgraph
// matching's join (found) and of the masked SpGEMM behind triangle
// counting (locate).
//
// What bounds it on this card. The TPU kernel keeps the whole haystack in
// VMEM. Here the haystack stays in device memory, and each lane pays
// floor(log2 L) + 1 dependent loads (L = hi - lo) on top of its 16 bytes
// of lane traffic (needle, lo, hi read, one int32 or byte written, the
// byte bound). In every caller consecutive lanes come in runs that share
// one segment: the top levels of their searches read the same entries,
// which a warp reads as one broadcast load and L1 keeps; at rmat scale
// 18 the haystack sits in L2, at scale 22 the lower levels of a long
// segment come from HBM. So the search is latency-bound: time goes to
// dependent loads, and the card needs as many independent searches in
// flight as it can hold.
//
// The design, each step measured against the one before it on the card
// (tools/search_steps.py; PERF.md):
//  * a thread carries kSearchLanes lanes at once and runs their searches
//    interleaved, one load a live lane a round, so that many independent
//    loads are in flight; at most 40 registers a thread keep 1,536
//    threads an SM resident (int64 haystacks: 64 and 1,024);
//  * chunk c of 32·V lanes goes to warp c mod (the grid's warps), its row
//    j lanes base + 32 j + lane: each warp instruction reads, searches and
//    writes 32 consecutive lanes, which share a run's segment;
//  * a warp whose live lanes all search inside [0, m) skips the clamp;
//  * found / locate comes from the value read where the search last moved
//    hi: a lane that ends with l < hi moved hi to mid = l, so it read
//    hay[clamp(l)] already, and no final load is needed.
// Reading each run's segment (or its top tree levels) into shared memory
// once, in one block a tile (tools/search_variants/tiles.cu) or in each
// warp's own region (warp_stage.cu), measured slower at every shape: the
// L1 already keeps a run's segment, and the staging's scans, barriers
// and registers cost more than the shared-memory reads save.
//
// Every live lane takes the reference's steps on the reference's values,
// so l is the reference's for any input: runs broken by other lanes,
// overlapping or unsorted segments, needles in any order. A lane with
// lo >= hi, and every lane of an empty haystack, reads nothing. Outputs do
// not depend on the block size (64 ... 1024).
//
// The haystack is the graph's dense column array at its storage plan's
// index dtype (int16, int32 or int64; `kind` 1, 0, 2, as the advance
// kernels number them), compared with the int32 needles after widening.
// Lane indices are 64-bit (cap < 2^31 by the callers' plans).
#include "common.cuh"

namespace {

constexpr int kSearchLanes = 4;       // lanes a thread carries at once
constexpr int kSearchSmThreads = 1536;  // threads an SM holds (40 registers)

template <typename H> struct Wide { using type = int; };
template <> struct Wide<long long> { using type = long long; };

// Blocks an SM should hold: kSearchSmThreads threads (1,024 at 64
// registers where the haystack's entries are 64-bit).
template <int T, typename H>
constexpr int kSearchMinBlocks = (sizeof(H) == 8 ? 1024 : kSearchSmThreads) / T;

__device__ __forceinline__ int mid_of(int l, int h) {
  return l + static_cast<int>(static_cast<unsigned>(h - l) >> 1);
}

// The reference's steps for a thread's V lanes, interleaved: each
// round reads one entry for every live lane, then moves its bounds.
// kClamp reads at mid clamped to [0, m - 1]; without it every live
// lane's [l, h) lies inside [0, m), so mid needs no clamp. hv[j] is the
// value read where lane j last moved h.
template <bool kClamp, int V, typename H, typename W>
__device__ __forceinline__ void search_lanes(const H* __restrict__ hay,
                                             int m, int (&l)[V],
                                             int (&h)[V], const int (&x)[V],
                                             W (&hv)[V]) {
  for (;;) {
    W val[V];
    int mid[V];
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mid[j] = mid_of(l[j], h[j]);
      val[j] = 0;
      if (l[j] < h[j]) {
        const int p = kClamp ? min(max(mid[j], 0), m - 1) : mid[j];
        val[j] = static_cast<W>(__ldg(hay + p));
        any = true;
      }
    }
    if (!any) return;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (l[j] < h[j]) {
        if (val[j] < static_cast<W>(x[j])) {
          l[j] = mid[j] + 1;
        } else {
          h[j] = mid[j], hv[j] = val[j];
        }
      }
    }
  }
}

// Chunk c of 32·V lanes goes to warp c mod (the grid's warps); its row j
// is lanes base + 32 j + lane, so a warp instruction touches 32
// consecutive lanes, and a thread's V searches run interleaved.
template <int T, bool kLocate, typename H, typename Out>
__global__ void __launch_bounds__(T, kSearchMinBlocks<T, H>)
search_rows(const H* __restrict__ hay, int m, const int* __restrict__ lo,
            const int* __restrict__ hi, const int* __restrict__ needles,
            long long cap, Out* __restrict__ out) {
  using W = typename Wide<H>::type;
  constexpr int V = kSearchLanes;
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * T * V;
  for (long long base = (static_cast<long long>(blockIdx.x) * T +
                         (threadIdx.x & ~31)) * V;
       base < cap; base += step) {
    int l[V], h[V], h0[V], x[V];
    W hv[V];
    bool inside = true;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + 32 * j + lane;
      const bool in = i < cap;
      l[j] = in ? __ldg(lo + i) : 0;
      h0[j] = in ? __ldg(hi + i) : 0;
      x[j] = in ? __ldg(needles + i) : 0;
      h[j] = (m > 0 && l[j] < h0[j]) ? h0[j] : l[j];   // else no reads
      hv[j] = 0;
      inside = inside && (l[j] >= h[j] || (l[j] >= 0 && h[j] <= m));
    }
    if (__all_sync(kFull, inside)) {
      search_lanes<false>(hay, m, l, h, x, hv);
    } else {
      search_lanes<true>(hay, m, l, h, x, hv);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + 32 * j + lane;
      if (i < cap) {
        // l < hi: the search moved h to mid = l, where it read hv
        const bool found =
            m > 0 && l[j] < h0[j] && hv[j] == static_cast<W>(x[j]);
        out[i] = static_cast<Out>(kLocate ? (found ? l[j] : -1)
                                          : (found ? 1 : 0));
      }
    }
  }
}

template <int T, bool kLocate, typename H, typename Out>
int launch_rows(const H* hay, int m, const int* lo, const int* hi,
                const int* needles, long long cap, Out* out,
                cudaStream_t st) {
  const long long chunks = (cap + T * kSearchLanes - 1) / (T * kSearchLanes);
  const int blocks = static_cast<int>(min(chunks, 1LL << 20));
  search_rows<T, kLocate, H, Out><<<blocks, T, 0, st>>>(hay, m, lo, hi,
                                                        needles, cap, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLocate, typename H, typename Out>
int launch_kind(const void* hay, int m, const int* lo, const int* hi,
                const int* needles, long long cap, Out* out, int threads,
                cudaStream_t st) {
  const H* h = static_cast<const H*>(hay);
#define REPRO_SEARCH(TT) \
  return launch_rows<TT, kLocate>(h, m, lo, hi, needles, cap, out, st)
  REPRO_FOR_THREADS(threads, REPRO_SEARCH)
#undef REPRO_SEARCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kLocate, typename Out>
int launch(const void* hay, int kind, int m, const int* lo, const int* hi,
           const int* needles, long long cap, Out* out, int threads,
           void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_kind<kLocate, int>(hay, m, lo, hi, needles, cap, out,
                                       threads, st);
    case 1:
      return launch_kind<kLocate, short>(hay, m, lo, hi, needles, cap, out,
                                         threads, st);
    case 2:
      return launch_kind<kLocate, long long>(hay, m, lo, hi, needles, cap,
                                             out, threads, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

EXPORT int segment_search_found(const void* hay, int kind, int m,
                                const int* lo, const int* hi,
                                const int* needles, long long cap,
                                unsigned char* found, int threads,
                                void* stream) {
  return launch<false>(hay, kind, m, lo, hi, needles, cap, found, threads,
                       stream);
}

EXPORT int segment_search_locate(const void* hay, int kind, int m,
                                 const int* lo, const int* hi,
                                 const int* needles, long long cap, int* pos,
                                 int threads, void* stream) {
  return launch<true>(hay, kind, m, lo, hi, needles, cap, pos, threads,
                      stream);
}
