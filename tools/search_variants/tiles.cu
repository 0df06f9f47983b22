// A measured alternative of K5 (src/repro_torch/kernels/csrc/search.cu),
// built only by tools/search_steps.py: each run's segment, or the top
// levels of its search tree, staged in shared memory by one block a tile.
// It measured slower than the kernel at every shape (PERF.md §6).
// Same C interface as the kernel, plus the staging budget in bytes.
//
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
// VMEM. Here it stays in device memory, and one thread a lane (the port's
// first design) paid floor(log2 L) + 1 dependent loads a lane through L2
// (or HBM at rmat scale 22), L = hi - lo: K5 ran at half its byte bound
// (16 B a lane: needle, lo, hi read, one int32 or byte written). Yet in
// every caller consecutive lanes come in runs that share one segment
// [lo, hi): a mask edge's row in mxm, a pair's larger list in
// segmented_intersect, a partial embedding's anchor row in
// subgraph_match. The top levels of a run's searches read the same
// entries once a lane.
//
// The design: one block a tile of T·V lanes, V (at most kSearchLanes)
// consecutive lanes a thread.
//  1. The tile's lo, hi and needles are read with 16-byte loads. A lane
//     heads a run where (lo, hi) differs from the lane before it, or at
//     the tile's first lane; a block-wide scan numbers the runs and each
//     run's lane count c in the tile follows from its head's position.
//  2. Shared memory is shared out by one more scan: every run with a
//     segment reserves the top k = min(floor(log2(c + 1)), steps(L))
//     levels of its implicit search tree, 2^k - 1 <= c entries, so the
//     trees of a tile never pass its lane count. A run whose segment
//     holds at most kStageRatio entries a lane and whose search is
//     deeper than its tree also asks for the whole segment, staged after
//     every tree while the budget lasts.
//  3. The lanes of a run fill its entries, each at most one tree node or
//     kStageRatio segment entries, read at the clamped position and
//     widened (int16 to int32): every entry is read once a run and tile,
//     with independent loads, instead of c times with dependent ones.
//  4. Each lane replays the reference's steps: in the staged segment to
//     the end, or k steps down its run's tree, then the rest in device
//     memory, a thread's V searches interleaved so their loads are in
//     flight together. Lanes of no run with a segment (lo >= hi, an
//     empty haystack) read nothing.
//  5. found / locate comes from the value read where the search last went
//     left: a lane that ends with l < hi moved hi to mid = l there, so it
//     read hay[clamp(l)] already. Each thread stores its V outputs in one
//     or two vector stores.
// The search reads the reference's values at the reference's positions,
// so every lane's l is the reference's for any input: runs broken by
// other lanes, overlapping or unsorted segments, needles in any order.
// Nothing assumes that the callers' segments and needles are sorted.
// Outputs do not depend on the block size (64 ... 1024), which sets the
// tile (T·V lanes) and so c.
//
// The haystack is the graph's dense column array at its storage plan's
// index dtype (int16, int32 or int64; `kind` 1, 0, 2, as the advance
// kernels number them), compared with the int32 needles after widening.
// Lane indices are 64-bit (cap < 2^31 by the callers' plans).
#include "common.cuh"

namespace {

constexpr int kSearchTile = 2048;   // lanes a tile, at most
constexpr int kSearchLanes = 8;     // lanes a thread, at most
constexpr int kStageRatio = 8;      // segment entries a lane copies, at most
constexpr int kStaged = 1 << 30;    // allocation code: a staged segment

template <int T>
struct SearchShape {
  static constexpr int V =
      (kSearchLanes * T <= kSearchTile) ? kSearchLanes : kSearchTile / T;
  static constexpr int kTile = T * V;
  // bytes of the run table (kTile + 1 ints) before the staging buffer
  static constexpr int kRunBytes = ((kTile + 1) * 4 + 15) / 16 * 16;
};

// Blocks an SM should hold (512 threads): at most 128 registers a thread
// at 256 threads, for the V searches a thread interleaves.
template <int T>
constexpr int kSearchMinBlocks = 512 / T > 0 ? 512 / T : 1;

template <typename H> struct Wide { using type = int; };
template <> struct Wide<long long> { using type = long long; };

__device__ __forceinline__ int clamp_pos(int p, int m) {
  return min(max(p, 0), m - 1);
}

__device__ __forceinline__ int mid_of(int l, int h) {
  return l + static_cast<int>(static_cast<unsigned>(h - l) >> 1);
}

// Binary search steps a segment of L > 0 entries takes: floor(log2 L) + 1.
__device__ __forceinline__ int steps_of(unsigned len) {
  return 32 - __clz(static_cast<int>(len));
}

// Levels of a run's cached tree: 2^k - 1 <= c entries, no deeper than
// its search.
__device__ __forceinline__ int tree_levels(int c, unsigned len) {
  return min(31 - __clz(c + 1), steps_of(len));
}

template <int V>
__device__ __forceinline__ void load_lanes(const int* __restrict__ p,
                                           int (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(p) + k);
      a[4 * k] = t.x, a[4 * k + 1] = t.y, a[4 * k + 2] = t.z,
      a[4 * k + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const int2 t = __ldg(reinterpret_cast<const int2*>(p));
    a[0] = t.x, a[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = __ldg(p + j);
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(int* __restrict__ p,
                                            const int (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      reinterpret_cast<int4*>(p)[k] =
          make_int4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
    }
  } else if constexpr (V == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(a[0], a[1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = a[j];
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(unsigned char* __restrict__ p,
                                            const int (&a)[V]) {
  unsigned w[(V + 3) / 4] = {};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    w[j / 4] |= static_cast<unsigned>(a[j]) << (8 * (j % 4));
  }
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<unsigned*>(p) = w[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(w[0]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = static_cast<unsigned char>(a[j]);
  }
}

// One tile of T·V lanes a block (see the header). `stage_cap` is the
// staging buffer's size in entries of the widened type W; `vec` says
// that lo, hi, needles and out are 16-byte aligned.
template <int T, bool kLocate, typename H, typename Out>
__global__ void __launch_bounds__(T, kSearchMinBlocks<T>)
search_tiles(const H* __restrict__ hay, int m, const int* __restrict__ lo,
             const int* __restrict__ hi, const int* __restrict__ needles,
             long long cap, Out* __restrict__ out, int stage_cap, bool vec) {
  using W = typename Wide<H>::type;
  using S = SearchShape<T>;
  constexpr int V = S::V;
  extern __shared__ __align__(16) unsigned char s_mem[];
  int* s_run = reinterpret_cast<int*>(s_mem);   // head lane, then its code
  W* stage = reinterpret_cast<W*>(s_mem + S::kRunBytes);
  __shared__ int warp_buf[T / 32];

  const long long t0 = static_cast<long long>(blockIdx.x) * S::kTile;
  const int n = static_cast<int>(
      min(static_cast<long long>(S::kTile), cap - t0));
  const int first = threadIdx.x * V;
  const bool full = vec && n == S::kTile;

  int lo0[V], hi0[V], x[V];
  if (full) {
    load_lanes<V>(lo + t0 + first, lo0);
    load_lanes<V>(hi + t0 + first, hi0);
    load_lanes<V>(needles + t0 + first, x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool in = first + j < n;
      lo0[j] = in ? __ldg(lo + t0 + first + j) : 0;
      hi0[j] = in ? __ldg(hi + t0 + first + j) : 0;
      x[j] = in ? __ldg(needles + t0 + first + j) : 0;
    }
  }

  // 1. run heads and their numbers
  int plo = __shfl_up_sync(kFull, lo0[V - 1], 1);
  int phi = __shfl_up_sync(kFull, hi0[V - 1], 1);
  if ((threadIdx.x & 31) == 0 && first > 0 && first < n) {
    plo = __ldg(lo + t0 + first - 1);
    phi = __ldg(hi + t0 + first - 1);
  }
  unsigned heads = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int pl = j ? lo0[j - 1] : plo, ph = j ? hi0[j - 1] : phi;
    if (first + j < n &&
        (first + j == 0 || lo0[j] != pl || hi0[j] != ph)) {
      heads |= 1u << j;
    }
  }
  int nruns;
  const int run0 = block_excl_sum<T>(__popc(heads), warp_buf, &nruns);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if ((heads >> j) & 1u) {
      s_run[run0 + __popc(heads & ((1u << j) - 1u))] = first + j;
    }
  }
  if (threadIdx.x == 0) s_run[nruns] = n;
  __syncthreads();

  // 2. each run's reservation: its tree, and its segment where asked
  int run[V], c[V], q[V];
  unsigned len[V];
  int want = 0;                    // staged entries << 15 | tree entries
#pragma unroll
  for (int j = 0; j < V; ++j) {
    run[j] = run0 + __popc(heads & ((2u << j) - 1u)) - 1;
    const bool in = first + j < n;
    const int r = in ? run[j] : 0;
    c[j] = in ? s_run[r + 1] - s_run[r] : 1;
    q[j] = in ? first + j - s_run[r] : 0;
    len[j] = (in && m > 0 && lo0[j] < hi0[j])
                 ? static_cast<unsigned>(hi0[j] - lo0[j]) : 0u;
    if (((heads >> j) & 1u) && len[j] > 0) {
      const int k = tree_levels(c[j], len[j]);
      const bool ask = k < steps_of(len[j]) &&
                       len[j] <= static_cast<unsigned>(kStageRatio) * c[j];
      want += (ask ? static_cast<int>(len[j]) << 15 : 0) + (1 << k) - 1;
    }
  }
  int wanted;
  const int before = block_excl_sum<T>(want, warp_buf, &wanted);
  const int trees = wanted & 0x7fff;
  int acc = before;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (((heads >> j) & 1u)) {
      int code = -1;
      if (len[j] > 0) {
        const int k = tree_levels(c[j], len[j]);
        const int tw = (1 << k) - 1;
        const bool ask = k < steps_of(len[j]) &&
                         len[j] <= static_cast<unsigned>(kStageRatio) * c[j];
        const int toff = acc & 0x7fff;
        const int soff = trees + (acc >> 15);
        if (ask && soff + static_cast<int>(len[j]) <= stage_cap) {
          code = soff | kStaged;
        } else if (toff + tw <= stage_cap) {
          code = toff;
        }
        acc += (ask ? static_cast<int>(len[j]) << 15 : 0) + tw;
      }
      s_run[run[j]] = code;
    }
  }
  __syncthreads();

  // 3. fill the reserved entries; set each lane's search state
  int l[V], h[V], kl[V], v[V];
  unsigned sb[V];
  W hv[V];
  bool left[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int code = len[j] > 0 ? s_run[run[j]] : -1;
    l[j] = lo0[j];
    h[j] = len[j] > 0 ? hi0[j] : lo0[j];     // no segment: nothing to read
    kl[j] = 0, v[j] = 0, sb[j] = 0, hv[j] = 0, left[j] = false;
    if (code >= 0 && (code & kStaged)) {
      const int off = code & ~kStaged;
      for (unsigned e = q[j]; e < len[j]; e += c[j]) {
        stage[off + e] = static_cast<W>(
            __ldg(hay + clamp_pos(lo0[j] + static_cast<int>(e), m)));
      }
      kl[j] = 32;
      sb[j] = static_cast<unsigned>(off) - static_cast<unsigned>(lo0[j]);
    } else if (code >= 0) {
      const int k = tree_levels(c[j], len[j]);
      if (q[j] < (1 << k) - 1) {             // node q + 1 of the heap
        const int node = q[j] + 1;
        const int depth = 31 - __clz(node);
        int a = lo0[j], b = hi0[j];
        for (int bit = depth - 1; bit >= 0 && a < b; --bit) {
          const int mid = mid_of(a, b);
          if ((node >> bit) & 1) a = mid + 1; else b = mid;
        }
        if (a < b) {
          stage[code + node - 1] =
              static_cast<W>(__ldg(hay + clamp_pos(mid_of(a, b), m)));
        }
      }
      kl[j] = k, v[j] = 1;
      sb[j] = static_cast<unsigned>(code) - 1u;
    }
  }
  __syncthreads();

  // 4. the reference's steps: in shared memory, then in device memory
  for (;;) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (kl[j] > 0 && l[j] < h[j]) {
        const int mid = mid_of(l[j], h[j]);
        const W val = stage[sb[j] + static_cast<unsigned>(v[j] ? v[j] : mid)];
        const bool right = val < static_cast<W>(x[j]);
        if (right) {
          l[j] = mid + 1;
        } else {
          h[j] = mid, hv[j] = val, left[j] = true;
        }
        if (v[j]) v[j] = 2 * v[j] + (right ? 1 : 0);
        --kl[j];
        any = true;
      }
    }
    if (!any) break;
  }
  for (;;) {
    W val[V];
    int mids[V];
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mids[j] = mid_of(l[j], h[j]);
      val[j] = 0;
      if (l[j] < h[j]) {
        val[j] = static_cast<W>(__ldg(hay + clamp_pos(mids[j], m)));
        any = true;
      }
    }
    if (!any) break;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (l[j] < h[j]) {
        if (val[j] < static_cast<W>(x[j])) {
          l[j] = mids[j] + 1;
        } else {
          h[j] = mids[j], hv[j] = val[j], left[j] = true;
        }
      }
    }
  }

  // 5. outputs
  int res[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool found = left[j] && hv[j] == static_cast<W>(x[j]);
    res[j] = kLocate ? (found ? l[j] : -1) : (found ? 1 : 0);
  }
  if (full) {
    store_lanes<V>(out + t0 + first, res);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (first + j < n) out[t0 + first + j] = static_cast<Out>(res[j]);
    }
  }
}

template <int T, bool kLocate, typename H, typename Out>
int launch_tiles(const H* hay, int m, const int* lo, const int* hi,
                 const int* needles, long long cap, Out* out,
                 int stage_bytes, bool vec, cudaStream_t st) {
  using S = SearchShape<T>;
  using W = typename Wide<H>::type;
  const int smem = S::kRunBytes + stage_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search_tiles<T, kLocate, H, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (cap + S::kTile - 1) / S::kTile;
  search_tiles<T, kLocate, H, Out><<<static_cast<unsigned>(blocks), T, smem,
                                     st>>>(
      hay, m, lo, hi, needles, cap, out,
      stage_bytes / static_cast<int>(sizeof(W)), vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLocate, typename H, typename Out>
int launch_kind(const void* hay, int m, const int* lo, const int* hi,
                const int* needles, long long cap, Out* out, int threads,
                int stage_bytes, bool vec, cudaStream_t st) {
  const H* h = static_cast<const H*>(hay);
#define REPRO_SEARCH(TT)                                                  \
  return launch_tiles<TT, kLocate>(h, m, lo, hi, needles, cap, out,       \
                                   stage_bytes, vec, st)
  REPRO_FOR_THREADS(threads, REPRO_SEARCH)
#undef REPRO_SEARCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kLocate, typename Out>
int launch(const void* hay, int kind, int m, const int* lo, const int* hi,
           const int* needles, long long cap, Out* out, int threads,
           int stage_bytes, void* stream) {
  if (!valid_threads(threads) || stage_bytes < 0 || stage_bytes % 16 ||
      stage_bytes > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = aligned(lo) && aligned(hi) && aligned(needles) &&
                   aligned(out);
  switch (kind) {
    case 0:
      return launch_kind<kLocate, int>(hay, m, lo, hi, needles, cap, out,
                                       threads, stage_bytes, vec, st);
    case 1:
      return launch_kind<kLocate, short>(hay, m, lo, hi, needles, cap, out,
                                         threads, stage_bytes, vec, st);
    case 2:
      return launch_kind<kLocate, long long>(hay, m, lo, hi, needles, cap,
                                             out, threads, stage_bytes, vec,
                                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

EXPORT int segment_search_found(const void* hay, int kind, int m,
                                const int* lo, const int* hi,
                                const int* needles, long long cap,
                                unsigned char* found, int threads,
                                int stage_bytes, void* stream) {
  return launch<false>(hay, kind, m, lo, hi, needles, cap, found, threads,
                       stage_bytes, stream);
}

EXPORT int segment_search_locate(const void* hay, int kind, int m,
                                 const int* lo, const int* hi,
                                 const int* needles, long long cap, int* pos,
                                 int threads, int stage_bytes,
                                 void* stream) {
  return launch<true>(hay, kind, m, lo, hi, needles, cap, pos, threads,
                      stage_bytes, stream);
}
