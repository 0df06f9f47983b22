// A measured alternative of K5 (src/repro_torch/kernels/csrc/search.cu),
// built only by tools/search_steps.py: warps take chunks of 32·V lanes,
// a thread's V searches interleaved; a row of 32 lanes that share one
// segment reads it into one of its warp's two shared-memory regions
// (whole where it fits, else its search tree's top 5 levels) and takes
// its first steps there. It measured slower than the kernel at every
// shape (PERF.md §6). Same C interface as the kernel, plus the
// staging budget of a block in bytes (0: no staging).
#include "common.cuh"

namespace {

constexpr int kSearchLanes = 4;     // lanes a thread

template <int T>
constexpr int kSearchMinBlocks = 1024 / T > 0 ? 1024 / T : 1;

template <typename H> struct Wide { using type = int; };
template <> struct Wide<long long> { using type = long long; };

__device__ __forceinline__ int clamp_pos(int p, int m) {
  return min(max(p, 0), m - 1);
}

__device__ __forceinline__ int mid_of(int l, int h) {
  return l + static_cast<int>(static_cast<unsigned>(h - l) >> 1);
}

// Chunk c of 32·V lanes goes to warp
// c mod (the grid's warps); row j of a chunk is lanes base + 32 j + lane,
// so a warp instruction touches 32 consecutive lanes. `region` is the
// entries of each of a warp's two staging regions (0: no staging).
template <int T, bool kLocate, typename H, typename Out>
__global__ void __launch_bounds__(T, kSearchMinBlocks<T>)
search_warps(const H* __restrict__ hay, int m, const int* __restrict__ lo,
             const int* __restrict__ hi, const int* __restrict__ needles,
             long long cap, Out* __restrict__ out, int region) {
  using W = typename Wide<H>::type;
  constexpr int V = kSearchLanes;
  extern __shared__ __align__(16) unsigned char s_mem[];
  const int lane = threadIdx.x & 31;
  W* const s_warp =
      reinterpret_cast<W*>(s_mem) + static_cast<size_t>(threadIdx.x >> 5) *
                                        2 * static_cast<size_t>(region);
  const long long step = static_cast<long long>(gridDim.x) * T * V;
  for (long long base = (static_cast<long long>(blockIdx.x) * T +
                         (threadIdx.x & ~31)) * V;
       base < cap; base += step) {
    int l[V], h[V], x[V], kl[V], node[V];
    unsigned sb[V];
    W hv[V];
    unsigned left = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + 32 * j + lane;
      const bool in = i < cap;
      l[j] = in ? __ldg(lo + i) : 0;
      const int h0 = in ? __ldg(hi + i) : 0;
      x[j] = in ? __ldg(needles + i) : 0;
      h[j] = (m > 0 && l[j] < h0) ? h0 : l[j];   // no segment: no reads
      hv[j] = 0, kl[j] = 0, node[j] = 0, sb[j] = 0;
    }
    if (region > 0) {
      // rows whose 32 lanes share one segment: the chunk's first two
      // such segments are read into the warp's regions, whole where they
      // fit, else their search tree's top 5 levels (31 entries)
      int slo0 = 0, shi0 = 0, slo1 = 0, shi1 = 0, nseg = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int a = __shfl_sync(kFull, l[j], 0);
        const int b = __shfl_sync(kFull, h[j], 0);
        if (a < b && __all_sync(kFull, l[j] == a && h[j] == b)) {
          int r = (nseg > 0 && a == slo0 && b == shi0) ? 0
                  : (nseg > 1 && a == slo1 && b == shi1) ? 1 : -1;
          const unsigned len = static_cast<unsigned>(b - a);
          const bool whole = len <= static_cast<unsigned>(region);
          if (r < 0 && nseg < 2 && (whole || region >= 31)) {
            r = nseg++;
            if (r == 0) slo0 = a, shi0 = b; else slo1 = a, shi1 = b;
            W* reg = s_warp + r * region;
            if (whole) {
#pragma unroll 4
              for (unsigned e = lane; e < len; e += 32) {
                reg[e] = static_cast<W>(
                    __ldg(hay + clamp_pos(a + static_cast<int>(e), m)));
              }
            } else if (lane < 31) {           // heap node lane + 1
              const int nd = lane + 1, depth = 31 - __clz(nd);
              int c = a, d = b;
              for (int bit = depth - 1; bit >= 0 && c < d; --bit) {
                const int mid = mid_of(c, d);
                if ((nd >> bit) & 1) c = mid + 1; else d = mid;
              }
              if (c < d) {
                reg[lane] =
                    static_cast<W>(__ldg(hay + clamp_pos(mid_of(c, d), m)));
              }
            }
          }
          if (r >= 0) {
            const unsigned off = static_cast<unsigned>(r * region);
            if (len <= static_cast<unsigned>(region)) {
              kl[j] = 32, sb[j] = off - static_cast<unsigned>(a);
            } else {
              kl[j] = 5, node[j] = 1, sb[j] = off - 1u;
            }
          }
        }
      }
      __syncwarp();
    }
    // the reference's steps: in the regions, then in device memory
    for (;;) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (kl[j] > 0 && l[j] < h[j]) {
          const int mid = mid_of(l[j], h[j]);
          const W val =
              s_warp[sb[j] + static_cast<unsigned>(node[j] ? node[j] : mid)];
          const bool right = val < static_cast<W>(x[j]);
          if (right) {
            l[j] = mid + 1;
          } else {
            h[j] = mid, hv[j] = val, left |= 1u << j;
          }
          if (node[j]) node[j] = 2 * node[j] + (right ? 1 : 0);
          --kl[j];
          any = true;
        }
      }
      if (!any) break;
    }
    for (;;) {
      W val[V];
      int mid[V];
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mid[j] = mid_of(l[j], h[j]);
        val[j] = 0;
        if (l[j] < h[j]) {
          val[j] = static_cast<W>(__ldg(hay + clamp_pos(mid[j], m)));
          any = true;
        }
      }
      if (!any) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (l[j] < h[j]) {
          if (val[j] < static_cast<W>(x[j])) {
            l[j] = mid[j] + 1;
          } else {
            h[j] = mid[j], hv[j] = val[j], left |= 1u << j;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + 32 * j + lane;
      if (i < cap) {
        const bool found =
            ((left >> j) & 1u) && hv[j] == static_cast<W>(x[j]);
        out[i] = static_cast<Out>(kLocate ? (found ? l[j] : -1)
                                          : (found ? 1 : 0));
      }
    }
    __syncwarp();                  // the regions are refilled next chunk
  }
}

template <int T, bool kLocate, typename H, typename Out>
int launch_tiles(const H* hay, int m, const int* lo, const int* hi,
                 const int* needles, long long cap, Out* out,
                 int stage_bytes, bool vec, cudaStream_t st) {
  (void)vec;
  using W = typename Wide<H>::type;
  const int region =
      stage_bytes / static_cast<int>(2 * (T / 32) * sizeof(W));
  const int smem = region * static_cast<int>(2 * (T / 32) * sizeof(W));
  auto kern = search_warps<T, kLocate, H, Out>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, T, smem);
  const long long want = (cap + T * kSearchLanes - 1) / (T * kSearchLanes);
  const int blocks = static_cast<int>(
      min(want, static_cast<long long>(max(per, 1) * max(sms, 1))));
  search_warps<T, kLocate, H, Out><<<blocks, T, smem, st>>>(
      hay, m, lo, hi, needles, cap, out, region);
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
