// Bounded segmented binary search (K5) for Hopper, in both of its modes.
//
// Replaces the TPU kernel segment_search_kernel
// (src/repro/kernels/segment_search.py:52): for each lane i, the lower
// bound of needles[i] in the sorted haystack[lo[i]:hi[i]); `found` mode
// writes 1 where the haystack holds the needle there (else 0), `locate`
// mode the matched position (else -1). It is the SmallLarge probe of
// segmented intersection (found) and of the masked SpGEMM behind
// triangle counting (locate).
//
// What differs from the TPU kernel, and why:
//  * The Pallas kernel maps the whole haystack into VMEM on every grid
//    step. Here it stays in device memory and is read through the
//    read-only path (__ldg): the columns of rmat scale 18 (30 MB) stay in
//    the 50 MB L2; at scale 22 (513 MB) the probes come from HBM.
//  * The Pallas kernel runs a fixed ceil(log2 m) + 1 steps on every lane;
//    a thread here stops when lo >= hi. Each step of a live lane is the
//    reference's step (mid clamped to the haystack), so the lower bound,
//    and every output, is bit-equal. The midpoint is lo + (hi - lo) / 2,
//    taken unsigned: the reference's (lo + hi) // 2 overflows int32 once
//    the edges pass 2^30.
//  * One thread per needle, in a grid-stride loop with a 64-bit index: a
//    launch of triangle counting at rmat scale 18 holds 6.6e8 lanes.
//  * A lane with lo >= hi reads nothing (padding lanes, empty segments,
//    and every lane of an empty haystack, which is never touched).
//  * The haystack is the graph's dense column array at its storage
//    plan's index dtype (int16, int32 or int64; `kind` 1, 0, 2, as the
//    advance kernels number them), compared with the int32 needles after
//    widening: an int16 graph's probes read 2 bytes an entry.
// Threads per block come from the wrapper (the tuner's op
// "segment_search"). Bound by bytes: 16 B per lane (needle, lo, hi read
// once, one int32 or byte written) plus the haystack once; the search's
// dependent loads are latency, which the many lanes in flight hide.
#include "common.cuh"

namespace {

template <bool kLocate, typename Out, typename T>
__global__ void search_kernel(const T* __restrict__ hay, int m,
                              const int* __restrict__ lo,
                              const int* __restrict__ hi,
                              const int* __restrict__ needles,
                              long long cap, Out* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < cap; i += stride) {
    const int h0 = hi[i];
    const int x = needles[i];
    int l = lo[i], h = h0;
    bool found = false;
    if (l < h && m > 0) {
      while (l < h) {
        const int mid =
            l + static_cast<int>(static_cast<unsigned>(h - l) >> 1);
        if (static_cast<long long>(__ldg(hay + min(max(mid, 0), m - 1))) <
            x) {
          l = mid + 1;
        } else {
          h = mid;
        }
      }
      found = l < h0 && static_cast<long long>(
                            __ldg(hay + min(max(l, 0), m - 1))) == x;
    }
    if (kLocate) out[i] = static_cast<Out>(found ? l : -1);
    else out[i] = static_cast<Out>(found ? 1 : 0);
  }
}

template <bool kLocate, typename Out>
int launch(const void* hay, int kind, int m, const int* lo, const int* hi,
           const int* needles, long long cap, Out* out, int threads,
           void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap > 0) {
    const long long want = (cap + threads - 1) / threads;
    const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SEARCH(T)                                                   \
  search_kernel<kLocate, Out, T><<<blocks, threads, 0, st>>>(             \
      static_cast<const T*>(hay), m, lo, hi, needles, cap, out)
    switch (kind) {
      case 0: REPRO_SEARCH(int); break;
      case 1: REPRO_SEARCH(short); break;
      case 2: REPRO_SEARCH(long long); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPRO_SEARCH
  }
  return static_cast<int>(cudaGetLastError());
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
