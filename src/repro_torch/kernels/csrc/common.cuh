// Shared device helpers of the graph kernels (sm_90a, plain C interface).
//
// Every launcher is an `extern "C"` function taking raw device pointers,
// sizes and PyTorch's current stream; it launches, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>
#include <unordered_map>

#define EXPORT extern "C" __attribute__((visibility("default")))

// Threads per block where the launcher takes no block size (spmm,
// scan_rows has its own 1024); the tuned launchers take `threads`, one of
// kBlockSizes, from the wrapper (repro_torch.kernels.tuner, whose untuned
// default is this same 256).
constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr bool valid_threads(int t) {
  return t >= 64 && t <= 1024 && (t & (t - 1)) == 0;
}

// Instantiates CALL(T) for the block size `threads` (64 ... 1024) and
// returns cudaErrorInvalidValue for any other.
#define REPRO_FOR_THREADS(threads, CALL)                                  \
  switch (threads) {                                                      \
    case 64: CALL(64); break;                                             \
    case 128: CALL(128); break;                                           \
    case 256: CALL(256); break;                                           \
    case 512: CALL(512); break;                                           \
    case 1024: CALL(1024); break;                                         \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

EXPORT const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Exclusive scan of each row of counts (rows × nblk) into offs, one block
// of 1024 threads per row; writes the row total and, when `lengths` is
// given, min(total, clamp).
__global__ void scan_rows(const int* __restrict__ counts, int nblk,
                          int* __restrict__ offs, int* __restrict__ totals,
                          int* __restrict__ lengths, int clamp) {
  __shared__ int buf[1024];
  const size_t row = blockIdx.x;
  const int* c = counts + row * nblk;
  int* o = offs + row * nblk;
  const int per = (nblk + blockDim.x - 1) / blockDim.x;
  const int beg = min(static_cast<int>(threadIdx.x) * per, nblk);
  const int end = min(beg + per, nblk);
  int s = 0;
  for (int i = beg; i < end; ++i) s += c[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int d = 1; d < blockDim.x; d <<= 1) {
    const int v = threadIdx.x >= d ? buf[threadIdx.x - d] : 0;
    __syncthreads();
    buf[threadIdx.x] += v;
    __syncthreads();
  }
  int run = buf[threadIdx.x] - s;
  for (int i = beg; i < end; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (threadIdx.x == blockDim.x - 1) {
    const int total = buf[threadIdx.x];
    totals[row] = total;
    if (lengths != nullptr) lengths[row] = min(total, clamp);
  }
}

// ---------------------------------------------------------------------------
// Single-pass ordered scans with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), as
// K1's offsets scan and emit and K2 run them over the tiles of each lane.
//
// Blocks run in no order, so a tile takes its index (its ticket) from the
// lane's counter: every tile before it was taken by a block that is
// already running, and a tile waits only on those. Each tile publishes
// its status word, hi32 = epoch << 2 | flag and lo32 = the tile's own
// count (flag kAggregate) or its inclusive prefix in the lane (flag
// kPrefix), then walks back over its predecessors until a prefix. The
// counters, statuses and K1's lane ends persist between calls (the
// wrapper keeps them per device); every launch takes a fresh epoch
// (< 2^30) from the wrapper and reads any word of another epoch as "not
// yet written", so no call ever sees an earlier call's flags, and
// nothing is reset between calls.
// ---------------------------------------------------------------------------

typedef unsigned long long u64;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kPrefix = 2u;

// Enters a launch's epoch on a lane's tile counter, once per block before
// its first ticket: the first call of an epoch lifts the counter to
// epoch << 32 (count 0); atomicMax never lowers a counter of the same
// epoch, so each launch counts from 0.
__device__ __forceinline__ u64 enter_epoch(u64* counter, unsigned epoch) {
  const u64 tag = static_cast<u64>(epoch) << 32;
  atomicMax(counter, tag);
  return tag;
}

// The next tile of a lane in this launch (after enter_epoch).
__device__ __forceinline__ int next_ticket(u64* counter, u64 tag) {
  return static_cast<int>(atomicAdd(counter, 1ull) - tag);
}

__device__ __forceinline__ void publish(u64* status, unsigned epoch,
                                        unsigned flag, int value) {
  atomicExch(status, (static_cast<u64>((epoch << 2) | flag) << 32) |
                         static_cast<unsigned>(value));
}

__device__ __forceinline__ u64 peek(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

// a + b for a, b in [0, INT_MAX], saturating at INT_MAX: every scan
// below adds counts this way (the LB scan's sums: a lane of duplicates
// can pass int32; below INT_MAX it is the plain sum); associative on
// that range.
__device__ __forceinline__ int sat_add(int a, int b) {
  return static_cast<int>(min(static_cast<unsigned>(a) +
                                  static_cast<unsigned>(b),
                              0x7fffffffu));
}

// Exclusive prefix of tile j > 0 of a lane whose statuses start at
// `status`, found by one whole warp: each step reads the 32 statuses
// below the window's top at once, waits until those down to the nearest
// published prefix are all written, and adds them (tile 0 always
// publishes a prefix).
__device__ __forceinline__ int look_back(const u64* status, int j,
                                         unsigned epoch) {
  const int lane = threadIdx.x & 31;
  int prefix = 0;
  for (int top = j - 1;;) {
    const int q = top - lane;
    unsigned flag = kPrefix;
    int value = 0;
    if (q >= 0) {
      const u64 w = peek(status + q);
      const unsigned hi = static_cast<unsigned>(w >> 32);
      flag = (hi >> 2) == epoch ? (hi & 3u) : 0u;
      value = static_cast<int>(static_cast<unsigned>(w));
    }
    const unsigned pre = __ballot_sync(kFull, flag == kPrefix);
    const unsigned need = pre ? (2u << (__ffs(pre) - 1)) - 1u : kFull;
    if (__ballot_sync(kFull, flag == 0) & need) continue;   // not written
    int v = ((need >> lane) & 1u) ? value : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      v = sat_add(v, __shfl_xor_sync(kFull, v, d));
    }
    prefix = sat_add(prefix, v);
    if (pre) return prefix;
    top -= 32;
  }
}

// Publishes tile j's count and returns its exclusive prefix; called by
// all 32 lanes of one warp, with the same arguments.
__device__ __forceinline__ int tile_prefix(u64* status, int j,
                                           unsigned epoch, int count) {
  const bool lead = (threadIdx.x & 31) == 0;
  if (j == 0) {
    if (lead) publish(status, epoch, kPrefix, count);
    return 0;
  }
  if (lead) publish(status + j, epoch, kAggregate, count);
  const int prefix = look_back(status, j, epoch);
  if (lead) publish(status + j, epoch, kPrefix, sat_add(prefix, count));
  return prefix;
}

// The inclusive prefix of a tile once it is published: a lane's total
// from its last tile. Waited on only by a block whose own ticket passed
// the lane's tile count, so every tile is held by a running block.
__device__ __forceinline__ int wait_prefix(const u64* status,
                                           unsigned epoch) {
  for (;;) {
    const u64 w = peek(status);
    const unsigned hi = static_cast<unsigned>(w >> 32);
    if ((hi >> 2) == epoch && (hi & 3u) == kPrefix) {
      return static_cast<int>(static_cast<unsigned>(w));
    }
    __nanosleep(64);
  }
}

// Shared-memory index with one pad word every 32: a thread reading V
// consecutive entries and a warp reading 32 consecutive ones are both
// free of bank conflicts (V a power of two).
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// Exclusive block-wide sum of `v` over the T threads in thread order;
// `warp_buf` holds T / 32 ints, v >= 0. Every thread must call it.
template <int T>
__device__ __forceinline__ int block_excl_sum(int v, int* warp_buf,
                                              int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = sat_add(x, y);
  }
  // a saturated inclusive sum less v is no exclusive one: shift instead
  const int ex = __shfl_up_sync(kFull, x, 1);
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    const int c = warp_buf[w];
    before = sat_add(before, (w < warp) ? c : 0);
    all = sat_add(all, c);
  }
  __syncthreads();                        // warp_buf may be reused
  *total = all;
  return sat_add(before, lane == 0 ? 0 : ex);
}

// Exclusive block-wide running maximum of `v` (identity -1), as above.
template <int T>
__device__ __forceinline__ int block_excl_max(int v, int* warp_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, y);
  }
  const int excl = max(__shfl_up_sync(kFull, x, 1), -1);
  if (lane == 31) warp_buf[warp] = x;
  __syncthreads();
  int before = -1;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    if (w < warp) before = max(before, warp_buf[w]);
  }
  __syncthreads();
  return max(before, lane == 0 ? -1 : excl);
}

// *p = v; with kStream an evict-first store (data the kernel writes once
// and does not read again).
template <bool kStream, typename X>
__device__ __forceinline__ void store(X* p, X v) {
  if constexpr (kStream) __stcs(p, v); else *p = v;
}

// p[i] = v0 + step * i (int32, wrapping) for i in [lo, hi), by thread t of
// nt: 16-byte stores between the unaligned ends.
template <bool kStream = false>
__device__ __forceinline__ void fill_run(int* __restrict__ p, long long lo,
                                         long long hi, int v0, int step,
                                         int t, int nt) {
  if (lo >= hi) return;
  const auto at = [&](long long i) {
    return static_cast<int>(static_cast<unsigned>(v0) +
                            static_cast<unsigned>(step) *
                                static_cast<unsigned>(i));
  };
  const long long mis = (reinterpret_cast<uintptr_t>(p + lo) >> 2) & 3;
  const long long a = min(hi, lo + ((4 - mis) & 3));
  for (long long i = lo + t; i < a; i += nt) store<kStream>(p + i, at(i));
  const long long nvec = (hi - a) >> 2;
  int4* v = reinterpret_cast<int4*>(p + a);
  for (long long i = t; i < nvec; i += nt) {
    const long long e = a + 4 * i;
    store<kStream>(v + i,
                   make_int4(at(e), at(e + 1), at(e + 2), at(e + 3)));
  }
  for (long long i = a + nvec * 4 + t; i < hi; i += nt) {
    store<kStream>(p + i, at(i));
  }
}

// p[lo, hi) = v, as fill_run.
template <bool kStream>
__device__ __forceinline__ void fill_bytes(unsigned char* __restrict__ p,
                                           long long lo, long long hi,
                                           unsigned char v, int t, int nt) {
  if (lo >= hi) return;
  const long long mis = reinterpret_cast<uintptr_t>(p + lo) & 15;
  const long long a = min(hi, lo + ((16 - mis) & 15));
  for (long long i = lo + t; i < a; i += nt) store<kStream>(p + i, v);
  const long long nvec = (hi - a) >> 4;
  const int w = v * 0x01010101;
  int4* q = reinterpret_cast<int4*>(p + a);
  for (long long i = t; i < nvec; i += nt) {
    store<kStream>(q + i, make_int4(w, w, w, w));
  }
  for (long long i = a + nvec * 16 + t; i < hi; i += nt) {
    store<kStream>(p + i, v);
  }
}

// A lane's tail [lo, hi) = -1, split in contiguous parts over the
// gridDim.x blocks of the lane.
__device__ __forceinline__ void fill_tail(int* __restrict__ row, int lo,
                                          int hi) {
  const long long len = hi - lo;
  if (len <= 0) return;
  const long long part = (len + gridDim.x - 1) / gridDim.x;
  const long long a = lo + part * blockIdx.x;
  fill_run(row, a, min(a + part, static_cast<long long>(hi)), -1, 0,
           threadIdx.x, blockDim.x);
}

// Blocks of `kernel` the card holds at once (its SMs times the blocks an
// SM takes at `threads` threads), measured once per kernel: the grid of
// a persistent launch.
template <typename K>
int resident_blocks(K kernel, int threads) {
  static std::mutex lock;
  static std::unordered_map<const void*, int> seen;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> guard(lock);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, 0);
  const int blocks = max(1, per) * max(1, sms);
  seen[key] = blocks;
  return blocks;
}
