// Mixture-of-experts dispatch gather (K8) for Hopper.
//
// Replaces the TPU kernel moe_gather_kernel
// (src/repro/kernels/moe_dispatch.py:38): out[s] = x[slot_token[s]] for
// every expert-buffer slot s, and a zero row where slot_token[s] < 0 (a
// slot the capacity left empty). A token id past the last row reads the
// last row: JAX clamps out-of-range gather indices and the reference's
// x[safe] relies on that, so this kernel and its plain version clamp too
// (no host-side check, which would cost a synchronisation).
//
// What differs from the TPU kernel: the Pallas kernel holds the whole
// (T, D) token matrix in VMEM and gathers from it per slot tile; the card
// cannot hold Kimi K2's 8192 x 7168 bf16 tokens (117 MB) in shared
// memory, nor in its 50 MB L2. Walked in slot order (expert-major), a
// token routed to top-k experts is read top-k times, one expert's worth
// of slots apart, so each filled slot reads its row from device memory:
// (filled slots + all slots) x row bytes move, 2.1 GB at Kimi K2's
// dispatch against the 1.31 GB of the bound. So the slots are first
// ordered by token with a counting sort on the card (no host read):
// token_count counts the slots of each bin (bin 0 the empty slots, bin
// 1 + t those of the clamped token t), scan_rows turns the counts into
// the bins' starts, token_place writes each slot's index at its bin's
// next position; both take one atomic per bin a warp touches
// (__match_any_sync). The order within a bin varies from run to run, and
// the output does not: every slot of a bin gets the same row. Then the
// gather walks the slots in that order, one warp a slot, a block's 8
// warps on neighbouring positions: a token's slots are copied back to
// back, the first read of its row brings it on chip and the others hit
// L1 or L2, and device memory moves x once and the output once. The
// output is written with streaming stores (__stcs: nothing reads it back
// soon, so it should not push the token rows out of L2). The warp copies
// its row as 16-byte vectors when the row's bytes are a multiple of 16
// and both base pointers are 16-byte aligned, else in units of 4 or 2
// bytes. The copy is of bits, so one kernel serves fp32, bf16 and fp16.
// Bound by bytes: x read once, each output row written once (S x D x
// itemsize) and 4 bytes of slot id a slot.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kCopyDepth = 4;   // vectors a lane loads before it stores

// bin of a slot: 0 when empty, 1 + its clamped token otherwise
__device__ __forceinline__ int token_bin(int t, int tokens) {
  return t < 0 || tokens == 0 ? 0 : min(t, tokens - 1) + 1;
}

// One warp-aggregated pass over the slots: lanes of a warp that share a
// bin take one atomicAdd on counts[bin] together; with `order`, each
// writes its slot at the bin's returned position plus its rank among
// them.
__global__ void token_bins(const int* __restrict__ slot_token,
                           long long slots, int tokens, int* __restrict__ counts,
                           int* __restrict__ order) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x +
                        (threadIdx.x & ~31);
       base < slots; base += stride) {                 // warp-uniform
    const long long s = base + lane;
    const int bin = s < slots ? token_bin(slot_token[s], tokens) : -1;
    const unsigned peers = __match_any_sync(kFull, bin);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (lane == leader && bin >= 0) {
      pos = atomicAdd(counts + bin, __popc(peers));
    }
    if (order != nullptr) {
      pos = __shfl_sync(kFull, pos, leader);
      if (bin >= 0) {
        order[pos + __popc(peers & ((1u << lane) - 1u))] =
            static_cast<int>(s);
      }
    }
  }
}

template <typename U>
__global__ void moe_gather_kernel(const U* __restrict__ x, int tokens,
                                  long long row_units,
                                  const int* __restrict__ slot_token,
                                  const int* __restrict__ order,
                                  long long slots, U* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long j = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       j < slots; j += warps) {
    const long long s = order[j];
    const int t = slot_token[s];
    U* dst = out + s * row_units;
    if (t < 0 || tokens == 0) {
      const U zero{};
      for (long long i = lane; i < row_units; i += 32) __stcs(dst + i, zero);
      continue;
    }
    const U* src = x + static_cast<long long>(min(t, tokens - 1)) * row_units;
    long long i = lane;
    for (; i + 32 * (kCopyDepth - 1) < row_units; i += 32 * kCopyDepth) {
      U v[kCopyDepth];
#pragma unroll
      for (int u = 0; u < kCopyDepth; ++u) v[u] = __ldg(src + i + 32 * u);
#pragma unroll
      for (int u = 0; u < kCopyDepth; ++u) __stcs(dst + i + 32 * u, v[u]);
    }
    for (; i < row_units; i += 32) __stcs(dst + i, __ldg(src + i));
  }
}

template <typename U>
int launch(const void* x, int tokens, long long row_bytes,
           const int* slot_token, long long slots, int* scratch, void* out,
           cudaStream_t st) {
  const int bins = tokens + 1;
  int* counts = scratch;
  int* cursor = counts + bins;
  int* total = cursor + bins;
  int* order = total + 1;
  const cudaError_t err =
      cudaMemsetAsync(counts, 0, bins * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want_b = (slots + kThreads - 1) / kThreads;
  const int grid_b = static_cast<int>(want_b < 4096 ? want_b : 4096);
  token_bins<<<grid_b, kThreads, 0, st>>>(slot_token, slots, tokens, counts,
                                          nullptr);
  scan_rows<<<1, 1024, 0, st>>>(counts, bins, cursor, total, nullptr, 0);
  token_bins<<<grid_b, kThreads, 0, st>>>(slot_token, slots, tokens, cursor,
                                          order);
  const long long want = (slots + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  moe_gather_kernel<U><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(x), tokens,
      row_bytes / static_cast<long long>(sizeof(U)), slot_token, order,
      slots, static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (tokens, row_bytes / itemsize) rows; out: (slots, same) rows;
// scratch: 2 (tokens + 1) + 1 + slots ints (the bins' counts and starts,
// the total, the slots by token).
EXPORT int moe_gather(const void* x, int tokens, long long row_bytes,
                      int itemsize, const int* slot_token, long long slots,
                      int* scratch, void* out, void* stream) {
  if (slots == 0 || row_bytes == 0) return 0;
  if (slots > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](int a) {
    return row_bytes % a == 0 &&
           reinterpret_cast<std::uintptr_t>(x) % a == 0 &&
           reinterpret_cast<std::uintptr_t>(out) % a == 0;
  };
  if (aligned(16)) {
    return launch<uint4>(x, tokens, row_bytes, slot_token, slots, scratch,
                         out, st);
  }
  if (aligned(4)) {
    return launch<unsigned>(x, tokens, row_bytes, slot_token, slots, scratch,
                            out, st);
  }
  if (itemsize == 2 && aligned(2)) {
    return launch<unsigned short>(x, tokens, row_bytes, slot_token, slots,
                                  scratch, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
