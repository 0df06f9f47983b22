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
// memory, and needs not: rows are copied straight from device memory.
// One warp per slot, a grid-stride loop over slots; the warp copies its
// row as 16-byte vectors when the row's bytes are a multiple of 16 and
// both base pointers are 16-byte aligned, else in units of 4 or 2 bytes.
// The copy is of bits, so one kernel serves fp32, bf16 and fp16.
// Bound by bytes: each output row written once (S x D x itemsize) and x
// read once; a token routed to several experts is read again, mostly from
// L2.
#include "common.cuh"

#include <cstdint>

namespace {

template <typename U>
__global__ void moe_gather_kernel(const U* __restrict__ x, int tokens,
                                  long long row_units,
                                  const int* __restrict__ slot_token,
                                  long long slots, U* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long s = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       s < slots; s += warps) {
    const int t = slot_token[s];
    U* dst = out + s * row_units;
    if (t < 0 || tokens == 0) {
      const U zero{};
      for (long long j = lane; j < row_units; j += 32) dst[j] = zero;
    } else {
      const U* src = x + static_cast<long long>(min(t, tokens - 1)) *
                             row_units;
      for (long long j = lane; j < row_units; j += 32) dst[j] = src[j];
    }
  }
}

template <typename U>
int launch(const void* x, int tokens, long long row_bytes,
           const int* slot_token, long long slots, void* out,
           cudaStream_t st) {
  const long long want = (slots + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  moe_gather_kernel<U><<<grid, kThreads, 0, st>>>(
      static_cast<const U*>(x), tokens,
      row_bytes / static_cast<long long>(sizeof(U)), slot_token, slots,
      static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (tokens, row_bytes / itemsize) rows; out: (slots, same) rows.
EXPORT int moe_gather(const void* x, int tokens, long long row_bytes,
                      int itemsize, const int* slot_token, long long slots,
                      void* out, void* stream) {
  if (slots == 0 || row_bytes == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](int a) {
    return row_bytes % a == 0 &&
           reinterpret_cast<std::uintptr_t>(x) % a == 0 &&
           reinterpret_cast<std::uintptr_t>(out) % a == 0;
  };
  if (aligned(16)) {
    return launch<uint4>(x, tokens, row_bytes, slot_token, slots, out, st);
  }
  if (aligned(4)) {
    return launch<unsigned>(x, tokens, row_bytes, slot_token, slots, out,
                            st);
  }
  if (itemsize == 2 && aligned(2)) {
    return launch<unsigned short>(x, tokens, row_bytes, slot_token, slots,
                                  out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
