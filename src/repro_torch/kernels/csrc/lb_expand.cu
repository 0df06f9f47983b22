// Load-balanced expansion geometry (K6) for Hopper.
//
// Replaces the TPU kernel lb_expand_kernel
// (src/repro/kernels/lb_expand.py:53): for each output slot of
// [0, cap_out), the input segment it belongs to (the upper bound of the
// slot in the exclusive scan offsets[0..cap_in), less one, clamped to a
// valid segment), its rank inside that segment and whether it lies below
// the total offsets[cap_in]. It is the tuner's probe "lb_expand" and the
// kernel API's lb_expand (repro_torch.kernels.ops).
//
// One thread per output slot, running the search K1 and K3 share
// (common.cuh: lb_search, the reference's body at lb_expand.py:34-45).
// Every slot runs it, the slots past the total too (they end on the last
// segment, as the reference's do), so every output, valid or not, equals
// the plain version's. cap_in = 0 (offsets of length 1) gives in_pos 0
// and rank = slot - offsets[0], as the reference clips there.
//
// What differs from the TPU kernel: the Pallas kernel maps all the
// offsets into VMEM on every grid step; here they stay in device memory
// and are read through L2 (16.8 MB at rmat scale 22, inside the 50 MB
// L2), and neighbouring slots walk the same search path, so a warp's
// probes mostly hit one line. valid is written as one byte (the API
// returns a bool), not the reference kernel's int32.
// Bound by bytes: 9 bytes written per slot and the offsets read once.
#include "common.cuh"

namespace {

__global__ void lb_expand_kernel(const int* __restrict__ offs, int cap_in,
                                 int cap_out, int iters,
                                 int* __restrict__ in_pos,
                                 int* __restrict__ rank,
                                 unsigned char* __restrict__ valid) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cap_out) return;
  const int slot = static_cast<int>(i);
  const int pos = lb_search(offs, cap_in, slot, iters);
  in_pos[slot] = pos;
  rank[slot] = slot - offs[pos];
  valid[slot] = slot < offs[cap_in] ? 1 : 0;
}

}  // namespace

EXPORT int lb_expand(const int* offsets, int cap_in, int cap_out, int iters,
                     int* in_pos, int* rank, unsigned char* valid,
                     int threads, void* stream) {
  if (!valid_threads(threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cap_out > 0) {
    const int grid = static_cast<int>(
        (static_cast<long long>(cap_out) + threads - 1) / threads);
    lb_expand_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        offsets, cap_in, cap_out, iters, in_pos, rank, valid);
  }
  return static_cast<int>(cudaGetLastError());
}
