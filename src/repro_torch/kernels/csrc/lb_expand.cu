// Load-balanced expansion geometry (K6) for Hopper.
//
// Replaces the TPU kernel lb_expand_kernel
// (src/repro/kernels/lb_expand.py:53): for each output slot of
// [0, cap_out), the input segment it belongs to (the upper bound of the
// slot in the exclusive scan of the sizes, less one, clamped to a valid
// segment), its rank inside that segment and whether it lies below the
// total. It is the tuner's probe "lb_expand" and the kernel API's
// lb_expand (repro_torch.kernels.ops).
//
// K3's design with B = 1 and no gathers (lb_tiles.cuh): the int32 scan of
// the sizes (it writes the total), then lb_expand_tiles, which walks the
// live slots in tiles whose segments are staged in shared memory, writes
// each slot's segment and rank with no search, and fills the slots past
// the total with what the reference's search gives them: in_pos = cap_in
// - 1 (0 at cap_in = 0), rank = slot - offsets[cap_in - 1] (slot at
// cap_in = 0), valid 0. Every output, valid or not, equals the plain
// version's.
//
// What differs from the TPU kernel: the Pallas kernel maps all the
// offsets into VMEM on every grid step and searches them for every slot;
// here no slot searches. valid is written as one byte (the API returns a
// bool), not the reference kernel's int32.
// Bound by bytes: 9 bytes written a slot and 4 read a segment.
#include "lb_tiles.cuh"

EXPORT int lb_expand(const int* sizes, int cap_in, int cap_out,
                     int* offsets, int* tile_lane, long long tile_lane_cap,
                     u64* counters, u64* live_end, u64* status,
                     long long status_cap, unsigned epoch, int* in_pos,
                     int* rank, unsigned char* valid, int* total,
                     int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LB_T(T)                                                      \
  return lb_tiles_launch<T, false>(                                        \
      NoCols{}, sizes, nullptr, nullptr, 1, cap_in, cap_out, 0, offsets,   \
      nullptr, tile_lane, tile_lane_cap, counters, live_end, status,       \
      status_cap, epoch, nullptr, nullptr, nullptr, in_pos, rank, valid,   \
      total, st);
  REPRO_FOR_THREADS(threads, REPRO_LB_T)
#undef REPRO_LB_T
  return static_cast<int>(cudaErrorInvalidValue);
}
