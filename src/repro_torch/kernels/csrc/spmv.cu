// Masked-semiring SpMV (K4) and SpMM (K4m) row kernels for Hopper.
//
// ---- K4, spmv: one dense column -------------------------------------
//
// Replaces the TPU kernel semiring_ell_kernel
// (src/repro/kernels/semiring_spmv.py:56) together with the ELL pack and
// the COO-overflow merge of its wrapper (src/repro/kernels/ops.py:143-217).
// It reads the CSR directly, so no per-call ELL pack exists, and folds
// each row exactly as the reference's hybrid sweep
// (src/repro/linalg/ops.py:87-140):
//   * the first `width` edges by the pairwise halving tree over
//     wp = pow2(width) leaves, padded with the (+)-identity z;
//   * the edges past `width` one at a time, in ascending edge order
//     (an atomic index_add_ would add in no fixed order);
//   * empty and masked-out rows get z.
// Products and sums use __fmul_rn / __fadd_rn (and the build passes
// -fmad=false), so each product and each sum rounds as PyTorch's separate
// operations do: the result is bit-equal to the plain version on the CPU.
//
// A power-law graph's time goes to its heaviest rows: the overflow fold
// is one serial chain per row (163,460 dependent adds for rmat scale
// 22's hub), so a kernel that walks a row's overflow with one warp takes
// as long as that row's loads in series. The launch has three kinds of
// block, in this order, so the heaviest rows start first:
//   1. a block per very heavy row (overflow > 2048 edges, the wrapper's
//      SPMV_BLOCK_OVER), the first entries of `heavy`, the rows of
//      degree > width sorted by degree, largest first (the wrapper makes
//      the list once per graph): warp 0 folds the tree, then its lane 0
//      folds the overflow in order from a two-slab ring in shared memory
//      that the other warps fill with products (gathered in parallel),
//      so the chain holds only the adds. Such a block holds its SM's
//      slots with one thread at work for most of its time: 128 threads
//      (the op's default, kernels/tuner.py) measured fastest at rmat
//      scale 22;
//   2. a warp per 32 further heavy rows, consecutive in `heavy`, so of
//      similar length: it folds their 32 trees, then per round gathers
//      kRound overflow products of each row (coalesced) into a shared
//      tile, and lane r folds row r's in order;
//   3. a warp per 32 consecutive rows for the light rows (degree <=
//      width): rows of d <= 32 edges run in groups of pow2(d) lanes, 32
//      / pow2(d) rows at once, and rows of 32 < d <= width take the warp.
//      The tree over wp leaves with d real ones equals the tree over
//      pow2(d) leaves followed by one (+) z whenever pow2(d) < wp: the
//      levels of stride >= pow2(d) only (+) z into each partial, and
//      x (+) z (+) z = x (+) z, which holds for plus (-0 -> +0), for
//      or_and's max(x, 0) and for the true identities. That keeps the
//      bits and leaves no lane idle.
// The wrapper gives the threads per block (the tuner's op "spmv"); no
// block size changes the fold, so every size gives the same bits.
// Bound by bytes: per edge a 4-byte column read (plus 4 bytes of value
// when weighted), x read once (4 bytes per vertex: 16.8 MB at rmat scale
// 22, which the 50 MB L2 holds), per row 4 bytes of offsets and 4 of
// output. The per-edge random gathers of x go through L2 (one 32-byte
// sector for 4 bytes: at rmat scale 22 they, not the bytes, set the
// time; they take the read-only path, __ldg, which measured faster).
// Below it sits the longest overflow's chain: one dependent add per
// edge, ~4 cycles.

// ---- K4m, spmm: a dense (nx, k) block --------------------------------
//
// Replaces the same TPU kernel, semiring_ell_kernel
// (src/repro/kernels/semiring_spmv.py:56), as its k-column wrapper
// semiring_spmm (src/repro/kernels/ops.py:143) runs it on a (k, tiles)
// grid, with that wrapper's ELL pack and its COO-overflow segment reduce
// over all m edges x k columns: Y<mask>[i, c] = (+)_{e in row i}
// vals[e] (x) X[cols[e], c], X row-major float32, the (+)-identity on
// empty and masked-out rows. Reach runs it with or_and at k = B sources,
// label propagation with plus_times at k = 32 one-hot label columns.
//  * One warp per (row, 32-column chunk): lanes split into G = 32 / KP
//    edge groups x KP columns, KP = pow2(k) capped at 32 (one group of 32
//    columns when k >= 32). The warp reads 32 of the row's columns (and
//    values) at once, coalesced; group g then takes edges g, g + G, ...
//    of the chunk by shuffles, so its lanes read KP consecutive floats of
//    one row of X and issue KP independent loads per chunk (32 at
//    k >= 32); the next chunk's columns are loaded before this chunk's
//    rows of X.
//  * Heavy rows: a row of d edges costs one warp d / 32 chunk steps, and
//    the hubs of a power-law graph (9,699 edges at rmat scale 16, 163,558
//    at 22) would leave one warp running long after the rest of the grid.
//    A row of more than kHeavy edges is split over the block's 8 warps
//    instead, one contiguous share each.
//  * Each group folds its edges in ascending order starting from the
//    fold's identity (0 for plus, as the reference's segment_sum starts
//    there; -inf for or_and's max, so a row's result is the max of its
//    own products, as segment_max gives it); the groups merge by a fixed
//    shuffle tree, a heavy row's shares in warp order. Every output is
//    folded in one fixed order: the kernel is deterministic. At k >= 32,
//    on rows of at most kHeavy edges, the fold IS the ascending edge
//    order of the plain version (index_add_ on the CPU). For min, max
//    and plus over integer values below 2^24 any order gives the same
//    bits, which covers reach (0/1) and label propagation (vote counts
//    at most the degree).
//  * Indices are int32: the wrapper refuses n*k or nx*k past 2^31.
//  * Blocks are always kThreads = 256 threads: the heavy-row split folds
//    the block's 8 warps' shares in a fixed order, so another block size
//    would change float sums. spmm has no tuner probe.
// Bound by bytes: per edge a 4-byte column (plus 4 of value) and k*4
// bytes of X gathered (through L2 where X fits its 50 MB), per row 4 of
// offsets, 1 of mask and k*4 of output.

// ---- Precision (both kernels) ----------------------------------------
//
// The TPU kernel rounds its (x) through the semiring's mul_op
// (src/repro/kernels/semiring_spmv.py:48), so under precision="bf16"
// (src/repro/linalg/semiring.py:78-104, plus_times and plus_and only) it
// rounds both operands to bfloat16, then the product, and widens it to
// fp32 for the (+) fold; a structural matrix's product (the gathered x
// itself) rounds to bfloat16 too. Here those are two more semiring codes,
// kPlusTimesBf16 and kPlusAndBf16: their Ring rounds with
// __float2bfloat16_rn (to nearest even, as PyTorch's conversion rounds).
// The product of two bfloat16 values is exact in fp32, so rounding the
// fp32 product once gives the bfloat16 product. The folds are the fp32
// folds above, unchanged. Both kernels take their columns as int32 and
// their values as fp32: the wrapper decodes a delta or narrow column
// store and widens bfloat16 values once per graph.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// semiring codes, the order of repro_torch.linalg.semiring.SEMIRINGS,
// then the bf16 variants of the plus semirings (Semiring.code)
enum {
  kPlusTimes = 0,
  kMinPlus = 1,
  kOrAnd = 2,
  kMaxMin = 3,
  kPlusAnd = 4,
  kPlusTimesBf16 = 5,
  kPlusAndBf16 = 6
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Ring<SR>: zero() the (+)-identity, add the (+), mul the (x) of a value
// and a gathered x, lone(x) the product of a structural matrix

template <int SR>
struct Ring;

template <>
struct Ring<kPlusTimes> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float lone(float x) { return x; }
};
template <>
struct Ring<kMinPlus> {
  static __device__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ float add(float a, float b) { return fminf(a, b); }
  static __device__ float mul(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float lone(float x) { return x; }
};
template <>
struct Ring<kOrAnd> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
  static __device__ float lone(float x) { return x; }
};
template <>
struct Ring<kMaxMin> {
  static __device__ float zero() { return __int_as_float(0xff800000); }
  static __device__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
  static __device__ float lone(float x) { return x; }
};
template <>
struct Ring<kPlusAnd> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) { return fminf(a, b); }
  static __device__ float lone(float x) { return x; }
};

template <>
struct Ring<kPlusTimesBf16> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) {
    return bf16_round(__fmul_rn(bf16_round(a), bf16_round(b)));
  }
  static __device__ float lone(float x) { return bf16_round(x); }
};
template <>
struct Ring<kPlusAndBf16> {
  static __device__ float zero() { return 0.0f; }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float mul(float a, float b) {
    return fminf(bf16_round(a), bf16_round(b));
  }
  static __device__ float lone(float x) { return bf16_round(x); }
};

constexpr int kProdDepth = 16;      // a producer's loads in flight
constexpr int kRound = 16;          // heavy warps: edges a row a round
constexpr int kStage = kRound + 1;  // padded row of their tile
// dynamic shared memory per warp: the heavy warps' 32 x kStage tile and
// their rows' overflow starts and lengths; the light warps' 3 x 32 slots
// fit in it, and a very heavy row's block uses all of its block's as a
// two-slab ring.
constexpr int kSpmvWarpSmem = (32 * kStage + 2 * 32) * 4;

// The warp's tree over wp = 32 C leaves of the edges [start, start + lim),
// lim <= width: leaf j (lane j % 32, slot j / 32) holds edge j's product,
// z past lim; the levels of stride >= 32 fold within a lane's slots, the
// last five by __shfl_down_sync. The result is valid in lane 0.
template <int SR, int C>
__device__ __forceinline__ float tree_row(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ x,
                                          int nx, int start, int lim,
                                          int wp) {
  using R = Ring<SR>;
  const int lane = threadIdx.x & 31;
  float q[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int j = lane + 32 * i;
    float p = R::zero();
    if (j < lim) {
      const int e = start + j;
      const float xv = __ldg(x + min(max(cols[e], 0), nx - 1));
      p = vals != nullptr ? R::mul(vals[e], xv) : R::lone(xv);
    }
    q[i] = p;
  }
#pragma unroll
  for (int h = C / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) q[i] = R::add(q[i], q[i + h]);
  }
  float v = q[0];
  for (int k = min(wp, 32) / 2; k >= 1; k >>= 1) {
    v = R::add(v, __shfl_down_sync(kFull, v, k));
  }
  return v;
}

// 1. one very heavy row: warp 0 folds the tree, then its lane 0 the
// overflow in edge order from a two-slab ring (the block's shared
// memory) that the other warps fill with products
template <int SR, int C>
__device__ void spmv_block_row(const int* __restrict__ offsets,
                               const int* __restrict__ cols,
                               const float* __restrict__ vals,
                               const float* __restrict__ x, int nx,
                               const unsigned char* __restrict__ mask,
                               int width, int wp, int row,
                               float* __restrict__ y, float* ring) {
  using R = Ring<SR>;
  const int warp = threadIdx.x >> 5;
  if (mask != nullptr && !mask[row]) {        // block-uniform
    if (threadIdx.x == 0) y[row] = R::zero();
    return;
  }
  // each slab half the block's shared memory, a multiple of 4 floats
  const int slab = ((blockDim.x >> 5) * kSpmvWarpSmem / 8) & ~3;
  const int start = offsets[row], end = offsets[row + 1];
  const int over0 = start + width;
  const int rounds = (end - over0 + slab - 1) / slab;
  const int nprod = blockDim.x - 32;          // producer threads
  float v = R::zero();
  if (warp == 0) v = tree_row<SR, C>(cols, vals, x, nx, start, width, wp);
  for (int r = 0; r <= rounds; ++r) {
    if (warp > 0 && r < rounds) {             // products of round r
      const int base = over0 + r * slab;
      const int cnt = min(slab, end - base);
      float* dst = ring + (r & 1) * slab;
      for (int i0 = threadIdx.x - 32; i0 < cnt; i0 += kProdDepth * nprod) {
        int c[kProdDepth];
#pragma unroll
        for (int u = 0; u < kProdDepth; ++u) {  // independent loads first
          const int i = i0 + u * nprod;
          c[u] = i < cnt ? cols[base + i] : 0;
        }
#pragma unroll
        for (int u = 0; u < kProdDepth; ++u) {  // then x and the values
          const int i = i0 + u * nprod;
          if (i < cnt) {
            const float xv = __ldg(x + c[u]);
            dst[i] = vals != nullptr ? R::mul(vals[base + i], xv)
                                     : R::lone(xv);
          }
        }
      }
    }
    if (r > 0 && threadIdx.x == 0) {          // fold round r - 1 in order
      const int base = over0 + (r - 1) * slab;
      const int cnt = min(slab, end - base);
      const float* src = ring + ((r - 1) & 1) * slab;
      const float4* src4 = reinterpret_cast<const float4*>(src);
      int i = 0;
#pragma unroll 8
      for (; i + 4 <= cnt; i += 4) {
        const float4 f = src4[i >> 2];
        v = R::add(v, f.x);
        v = R::add(v, f.y);
        v = R::add(v, f.z);
        v = R::add(v, f.w);
      }
      for (; i < cnt; ++i) v = R::add(v, src[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) y[row] = v;
}

// 2. the heavy rows heavy[h0 .. h0 + 32) (fewer at the end), lane r
// owning row r: the 32 trees, then kRound overflow edges of each row a
// round
template <int SR, int C>
__device__ void spmv_heavy_warp(const int* __restrict__ offsets,
                                const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x, int nx,
                                const unsigned char* __restrict__ mask,
                                int width, int wp,
                                const int* __restrict__ heavy, int h0,
                                int nh, float* __restrict__ y,
                                float* tile) {
  using R = Ring<SR>;
  // rows whose trees load together: C leaves a lane each
  constexpr int RB = C <= 4 ? 4 : (C <= 8 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  int* s_first = reinterpret_cast<int*>(tile + 32 * kStage);
  int* s_over = s_first + 32;
  const int nrows = min(32, nh - h0);
  int row = 0, start = 0, over = 0;
  bool live = false;
  if (lane < nrows) {
    row = heavy[h0 + lane];
    start = offsets[row];
    live = mask == nullptr || mask[row];
    if (live) over = offsets[row + 1] - start - width;
    else y[row] = R::zero();
  }
  s_first[lane] = start + width;
  s_over[lane] = over;
  float mine = R::zero();
  for (int r0 = 0; r0 < nrows; r0 += RB) {    // warp-uniform
    float q[RB][C];
    bool lv[RB];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = min(r0 + b, 31);
      const int st = __shfl_sync(kFull, start, r);
      lv[b] = __shfl_sync(kFull, static_cast<int>(live), r) != 0 &&
              r0 + b < nrows;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int j = lane + 32 * i;
        float p = R::zero();
        if (lv[b] && j < width) {
          const int e = st + j;
          const float xv = __ldg(x + min(max(cols[e], 0), nx - 1));
          p = vals != nullptr ? R::mul(vals[e], xv) : R::lone(xv);
        }
        q[b][i] = p;
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
#pragma unroll
      for (int h = C / 2; h >= 1; h >>= 1) {
#pragma unroll
        for (int i = 0; i < h; ++i) q[b][i] = R::add(q[b][i], q[b][i + h]);
      }
      float v = q[b][0];
      for (int k = min(wp, 32) / 2; k >= 1; k >>= 1) {
        v = R::add(v, __shfl_down_sync(kFull, v, k));
      }
      v = __shfl_sync(kFull, v, 0);
      if (lane == r0 + b) mine = v;
    }
  }
  int longest = over;                         // masked rows count 0
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    longest = max(longest, __shfl_xor_sync(kFull, longest, off));
  }
  __syncwarp();
  const int j = lane % kRound, half = lane / kRound;
  for (int e0 = 0; e0 < longest; e0 += kRound) {
    int c[16];
    float a[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {            // rows 2u, 2u + 1: coalesced
      const int r = 2 * u + half;
      const bool ok = e0 + j < s_over[r];
      const int e = s_first[r] + e0 + j;
      c[u] = ok ? cols[e] : -1;
      a[u] = (vals != nullptr && ok) ? vals[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      float p = 0.0f;
      if (c[u] >= 0) {
        const float xv = __ldg(x + c[u]);
        p = vals != nullptr ? R::mul(a[u], xv) : R::lone(xv);
      }
      tile[(2 * u + half) * kStage + j] = p;
    }
    __syncwarp();
    const int cnt = min(kRound, over - e0);   // row `lane`, in edge order
    for (int k = 0; k < cnt; ++k) mine = R::add(mine, tile[lane * kStage + k]);
    __syncwarp();
  }
  if (live) y[row] = mine;
}

// 3. the light rows among rows [r0, r0 + 32): sorted by class into the
// warp's slots, then folded pow2(d) lanes a row
template <int SR, int C>
__device__ void spmv_light_warp(const int* __restrict__ offsets,
                                const int* __restrict__ cols,
                                const float* __restrict__ vals,
                                const float* __restrict__ x, int nx,
                                const unsigned char* __restrict__ mask,
                                int n, int width, int wp, int r0,
                                float* __restrict__ y, int* slots) {
  using R = Ring<SR>;
  const int lane = threadIdx.x & 31;
  int* s_row = slots;
  int* s_start = slots + 32;
  int* s_deg = slots + 64;
  const int row = r0 + lane;
  int cls = -1;                 // 0..5: pow2(d) = 2^cls; 6: 32 < d <= width
  int start = 0, d = 0;
  if (row < n) {
    start = offsets[row];
    d = offsets[row + 1] - start;
    if (d == 0 || (mask != nullptr && !mask[row])) {
      y[row] = R::zero();
    } else if (d <= width) {
      cls = d <= 32 ? 32 - __clz(d - 1) : 6;
    }                           // d > width: a heavy row, folded elsewhere
  }
  int cnt[7];
  int slot = 0, base = 0;
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    const unsigned b = __ballot_sync(kFull, cls == c);
    if (cls == c) slot = base + __popc(b & ((1u << lane) - 1u));
    cnt[c] = __popc(b);
    base += cnt[c];
  }
  if (cls >= 0) {
    s_row[slot] = row;
    s_start[slot] = start;
    s_deg[slot] = d;
  }
  __syncwarp();
  int off = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int g = 1 << c;                     // lanes a row
    for (int it = 0; it < cnt[c]; it += 32 >> c) {
      const int k = it + (lane >> c);
      const int j = lane & (g - 1);
      const bool have = k < cnt[c];
      float p = R::zero();
      if (have && j < s_deg[off + k]) {
        const int e = s_start[off + k] + j;
        const float xv = __ldg(x + min(max(cols[e], 0), nx - 1));
        p = vals != nullptr ? R::mul(vals[e], xv) : R::lone(xv);
      }
      float v = p;
#pragma unroll
      for (int s = g / 2; s >= 1; s >>= 1) {
        v = R::add(v, __shfl_down_sync(kFull, v, s));
      }
      if (g < wp) v = R::add(v, R::zero());
      if (have && j == 0) y[s_row[off + k]] = v;
    }
    off += cnt[c];
  }
  for (int k = off; k < off + cnt[6]; ++k) {
    const float v = tree_row<SR, C>(cols, vals, x, nx, s_start[k], s_deg[k],
                                    wp);
    if (lane == 0) y[s_row[k]] = v;
  }
}

// C = wp / 32 leaves per lane (1 when wp <= 32). Blocks [0, nvery) take
// the very heavy rows heavy[0 .. nvery), one each; the next nwarp_blocks
// the other heavy rows, 32 a warp; the rest the light rows, 32 a warp.
template <int SR, int C>
__global__ void __launch_bounds__(1024)
spmv_rows(const int* __restrict__ offsets, const int* __restrict__ cols,
          const float* __restrict__ vals, const float* __restrict__ x,
          int nx, const unsigned char* __restrict__ mask, int n, int width,
          int wp, const int* __restrict__ heavy, int nheavy, int nvery,
          int nwarp_blocks, float* __restrict__ y) {
  extern __shared__ __align__(16) float spmv_smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  int b = blockIdx.x;
  if (b < nvery) {
    spmv_block_row<SR, C>(offsets, cols, vals, x, nx, mask, width, wp,
                          heavy[b], y, spmv_smem);
    return;
  }
  b -= nvery;
  float* mine = spmv_smem + warp * (kSpmvWarpSmem / 4);
  if (b < nwarp_blocks) {
    const long long h0 = nvery + (static_cast<long long>(b) * warps + warp)
                                 * 32;
    if (h0 < nheavy) {
      spmv_heavy_warp<SR, C>(offsets, cols, vals, x, nx, mask, width, wp,
                             heavy, static_cast<int>(h0), nheavy, y, mine);
    }
    return;
  }
  const long long r0 =
      (static_cast<long long>(b - nwarp_blocks) * warps + warp) * 32;
  if (r0 < n) {
    spmv_light_warp<SR, C>(offsets, cols, vals, x, nx, mask, n, width, wp,
                           static_cast<int>(r0), y,
                           reinterpret_cast<int*>(mine));
  }
}

template <int SR, int C>
int launch_c(const int* offsets, const int* cols, const float* vals,
             const float* x, int nx, const unsigned char* mask, int n,
             int width, int wp, const int* heavy, int nheavy, int nvery,
             float* y, int threads, cudaStream_t st) {
  static bool raised = false;   // the shared-memory limit, once a kernel
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmv_rows<SR, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        32 * kSpmvWarpSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int warps = threads / 32;
  const long long heavy_warps = (nheavy - nvery + 31) / 32;
  const long long nwarp_blocks = (heavy_warps + warps - 1) / warps;
  const long long grid = nvery + nwarp_blocks + (n + threads - 1) / threads;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  spmv_rows<SR, C><<<static_cast<int>(grid), threads, warps * kSpmvWarpSmem,
                     st>>>(offsets, cols, vals, x, nx, mask, n, width, wp,
                           heavy, nheavy, nvery,
                           static_cast<int>(nwarp_blocks), y);
  return static_cast<int>(cudaGetLastError());
}

template <int SR>
int launch(int c, const int* offsets, const int* cols, const float* vals,
           const float* x, int nx, const unsigned char* mask, int n,
           int width, int wp, const int* heavy, int nheavy, int nvery,
           float* y, int threads, cudaStream_t st) {
#define REPRO_SPMV_CASE(CC)                                               \
  case CC:                                                                \
    return launch_c<SR, CC>(offsets, cols, vals, x, nx, mask, n, width,  \
                            wp, heavy, nheavy, nvery, y, threads, st);
  switch (c) {
    REPRO_SPMV_CASE(1)
    REPRO_SPMV_CASE(2)
    REPRO_SPMV_CASE(4)
    REPRO_SPMV_CASE(8)
    REPRO_SPMV_CASE(16)
    REPRO_SPMV_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMV_CASE
}

// the fold's starting value: the (+)-identity, but -inf for or_and's max
// (segment_max covers a row's own products only)
template <int SR>
__device__ __forceinline__ float fold_init() {
  return SR == kOrAnd ? __int_as_float(0xff800000) : Ring<SR>::zero();
}

// rows longer than this are split over the block's warps
constexpr int kHeavy = 1024;

// One warp's fold of column c over the edges [start, end) of one row:
// lanes split into 32 / KP edge groups x KP columns, group g takes edges
// g, g + G, ... of each 32-edge chunk in ascending order, then the groups
// merge by a fixed shuffle tree. The result is valid in group 0's lanes.
// KP = columns per edge group (a power of two, at most 32).
template <int SR, int KP>
__device__ __forceinline__ float fold_range(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, int nx, int k, int c, bool col_ok,
    int start, int end) {
  using R = Ring<SR>;
  constexpr int G = 32 / KP;                  // edge groups per warp
  const int lane = threadIdx.x & 31;
  const int g = lane / KP;
  float v = fold_init<SR>();
  // lane l holds edge e0 + l of the current chunk; the next chunk's
  // column and value are loaded before this one's X rows, so the column
  // load's latency overlaps the gathers
  int nxt_col = 0;
  float nxt_val = 0.0f;
  if (start + lane < end) {
    nxt_col = cols[start + lane];
    if (vals != nullptr) nxt_val = vals[start + lane];
  }
  for (int e0 = start; e0 < end; e0 += 32) {
    const int cnt = min(32, end - e0);
    const int my_col = min(max(nxt_col, 0), nx - 1);
    const float my_val = nxt_val;
    if (e0 + 32 + lane < end) {
      nxt_col = cols[e0 + 32 + lane];
      if (vals != nullptr) nxt_val = vals[e0 + 32 + lane];
    }
    float p[KP];
#pragma unroll
    for (int t = 0; t < KP; ++t) {            // independent loads first
      const int j = t * G + g;
      const int col = __shfl_sync(kFull, my_col, j);
      const float a = __shfl_sync(kFull, my_val, j);
      const float xv = (j < cnt && col_ok) ? x[col * k + c] : 0.0f;
      p[t] = vals != nullptr ? R::mul(a, xv) : R::lone(xv);
    }
#pragma unroll
    for (int t = 0; t < KP; ++t) {            // then the ordered fold
      if (t * G + g < cnt) v = R::add(v, p[t]);
    }
  }
  // merge the groups: lane l takes lane l + off, a fixed tree
#pragma unroll
  for (int off = 16; off >= KP; off >>= 1) {
    v = R::add(v, __shfl_down_sync(kFull, v, off));
  }
  return v;
}

// Warp w of the grid owns (row, 32-column chunk) w. A row of at most
// kHeavy edges is folded by its warp alone; a longer one by all the
// block's warps, each over one contiguous share of the row, the shares'
// partials then folded in warp order through shared memory.
template <int SR, int KP>
__global__ void spmm_rows(const int* __restrict__ offsets,
                          const int* __restrict__ cols,
                          const float* __restrict__ vals,
                          const float* __restrict__ x, int nx, int k,
                          const unsigned char* __restrict__ mask, int n,
                          int nchunk, float* __restrict__ y) {
  using R = Ring<SR>;
  __shared__ int heavy_row[kWarps];           // -1 = none
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / KP;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const bool have = w < static_cast<long long>(n) * nchunk;
  const int row = have ? static_cast<int>(w / nchunk) : 0;
  const int c = (have ? static_cast<int>(w % nchunk) : 0) * 32 + lane % KP;
  const bool col_ok = c < k;
  int start = 0, end = 0;
  bool live = false;
  if (have) {                                 // warp-uniform
    start = offsets[row];
    end = offsets[row + 1];
    live = end > start && (mask == nullptr || mask[row]);
  }
  const bool heavy = live && end - start > kHeavy;
  if (lane == 0) heavy_row[warp] = heavy ? row : -1;
  if (have && !heavy) {
    float v = R::zero();
    if (live) v = fold_range<SR, KP>(cols, vals, x, nx, k, c, col_ok, start,
                                     end);
    if (g == 0 && col_ok) y[row * k + c] = v;
  }
  __syncthreads();
  for (int h = 0; h < kWarps; ++h) {          // block-uniform loop
    const int hrow = heavy_row[h];
    if (hrow < 0) continue;
    const long long wh = static_cast<long long>(blockIdx.x) * kWarps + h;
    const int hc = static_cast<int>(wh % nchunk) * 32 + lane % KP;
    const int hs = offsets[hrow], he = offsets[hrow + 1];
    const int share = (he - hs + kWarps * 32 - 1) / (kWarps * 32) * 32;
    const int s0 = min(hs + warp * share, he);
    const float pv = fold_range<SR, KP>(cols, vals, x, nx, k, hc, hc < k,
                                        s0, min(s0 + share, he));
    if (g == 0) part[warp][lane] = pv;
    __syncthreads();
    if (warp == h && g == 0 && hc < k) {
      float t = part[0][lane];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) t = R::add(t, part[q][lane]);
      y[hrow * k + hc] = t;
    }
    __syncthreads();
  }
}

template <int SR>
int launch_mm(const int* offsets, const int* cols, const float* vals,
              const float* x, int nx, int k, const unsigned char* mask,
              int n, float* y, cudaStream_t st) {
  int kp = 1;
  while (kp < k && kp < 32) kp *= 2;
  const int nchunk = (k + 31) / 32;
  const long long warps = static_cast<long long>(n) * nchunk;
  const int grid = static_cast<int>((warps + kWarps - 1) / kWarps);
#define REPRO_SPMM_CASE(KK)                                               \
  case KK:                                                                \
    spmm_rows<SR, KK><<<grid, kThreads, 0, st>>>(offsets, cols, vals, x,  \
                                                 nx, k, mask, n, nchunk,  \
                                                 y);                      \
    break;
  switch (kp) {
    REPRO_SPMM_CASE(1)
    REPRO_SPMM_CASE(2)
    REPRO_SPMM_CASE(4)
    REPRO_SPMM_CASE(8)
    REPRO_SPMM_CASE(16)
    REPRO_SPMM_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMM_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT int spmm(int semiring, const int* offsets, const int* cols,
                const float* vals, const float* x, int nx, int k,
                const unsigned char* mask, int n, float* y, void* stream) {
  if (n == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case kPlusTimes:
      return launch_mm<kPlusTimes>(offsets, cols, vals, x, nx, k, mask, n,
                                   y, st);
    case kMinPlus:
      return launch_mm<kMinPlus>(offsets, cols, vals, x, nx, k, mask, n, y,
                                 st);
    case kOrAnd:
      return launch_mm<kOrAnd>(offsets, cols, vals, x, nx, k, mask, n, y,
                               st);
    case kMaxMin:
      return launch_mm<kMaxMin>(offsets, cols, vals, x, nx, k, mask, n, y,
                                st);
    case kPlusAnd:
      return launch_mm<kPlusAnd>(offsets, cols, vals, x, nx, k, mask, n, y,
                                 st);
    case kPlusTimesBf16:
      return launch_mm<kPlusTimesBf16>(offsets, cols, vals, x, nx, k, mask,
                                       n, y, st);
    case kPlusAndBf16:
      return launch_mm<kPlusAndBf16>(offsets, cols, vals, x, nx, k, mask, n,
                                     y, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

EXPORT int spmv(int semiring, const int* offsets, const int* cols,
                const float* vals, const float* x, int nx,
                const unsigned char* mask, int n, int width,
                const int* heavy, int nheavy, int nvery, float* y,
                int threads, void* stream) {
  if (!valid_threads(threads) || nvery < 0 || nvery > nheavy) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int wp = 1;
  while (wp < width) wp *= 2;
  const int c = wp > 32 ? wp / 32 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SPMV_SR(SR)                                                 \
  case SR:                                                                \
    return launch<SR>(c, offsets, cols, vals, x, nx, mask, n, width, wp,  \
                      heavy, nheavy, nvery, y, threads, st);
  switch (semiring) {
    REPRO_SPMV_SR(kPlusTimes)
    REPRO_SPMV_SR(kMinPlus)
    REPRO_SPMV_SR(kOrAnd)
    REPRO_SPMV_SR(kMaxMin)
    REPRO_SPMV_SR(kPlusAnd)
    REPRO_SPMV_SR(kPlusTimesBf16)
    REPRO_SPMV_SR(kPlusAndBf16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMV_SR
}
