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
// vals[e] (x) X[cols[e], c], X row-major, the (+)-identity on empty and
// masked-out rows. Reach runs it with or_and at k = B sources, label
// propagation with plus_times at k = 32 one-hot label columns.
//  * A group of L lanes folds one (row, 32-column chunk), a lane 4
//    consecutive columns: L = pow2(ceil(min(k, 32) / 4)), at most 8, so
//    a warp folds 32 / L rows at once (4 at k >= 17, 32 at k <= 4) and
//    no lane walks empty slots of a short row. Where k is a multiple of
//    4 and X is 16-byte aligned, a lane gathers its 4 columns as one
//    16-byte load, and 8 lanes read one 128-byte line of X per edge.
//  * A lane walks its row's edges kMmDepth at a time: the batch's
//    column ids were loaded during the previous batch, its kMmDepth rows
//    of X are gathered at once, then folded in edge order. Each column is
//    folded in ascending edge order from the fold's identity (0 for plus,
//    as the reference's segment_sum starts there; -inf for or_and's max,
//    so a row's result is the max of its own products, as segment_max
//    gives it): the order of the reference's _spmm_xla and of the plain
//    version on the CPU (index_add_), so every row that one group folds
//    alone is bit-equal to it, at every k.
//  * Long rows first: the wrapper lists the rows of more than SPMM_LONG
//    edges by degree, largest first, once per graph (kernels/ops.py,
//    heavy_rows). The first blocks take the rows of more than SPMM_SPLIT
//    edges, one (row, chunk) a block: its G = kThreads / L groups each
//    fold one contiguous share of ceil(d / G) edges, and the block's
//    first L threads merge the G partials in share order through shared
//    memory. The next blocks fold the other listed rows, one group each,
//    consecutive in the list (so a warp's rows are of similar length);
//    the rest fold the rows of at most SPMM_LONG edges in row order. Only
//    a split row's block synchronises, and only with itself.
//  * Indices are int32: the wrapper refuses n*k or nx*k past 2^31.
//  * Blocks are always kThreads = 256 threads: a split row's share count
//    is G, so another block size would change its float sums. spmm has no
//    tuner probe.
// Bound by bytes: per edge a 4-byte column (plus 4 of value) and k*4
// bytes of X gathered (through L2 where X fits its 50 MB: at label
// propagation's shape X is 8.4 MB and the gathers 233 MB of 128-byte
// lines, the practical floor), per row 4 of offsets, 1 of mask and k*4
// of output.

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
// store and widens bfloat16 values once per graph. K4m rounds each
// operand once: under the bf16 codes the wrapper passes the values
// rounded to bfloat16 (once per graph, not once per lane that shares an
// edge), and a lane rounds its 4 gathered entries of X in two packed
// conversions (cvt.rn.bf16x2.f32) and widens them with a shift, so the
// inner loop converts only X and the product. (A bfloat16 copy of X made
// by the wrapper gathered 64-byte rows and measured slower than this on
// the fp32 X's 128-byte lines.)
#include <cuda_bf16.h>

#include <cstdint>

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

constexpr int kMmDepth = 8;   // edges a lane gathers before it folds them

// four floats rounded to bfloat16 (to nearest even) and widened back, in
// two packed conversions
__device__ __forceinline__ float4 bf16_round4(float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  const unsigned a = *reinterpret_cast<const unsigned*>(&lo);
  const unsigned b = *reinterpret_cast<const unsigned*>(&hi);
  return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}

// K4m's operands (see Precision): prep rounds a lane's 4 gathered
// entries of X under the bf16 codes; mul is the (x) of a value that
// arrives rounded and a prepped x; a structural product is the prepped x
// itself
template <int SR>
struct MmOps {
  static __device__ float4 prep(float4 x) { return x; }
  static __device__ float mul(float a, float x) { return Ring<SR>::mul(a, x); }
};
template <>
struct MmOps<kPlusTimesBf16> {
  static __device__ float4 prep(float4 x) { return bf16_round4(x); }
  static __device__ float mul(float a, float x) {
    return bf16_round(__fmul_rn(a, x));
  }
};
template <>
struct MmOps<kPlusAndBf16> {
  static __device__ float4 prep(float4 x) { return bf16_round4(x); }
  static __device__ float mul(float a, float x) { return fminf(a, x); }
};

// four consecutive entries of a row of X: one vector load when V4 (k a
// multiple of 4, X 16-byte aligned), else up to `live` scalar loads (0
// past them)
template <bool V4>
__device__ __forceinline__ float4 load_x4(const float* __restrict__ p,
                                          int live) {
  if (V4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live > 0) r.x = __ldg(p);
  if (live > 1) r.y = __ldg(p + 1);
  if (live > 2) r.z = __ldg(p + 2);
  if (live > 3) r.w = __ldg(p + 3);
  return r;
}
template <int SR>
__device__ __forceinline__ float4 add4(float4 v, float4 p) {
  using R = Ring<SR>;
  return make_float4(R::add(v.x, p.x), R::add(v.y, p.y), R::add(v.z, p.z),
                     R::add(v.w, p.w));
}

// The fold of columns c0 .. c0 + 3 (those below k) over the edges
// [s, e) of one row, each column in ascending edge order from
// fold_init. The lane loads kMmDepth column ids a batch (the next
// batch's while this one's rows of X are in flight), gathers the batch's
// rows of X, then folds them in order.
template <int SR, bool V4>
__device__ __forceinline__ float4 fold_edges(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, int nx, int k, int c0,
    int s, int e) {
  using M = MmOps<SR>;
  const float z = fold_init<SR>();
  float4 v = make_float4(z, z, z, z);
  const int live = k - c0;
  int c[kMmDepth];
#pragma unroll
  for (int u = 0; u < kMmDepth; ++u) {
    c[u] = s + u < e ? min(max(__ldg(cols + s + u), 0), nx - 1) : -1;
  }
  for (int e0 = s; e0 < e; e0 += kMmDepth) {
    float4 xv[kMmDepth];
    float a[kMmDepth];
#pragma unroll
    for (int u = 0; u < kMmDepth; ++u) {      // the batch's gathers
      xv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      a[u] = 0.0f;
      if (c[u] >= 0) {
        xv[u] = load_x4<V4>(x + static_cast<long long>(c[u]) * k + c0, live);
        if (vals != nullptr) a[u] = __ldg(vals + e0 + u);
      }
    }
    const int nxt = e0 + kMmDepth;
#pragma unroll
    for (int u = 0; u < kMmDepth; ++u) {      // the next batch's ids
      c[u] = nxt + u < e ? min(max(__ldg(cols + nxt + u), 0), nx - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kMmDepth; ++u) {      // then the ordered fold
      if (e0 + u < e) {
        float4 p = M::prep(xv[u]);
        if (vals != nullptr) {
          p = make_float4(M::mul(a[u], p.x), M::mul(a[u], p.y),
                          M::mul(a[u], p.z), M::mul(a[u], p.w));
        }
        v = add4<SR>(v, p);
      }
    }
  }
  return v;
}

template <bool V4>
__device__ __forceinline__ void store_y4(float* __restrict__ p, float4 v,
                                         int live) {
  if (V4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (live > 0) p[0] = v.x;
  if (live > 1) p[1] = v.y;
  if (live > 2) p[2] = v.z;
  if (live > 3) p[3] = v.w;
}

// Blocks [0, nsplit * nchunk): the split rows long_rows[0 .. nsplit),
// one (row, chunk) a block; the next ceil((nlong - nsplit) * nchunk / G)
// blocks the other listed rows, one (row, chunk) a group; the rest every
// row of at most `tlong` edges, one (row, chunk) a group, in row order.
// L lanes a group, G = kThreads / L groups a block.
template <int SR, bool V4>
__global__ void __launch_bounds__(kThreads)
spmm_rows(const int* __restrict__ offsets, const int* __restrict__ cols,
          const float* __restrict__ vals,
          const float* __restrict__ x, int nx, int k,
          const unsigned char* __restrict__ mask, int n, int nchunk, int L,
          const int* __restrict__ long_rows, int nlong, int nsplit,
          int tlong, float* __restrict__ y) {
  using R = Ring<SR>;
  __shared__ float4 part[kThreads];
  const int groups = kThreads / L;
  const int g = threadIdx.x / L, sub = threadIdx.x % L;
  const float zr = R::zero();
  const float4 zero4 = make_float4(zr, zr, zr, zr);
  long long b = blockIdx.x;
  const long long split_blocks = static_cast<long long>(nsplit) * nchunk;
  if (b < split_blocks) {                     // block-uniform
    const int row = long_rows[b / nchunk];
    const int c0 = static_cast<int>(b % nchunk) * 32 + sub * 4;
    float* yr = y + static_cast<long long>(row) * k + c0;
    if (mask != nullptr && !mask[row]) {
      if (g == 0 && c0 < k) store_y4<V4>(yr, zero4, k - c0);
      return;
    }
    const int s = offsets[row], e = offsets[row + 1];
    const int len = (e - s + groups - 1) / groups;
    const int s0 = min(s + g * len, e);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c0 < k) {
      v = fold_edges<SR, V4>(cols, vals, x, nx, k, c0, s0, min(s0 + len, e));
    }
    part[threadIdx.x] = v;
    __syncthreads();
    if (g == 0 && c0 < k) {                   // the shares in order
      float4 t = part[sub];
      for (int q = 1; q < groups; ++q) t = add4<SR>(t, part[q * L + sub]);
      store_y4<V4>(yr, t, k - c0);
    }
    return;
  }
  b -= split_blocks;
  const long long listed = static_cast<long long>(nlong - nsplit) * nchunk;
  const long long listed_blocks = (listed + groups - 1) / groups;
  long long item;
  int row;
  bool light = false;
  if (b < listed_blocks) {
    item = b * groups + g;
    if (item >= listed) return;
    row = long_rows[nsplit + item / nchunk];
  } else {
    item = (b - listed_blocks) * groups + g;
    if (item >= static_cast<long long>(n) * nchunk) return;
    row = static_cast<int>(item / nchunk);
    light = true;
  }
  const int c0 = static_cast<int>(item % nchunk) * 32 + sub * 4;
  if (c0 >= k) return;
  const int s = offsets[row], e = offsets[row + 1];
  if (light && e - s > tlong) return;         // a listed row, folded above
  float4 v = zero4;
  if (e > s && (mask == nullptr || mask[row])) {
    v = fold_edges<SR, V4>(cols, vals, x, nx, k, c0, s, e);
  }
  store_y4<V4>(y + static_cast<long long>(row) * k + c0, v, k - c0);
}

template <int SR>
int launch_mm(const int* offsets, const int* cols, const float* vals,
              const float* x, int nx, int k, const unsigned char* mask,
              int n, const int* long_rows, int nlong, int nsplit, int tlong,
              float* y, cudaStream_t st) {
  int L = 1;
  while (L * 4 < min(k, 32)) L *= 2;
  const int groups = kThreads / L;
  const int nchunk = (k + 31) / 32;
  const long long blocks =
      static_cast<long long>(nsplit) * nchunk +
      ((static_cast<long long>(nlong - nsplit) * nchunk + groups - 1) /
       groups) +
      (static_cast<long long>(n) * nchunk + groups - 1) / groups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool v4 = k % 4 == 0 &&
                  reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  if (v4) {
    spmm_rows<SR, true><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        offsets, cols, vals, x, nx, k, mask, n, nchunk, L, long_rows, nlong,
        nsplit, tlong, y);
  } else {
    spmm_rows<SR, false><<<static_cast<int>(blocks), kThreads, 0, st>>>(
        offsets, cols, vals, x, nx, k, mask, n, nchunk, L, long_rows, nlong,
        nsplit, tlong, y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (nx, k) and y: (n, k) fp32, row-major; long_rows: the rows of more
// than tlong edges by degree, largest first, the first nsplit of them
// split over a block.
EXPORT int spmm(int semiring, const int* offsets, const int* cols,
                const float* vals, const float* x, int nx, int k,
                const unsigned char* mask, int n, const int* long_rows,
                int nlong, int nsplit, int tlong, float* y, void* stream) {
  if (nsplit < 0 || nsplit > nlong) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || k == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SPMM_SR(SR)                                                 \
  case SR:                                                                \
    return launch_mm<SR>(offsets, cols, vals, x, nx, k, mask, n,         \
                         long_rows, nlong, nsplit, tlong, y, st);
  switch (semiring) {
    REPRO_SPMM_SR(kPlusTimes)
    REPRO_SPMM_SR(kMinPlus)
    REPRO_SPMM_SR(kOrAnd)
    REPRO_SPMM_SR(kMaxMin)
    REPRO_SPMM_SR(kPlusAnd)
    REPRO_SPMM_SR(kPlusTimesBf16)
    REPRO_SPMM_SR(kPlusAndBf16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SPMM_SR
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
