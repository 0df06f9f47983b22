// Single-head fused attention with an online softmax (K7) on Hopper's
// tensor cores, and the combine pass of its split-kv form.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention.py:74): o = softmax(q k^T / sqrt(D))
// v for q (Sq, D) and k, v (Sk, D), fp32, bf16 or fp16, with the causal
// mask aligned to the ends (query i sees keys j <= i + Sk - Sq). Scores,
// softmax statistics and the accumulator are fp32, as in the reference;
// the output is rounded to q's type once, at the end.
//
// The Pallas kernel runs a (q tiles, kv tiles) grid whose kv axis goes in
// order, carrying the running max m, normaliser l and accumulator acc
// across grid steps in VMEM. Here a block of 4 warps owns a 64-query tile
// (16 rows a warp) and walks a range of kv tiles in a loop; K and V tiles
// are double-buffered in shared memory by cp.async, the next tile in
// flight while the block works on this one. Per kv tile and warp:
//   1. S = Q K^T on the tensor cores, fp32 accumulation (mma.sync):
//      bf16 and fp16 run m16n8k16 in the input type, fragments by
//      ldmatrix (products of 16-bit values are exact in fp32, so only the
//      order of the sums differs from the reference's fp32 dot); fp32
//      runs 3xTF32 (m16n8k8): each operand a = hi + lo, hi rounded to
//      tf32 and lo the rest, and S += lo_a hi_b + hi_a lo_b + hi_a hi_b,
//      about 21 bits;
//   2. the reference's update on the S fragments, in registers: s = dot *
//      scale, -1e30 where masked, m' = max(m, max s) over the row (a quad
//      of lanes shares a row), alpha = exp(m - m'), p = exp(s - m') and 0
//      where masked, l' = alpha l + sum p;
//   3. acc = alpha acc + P V on the tensor cores. P is fp32 as in the
//      reference: in bf16 / fp16 it is split into p_hi = rn(p) and p_lo =
//      rn(p - p_hi) of the input type and both pieces multiply V (two
//      MMAs, about 16 bits of p; fp16 scales p by 2^12 first so that the
//      low piece of a small p stays normal, and the result by 2^-12, both
//      exact); fp32 runs 3xTF32 again. The S fragments are the A
//      fragments of P V without a trip through shared memory (fp32 takes
//      a tile's keys in the order 2t, 2t+1 of each 8, which only reorders
//      the sum).
// Head widths that are multiples of 8 run in a tile of D' = 32, 64, 128
// or 256 columns whose padding is zero in shared memory.
//
// Balanced work: the q tiles go longest first (block 0 takes the last
// tile, which sees the most keys under the causal mask), and the wrapper
// splits each q tile's kv range into `nsplit` parts of whole tiles when
// the q tiles alone cannot fill the card about twice over (a 128-query
// chunk against 8192 keys has 2 q tiles). With nsplit = 1 the block
// writes o = acc / max(l, 1e-30); with nsplit > 1 it writes its (m, l,
// acc) in fp32 to the wrapper's workspace, and attn_combine (K7c, below)
// merges the parts: M = max m_s, w_s = exp(m_s - M), o = sum w_s acc_s /
// max(sum w_s l_s, 1e-30). A part that sees no key carries m = -1e30, l =
// 0, acc = 0. flash_attention_split launches the two back to back, the
// combine as a programmatic dependent launch.
// The finite -1e30 and the clamp are the reference's
// (flash_attention.py:25, :68): a row that sees no key comes out exactly
// 0, where -inf would give NaN. Kv tiles wholly past a q tile's last
// visible key are not visited: in the reference they leave m, l and acc
// as they were.
//
// Bound: 4 Sq Sk D operations (about half under the causal mask) at the
// tensor cores' rate for the input type; the fp32 form issues three TF32
// products for each (1/3 of 495 TFLOP/s), the 16-bit form two for P V;
// or q, k, v and o moved once, whichever is longer.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;               // queries per block, 16 a warp
constexpr int kAttnThreads = 128;     // 4 warps
constexpr float kNegBig = -1e30f;     // the reference's NEG_INF
constexpr float kP16Scale = 4096.0f;  // fp16's p scale, 2^12

// kv tile: 64 keys for 16-bit inputs, 32 for fp32 (its tiles are twice
// the bytes; 32 keeps two blocks on an SM at D' = 128)
template <typename T>
__host__ __device__ constexpr int kv_tile() {
  return std::is_same<T, float>::value ? 32 : 64;
}

// shared-memory row stride in elements: 16 bytes of padding, so the
// ldmatrix rows (16-bit) and the fragment loads (fp32) hit distinct banks
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + 4 * kv_tile<T>()) * row_stride<T, DP>() *
         sizeof(T);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D += A B, m16n8k16, 16-bit inputs, fp32 accumulation
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// D += A B, m16n8k8, tf32 inputs, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to tf32, lo = x - hi exactly in fp32, of
// which the tensor cores read the top 19 bits (a tf32 truncation, an
// error of at most 2^-10 |lo| <= 2^-21 |x|)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// (x, y) -> one register of two 16-bit values, x in the low half; the
// rounding residues into lo
template <typename T>
__device__ __forceinline__ unsigned pack_split(float x, float y,
                                               unsigned& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(
        x - __bfloat162float(h.x), y - __bfloat162float(h.y));
    lo = *reinterpret_cast<const unsigned*>(&l);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x, y);
    const __half2 l = __floats2half2_rn(x - __low2float(h),
                                        y - __high2float(h));
    lo = *reinterpret_cast<const unsigned*>(&l);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
}

// rows [r0, r0 + rows) of a (n, d) matrix into a shared tile of stride S,
// 16-byte copies, zero past row n
template <typename T, int S>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int n, int d, int r0, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = d / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kAttnThreads) {
    const int r = i / per_row, c = (i - r * per_row) * kVec;
    const int g = r0 + r;
    const bool ok = g < n;
    cp_async16(dst + r * S + c,
               src + (static_cast<size_t>(ok ? g : 0) * d + c), ok);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kAttnThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o,
            float* __restrict__ ws_acc, float* __restrict__ ws_ml, int sq,
            int sk, int d, float scale, int causal, int nsplit) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  constexpr int BK = kv_tile<T>();
  constexpr int S = row_stride<T, DP>();
  constexpr int NS = BK / 8;            // S fragments (8 keys each)
  constexpr int ND = DP / 8;            // accumulator fragments (8 cols)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK[2] = {sQ + kBQ * S, sQ + (kBQ + 2 * BK) * S};
  T* sV[2] = {sQ + (kBQ + BK) * S, sQ + (kBQ + 3 * BK) * S};

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / nsplit;
  const int split = static_cast<int>(blockIdx.x) % nsplit;
  const int q0 = qt * kBQ;
  const int shift = sk - sq;            // query i sees keys j <= i + shift
  int kend = sk;
  if (causal) kend = max(0, min(sk, min(q0 + kBQ, sq) + shift));
  const int ntile = (kend + BK - 1) / BK;
  const int per = (ntile + nsplit - 1) / nsplit;
  const int t0 = min(split * per, ntile);
  const int t1 = min(t0 + per, ntile);

  // the padding columns [d, DP) of every tile are zero
  if (d < DP) {
    const int pad = DP - d;
    for (int i = tid; i < (kBQ + 4 * BK) * pad; i += kAttnThreads) {
      const int r = i / pad;
      sQ[r * S + d + (i - r * pad)] = T(0.0f);
    }
  }
  load_rows<T, S>(sQ, q, sq, d, q0, kBQ);
  if (t0 < t1) {
    load_rows<T, S>(sK[0], k, sk, d, t0 * BK, BK);
    load_rows<T, S>(sV[0], v, sk, d, t0 * BK, BK);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g;    // this thread's two rows
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.0f, 0.0f};            // this thread's part of l
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) & 1;
    if (tile + 1 < t1) {
      load_rows<T, S>(sK[cur ^ 1], k, sk, d, (tile + 1) * BK, BK);
      load_rows<T, S>(sV[cur ^ 1], v, sk, d, (tile + 1) * BK, BK);
    }
    cp_async_commit();
    cp_async_wait_1();                      // this tile (and Q) landed
    __syncthreads();
    const T* cK = sK[cur];
    const T* cV = sV[cur];
    const int k0 = tile * BK;

    // 1. S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    if constexpr (kF32) {
      const T* qa = sQ + (warp * 16 + g) * S + t;
#pragma unroll 4
      for (int kk = 0; kk < DP / 8; ++kk) {
        unsigned ahi[4], alo[4];
        split_tf32(qa[8 * kk], ahi[0], alo[0]);
        split_tf32(qa[8 * S + 8 * kk], ahi[1], alo[1]);
        split_tf32(qa[8 * kk + 4], ahi[2], alo[2]);
        split_tf32(qa[8 * S + 8 * kk + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const T* kb = cK + (8 * j + g) * S + 8 * kk + t;
          unsigned bhi0, blo0, bhi1, blo1;
          split_tf32(kb[0], bhi0, blo0);
          split_tf32(kb[4], bhi1, blo1);
          mma_tf32(s[j], alo, bhi0, bhi1);
          mma_tf32(s[j], ahi, blo0, blo1);
          mma_tf32(s[j], ahi, bhi0, bhi1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * S + 16 * kk +
                       8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          unsigned b[4];
          ldsm_x4(b, cK + (16 * np + (lane & 7) + 8 * (lane >> 4)) * S +
                         16 * kk + 8 * ((lane >> 3) & 1));
          mma16<T>(s[2 * np], a, b[0], b[1]);
          mma16<T>(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // 2. the online-softmax update; element e of fragment j is row
    // row_lo + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)
    // (a tile that all 16 of the warp's rows see whole needs no mask)
    unsigned ok = ~0u;
    if (k0 + BK > sk ||
        (causal && k0 + BK - 1 > q0 + warp * 16 + shift)) {
      ok = 0;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = row_lo + 8 * (e >> 1);
          const bool vis = key < sk && (!causal || key <= row + shift);
          ok |= static_cast<unsigned>(vis) << (4 * j + e);
        }
      }
    }
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * scale : kNegBig;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_cur = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_cur);
      m_run[r] = m_cur;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * j + e)) & 1u
                            ? expf(s[j][e] - m_run[e >> 1]) : 0.0f;
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + sum[r];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // 3. acc += P V
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        unsigned phi[4], plo[4];
        split_tf32(s[j][0], phi[0], plo[0]);   // (row g, key 2t)
        split_tf32(s[j][2], phi[1], plo[1]);   // (row g + 8, key 2t)
        split_tf32(s[j][1], phi[2], plo[2]);   // (row g, key 2t + 1)
        split_tf32(s[j][3], phi[3], plo[3]);   // (row g + 8, key 2t + 1)
        const T* vb = cV + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int i = 0; i < ND; ++i) {
          unsigned bhi0, blo0, bhi1, blo1;
          split_tf32(vb[8 * i], bhi0, blo0);
          split_tf32(vb[S + 8 * i], bhi1, blo1);
          mma_tf32(acc[i], plo, bhi0, bhi1);
          mma_tf32(acc[i], phi, blo0, blo1);
          mma_tf32(acc[i], phi, bhi0, bhi1);
        }
      }
    } else {
      const float ps = kF16 ? kP16Scale : 1.0f;
#pragma unroll
      for (int kc = 0; kc < NS / 2; ++kc) {
        unsigned phi[4], plo[4];
        phi[0] = pack_split<T>(s[2 * kc][0] * ps, s[2 * kc][1] * ps, plo[0]);
        phi[1] = pack_split<T>(s[2 * kc][2] * ps, s[2 * kc][3] * ps, plo[1]);
        phi[2] = pack_split<T>(s[2 * kc + 1][0] * ps, s[2 * kc + 1][1] * ps,
                               plo[2]);
        phi[3] = pack_split<T>(s[2 * kc + 1][2] * ps, s[2 * kc + 1][3] * ps,
                               plo[3]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          unsigned b[4];
          ldsm_x4_t(b, cV + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                S + 16 * dp + 8 * (lane >> 4));
          mma16<T>(acc[2 * dp], plo, b[0], b[1]);
          mma16<T>(acc[2 * dp], phi, b[0], b[1]);
          mma16<T>(acc[2 * dp + 1], plo, b[2], b[3]);
          mma16<T>(acc[2 * dp + 1], phi, b[2], b[3]);
        }
      }
    }
    __syncthreads();                        // the buffer may be refilled
  }
  cp_async_wait_all();                      // nothing left in flight
  // the combine (a programmatic dependent launch) may be scheduled now;
  // it waits for this grid's completion before it reads the parts
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the row's l is the sum over its quad of lanes
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r] + __shfl_xor_sync(kFull, l_run[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  const float unscale = kF16 ? 1.0f / kP16Scale : 1.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= sq) continue;
    if (nsplit == 1) {
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = o + static_cast<size_t>(row) * d;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int c = 8 * i + 2 * t;
        if (c < d) {
          store2<T>(orow + c, acc[i][2 * r] * unscale / den,
                    acc[i][2 * r + 1] * unscale / den);
        }
      }
    } else {
      const size_t at = static_cast<size_t>(split) * sq + row;
      float* arow = ws_acc + at * d;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int c = 8 * i + 2 * t;
        if (c < d) {
          store2<float>(arow + c, acc[i][2 * r] * unscale,
                        acc[i][2 * r + 1] * unscale);
        }
      }
      if (t == 0) {
        ws_ml[2 * at] = m_run[r];
        ws_ml[2 * at + 1] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7c, the combine of the split form's parts: o[row] = sum_s w_s acc_s[row]
// / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max_s m_s), rounded once to
// the output type. It is the reference's carry of (m, l, acc) across its
// kv grid axis (flash_attention.py:49-69), which blocks running in no
// order cannot carry, so it is a second pass over the parts.
//
// Bound: the parts (nsplit (Sq, D) fp32 sums and (m, l) pairs) read once
// and o written once, at the memory's rate; K7 has just written the parts,
// so at the chunk's 4.2 MB they are read from L2. At that size the floor
// is one launch and one round trip to L2, a few microseconds: the design
// spreads the work so that no warp makes more than a few such trips.
//   * G warps a row, the fewest of 1, 2, 4, 8 whose first 8 loads a lane
//     cover every part (G = 8 from 33 parts on), in blocks of 8 warps (8 /
//     G rows a block) and 32 V columns (V = 4, a float4 a lane; V = 2
//     where D % 4 != 0): the chunk's 128 rows of 64 parts make 128 blocks,
//     prefill's 8192 rows of 3 parts 1024;
//   * part s goes to warp s mod G of its row, each lane summing its column
//     vector of its warp's parts in increasing s, 8 parts' loads in
//     flight; the first 8 are issued before the weights are made, so the
//     two trips to L2 overlap;
//   * the weights are made once a row: the max of m by the row's 32 G
//     threads, then thread t of the row makes w_s for s = t mod 32 G into
//     shared memory (chunks of 256 G parts) and sums its w_s l_s in
//     increasing s, the denominator a butterfly over the warp's lanes and
//     then the row's warps in order;
//   * the row's warps' partial sums are merged in shared memory in warp
//     order.
// Every sum has one fixed order for a given nsplit: the result does not
// depend on the order the blocks run in, and repeated calls are bit-equal
// (no atomics).
//
// A part that sees no key carries m = -1e30, l = 0, acc = 0; a row whose
// parts all see none gets w = 1 on zeros and the clamped denominator: 0.
//
// Launched by the fused entry point right behind K7, with a programmatic
// dependent launch: its blocks may start while K7's last blocks finish
// (K7 signals launch_dependents after its main loop) and wait at
// griddepcontrol.wait until K7 is complete and its writes are visible,
// before the first read of the parts. Launched alone, the wait returns at
// once.
// ---------------------------------------------------------------------------

constexpr int kCombThreads = 256;
constexpr int kCombWarps = kCombThreads / 32;
constexpr int kCombUnroll = 8;        // parts' loads in flight a lane
constexpr int kCombChunk = 2048;      // weights staged at a time, a block

// Warps a row of `nsplit` parts (the G above).
constexpr int comb_group(int nsplit) {
  return nsplit <= 8 ? 1 : nsplit <= 16 ? 2 : nsplit <= 32 ? 4 : 8;
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int V>
struct CombVec;
template <>
struct CombVec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // x += w a, the product rounded before the sum (built with -fmad=false)
  static __device__ __forceinline__ void add(float4& x, float w,
                                             const float4& a) {
    x.x += w * a.x;
    x.y += w * a.y;
    x.z += w * a.z;
    x.w += w * a.w;
  }
  static __device__ __forceinline__ void sum(float4& x, const float4& y) {
    x.x += y.x;
    x.y += y.y;
    x.z += y.z;
    x.w += y.w;
  }
};
template <>
struct CombVec<2> {
  using type = float2;
  static __device__ __forceinline__ float2 zero() {
    return make_float2(0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(float2& x, float w,
                                             const float2& a) {
    x.x += w * a.x;
    x.y += w * a.y;
  }
  static __device__ __forceinline__ void sum(float2& x, const float2& y) {
    x.x += y.x;
    x.y += y.y;
  }
};

template <typename T>
__device__ __forceinline__ void store_vec(T* p, float4 x, float den) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x.x / den, x.y / den, x.z / den, x.w / den);
  } else {
    store2<T>(p, x.x / den, x.y / den);
    store2<T>(p + 2, x.z / den, x.w / den);
  }
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, float2 x, float den) {
  store2<T>(p, x.x / den, x.y / den);
}

// The batch of 8 parts b, b + G, ..., b + 7 G of a warp (those below
// `end`) at this lane's column vector; zeros elsewhere.
template <int V, int G>
__device__ __forceinline__ void load_batch(
    typename CombVec<V>::type (&a)[kCombUnroll], const float* __restrict__ at,
    size_t part_stride, int b, int end, bool col) {
  using Vec = typename CombVec<V>::type;
#pragma unroll
  for (int j = 0; j < kCombUnroll; ++j) {
    const int s = b + j * G;
    a[j] = col && s < end
               ? __ldcg(reinterpret_cast<const Vec*>(at + s * part_stride))
               : CombVec<V>::zero();
  }
}

template <typename T, int V, int G>
__global__ void __launch_bounds__(kCombThreads)
attn_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
             T* __restrict__ o, int sq, int d, int nsplit) {
  using Vec = typename CombVec<V>::type;
  constexpr int R = kCombWarps / G;     // rows a block
  constexpr int GT = 32 * G;            // threads a row
  constexpr int CH = kCombChunk / R;    // a row's weights staged at a time
  static_assert(CH % (G * kCombUnroll) == 0,
                "a batch of a warp's parts never straddles a chunk");
  __shared__ float s_w[kCombChunk];
  __shared__ Vec s_part[kCombWarps][32];
  __shared__ float s_max[kCombWarps];
  __shared__ float s_den[kCombWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = warp / G, gw = warp % G, gt = tid % GT;
  const int row = static_cast<int>(blockIdx.x) * R + r;
  const bool live = row < sq;
  const int c = (static_cast<int>(blockIdx.y) * 32 + lane) * V;
  const bool col = live && c < d;
  const size_t part_stride = static_cast<size_t>(sq) * d;
  const float* at = ws_acc + static_cast<size_t>(row) * d + c;
  const float2* ml = reinterpret_cast<const float2*>(ws_ml) + row;
  float* w_row = s_w + r * CH;

  grid_dependency_wait();               // K7's parts are complete
  Vec a[kCombUnroll];
  load_batch<V, G>(a, at, part_stride, gw, nsplit, col);

  float mx = kNegBig;
  for (int s = gt; live && s < nsplit; s += GT) {
    mx = fmaxf(mx, __ldcg(ml + static_cast<size_t>(s) * sq).x);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  }
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  mx = s_max[r * G];
#pragma unroll
  for (int w = 1; w < G; ++w) mx = fmaxf(mx, s_max[r * G + w]);

  Vec x = CombVec<V>::zero();
  float lsum = 0.0f;
  for (int c0 = 0; c0 < nsplit; c0 += CH) {
    const int c1 = min(nsplit, c0 + CH);
    if (c0 > 0) __syncthreads();        // the last chunk's weights are read
    for (int s = c0 + gt; live && s < c1; s += GT) {
      const float2 p = __ldcg(ml + static_cast<size_t>(s) * sq);
      const float w = expf(p.x - mx);
      w_row[s - c0] = w;
      lsum += w * p.y;
    }
    __syncthreads();
    for (int b = c0 + gw; col && b < c1; b += G * kCombUnroll) {
      if (b != gw) load_batch<V, G>(a, at, part_stride, b, c1, col);
#pragma unroll
      for (int j = 0; j < kCombUnroll; ++j) {
        const int s = b + j * G;
        if (s < c1) CombVec<V>::add(x, w_row[s - c0], a[j]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lsum += __shfl_xor_sync(kFull, lsum, off);
  }
  if (lane == 0) s_den[warp] = lsum;
  s_part[warp][lane] = x;
  __syncthreads();
  if (gw != 0 || !col) return;
  float den = s_den[r * G];
  Vec y = s_part[r * G][lane];
#pragma unroll
  for (int w = 1; w < G; ++w) {
    den += s_den[r * G + w];
    CombVec<V>::sum(y, s_part[r * G + w][lane]);
  }
  store_vec<T>(o + static_cast<size_t>(row) * d + c, y, fmaxf(den, 1e-30f));
}

template <typename T, int V, int G>
cudaError_t launch_combine_g(cudaLaunchConfig_t& cfg, const float* ws_acc,
                             const float* ws_ml, T* o, int sq, int d,
                             int nsplit) {
  constexpr int R = kCombWarps / G;
  cfg.gridDim = dim3((sq + R - 1) / R, (d + 32 * V - 1) / (32 * V));
  return cudaLaunchKernelEx(&cfg, attn_combine<T, V, G>, ws_acc, ws_ml, o,
                            sq, d, nsplit);
}

template <typename T, int V>
cudaError_t launch_combine_v(cudaLaunchConfig_t& cfg, const float* ws_acc,
                             const float* ws_ml, T* o, int sq, int d,
                             int nsplit) {
  switch (comb_group(nsplit)) {
    case 1:
      return launch_combine_g<T, V, 1>(cfg, ws_acc, ws_ml, o, sq, d, nsplit);
    case 2:
      return launch_combine_g<T, V, 2>(cfg, ws_acc, ws_ml, o, sq, d, nsplit);
    case 4:
      return launch_combine_g<T, V, 4>(cfg, ws_acc, ws_ml, o, sq, d, nsplit);
    default:
      return launch_combine_g<T, V, 8>(cfg, ws_acc, ws_ml, o, sq, d, nsplit);
  }
}

// Launches the combine of `nsplit` parts into o (Sq, d): behind K7 as a
// programmatic dependent launch when `dependent`, else as a plain launch.
template <typename T>
int launch_combine(const float* ws_acc, const float* ws_ml, void* o, int sq,
                   int d, int nsplit, bool dependent, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kCombThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  T* out = static_cast<T*>(o);
  const cudaError_t err =
      d % 4 == 0
          ? launch_combine_v<T, 4>(cfg, ws_acc, ws_ml, out, sq, d, nsplit)
          : launch_combine_v<T, 2>(cfg, ws_acc, ws_ml, out, sq, d, nsplit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_combine_dtype(int dtype, const float* ws_acc, const float* ws_ml,
                         void* o, int sq, int d, int nsplit, bool dependent,
                         cudaStream_t st) {
  switch (dtype) {
    case 0:
      return launch_combine<float>(ws_acc, ws_ml, o, sq, d, nsplit,
                                   dependent, st);
    case 1:
      return launch_combine<__nv_bfloat16>(ws_acc, ws_ml, o, sq, d, nsplit,
                                           dependent, st);
    case 2:
      return launch_combine<__half>(ws_acc, ws_ml, o, sq, d, nsplit,
                                    dependent, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           float* ws_acc, float* ws_ml, int sq, int sk, int d, float scale,
           int causal, int nsplit, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, DP>();
  static bool raised = false;         // the smem limit, once per kernel
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int nq = (sq + kBQ - 1) / kBQ;
  attn_kernel<T, DP><<<nq * nsplit, kAttnThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), ws_acc, ws_ml, sq, sk,
      d, scale, causal, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* ws_acc, float* ws_ml, int sq, int sk, int d,
             float scale, int causal, int nsplit, cudaStream_t st) {
#define REPRO_ATTN_D(DP)                                                  \
  if (d <= DP) {                                                          \
    return launch<T, DP>(q, k, v, o, ws_acc, ws_ml, sq, sk, d, scale,     \
                         causal, nsplit, st);                             \
  }
  REPRO_ATTN_D(32)
  REPRO_ATTN_D(64)
  REPRO_ATTN_D(128)
  REPRO_ATTN_D(256)
#undef REPRO_ATTN_D
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_attention(int dtype, const void* q, const void* k, const void* v,
                     void* o, float* ws_acc, float* ws_ml, int sq, int sk,
                     int d, float scale, int causal, int nsplit,
                     cudaStream_t st) {
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, ws_acc, ws_ml, sq, sk, d, scale,
                             causal, nsplit, st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, ws_acc, ws_ml, sq, sk, d,
                                     scale, causal, nsplit, st);
    case 2:
      return launch_d<__half>(q, k, v, o, ws_acc, ws_ml, sq, sk, d, scale,
                              causal, nsplit, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool attention_args_ok(int d, int nsplit) {
  return d >= 8 && d <= 256 && d % 8 == 0 && nsplit >= 1;
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16. d: a multiple of 8 in [8, 256]. With
// nsplit = 1 writes o (Sq, d) in the input type; with nsplit > 1 writes
// the parts' acc (nsplit, Sq, d) and (m, l) (nsplit, Sq, 2), fp32, to the
// workspace and leaves o alone.
EXPORT int flash_attention(int dtype, const void* q, const void* k,
                           const void* v, void* o, float* ws_acc,
                           float* ws_ml, int sq, int sk, int d, float scale,
                           int causal, int nsplit, void* stream) {
  if (!attention_args_ok(d, nsplit) ||
      (nsplit > 1 && (ws_acc == nullptr || ws_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq == 0) return 0;
  return launch_attention(dtype, q, k, v, o, ws_acc, ws_ml, sq, sk, d, scale,
                          causal, nsplit, static_cast<cudaStream_t>(stream));
}

// The split form in one call: K7 writes the parts of nsplit >= 2 kv
// ranges to the workspace, then the combine, a programmatic dependent
// launch on the same stream, writes o (Sq, d) in the input type. Takes
// what both kernels take (d a multiple of 8 in [8, 256]); a refused
// launch of either returns its error.
EXPORT int flash_attention_split(int dtype, const void* q, const void* k,
                                 const void* v, void* o, float* ws_acc,
                                 float* ws_ml, int sq, int sk, int d,
                                 float scale, int causal, int nsplit,
                                 void* stream) {
  if (!attention_args_ok(d, nsplit) || nsplit < 2 || ws_acc == nullptr ||
      ws_ml == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_attention(dtype, q, k, v, nullptr, ws_acc, ws_ml, sq,
                                   sk, d, scale, causal, nsplit, st);
  if (err != 0) return err;
  return launch_combine_dtype(dtype, ws_acc, ws_ml, o, sq, d, nsplit, true,
                              st);
}

// o (Sq, d) in the type `dtype` from the parts flash_attention wrote
// (d even, at least 8)
EXPORT int attention_combine(int dtype, const float* ws_acc,
                             const float* ws_ml, void* o, int sq, int d,
                             int nsplit, void* stream) {
  if (d < 8 || d % 2 != 0 || nsplit < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sq == 0) return 0;
  return launch_combine_dtype(dtype, ws_acc, ws_ml, o, sq, d, nsplit, false,
                              static_cast<cudaStream_t>(stream));
}
