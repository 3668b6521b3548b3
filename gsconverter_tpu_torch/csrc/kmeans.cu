// K-Means on Hopper (sm_90a): the labels of kernel K2 (the Lloyd step) and
// kernel K3 (assign), with a plain C interface for ctypes.  K4 (update)
// lives in kmeans_update.cu and is K2's sum stage.
//
// Replaces the Pallas TPU kernels of gsconverter_tpu/ops/kmeans.py:
//   K2 kmeans_lloyd_labels, then K4 <- _lloyd_kernel  (launched by _lloyd_pallas)
//   K3 kmeans_assign                 <- _assign_kernel (launched by _assign_pallas)
//
// Same functions, same numbers as the TPU kernels:
//   d[r, j] = ||c_j||^2 - 2 * x_r . c_j, with ||c_j||^2 from the f32
//   centroids; label = the first argmin over j (the lowest index wins every
//   tie, across centroid tiles too), with x . c as the sequential f32 FMA
//   chain over d = 0, 1, ... forms it; in bf16 mode x and c are rounded to
//   bf16 (nearest even) first.  K2 is batched over independent problems
//   ("chunks"): x [C, P, D], c [C, K, D], n_valid [C] -> labels [C, P] and
//   seg [C * P] = chunk * K + label for rows r < n_valid, -1 for the others.
//   ops/kmeans.py::_lloyd_kernel hands seg and x (bf16-rounded in bf16
//   mode) to K4, whose summation order depends on (x, seg) alone, so K2's
//   sums and counts are bit-identical from launch to launch and from card
//   to card.  Nothing here reads the SM count or asks for occupancy.
//
// Two label passes:
//   - bf16 mode, D <= 128 (the JAX package's bf16 kernel range): the
//     tensor cores.  lloyd_labels_tc_kernel: 8 warps, each owning an
//     m-tile of 16 rows as bf16 A fragments in registers (two m-tiles a
//     warp, with more registers and fewer warps in flight, ran slower); the chunk's
//     centroids staged in shared memory as bf16 pairs (D zero-padded to a
//     multiple of 16), with ||c||^2 by the f32 FMA chain beside them (+inf
//     in padded slots); mma.sync.m16n8k16 (bf16 in, f32 accumulation) forms
//     x.c for 16 rows x 8 centroids per k-step; each thread keeps a running
//     top two (d1, i1), d2 of its rows, merged over the four threads of a
//     row by shuffles (the lower index wins an equal d).  The products of
//     bf16 values are exact, but the tensor cores' accumulation order and
//     rounding are not the FMA chain's.  So a row r < n_valid whose gap
//     d2 - d1 is within 2E, where E = 4 g ||x|| max||c|| + 2^-21 max(|d1|,
//     |d2|), g = 4 Dp 2^-24 (ops/kmeans.py::_nearest's bound, 16x the
//     chain's own gamma_D, with the chunk's largest ||c||), is listed; then
//     lloyd_recheck_kernel gives each listed row its exact label: one warp
//     a row, lanes over centroids, the FMA chain of the bf16 values, a warp
//     argmin keeping the lower index.  Rows at and above n_valid (SOG's
//     PAD_POS rows, whole chunks of them at 3M splats) are not re-checked,
//     as _nearest(exact_rows=real) does not re-check them.
//   - f32 mode (k > 2048 or D > 128 on the lloyd_step route), and bf16
//     mode above D = 128: nearest_pass_kernel, the CUDA-core FMA chain
//     itself (exact, so no re-check), which K3 also runs.
//
// What bounds it here.  The tensor-core pass does 2 rows k D bf16
// operations (0.21 ms at 64 x 65,536 rows, k = 1024, D = 24, at 989 TFLOP/s) but about six FP32
// and integer instructions a (row, centroid) pair in its argmin epilogue,
// which bound it in practice; x is read once (403 MB at 4.19M rows of 24).
// The CUDA-core pass is bound by FP32 FMA throughput (N K D FMAs).  Its
// design:
//   - 256 threads; a tile of rows of x sits in shared memory transposed
//     ([D][rows + 1]: conflict-free both ways), and a tile of centroids
//     beside it (all of them at D = 24, K <= 1632); every thread of a warp
//     reads the same centroid at the same time (a broadcast), 16 centroids
//     in registers, 4 dimensions per 128-bit load;
//   - the row tile is as large as shared memory allows beside at least 16
//     centroids: 512 rows (two per thread, so a load feeds 8 FMAs) up to
//     D = 104, 256 (one per thread) up to D = 208, then 128, 64, ... 8
//     rows, where 256 / rows threads share a row, each taking every
//     (256 / rows)-th group of 16 centroids, and their (distance, index)
//     minima are reduced with the lower index winning a tie;
//   - tiles are staged with 8 loads in flight per thread: one load at a
//     time left a block waiting on memory for about a quarter of the pass;
//   - one block per 512 rows of each chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;         // threads per block
constexpr int kTileRows = 512;        // most rows per x tile: two per thread
constexpr int kMinTileRows = 8;       // fewest rows per x tile (the widest rows)
constexpr int kJ = 16;                // centroids per register tile
constexpr int kLoads = 8;             // loads a thread issues before it stores
constexpr int kMaxD = 2048;           // widest rows: 8 rows and 16 centroids fit
constexpr size_t kCentBudget = 160 * 1024;  // shared bytes for one centroid tile
constexpr size_t kSmemLimit = 232448;       // 227 KB: a Hopper block's most
// shared bytes beside the tiles: each thread's (distance, index) minimum
// [kThreads] for the cross-thread argmin
constexpr size_t kFixedBytes = 2 * kThreads * sizeof(int);

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Threads that own the rows of a tile of `tr` rows, one row each (two each
// for a 512-row tile); the other threads of the block share those rows.
__host__ __device__ inline int row_slots(int tr) { return tr < kThreads ? tr : kThreads; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage rows [r0, r0 + nrows) of xc ([*, D] row-major) as
// xs[d * (tr + 1) + r], zero beyond nrows and for the padded dimensions
// [D, dp).  Each thread issues kLoads coalesced loads before it stores any
// of them, so a tile costs a few memory round trips, not one per value.
__device__ __forceinline__ void load_x_tile(const float* __restrict__ xc, int r0,
                                            int nrows, int D, int dp, int tr, bool bf16,
                                            float* __restrict__ xs) {
  const int total = tr * dp;
  const int xstride = tr + 1;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / dp;
      const int d = i - r * dp;
      v[u] = (i < total && r < nrows && d < D) ? xc[static_cast<size_t>(r0 + r) * D + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int r = i / dp;
      if (i < total) xs[(i - r * dp) * xstride + r] = bf16 ? bf16_round(v[u]) : v[u];
    }
  }
}

// Stage centroids [j0, j0 + jn) of cc ([K, D]) as cs[j * dp + d] (zero
// padded, bf16-rounded in bf16 mode) and their squared norms from the f32
// values as c2s[j] (+inf for the padded slots, which then never win).
__device__ __forceinline__ void load_centroid_tile(const float* __restrict__ cc, int j0,
                                                   int jn, int kt, int D, int dp,
                                                   bool bf16, float* __restrict__ cs,
                                                   float* __restrict__ c2s) {
  const int total = kt * dp;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int j = i / dp;
      const int d = i - j * dp;
      v[u] = (i < total && j < jn && d < D) ? cc[static_cast<size_t>(j0 + j) * D + d] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) cs[i] = bf16 ? bf16_round(v[u]) : v[u];
    }
  }
  for (int j = threadIdx.x; j < kt; j += kThreads) {
    float s = CUDART_INF_F;
    if (j < jn) {
      s = 0.f;
      const float* cj = cc + static_cast<size_t>(j0 + j) * D;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(cj[d], cj[d], s);
    }
    c2s[j] = s;
  }
}

// Labels of every row of chunk blockIdx.y in rows [blockIdx.x * rps,
// +rps); with kSeg, also seg[chunk * P + r] = chunk * K + label for rows
// r < n_valid[chunk] and -1 for the others (K4's input).  Tiles of tr
// rows; kRows = 2 for tr = 512 (thread t owns rows t and t + 256), else 1
// (thread t works on row t % tr, centroid group t / tr).
template <bool kSeg, int kRows>
__global__ void __launch_bounds__(kThreads)
nearest_pass_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const int* __restrict__ n_valid, int* __restrict__ labels,
                    int* __restrict__ seg, int P, int D, int K, int dp, int tr_arg, int kt,
                    int rps, int bf16) {
  extern __shared__ __align__(16) float smem[];
  // compile-time tile geometry for the 512-row tile (rows, stride, threads
  // per row), which the shared-memory addressing folds in
  const int tr = kRows == 2 ? kTileRows : tr_arg;
  const int xstride = tr + 1;
  float* xs = smem;                                              // [dp][tr + 1]
  float* cs = xs + dp * xstride;                                 // [kt][dp]
  float* c2s = cs + static_cast<size_t>(kt) * dp;                // [kt]
  float* best_s = c2s + kt;                                      // [kThreads]
  int* idx_s = reinterpret_cast<int*>(best_s + kThreads);        // [kThreads]

  const int chunk = blockIdx.y;
  const int t = threadIdx.x;
  const int slots = kRows == 2 ? kThreads : row_slots(tr);
  const int groups = kRows == 2 ? 1 : kThreads / slots;  // threads per row
  const int slot = kRows == 2 ? t : t % slots;
  const int grp = kRows == 2 ? 0 : t / slots;
  const float* xc = x + static_cast<size_t>(chunk) * P * D;
  const float* cc = c + static_cast<size_t>(chunk) * K * D;
  const int row_begin = blockIdx.x * rps;
  const int row_end = min(P, row_begin + rps);
  const int nv = kSeg ? n_valid[chunk] : 0;

  const int ntiles_k = (K + kt - 1) / kt;
  int loaded = -1;
  for (int r0 = row_begin; r0 < row_end; r0 += tr) {
    const int nrows = min(tr, row_end - r0);
    __syncthreads();  // the previous tile's xs and minima are consumed
    load_x_tile(xc, r0, nrows, D, dp, tr, bf16 != 0, xs);
    __syncthreads();

    float best0 = CUDART_INF_F, best1 = CUDART_INF_F;
    int bi0 = 0, bi1 = 0;
    for (int kb = 0; kb < ntiles_k; ++kb) {
      const int j0 = kb * kt;
      const int jn = min(kt, K - j0);
      if (kb != loaded) {
        __syncthreads();  // every thread is done with the previous tile
        load_centroid_tile(cc, j0, jn, kt, D, dp, bf16 != 0, cs, c2s);
        loaded = kb;
        __syncthreads();
      }
      const int jn_pad = round_up(jn, kJ);
      for (int jj = grp * kJ; jj < jn_pad; jj += groups * kJ) {
        float a0[kJ], a1[kJ];
#pragma unroll
        for (int q = 0; q < kJ; ++q) a0[q] = a1[q] = 0.f;
        for (int d = 0; d < dp; d += 4) {
          const float* xr = xs + d * xstride + slot;
          const float x00 = xr[0], x01 = xr[xstride];
          const float x02 = xr[2 * xstride], x03 = xr[3 * xstride];
          float x10 = 0.f, x11 = 0.f, x12 = 0.f, x13 = 0.f;
          if constexpr (kRows == 2) {
            x10 = xr[kThreads];
            x11 = xr[xstride + kThreads];
            x12 = xr[2 * xstride + kThreads];
            x13 = xr[3 * xstride + kThreads];
          }
#pragma unroll
          for (int q = 0; q < kJ; ++q) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + (jj + q) * dp + d);
            // the two rows' chains interleaved: independent FMAs back to back
            a0[q] = fmaf(x00, cv.x, a0[q]);
            if constexpr (kRows == 2) a1[q] = fmaf(x10, cv.x, a1[q]);
            a0[q] = fmaf(x01, cv.y, a0[q]);
            if constexpr (kRows == 2) a1[q] = fmaf(x11, cv.y, a1[q]);
            a0[q] = fmaf(x02, cv.z, a0[q]);
            if constexpr (kRows == 2) a1[q] = fmaf(x12, cv.z, a1[q]);
            a0[q] = fmaf(x03, cv.w, a0[q]);
            if constexpr (kRows == 2) a1[q] = fmaf(x13, cv.w, a1[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kJ; ++q) {
          const float c2 = c2s[jj + q];
          const float d0 = __fsub_rn(c2, __fmul_rn(2.f, a0[q]));
          const float d1 = kRows == 2 ? __fsub_rn(c2, __fmul_rn(2.f, a1[q])) : 0.f;
          // strict: the earlier centroid keeps a tie
          if (d0 < best0) { best0 = d0; bi0 = j0 + jj + q; }
          if (kRows == 2 && d1 < best1) { best1 = d1; bi1 = j0 + jj + q; }
        }
      }
    }

    if (groups > 1) {  // the threads of a row saw disjoint centroids
      best_s[t] = best0;
      idx_s[t] = bi0;
      __syncthreads();
      if (grp == 0) {
        for (int g = 1; g < groups; ++g) {
          const float b = best_s[g * slots + t];
          const int i = idx_s[g * slots + t];
          if (b < best0 || (b == best0 && i < bi0)) { best0 = b; bi0 = i; }
        }
      }
    }
    if (grp == 0) {
      const size_t out = static_cast<size_t>(chunk) * P + r0;
      if (slot < nrows) labels[out + slot] = bi0;
      if (kRows == 2 && slot + kThreads < nrows) labels[out + slot + kThreads] = bi1;
      if (kSeg) {
        const int base = chunk * K;
        if (slot < nrows) seg[out + slot] = r0 + slot < nv ? base + bi0 : -1;
        if (kRows == 2 && slot + kThreads < nrows) {
          seg[out + slot + kThreads] = r0 + slot + kThreads < nv ? base + bi1 : -1;
        }
      }
    }
  }
}

size_t x_tile_bytes(int dp, int tr) {
  return static_cast<size_t>(dp) * (tr + 1) * sizeof(float) + kFixedBytes;
}

size_t cent_bytes(int kt, int dp) {
  return static_cast<size_t>(kt) * (dp + 1) * sizeof(float);
}

// Shared-memory layout of one launch: rows per x tile, centroids per
// centroid tile.
struct Plan {
  int tr = 0;
  int kt = 0;
  size_t smem = 0;
};

// The nearest pass: the most rows per x tile (512, 256, ..., 8) that leave
// room for kJ centroids, then as many centroids as fit.  False when even 8
// rows and kJ centroids do not fit.
bool plan_nearest(int D, int K, Plan* p) {
  const int dp = round_up(D, 4);
  const int kpad = round_up(K, kJ);
  for (int tr = kTileRows; tr >= kMinTileRows; tr /= 2) {
    const size_t xb = x_tile_bytes(dp, tr);
    if (xb + cent_bytes(kJ, dp) > kSmemLimit) continue;
    p->tr = tr;
    const size_t budget = std::min(kSmemLimit - xb, kCentBudget);
    const int cap = static_cast<int>(budget / (sizeof(float) * (dp + 1))) / kJ * kJ;
    p->kt = std::min(kpad, cap);
    p->smem = xb + cent_bytes(p->kt, dp);
    return p->kt >= kJ && p->smem <= kSmemLimit;
  }
  return false;
}

// One block per 512 rows of each chunk (blockIdx.y the chunk); no
// occupancy query, so the launch depends on the shape alone.
template <bool kSeg>
int launch_nearest(const float* x, const float* c, const int* n_valid, int* labels, int* seg,
                   int C, int P, int D, int K, int bf16, cudaStream_t stream) {
  Plan p;
  if (!plan_nearest(D, K, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = round_up(D, 4);
  auto kernel = p.tr == kTileRows ? nearest_pass_kernel<kSeg, 2> : nearest_pass_kernel<kSeg, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (P + kTileRows - 1) / kTileRows;
  kernel<<<dim3(nblocks, C), kThreads, p.smem, stream>>>(
      x, c, n_valid, labels, seg, P, D, K, dp, p.tr, p.kt, kTileRows, bf16);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ K2's bf16 labels on the tensor cores

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;              // rows per row tile: 16 a warp
constexpr int kTcBlockRows = 2048;                  // rows per block: 16 row tiles
constexpr int kTcMaxD = 128;                        // PRECISION_MAX_D
constexpr size_t kTcCentBudget = 110 * 1024;        // two blocks an SM
constexpr int kRecheckBlocks = 8;                   // re-check blocks per chunk
// slack on the ambiguity bound, for the f32 roundings of the norms
constexpr float kBoundSlack = 1.0625f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// d += a . b for one 16 x 8 x 16 tile: A row-major (rows g, g + 8 of the
// warp's m-tile), B column-major (8 centroids), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Words of one staged centroid: hw bf16 pairs (D padded to a multiple of
// 16), then 4 unused words, so that stride % 8 == 4 and the 8 centroids of
// an n-tile, read at the same word offset, fall in 8 distinct 4-bank groups.
__host__ __device__ inline int tc_stride(int hw) { return hw + 4; }

// Stage centroids [j0, j0 + jn) of cc ([K, D] f32) as bf16 pairs cw[j *
// stride + w] = (c[2w], c[2w + 1]), zero beyond D and for the padded slots
// j >= jn; c2s[j] = ||c_j||^2 by the f32 FMA chain over the f32 values
// (+inf for the padded slots, which then never win); *cmax2 rises to the
// largest ||bf16(c_j)||^2 (nonnegative floats order as their bits).
__device__ __forceinline__ void stage_bf16_tile(const float* __restrict__ cc, int j0, int jn,
                                                int kt, int D, int hw,
                                                uint32_t* __restrict__ cw,
                                                float* __restrict__ c2s, int* cmax2) {
  const int stride = tc_stride(hw);
  const int total = kt * hw;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * kTcThreads) {
    float lo[kLoads], hi[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kTcThreads;
      const int j = i / hw;
      const int d = 2 * (i - j * hw);
      const bool ok = i < total && j < jn;
      const float* src = cc + static_cast<size_t>(j0 + j) * D + d;
      lo[u] = ok && d < D ? src[0] : 0.f;
      hi[u] = ok && d + 1 < D ? src[1] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kTcThreads;
      const int j = i / hw;
      if (i < total) cw[j * stride + (i - j * hw)] = pack_bf16(lo[u], hi[u]);
    }
  }
  for (int j = threadIdx.x; j < kt; j += kTcThreads) {
    float s = CUDART_INF_F;
    if (j < jn) {
      s = 0.f;
      float nb = 0.f;
      const float* cj = cc + static_cast<size_t>(j0 + j) * D;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float v = cj[d];
        s = fmaf(v, v, s);
        const float b = bf16_round(v);
        nb = fmaf(b, b, nb);
      }
      atomicMax(cmax2, __float_as_int(nb));
    }
    c2s[j] = s;
  }
}

// Running top two of one row: d1 at i1 the least distance (the earlier
// centroid keeps a tie, since a thread sees its centroids in ascending
// order), d2 the next one (equal to d1 on a tie).
__device__ __forceinline__ void top2(float& d1, float& d2, int& i1, float d, int j) {
  d2 = fminf(d2, fmaxf(d, d1));
  if (d < d1) { d1 = d; i1 = j; }
}

// The four threads of a quad hold disjoint centroids of the same rows:
// merge their top twos, the lower index winning an equal distance.
__device__ __forceinline__ void top2_quad(float& d1, float& d2, int& i1) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const float od1 = __shfl_xor_sync(0xffffffffu, d1, m);
    const float od2 = __shfl_xor_sync(0xffffffffu, d2, m);
    const int oi = __shfl_xor_sync(0xffffffffu, i1, m);
    d2 = fminf(fminf(d2, od2), fmaxf(d1, od1));
    if (od1 < d1 || (od1 == d1 && oi < i1)) { d1 = od1; i1 = oi; }
  }
}

// Labels of rows [blockIdx.x * kTcBlockRows, +kTcBlockRows) of chunk
// blockIdx.y in bf16 mode, D <= 16 * KS.  Each warp owns an m-tile of 16
// rows per row tile, its A fragments (bf16) in registers; for each n-tile
// of 8 staged centroids, KS mma.sync form x.c, then d = ||c||^2 - 2 x.c
// enters each row's running top two.  A row r < n_valid whose gap d2 - d1
// is within 2E (E: _nearest's bound on |tensor-core x.c - FMA-chain x.c|,
// with the chunk's largest ||c||) is listed in amb_rows for
// lloyd_recheck_kernel, which writes its label.
template <int KS>
__global__ void __launch_bounds__(kTcThreads)
lloyd_labels_tc_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       const int* __restrict__ n_valid, int* __restrict__ labels,
                       int* __restrict__ seg, int* __restrict__ amb_rows,
                       int* __restrict__ amb_count, int P, int D, int K, int kt) {
  constexpr int kHw = 8 * KS;  // bf16 pairs of a padded row
  constexpr int kStride = kHw + 4;
  extern __shared__ __align__(16) uint32_t tsm[];
  uint32_t* cw = tsm;                                          // [kt][kStride]
  float* c2s = reinterpret_cast<float*>(cw + kt * kStride);    // [kt]
  __shared__ int cmax2;

  const int chunk = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row (and centroid) of the fragments within a tile
  const int t = lane % 4;  // column pair of the fragments
  const float* xc = x + static_cast<size_t>(chunk) * P * D;
  const float* cc = c + static_cast<size_t>(chunk) * K * D;
  const size_t out = static_cast<size_t>(chunk) * P;
  const int nv = n_valid[chunk];
  const int row_begin = blockIdx.x * kTcBlockRows;
  const int row_end = min(P, row_begin + kTcBlockRows);
  // g = 4 Dp 2^-24, as _nearest's g = 4 D 2^-24 (Dp >= D)
  const float gam = 4.f * (16 * KS) * 5.9604644775390625e-8f;
  if (threadIdx.x == 0) cmax2 = 0;

  const int ntiles = (K + kt - 1) / kt;
  int loaded = -1;
  for (int r0 = row_begin; r0 < row_end; r0 += kTcRows) {
    // rows[h]: row g (h = 0) and g + 8 (h = 1) of the warp's m-tile
    int rows[2];
    float xn[2];  // their ||bf16(x)||
    uint32_t a[KS][4];
    {
      rows[0] = r0 + warp * 16 + g;
      rows[1] = rows[0] + 8;
      const float* pa = xc + static_cast<size_t>(rows[0]) * D;
      const float* pb = pa + 8 * D;
      const bool oka = rows[0] < row_end, okb = rows[1] < row_end;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = ks * 16 + h * 8 + 2 * t;
          const float a0 = oka && col < D ? bf16_round(pa[col]) : 0.f;
          const float a1 = oka && col + 1 < D ? bf16_round(pa[col + 1]) : 0.f;
          const float b0 = okb && col < D ? bf16_round(pb[col]) : 0.f;
          const float b1 = okb && col + 1 < D ? bf16_round(pb[col + 1]) : 0.f;
          a[ks][2 * h] = pack_bf16(a0, a1);      // row g
          a[ks][2 * h + 1] = pack_bf16(b0, b1);  // row g + 8
          sa = fmaf(a0, a0, fmaf(a1, a1, sa));
          sb = fmaf(b0, b0, fmaf(b1, b1, sb));
        }
      }
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 2);
      sb += __shfl_xor_sync(0xffffffffu, sb, 1);
      sb += __shfl_xor_sync(0xffffffffu, sb, 2);
      xn[0] = sqrtf(sa);
      xn[1] = sqrtf(sb);
    }

    float d1[2] = {CUDART_INF_F, CUDART_INF_F}, d2[2] = {CUDART_INF_F, CUDART_INF_F};
    int i1[2] = {0, 0};
    for (int kb = 0; kb < ntiles; ++kb) {
      const int j0 = kb * kt;
      const int jn = min(kt, K - j0);
      if (kb != loaded) {
        __syncthreads();  // every warp is done with the previous tile
        stage_bf16_tile(cc, j0, jn, kt, D, kHw, cw, c2s, &cmax2);
        loaded = kb;
        __syncthreads();
      }
      const int ntn = (jn + 7) / 8;
      for (int nt = 0; nt < ntn; ++nt) {
        const uint32_t* bw = cw + (nt * 8 + g) * kStride + t;
        const float2 cp = *reinterpret_cast<const float2*>(c2s + nt * 8 + 2 * t);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // dims 16 ks + 2t, +1 and 16 ks + 8 + 2t, +1 of centroid g
          mma_bf16(acc, a[ks], bw[ks * 8], bw[ks * 8 + 4]);
        }
        const int j = j0 + nt * 8 + 2 * t;
        // d = c2 - 2 acc, one rounding (2 acc is exact)
        top2(d1[0], d2[0], i1[0], fmaf(-2.f, acc[0], cp.x), j);
        top2(d1[0], d2[0], i1[0], fmaf(-2.f, acc[1], cp.y), j + 1);
        top2(d1[1], d2[1], i1[1], fmaf(-2.f, acc[2], cp.x), j);
        top2(d1[1], d2[1], i1[1], fmaf(-2.f, acc[3], cp.y), j + 1);
      }
    }

    // every tile has been staged once: cmax2 is the chunk's
    const float cmax = sqrtf(__int_as_float(cmax2));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top2_quad(d1[h], d2[h], i1[h]);
      const int r = rows[h];
      if (t != h || r >= row_end) continue;  // one thread of the quad writes
      labels[out + r] = i1[h];
      if (r >= nv) {
        seg[out + r] = -1;
        continue;
      }
      seg[out + r] = chunk * K + i1[h];
      const float e = 4.f * gam * xn[h] * cmax +
                      4.76837158203125e-7f * fmaxf(fabsf(d1[h]), fabsf(d2[h]));
      if (d2[h] < CUDART_INF_F && d2[h] - d1[h] <= 2.f * kBoundSlack * e) {
        const int slot = atomicAdd(amb_count + chunk, 1);
        amb_rows[out + slot] = r;
      }
    }
  }
}

// The exact labels of the rows that lloyd_labels_tc_kernel listed: block
// (blockIdx.x, chunk) stages the chunk's centroids tile by tile (bf16, as
// the labels kernel does) and each warp takes listed rows blockIdx.x * 8 +
// warp, then every kRecheckBlocks * 8-th: the sequential f32 FMA chain of
// the bf16 values over d = 0, 1, ... against each centroid (lanes over
// centroids), d = c2 - 2 x.c, and a warp reduction that keeps the lower
// index on ties.  Across several centroid tiles each row's minimum so far
// waits in best_d / best_i (an earlier tile keeps a tie).
__global__ void __launch_bounds__(kTcThreads)
lloyd_recheck_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     const int* __restrict__ amb_rows, const int* __restrict__ amb_count,
                     int* __restrict__ labels, int* __restrict__ seg,
                     float* __restrict__ best_d, int* __restrict__ best_i, int P, int D,
                     int K, int kt) {
  const int chunk = blockIdx.y;
  const int count = amb_count[chunk];
  if (static_cast<int>(blockIdx.x) * kTcWarps >= count) return;  // the block's list is empty
  const int hw = round_up(D, 16) / 2;
  const int stride = tc_stride(hw);
  extern __shared__ __align__(16) uint32_t tsm[];
  uint32_t* cw = tsm;                                        // [kt][stride]
  float* c2s = reinterpret_cast<float*>(cw + kt * stride);  // [kt]
  float* xw = c2s + kt;                                      // [kTcWarps][kTcMaxD]
  __shared__ int unused_cmax2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xr = xw + warp * kTcMaxD;
  const float* cc = c + static_cast<size_t>(chunk) * K * D;
  const size_t out = static_cast<size_t>(chunk) * P;
  const int ntiles = (K + kt - 1) / kt;
  for (int kb = 0; kb < ntiles; ++kb) {
    const int j0 = kb * kt;
    const int jn = min(kt, K - j0);
    __syncthreads();
    stage_bf16_tile(cc, j0, jn, kt, D, hw, cw, c2s, &unused_cmax2);
    __syncthreads();
    for (int e = blockIdx.x * kTcWarps + warp; e < count; e += gridDim.x * kTcWarps) {
      const int r = amb_rows[out + e];
      const float* xg = x + (out + r) * D;
      for (int d = lane; d < D; d += 32) xr[d] = bf16_round(xg[d]);
      __syncwarp();
      float best = CUDART_INF_F;
      int bi = 0;
      for (int jj = lane; jj < jn; jj += 32) {
        const uint32_t* cj = cw + jj * stride;
        float s = 0.f;
        for (int d = 0; d < D; d += 2) {
          const uint32_t w = cj[d / 2];
          s = fmaf(xr[d], bf16_lo(w), s);
          if (d + 1 < D) s = fmaf(xr[d + 1], bf16_hi(w), s);
        }
        const float dist = __fsub_rn(c2s[jj], __fmul_rn(2.f, s));
        if (dist < best) { best = dist; bi = j0 + jj; }  // strict: the earlier keeps a tie
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, m);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
        if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (kb > 0) {  // the earlier tiles' minimum keeps a tie
        const float pb = best_d[out + e];
        const int pi = best_i[out + e];
        if (!(best < pb)) { best = pb; bi = pi; }
      }
      if (lane == 0) {
        if (kb + 1 < ntiles) {
          best_d[out + e] = best;
          best_i[out + e] = bi;
        } else {
          labels[out + r] = bi;
          seg[out + r] = chunk * K + bi;
        }
      }
      __syncwarp();  // xr is consumed
    }
  }
}

// Centroids per tile of the tensor-core pass (a multiple of 8) and its
// shared bytes; the re-check kernel adds kTcWarps rows of x.
int tc_tile(int D, int K, size_t* smem) {
  const int hw = round_up(D, 16) / 2;
  const size_t per = static_cast<size_t>(tc_stride(hw)) * sizeof(uint32_t) + sizeof(float);
  const int kt = std::min(round_up(K, 8), static_cast<int>(kTcCentBudget / per) / 8 * 8);
  *smem = kt * per;
  return kt;
}

template <int KS>
int launch_labels_tc(const float* x, const float* c, const int* n_valid, int* labels,
                     int* seg, int* amb_rows, int* amb_count, int C, int P, int D, int K,
                     int kt, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lloyd_labels_tc_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (P + kTcBlockRows - 1) / kTcBlockRows;
  lloyd_labels_tc_kernel<KS><<<dim3(nblocks, C), kTcThreads, smem, stream>>>(
      x, c, n_valid, labels, seg, amb_rows, amb_count, P, D, K, kt);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 mode: the tensor-core labels, then the exact re-check of the
// listed rows.  scratch [3 C P] i32: the lists, then the re-check's
// best_d (f32) and best_i.
int lloyd_labels_bf16(const float* x, const float* c, const int* n_valid, int* labels,
                      int* seg, int* scratch, int* amb_count, int C, int P, int D, int K,
                      cudaStream_t stream) {
  size_t smem = 0;
  const int kt = tc_tile(D, K, &smem);
  int* amb_rows = scratch;
  const size_t cp = static_cast<size_t>(C) * P;
  using Launch = int (*)(const float*, const float*, const int*, int*, int*, int*, int*, int,
                         int, int, int, int, size_t, cudaStream_t);
  // one instance per k-step count: D up to 16, 32, ..., 128
  constexpr Launch kLaunch[] = {launch_labels_tc<1>, launch_labels_tc<2>, launch_labels_tc<3>,
                                launch_labels_tc<4>, launch_labels_tc<5>, launch_labels_tc<6>,
                                launch_labels_tc<7>, launch_labels_tc<8>};
  const int err = kLaunch[(D + 15) / 16 - 1](x, c, n_valid, labels, seg, amb_rows, amb_count, C,
                                             P, D, K, kt, smem, stream);
  if (err != 0) return err;
  const size_t rsmem = smem + kTcWarps * kTcMaxD * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(lloyd_recheck_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(rsmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  lloyd_recheck_kernel<<<dim3(kRecheckBlocks, C), kTcThreads, rsmem, stream>>>(
      x, c, amb_rows, amb_count, labels, seg, reinterpret_cast<float*>(scratch + cp),
      scratch + 2 * cp, P, D, K, kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2's labels.  x [C, P, D], c [C, K, D] f32; n_valid [C] i32 -> labels
// [C, P] i32 and seg [C * P] i32 (chunk * K + label below n_valid, else
// -1: K4's input); amb_count [C] i32, the rows of each chunk re-checked
// exactly; scratch [3 C P] i32.  bf16 with D <= 128 takes the tensor-core
// pass and its re-check; otherwise the CUDA-core FMA-chain pass (with bf16
// rounding of x and c in bf16 mode).  Returns cudaGetLastError() after the
// launches.
extern "C" int kmeans_lloyd_labels(const float* x, const float* c, const int* n_valid,
                                   int* labels, int* seg, int* scratch, int* amb_count,
                                   int C, int P, int D, int K, int bf16, void* stream) {
  if (C <= 0 || P <= 0 || D <= 0 || D > kMaxD || K <= 0 ||
      3LL * C * P >= (1LL << 31) || static_cast<long long>(C) * K >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(amb_count, 0, sizeof(int) * C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16 && D <= kTcMaxD) {
    return lloyd_labels_bf16(x, c, n_valid, labels, seg, scratch, amb_count, C, P, D, K, s);
  }
  return launch_nearest<true>(x, c, n_valid, labels, seg, C, P, D, K, bf16, s);
}

// K3.  x [N, D], c [K, D] f32 -> labels [N] i32.
extern "C" int kmeans_assign(const float* x, const float* c, int* labels, int N, int D,
                             int K, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_nearest<false>(x, c, nullptr, labels, nullptr, 1, N, D, K, 0,
                               static_cast<cudaStream_t>(stream));
}
