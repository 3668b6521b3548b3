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
// Label passes:
//   - K2, bf16 mode, D <= 128 (the JAX package's bf16 kernel range): the
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
//   - K3, D <= 128: the tensor cores on the f32 values split into two bf16
//     terms each (assign_pack_kernel, assign_labels_tc_kernel, then
//     assign_recheck_kernel for the listed rows; the split and its bound
//     below).
//   - K2 in f32 mode (k > 2048 or D > 128 on the lloyd_step route), K2 in
//     bf16 mode above D = 128, and K3 above D = 128: nearest_pass_kernel,
//     the CUDA-core FMA chain itself (exact, so no re-check).
//
// K3's split product and its error bound E.  Each f32 value a is split
// into hi = bf16_rn(a) and lo = bf16_rn(a - hi) (a - hi is exact in f32).
// With the bf16 unit roundoff 2^-8, |a - hi| <= 2^-8 |a| and |a - hi - lo|
// <= 2^-8 |a - hi| <= 2^-16 |a|.  One tensor-core product over a
// contraction of 3D, A rows (xh | xh | xl) against B columns (ch | cl |
// ch), zero-padded to Dp3 = 16 KS, forms xh.ch + xh.cl + xl.ch.  Per
// dimension, x c - (xh ch + xh cl + xl ch) = xh ec + xl cl + xl ec + ex c
// (ex = x - xh - xl, ec likewise), at most (1 + 2^-8) 2^-16 + (1 + 2^-8)^2
// 2^-16 + 2^-24 + 2^-16 < 3.1 * 2^-16 times |x_d c_d|; and sum_d |x_d c_d|
// <= ||x|| ||c|| (Cauchy-Schwarz).  The tensor cores add the 3D exact bf16
// products in their own order and rounding, within g = 4 Dp3 2^-24 (K2's
// assumption for them, 4x gamma_Dp3) of the sum of the terms' magnitudes,
// which is at most 1.03 ||x|| ||c||.  The FMA chain (the function) is
// within gamma_D <= D 2^-23 of the same sum of the exact x.c.  So
//   |acc - chain| <= (1.03 g + 3.1 * 2^-16 + D 2^-23) ||x|| ||c|| + A,
// where A covers underflow: a tensor core may flush subnormal bf16 inputs,
// products and sums (at most 2^-126 times the other factor, or 2^-126, for
// each of the 3D terms and Dp3 additions), a subnormal lo rounds with an
// absolute error of 2^-134, and the chain underflows by 2^-150 a step;
// A = 2^-124 (sqrt(D) (||x|| + ||c||) + Dp3) bounds all of them.  Both
// sides round d = c2 - 2 x.c once (2 x.c is exact), adding 2^-24 |d| each.
// With ||x|| of the row (f64 sum of squares, rounded up to f32) and
// max||c|| (f64) in place of ||c||,
//   E = 1.0625 (2 (1.03 g + 3.1 * 2^-16 + D 2^-23) ||x|| max||c||
//               + 2 A + 2^-21 max(|d1|, |d2|))
// bounds |d_tc(j) - d_chain(j)| for every centroid j (the 1.0625 covers
// the norms' roundings and the slightly larger |d| of a candidate up to
// d1 + 2E).  If the chain's winner j* is not the tensor cores' i1, then
// d2 <= d_tc(j*) <= d_chain(j*) + E <= d_chain(i1) + E <= d_tc(i1) + 2E =
// d1 + 2E (j* < i1 on an exact tie), so every row whose label could differ
// has a gap d2 - d1 <= 2E and is listed; so is every row (K > 1) with a
// non-finite d1 or d2 (a NaN distance also sets d2 = d1), or with ||x||
// max||c|| >= 2^125, where 2 x.c may overflow.  assign_recheck_kernel gives
// each listed row the chain's label from the f32 values.
// ops/kmeans.py::_assign_split_ref is this route in plain PyTorch, and
// tests/test_torch_kmeans.py holds E against the chain on the CPU.
//
// What bounds it here.  K2's tensor-core pass does 2 rows k D bf16
// operations (0.21 ms at 64 x 65,536 rows, k = 1024, D = 24, at 989 TFLOP/s) but about six FP32
// and integer instructions a (row, centroid) pair in its argmin epilogue,
// which bound it in practice; x is read once (403 MB at 4.19M rows of 24).
// K3's split product has 2.5x the k-steps of K2's at D = 24 (5 a 16 x 8
// tile) against the same epilogue, so the two are about even.  Its packed
// centroids (655 KB at K = 4096, D = 24) do not fit in shared memory: each
// block streams them from L2 in tiles, the next one copied (cp.async)
// while the current one is used, and owns 256 rows (two m-tiles a warp up
// to KS = 8) so that each staged byte feeds twice the mma of a 128-row
// block; two n-tiles a step keep four independent mma chains in flight.
// With the exact re-check, none of its 2 N K D operations need the FP32
// pipe.
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
#include <cuda_pipeline.h>
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

// ------------------------------------------ K3's f32 labels on the tensor cores

constexpr int kAsWarps = 8;
constexpr int kAsThreads = kAsWarps * 32;
constexpr size_t kAsTileBudget = 100 * 1024;     // both centroid buffers of a block
constexpr size_t kAsRecheckBudget = 96 * 1024;   // one f32 centroid tile of the re-check
constexpr int kAsRecheckBlocks = 256;            // re-check blocks (those beyond the list exit)

// k-steps of the split product at width D: 3 D zero-padded to 16 KS
__host__ __device__ constexpr int as_ks(int D) { return (3 * D + 15) / 16; }
// m-tiles a warp owns: two while their A fragments take at most 64 registers
__host__ __device__ constexpr int as_mt(int ks) { return ks <= 8 ? 2 : 1; }
// Words of one packed centroid: 8 KS bf16 pairs, then padding to stride %
// 32 == 8, so that the 64-bit loads of a half-warp (centroids g = 0..3 or
// 4..7, word pairs 2t) fall in 16 distinct bank pairs.
__host__ __device__ constexpr int as_stride(int ks) { return 8 * ks + (40 - 8 * ks % 32) % 32; }

// Column q of the split layout of one row of D f32 values: xh | xh | xl for
// x (A), ch | cl | ch for a centroid (B); 0 from 3D on.
__device__ __forceinline__ float split_col(const float* row, int q, int D, bool centroid) {
  if (q >= 3 * D) return 0.f;
  const int part = q / D;
  const float v = row[q - part * D];
  const float hi = bf16_round(v);
  return (centroid ? part == 1 : part == 2) ? bf16_round(__fsub_rn(v, hi)) : hi;
}

// K3's centroids, packed once a launch: cw[j * stride + w] holds the split
// B operand of centroid j in the order the labels kernel reads it (word 2t
// + h of k-step ks holds columns 16 ks + 8 h + 2t, +1, so a thread's two
// fragment words are one 64-bit load), zero for the padding words and the
// padded slots K <= j < kp; c2[j] = ||c_j||^2 by the f32 FMA chain (+inf
// for the padded slots, which then never win); *cmax2 rises to the largest
// ||c_j||^2 in f64 (nonnegative doubles order as their bits).
__global__ void __launch_bounds__(256)
assign_pack_kernel(const float* __restrict__ c, uint32_t* __restrict__ cw,
                   float* __restrict__ c2, unsigned long long* __restrict__ cmax2, int D, int K,
                   int kp, int ks, int stride) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < kp * stride) {
    const int j = i / stride;
    const int w = i - j * stride;
    uint32_t v = 0;
    if (j < K && w < 8 * ks) {
      const int p = w % 8;
      const int q = 16 * (w / 8) + 8 * (p & 1) + 2 * (p >> 1);
      const float* cj = c + static_cast<size_t>(j) * D;
      v = pack_bf16(split_col(cj, q, D, true), split_col(cj, q + 1, D, true));
    }
    cw[i] = v;
  }
  if (i < kp) {
    float s = CUDART_INF_F;
    if (i < K) {
      s = 0.f;
      double n2 = 0.0;
      const float* cj = c + static_cast<size_t>(i) * D;
      for (int d = 0; d < D; ++d) {
        const float v = cj[d];
        s = fmaf(v, v, s);
        n2 = fma(static_cast<double>(v), static_cast<double>(v), n2);
      }
      atomicMax(cmax2, static_cast<unsigned long long>(__double_as_longlong(n2)));
    }
    c2[i] = s;
  }
}

// Whether a row's tensor-core top two leave its label in doubt: E as the
// comment at the top of this file derives it, in f64.
__device__ __forceinline__ bool assign_listed(float d1, float d2, float xn, double cmax, int D,
                                              int dp3) {
  if (!isfinite(d1) || !isfinite(d2)) return true;
  const double xc = static_cast<double>(xn) * cmax;
  if (!(xc < 0x1p125)) return true;  // 2 x.c may overflow f32 (or a norm is NaN)
  const double rel = 2.0 * (1.03 * 4.0 * dp3 * 0x1p-24 + 3.1 * 0x1p-16 + D * 0x1p-23);
  const double e = static_cast<double>(kBoundSlack) *
                   (rel * xc + 0x1p-123 * (sqrt(static_cast<double>(D)) * (xn + cmax) + dp3) +
                    0x1p-21 * fmax(fabs(static_cast<double>(d1)), fabs(static_cast<double>(d2))));
  return !(static_cast<double>(d2) - static_cast<double>(d1) > 2.0 * e);
}

// Labels of rows [blockIdx.x * rows, +rows), rows = 128 MT, by the split
// product.  Each warp owns MT m-tiles of 16 rows, their split A fragments
// (bf16) in registers.  The packed centroids stream through two shared
// buffers of kt centroids (tile kb + 1 copied by cp.async while tile kb is
// used); for each pair of n-tiles (16 centroids), KS mma.sync per m-tile
// and n-tile form the split x.c, then d = ||c||^2 - 2 x.c enters each
// row's running top two in ascending centroid order.  After the last tile
// the four threads of a row merge their top twos, one writes the label,
// and a row in doubt (assign_listed) is appended to amb_rows for
// assign_recheck_kernel.
template <int KS>
__global__ void __launch_bounds__(kAsThreads)
assign_labels_tc_kernel(const float* __restrict__ x, const uint32_t* __restrict__ cwg,
                        const float* __restrict__ c2g,
                        const unsigned long long* __restrict__ cmax2, int* __restrict__ labels,
                        int* __restrict__ amb_rows, int* __restrict__ amb_count, int N, int D,
                        int K, int kt) {
  constexpr int MT = as_mt(KS);
  constexpr int kStride = as_stride(KS);
  extern __shared__ __align__(16) uint32_t tsm[];
  const int tile_words = kt * kStride;
  uint32_t* cw = tsm;                                                // [2][kt][kStride]
  float* c2s = reinterpret_cast<float*>(tsm + 2 * tile_words);       // [2][kt]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row (and centroid) of the fragments within a tile
  const int t = lane % 4;  // column pair of the fragments
  const int ntiles = (K + kt - 1) / kt;

  // copy tile kb (words and norms) into buffer kb & 1, one pipeline stage
  auto stage = [&](int kb) {
    const uint32_t* src = cwg + static_cast<size_t>(kb) * tile_words;
    uint32_t* dst = cw + (kb & 1) * tile_words;
    for (int i = threadIdx.x * 4; i < tile_words; i += kAsThreads * 4) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
    const float* csrc = c2g + static_cast<size_t>(kb) * kt;
    float* cdst = c2s + (kb & 1) * kt;
    for (int i = threadIdx.x * 4; i < kt; i += kAsThreads * 4) {
      __pipeline_memcpy_async(cdst + i, csrc + i, 16);
    }
    __pipeline_commit();
  };
  stage(0);

  // A fragments of rows r0 + 16 m + g (h = 0) and + 8 (h = 1), and their
  // ||x|| (f64 sum of squares over the quad, rounded up to f32)
  const int r0 = blockIdx.x * (kAsWarps * 16 * MT) + warp * 16 * MT;
  uint32_t a[MT][KS][4];
  float xn[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * m + 8 * h + g;
      const bool ok = r < N;
      const float* xr = x + static_cast<size_t>(ok ? r : 0) * D;
      double s = 0.0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int q = 16 * ks + 8 * hk + 2 * t;
          const float v0 = ok ? split_col(xr, q, D, false) : 0.f;
          const float v1 = ok ? split_col(xr, q + 1, D, false) : 0.f;
          a[m][ks][2 * hk + h] = pack_bf16(v0, v1);
          if (ok && q < D) s = fma(static_cast<double>(xr[q]), static_cast<double>(xr[q]), s);
          if (ok && q + 1 < D) {
            s = fma(static_cast<double>(xr[q + 1]), static_cast<double>(xr[q + 1]), s);
          }
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      xn[m][h] = __double2float_ru(sqrt(s));
    }
  }

  float d1[MT][2], d2[MT][2];
  int i1[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d1[m][h] = d2[m][h] = CUDART_INF_F;
      i1[m][h] = 0;
    }
  }
  for (int kb = 0; kb < ntiles; ++kb) {
    if (kb + 1 < ntiles) {
      stage(kb + 1);
      __pipeline_wait_prior(1);  // this thread's copies of tile kb are in
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // and every thread's
    const uint32_t* cwb = cw + (kb & 1) * tile_words;
    const float* c2b = c2s + (kb & 1) * kt;
    const int j0 = kb * kt;
    const int npairs = (min(kt, K - j0) + 15) / 16;
    for (int np = 0; np < npairs; ++np) {
      // words 2t, 2t + 1 of each k-step of centroids g and g + 8 of the pair
      const uint32_t* b0 = cwb + (np * 16 + g) * kStride + 2 * t;
      const uint32_t* b1 = b0 + 8 * kStride;
      float acc[MT][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint2 w0 = *reinterpret_cast<const uint2*>(b0 + ks * 8);
        const uint2 w1 = *reinterpret_cast<const uint2*>(b1 + ks * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][0], a[m][ks], w0.x, w0.y);
          mma_bf16(acc[m][1], a[m][ks], w1.x, w1.y);
        }
      }
      const float2 ca = *reinterpret_cast<const float2*>(c2b + np * 16 + 2 * t);
      const float2 cb = *reinterpret_cast<const float2*>(c2b + np * 16 + 8 + 2 * t);
      const int j = j0 + np * 16 + 2 * t;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // d = c2 - 2 acc, one rounding (2 acc is exact), centroids ascending
          top2(d1[m][h], d2[m][h], i1[m][h], fmaf(-2.f, acc[m][0][2 * h], ca.x), j);
          top2(d1[m][h], d2[m][h], i1[m][h], fmaf(-2.f, acc[m][0][2 * h + 1], ca.y), j + 1);
          top2(d1[m][h], d2[m][h], i1[m][h], fmaf(-2.f, acc[m][1][2 * h], cb.x), j + 8);
          top2(d1[m][h], d2[m][h], i1[m][h], fmaf(-2.f, acc[m][1][2 * h + 1], cb.y), j + 9);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer kb & 1 before it is refilled
  }

  const double cmax = sqrt(__longlong_as_double(static_cast<long long>(*cmax2)));
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      top2_quad(d1[m][h], d2[m][h], i1[m][h]);
      const int r = r0 + 16 * m + 8 * h + g;
      if (t != h || r >= N) continue;  // one thread of the quad writes
      labels[r] = i1[m][h];
      if (K > 1 && assign_listed(d1[m][h], d2[m][h], xn[m][h], cmax, D, 16 * KS)) {
        amb_rows[atomicAdd(amb_count, 1)] = r;
      }
    }
  }
}

// Row stride of a staged f32 centroid of the re-check: D rounded up to 4,
// then to 4 mod 8 words, so that the 128-bit loads of 8 lanes fall in
// distinct bank quads.
__host__ __device__ inline int rc_stride(int D) {
  const int s = round_up(D, 4);
  return s % 8 ? s : s + 4;
}

// The exact labels of the rows that assign_labels_tc_kernel listed: block
// b stages the f32 centroids tile by tile (cp.async, rows of rc_stride(D)
// words, zero from D on), with c2 from the pack.  Warp w takes kRcRows
// listed rows at a time, from (8 b + w) kRcRows on in steps of 8 gridDim.x
// kRcRows; each lane takes centroids jj and jj + 32 at a time, so that a
// centroid value loaded from shared memory feeds kRcRows chains and a row
// value kRcCols; each chain is the sequential f32 FMA chain over d = 0,
// 1, ... of the f32 values (the padded dimensions add fmaf(0, 0, s), as
// nearest_pass_kernel's do), d = c2 - 2 x.c, and a warp argmin keeps the
// lower index on ties.  Across tiles each row's minimum so far waits in
// best_d / best_i (an earlier tile keeps a tie).
constexpr int kRcRows = 4;  // listed rows a warp re-checks at once
constexpr int kRcCols = 2;  // centroids a lane takes at once
__global__ void __launch_bounds__(kAsThreads)
assign_recheck_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const float* __restrict__ c2g, const int* __restrict__ amb_rows,
                      const int* __restrict__ amb_count, int* __restrict__ labels,
                      float* __restrict__ best_d, int* __restrict__ best_i, int D, int K, int kt) {
  const int count = *amb_count;
  const int stride_rows = gridDim.x * kAsWarps * kRcRows;
  if (static_cast<int>(blockIdx.x) * kAsWarps * kRcRows >= count) return;  // nothing listed for it
  const int cs = rc_stride(D);
  const int dp = round_up(D, 4);
  extern __shared__ __align__(16) float fsm[];
  float* cf = fsm;                          // [kt][cs]
  float* c2s = cf + kt * cs;                // [kt]
  float* xw = c2s + round_up(kt, 4);        // [kAsWarps][kRcRows][dp]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* xs = xw + warp * kRcRows * dp;
  for (int i = threadIdx.x; i < kt * (dp - D); i += kAsThreads) {  // the padded dimensions
    const int j = i / (dp - D);
    cf[j * cs + D + (i - j * (dp - D))] = 0.f;
  }
  const int ntiles = (K + kt - 1) / kt;
  for (int kb = 0; kb < ntiles; ++kb) {
    const int j0 = kb * kt;
    const int jn = min(kt, K - j0);
    __syncthreads();  // every warp is done with the previous tile
    const float* src = c + static_cast<size_t>(j0) * D;
    for (int i = threadIdx.x; i < jn * D; i += kAsThreads) {
      const int j = i / D;
      __pipeline_memcpy_async(cf + j * cs + (i - j * D), src + i, sizeof(float));
    }
    for (int i = threadIdx.x; i < jn; i += kAsThreads) {
      __pipeline_memcpy_async(c2s + i, c2g + j0 + i, sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int e0 = (blockIdx.x * kAsWarps + warp) * kRcRows; e0 < count; e0 += stride_rows) {
      const int nr = min(kRcRows, count - e0);
      for (int i = lane; i < kRcRows * dp; i += 32) {
        const int q = i / dp;
        const int d = i - q * dp;
        xs[i] = q < nr && d < D ? x[static_cast<size_t>(amb_rows[e0 + q]) * D + d] : 0.f;
      }
      __syncwarp();
      float best[kRcRows];
      int bi[kRcRows];
#pragma unroll
      for (int q = 0; q < kRcRows; ++q) {
        best[q] = CUDART_INF_F;
        bi[q] = 0;
      }
      for (int jj = lane; jj < jn; jj += 32 * kRcCols) {
        const bool has1 = jj + 32 < jn;
        const float* cj0 = cf + jj * cs;
        const float* cj1 = has1 ? cj0 + 32 * cs : cj0;
        float s[kRcRows][kRcCols] = {};
        for (int d = 0; d < dp; d += 4) {
          const float4 ca = *reinterpret_cast<const float4*>(cj0 + d);
          const float4 cb = *reinterpret_cast<const float4*>(cj1 + d);
#pragma unroll
          for (int q = 0; q < kRcRows; ++q) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + q * dp + d);
            s[q][0] = fmaf(xv.x, ca.x, s[q][0]);
            s[q][1] = fmaf(xv.x, cb.x, s[q][1]);
            s[q][0] = fmaf(xv.y, ca.y, s[q][0]);
            s[q][1] = fmaf(xv.y, cb.y, s[q][1]);
            s[q][0] = fmaf(xv.z, ca.z, s[q][0]);
            s[q][1] = fmaf(xv.z, cb.z, s[q][1]);
            s[q][0] = fmaf(xv.w, ca.w, s[q][0]);
            s[q][1] = fmaf(xv.w, cb.w, s[q][1]);
          }
        }
        // a lane's centroids in ascending order; strict: the earlier keeps a tie
#pragma unroll
        for (int q = 0; q < kRcRows; ++q) {
          const float da = __fsub_rn(c2s[jj], __fmul_rn(2.f, s[q][0]));
          if (da < best[q]) { best[q] = da; bi[q] = j0 + jj; }
          if (has1) {
            const float db = __fsub_rn(c2s[jj + 32], __fmul_rn(2.f, s[q][1]));
            if (db < best[q]) { best[q] = db; bi[q] = j0 + jj + 32; }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRcRows; ++q) {
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best[q], m);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[q], m);
          if (ob < best[q] || (ob == best[q] && oi < bi[q])) { best[q] = ob; bi[q] = oi; }
        }
      }
      if (lane < nr) {
        float bq = best[0];
        int iq = bi[0];
#pragma unroll
        for (int q = 1; q < kRcRows; ++q) {
          if (lane == q) { bq = best[q]; iq = bi[q]; }
        }
        const int e = e0 + lane;
        if (kb > 0) {  // the earlier tiles' minimum keeps a tie
          const float pb = best_d[e];
          const int pi = best_i[e];
          if (!(bq < pb)) { bq = pb; iq = pi; }
        }
        if (kb + 1 < ntiles) {
          best_d[e] = bq;
          best_i[e] = iq;
        } else {
          labels[amb_rows[e]] = iq;
        }
      }
      __syncwarp();  // xs is consumed
    }
  }
}

// Shapes of one K3 launch on the tensor-core route.
struct AssignPlan {
  int ks = 0;      // k-steps of the split product
  int stride = 0;  // words of a packed centroid
  int kt = 0;      // centroids of a labels tile (a multiple of 16)
  int kp = 0;      // packed centroid slots: K rounded up to kt
  int kt_r = 0;    // centroids of a re-check tile
  size_t smem = 0, rsmem = 0;
};

AssignPlan plan_assign(int D, int K) {
  AssignPlan p;
  p.ks = as_ks(D);
  p.stride = as_stride(p.ks);
  const size_t per = static_cast<size_t>(p.stride) * sizeof(uint32_t) + sizeof(float);
  const int cap = std::max(16, static_cast<int>(kAsTileBudget / (2 * per)) / 16 * 16);
  p.kt = std::min(round_up(K, 16), cap);
  p.kp = round_up(K, p.kt);
  p.smem = 2 * p.kt * per;
  const size_t rper = static_cast<size_t>(rc_stride(D) + 1) * sizeof(float);
  const size_t xbytes = static_cast<size_t>(kAsWarps) * kRcRows * round_up(D, 4) * sizeof(float);
  p.kt_r = std::min(K, static_cast<int>((kAsRecheckBudget - xbytes) / rper) / 4 * 4);
  p.rsmem = (static_cast<size_t>(p.kt_r) * rc_stride(D) + round_up(p.kt_r, 4)) * sizeof(float) +
            xbytes;
  return p;
}

template <int KS>
int launch_assign_tc(const float* x, const uint32_t* cw, const float* c2,
                     const unsigned long long* cmax2, int* labels, int* amb_rows, int* amb_count,
                     int N, int D, int K, int kt, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(assign_labels_tc_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int rows = kAsWarps * 16 * as_mt(KS);
  const int nblocks = static_cast<int>((static_cast<long long>(N) + rows - 1) / rows);
  assign_labels_tc_kernel<KS><<<nblocks, kAsThreads, smem, stream>>>(
      x, cw, c2, cmax2, labels, amb_rows, amb_count, N, D, K, kt);
  return static_cast<int>(cudaGetLastError());
}

// K3 at D <= 128: pack, tensor-core labels, exact re-check of the listed
// rows (amb_count is zeroed by the caller).
int assign_tc(const float* x, const float* c, int* labels, int* scratch, int* amb_count, int N,
              int D, int K, cudaStream_t stream) {
  const AssignPlan p = plan_assign(D, K);
  const size_t packed = static_cast<size_t>(p.kp) * p.stride;
  uint32_t* cw = reinterpret_cast<uint32_t*>(scratch);
  float* c2 = reinterpret_cast<float*>(scratch + packed);
  auto* cmax2 = reinterpret_cast<unsigned long long*>(scratch + packed + p.kp);
  int* amb_rows = scratch + packed + p.kp + 2;
  float* best_d = reinterpret_cast<float*>(amb_rows + N);
  int* best_i = amb_rows + 2 * static_cast<size_t>(N);
  cudaError_t err = cudaMemsetAsync(cmax2, 0, sizeof(*cmax2), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pblocks = static_cast<int>((packed + 255) / 256);
  assign_pack_kernel<<<pblocks, 256, 0, stream>>>(c, cw, c2, cmax2, D, K, p.kp, p.ks, p.stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Launch = int (*)(const float*, const uint32_t*, const float*, const unsigned long long*,
                         int*, int*, int*, int, int, int, int, size_t, cudaStream_t);
  // one instance per k-step count: D up to 5, 10, 16, ..., 128
  constexpr Launch kLaunch[] = {
      launch_assign_tc<1>,  launch_assign_tc<2>,  launch_assign_tc<3>,  launch_assign_tc<4>,
      launch_assign_tc<5>,  launch_assign_tc<6>,  launch_assign_tc<7>,  launch_assign_tc<8>,
      launch_assign_tc<9>,  launch_assign_tc<10>, launch_assign_tc<11>, launch_assign_tc<12>,
      launch_assign_tc<13>, launch_assign_tc<14>, launch_assign_tc<15>, launch_assign_tc<16>,
      launch_assign_tc<17>, launch_assign_tc<18>, launch_assign_tc<19>, launch_assign_tc<20>,
      launch_assign_tc<21>, launch_assign_tc<22>, launch_assign_tc<23>, launch_assign_tc<24>};
  const int lerr = kLaunch[p.ks - 1](x, cw, c2, cmax2, labels, amb_rows, amb_count, N, D, K, p.kt,
                                     p.smem, stream);
  if (lerr != 0) return lerr;
  err = cudaFuncSetAttribute(assign_recheck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.rsmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_recheck_kernel<<<kAsRecheckBlocks, kAsThreads, p.rsmem, stream>>>(
      x, c, c2, amb_rows, amb_count, labels, best_d, best_i, D, K, p.kt_r);
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

// Scratch of a K3 launch, in int32 words: on the tensor-core route the
// packed centroids [kp * stride], c2 [kp], the largest ||c||^2 (f64, 2
// words), then the listed rows, best_d and best_i [N] each; none above
// D = 128.
extern "C" int kmeans_assign_scratch(int N, int D, int K, long long* words) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AssignPlan p = plan_assign(D, K);
  *words = D > kTcMaxD ? 0 : static_cast<long long>(p.kp) * p.stride + p.kp + 2 + 3LL * N;
  return 0;
}

// K3.  x [N, D], c [K, D] f32 -> labels [N] i32; scratch of
// kmeans_assign_scratch's words; amb_count [1] i32, the rows re-checked
// exactly.  D <= 128 takes the split tensor-core pass and its re-check;
// wider rows the CUDA-core FMA-chain pass.  Returns cudaGetLastError()
// after the launches.
extern "C" int kmeans_assign(const float* x, const float* c, int* labels, int* scratch,
                             int* amb_count, int N, int D, int K, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(amb_count, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D <= kTcMaxD) return assign_tc(x, c, labels, scratch, amb_count, N, D, K, s);
  return launch_nearest<false>(x, c, nullptr, labels, nullptr, 1, N, D, K, 0, s);
}
