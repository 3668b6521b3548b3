// K-Means on Hopper (sm_90a): kernels K2 (fused Lloyd step) and K3
// (assign), with a plain C interface for ctypes.  K4 (update) lives in
// kmeans_update.cu.
//
// Replaces the Pallas TPU kernels of gsconverter_tpu/ops/kmeans.py:
//   K2 kmeans_lloyd  <- _lloyd_kernel  (launched by _lloyd_pallas)
//   K3 kmeans_assign <- _assign_kernel (launched by _assign_pallas)
//
// Same functions, same numbers as the TPU kernels:
//   d[r, j] = ||c_j||^2 - 2 * x_r . c_j, with ||c_j||^2 from the f32
//   centroids; label = the first argmin over j (the lowest index wins every
//   tie, across centroid tiles too); in bf16 mode x and c are rounded to
//   bf16 (nearest even) before the product, the products are exact in f32
//   and summed in f32, and the segment sums add up the bf16-rounded x;
//   K2's sums and counts take only rows r < n_valid of each chunk.  Both
//   kernels take any K and rows of D <= 2048 values.
//
// K2 is batched over independent problems ("chunks"): x [C, P, D],
// c [C, K, D], n_valid [C] -> labels [C, P], sums [C, K, D], counts [C, K].
// One call runs every chunk of a Lloyd step, where the TPU runs one
// pallas_call per chunk.
//
// What bounds it here.  The TPU kernel runs both products (x.c^T and
// one-hot^T.x) on its matrix unit with the whole centroid set resident in
// VMEM.  These kernels are the simple first version: CUDA-core FMAs, no
// tensor cores.  K2 and K3 are bound by FP32 FMA throughput (N * K * D FMAs for
// the distances; the bf16 mode costs the same here, since the rounded
// values are multiplied in f32).  Design:
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
//     time left a block waiting on memory for about a quarter of K2;
//   - deterministic sums without float atomics: the rows of a chunk are
//     cut into `nsplit` contiguous ranges, one block each; within a block,
//     centroid j is owned by warp j % 8, whose lanes (one per dimension)
//     add the rows labelled j in ascending row order into the block's own
//     sums, kept in shared memory when they fit beside the x tile and all
//     centroids (SOG's level 10, K = 64 at D = 24) and in the block's slice
//     of the global partial-sum buffer otherwise (level 1, K = 1024); a
//     second kernel adds the slices in split order.  Two launches on the
//     same input give bit-identical labels, sums and counts;
//   - each chunk's rows are split over as many blocks as the card holds
//     at once (kmeans_resident_blocks), so a launch is one wave.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;         // threads per block
constexpr int kTileRows = 512;        // most rows per x tile: two per thread
constexpr int kMinTileRows = 8;       // fewest rows per x tile (the widest rows)
constexpr int kWarps = kThreads / 32;
constexpr int kJ = 16;                // centroids per register tile
constexpr int kLoads = 8;             // loads a thread issues before it stores
constexpr int kMaxD = 2048;           // widest rows: 8 rows and 16 centroids fit
constexpr size_t kCentBudget = 160 * 1024;  // shared bytes for one centroid tile
constexpr size_t kSmemLimit = 232448;       // 227 KB: a Hopper block's most
// shared bytes beside the tiles: the row labels [kTileRows], and each
// thread's (distance, index) minimum [kThreads] for the cross-thread argmin
constexpr size_t kFixedBytes = (kTileRows + 2 * kThreads) * sizeof(int);

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

// Warp j % kWarps owns centroid j: its lanes (one per dimension) add the
// tile's rows labelled j, in ascending row order, to acc[j], and lane 0
// counts them.  acc and cnt lie in shared or in global memory.
__device__ __forceinline__ void accumulate_tile(const float* __restrict__ xs, int xstride,
                                                const int* __restrict__ lab_s,
                                                int nrows, int D, float* acc, int* cnt) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < nrows; ++r) {
    const int j = lab_s[r];
    if (j >= 0 && j % kWarps == warp) {  // uniform over the warp
      float* dst = acc + static_cast<size_t>(j) * D;
      for (int d = lane; d < D; d += 32) dst[d] = __fadd_rn(dst[d], xs[d * xstride + r]);
      if (lane == 0) cnt[j] += 1;
    }
  }
}

__device__ __forceinline__ void zero_sums(float* acc, int* cnt, int K, int D) {
  const size_t kd = static_cast<size_t>(K) * D;
  for (size_t i = threadIdx.x; i < kd; i += kThreads) acc[i] = 0.f;
  for (int j = threadIdx.x; j < K; j += kThreads) cnt[j] = 0;
}

// After the last tile: the block's shared-memory sums to its global slice.
__device__ __forceinline__ void store_sums(const float* acc, const int* cnt,
                                           float* __restrict__ ps, int* __restrict__ pc,
                                           int K, int D) {
  __syncthreads();
  const size_t kd = static_cast<size_t>(K) * D;
  for (size_t i = threadIdx.x; i < kd; i += kThreads) ps[i] = acc[i];
  for (int j = threadIdx.x; j < K; j += kThreads) pc[j] = cnt[j];
}

// Labels of every row of chunk blockIdx.y in rows [split * rps, +rps);
// with kSums, also the block's partial sums and counts of rows < n_valid.
// Tiles of tr rows; kRows = 2 for tr = 512 (thread t owns rows t and
// t + 256), else 1 (thread t works on row t % tr, centroid group t / tr).
template <bool kSums, int kRows>
__global__ void __launch_bounds__(kThreads)
nearest_pass_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const int* __restrict__ n_valid, int* __restrict__ labels,
                    float* __restrict__ psums, int* __restrict__ pcounts,
                    int P, int D, int K, int dp, int tr_arg, int kt, int nsplit, int rps,
                    int bf16, int smem_sums) {
  extern __shared__ __align__(16) float smem[];
  // compile-time tile geometry for the 512-row tile (rows, stride, threads
  // per row), which the shared-memory addressing folds in
  const int tr = kRows == 2 ? kTileRows : tr_arg;
  const int xstride = tr + 1;
  float* xs = smem;                                              // [dp][tr + 1]
  float* cs = xs + dp * xstride;                                 // [kt][dp]
  float* c2s = cs + static_cast<size_t>(kt) * dp;                // [kt]
  int* lab_s = reinterpret_cast<int*>(c2s + kt);                 // [kTileRows]
  float* best_s = reinterpret_cast<float*>(lab_s + kTileRows);   // [kThreads]
  int* idx_s = reinterpret_cast<int*>(best_s + kThreads);        // [kThreads]
  float* sums_s = reinterpret_cast<float*>(idx_s + kThreads);    // [K][D] if smem_sums
  int* cnt_s = reinterpret_cast<int*>(sums_s + static_cast<size_t>(K) * D);  // [K]

  const int chunk = blockIdx.y;
  const int split = blockIdx.x;
  const int t = threadIdx.x;
  const int slots = kRows == 2 ? kThreads : row_slots(tr);
  const int groups = kRows == 2 ? 1 : kThreads / slots;  // threads per row
  const int slot = kRows == 2 ? t : t % slots;
  const int grp = kRows == 2 ? 0 : t / slots;
  const float* xc = x + static_cast<size_t>(chunk) * P * D;
  const float* cc = c + static_cast<size_t>(chunk) * K * D;
  const int row_begin = split * rps;
  const int row_end = min(P, row_begin + rps);
  float* ps = nullptr;
  int* pc = nullptr;
  float* acc = nullptr;
  int* cnt = nullptr;
  int nv = 0;
  if (kSums) {
    const size_t slice = static_cast<size_t>(chunk) * nsplit + split;
    ps = psums + slice * K * D;
    pc = pcounts + slice * K;
    acc = smem_sums ? sums_s : ps;
    cnt = smem_sums ? cnt_s : pc;
    nv = n_valid[chunk];
    zero_sums(acc, cnt, K, D);
  }

  const int ntiles_k = (K + kt - 1) / kt;
  int loaded = -1;
  for (int r0 = row_begin; r0 < row_end; r0 += tr) {
    const int nrows = min(tr, row_end - r0);
    __syncthreads();  // the previous tile's xs, lab_s and minima are consumed
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
      int* lab_out = labels + static_cast<size_t>(chunk) * P + r0;
      if (slot < nrows) lab_out[slot] = bi0;
      if (kRows == 2 && slot + kThreads < nrows) lab_out[slot + kThreads] = bi1;
      if (kSums) {
        lab_s[slot] = (slot < nrows && r0 + slot < nv) ? bi0 : -1;
        if (kRows == 2) {
          const int r1 = slot + kThreads;
          lab_s[r1] = (r1 < nrows && r0 + r1 < nv) ? bi1 : -1;
        }
      }
    }
    if (kSums) {
      __syncthreads();
      accumulate_tile(xs, xstride, lab_s, nrows, D, acc, cnt);
    }
  }
  if (kSums && smem_sums) store_sums(acc, cnt, ps, pc, K, D);
}

// sums[c, j, d] = sum over s = 0, 1, ... of psums[c, s, j, d], in that order.
__global__ void reduce_partials_kernel(const float* __restrict__ psums,
                                       const int* __restrict__ pcounts,
                                       float* __restrict__ sums, float* __restrict__ counts,
                                       int C, int nsplit, int K, int D) {
  const size_t kd = static_cast<size_t>(K) * D;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = first; i < static_cast<size_t>(C) * kd; i += stride) {
    const size_t ch = i / kd;
    const float* p = psums + ch * nsplit * kd + (i - ch * kd);
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s = __fadd_rn(s, p[sp * kd]);
    sums[i] = s;
  }
  for (size_t i = first; i < static_cast<size_t>(C) * K; i += stride) {
    const size_t ch = i / K;
    const int* p = pcounts + ch * nsplit * K + (i - ch * K);
    int s = 0;
    for (int sp = 0; sp < nsplit; ++sp) s += p[static_cast<size_t>(sp) * K];
    counts[i] = static_cast<float>(s);
  }
}

size_t x_tile_bytes(int dp, int tr) {
  return static_cast<size_t>(dp) * (tr + 1) * sizeof(float) + kFixedBytes;
}

size_t sums_bytes(int K, int D) {
  return static_cast<size_t>(K) * D * sizeof(float) + static_cast<size_t>(K) * sizeof(int);
}

size_t cent_bytes(int kt, int dp) {
  return static_cast<size_t>(kt) * (dp + 1) * sizeof(float);
}

// Shared-memory layout of one launch: rows per x tile, centroids per
// centroid tile, and whether the block's sums live in shared memory.
struct Plan {
  int tr = 0;
  int kt = 0;
  bool smem_sums = false;
  size_t smem = 0;
};

// The nearest pass (K2 with sums, K3 without): the most rows per x tile
// (512, 256, ..., 8) that leave room for kJ centroids; sums in shared
// memory only when every centroid stays resident beside them, since
// reloading centroid tiles for every row tile costs more than global sums.
// False when even 8 rows and kJ centroids do not fit.
bool plan_nearest(bool sums, int D, int K, Plan* p) {
  const int dp = round_up(D, 4);
  const int kpad = round_up(K, kJ);
  for (int tr = kTileRows; tr >= kMinTileRows; tr /= 2) {
    const size_t xb = x_tile_bytes(dp, tr);
    if (xb + cent_bytes(kJ, dp) > kSmemLimit) continue;
    p->tr = tr;
    p->smem_sums = sums && xb + sums_bytes(K, D) + cent_bytes(kpad, dp) <= kSmemLimit;
    const size_t reserved = xb + (p->smem_sums ? sums_bytes(K, D) : 0);
    const size_t budget = std::min(kSmemLimit - reserved, kCentBudget);
    const int cap = static_cast<int>(budget / (sizeof(float) * (dp + 1))) / kJ * kJ;
    p->kt = std::min(kpad, cap);
    p->smem = reserved + cent_bytes(p->kt, dp);
    return p->kt >= kJ && p->smem <= kSmemLimit;
  }
  return false;
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem);
  }
  return static_cast<int>(err);
}

template <bool kSums>
int launch_nearest(const float* x, const float* c, const int* n_valid, int* labels,
                   float* psums, int* pcounts, int C, int P, int D, int K, int nsplit,
                   int rps, int bf16, cudaStream_t stream) {
  Plan p;
  if (!plan_nearest(kSums, D, K, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const int dp = round_up(D, 4);
  auto kernel = p.tr == kTileRows ? nearest_pass_kernel<kSums, 2> : nearest_pass_kernel<kSums, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nsplit, C), kThreads, p.smem, stream>>>(
      x, c, n_valid, labels, psums, pcounts, P, D, K, dp, p.tr, p.kt, nsplit, rps, bf16,
      p.smem_sums ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int launch_reduce(const float* psums, const int* pcounts, float* sums, float* counts,
                  int C, int nsplit, int K, int D, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(C) * K * D;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 132 * 16));
  reduce_partials_kernel<<<blocks, 256, 0, stream>>>(psums, pcounts, sums, counts, C,
                                                    nsplit, K, D);
  return static_cast<int>(cudaGetLastError());
}

bool bad_split(int rows, int nsplit, int rps) {
  return nsplit <= 0 || rps <= 0 || rps % kTileRows != 0 ||
         static_cast<long long>(nsplit) * rps < rows ||
         static_cast<long long>(nsplit - 1) * rps >= rows;
}

}  // namespace

// K2.  x [C, P, D], c [C, K, D] f32; n_valid [C] i32; labels [C, P] i32;
// sums [C, K, D], counts [C, K] f32; scratch psums [C, nsplit, K, D] f32 and
// pcounts [C, nsplit, K] i32.  Rows split into nsplit ranges of rps rows
// (a multiple of 512).  Returns cudaGetLastError() after the launches.
extern "C" int kmeans_lloyd(const float* x, const float* c, const int* n_valid,
                            int* labels, float* sums, float* counts, float* psums,
                            int* pcounts, int C, int P, int D, int K, int nsplit,
                            int rps, int bf16, void* stream) {
  if (C <= 0 || P <= 0 || D <= 0 || D > kMaxD || K <= 0 || bad_split(P, nsplit, rps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_nearest<true>(x, c, n_valid, labels, psums, pcounts, C, P, D,
                                       K, nsplit, rps, bf16, s);
  if (err != 0) return err;
  return launch_reduce(psums, pcounts, sums, counts, C, nsplit, K, D, s);
}

// K3.  x [N, D], c [K, D] f32 -> labels [N] i32.
extern "C" int kmeans_assign(const float* x, const float* c, int* labels, int N, int D,
                             int K, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD || K <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblocks = (N + kTileRows - 1) / kTileRows;
  return launch_nearest<false>(x, c, nullptr, labels, nullptr, nullptr, 1, N, D, K,
                               nblocks, kTileRows, 0, static_cast<cudaStream_t>(stream));
}

// Blocks of one K2 launch that the card holds at once: the occupancy of
// its shared-memory footprint times the SMs.  The caller splits each
// chunk's rows over about that many blocks in all, so that one wave covers
// the launch.
extern "C" int kmeans_resident_blocks(int D, int K, int* blocks) {
  Plan p;
  if (D <= 0 || D > kMaxD || K <= 0 || !plan_nearest(true, D, K, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int per_sm = 0, device = 0, sms = 0;
  int err = p.tr == kTileRows ? blocks_per_sm(nearest_pass_kernel<true, 2>, p.smem, &per_sm)
                              : blocks_per_sm(nearest_pass_kernel<true, 1>, p.smem, &per_sm);
  if (err != 0) return err;
  err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  *blocks = per_sm * sms;
  return err;
}
