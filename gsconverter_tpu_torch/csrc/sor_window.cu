// SOR Morton-window mean-KNN distance on Hopper (sm_90a).
//
// Replaces gsconverter_tpu/ops/sor.py::_window_md_kernel (the Pallas TPU
// kernel launched by _sor_window_loop_pallas).  Same function, same numbers:
// for every point of a 512-point block of Morton-sorted positions, the
// candidates are the contiguous rows [block_start - window,
// block_start + 512 + window); rows outside [0, n) read as PAD_POS.
//   d = sqrt((t0*t0 + t1*t1) + t2*t2), t = c - x, in f32 in that order;
//   a pair is valid iff 1e-6 < d < 1e12; valid d is rounded to bf16 and
//   back before every compare and sum, invalid d is +inf;
//   the k-th-neighbour radius is bracketed by [0, hi], hi = max over the
//   middle block when it holds >= k valid candidates, else the max of all,
//   and narrowed by `iters` bisection steps;
//   md = (sum(d <= lo) + (k - count(d <= lo)) * (lo + hi) / 2) / k, or
//   (sum(d) + (k - count) * dmax) / k with fewer than k valid candidates.
//
// What bounds it here: FP32 ALU and SFU work, not memory.  Each point reads
// 12 B and writes 4 B, but evaluates (512 + 2*window) candidates in each of
// iters + 2 passes.  The TPU kernel keeps the [512 + 2w, 512] bf16 distance
// matrix resident in VMEM (1 MB at w = 256); that is far above the 227 KB
// of shared memory a Hopper block may use, so this kernel stages only the
// block's candidate positions in shared memory (at most 1536 x 12 B) and
// recomputes the distances in every pass instead of storing them.  One
// thread owns one point; every thread of a warp reads the same candidate
// at the same time, a shared-memory broadcast without bank conflicts.
//
// Rounding: the distance and the final formulas use the _rn intrinsics so
// that nvcc cannot contract them into FMAs, and sqrt is IEEE-rounded;
// that keeps d bit-identical to the plain PyTorch version, so both take
// the same bisection steps and differ only by the order of the f32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 512;       // points per block (the TPU kernel's lane tile)
constexpr int kMaxWindow = 512;   // window must divide kBlock
constexpr float kPadPos = 1e15f;  // sentinel coordinate of padded rows
constexpr float kValidMax = 1e12f;
constexpr float kValidMin = 1e-6f;

// Distance from point (x, y, z) to candidate c, rounded to bf16 and back;
// +inf for self/duplicate pairs and for pad sentinels.
__device__ __forceinline__ float cand_dist(const float* __restrict__ cx,
                                           const float* __restrict__ cy,
                                           const float* __restrict__ cz,
                                           int c, float x, float y, float z) {
  const float t0 = __fsub_rn(cx[c], x);
  const float t1 = __fsub_rn(cy[c], y);
  const float t2 = __fsub_rn(cz[c], z);
  const float acc = __fadd_rn(__fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1)),
                              __fmul_rn(t2, t2));
  const float d = __fsqrt_rn(acc);
  if (d > kValidMin && d < kValidMax) {
    return __bfloat162float(__float2bfloat16_rn(d));
  }
  return CUDART_INF_F;
}

__global__ void __launch_bounds__(kBlock)
sor_window_md_kernel(const float* __restrict__ spos, float* __restrict__ md,
                     int n, int k, int window, int iters) {
  __shared__ float cand[3 * (kBlock + 2 * kMaxWindow)];
  const int cw = kBlock + 2 * window;
  float* cx = cand;
  float* cy = cand + cw;
  float* cz = cand + 2 * cw;

  // Stage the candidate rows as x/y/z planes: one coalesced linear read of
  // the [cw, 3] slab, out-of-range rows as PAD_POS.
  const long long first = (static_cast<long long>(blockIdx.x) * kBlock - window) * 3;
  const long long total = static_cast<long long>(n) * 3;
  for (int i = threadIdx.x; i < 3 * cw; i += kBlock) {
    const long long g = first + i;
    const float v = (g >= 0 && g < total) ? spos[g] : kPadPos;
    cand[(i % 3) * cw + i / 3] = v;
  }
  __syncthreads();

  const int me = window + threadIdx.x;
  const float x = cx[me], y = cy[me], z = cz[me];

  // Pass 1: count, sum and max over all candidates, and count and max over
  // the middle block [window, window + 512).
  int cntv = 0, cntm = 0;
  float sumv = 0.f, dmax = 0.f, hmid = 0.f;
  for (int c = 0; c < cw; ++c) {
    const float v = cand_dist(cx, cy, cz, c, x, y, z);
    const bool fin = v < kValidMax;
    const float dz = fin ? v : 0.f;
    cntv += fin;
    sumv = __fadd_rn(sumv, dz);
    dmax = fmaxf(dmax, dz);
    if (c >= window && c < window + kBlock) {
      cntm += fin;
      hmid = fmaxf(hmid, dz);
    }
  }

  // Bisection for the k-th-neighbour radius.
  // Invariant: count(d <= lo) < k <= count(d <= hi) whenever cntv >= k.
  float hi = (cntm >= k) ? hmid : dmax;
  float lo = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
    for (int c = 0; c < cw; ++c) {
      cnt += cand_dist(cx, cy, cz, c, x, y, z) <= mid;
    }
    if (cnt >= k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }

  // Final pass: count and sum of the candidates at or below lo.
  int cl = 0;
  float sl = 0.f;
  for (int c = 0; c < cw; ++c) {
    const float v = cand_dist(cx, cy, cz, c, x, y, z);
    if (v <= lo) {
      ++cl;
      sl = __fadd_rn(sl, v);
    }
  }

  const float kf = static_cast<float>(k);
  float out;
  if (cntv >= k) {
    // neighbours between lo and the k-th radius all sit within [lo, hi]
    const float fill = __fmul_rn(__fmul_rn(__fsub_rn(kf, static_cast<float>(cl)), 0.5f),
                                 __fadd_rn(lo, hi));
    out = __fdiv_rn(__fadd_rn(sl, fill), kf);
  } else {
    // fewer than k valid candidates: fill at the largest found distance
    const float fill = __fmul_rn(__fsub_rn(kf, static_cast<float>(cntv)), dmax);
    out = __fdiv_rn(__fadd_rn(sumv, fill), kf);
  }
  md[static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x] = out;
}

}  // namespace

// spos: [n, 3] f32 contiguous on the device, n a multiple of 512; md: [n] f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sor_window_md(const float* spos, float* md, int n, int k,
                             int window, int iters, void* stream) {
  if (n <= 0 || n % kBlock != 0 || window <= 0 || window > kMaxWindow ||
      kBlock % window != 0 || k <= 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sor_window_md_kernel<<<n / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      spos, md, n, k, window, iters);
  return static_cast<int>(cudaGetLastError());
}
