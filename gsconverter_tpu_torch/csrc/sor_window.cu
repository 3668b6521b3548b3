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
// What bounds it: instruction issue, not memory.  Each point reads 12 B
// and writes 4 B, but needs (512 + 2*window) distances, each a dozen FP32
// instructions with an IEEE square root, and one compare per distance in
// each of the iters + 2 passes over them (stats, bisection, final sum).
// The TPU kernel keeps the [512 + 2w, 512] bf16 distance matrix in VMEM
// (1 MB at w = 256), far above the 227 KB of shared memory a Hopper block
// may use.  Here a warp owns a point and its distances live in the warp's
// registers: lane l computes the distances to candidates l + 32*j, once,
// and keeps them as bf16 pairs in VPL / 2 registers (VPL = 24, 32, 48 at
// window 128, 256, 512; 20 for every window up to 64, the slots past the
// candidates +inf).  The stats, every bisection step and the final sum read those
// registers and reduce across the warp (__reduce_*_sync, shuffles).  VPL
// is a template argument and every loop over the registers is unrolled,
// so no register array is indexed at run time (which would put it in
// local memory).  A block stages the candidate rows of one 512-point
// block as x/y/z planes in shared memory (at most 1536 x 12 B; lane reads
// are consecutive words, the point's own coordinates a broadcast) and
// serves 64 of its points, so the grid is n / 64 blocks of 8 warps and the
// last wave is a small share of the run.
//
// The bisection compare: every value v is a non-negative bf16 or +inf and
// every midpoint m is a finite f32 >= 0, so v <= m exactly when
// bits16(v) <= bits32(m) >> 16, i.e. when v <= the bf16 truncation of m.
// Each step compares two values a register against that truncation in
// bf16 (set.le.bf16x2) and counts in bf16 pairs (exact up to 256).
//
// Rounding: the distance and the final formulas use the _rn intrinsics so
// that nvcc cannot contract them into FMAs, and sqrt is IEEE-rounded;
// that keeps d bit-identical to the plain PyTorch version, so counts,
// maxima, hi, lo and every midpoint are identical too; only the two f32
// sums (sum(d) and sum(d <= lo)) are taken in another order, a warp tree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 512;       // points per block (the TPU kernel's lane tile)
constexpr int kMaxWindow = 512;   // window must divide kBlock
constexpr int kThreads = 256;     // 8 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCtaPoints = 64;    // points of one 512-point block a CTA serves
constexpr int kGenericVpl = 20;   // values a lane for every window <= 64
constexpr float kPadPos = 1e15f;  // sentinel coordinate of padded rows
constexpr float kValidMax = 1e12f;
constexpr float kValidMin = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(32 * kGenericVpl >= kBlock + 2 * 64, "generic slots cover window 64");
static_assert(kBlock % kCtaPoints == 0 && kCtaPoints % kWarps == 0, "tiling");

// Distance from point (x, y, z) to candidate (cx, cy, cz), not yet rounded
// to bf16; +inf for self/duplicate pairs and for pad sentinels.
__device__ __forceinline__ float pair_dist(float cx, float cy, float cz,
                                           float x, float y, float z) {
  const float t0 = __fsub_rn(cx, x);
  const float t1 = __fsub_rn(cy, y);
  const float t2 = __fsub_rn(cz, z);
  const float acc = __fadd_rn(__fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1)),
                              __fmul_rn(t2, t2));
  const float d = __fsqrt_rn(acc);
  return (d > kValidMin && d < kValidMax) ? d : CUDART_INF_F;
}

// The sum over the warp by a butterfly: a + b == b + a, so every lane ends
// with the same bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  }
  return s;
}

// The max over the warp of non-negative floats, as unsigned integers.
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v)));
}

// The lane's count of values v <= t (t a finite f32 >= 0): v <= t exactly
// when v <= the bf16 truncation of t, compared two a register in bf16 and
// counted in bf16 pairs (at most R per half, exact).
template <int R>
__device__ __forceinline__ int count_le(const __nv_bfloat162 (&v)[R], float t) {
  const __nv_bfloat16 tb =
      __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(t) >> 16));
  const __nv_bfloat162 t2 = __halves2bfloat162(tb, tb);
  __nv_bfloat162 a0 = __float2bfloat162_rn(0.f);
  __nv_bfloat162 a1 = a0;
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    a0 = __hadd2(a0, __hle2(v[r], t2));
    if (r + 1 < R) {
      a1 = __hadd2(a1, __hle2(v[r + 1], t2));
    }
  }
  const __nv_bfloat162 a = __hadd2(a0, a1);
  return static_cast<int>(__low2float(a) + __high2float(a));
}

// VPL: values a lane (even; 32 * VPL >= 512 + 2 * window).  WIN: the
// window, or 0 for a window read from `window_arg` (any divisor of 512 up
// to 64).
template <int VPL, int WIN>
__global__ void __launch_bounds__(kThreads)
sor_window_md_kernel(const float* __restrict__ spos, float* __restrict__ md,
                     int n, int k, int window_arg, int iters) {
  constexpr int R = VPL / 2;
  static_assert(VPL % 2 == 0, "values are kept in bf16 pairs");
  static_assert(WIN % 32 == 0, "a fixed window is whole rows of lanes");
  __shared__ float cand[3 * 32 * VPL];
  const int window = WIN > 0 ? WIN : window_arg;
  const int cw = kBlock + 2 * window;
  float* cx = cand;
  float* cy = cand + cw;
  float* cz = cand + 2 * cw;

  constexpr int kSplit = kBlock / kCtaPoints;
  const int blk = blockIdx.x / kSplit;
  const int first = (blockIdx.x % kSplit) * kCtaPoints;  // within the block

  // Stage the candidate rows as x/y/z planes: one coalesced linear read of
  // the [cw, 3] slab, out-of-range rows as PAD_POS.
  const long long base = (static_cast<long long>(blk) * kBlock - window) * 3;
  const long long total = static_cast<long long>(n) * 3;
  for (int i = threadIdx.x; i < 3 * cw; i += kThreads) {
    const long long g = base + i;
    const float v = (g >= 0 && g < total) ? spos[g] : kPadPos;
    cand[(i % 3) * cw + i / 3] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float kf = static_cast<float>(k);

  for (int q = first + (threadIdx.x >> 5); q < first + kCtaPoints; q += kWarps) {
    const int me = window + q;
    const float x = cx[me], y = cy[me], z = cz[me];

    // The one pass that computes distances: the lane's values into
    // registers, with the lane's count, sum and max over all candidates
    // and count and max over the middle block [window, window + 512).
    __nv_bfloat162 v[R];
    int cnt = 0;  // valid count + (middle-block valid count << 16)
    float sumv = 0.f, dmax = 0.f, hmid = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * (2 * r + h);
        d[h] = (WIN == 0 && c >= cw) ? CUDART_INF_F
                                     : pair_dist(cx[c], cy[c], cz[c], x, y, z);
      }
      v[r] = __floats2bfloat162_rn(d[0], d[1]);  // low half: d[0]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * r + h;
        const int c = lane + 32 * j;
        const bool middle = WIN > 0 ? (j >= WIN / 32 && j < WIN / 32 + kBlock / 32)
                                    : (c >= window && c < window + kBlock);
        const float w = h == 0 ? __low2float(v[r]) : __high2float(v[r]);
        const bool fin = w < kValidMax;
        const float dz = fin ? w : 0.f;
        cnt += fin ? (middle ? 0x10001 : 1) : 0;
        sumv = __fadd_rn(sumv, dz);
        dmax = fmaxf(dmax, dz);
        if (middle) hmid = fmaxf(hmid, dz);
      }
    }
    const int tot = __reduce_add_sync(kFull, cnt);
    const int cntv = tot & 0xffff;
    const int cntm = tot >> 16;
    sumv = warp_sum(sumv);
    dmax = warp_max(dmax);
    hmid = warp_max(hmid);

    // Bisection for the k-th-neighbour radius, over the registers.
    // Invariant: count(d <= lo) < k <= count(d <= hi) whenever cntv >= k.
    float hi = (cntm >= k) ? hmid : dmax;
    float lo = 0.f;
    for (int it = 0; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (__reduce_add_sync(kFull, count_le(v, mid)) >= k) {
        hi = mid;
      } else {
        lo = mid;
      }
    }

    // Count and sum of the values at or below lo, and the mean distance.
    float sl = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w0 = __low2float(v[r]);
      const float w1 = __high2float(v[r]);
      sl = __fadd_rn(sl, w0 <= lo ? w0 : 0.f);
      sl = __fadd_rn(sl, w1 <= lo ? w1 : 0.f);
    }
    const int cl = __reduce_add_sync(kFull, count_le(v, lo));
    sl = warp_sum(sl);
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
    if (lane == 0) {
      md[static_cast<long long>(blk) * kBlock + q] = out;
    }
  }
}

template <int VPL, int WIN>
int launch(const float* spos, float* md, int n, int k, int window, int iters,
           cudaStream_t stream) {
  static_assert(32 * VPL >= kBlock + 2 * WIN, "a lane's slots cover the candidates");
  sor_window_md_kernel<VPL, WIN><<<n / kCtaPoints, kThreads, 0, stream>>>(
      spos, md, n, k, window, iters);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 128: return launch<24, 128>(spos, md, n, k, window, iters, s);
    case 256: return launch<32, 256>(spos, md, n, k, window, iters, s);
    case 512: return launch<48, 512>(spos, md, n, k, window, iters, s);
    default:  return launch<kGenericVpl, 0>(spos, md, n, k, window, iters, s);  // window <= 64
  }
}
