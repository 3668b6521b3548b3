// Front-to-back alpha compositing of depth-ordered tile windows, and its
// analytic backward, on Hopper (sm_90a): kernels K5 and K6.
//
// Replaces XLA code, not a Pallas kernel: K5 computes
// gsconverter_tpu/render/rasterizer.py::_composite_fwd_impl (:138) and K6
// its custom VJP _composite_bwd (:204), for every tile of a band in one
// launch.  The JAX code runs a while_loop over blocks of BM candidates for
// a chunk of tiles at a time (many small XLA ops per block); here one CTA
// composites one 16x16 tile, one thread a pixel.
//
// Inputs (all f32, contiguous): geo [C, M, 8] (mean x, y; conic a, b, c;
// color r, g, b: the packed window gather), alpha [C, M] (0 on invalid
// slots), origin [C, 2] (tile top-left, pixels), bg [3]; M = nb * BM.
// Per pixel p of tile c (x = p % 16, y = p / 16, center origin + (x, y) +
// 0.5) and candidate j:
//   power = -0.5 (a dx dx + 2 b dx dy + c dy dy), dx = px - mx, dy = py - my
//   gauss = exp(min(power, 0)), raw = alpha_j gauss,
//   a_j = min(raw, 0.99), set to 0 below 1/255;
//   within a block, t_prev = prod_{i<j} (1 - a_i); w_j = a_j t_prev T;
//   rgb += w_j color_j; at the block's end T *= prod (1 - a_i).
// K5 writes rgb [C,256,3] (+ T bg at the end), the entry transmittance of
// every block it composited t_starts [nb, C, 256], t_final [C, 256] and
// n_done [C] (blocks composited).  A tile stops at a block boundary when
// no pixel has T > 1e-4 (__syncthreads_or) or after ceil(count / BM)
// blocks (later blocks hold only invalid slots).  The JAX loop stops a
// chunk of tiles together; per tile is its result with a chunk of one.
//
// K6 walks each tile's blocks back to front from n_done with the saved
// t_starts (block-exact, no 1/(1-a) reconstruction).  With g the pixel's
// rgb cotangent, R the back contribution (starting at (g . bg) t_final),
// and s_i = (g . color_i) w_i: R_i = R + sum_{j>i} s_j (formed as the
// block sum minus the inclusive prefix, as JAX does: one pass for the sum,
// one for the rest), d_a = (g . color_i) T_i - R_i / (1 - a_i), masked to
// the live clamp region, then the chain to alpha, conic and mean, and
// d_color_i = g w_i.  Each per-candidate sum over the tile's 256 pixels
// is a warp butterfly (__shfl_xor_sync) and then a sum over the 8 warps
// in a fixed order: no atomics, so repeat launches are bit-identical.
// A warp in which no pixel sees candidate i (a = 0 everywhere) skips the
// shuffles; its share is exactly 0.  K6 writes d_geo [C, M, 8],
// d_alpha [C, M] for the blocks it walked (the wrapper zeroes the rest)
// and d_bg partials [C, 3].
//
// What bounds them: operations.  Each live (candidate, pixel) pair costs
// K5 about two dozen FP32 instructions and one expf, K6 twice the alpha
// (two passes) and about 60 more; the bytes (36 a candidate, read once
// per tile) are small beside that.  This first version is one thread a
// pixel with candidates staged through shared memory.  Alpha is computed
// with the plain PyTorch version's roundings and the accurate expf (not
// __expf), so every alpha, and with it every clamp and exit decision, is
// the plain version's; the image stays within 2e-5 of it.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads a CTA, one a pixel
constexpr int kWarps = kPixels / 32;
constexpr int kMaxBm = 64;             // candidates a block stages
constexpr int kGeo = 8;                // mean (2), conic (3), color (3)
constexpr int kGrads = 9;              // kGeo, then alpha
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

// One block of candidates, structure of arrays.
struct Cands {
  float mx[kMaxBm], my[kMaxBm], ca[kMaxBm], cb[kMaxBm], cc[kMaxBm];
  float r[kMaxBm], g[kMaxBm], b[kMaxBm], al[kMaxBm];
};

// Threads t < bm load candidate t of the block starting at `geo`/`alpha`.
__device__ __forceinline__ void stage(Cands& s, const float* __restrict__ geo,
                                      const float* __restrict__ alpha, int bm, int t) {
  if (t < bm) {
    const float* row = geo + static_cast<size_t>(t) * kGeo;
    s.mx[t] = row[0];
    s.my[t] = row[1];
    s.ca[t] = row[2];
    s.cb[t] = row[3];
    s.cc[t] = row[4];
    s.r[t] = row[5];
    s.g[t] = row[6];
    s.b[t] = row[7];
    s.al[t] = alpha[t];
  }
}

struct Alpha {
  float a, raw, gauss, power, dx, dy;
};

// Every operation rounded on its own, in the plain version's order: an
// FMA contraction moves raw by an ulp, and where raw sits at 1/255 that
// flips a whole contribution of about 0.004 T color (the clamp is a step).
// With the same roundings and the same expf, a is bit-identical.
__device__ __forceinline__ Alpha alpha_at(const Cands& s, int j, float gx, float gy) {
  Alpha v;
  v.dx = __fsub_rn(gx, s.mx[j]);
  v.dy = __fsub_rn(gy, s.my[j]);
  const float t1 = __fmul_rn(__fmul_rn(s.ca[j], v.dx), v.dx);
  const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, s.cb[j]), v.dx), v.dy);
  const float t3 = __fmul_rn(__fmul_rn(s.cc[j], v.dy), v.dy);
  v.power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(t1, t2), t3));
  v.gauss = expf(fminf(v.power, 0.f));
  v.raw = __fmul_rn(s.al[j], v.gauss);
  const float a = fminf(v.raw, kAlphaMax);
  v.a = a < kAlphaMin ? 0.f : a;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ geo, const float* __restrict__ alpha,
                     const float* __restrict__ origin, const int* __restrict__ count,
                     const float* __restrict__ bg, float* __restrict__ rgb,
                     float* __restrict__ t_starts, float* __restrict__ t_final,
                     int* __restrict__ n_done, int C, int M, int bm) {
  __shared__ Cands s;
  const int c = blockIdx.x;
  const int p = threadIdx.x;
  const float gx = origin[2 * c] + (static_cast<float>(p & (kTile - 1)) + 0.5f);
  const float gy = origin[2 * c + 1] + (static_cast<float>(p / kTile) + 0.5f);
  const int nb = M / bm;
  const int nbt = min((count[c] + bm - 1) / bm, nb);
  const size_t win = static_cast<size_t>(c) * M;

  float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f;
  int b = 0;
  for (; b < nbt; ++b) {
    // also the barrier before the staging overwrites the last block
    if (!__syncthreads_or(T > kTEps)) break;
    const size_t off = win + static_cast<size_t>(b) * bm;
    stage(s, geo + off * kGeo, alpha + off, bm, p);
    __syncthreads();
    t_starts[(static_cast<size_t>(b) * C + c) * kPixels + p] = T;
    float tb = 1.f;
    for (int j = 0; j < bm; ++j) {
      const Alpha v = alpha_at(s, j, gx, gy);
      const float w = v.a * tb * T;
      cr += w * s.r[j];
      cg += w * s.g[j];
      cb += w * s.b[j];
      tb *= 1.f - v.a;
    }
    T *= tb;
  }
  const size_t px = static_cast<size_t>(c) * kPixels + p;
  rgb[px * 3 + 0] = cr + T * bg[0];
  rgb[px * 3 + 1] = cg + T * bg[1];
  rgb[px * 3 + 2] = cb + T * bg[2];
  t_final[px] = T;
  if (p == 0) n_done[c] = b;
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ geo, const float* __restrict__ alpha,
                     const float* __restrict__ origin, const float* __restrict__ bg,
                     const float* __restrict__ grgb, const float* __restrict__ t_starts,
                     const float* __restrict__ t_final, const int* __restrict__ n_done,
                     float* __restrict__ d_geo, float* __restrict__ d_alpha,
                     float* __restrict__ d_bg, int C, int M, int bm) {
  __shared__ Cands s;
  __shared__ float red[kWarps][kMaxBm][kGrads];
  const int c = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float gx = origin[2 * c] + (static_cast<float>(p & (kTile - 1)) + 0.5f);
  const float gy = origin[2 * c + 1] + (static_cast<float>(p / kTile) + 0.5f);
  const size_t px = static_cast<size_t>(c) * kPixels + p;
  const float g0 = grgb[px * 3 + 0], g1 = grgb[px * 3 + 1], g2 = grgb[px * 3 + 2];
  const float tf = t_final[px];
  const size_t win = static_cast<size_t>(c) * M;

  // d_bg partial of this tile: sum over pixels of g * t_final
  {
    const float q0 = warp_sum(g0 * tf), q1 = warp_sum(g1 * tf), q2 = warp_sum(g2 * tf);
    if (lane == 0) {
      red[warp][0][0] = q0;
      red[warp][0][1] = q1;
      red[warp][0][2] = q2;
    }
    __syncthreads();
    if (p < 3) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += red[w][0][p];
      d_bg[static_cast<size_t>(c) * 3 + p] = acc;
    }
  }

  float R = (g0 * bg[0] + g1 * bg[1] + g2 * bg[2]) * tf;
  for (int b = n_done[c] - 1; b >= 0; --b) {
    __syncthreads();  // the last block's reads of s and red are done
    const size_t off = win + static_cast<size_t>(b) * bm;
    stage(s, geo + off * kGeo, alpha + off, bm, p);
    __syncthreads();
    const float ts = t_starts[(static_cast<size_t>(b) * C + c) * kPixels + p];

    // pass 1: the block's sum S of s_i
    float tb = 1.f, S = 0.f;
    for (int j = 0; j < bm; ++j) {
      const Alpha v = alpha_at(s, j, gx, gy);
      const float w = v.a * (ts * tb);
      S += (g0 * s.r[j] + g1 * s.g[j] + g2 * s.b[j]) * w;
      tb *= 1.f - v.a;
    }
    // pass 2: per-candidate gradients, R_i = R + S - prefix_i
    tb = 1.f;
    float P = 0.f;
    for (int j = 0; j < bm; ++j) {
      const Alpha v = alpha_at(s, j, gx, gy);
      const float Ti = ts * tb;
      const float w = v.a * Ti;
      const float cgj = g0 * s.r[j] + g1 * s.g[j] + g2 * s.b[j];
      P += cgj * w;
      const float Ri = R + (S - P);
      const float d_a = cgj * Ti - Ri / (1.f - v.a);
      const bool live = v.a >= kAlphaMin && v.raw < kAlphaMax;
      const float d_raw = live ? d_a : 0.f;
      const float d_gauss = d_raw * s.al[j];
      const float d_power = v.power < 0.f ? d_gauss * v.gauss : 0.f;
      float q[kGrads];
      q[0] = d_power * (s.ca[j] * v.dx + s.cb[j] * v.dy);
      q[1] = d_power * (s.cb[j] * v.dx + s.cc[j] * v.dy);
      q[2] = d_power * -0.5f * v.dx * v.dx;
      q[3] = d_power * -1.0f * v.dx * v.dy;
      q[4] = d_power * -0.5f * v.dy * v.dy;
      q[5] = g0 * w;
      q[6] = g1 * w;
      q[7] = g2 * w;
      q[8] = d_raw * v.gauss;
      tb *= 1.f - v.a;
      if (__any_sync(kFull, v.a != 0.f)) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) q[k] = warp_sum(q[k]);
      } else {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) q[k] = 0.f;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kGrads; ++k) red[warp][j][k] = q[k];
      }
    }
    R += S;
    __syncthreads();
    // the 8 warps' shares, summed in warp order
    for (int t = p; t < bm * kGrads; t += kPixels) {
      const int j = t / kGrads;
      const int k = t - j * kGrads;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += red[w][j][k];
      const size_t row = off + j;
      if (k < kGeo) {
        d_geo[row * kGeo + k] = acc;
      } else {
        d_alpha[row] = acc;
      }
    }
  }
}

bool bad_shape(int C, int M, int bm) {
  return C < 0 || M <= 0 || bm < 1 || bm > kMaxBm || M % bm != 0;
}

}  // namespace

// K5.  geo [C,M,8], alpha [C,M], origin [C,2], bg [3] f32; count [C] int32;
// out: rgb [C,256,3], t_starts [M/bm, C, 256], t_final [C,256] f32,
// n_done [C] int32.  1 <= bm <= 64 divides M.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int composite_fwd(const float* geo, const float* alpha, const float* origin,
                             const int* count, const float* bg, float* rgb,
                             float* t_starts, float* t_final, int* n_done, int C, int M,
                             int bm, void* stream) {
  if (bad_shape(C, M, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  composite_fwd_kernel<<<C, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
      geo, alpha, origin, count, bg, rgb, t_starts, t_final, n_done, C, M, bm);
  return static_cast<int>(cudaGetLastError());
}

// K6.  The forward's inputs and saved outputs, grgb [C,256,3]; out:
// d_geo [C,M,8] and d_alpha [C,M] (zeroed by the caller; blocks at or past
// a tile's n_done stay 0), d_bg [C,3] per-tile partials.
extern "C" int composite_bwd(const float* geo, const float* alpha, const float* origin,
                             const float* bg, const float* grgb, const float* t_starts,
                             const float* t_final, const int* n_done, float* d_geo,
                             float* d_alpha, float* d_bg, int C, int M, int bm,
                             void* stream) {
  if (bad_shape(C, M, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  composite_bwd_kernel<<<C, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
      geo, alpha, origin, bg, grgb, t_starts, t_final, n_done, d_geo, d_alpha, d_bg, C,
      M, bm);
  return static_cast<int>(cudaGetLastError());
}
