// Front-to-back alpha compositing of depth-ordered tile windows, and its
// analytic backward, on Hopper (sm_90a): kernels K5 and K6.
//
// Replaces XLA code, not a Pallas kernel: K5 computes
// gsconverter_tpu/render/rasterizer.py::_composite_fwd_impl (:138) and K6
// its custom VJP _composite_bwd (:204), for every tile of a band in one
// launch.  The JAX code runs a while_loop over blocks of BM candidates for
// a chunk of tiles at a time (many small XLA ops per block); here one CTA
// composites one 16x16 tile: K5 a 2x2 group of pixels a thread, K6 one
// pixel a thread.
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
// d_color_i = g w_i.  K6 writes d_geo [C, M, 8], d_alpha [C, M] for the
// blocks it walked (the wrapper zeroes the rest) and d_bg partials [C, 3].
//
// What bounds them.  K5: FP32 issue, about 15 instructions (its expf
// counted as 4) a walked (candidate, pixel) pair once the terms of a
// pixel's row (dy, (cc dy) dy) and column (dx, (ca dx) dx, (2 cb) dx) are
// formed once a row or column; the bytes (36 a candidate, read once per
// tile) are small beside that.  With one thread a pixel, each candidate's nine values
// cost nine shared loads a pixel, and the shared-memory pipe (about one
// warp-wide load a clock an SM, against four FP32 instructions) set the
// pace.  This design gives a thread a 2x2 group of pixels.  For each block
// of candidates the tile forms every column's and row's terms once, in
// shared memory; a thread then reads a candidate's terms for its two
// columns and two rows and its alpha and color with three 16-byte loads,
// and runs four independent transmittance and color chains.  The color
// sums of a block are scaled by the block's entry T once, at its end.
// The next block's rows are copied by cp.async while the current one
// composites.  Alpha is computed with the plain PyTorch version's
// roundings and the accurate expf (not __expf), so every alpha, and with
// it every clamp and exit decision, is the plain version's; each pixel's
// transmittance is the sequential product of its (1 - a) factors, a
// candidate at a time, then a block at a time; the image stays within
// 2e-5 of the plain version's.
//
// K6 sums 9 per-pixel terms a candidate over the tile's 256 pixels.  Done
// as a 5-step __shfl_xor_sync butterfly a term, that is 45 shuffles a
// (candidate, pixel) pair, and Hopper issues shuffles at 32 lanes a clock
// an SM, a quarter of its FP32 rate: the shuffle pipe bounded K6, and its
// second pass recomputed every alpha.  This design:
//   - pass 1 computes each alpha once and keeps its gauss in dynamic
//     shared memory ([BM][256] floats, 64 KB at BM = 64), its sign
//     carrying `power < 0` (a stored -1 means power >= 0, gauss 1): pass 2
//     derives raw = al * gauss, a, dx and dy bit-equal to alpha_at's.
//     Pass 1 also ballots, a candidate at a time, the candidates some
//     pixel of each warp sees (the warp's live mask);
//   - pass 2 walks only the warp's live candidates, in order (elsewhere
//     every pixel has a = 0, so the T factor and the prefix do not move),
//     8 at a time.  Each lane holds its pixel's 9 terms of the group's
//     candidates; halving steps of a reduce-scatter (offsets 16, 8, 4)
//     leave lane l with candidate l / 4's terms summed over 8 lanes, and
//     a butterfly (2, 1) finishes the warp: 81 shuffles a group of 8, 10.1
//     a reduced pair, against 45.  The last 3-4 go as a group of 4 (54
//     shuffles), the last 1-2 as one of 2 (45), so no candidate costs more
//     than the butterfly did.  The lanes that share a candidate write its
//     9 sums over cache entries the warp has read, so a CTA needs only the
//     64 KB cache and 2.4 KB more: three CTAs (24 warps) fit an SM, at
//     most 80 registers a thread;
//   - the warps that see a candidate add their shares in warp order, the
//     others add nothing: no atomics, so repeat launches are bit-identical.
// What is left is FP32 issue: pass 1's alpha for every pair (about 21
// instructions and one expf), and pass 2's gradient chain with its
// division where a warp sees the candidate.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // pixels a tile; K6: threads a CTA
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
  float a, gauss, power;
};

// Every operation rounded on its own, in the plain version's order: an
// FMA contraction moves raw by an ulp, and where raw sits at 1/255 that
// flips a whole contribution of about 0.004 T color (the clamp is a step).
// With the same roundings and the same expf, a is bit-identical.
__device__ __forceinline__ Alpha alpha_at(const Cands& s, int j, float gx, float gy) {
  Alpha v;
  const float dx = __fsub_rn(gx, s.mx[j]);
  const float dy = __fsub_rn(gy, s.my[j]);
  const float t1 = __fmul_rn(__fmul_rn(s.ca[j], dx), dx);
  const float t2 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, s.cb[j]), dx), dy);
  const float t3 = __fmul_rn(__fmul_rn(s.cc[j], dy), dy);
  v.power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(t1, t2), t3));
  v.gauss = expf(fminf(v.power, 0.f));
  const float a = fminf(__fmul_rn(s.al[j], v.gauss), kAlphaMax);
  v.a = a < kAlphaMin ? 0.f : a;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// K5 gives each thread a 2x2 group of pixels: 64 threads a tile.
constexpr int kFwdThreads = kPixels / 4;
constexpr int kPairs = kTile / 2;  // column (row) pairs of a tile

// One block of candidates as K5 copies it from the window: each geo row as
// two float4 (mean x, y, conic a, b | conic c, color r, g, b), and alpha.
struct FwdRows {
  float4 geo[kMaxBm][2];
  float al[kMaxBm];
};

// A block's terms for one tile, each formed once: of candidate j and
// column pair q (x = 2q, 2q + 1) t1 = (ca dx) dx and u = (2 cb) dx of x =
// 2q, then of 2q + 1; of row pair q (y = 2q, 2q + 1) dy and t3 = (cc dy) dy
// of y = 2q, then of 2q + 1; and j's alpha and color.  A thread reads a
// candidate with three 16-byte loads for its four pixels.
struct FwdTerms {
  float4 col[kMaxBm][kPairs];
  float4 row[kMaxBm][kPairs];
  float4 cand[kMaxBm];  // alpha, color r, g, b
};

// Copies the block of bm candidates starting at `geo`/`alpha` into `s`
// (cp.async, one stage; thread t takes candidates t, t + kFwdThreads, ...).
// Each row goes as two 16-byte copies: geo is 16-byte aligned (the entry
// point checks it) and a row is 32 bytes, so every row is.
__device__ __forceinline__ void copy_rows(FwdRows& s, const float* __restrict__ geo,
                                          const float* __restrict__ alpha, int bm, int t) {
  for (int j = t; j < bm; j += kFwdThreads) {
    const float* row = geo + static_cast<size_t>(j) * kGeo;
    float* dst = reinterpret_cast<float*>(s.geo[j]);
    __pipeline_memcpy_async(dst, row, 16);
    __pipeline_memcpy_async(dst + 4, row + 4, 16);
    __pipeline_memcpy_async(&s.al[j], alpha + j, sizeof(float));
  }
  __pipeline_commit();
}

// Forms the block's terms from its rows.  Warp 0 forms the column pairs'
// terms, warp 1 the row pairs' (and each candidate's alpha and color):
// lane l takes pair l % 8 of candidates l / 8, l / 8 + 4, ...  `c0`, `c1`
// are the centers of the lane's pair (x or y), every product rounded on
// its own as in alpha_at.
__device__ __forceinline__ void form_terms(FwdTerms& s, const FwdRows& r, int bm, int t,
                                           float c0, float c1) {
  const int q = t % kPairs;
  const int lane = t % 32;
  if (t < 32) {
    for (int j = lane / kPairs; j < bm; j += 32 / kPairs) {
      const float4 q0 = r.geo[j][0];
      const float cb2 = __fmul_rn(2.0f, q0.w);
      const float dx0 = __fsub_rn(c0, q0.x), dx1 = __fsub_rn(c1, q0.x);
      s.col[j][q] = make_float4(__fmul_rn(__fmul_rn(q0.z, dx0), dx0), __fmul_rn(cb2, dx0),
                                __fmul_rn(__fmul_rn(q0.z, dx1), dx1), __fmul_rn(cb2, dx1));
    }
  } else {
    for (int j = lane / kPairs; j < bm; j += 32 / kPairs) {
      const float my = r.geo[j][0].y;
      const float4 q1 = r.geo[j][1];
      const float dy0 = __fsub_rn(c0, my), dy1 = __fsub_rn(c1, my);
      s.row[j][q] = make_float4(dy0, __fmul_rn(__fmul_rn(q1.x, dy0), dy0), dy1,
                                __fmul_rn(__fmul_rn(q1.x, dy1), dy1));
      if (q == 0) s.cand[j] = make_float4(r.al[j], q1.y, q1.z, q1.w);
    }
  }
}

// Stores the values of two neighbouring pixels.
__device__ __forceinline__ void store2(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// K5: a CTA composites one tile, thread t the 2x2 group of pixels at
// columns x0, x0 + 1 = 2 (t % 8) + {0, 1} and rows y0, y0 + 1 = 2 (t / 8) +
// {0, 1}.  Per block the tile forms each column's and row's terms once
// (form_terms); per candidate a thread then reads them with three shared
// loads and forms, per pixel, t2 = ((2 cb) dx) dy and the rest of alpha_at:
// every product and sum rounded on its own in alpha_at's order, so each
// alpha is bit-identical to it.  The four pixels are independent chains
// of tb *= 1 - a and of the block's color sums (of a tb color), which are
// scaled by the block's entry T at its end.  Block b + 1's rows are
// copied (cp.async) while block b composites.  A tile stops at a block
// boundary when no pixel has T > T_EPS (an OR over the thread's pixels,
// then __syncthreads_or) or after ceil(count / bm) blocks.
__global__ void __launch_bounds__(kFwdThreads)
composite_fwd_kernel(const float* __restrict__ geo, const float* __restrict__ alpha,
                     const float* __restrict__ origin, const int* __restrict__ count,
                     const float* __restrict__ bg, float* __restrict__ rgb,
                     float* __restrict__ t_starts, float* __restrict__ t_final,
                     int* __restrict__ n_done, int C, int M, int bm) {
  __shared__ FwdRows rows[2];
  __shared__ FwdTerms terms;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int gq = t % kPairs, gr = t / kPairs;  // the thread's column and row pair
  const int x0 = 2 * gq, y0 = 2 * gr;
  // the centers of the pair whose terms this thread forms (form_terms)
  const float o = origin[2 * c + (t < 32 ? 0 : 1)];
  const float c0 = o + (static_cast<float>(2 * (t % kPairs)) + 0.5f);
  const float c1 = o + (static_cast<float>(2 * (t % kPairs) + 1) + 0.5f);
  const int nb = M / bm;
  const int nbt = min((count[c] + bm - 1) / bm, nb);
  const size_t win = static_cast<size_t>(c) * M;

  float T[2][2], cr[2][2], cg[2][2], cb[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < 2; ++i) T[k][i] = 1.f, cr[k][i] = cg[k][i] = cb[k][i] = 0.f;
  }
  if (nbt > 0) copy_rows(rows[0], geo + win * kGeo, alpha + win, bm, t);
  int b = 0;
  for (; b < nbt; ++b) {
    const bool alive = T[0][0] > kTEps || T[0][1] > kTEps || T[1][0] > kTEps ||
                       T[1][1] > kTEps;
    __pipeline_wait_prior(0);  // this thread's copies of block b are in
    // every thread's too, and every thread is done with block b - 1's terms
    // and rows
    if (!__syncthreads_or(alive)) break;
    if (b + 1 < nbt) {
      const size_t off = win + static_cast<size_t>(b + 1) * bm;
      copy_rows(rows[(b + 1) & 1], geo + off * kGeo, alpha + off, bm, t);
    }
    form_terms(terms, rows[b & 1], bm, t, c0, c1);
    float* ts = t_starts + (static_cast<size_t>(b) * C + c) * kPixels;
    store2(ts + y0 * kTile + x0, T[0][0], T[0][1]);
    store2(ts + (y0 + 1) * kTile + x0, T[1][0], T[1][1]);
    __syncthreads();  // the terms are in

    float tb[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    float pr[2][2] = {}, pg[2][2] = {}, pb[2][2] = {};  // the block's sums before T
#pragma unroll 4
    for (int j = 0; j < bm; ++j) {
      const float4 cq = terms.col[j][gq];
      const float4 rq = terms.row[j][gr];
      const float4 cd = terms.cand[j];
      const float t1[2] = {cq.x, cq.z}, u[2] = {cq.y, cq.w};
      const float dy[2] = {rq.x, rq.z}, t3[2] = {rq.y, rq.w};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float t2 = __fmul_rn(u[i], dy[k]);
          const float power = __fmul_rn(-0.5f, __fadd_rn(__fadd_rn(t1[i], t2), t3[k]));
          const float gauss = expf(fminf(power, 0.f));
          const float am = fminf(__fmul_rn(cd.x, gauss), kAlphaMax);
          const float a = am < kAlphaMin ? 0.f : am;
          const float w = a * tb[k][i];
          pr[k][i] += w * cd.y;
          pg[k][i] += w * cd.z;
          pb[k][i] += w * cd.w;
          tb[k][i] *= 1.f - a;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cr[k][i] += T[k][i] * pr[k][i];
        cg[k][i] += T[k][i] * pg[k][i];
        cb[k][i] += T[k][i] * pb[k][i];
        T[k][i] *= tb[k][i];
      }
    }
  }
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int row = (y0 + k) * kTile + x0;
    store2(t_final + static_cast<size_t>(c) * kPixels + row, T[k][0], T[k][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* out = rgb + (static_cast<size_t>(c) * kPixels + row + i) * 3;
      out[0] = cr[k][i] + T[k][i] * bg0;
      out[1] = cg[k][i] + T[k][i] * bg1;
      out[2] = cb[k][i] + T[k][i] * bg2;
    }
  }
  if (t == 0) n_done[c] = b;
}

// Pixel terms of candidate j for K6's pass 2, from pass 1's cached gauss
// `st` (negative: power >= 0 and gauss 1): q gets the 9 terms (mean x, y;
// conic a, b, c; color r, g, b; alpha), all 0 where the pixel does not see
// j, and tb (the block's running T factor) and P (the inclusive prefix of
// s) move past j.  raw = al * gauss and the clamp are alpha_at's, so a is
// bit-equal to pass 1's.
__device__ __forceinline__ void pair_terms(const Cands& s, int j, float st, float gx,
                                           float gy, float g0, float g1, float g2,
                                           float ts, float R, float S, float& tb,
                                           float& P, float (&q)[kGrads]) {
#pragma unroll
  for (int k = 0; k < kGrads; ++k) q[k] = 0.f;
  const float gauss = fabsf(st);
  const float raw = __fmul_rn(s.al[j], gauss);
  const float am = fminf(raw, kAlphaMax);
  const float a = am < kAlphaMin ? 0.f : am;
  if (a == 0.f) return;  // w = 0, not live: every term is 0, tb and P stay
  const float dx = __fsub_rn(gx, s.mx[j]);
  const float dy = __fsub_rn(gy, s.my[j]);
  const float Ti = ts * tb;
  const float w = a * Ti;
  const float cgj = g0 * s.r[j] + g1 * s.g[j] + g2 * s.b[j];
  P += cgj * w;
  const float Ri = R + (S - P);
  const float d_a = cgj * Ti - Ri / (1.f - a);
  const bool live = a >= kAlphaMin && raw < kAlphaMax;
  const float d_raw = live ? d_a : 0.f;
  const float d_gauss = d_raw * s.al[j];
  const float d_power = st >= 0.f ? d_gauss * gauss : 0.f;  // power < 0
  q[0] = d_power * (s.ca[j] * dx + s.cb[j] * dy);
  q[1] = d_power * (s.cb[j] * dx + s.cc[j] * dy);
  q[2] = d_power * -0.5f * dx * dx;
  q[3] = d_power * -1.0f * dx * dy;
  q[4] = d_power * -0.5f * dy * dy;
  q[5] = g0 * w;
  q[6] = g1 * w;
  q[7] = g2 * w;
  q[8] = d_raw * gauss;
  tb *= 1.f - a;
}

// One halving step of the reduce-scatter: the lanes with `upper` keep `hi`
// and send `lo`, the others keep `lo` and send `hi`, and each adds the
// partner's copy of the half it keeps.  Both partners add the same two
// values, so they hold the same bits.
__device__ __forceinline__ float halve(float lo, float hi, bool upper, int offset) {
  return (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, offset);
}

// Pass 2 of K6 for the next G (8, 4 or 2) candidates of `live`, the warp's
// candidates that some pixel of the warp sees, in order (taken off
// `live`): their terms, summed over the warp's 32 pixels, go to the first
// 9 of the warp's 32 cache entries of each candidate j, which its pixels
// have read by then (gauss_of[j][32 warp + k], k < 9).  Slot g holds the g-th candidate.  Slots 0 .. G/2-1 stay in v; slots
// G/2 .. G-1 are folded in as they come by the first halving step
// (offset 16).  The other log2(G) - 1 halving steps (offsets 8, then 4 for
// G = 8) leave lane l with slot l / (32 / G) summed over G lanes, and a
// butterfly over the remaining 32 / G lanes finishes the warp.  Shuffles:
// 9 ((G - 1) + log2(32 / G)) a call: 81 for G = 8, 54 for G = 4 and 45
// for G = 2 (one butterfly's worth, for one or two candidates).  Empty
// slots hold 0.  The 32 / G lanes of a slot write its 9 sums between them.
template <int G>
__device__ __forceinline__ void reduce_group(float* gauss_of, const Cands& s,
                                             unsigned long long& live, int p, int lane,
                                             float gx, float gy, float g0, float g1, float g2,
                                             float ts, float R, float S, float& tb, float& P) {
  constexpr int kSpan = 32 / G;  // lanes that end with one slot
  float v[G / 2][kGrads];
  float q[kGrads];
  int js[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    js[g] = -1;
    if (live) {  // warp-uniform
      const int j = __ffsll(static_cast<long long>(live)) - 1;
      live &= live - 1;
      js[g] = j;
      pair_terms(s, j, gauss_of[j * kPixels + p], gx, gy, g0, g1, g2, ts, R, S, tb, P, q);
    } else {
#pragma unroll
      for (int k = 0; k < kGrads; ++k) q[k] = 0.f;
    }
    if (g < G / 2) {
#pragma unroll
      for (int k = 0; k < kGrads; ++k) v[g][k] = q[k];
    } else {
#pragma unroll
      for (int k = 0; k < kGrads; ++k)
        v[g - G / 2][k] = halve(v[g - G / 2][k], q[k], lane & 16, 16);
    }
  }
#pragma unroll
  for (int h = G / 4; h >= 1; h /= 2) {
    const int off = 32 * h / G;
#pragma unroll
    for (int i = 0; i < h; ++i) {
#pragma unroll
      for (int k = 0; k < kGrads; ++k) v[i][k] = halve(v[i][k], v[i + h][k], lane & off, off);
    }
  }
#pragma unroll
  for (int off = kSpan / 2; off >= 1; off /= 2) {
#pragma unroll
    for (int k = 0; k < kGrads; ++k) v[0][k] += __shfl_xor_sync(kFull, v[0][k], off);
  }
  const int slot = lane / kSpan;
  int jq = -1;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (g == slot) jq = js[g];
  // the warp's cache entries of candidate jq are read: its sums go there
  __syncwarp();
  if (jq >= 0) {
    float* red = gauss_of + jq * kPixels + (p & ~31);
#pragma unroll
    for (int k = 0; k < kGrads; ++k)
      if (k % kSpan == lane % kSpan) red[k] = v[0][k];
  }
}

__global__ void __launch_bounds__(kPixels, 3)
composite_bwd_kernel(const float* __restrict__ geo, const float* __restrict__ alpha,
                     const float* __restrict__ origin, const float* __restrict__ bg,
                     const float* __restrict__ grgb, const float* __restrict__ t_starts,
                     const float* __restrict__ t_final, const int* __restrict__ n_done,
                     float* __restrict__ d_geo, float* __restrict__ d_alpha,
                     float* __restrict__ d_bg, int C, int M, int bm) {
  extern __shared__ float gauss_of[];  // [bm][256]: pass 1's gauss, signed
  __shared__ Cands s;
  __shared__ unsigned long long warp_live[kWarps];  // bit j: the warp sees j
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

  // d_bg partial of this tile: sum over pixels of g * t_final (the warps'
  // shares in the cache, before pass 1 first writes it)
  {
    const float q0 = warp_sum(g0 * tf), q1 = warp_sum(g1 * tf), q2 = warp_sum(g2 * tf);
    if (lane == 0) {
      gauss_of[p + 0] = q0;
      gauss_of[p + 1] = q1;
      gauss_of[p + 2] = q2;
    }
    __syncthreads();
    if (p < 3) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += gauss_of[32 * w + p];
      d_bg[static_cast<size_t>(c) * 3 + p] = acc;
    }
  }

  float R = (g0 * bg[0] + g1 * bg[1] + g2 * bg[2]) * tf;
  for (int b = n_done[c] - 1; b >= 0; --b) {
    __syncthreads();  // the last block's reads of s, the cache and warp_live are done
    const size_t off = win + static_cast<size_t>(b) * bm;
    stage(s, geo + off * kGeo, alpha + off, bm, p);
    __syncthreads();
    const float ts = t_starts[(static_cast<size_t>(b) * C + c) * kPixels + p];

    // pass 1: every alpha of the block, once: the block's sum S of s_i, the
    // cached gauss, and the candidates some pixel of the warp sees
    float tb = 1.f, S = 0.f;
    unsigned long long live = 0;
#pragma unroll 4
    for (int j = 0; j < bm; ++j) {
      const Alpha v = alpha_at(s, j, gx, gy);
      const float w = v.a * (ts * tb);
      S += (g0 * s.r[j] + g1 * s.g[j] + g2 * s.b[j]) * w;
      tb *= 1.f - v.a;
      gauss_of[j * kPixels + p] = v.power < 0.f ? v.gauss : -1.f;
      if (__ballot_sync(kFull, v.a != 0.f)) live |= 1ull << j;
    }
    if (lane == 0) warp_live[warp] = live;

    // pass 2: R_i = R + S - prefix_i over the warp's live candidates only
    // (where every pixel has a = 0, tb and the prefix do not move), 8 at a
    // time, then the last 3-4 as a group of 4 or the last 1-2 as one of 2
    tb = 1.f;
    float P = 0.f;
    while (__popcll(live) > 4)
      reduce_group<8>(gauss_of, s, live, p, lane, gx, gy, g0, g1, g2, ts, R, S, tb, P);
    if (__popcll(live) > 2) {
      reduce_group<4>(gauss_of, s, live, p, lane, gx, gy, g0, g1, g2, ts, R, S, tb, P);
    } else if (live) {
      reduce_group<2>(gauss_of, s, live, p, lane, gx, gy, g0, g1, g2, ts, R, S, tb, P);
    }
    R += S;
    __syncthreads();
    // the shares of the warps that see each candidate, summed in warp order
    for (int t = p; t < bm * kGrads; t += kPixels) {
      const int j = t / kGrads;
      const int k = t - j * kGrads;
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w)
        if ((warp_live[w] >> j) & 1ull) acc += gauss_of[j * kPixels + 32 * w + k];
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
// n_done [C] int32.  1 <= bm <= 64 divides M; geo starts 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int composite_fwd(const float* geo, const float* alpha, const float* origin,
                             const int* count, const float* bg, float* rgb,
                             float* t_starts, float* t_final, int* n_done, int C, int M,
                             int bm, void* stream) {
  if (bad_shape(C, M, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<size_t>(geo) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (C == 0) return 0;
  composite_fwd_kernel<<<C, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geo, alpha, origin, count, bg, rgb, t_starts, t_final, n_done, C, M, bm);
  return static_cast<int>(cudaGetLastError());
}

// K6.  The forward's inputs and saved outputs, grgb [C,256,3]; out:
// d_geo [C,M,8] and d_alpha [C,M] (zeroed by the caller; blocks at or past
// a tile's n_done stay 0), d_bg [C,3] per-tile partials.  Takes bm * 1 KB
// of dynamic shared memory; returns the error of raising its limit (at the
// first call, and the same on every later one), else cudaGetLastError()
// after the launch.
extern "C" int composite_bwd(const float* geo, const float* alpha, const float* origin,
                             const float* bg, const float* grgb, const float* t_starts,
                             const float* t_final, const int* n_done, float* d_geo,
                             float* d_alpha, float* d_bg, int C, int M, int bm,
                             void* stream) {
  if (bad_shape(C, M, bm)) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0) return 0;
  // pass 1's gauss cache lies above the 48 KB a launch gets by default;
  // both attributes hold for the process, so they are set at the first call
  static const cudaError_t attr_err = [] {
    const int cache_bytes = kMaxBm * kPixels * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cache_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(composite_bwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    return err;
  }();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  composite_bwd_kernel<<<C, kPixels, static_cast<size_t>(bm) * kPixels * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      geo, alpha, origin, bg, grgb, t_starts, t_final, n_done, d_geo, d_alpha, d_bg, C,
      M, bm);
  return static_cast<int>(cudaGetLastError());
}
