// K-Means kernel K4 (update: segment sums and counts) on Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel _update_kernel of
// gsconverter_tpu/ops/kmeans.py (launched by _update_sums_pallas):
// x [N, D] f32, labels [N] i32 -> sums [K, D] f32, counts [K] f32; labels
// outside [0, K) are dropped; any K >= 1, N >= 1, D <= 2048.
//
// The summation order is fixed by (x, labels) alone, so the result is
// bit-identical from launch to launch and from card to card:
//   - the rows of cluster j are taken in ascending row index;
//   - they are cut into consecutive pieces of kPiece = 256 rows, counted
//     from the cluster's first row;
//   - each piece is summed left to right in f32 from +0.0;
//   - the piece sums of a cluster are added left to right from +0.0;
//   - counts are exact integers, converted to f32 at the end.
// ops/kmeans.py::_update_ordered_ref computes the same order in PyTorch.
//
// What bounds it here: its bytes (x read once, the labels; about 0.03 ms
// at N = 1M, D = 24 at 3.35 TB/s).  The TPU kernel forms one-hot products
// on its matrix unit; here that would cost N * K * D operations.  Design:
//   1. a stable LSD radix sort of the labels (8 bits a pass; 2 passes for
//      K <= 65,535), rows as the values, out-of-range labels in a discard bin
//      K: per block of 2,048 rows a digit histogram; an exclusive scan of
//      each digit's row of the [256, blocks] table (one block a digit); a
//      scatter that ranks each row within its block stably (each warp a
//      contiguous run of rows, equal digits found by ballots), stages the
//      block in shared memory in (digit, row) order and writes each digit's
//      rows as one contiguous run.  Integer work only, so no order question
//      arises; `perm` is the rows sorted by (label, row);
//   2. each cluster's first sorted position (where the sorted keys step
//      past it), its count, its number of pieces, and an exclusive scan of
//      those: piece offsets;
//   3. one warp per (piece, 32 dimensions): it finds its cluster by a
//      32-way search of the piece offsets, and its lanes gather the piece's
//      rows of x through `perm`, 8 rows in flight, and add them in order
//      (a 96-byte row at D = 24 is three full 32-byte sectors).  A cluster
//      that holds every row is N / 256 pieces on as many warps, so skew
//      costs no serial warp;
//   4. the piece sums of each cluster added in order: one warp per cluster
//      of at most 32 pieces, every load in flight at once; one block per
//      larger cluster (listed by step 2), streaming them through shared
//      memory with two chunks copied (cp.async) while a third is added.
// Scratch (kmeans_update_scratch): keys and rows twice [4N] i32, the
// digit table and digit totals, cluster starts and piece offsets
// [2(K + 1)] i32, the list of large clusters, piece sums
// [(N / 256 + min(K, N)) * D] f32.  No occupancy query: the plan depends
// on N, D and K only.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kPiece = 256;            // rows per piece: fixes the summation order
constexpr int kMaxD = 2048;            // widest rows
constexpr int kBits = 8;               // radix digit
constexpr int kBins = 1 << kBits;
constexpr int kSortThreads = kBins;    // one thread per digit in the scatter's scan
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortRounds = 8;
constexpr int kSortRows = kSortThreads * kSortRounds;  // rows per sort block
constexpr int kTableScanThreads = 128;  // a digit's row of the table: 512 blocks at 1M rows
constexpr int kPieceScanThreads = 1024; // the clusters: 4,096 entries at K = 4096
constexpr int kScanItems = 4;          // consecutive entries a scan thread takes
constexpr int kPieceThreads = 256;
constexpr int kPieceWarps = kPieceThreads / 32;
constexpr int kInFlight = 8;           // rows a lane loads before it adds them
constexpr int kSmallPieces = 32;      // larger clusters go to combine_big_kernel
constexpr int kBigThreads = 256;
constexpr int kBigStages = 3;          // chunks in flight in combine_big_kernel
constexpr int kBigFloats = 4096;       // piece sums per chunk (3 x 16 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bin_of(int label, int K) {
  return (label < 0 || label >= K) ? K : label;
}

// Element i of a pass: its key (pass 0 maps the raw label) and its row.
__device__ __forceinline__ void load_key(const int* __restrict__ keys_in,
                                         const int* __restrict__ vals_in, int first,
                                         int K, int i, int* key, int* val) {
  const int k = keys_in[i];
  *key = first ? bin_of(k, K) : k;
  *val = first ? i : vals_in[i];
}

// Lanes of the warp whose digit (0 .. kBins, kBins for no element)
// equals this lane's: one ballot a bit.
__device__ __forceinline__ unsigned digit_peers(int digit) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b <= kBits; ++b) {
    const bool bit = (digit >> b) & 1;
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Row i of sort block blockIdx.x, round r of warp w: the block's rows are
// split into one contiguous run per warp, taken 32 at a time.
__device__ __forceinline__ int sort_row(int r) {
  return blockIdx.x * kSortRows + (threadIdx.x / 32) * (kSortRounds * 32) + r * 32 +
         threadIdx.x % 32;
}

// Digit counts of sort block b: table[digit * nblocks + b].
__global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(const int* __restrict__ keys_in, int first, int N, int K, int shift,
                  int nblocks, int* __restrict__ table) {
  __shared__ int hist[kBins];
  const int t = threadIdx.x;
  hist[t] = 0;
  __syncthreads();
  int dig[kSortRounds];
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {  // every load in flight before the first ballot
    const int i = sort_row(r);
    dig[r] = kBins;  // no element
    if (i < N) {
      const int k = keys_in[i];
      dig[r] = ((first ? bin_of(k, K) : k) >> shift) & (kBins - 1);
    }
  }
  const unsigned below = (1u << (t % 32)) - 1;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    // one shared atomic per distinct digit of the warp
    const unsigned peers = digit_peers(dig[r]);
    if (dig[r] < kBins && (peers & below) == 0) atomicAdd(&hist[dig[r]], __popc(peers));
  }
  __syncthreads();
  table[t * nblocks + blockIdx.x] = hist[t];
}

// Exclusive prefix of v over the block's kThreads threads; *total is the
// block's sum.  warp_sums: kThreads / 32 ints of shared memory.
template <int kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int res = (warp > 0 ? warp_sums[warp - 1] : 0) + inc - v;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums may be reused
  return res;
}

// Exclusive prefix sum in place of row blockIdx.x of a ([rows, M]); with
// totals, also each row's sum.  With kPieces (one row, M = K + 1), the
// entries are not read from a but are the clusters' piece counts, from
// their starts: entry j < K is ceil(n_j / kPiece), where n_j =
// start[j + 1] - start[j] also goes to counts[j]; entry K is 0, so
// a[K] ends up the total.
// Clusters of more than kSmallPieces pieces are also listed in big[0,
// *nbig), in no particular order.
template <bool kPieces, int kThreads>
__global__ void __launch_bounds__(kThreads)
row_scan_kernel(int* __restrict__ a, int M, int* __restrict__ totals,
                const int* __restrict__ start, float* __restrict__ counts,
                int* __restrict__ nbig, int* __restrict__ big) {
  __shared__ int warp_sums[kThreads / 32];
  int* row = a + static_cast<long long>(blockIdx.x) * M;
  int carry = 0;
  for (int base = 0; base < M; base += kThreads * kScanItems) {
    const int i0 = base + threadIdx.x * kScanItems;
    int v[kScanItems];
    int s = 0;
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      const int i = i0 + u;
      if (!kPieces) {
        v[u] = i < M ? row[i] : 0;
      } else if (i < M - 1) {
        const int n = start[i + 1] - start[i];
        counts[i] = static_cast<float>(n);
        v[u] = (n + kPiece - 1) / kPiece;
        if (v[u] > kSmallPieces) big[atomicAdd(nbig, 1)] = i;
      } else {
        v[u] = 0;
      }
      s += v[u];
    }
    int total;
    int pre = carry + block_exclusive_scan<kThreads>(s, warp_sums, &total);
#pragma unroll
    for (int u = 0; u < kScanItems; ++u) {
      if (i0 + u < M) row[i0 + u] = pre;
      pre += v[u];
    }
    carry += total;
  }
  if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Stable scatter of sort block b by the digit at `shift`.  The table holds
// each (digit, block)'s first slot among that digit's rows, digit_tot each
// digit's count.  Each warp ranks its run of rows stably (lanes with equal
// digits by ballots, rounds in order, a count per digit in shared memory);
// the runs are then ordered by warp, the block's rows staged in shared
// memory in (digit, row) order, and each digit's rows written as one
// contiguous run.
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                     int first, int N, int K, int shift, int nblocks,
                     const int* __restrict__ table, const int* __restrict__ digit_tot,
                     int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int wcount[kSortWarps][kBins];  // a warp's rows per digit, then its first slot
  __shared__ int local_start[kBins];
  __shared__ int shift_out[kBins];           // global slot - local slot, per digit
  __shared__ int warp_sums[kSortWarps];
  __shared__ int skey[kSortRows];
  __shared__ int sval[kSortRows];
  const int t = threadIdx.x;
  const int warp = t / 32;
  const unsigned below = (1u << (t % 32)) - 1;
  int key[kSortRounds], val[kSortRounds], dig[kSortRounds], rank[kSortRounds];
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int i = sort_row(r);
    key[r] = val[r] = 0;
    dig[r] = kBins;  // no element
    if (i < N) {
      load_key(keys_in, vals_in, first, K, i, &key[r], &val[r]);
      dig[r] = (key[r] >> shift) & (kBins - 1);
    }
  }
  for (int d = t % 32; d < kBins; d += 32) wcount[warp][d] = 0;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const unsigned peers = digit_peers(dig[r]);
    const int before = dig[r] < kBins ? wcount[warp][dig[r]] : 0;
    __syncwarp();
    if (dig[r] < kBins && (peers & below) == 0) wcount[warp][dig[r]] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & below);  // among this warp's rows of the digit
  }
  __syncthreads();
  // thread t: digit t's first slot of each warp within the block, in warp order
  int run = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = wcount[w][t];
    wcount[w][t] = run;
    run += c;
  }
  int total;
  const int ls = block_exclusive_scan<kSortThreads>(run, warp_sums, &total);
  const int db = block_exclusive_scan<kSortThreads>(digit_tot[t], warp_sums, &total);
  local_start[t] = ls;
  shift_out[t] = db + table[t * nblocks + blockIdx.x] - ls;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    if (dig[r] < kBins) {
      const int lp = local_start[dig[r]] + wcount[warp][dig[r]] + rank[r];
      skey[lp] = key[r];
      sval[lp] = val[r];
    }
  }
  __syncthreads();
  const int base = blockIdx.x * kSortRows;
  const int cnt = min(kSortRows, N - base);
  for (int i = t; i < cnt; i += kSortThreads) {
    const int k = skey[i];
    const int pos = shift_out[(k >> shift) & (kBins - 1)] + i;
    keys_out[pos] = k;
    vals_out[pos] = sval[i];
  }
}

// start[j] for j in [0, K]: the first sorted position whose key is >= j
// (N for none).  Position i owns the j in (skeys[i - 1], skeys[i]], so
// each j is written once; the lanes of a warp write each owned range
// together (a range is long where many clusters are empty).  Also zeroes
// the count of large clusters.
__global__ void cluster_starts_kernel(const int* __restrict__ skeys, int N, int K,
                                      int* __restrict__ start, int* __restrict__ nbig) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  if (i == 0) *nbig = 0;
  int lo = 0, hi = 0;  // owns (lo, hi]
  if (i <= N) {
    lo = i > 0 ? skeys[i - 1] : -1;
    hi = i < N ? skeys[i] : K;
  }
  for (unsigned todo = __ballot_sync(kFull, hi > lo); todo != 0; todo &= todo - 1) {
    const int l = __ffs(todo) - 1;
    const int a = __shfl_sync(kFull, lo, l) + 1;
    const int b = __shfl_sync(kFull, hi, l);
    const int at = __shfl_sync(kFull, i, l);
    for (int j = a + lane; j <= b; j += 32) start[j] = at;
  }
}

// The cluster of piece p: the last j in [0, K) with poff[j] <= p
// (poff[0] = 0 <= p < poff[K]), by a search whose every step probes 32
// offsets at once, one a lane.
__device__ __forceinline__ int find_cluster(const int* __restrict__ poff, int K, int p) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = K;  // poff[lo] <= p, and poff[hi] > p unless hi == K
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, probe < hi && poff[probe] <= p);
    lo += (31 - __clz(le)) * step;  // lane 0's probe always holds
    hi = min(hi, lo + step);
  }
  return lo;
}

// One warp per (piece, 32 dimensions): the piece's rows added in order.
__global__ void __launch_bounds__(kPieceThreads)
piece_sums_kernel(const float* __restrict__ x, const int* __restrict__ perm,
                  const int* __restrict__ start, const int* __restrict__ poff, int D, int K,
                  int nchunks, long long items, float* __restrict__ psum) {
  const long long item = static_cast<long long>(blockIdx.x) * kPieceWarps + threadIdx.x / 32;
  if (item >= items) return;
  const int p = static_cast<int>(item / nchunks);
  const int chunk = static_cast<int>(item - static_cast<long long>(p) * nchunks);
  if (p >= poff[K]) return;  // beyond this input's pieces
  const int j = find_cluster(poff, K, p);
  const int r0 = start[j] + (p - poff[j]) * kPiece;
  const int r1 = min(r0 + kPiece, start[j + 1]);
  const int lane = threadIdx.x % 32;
  const int d = chunk * 32 + lane;
  const bool on = d < D;
  float acc = 0.f;
  // lane u holds the index of row u of a batch of 32; the rows' values are
  // loaded kInFlight at a time (more in flight measured slower: fewer
  // warps fit on an SM)
  for (int rb = r0; rb < r1; rb += 32) {
    const int cnt = min(32, r1 - rb);
    const int mine = lane < cnt ? perm[rb + lane] : 0;
    for (int u0 = 0; u0 < cnt; u0 += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int row = __shfl_sync(kFull, mine, u0 + u);
        v[u] = (on && u0 + u < cnt) ? x[static_cast<size_t>(row) * D + d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (u0 + u < cnt) acc = __fadd_rn(acc, v[u]);
      }
    }
  }
  if (on) psum[static_cast<size_t>(p) * D + d] = acc;
}

// One warp per cluster of at most kSmallPieces pieces: its lanes (one a
// dimension) load every piece sum, then add them in piece order from +0.0.
__global__ void __launch_bounds__(kPieceThreads)
combine_small_kernel(const float* __restrict__ psum, const int* __restrict__ poff, int D,
                     int K, float* __restrict__ sums) {
  const int j = blockIdx.x * kPieceWarps + threadIdx.x / 32;
  if (j >= K) return;
  const int p0 = poff[j];
  const int n = poff[j + 1] - p0;
  if (n > kSmallPieces) return;  // combine_big_kernel's
  for (int d = threadIdx.x % 32; d < D; d += 32) {
    float v[kSmallPieces];
#pragma unroll
    for (int q = 0; q < kSmallPieces; ++q) {
      v[q] = q < n ? psum[static_cast<size_t>(p0 + q) * D + d] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kSmallPieces; ++q) {
      if (q < n) acc = __fadd_rn(acc, v[q]);
    }
    sums[static_cast<size_t>(j) * D + d] = acc;
  }
}

// Copy chunk c (pieces [c * per, +per)) of a cluster's piece sums, which
// are contiguous rows of psum from piece p0, into buf asynchronously, as
// one pipeline stage (committed even when empty, to keep the count).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ psum, int p0, int c,
                                            int n, int per, int D, float* buf) {
  const int q0 = c * per;
  const int floats = q0 < n ? min(per, n - q0) * D : 0;
  const float* src = psum + static_cast<size_t>(p0 + q0) * D;
  if (D % 4 == 0) {  // every chunk starts 16-byte aligned
    for (int i = 4 * threadIdx.x; i < floats; i += 4 * kBigThreads) {
      __pipeline_memcpy_async(buf + i, src + i, 4 * sizeof(float));
    }
  } else {
    for (int i = threadIdx.x; i < floats; i += kBigThreads) {
      __pipeline_memcpy_async(buf + i, src + i, sizeof(float));
    }
  }
  __pipeline_commit();
}

// One block per listed large cluster: its piece sums added in piece order
// from +0.0, streamed through kBigStages shared-memory buffers, the next
// chunks in flight while one is added.
__global__ void __launch_bounds__(kBigThreads)
combine_big_kernel(const float* __restrict__ psum, const int* __restrict__ poff,
                   const int* __restrict__ nbig, const int* __restrict__ big, int D,
                   float* __restrict__ sums) {
  __shared__ __align__(16) float buf[kBigStages][kBigFloats];
  constexpr int kPerThread = kMaxD / kBigThreads;
  if (static_cast<int>(blockIdx.x) >= *nbig) return;
  const int j = big[blockIdx.x];
  const int t = threadIdx.x;
  const int p0 = poff[j];
  const int n = poff[j + 1] - p0;
  const int per = kBigFloats / D;  // pieces per chunk, >= 1
  const int chunks = (n + per - 1) / per;
  float acc[kPerThread];
#pragma unroll
  for (int g = 0; g < kPerThread; ++g) acc[g] = 0.f;
  for (int c = 0; c < kBigStages - 1; ++c) stage_chunk(psum, p0, c, n, per, D, buf[c]);
  for (int c = 0; c < chunks; ++c) {
    const int ahead = c + kBigStages - 1;
    stage_chunk(psum, p0, ahead, n, per, D, buf[ahead % kBigStages]);
    __pipeline_wait_prior(kBigStages - 1);  // this thread's copies of chunk c
    __syncthreads();                        // everyone's
    const float* b = buf[c % kBigStages];
    const int cn = min(per, n - c * per);
#pragma unroll
    for (int g = 0; g < kPerThread; ++g) {
      const int d = t + g * kBigThreads;
      if (d < D) {
        float s = acc[g];
#pragma unroll 16
        for (int q = 0; q < cn; ++q) s = __fadd_rn(s, b[q * D + d]);
        acc[g] = s;
      }
    }
    __syncthreads();  // chunk c's buffer is consumed before it is staged again
  }
#pragma unroll
  for (int g = 0; g < kPerThread; ++g) {
    const int d = t + g * kBigThreads;
    if (d < D) sums[static_cast<size_t>(j) * D + d] = acc[g];
  }
}

int radix_passes(int K) {
  int bits = 0;
  for (unsigned v = static_cast<unsigned>(K); v != 0; v >>= 1) ++bits;  // keys 0..K
  return (bits + kBits - 1) / kBits;
}

int sort_blocks(int N) { return (N + kSortRows - 1) / kSortRows; }

long long max_pieces(int N, int K) {
  return static_cast<long long>(N / kPiece) + std::min(K, N);
}

// Most clusters of more than kSmallPieces pieces that N rows can make.
int max_big(int N) { return N / (kSmallPieces * kPiece + 1) + 1; }

// Shapes whose counts fit the kernels' int32 offsets and grid sizes.
bool bad_shape(int N, int D, int K) {
  return N <= 0 || D <= 0 || D > kMaxD || K <= 0 || K == 0x7fffffff ||
         max_pieces(N, K) > 0x7fffffffLL ||
         max_pieces(N, K) * ((D + 31) / 32) > 0x7fffffffLL * kPieceWarps;
}

}  // namespace

// Scratch of one K4 launch: *ints int32 and *floats float32 elements.
extern "C" int kmeans_update_scratch(int N, int D, int K, long long* ints,
                                     long long* floats) {
  if (bad_shape(N, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  *ints = 4LL * N + static_cast<long long>(kBins) * (sort_blocks(N) + 1) + 2LL * (K + 1) + 1 +
          max_big(N);
  *floats = max_pieces(N, K) * D;
  return 0;
}

// K4.  x [N, D] f32, labels [N] i32 -> sums [K, D], counts [K] f32;
// iscratch and fscratch as kmeans_update_scratch sizes them.  Returns
// cudaGetLastError() after the launches.
extern "C" int kmeans_update(const float* x, const int* labels, float* sums, float* counts,
                             int* iscratch, float* fscratch, int N, int D, int K,
                             void* stream) {
  if (bad_shape(N, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = sort_blocks(N);
  int* keys[2] = {iscratch, iscratch + N};
  int* vals[2] = {iscratch + 2LL * N, iscratch + 3LL * N};
  int* table = iscratch + 4LL * N;                                     // [kBins, nblocks]
  int* digit_tot = table + static_cast<long long>(kBins) * nblocks;    // [kBins]
  int* start = digit_tot + kBins;
  int* poff = start + (K + 1);
  int* nbig = poff + (K + 1);                                          // [1]
  int* big = nbig + 1;                                                 // [max_big(N)]

  // 1. stable sort of the rows by label
  const int passes = radix_passes(K);
  for (int p = 0; p < passes; ++p) {
    const int first = p == 0 ? 1 : 0;
    const int* kin = first ? labels : keys[(p - 1) % 2];
    const int* vin = first ? nullptr : vals[(p - 1) % 2];
    radix_hist_kernel<<<nblocks, kSortThreads, 0, s>>>(kin, first, N, K, p * kBits, nblocks,
                                                       table);
    row_scan_kernel<false, kTableScanThreads><<<kBins, kTableScanThreads, 0, s>>>(
        table, nblocks, digit_tot, nullptr, nullptr, nullptr, nullptr);
    radix_scatter_kernel<<<nblocks, kSortThreads, 0, s>>>(kin, vin, first, N, K, p * kBits,
                                                          nblocks, table, digit_tot,
                                                          keys[p % 2], vals[p % 2]);
  }
  const int* skeys = keys[(passes - 1) % 2];
  const int* perm = vals[(passes - 1) % 2];

  // 2. cluster bounds, counts, piece offsets
  cluster_starts_kernel<<<N / 256 + 1, 256, 0, s>>>(skeys, N, K, start, nbig);
  row_scan_kernel<true, kPieceScanThreads><<<1, kPieceScanThreads, 0, s>>>(
      poff, K + 1, nullptr, start, counts, nbig, big);

  // 3. piece sums; 4. cluster sums
  const int nchunks = (D + 31) / 32;
  const long long items = max_pieces(N, K) * nchunks;
  const long long pblocks = (items + kPieceWarps - 1) / kPieceWarps;
  piece_sums_kernel<<<static_cast<unsigned>(pblocks), kPieceThreads, 0, s>>>(
      x, perm, start, poff, D, K, nchunks, items, fscratch);
  combine_small_kernel<<<(K + kPieceWarps - 1) / kPieceWarps, kPieceThreads, 0, s>>>(
      fscratch, poff, D, K, sums);
  combine_big_kernel<<<max_big(N), kBigThreads, 0, s>>>(fscratch, poff, nbig, big, D, sums);
  return static_cast<int>(cudaGetLastError());
}
