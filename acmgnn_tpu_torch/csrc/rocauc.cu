// K4 — ROC-AUC rank pass over sorted scores, several masks at once (sm_90a).
//
// Replaces the rank pass of acmgnn_tpu/train/metrics.py
// (_auc_from_sorted_batch, under masked_rocauc_multi): the Mann-Whitney
// statistic with average-rank ties, sklearn-exact, for M masks over one
// score sort.  The sort itself stays a library sort (torch.sort, as
// jnp.argsort in the JAX package).
//
// Input per score column b (grid.y): the ascending scores s, their sort
// permutation `order`, and a packed byte per node (bit 0 the label, bit
// m+1 mask m) read through `order`.  Output per column and mask: n_pos,
// n_neg and 2 * rank_sum as exact int64 (JAX sums the ranks in f32).
//
// Formulation.  Tie groups are the runs of equal sorted scores.  A group
// g holding P_g masked positives, with lo_g masked nodes before it and
// hi_g masked nodes up to its end, adds P_g * (lo_g + 1 + hi_g) to
// 2 * rank_sum.  With the packed prefix count G(i) = (masked count << 32)
// | (masked-positive count) through sorted position i, at each group end
// e:  P_g = Q(e) - Q(prev), lo_g = M(prev), hi_g = M(e), where prev is
// the previous group end.  G is monotone, so "the previous group end's G"
// is an exclusive max-scan of (end ? G : 0).  A group of thousands of
// equal scores (softmax saturates to exactly 1.0) spans many tiles; only
// its end contributes, and the carries across tiles are exact:
//   - launch 1 (auc_tiles_kernel): per 1024-node tile and mask, the
//     tile's packed count and the tile-local G at its last group end;
//   - launch 2 (auc_scan_kernel, one block per column): the exclusive
//     prefix of tile counts (base) and the G of the last group end before
//     each tile (carry); n_pos and n_neg from the totals;
//   - launch 3 (auc_ranks_kernel): per tile, G = base + local scan, the
//     max-scan from the carry, and the group-end contributions, summed
//     per block and added to 2 * rank_sum with an integer atomic (exact
//     in any order).
//
// What bounds it on an H100: bytes, ~13 per node (f32 score, int64
// permutation, the gathered packed byte), read twice (launches 1 and 3):
// 5.5 MB at genius scale, a few microseconds, so launch latency is the
// practical floor.
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr long long kOne = 1LL << 32;  // one masked node in a packed count
constexpr long long kLow = kOne - 1;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct MaxOp {
  __device__ __forceinline__ long long operator()(long long a,
                                                  long long b) const {
    return a > b ? a : b;
  }
};

using Scan = cub::BlockScan<long long, kThreads>;
using Reduce = cub::BlockReduce<long long, kThreads>;
union TempStorage {
  Scan::TempStorage scan;
  Reduce::TempStorage reduce;
};

struct Tile {
  bool end[kItems];       // last node of its tie group
  uint8_t bits[kItems];   // packed label and mask bits
};

// Blocked arrangement: thread k holds sorted positions k*kItems + j.
__device__ __forceinline__ void load_tile(const float* __restrict__ s,
                                          const int64_t* __restrict__ order,
                                          const uint8_t* __restrict__ packed,
                                          int64_t n, int64_t t, Tile& in) {
  const int64_t base = t * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i < n) {
      in.end[j] = i == n - 1 || s[i] != s[i + 1];
      in.bits[j] = packed[order[i]];
    } else {
      in.end[j] = false;
      in.bits[j] = 0;
    }
  }
}

__device__ __forceinline__ void mask_counts(const Tile& in, int m,
                                            long long (&v)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int b = in.bits[j];
    v[j] = ((b >> (m + 1)) & 1) ? (kOne | (b & 1)) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
auc_tiles_kernel(const float* __restrict__ s, const int64_t* __restrict__ order,
                 const uint8_t* __restrict__ packed, int64_t n, int n_masks,
                 int64_t n_tiles, long long* __restrict__ total,
                 long long* __restrict__ last_end) {
  __shared__ TempStorage tmp;
  const int64_t col = blockIdx.y;
  const int64_t t = blockIdx.x;
  Tile in;
  load_tile(s + col * n, order + col * n, packed + col * n, n, t, in);
  for (int m = 0; m < n_masks; ++m) {
    long long v[kItems], inc[kItems], agg;
    mask_counts(in, m, v);
    Scan(tmp.scan).InclusiveSum(v, inc, agg);
    __syncthreads();
    long long le = -1;  // -1: no group ends in this tile
#pragma unroll
    for (int j = 0; j < kItems; ++j) le = in.end[j] && inc[j] > le ? inc[j] : le;
    const long long last = Reduce(tmp.reduce).Reduce(le, MaxOp());
    __syncthreads();
    if (threadIdx.x == 0) {
      const int64_t k = (col * n_tiles + t) * n_masks + m;
      total[k] = agg;
      last_end[k] = last;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
auc_scan_kernel(int n_masks, int64_t n_tiles,
                const long long* __restrict__ total,
                const long long* __restrict__ last_end,
                long long* __restrict__ base, long long* __restrict__ carry,
                int64_t* __restrict__ out) {
  __shared__ Scan::TempStorage tmp;
  const int64_t col = blockIdx.x;
  const int64_t chunk = (n_tiles + kThreads - 1) / kThreads;
  const int64_t t0 = min64(n_tiles, threadIdx.x * chunk);
  const int64_t t1 = min64(n_tiles, t0 + chunk);
  for (int m = 0; m < n_masks; ++m) {
    const int64_t k0 = col * n_tiles * n_masks + m;
    long long sum = 0;
    for (int64_t t = t0; t < t1; ++t) sum += total[k0 + t * n_masks];
    long long run, all;
    Scan(tmp).ExclusiveSum(sum, run, all);
    __syncthreads();
    long long cand = 0;  // G at this thread's last group end
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t k = k0 + t * n_masks;
      base[k] = run;
      if (last_end[k] >= 0) cand = MaxOp()(cand, run + last_end[k]);
      run += total[k];
    }
    long long c;
    Scan(tmp).ExclusiveScan(cand, c, 0LL, MaxOp());
    __syncthreads();
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t k = k0 + t * n_masks;
      carry[k] = c;
      if (last_end[k] >= 0) c = MaxOp()(c, base[k] + last_end[k]);
    }
    if (threadIdx.x == 0) {
      const long long n_pos = all & kLow;
      out[(col * n_masks + m) * 3 + 0] = n_pos;
      out[(col * n_masks + m) * 3 + 1] = (all >> 32) - n_pos;
      out[(col * n_masks + m) * 3 + 2] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
auc_ranks_kernel(const float* __restrict__ s, const int64_t* __restrict__ order,
                 const uint8_t* __restrict__ packed, int64_t n, int n_masks,
                 int64_t n_tiles, const long long* __restrict__ base,
                 const long long* __restrict__ carry,
                 int64_t* __restrict__ out) {
  __shared__ TempStorage tmp;
  const int64_t col = blockIdx.y;
  const int64_t t = blockIdx.x;
  Tile in;
  load_tile(s + col * n, order + col * n, packed + col * n, n, t, in);
  for (int m = 0; m < n_masks; ++m) {
    const int64_t k = (col * n_tiles + t) * n_masks + m;
    long long v[kItems], g[kItems], e[kItems], prev[kItems];
    mask_counts(in, m, v);
    Scan(tmp.scan).InclusiveSum(v, g);
    __syncthreads();
    const long long tb = base[k];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      g[j] += tb;
      e[j] = in.end[j] ? g[j] : 0;
    }
    Scan(tmp.scan).ExclusiveScan(e, prev, carry[k], MaxOp());
    __syncthreads();
    long long contrib = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (in.end[j]) {
        const long long p = (g[j] & kLow) - (prev[j] & kLow);
        contrib += p * ((prev[j] >> 32) + 1 + (g[j] >> 32));
      }
    }
    const long long sum = Reduce(tmp.reduce).Sum(contrib);
    __syncthreads();
    if (threadIdx.x == 0 && sum != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(
                    out + (col * n_masks + m) * 3 + 2),
                static_cast<unsigned long long>(sum));
    }
  }
}

}  // namespace

extern "C" int acm_k4_tile_size() { return kTile; }

// scratch: 4 * n_cols * n_tiles * n_masks int64 (tile totals, tile last
// group ends, bases, carries); out: [n_cols, n_masks, 3] int64.
extern "C" int acm_k4_auc_rank_pass(const void* s_sorted, const void* order,
                                    const void* packed, int64_t n, int n_cols,
                                    int n_masks, int64_t n_tiles,
                                    void* scratch, void* out, void* stream) {
  if (n_cols <= 0 || n_masks <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(s_sorted);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* p = static_cast<const uint8_t*>(packed);
  auto* w = static_cast<long long*>(scratch);
  const int64_t plane = static_cast<int64_t>(n_cols) * n_tiles * n_masks;
  long long* total = w;
  long long* last_end = w + plane;
  long long* base = w + 2 * plane;
  long long* carry = w + 3 * plane;
  auto* res = static_cast<int64_t*>(out);
  const dim3 grid(static_cast<unsigned>(n_tiles), n_cols);
  auc_tiles_kernel<<<grid, kThreads, 0, st>>>(s, o, p, n, n_masks, n_tiles,
                                              total, last_end);
  auc_scan_kernel<<<n_cols, kThreads, 0, st>>>(n_masks, n_tiles, total,
                                               last_end, base, carry, res);
  auc_ranks_kernel<<<grid, kThreads, 0, st>>>(s, o, p, n, n_masks, n_tiles,
                                              base, carry, res);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
