// K4 — ROC-AUC over sorted scores, several masks at once, in one launch
// (sm_90a).
//
// Replaces the rank pass of acmgnn_tpu/train/metrics.py
// (_auc_from_sorted_batch and the AUC it forms, under masked_rocauc_multi):
// the Mann-Whitney statistic with average-rank ties, sklearn-exact, for M
// masks over one score sort.  The sort itself stays a library sort
// (torch.sort, as jnp.argsort in the JAX package).
//
// Input per score column b (grid.y): the ascending scores s, their sort
// permutation `order`, and a packed byte per node (bit 0 the label, bit
// m+1 mask m) read through `order`.  Output: per column and mask n_pos,
// n_neg and 2 * rank_sum as exact int64 (JAX sums the ranks in f32), and
// per mask the AUC formed from them in f64 and rounded once to f32; for
// several columns (multilabel) the mean over the columns whose AUC is not
// NaN, summed in column order.
//
// Formulation.  Tie groups are the runs of equal sorted scores.  A group
// holding P masked positives, with lo masked nodes before it and hi masked
// nodes up to its end, adds P * (lo + 1 + hi) to 2 * rank_sum.  With m(i),
// q(i) the masked and masked-positive counts through sorted position i and
// f_1 < ... < f_r a tile's group ends (tile-local counts), the tile's share
// is
//   (Q_B + q(f_1) - Q_C) * (M_C + 1 + M_B + m(f_1)) + S1 + 2 * M_B * S2,
//   S1 = sum_{j>=2} (q(f_j) - q(f_{j-1})) * (1 + m(f_{j-1}) + m(f_j)),
//   S2 = q(f_r) - q(f_1),
// where (M_B, Q_B) are the counts before the tile and (M_C, Q_C) the global
// counts at the last group end before it ((0, 0) if none).  A group of
// thousands of equal scores (softmax saturates to exactly 1.0) spans many
// tiles: only its end contributes, through C.
//
// One launch, one read of every input element:
//   - block (t, b) reads tile t of column b once (its scores and one past
//     the tile for the group-end flag, its `order`, the packed byte
//     gathered through it), scans all masks together — two masks a 64-bit
//     word as four 16-bit fields (masked, masked-positive per mask; the
//     tile-local counts stay below 2^15; one instance per number of words,
//     so the registers follow the masks evaluated) — with warp shuffles
//     and one shared-memory round under the monoid
//       (T1, L1) + (T2, L2) = (T1 + T2, L2 exists ? T1 + L2 : L1)
//     (T: the counts, L: the counts at the last group end), and writes
//     the tile's statistics (M_t, Q_t, r > 0, m/q at f_1 and f_r, S1:
//     16 bytes a mask);
//   - the last block of a column to finish (a ticket taken after
//     __threadfence) scans that column's tile statistics with the same
//     monoid over tiles, forms each tile's share, sums them (integers:
//     exact and bit-reproducible in any order) and writes the counts and
//     the column's f64 AUCs, then puts its ticket back to 0;
//   - with several columns, the last column to finish (a second ticket)
//     forms each mask's nanmean in column order and writes the f32 AUCs.
// No float atomics, no device-wide library kernel.  The tickets and the
// statistics live in a persistent per-shape workspace the wrapper owns (the
// tickets zeroed once, when it is made, and put back by the kernel), so a
// CUDA graph can capture the launch and replay it any number of times.
//
// What bounds it on an H100: bytes, 13 a node (f32 score, int64
// permutation, the gathered packed byte), each read once: 5.5 MB at genius
// scale, 1.6 us at 3.35 TB/s.  A chain of dependent steps sets the time
// (PERF.md §6), not bytes: the launch, the loads and the gather through
// `order`, the tile's scan, its statistics made visible (__threadfence),
// the ticket, then the finishing block's own loads, scan and reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMasks = 7;
constexpr int kMaxWords = (kMaxMasks + 1) / 2;  // two masks a word
constexpr unsigned kFull = 0xffffffffu;

// An element of the scan monoid, K values wide (two masks a value in the
// tile pass, one mask a value with M << 32 | Q in the finish).  `h`: a
// group ends in the range; L is the counts at its last group end.
template <int K>
struct Run {
  u64 t[K];
  u64 l[K];
  bool h;
};

template <int K>
__device__ __forceinline__ void combine(Run<K>& right, const Run<K>& left) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    right.l[k] = right.h ? left.t[k] + right.l[k] : left.l[k];
    right.t[k] += left.t[k];
  }
  right.h = right.h || left.h;
}

template <int K>
__device__ __forceinline__ Run<K> identity() {
  Run<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.t[k] = r.l[k] = 0;
  r.h = false;
  return r;
}

// a[i] for a register array and an index known only at run time, without
// moving the array to local memory
template <int K>
__device__ __forceinline__ u64 pick(const u64 (&a)[K], int i) {
  u64 v = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) v = k == i ? a[k] : v;
  return v;
}

template <int K>
struct ScanSmem {
  u64 t[kWarps][K];
  u64 l[kWarps][K];
  int h[kWarps];
};

// Block-wide exclusive scan of `x` (one Run a thread, in thread order):
// `x` becomes the combination of the threads before this one, `total` that
// of the whole block.  One __syncthreads.
template <int K>
__device__ __forceinline__ void block_scan(Run<K>& x, Run<K>& total,
                                           ScanSmem<K>& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Run<K> up;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      up.t[k] = __shfl_up_sync(kFull, x.t[k], d);
      up.l[k] = __shfl_up_sync(kFull, x.l[k], d);
    }
    up.h = __shfl_up_sync(kFull, static_cast<int>(x.h), d) != 0;
    if (lane >= d) combine(x, up);
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sm.t[warp][k] = x.t[k];
      sm.l[warp][k] = x.l[k];
    }
    sm.h[warp] = x.h;
  }
  // the lane's exclusive prefix inside its warp
  Run<K> ex = identity<K>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const u64 t = __shfl_up_sync(kFull, x.t[k], 1);
    const u64 l = __shfl_up_sync(kFull, x.l[k], 1);
    if (lane > 0) {
      ex.t[k] = t;
      ex.l[k] = l;
    }
  }
  const int h = __shfl_up_sync(kFull, static_cast<int>(x.h), 1);
  ex.h = lane > 0 && h != 0;
  __syncthreads();
  Run<K> pre = identity<K>();  // the warps before this one
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      x = ex;
      combine(x, pre);
    }
    Run<K> agg;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      agg.t[k] = sm.t[w][k];
      agg.l[k] = sm.l[w][k];
    }
    agg.h = sm.h[w] != 0;
    combine(agg, pre);
    pre = agg;
  }
  total = pre;
}

// One node's word for masks 2w and 2w+1: fields masked / masked-positive
// of mask 2w at bits 0 / 16, of mask 2w+1 at bits 32 / 48.
__device__ __forceinline__ u64 node_word(uint32_t b, int w) {
  const u64 lab = b & 1u;
  const u64 ma = (b >> (2 * w + 1)) & 1u;
  const u64 mb = (b >> (2 * w + 2)) & 1u;
  return ma | ((ma & lab) << 16) | (mb << 32) | ((mb & lab) << 48);
}

__device__ __forceinline__ u64 field(u64 v, int f) {
  return (v >> (16 * f)) & 0xffffu;
}

// S1's term of one group end g with the previous in-tile group end p, for
// both masks of a word: (q - q_p) * (1 + m_p + m) in 32-bit halves (a
// tile's S1 is below T * (2T + 1) < 2^31).
__device__ __forceinline__ u64 s1_term(u64 g, u64 p) {
  const u64 a = (field(g, 1) - field(p, 1)) * (1 + field(p, 0) + field(g, 0));
  const u64 b = (field(g, 3) - field(p, 3)) * (1 + field(p, 2) + field(g, 2));
  return a | (b << 32);
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int K>
struct FinishSmem {
  ScanSmem<K> scan;
  u64 share[kWarps][K];
  int last;
};

// A tile's statistics for one mask, one 16-byte entry (counts below 2^15):
//   x = M_t | Q_t << 16 | (r > 0) << 31,  y = m(f_1) | q(f_1) << 16,
//   z = m(f_r) | q(f_r) << 16,            w = S1.
__device__ __forceinline__ u64 unpack(int v) {  // -> M << 32 | Q
  return (static_cast<u64>(v & 0xffff) << 32) | ((v >> 16) & 0x7fff);
}

// One tile of the finish under the monoid (`x`: the counts before it and
// at the last group end before it); with `share`, its share of
// 2 * rank_sum is added first.
template <int K>
__device__ __forceinline__ void finish_tile(Run<K>& x, const int4 (&e)[K],
                                            int n_masks, u64* share) {
  const bool has = e[0].x < 0;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if (m < n_masks) {
      if (has) {
        if (share != nullptr) {
          const long long mb = static_cast<long long>(x.t[m] >> 32);
          const long long qb = static_cast<long long>(x.t[m] & 0xffffffffu);
          const long long mc = static_cast<long long>(x.l[m] >> 32);
          const long long qc = static_cast<long long>(x.l[m] & 0xffffffffu);
          const long long m1 = e[m].y & 0xffff, q1 = (e[m].y >> 16) & 0x7fff;
          const long long qr = (e[m].z >> 16) & 0x7fff;
          share[m] += static_cast<u64>((qb + q1 - qc) * (mc + 1 + mb + m1) +
                                       e[m].w + 2 * mb * (qr - q1));
        }
        x.l[m] = x.t[m] + unpack(e[m].z);
      }
      x.t[m] += unpack(e[m].x);
    }
  }
  x.h = x.h || has;
}

template <int K>
__device__ __forceinline__ void load_tile_stats(const int4* st, int n_masks,
                                                int4 (&e)[K]) {
#pragma unroll
  for (int m = 0; m < K; ++m) {
    e[m] = m < n_masks ? __ldcg(st + m) : make_int4(0, 0, 0, 0);
  }
}

// The finish of column `col`, run by the column's last block: the tiles'
// statistics scanned over tiles (K >= n_masks values, M << 32 | Q a mask),
// each tile's share of 2 * rank_sum, the counts and the column's f64 AUCs;
// returns thread m's AUC (m < n_masks).
template <int K>
__device__ double finish_column(const int4* __restrict__ stats, int n_tiles,
                                int n_masks, int col,
                                int64_t* __restrict__ counts,
                                double* __restrict__ aucs, FinishSmem<K>& sm) {
  const int chunk = (n_tiles + kThreads - 1) / kThreads;
  const int t0 = min(n_tiles, static_cast<int>(threadIdx.x) * chunk);
  const int t1 = min(n_tiles, t0 + chunk);
  const int4* base = stats + static_cast<int64_t>(col) * n_tiles * n_masks;
  // pass 1: this thread's tiles under the monoid; the first stays in
  // registers for pass 2
  Run<K> x = identity<K>();
  int4 first[K];
  for (int t = t0; t < t1; ++t) {
    int4 e[K];
    load_tile_stats(base + static_cast<int64_t>(t) * n_masks, n_masks, e);
    if (t == t0) {
#pragma unroll
      for (int m = 0; m < K; ++m) first[m] = e[m];
    }
    finish_tile(x, e, n_masks, nullptr);
  }
  Run<K> total;
  block_scan(x, total, sm.scan);
  // pass 2: each tile's share, from the counts before it (B) and at the
  // last group end before it (C)
  u64 share[K];
#pragma unroll
  for (int m = 0; m < K; ++m) share[m] = 0;
  for (int t = t0; t < t1; ++t) {
    int4 e[K];
    if (t == t0) {
#pragma unroll
      for (int m = 0; m < K; ++m) e[m] = first[m];
    } else {
      load_tile_stats(base + static_cast<int64_t>(t) * n_masks, n_masks, e);
    }
    finish_tile(x, e, n_masks, share);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const u64 v = warp_sum(share[m]);
    if (lane == 0) sm.share[warp][m] = v;
  }
  __syncthreads();
  const int m = threadIdx.x;
  double auc = nan("");
  if (m < n_masks) {
    u64 rank2 = 0;
    for (int w = 0; w < kWarps; ++w) rank2 += sm.share[w][m];
    const u64 all = pick(total.t, m);
    const long long n_pos = static_cast<long long>(all & 0xffffffffu);
    const long long n_neg = static_cast<long long>(all >> 32) - n_pos;
    int64_t* out = counts + (static_cast<int64_t>(col) * n_masks + m) * 3;
    out[0] = n_pos;
    out[1] = n_neg;
    out[2] = static_cast<long long>(rank2);
    if (n_pos > 0 && n_neg > 0) {
      // (rank2 - n_pos (n_pos + 1)) / (2 n_pos n_neg), as the plain
      // version's f64 operations, each rounded on its own
      const double p = static_cast<double>(n_pos);
      const double q = static_cast<double>(n_neg);
      const double r = static_cast<double>(static_cast<long long>(rank2));
      auc = __ddiv_rn(__dsub_rn(r, __dmul_rn(p, __dadd_rn(p, 1.0))),
                      __dmul_rn(__dmul_rn(2.0, p), q));
    }
    aucs[static_cast<int64_t>(col) * n_masks + m] = auc;
  }
  return auc;
}

// kItems sorted positions a thread, kWords words of two masks each.
template <int kItems, int kWords>
__global__ void __launch_bounds__(kThreads)
rocauc_pass_kernel(const float* __restrict__ s_all,
                   const int64_t* __restrict__ order_all,
                   const uint8_t* __restrict__ packed_all, int64_t n,
                   int n_masks, unsigned* __restrict__ tickets,
                   int4* __restrict__ stats, double* __restrict__ col_auc,
                   int64_t* __restrict__ counts, float* __restrict__ auc) {
  constexpr int kTile = kThreads * kItems;
  static_assert(kItems % 4 == 0 && kItems <= 32, "4..32 nodes a thread");
  static_assert(kTile < 32768, "tile-local counts must fit 15 bits");
  __shared__ ScanSmem<kWords> scan_sm;
  __shared__ u64 s1_sm[kWarps][kWords];
  __shared__ u64 first_sm[kWords];
  __shared__ FinishSmem<2 * kWords> fin_sm;
  const int n_tiles = gridDim.x;
  const int n_cols = gridDim.y;
  const int col = blockIdx.y;
  const int t = blockIdx.x;
  const float* s = s_all + static_cast<int64_t>(col) * n;
  const int64_t* order = order_all + static_cast<int64_t>(col) * n;
  const uint8_t* packed = packed_all + static_cast<int64_t>(col) * n;

  // 1. this thread's kItems sorted positions (blocked), one read each
  const int64_t i0 = static_cast<int64_t>(t) * kTile + threadIdx.x * kItems;
  float sc[kItems + 1];
  int64_t ord[kItems];
  if (i0 + kItems <= n && aligned16(s + i0) && aligned16(order + i0)) {
#pragma unroll
    for (int j = 0; j < kItems; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(s + i0 + j);
      sc[j] = v.x;
      sc[j + 1] = v.y;
      sc[j + 2] = v.z;
      sc[j + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kItems; j += 2) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(order + i0 + j);
      ord[j] = v.x;
      ord[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i0 + j < n;
      sc[j] = in ? s[i0 + j] : 0.f;
      ord[j] = in ? order[i0 + j] : 0;
    }
  }
  sc[kItems] = i0 + kItems < n ? s[i0 + kItems] : 0.f;
  uint32_t bits[kItems];
  uint32_t ends = 0;  // bit j: position i0 + j ends its tie group
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = i0 + j;
    const bool in = i < n;
    bits[j] = in ? packed[ord[j]] : 0u;
    if (in && (i == n - 1 || sc[j] != sc[j + 1])) ends |= 1u << j;
  }

  // 2. the thread's counts and its counts at its last group end, all
  // masks at once; then the block scan over threads
  Run<kWords> x = identity<kWords>();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      x.t[w] += node_word(bits[j], w);
      if ((ends >> j) & 1u) x.l[w] = x.t[w];
    }
  }
  x.h = ends != 0;
  Run<kWords> tile;
  block_scan(x, tile, scan_sm);

  // 3. S1 over the group ends that have an earlier one in the tile; the
  // thread holding f_1 leaves its counts in shared memory
  u64 s1[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) s1[w] = 0;
  bool seen = x.h;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool end = (ends >> j) & 1u;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const u64 g = x.t[w] + node_word(bits[j], w);
      if (end) {
        if (seen)
          s1[w] += s1_term(g, x.l[w]);
        else
          first_sm[w] = g;
        x.l[w] = g;
      }
      x.t[w] = g;
    }
    seen = seen || end;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const u64 v = warp_sum(s1[w]);
    if (lane == 0) s1_sm[warp][w] = v;
  }
  __syncthreads();

  // 4. the tile's statistics, one thread a mask (the entry above
  // finish_tile)
  const int k = threadIdx.x;
  if (k < n_masks) {
    const int w = k >> 1, h = 2 * (k & 1);
    u64 s1_all = 0;
    for (int v = 0; v < kWarps; ++v) s1_all += s1_sm[v][w];
    const u64 all = pick(tile.t, w);
    const u64 first = tile.h ? first_sm[w] : 0;
    const u64 last = tile.h ? pick(tile.l, w) : 0;
    const unsigned has = tile.h ? 0x80000000u : 0u;
    int4 e;
    e.x = static_cast<int>(field(all, h) | field(all, h + 1) << 16 | has);
    e.y = static_cast<int>(field(first, h) | field(first, h + 1) << 16);
    e.z = static_cast<int>(field(last, h) | field(last, h + 1) << 16);
    e.w = tile.h ? static_cast<int>((s1_all >> (16 * h)) & 0xffffffffu) : 0;
    stats[(static_cast<int64_t>(col) * n_tiles + t) * n_masks + k] = e;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fin_sm.last = atomicAdd(tickets + col, 1u) == unsigned(n_tiles - 1);
  }
  __syncthreads();
  if (!fin_sm.last) return;

  // 5. the column's last block: the finish
  __threadfence();
  if (threadIdx.x == 0) tickets[col] = 0;  // for the next launch
  const double col_m =
      finish_column(stats, n_tiles, n_masks, col, counts, col_auc, fin_sm);
  const int m = threadIdx.x;
  if (n_cols == 1) {
    if (m < n_masks) auc[m] = __double2float_rn(col_m);
    return;
  }
  // 6. several columns: the last column to finish forms the nanmeans
  if (m < n_masks) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    fin_sm.last = atomicAdd(tickets + n_cols, 1u) == unsigned(n_cols - 1);
  }
  __syncthreads();
  if (!fin_sm.last) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[n_cols] = 0;
  if (m < n_masks) {
    double sum = 0.0, seen_cols = 0.0;
    for (int c = 0; c < n_cols; ++c) {
      const double a = __ldcg(col_auc + static_cast<int64_t>(c) * n_masks + m);
      if (!isnan(a)) {
        sum = __dadd_rn(sum, a);
        seen_cols = __dadd_rn(seen_cols, 1.0);
      }
    }
    auc[m] = __double2float_rn(__ddiv_rn(sum, seen_cols));
  }
}

struct Args {
  const float* s;
  const int64_t* order;
  const uint8_t* packed;
  int64_t n;
  int n_cols, n_masks;
  unsigned* tickets;
  int4* stats;
  double* col_auc;
  int64_t* counts;
  float* auc;
};

template <int kItems, int kWords>
void launch(const Args& a, cudaStream_t st) {
  constexpr int64_t kTile = kThreads * kItems;
  const dim3 grid(static_cast<unsigned>((a.n + kTile - 1) / kTile), a.n_cols);
  rocauc_pass_kernel<kItems, kWords><<<grid, kThreads, 0, st>>>(
      a.s, a.order, a.packed, a.n, a.n_masks, a.tickets, a.stats, a.col_auc,
      a.counts, a.auc);
}

// one instance per word count: registers sized to the masks evaluated
template <int kItems>
void launch_tile(const Args& a, cudaStream_t st) {
  switch ((a.n_masks + 1) / 2) {
    case 1:
      launch<kItems, 1>(a, st);
      break;
    case 2:
      launch<kItems, 2>(a, st);
      break;
    case 3:
      launch<kItems, 3>(a, st);
      break;
    default:
      launch<kItems, kMaxWords>(a, st);
  }
}

// The tile sizes compiled (nodes a block: 256 threads, 4 to 16 nodes each).
bool has_tile(int tile) { return tile == 1024 || tile == 2048 || tile == 4096; }

}  // namespace

// s_sorted, order, packed: [n_cols, n]; tickets: n_cols + 1 uint32, zero
// before the first launch and after every launch; stats: n_cols * n_tiles *
// n_masks * 4 int32; col_auc: n_cols * n_masks f64; counts: [n_cols,
// n_masks, 3] int64; auc: [n_masks] f32.
extern "C" int acm_k4_rocauc(const void* s_sorted, const void* order,
                             const void* packed, int64_t n, int n_cols,
                             int n_masks, int tile, void* tickets,
                             void* stats, void* col_auc, void* counts,
                             void* auc, void* stream) {
  if (n < 1 || n >= (1LL << 31) || n_cols < 1 || n_cols > 65535 ||
      n_masks < 1 || n_masks > kMaxMasks || !has_tile(tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(s_sorted),
               static_cast<const int64_t*>(order),
               static_cast<const uint8_t*>(packed),
               n,
               n_cols,
               n_masks,
               static_cast<unsigned*>(tickets),
               static_cast<int4*>(stats),
               static_cast<double*>(col_auc),
               static_cast<int64_t*>(counts),
               static_cast<float*>(auc)};
  auto st = static_cast<cudaStream_t>(stream);
  if (tile == 1024) {
    launch_tile<4>(a, st);
  } else if (tile == 2048) {
    launch_tile<8>(a, st);
  } else {
    launch_tile<16>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
