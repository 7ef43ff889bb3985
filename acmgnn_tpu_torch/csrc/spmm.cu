// K1 — row-gather SpMM with a per-column epilogue (sm_90a).
//
//   out[r, j] = alpha[j] * z[r, j] + beta[j] * rs[r] * sum_{e in row r} w_e * x[col_e, j]
//
// Replaces the bucketed-ELL SpMM of acmgnn_tpu/ops/ell.py
// (_bucket_spmm / _half_spmm / ell_spmm and its VJP) and the fused
// multi-operand gather of acmgnn_tpu/ops/spmm.py (spmm_multi with its
// high-pass `z - Az` epilogue and the prefix-gradient transpose).
//
// Layout: degree-sorted CSR.  Row i of the sorted order holds the
// structure of original row row_ids[i]; the inverse permutation is folded
// into the store.  Value-free halves pass vals == nullptr (every slot
// weighs 1) and apply the row scale rs once after the sum; a transpose
// half's column scale is applied to the operand before the call.  x is
// bf16 or f32 with a row stride ld >= d, accumulation is f32, z and out
// are f32 [n_rows, d].  Valued halves (symmetric normalization, weighted
// graphs) store w_e in the gather dtype, as the JAX package's value
// planes (ell.py:547-553): with bf16 values and operand each term w_e *
// x is rounded to bf16 (the product of two bf16 values is exact in f32,
// so that is JAX's one rounding) and added in f32; f32 values round the
// product to f32.
//
// What bounds it on an H100: bytes and, below them, latency.  The HBM
// floor is the index stream (4 bytes a nonzero) plus the output; an
// operand of the narrow widths (<= 10 MB) stays in the 50 MB L2, so every
// nonzero also costs one L2 sector of gathered row.  Below that the limit
// is latency: each entry is an index load and then a dependent row load.
// K1 has two forms, chosen on the host by a row's bytes (ops/ell.py
// k1_form, K1_WIDE_BYTES) and passed in `form`.
//
// The narrow form (rows of a few to a few tens of bytes: the headline's
// and genius's w4-w12).  On the heavy-tailed genius graph the median row
// holds 4 nonzeros, so a warp per row would leave most lanes idle and pay
// a 32-lane reduction per row; rows of 14 or 24 bytes would take one load
// per element, or straddle two L2 sectors.  The design:
//   - gives each row a group of lanes sized by its degree alone: g in
//     {1, 2, 4, 8, 16, 32} (about 8 entries a lane), or a whole block of
//     256 lanes for hub rows (degree > 256).  Rows are degree-sorted, so
//     each size covers a contiguous range of sorted rows; the host passes
//     the class boundaries (ops/ell.py k1_lanes) and each block finds its
//     class from its index;
//   - walks a row's indices once for up to 16 columns (8-column tiles
//     for d <= 8 keep registers, so warps in flight, up), each lane
//     keeping 2 entries' loads in flight;
//   - loads an operand row with the widest vector its byte size and
//     stride allow (a zero-padded stride makes 14- and 24-byte bf16 rows
//     one 16- or 32-byte load sequence, see ops/ell.py k1_operand);
//   - stores each row whole, in float4 pieces where d % 4 == 0.
// Summation order (replayed bit for bit by ops/ell.py k1_order_replay):
// lane l of a g-lane group sums entries l, l+g, ... in turn, a butterfly
// over lane offsets g/2 ... 1 adds the partials; a hub row's 8 warps each
// reduce over offsets 16 ... 1 and their 8 partials are added in warp
// order.
//
// The wide form (rows of K1_WIDE_BYTES or more: penn94_pp's w64, w128 and
// w4814, wiki's w128 and w600).  There the narrow form walked a row's
// indices once per 16 columns (w128 8 times, w600 38), and on wiki the
// operand (493 MB at w128) does not fit L2, so a gathered row came from
// HBM in as many visits.  The design:
//   - lanes along the columns: each lane owns 16-byte vectors of the row
//     (8 bf16 or 4 f32 columns), L lanes a row, the row's vector count
//     rounded up to a power of two, at most 32 (bf16 w64: 8 lanes, 4 rows
//     a warp; w128 16; w600 32 lanes of 3 vectors), so consecutive lanes
//     fetch a gathered row whole and every sector is used once a pass;
//   - a pass covers at most kMaxVecs vectors a lane (2 KB of a bf16
//     row): w4814 walks its indices 5 times;
//   - a group loads up to L of the row's indices (and values) in one
//     coalesced, streaming (__ldcs: they do not evict gathered rows from
//     L2) read and broadcasts each with a shuffle; each lane keeps U
//     entries' row loads in flight;
//   - each column sums its entries in entry order, one at a time: no
//     cross-lane reduction;
//   - hub rows (degree > 256, class 0) take a block: warp w sums entries
//     w, w+8, ... in order, and the 8 partials are added in warp order
//     through shared memory;
//   - the output is stored with __stcs, in float4 pieces where d % 4 ==
//     0.  The operand's base and row bytes must be 16-byte aligned
//     (ops/ell.py k1_operand pads wide rows to 16 bytes); otherwise the
//     launch is refused, never run in the narrow form.
// Products (valued halves) and the epilogue of both forms round each
// operation on its own (no fused multiply-add), so the replay's PyTorch
// arithmetic matches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one block; a hub row takes all of it
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 16;   // columns per walk over a row's indices
constexpr int kUnroll = 2;     // entries a lane has in flight
constexpr int kClasses = 7;    // lanes per row: 256 (hub), 32, 16, ..., 1

struct Classes {
  int row_end[kClasses];    // sorted rows [row_end[c-1], row_end[c]): class c
  int block_end[kClasses];  // blocks [block_end[c-1], block_end[c]): class c
};

__host__ __device__ constexpr int class_lanes(int c) {
  return c == 0 ? kThreads : 64 >> c;
}

template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// 32-bit word k of a loaded vector (k is a constant after unrolling)
__device__ __forceinline__ unsigned word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(const uint2& r, int k) {
  return k == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }

// element i of a loaded vector as f32 (a bf16 is the top half of an f32)
template <typename T, typename R>
__device__ __forceinline__ float element(const R& r, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, i));
  } else {
    const unsigned w = word(r, i >> 1);
    return __uint_as_float((i & 1 ? w >> 16 : w & 0xffffu) << 16);
  }
}

// The partial sums of one tile of a row, for one lane: entries
// beg + lane, beg + lane + stride, ... in order.
// a valued term w * v in the values' type W, as f32
template <typename W>
__device__ __forceinline__ float term(float w, float v) {
  const float p = __fmul_rn(w, v);
  if constexpr (sizeof(W) == 2) {
    return __bfloat162float(__float2bfloat16_rn(p));
  } else {
    return p;
  }
}

template <typename W>
__device__ __forceinline__ float value(const W* vals, int64_t e) {
  if constexpr (sizeof(W) == 2) {
    return __bfloat162float(vals[e]);
  } else {
    return __ldg(vals + e);
  }
}

template <typename T, typename W, int VB, int kTile>
__device__ __forceinline__ void gather_tile(
    const int32_t* __restrict__ indices, const W* __restrict__ vals,
    const T* __restrict__ x, int64_t ld, int c0, int dt, int64_t beg,
    int64_t end, int lane, int stride, float (&acc)[kTile]) {
  using R = typename Raw<VB>::type;
  constexpr int kPer = VB / sizeof(T);  // columns per load
  constexpr int kMax = kTile / kPer;    // loads per tile
  const int nload = (dt + kPer - 1) / kPer;
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
  for (int64_t e0 = beg + lane; e0 < end; e0 += kUnroll * stride) {
    int col[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = e0 + static_cast<int64_t>(u) * stride;
      col[u] = e < end ? __ldg(indices + e) : -1;
    }
    R raw[kUnroll][kMax];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (col[u] >= 0) {
        const R* p = reinterpret_cast<const R*>(
            x + static_cast<int64_t>(col[u]) * ld + c0);
#pragma unroll
        for (int k = 0; k < kMax; ++k) {
          if (k < nload) raw[u][k] = __ldg(p + k);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (col[u] < 0) continue;
      const float w = vals != nullptr
          ? value<W>(vals, e0 + static_cast<int64_t>(u) * stride) : 1.f;
#pragma unroll
      for (int k = 0; k < kMax; ++k) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int j = k * kPer + i;
          if (j < dt) {
            const float v = element<T>(raw[u][k], i);
            acc[j] = vals != nullptr ? __fadd_rn(acc[j], term<W>(w, v))
                                     : acc[j] + v;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ float epilogue(float s, float rs, int col,
                                          int64_t o,
                                          const float* __restrict__ z,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ beta) {
  float y = __fmul_rn(__ldg(beta + col), __fmul_rn(s, rs));
  if (z != nullptr) y = __fadd_rn(__fmul_rn(__ldg(alpha + col), z[o]), y);
  return y;
}

// kTile: 8 columns for d <= 8 (fewer registers, more warps in flight),
// else 16.
template <typename T, typename W, int VB, int kTile>
__global__ void __launch_bounds__(kThreads)
spmm_rows_kernel(const int64_t* __restrict__ indptr,
                 const int32_t* __restrict__ indices,
                 const W* __restrict__ vals,
                 const int32_t* __restrict__ row_ids,
                 const T* __restrict__ x, int64_t ld,
                 const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const float* __restrict__ row_scale,
                 float* __restrict__ out, int d, bool vec_store,
                 Classes cls) {
  __shared__ float part[kWarps][kTile];
  int c = 0;  // this block's class
#pragma unroll
  for (int k = 0; k < kClasses - 1; ++k)
    c += static_cast<int>(blockIdx.x) >= cls.block_end[k];
  const int lane = threadIdx.x & 31;

  if (c == 0) {  // hub row: the whole block, one row
    const int i = blockIdx.x;
    const int64_t beg = indptr[i], end = indptr[i + 1];
    const int r = row_ids[i];
    const float rs = row_scale != nullptr ? row_scale[r] : 1.f;
    for (int c0 = 0; c0 < d; c0 += kTile) {
      const int dt = min(kTile, d - c0);
      float acc[kTile];
      gather_tile<T, W, VB, kTile>(indices, vals, x, ld, c0, dt, beg, end,
                                   threadIdx.x, kThreads, acc);
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < dt) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) part[threadIdx.x >> 5][j] = acc[j];
      }
      __syncthreads();
      if (threadIdx.x < dt) {
        float s = part[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][threadIdx.x];
        const int col = c0 + threadIdx.x;
        const int64_t o = static_cast<int64_t>(r) * d + col;
        out[o] = epilogue(s, rs, col, o, z, alpha, beta);
      }
      __syncthreads();
    }
    return;
  }

  const int g = class_lanes(c);
  const int lig = threadIdx.x & (g - 1);  // lane in the row's group
  const int i = cls.row_end[c - 1]
      + (static_cast<int>(blockIdx.x) - cls.block_end[c - 1]) * (kThreads / g)
      + static_cast<int>(threadIdx.x) / g;
  // a group past the class's last row idles through the shuffles
  const bool valid = i < cls.row_end[c];
  const int64_t beg = valid ? indptr[i] : 0;
  const int64_t end = valid ? indptr[i + 1] : 0;
  const int r = valid ? row_ids[i] : 0;
  const float rs = valid && row_scale != nullptr ? row_scale[r] : 1.f;
  for (int c0 = 0; c0 < d; c0 += kTile) {
    const int dt = min(kTile, d - c0);
    float acc[kTile];
    gather_tile<T, W, VB, kTile>(indices, vals, x, ld, c0, dt, beg, end, lig,
                                 g, acc);
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < dt) {
        for (int off = g >> 1; off > 0; off >>= 1)
          acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    if (!valid) continue;
    const int64_t o = static_cast<int64_t>(r) * d + c0;
    if (vec_store) {  // the group's lanes store the row's float4 pieces
#pragma unroll
      for (int p = 0; p < kTile / 4; ++p) {
        if (4 * p < dt && (p & (g - 1)) == lig) {
          float4 y;
          y.x = epilogue(acc[4 * p], rs, c0 + 4 * p, o + 4 * p, z, alpha,
                         beta);
          y.y = epilogue(acc[4 * p + 1], rs, c0 + 4 * p + 1, o + 4 * p + 1,
                         z, alpha, beta);
          y.z = epilogue(acc[4 * p + 2], rs, c0 + 4 * p + 2, o + 4 * p + 2,
                         z, alpha, beta);
          y.w = epilogue(acc[4 * p + 3], rs, c0 + 4 * p + 3, o + 4 * p + 3,
                         z, alpha, beta);
          *reinterpret_cast<float4*>(out + o + 4 * p) = y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < dt && (j & (g - 1)) == lig)
          out[o + j] = epilogue(acc[j], rs, c0 + j, o + j, z, alpha, beta);
      }
    }
  }
}

template <typename T, typename W, int VB>
void launch(const int64_t* indptr, const int32_t* indices, const W* vals,
            const int32_t* row_ids, const T* x, int64_t ld, const float* z,
            const float* alpha, const float* beta, const float* row_scale,
            float* out, int d, const Classes& cls, cudaStream_t stream) {
  // float4 stores of out (and loads of z) where every row is aligned
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_store =
      d % 4 == 0 && aligned(out) && (z == nullptr || aligned(z));
  const unsigned blocks = cls.block_end[kClasses - 1];
  if (d <= 8) {
    spmm_rows_kernel<T, W, VB, 8><<<blocks, kThreads, 0, stream>>>(
        indptr, indices, vals, row_ids, x, ld, z, alpha, beta, row_scale,
        out, d, vec_store, cls);
  } else {
    spmm_rows_kernel<T, W, VB, kMaxTile><<<blocks, kThreads, 0, stream>>>(
        indptr, indices, vals, row_ids, x, ld, z, alpha, beta, row_scale,
        out, d, vec_store, cls);
  }
}

// The widest load (16, 8, 4 bytes, else one element) that every operand
// row's start and stride are aligned to; a 16-column tile's loads then
// stay inside the row's ld elements.
template <typename T, typename W>
void dispatch(const int64_t* ip, const int32_t* ix, const W* vl,
              const int32_t* ri, const void* x, int64_t ld, const float* zz,
              const float* al, const float* be, const float* rs, float* o,
              int d, const Classes& cls, cudaStream_t s) {
  const auto* xx = static_cast<const T*>(x);
  const int64_t row_bytes = ld * static_cast<int64_t>(sizeof(T));
  const auto addr = reinterpret_cast<uintptr_t>(x);
  auto fits = [&](int vb) { return row_bytes % vb == 0 && addr % vb == 0; };
  if (fits(16)) {
    launch<T, W, 16>(ip, ix, vl, ri, xx, ld, zz, al, be, rs, o, d, cls, s);
  } else if (fits(8)) {
    launch<T, W, 8>(ip, ix, vl, ri, xx, ld, zz, al, be, rs, o, d, cls, s);
  } else if (sizeof(T) == 4 || fits(4)) {
    launch<T, W, 4>(ip, ix, vl, ri, xx, ld, zz, al, be, rs, o, d, cls, s);
  } else {
    launch<T, W, sizeof(T)>(ip, ix, vl, ri, xx, ld, zz, al, be, rs, o, d,
                            cls, s);
  }
}

// ---------------------------------------------------------------------------
// The wide form
// ---------------------------------------------------------------------------

constexpr int kMaxVecs = 4;    // 16-byte vectors a lane holds in one pass

// a value of a valued half, read once (streaming)
template <typename W>
__device__ __forceinline__ float value_cs(const W* vals, int64_t e) {
  if constexpr (sizeof(W) == 2) {
    const unsigned short u =
        __ldcs(reinterpret_cast<const unsigned short*>(vals) + e);
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  } else {
    return __ldcs(reinterpret_cast<const float*>(vals) + e);
  }
}

// One pass over entries first, first + step, ... (count of them) for the
// vectors vec0, vec0 + L, ... (V of them, those below nvec) of each
// gathered row: a group of `width` lanes (shuffle mask `mask`, this
// lane's index `src`) reads `width` indices at once, then every lane
// adds the entries in order, U rows' loads in flight.
template <typename T, typename W, int V, int U>
__device__ __forceinline__ void walk_wide(
    const int32_t* __restrict__ indices, const W* __restrict__ vals,
    const T* __restrict__ x, int64_t ld, int64_t first, int step,
    int count, int src, int width, unsigned mask, int vec0, int L,
    int nvec, float (&acc)[V][16 / sizeof(T)]) {
  constexpr int kPer = 16 / sizeof(T);  // columns a vector
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[v][i] = 0.f;
  }
  for (int c0 = 0; c0 < count; c0 += width) {
    const int n = min(width, count - c0);
    int my_col = 0;
    float my_w = 1.f;
    if (src < n) {
      const int64_t e = first + static_cast<int64_t>(c0 + src) * step;
      my_col = __ldcs(reinterpret_cast<const int*>(indices) + e);
      if (vals != nullptr) my_w = value_cs<W>(vals, e);
    }
    for (int k = 0; k < n; k += U) {
      int col[U];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        col[u] = __shfl_sync(mask, my_col, k + u, width);
        w[u] = vals != nullptr ? __shfl_sync(mask, my_w, k + u, width) : 1.f;
      }
      uint4 raw[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u < n) {
          const uint4* p = reinterpret_cast<const uint4*>(
              x + static_cast<int64_t>(col[u]) * ld);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (vec0 + v * L < nvec) raw[u][v] = __ldg(p + vec0 + v * L);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u < n) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (vec0 + v * L < nvec) {
#pragma unroll
              for (int i = 0; i < kPer; ++i) {
                const float xv = element<T>(raw[u][v], i);
                acc[v][i] = vals != nullptr
                    ? __fadd_rn(acc[v][i], term<W>(w[u], xv))
                    : acc[v][i] + xv;
              }
            }
          }
        }
      }
    }
  }
}

// the epilogue of one output element whose residual value is zv
__device__ __forceinline__ float epilogue_z(float s, float rs, int col,
                                            float zv, bool has_z,
                                            const float* __restrict__ alpha,
                                            const float* __restrict__ beta) {
  float y = __fmul_rn(__ldg(beta + col), __fmul_rn(s, rs));
  if (has_z) y = __fadd_rn(__fmul_rn(__ldg(alpha + col), zv), y);
  return y;
}

// V: vectors a lane holds in a pass; U: entries in flight.  Blocks below
// `hubs` take one hub row each; the others 256 / L rows of L lanes.
template <typename T, typename W, int V, int U>
__global__ void __launch_bounds__(kThreads)
spmm_wide_kernel(const int64_t* __restrict__ indptr,
                 const int32_t* __restrict__ indices,
                 const W* __restrict__ vals,
                 const int32_t* __restrict__ row_ids,
                 const T* __restrict__ x, int64_t ld,
                 const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const float* __restrict__ row_scale,
                 float* __restrict__ out, int d, int n_rows, int hubs,
                 int lanes_log2, bool vec_store) {
  constexpr int kPer = 16 / sizeof(T);
  __shared__ __align__(16) float part[kWarps][32 * V * kPer];
  const int L = 1 << lanes_log2;
  const int nvec = (d + kPer - 1) / kPer;
  const int lane = threadIdx.x & 31;
  float acc[V][kPer];

  if (static_cast<int>(blockIdx.x) < hubs) {  // hub row: the whole block
    const int i = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int64_t beg = indptr[i], end = indptr[i + 1];
    const int count = static_cast<int>((end - beg - warp + kWarps - 1)
                                       / kWarps);
    const int r = row_ids[i];
    const float rs = row_scale != nullptr ? row_scale[r] : 1.f;
    for (int v0 = 0; v0 < nvec; v0 += L * V) {
      const int vec0 = lane < L ? v0 + lane : nvec;
      walk_wide<T, W, V, U>(indices, vals, x, ld, beg + warp, kWarps, count,
                            lane, 32, 0xffffffffu, vec0, L, nvec, acc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (vec0 + v * L < nvec) {
          float4* p = reinterpret_cast<float4*>(
              &part[warp][(lane + v * L) * kPer]);
#pragma unroll
          for (int q = 0; q < kPer / 4; ++q) {
            p[q] = make_float4(acc[v][4 * q], acc[v][4 * q + 1],
                               acc[v][4 * q + 2], acc[v][4 * q + 3]);
          }
        }
      }
      __syncthreads();
      const int c_beg = v0 * kPer;
      const int ncols = min(L * V * kPer, d - c_beg);
      for (int c = threadIdx.x; c < ncols; c += kThreads) {
        float s = part[0][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += part[w][c];
        const int col = c_beg + c;
        const int64_t o = static_cast<int64_t>(r) * d + col;
        __stcs(out + o, epilogue(s, rs, col, o, z, alpha, beta));
      }
      __syncthreads();
    }
    return;
  }

  const int lig = threadIdx.x & (L - 1);  // lane in the row's group
  const int i = hubs
      + (static_cast<int>(blockIdx.x) - hubs) * (kThreads >> lanes_log2)
      + (static_cast<int>(threadIdx.x) >> lanes_log2);
  if (i >= n_rows) return;  // the whole group leaves together
  const unsigned mask = L == 32 ? 0xffffffffu
      : ((1u << L) - 1u) << (lane & ~(L - 1));
  const int64_t beg = indptr[i], end = indptr[i + 1];
  const int r = row_ids[i];
  const float rs = row_scale != nullptr ? row_scale[r] : 1.f;
  const bool has_z = z != nullptr;
  for (int v0 = 0; v0 < nvec; v0 += L * V) {
    const int vec0 = v0 + lig;
    walk_wide<T, W, V, U>(indices, vals, x, ld, beg, 1,
                          static_cast<int>(end - beg), lig, L, mask, vec0,
                          L, nvec, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int vec = vec0 + v * L;
      if (vec >= nvec) continue;
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const int col = vec * kPer + 4 * q;
        if (col >= d) continue;
        const int64_t o = static_cast<int64_t>(r) * d + col;
        if (vec_store) {  // d % 4 == 0: the piece lies inside the row
          const float4 zv = has_z
              ? __ldcs(reinterpret_cast<const float4*>(z + o))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 y;
          y.x = epilogue_z(acc[v][4 * q], rs, col, zv.x, has_z, alpha, beta);
          y.y = epilogue_z(acc[v][4 * q + 1], rs, col + 1, zv.y, has_z,
                           alpha, beta);
          y.z = epilogue_z(acc[v][4 * q + 2], rs, col + 2, zv.z, has_z,
                           alpha, beta);
          y.w = epilogue_z(acc[v][4 * q + 3], rs, col + 3, zv.w, has_z,
                           alpha, beta);
          __stcs(reinterpret_cast<float4*>(out + o), y);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col + j < d) {
              __stcs(out + o + j, epilogue(acc[v][4 * q + j], rs, col + j,
                                           o + j, z, alpha, beta));
            }
          }
        }
      }
    }
  }
}

// entries in flight a lane by vectors a lane holds (U x V 16-byte
// loads): 4, and 8 at 4 vectors (2, 4 and 8 were measured on penn94_pp,
// twitch and wiki: PERF.md)
constexpr int default_unroll(int v) { return v == kMaxVecs ? 8 : 4; }

template <typename T, typename W, int V>
void launch_wide(unsigned blocks, const int64_t* ip, const int32_t* ix,
                 const W* vl, const int32_t* ri, const T* x, int64_t ld,
                 const float* zz, const float* al, const float* be,
                 const float* rs, float* o, int d, int n_rows, int hubs,
                 int lanes_log2, bool vec_store, cudaStream_t s) {
  spmm_wide_kernel<T, W, V, default_unroll(V)><<<blocks, kThreads, 0, s>>>(
      ip, ix, vl, ri, x, ld, zz, al, be, rs, o, d, n_rows, hubs, lanes_log2,
      vec_store);
}

// The wide form's plan: L lanes a row (the row's 16-byte vectors rounded
// up to a power of two, at most 32), V vectors a lane in a pass (at most
// kMaxVecs).  The operand's base and row bytes must be 16-byte aligned.
template <typename T, typename W>
int wide(const int64_t* ip, const int32_t* ix, const W* vl,
         const int32_t* ri, const void* x, int64_t ld, const float* zz,
         const float* al, const float* be, const float* rs, float* o,
         int d, int n_rows, int hubs, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0
      || (ld * static_cast<int64_t>(sizeof(T))) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int nvec = (d + kPer - 1) / kPer;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < nvec && lanes_log2 < 5) ++lanes_log2;
  const int L = 1 << lanes_log2;
  const int vecs = min(kMaxVecs, (nvec + L - 1) / L);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_store =
      d % 4 == 0 && aligned(o) && (zz == nullptr || aligned(zz));
  const int per_block = kThreads / L;
  const unsigned blocks =
      hubs + (n_rows - hubs + per_block - 1) / per_block;
  const auto* xx = static_cast<const T*>(x);
  switch (vecs) {
#define ACM_K1_V(V)                                                       \
  case V:                                                                 \
    launch_wide<T, W, V>(blocks, ip, ix, vl, ri, xx, ld, zz, al, be, rs,  \
                         o, d, n_rows, hubs, lanes_log2, vec_store, s);   \
    return 0
    ACM_K1_V(1);
    ACM_K1_V(2);
    ACM_K1_V(3);
    ACM_K1_V(4);
#undef ACM_K1_V
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// class_end: the end of each class's sorted rows (lanes 256, 32, ..., 1);
// class_end[6] == n_rows; the wide form reads only class_end[0], the
// end of the hub rows.  vals_bf16: the values are bf16 (then x is bf16
// too), else f32 (or none: vals == nullptr).  form: 0 narrow, 1 wide.
extern "C" int acm_k1_spmm(const void* indptr, const void* indices,
                           const void* vals, int vals_bf16,
                           const void* row_ids,
                           const void* x, int x_bf16, int64_t ld,
                           const void* z, const void* alpha, const void* beta,
                           const void* row_scale, void* out, int n_rows,
                           int d, const int* class_end, int form,
                           void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (vals_bf16 && !x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* ri = static_cast<const int32_t*>(row_ids);
  const auto* zz = static_cast<const float*>(z);
  const auto* al = static_cast<const float*>(alpha);
  const auto* be = static_cast<const float*>(beta);
  const auto* rs = static_cast<const float*>(row_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* vl = static_cast<const float*>(vals);
  if (form == 1) {
    const int hubs = class_end[0];
    int rc;
    if (vals_bf16) {
      rc = wide<__nv_bfloat16, __nv_bfloat16>(
          ip, ix, static_cast<const __nv_bfloat16*>(vals), ri, x, ld, zz, al,
          be, rs, o, d, n_rows, hubs, s);
    } else if (x_bf16) {
      rc = wide<__nv_bfloat16, float>(ip, ix, vl, ri, x, ld, zz, al, be, rs,
                                      o, d, n_rows, hubs, s);
    } else {
      rc = wide<float, float>(ip, ix, vl, ri, x, ld, zz, al, be, rs, o, d,
                              n_rows, hubs, s);
    }
    return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
  }
  if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
  Classes cls;
  int rows0 = 0, blocks = 0;
  for (int c = 0; c < kClasses; ++c) {
    const int rows = class_end[c] - rows0;
    const int per_block = c == 0 ? 1 : kThreads / class_lanes(c);
    blocks += (rows + per_block - 1) / per_block;
    cls.row_end[c] = class_end[c];
    cls.block_end[c] = blocks;
    rows0 = class_end[c];
  }
  if (blocks > 0) {
    if (vals_bf16) {
      dispatch<__nv_bfloat16, __nv_bfloat16>(
          ip, ix, static_cast<const __nv_bfloat16*>(vals), ri, x, ld, zz, al,
          be, rs, o, d, cls, s);
    } else if (x_bf16) {
      dispatch<__nv_bfloat16, float>(ip, ix, vl, ri, x, ld, zz, al, be, rs,
                                     o, d, cls, s);
    } else {
      dispatch<float, float>(ip, ix, vl, ri, x, ld, zz, al, be, rs, o, d,
                             cls, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
