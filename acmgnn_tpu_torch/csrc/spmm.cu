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
// floor is the index stream (4 bytes a nonzero) plus the output; the
// operand (<= 10 MB at the training widths) stays in the 50 MB L2, so
// every nonzero also costs one L2 sector of gathered row.  Below that the
// limit is latency: each entry is an index load and then a dependent row
// load.  On the heavy-tailed genius graph the median row holds 4
// nonzeros, so a warp per row would leave most lanes idle and pay a
// 32-lane reduction per row; rows of 14 or 24 bytes would take one load
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
// order.  Products (valued halves) and the epilogue round each operation
// on its own (no fused multiply-add), so the replay's PyTorch arithmetic
// matches.
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

}  // namespace

// class_end: the end of each class's sorted rows (lanes 256, 32, ..., 1);
// class_end[6] == n_rows.  vals_bf16: the values are bf16 (then x is bf16
// too), else f32 (or none: vals == nullptr).
extern "C" int acm_k1_spmm(const void* indptr, const void* indices,
                           const void* vals, int vals_bf16,
                           const void* row_ids,
                           const void* x, int x_bf16, int64_t ld,
                           const void* z, const void* alpha, const void* beta,
                           const void* row_scale, void* out, int n_rows,
                           int d, const int* class_end, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
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
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* ri = static_cast<const int32_t*>(row_ids);
  const auto* zz = static_cast<const float*>(z);
  const auto* al = static_cast<const float*>(alpha);
  const auto* be = static_cast<const float*>(beta);
  const auto* rs = static_cast<const float*>(row_scale);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vals_bf16 && !x_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const auto* vl = static_cast<const float*>(vals);
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
