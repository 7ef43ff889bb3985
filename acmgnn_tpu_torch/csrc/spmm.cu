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
// into the store, so no concat/re-gather pass exists.  Value-free halves
// pass vals == nullptr (every slot weighs 1) and apply the per-row scale
// rs once after the sum; a transpose half's column scale is applied to the
// operand before the call.  x is bf16 or f32, accumulation is f32, z and
// out are f32.
//
// What bounds it on an H100: bytes.  Each traversal reads the 4-byte
// column index of every nonzero (13.76M at twitch scale, ~55 MB) plus the
// gathered operand rows; the operand itself (<= 2.7 MB at widths <= 8 in
// bf16) stays resident in the 50 MB L2, so the index stream is the HBM
// floor.  The design keeps that stream coalesced: one warp per row, lanes
// stride over the row's nonzeros (consecutive lanes read consecutive
// indices), each lane accumulates an 8-column tile in f32 registers, and a
// butterfly shuffle reduces the tile.  Degree-sorted rows keep the warps
// of a block at equal trip counts.  Operand rows are one 16-byte load per
// nonzero when the width is a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;   // columns per warp pass (grid.y walks the tiles)
constexpr int kWarps = 8;  // rows per 256-thread block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void load_scalar(const T* __restrict__ p,
                                            int nvalid, float (&v)[kTile]) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) v[j] = j < nvalid ? to_f32(p[j]) : 0.f;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&v)[kTile]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kTile / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[kTile]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// kVec: the width is a multiple of kTile, so every tile row is aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
spmm_rows_kernel(const int64_t* __restrict__ indptr,
                 const int32_t* __restrict__ indices,
                 const float* __restrict__ vals,
                 const int32_t* __restrict__ row_ids,
                 const T* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const float* __restrict__ row_scale,
                 float* __restrict__ out, int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_rows) return;  // the whole warp leaves together
  const int c0 = blockIdx.y * kTile;
  const int nvalid = min(kTile, d - c0);
  const int64_t beg = indptr[i];
  const int64_t end = indptr[i + 1];

  float acc[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
  for (int64_t e = beg + lane; e < end; e += 32) {
    const T* p = x + static_cast<int64_t>(indices[e]) * d + c0;
    float v[kTile];
    if constexpr (kVec) {
      load_vec(p, v);
    } else {
      load_scalar(p, nvalid, v);
    }
    if (vals != nullptr) {
      const float w = vals[e];
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] += w * v[j];
    } else {
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] += v[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }

  if (lane < nvalid) {
    float s = 0.f;  // acc[lane] without dynamic register indexing
#pragma unroll
    for (int j = 0; j < kTile; ++j) s = (j == lane) ? acc[j] : s;
    const int r = row_ids[i];
    const int col = c0 + lane;
    const int64_t o = static_cast<int64_t>(r) * d + col;
    if (row_scale != nullptr) s *= row_scale[r];
    float y = beta[col] * s;
    if (z != nullptr) y = alpha[col] * z[o] + y;
    out[o] = y;
  }
}

template <typename T>
void launch(const int64_t* indptr, const int32_t* indices, const float* vals,
            const int32_t* row_ids, const T* x, const float* z,
            const float* alpha, const float* beta, const float* row_scale,
            float* out, int n_rows, int d, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps, (d + kTile - 1) / kTile);
  const dim3 block(kWarps * 32);
  if (d % kTile == 0) {
    spmm_rows_kernel<T, true><<<grid, block, 0, stream>>>(
        indptr, indices, vals, row_ids, x, z, alpha, beta, row_scale, out,
        n_rows, d);
  } else {
    spmm_rows_kernel<T, false><<<grid, block, 0, stream>>>(
        indptr, indices, vals, row_ids, x, z, alpha, beta, row_scale, out,
        n_rows, d);
  }
}

}  // namespace

extern "C" int acm_k1_spmm(const void* indptr, const void* indices,
                           const void* vals, const void* row_ids,
                           const void* x, int x_bf16, const void* z,
                           const void* alpha, const void* beta,
                           const void* row_scale, void* out, int n_rows,
                           int d, void* stream) {
  if (n_rows > 0 && d > 0) {
    const auto* ip = static_cast<const int64_t*>(indptr);
    const auto* ix = static_cast<const int32_t*>(indices);
    const auto* vl = static_cast<const float*>(vals);
    const auto* ri = static_cast<const int32_t*>(row_ids);
    const auto* zz = static_cast<const float*>(z);
    const auto* al = static_cast<const float*>(alpha);
    const auto* be = static_cast<const float*>(beta);
    const auto* rs = static_cast<const float*>(row_scale);
    auto* o = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (x_bf16) {
      launch(ip, ix, vl, ri, static_cast<const __nv_bfloat16*>(x), zz, al, be,
             rs, o, n_rows, d, s);
    } else {
      launch(ip, ix, vl, ri, static_cast<const float*>(x), zz, al, be, rs, o,
             n_rows, d, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
