// K5 — nonzero-balanced COO SpMM with a per-column epilogue (sm_90a).
//
//   out[r, j] = alpha[j] * z[r, j] + beta[j] * sum_{k: row[k] = r} val[k] * x[col[k], j]
//
// Replaces the COO SpMM of acmgnn_tpu/ops/spmm.py (_coo_matvec_rows, the
// gather + sorted segment_sum, and _coo_spmm with its VJP, which runs the
// same product over the transpose triplets).  The epilogue is K1's
// (csrc/spmm.cu), so the high-pass `z - Az` and the backward's identity
// path are written directly.  Operand, values and sums are f32.
//
// What bounds it on an H100: bytes.  Each product reads 12 bytes per
// nonzero (row, col, val: 29 MB at genius scale) plus the operand,
// residual and output rows once; the gathered operand rows (<= 20 MB at
// width 12) mostly hit the 50 MB L2.
//
// Why nonzero-balanced: on heavy-tailed graphs a row-per-warp kernel
// (K1) gives an 8,930-entry hub row and a 4-entry median row one warp
// each.  Here every thread takes an equal slice of `slice_nnz` triplets:
//   - launch 1 (coo_slices_kernel): each thread walks its slice in order,
//     keeping an 8-column f32 tile.  A row that starts and ends inside
//     the slice is stored with the epilogue.  A row continued from the
//     previous slice leaves its partial sum in carry[2s]; a row continued
//     into the next slice leaves it in carry[2s + 1].
//   - launch 2 (coo_spans_kernel): one warp per row that crosses a slice
//     boundary (first slice f, last slice l, found on the host) sums
//     carry[2f + 1], carry[2(f+1)], ..., carry[2l] in a fixed order (lane
//     stride, then a butterfly) and stores the row; further warps store
//     the rows that have no triplet (alpha * z).
// No atomics, so two runs agree bit for bit.  Every row of `out` is
// written exactly once.
//
// `slice_offset` shifts the slice grid: slice s holds triplets
// [s * slice_nnz - slice_offset, (s + 1) * slice_nnz - slice_offset), the
// first one cut short.  A rank's block of a sharded matrix passes its
// first triplet's position in the whole matrix modulo slice_nnz, so each
// of its rows is split, and summed, as in the whole matrix's half.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;       // columns per thread (grid.y walks the tiles)
constexpr int kThreads = 128;  // slices per block in launch 1
constexpr int kWarps = 8;      // spanning rows per block in launch 2

// kVec: d is a multiple of 4, so every tile of a row is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         int nvalid, float (&v)[kTile]) {
  if constexpr (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    if (nvalid > 4) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      v[4] = v[5] = v[6] = v[7] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[j] = j < nvalid ? __ldg(p + j) : 0.f;
  }
}

__device__ __forceinline__ void store_row(const float (&acc)[kTile], int r,
                                          int c0, int nvalid, int d,
                                          const float* __restrict__ z,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ beta,
                                          float* __restrict__ out) {
  const int64_t o = static_cast<int64_t>(r) * d + c0;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j < nvalid) {
      float y = beta[c0 + j] * acc[j];
      if (z != nullptr) y = alpha[c0 + j] * z[o + j] + y;
      out[o + j] = y;
    }
  }
}

__device__ __forceinline__ void store_carry(const float (&acc)[kTile],
                                            int64_t slot, int c0, int nvalid,
                                            int d, float* __restrict__ carry) {
  const int64_t o = slot * d + c0;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (j < nvalid) carry[o + j] = acc[j];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
coo_slices_kernel(const int32_t* __restrict__ row,
                  const int32_t* __restrict__ col,
                  const float* __restrict__ val, int64_t nnz, int slice_nnz,
                  int slice_offset, int64_t n_slices,
                  const float* __restrict__ x,
                  const float* __restrict__ z, const float* __restrict__ alpha,
                  const float* __restrict__ beta, float* __restrict__ carry,
                  float* __restrict__ out, int d) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n_slices) return;
  const int c0 = blockIdx.y * kTile;
  const int nvalid = min(kTile, d - c0);
  const int64_t end = (s + 1) * slice_nnz - slice_offset;
  const int64_t a = s > 0 ? end - slice_nnz : 0;
  const int64_t b = end < nnz ? end : nnz;
  const bool head_open = a > 0 && row[a - 1] == row[a];
  const bool tail_open = b < nnz && row[b] == row[b - 1];

  float acc[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
  int r = row[a];
  bool first = true;  // the current run is the slice's first
  for (int64_t e = a; e < b; ++e) {
    const int re = row[e];
    if (re != r) {  // the run of r ended at e - 1, inside the slice
      if (first && head_open) {
        store_carry(acc, 2 * s, c0, nvalid, d, carry);
      } else {
        store_row(acc, r, c0, nvalid, d, z, alpha, beta, out);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
      r = re;
      first = false;
    }
    float v[kTile];
    load_row<kVec>(x + static_cast<int64_t>(col[e]) * d + c0, nvalid, v);
    const float w = val[e];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] += w * v[j];
  }
  if (first && head_open) {  // one run, continued from before
    store_carry(acc, 2 * s, c0, nvalid, d, carry);
  } else if (tail_open) {    // continued into the next slice
    store_carry(acc, 2 * s + 1, c0, nvalid, d, carry);
  } else {
    store_row(acc, r, c0, nvalid, d, z, alpha, beta, out);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
coo_spans_kernel(const int32_t* __restrict__ span_rows,
                 const int32_t* __restrict__ span_first,
                 const int32_t* __restrict__ span_last, int n_span,
                 const int32_t* __restrict__ empty_rows, int n_empty,
                 const float* __restrict__ carry, const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta, float* __restrict__ out,
                 int d) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_span + n_empty) return;  // the whole warp leaves together
  const int c0 = blockIdx.y * kTile;
  const int nvalid = min(kTile, d - c0);

  float acc[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
  int r;
  if (i < n_span) {
    r = span_rows[i];
    const int64_t f = span_first[i];
    const int64_t parts = span_last[i] - f + 1;
    for (int64_t k = lane; k < parts; k += 32) {
      // the first slice left its tail, every later one its head
      const int64_t slot = k == 0 ? 2 * f + 1 : 2 * (f + k);
      const float* p = carry + slot * d + c0;
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] += j < nvalid ? p[j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
  } else {
    r = empty_rows[i - n_span];
  }
  if (lane < nvalid) {
    float s = 0.f;  // acc[lane] without dynamic register indexing
#pragma unroll
    for (int j = 0; j < kTile; ++j) s = (j == lane) ? acc[j] : s;
    const int64_t o = static_cast<int64_t>(r) * d + c0 + lane;
    float y = beta[c0 + lane] * s;
    if (z != nullptr) y = alpha[c0 + lane] * z[o] + y;
    out[o] = y;
  }
}

}  // namespace

extern "C" int acm_k5_coo_spmm(const void* row, const void* col,
                               const void* val, int64_t nnz, int slice_nnz,
                               int slice_offset, const void* span_rows,
                               const void* span_first,
                               const void* span_last, int n_span,
                               const void* empty_rows, int n_empty,
                               const void* x, const void* z,
                               const void* alpha, const void* beta,
                               void* carry, void* out, int n_rows, int d,
                               void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float*>(x);
  const auto* zz = static_cast<const float*>(z);
  const auto* al = static_cast<const float*>(alpha);
  const auto* be = static_cast<const float*>(beta);
  auto* cy = static_cast<float*>(carry);
  auto* o = static_cast<float*>(out);
  const unsigned tiles = (d + kTile - 1) / kTile;
  const int64_t n_slices =
      nnz > 0 ? (nnz + slice_offset + slice_nnz - 1) / slice_nnz : 0;
  if (n_slices > 0) {
    const dim3 grid(static_cast<unsigned>((n_slices + kThreads - 1) / kThreads),
                    tiles);
    const auto* rw = static_cast<const int32_t*>(row);
    const auto* cl = static_cast<const int32_t*>(col);
    const auto* vl = static_cast<const float*>(val);
    if (d % 4 == 0) {
      coo_slices_kernel<true><<<grid, kThreads, 0, s>>>(
          rw, cl, vl, nnz, slice_nnz, slice_offset, n_slices, xx, zz, al, be,
          cy, o, d);
    } else {
      coo_slices_kernel<false><<<grid, kThreads, 0, s>>>(
          rw, cl, vl, nnz, slice_nnz, slice_offset, n_slices, xx, zz, al, be,
          cy, o, d);
    }
  }
  const int rows2 = n_span + n_empty;
  if (rows2 > 0) {
    const dim3 grid((rows2 + kWarps - 1) / kWarps, tiles);
    coo_spans_kernel<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const int32_t*>(span_rows),
        static_cast<const int32_t*>(span_first),
        static_cast<const int32_t*>(span_last), n_span,
        static_cast<const int32_t*>(empty_rows), n_empty, cy, zz, al, be, o,
        d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
