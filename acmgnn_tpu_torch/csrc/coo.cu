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
// width 12) mostly hit the 50 MB L2.  Below that the limit is latency
// and access width: the triplet loads must be coalesced and read once,
// the rows stored whole, and few rows left to the carry launch (with
// slices of 16 nonzeros, 96k rows of genius cross a slice boundary; with
// 256, 7k).  The design:
//   - launch 1 (coo_slices_kernel): a warp takes one slice of slice_nnz
//     triplets (256 on the training paths, ops/coo.py SLICE_NNZ).  Lane l
//     takes the slice's positions l, l+32, ...: every load of row/col/val
//     is coalesced.  Each lane gathers its operand rows for up to 16
//     columns at once (float4 loads where d % 4 == 0) and stages the
//     products in shared memory.  A ballot finds the row segments.  A
//     slice of 32 or more segments (genius: ~45) gives each lane whole
//     segments, summed in position order and stored whole with the
//     epilogue (float4 pieces); a slice of fewer, longer segments (the
//     headline graph's rows of 64-128) gives each lane one (segment,
//     column), so no lane sums a long row alone.  A column's terms are
//     added in the same order either way.  The
//     slice's first segment, if its row continues from the previous
//     slice, leaves its sum in carry[2s]; its last segment, if its row
//     continues into the next slice, in carry[2s + 1].  Wider operands
//     walk 16-column tiles, re-reading the triplets from L2.
//   - launch 2 (coo_spans_kernel): a thread per row that crosses a slice
//     boundary (first slice f, last slice l, found on the host) sums
//     carry[2f + 1], carry[2(f+1)], ..., carry[2l] in that order and
//     stores the row; further threads store the rows that have no triplet
//     (alpha * z).
// No atomics, so two runs agree bit for bit.  Every row of `out` is
// written exactly once.
//
// `slice_offset` shifts the slice grid: slice s holds triplets
// [s * slice_nnz - slice_offset, (s + 1) * slice_nnz - slice_offset), the
// first one cut short.  A rank's block of a sharded matrix passes its
// first triplet's position in the whole matrix modulo slice_nnz: each of
// its triplets then sits at the same position of the same slice as in
// the whole matrix's half, so each of its rows is split, and summed, in
// the same order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 16;        // columns per pass over a slice
constexpr int kUnroll = 4;       // positions a lane has in flight
constexpr int kRounds = 8;       // rounds of row ids loaded at once
constexpr int kMaxWarps = 4;     // slices per block in launch 1
constexpr int kSpanThreads = 128;
constexpr int kSmemLimit = 227 * 1024;

// One 16-column tile of operand row c, multiplied by w, into p[0..dt).
template <bool kVec>
__device__ __forceinline__ void product(const float* __restrict__ x,
                                        int64_t c, int d, int c0, int dt,
                                        float w, float* __restrict__ p) {
  const float* src = x + c * d + c0;
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < kTile / 4; ++k) {
      if (4 * k < dt) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src) + k);
        reinterpret_cast<float4*>(p)[k] = make_float4(
            __fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
            __fmul_rn(w, v.w));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < dt) p[j] = __fmul_rn(w, __ldg(src + j));
    }
  }
}

__device__ __forceinline__ float epilogue(float s, int col, int64_t o,
                                          const float* __restrict__ z,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ beta) {
  float y = __fmul_rn(__ldg(beta + col), s);
  if (z != nullptr) y = __fadd_rn(__fmul_rn(__ldg(alpha + col), z[o]), y);
  return y;
}

// Stores a tile of a row's sums: to the carry row `slot`, or with the
// epilogue to out[r].
template <bool kVec>
__device__ __forceinline__ void store_tile(const float (&acc)[kTile],
                                           int64_t slot, int r, int c0,
                                           int dt, int d,
                                           const float* __restrict__ z,
                                           const float* __restrict__ alpha,
                                           const float* __restrict__ beta,
                                           float* __restrict__ carry,
                                           float* __restrict__ out) {
  float y[kTile];
  float* dst;
  if (slot >= 0) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) y[j] = acc[j];
    dst = carry + slot * d + c0;
  } else {
    const int64_t o = static_cast<int64_t>(r) * d + c0;
#pragma unroll
    for (int j = 0; j < kTile; ++j)
      y[j] = j < dt ? epilogue(acc[j], c0 + j, o + j, z, alpha, beta) : 0.f;
    dst = out + o;
  }
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < kTile / 4; ++k) {
      if (4 * k < dt)
        reinterpret_cast<float4*>(dst)[k] =
            make_float4(y[4 * k], y[4 * k + 1], y[4 * k + 2], y[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j < dt) dst[j] = y[j];
    }
  }
}

// kVec: d % 4 == 0 and every array 16-byte aligned: float4 rows.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
coo_slices_kernel(const int32_t* __restrict__ row,
                  const int32_t* __restrict__ col,
                  const float* __restrict__ val, int64_t nnz, int slice_nnz,
                  int slice_offset, int64_t n_slices,
                  const float* __restrict__ x, const float* __restrict__ z,
                  const float* __restrict__ alpha,
                  const float* __restrict__ beta, float* __restrict__ carry,
                  float* __restrict__ out, int d, int pitch,
                  int warp_floats) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (s >= n_slices) return;  // the whole warp leaves together
  // this warp's products [slice_nnz][pitch], then its segment starts
  float* prod = reinterpret_cast<float*>(smem) + warp * warp_floats;
  int* seg = reinterpret_cast<int*>(prod + slice_nnz * pitch);

  const int64_t q0 = s * slice_nnz - slice_offset;  // position 0's triplet
  const int64_t a = q0 > 0 ? q0 : 0;
  const int64_t b = q0 + slice_nnz < nnz ? q0 + slice_nnz : nnz;
  const bool head_open = a > 0 && row[a - 1] == row[a];
  const bool tail_open = b < nnz && row[b] == row[b - 1];

  // segment starts, in position order: kRounds rounds' rows loaded at
  // once (-1 outside the slice's triplets), each position's predecessor
  // from the lane before it, or the previous round's lane 31
  int nseg = 0;
  int last = -1;
  for (int base = 0; base < slice_nnz; base += 32 * kRounds) {
    int r[kRounds];
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int64_t e = q0 + base + 32 * k + lane;
      r[k] = base + 32 * k + lane < slice_nnz && e >= a && e < b
          ? __ldg(row + e) : -1;
    }
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const int q = base + 32 * k + lane;
      int before = __shfl_up_sync(0xffffffffu, r[k], 1);
      if (lane == 0) before = last;
      last = __shfl_sync(0xffffffffu, r[k], 31);
      // a position after an invalid one is the slice's first, a start
      const bool start = r[k] >= 0 && r[k] != before;
      const unsigned m = __ballot_sync(0xffffffffu, start);
      if (start) seg[nseg + __popc(m & ((1u << lane) - 1u))] = q;
      nseg += __popc(m);
    }
  }
  if (lane == 0) seg[nseg] = static_cast<int>(b - q0);
  __syncwarp();

  for (int c0 = 0; c0 < d; c0 += kTile) {
    const int dt = min(kTile, d - c0);
    // products of this tile, each lane its positions
    for (int q = lane; q < slice_nnz; q += kUnroll * 32) {
      int cs[kUnroll];
      float ws[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t e = q0 + q + 32 * u;
        const bool in = q + 32 * u < slice_nnz && e >= a && e < b;
        cs[u] = in ? __ldg(col + e) : -1;
        ws[u] = in ? __ldg(val + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (cs[u] >= 0)
          product<kVec>(x, cs[u], d, c0, dt, ws[u],
                        prod + (q + 32 * u) * pitch);
      }
    }
    __syncwarp();
    // Each segment's sum, in position order.  With a lane's worth of
    // segments, the lane that owns a segment sums all its columns;
    // fewer, longer segments spread over lanes, one per (segment,
    // column).  Each column adds the same terms in the same order
    // either way.
    if (nseg >= 32) {
      for (int sg = lane; sg < nseg; sg += 32) {
        const int t0 = seg[sg], t1 = seg[sg + 1];
        float acc[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
        for (int t = t0; t < t1; ++t) {
          const float* p = prod + t * pitch;
          if constexpr (kVec) {
#pragma unroll
            for (int k = 0; k < kTile / 4; ++k) {
              if (4 * k < dt) {
                const float4 v = reinterpret_cast<const float4*>(p)[k];
                acc[4 * k] += v.x;
                acc[4 * k + 1] += v.y;
                acc[4 * k + 2] += v.z;
                acc[4 * k + 3] += v.w;
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
              if (j < dt) acc[j] += p[j];
            }
          }
        }
        int64_t slot = -1;
        if (sg == 0 && head_open) {
          slot = 2 * s;
        } else if (sg == nseg - 1 && tail_open) {
          slot = 2 * s + 1;
        }
        store_tile<kVec>(acc, slot, __ldg(row + q0 + t0), c0, dt, d, z, alpha,
                         beta, carry, out);
      }
    } else {
      for (int it = lane; it < nseg * dt; it += 32) {
        const int sg = it / dt;
        const int j = it - sg * dt;
        const int t0 = seg[sg], t1 = seg[sg + 1];
        float acc = 0.f;
#pragma unroll 4
        for (int t = t0; t < t1; ++t) acc += prod[t * pitch + j];
        if (sg == 0 && head_open) {
          carry[2 * s * d + c0 + j] = acc;
        } else if (sg == nseg - 1 && tail_open) {
          carry[(2 * s + 1) * d + c0 + j] = acc;
        } else {
          const int64_t o =
              static_cast<int64_t>(__ldg(row + q0 + t0)) * d + c0 + j;
          out[o] = epilogue(acc, c0 + j, o, z, alpha, beta);
        }
      }
    }
    __syncwarp();
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSpanThreads)
coo_spans_kernel(const int32_t* __restrict__ span_rows,
                 const int32_t* __restrict__ span_first,
                 const int32_t* __restrict__ span_last, int n_span,
                 const int32_t* __restrict__ empty_rows, int n_empty,
                 const float* __restrict__ carry, const float* __restrict__ z,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta, float* __restrict__ out,
                 int d) {
  const int i = blockIdx.x * kSpanThreads + threadIdx.x;
  if (i >= n_span + n_empty) return;
  const bool span = i < n_span;
  const int r = span ? span_rows[i] : empty_rows[i - n_span];
  for (int c0 = 0; c0 < d; c0 += kTile) {
    const int dt = min(kTile, d - c0);
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
    if (span) {
      const int64_t f = span_first[i], l = span_last[i];
      // the first slice left its tail, every later one its head
      for (int64_t k = f; k <= l; ++k) {
        const float* p = carry + (k == f ? 2 * f + 1 : 2 * k) * d + c0;
        if constexpr (kVec) {
#pragma unroll
          for (int m = 0; m < kTile / 4; ++m) {
            if (4 * m < dt) {
              const float4 v = reinterpret_cast<const float4*>(p)[m];
              acc[4 * m] += v.x;
              acc[4 * m + 1] += v.y;
              acc[4 * m + 2] += v.z;
              acc[4 * m + 3] += v.w;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            if (j < dt) acc[j] += p[j];
          }
        }
      }
    }
    store_tile<kVec>(acc, -1, r, c0, dt, d, z, alpha, beta, nullptr, out);
  }
}

template <bool kVec>
int launch(const int32_t* rw, const int32_t* cl, const float* vl,
           int64_t nnz, int slice_nnz, int slice_offset, int64_t n_slices,
           const int32_t* span_rows, const int32_t* span_first,
           const int32_t* span_last, int n_span, const int32_t* empty_rows,
           int n_empty, const float* x, const float* z, const float* alpha,
           const float* beta, float* carry, float* out, int d,
           cudaStream_t s) {
  if (n_slices > 0) {
    const int pitch = (min(d, kTile) + 3) / 4 * 4;
    // products, then the segment starts rounded up to keep float4 alignment
    const int64_t warp_floats = static_cast<int64_t>(slice_nnz) * pitch
        + (static_cast<int64_t>(slice_nnz) + 4) / 4 * 4;
    const int64_t warp_bytes = 4 * warp_floats;
    if (warp_bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const int warps = static_cast<int>(
        std::min<int64_t>(kMaxWarps, kSmemLimit / warp_bytes));
    const int smem = static_cast<int>(warps * warp_bytes);
    static int smem_set = 48 * 1024;  // per instantiation
    if (smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          coo_slices_kernel<kVec>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = kSmemLimit;
    }
    const int64_t blocks = (n_slices + warps - 1) / warps;
    coo_slices_kernel<kVec><<<static_cast<unsigned>(blocks), warps * 32,
                              smem, s>>>(
        rw, cl, vl, nnz, slice_nnz, slice_offset, n_slices, x, z, alpha,
        beta, carry, out, d, pitch, static_cast<int>(warp_floats));
  }
  const int rows2 = n_span + n_empty;
  if (rows2 > 0) {
    coo_spans_kernel<kVec><<<(rows2 + kSpanThreads - 1) / kSpanThreads,
                             kSpanThreads, 0, s>>>(
        span_rows, span_first, span_last, n_span, empty_rows, n_empty, carry,
        z, alpha, beta, out, d);
  }
  return static_cast<int>(cudaGetLastError());
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
  const int64_t n_slices =
      nnz > 0 ? (nnz + slice_offset + slice_nnz - 1) / slice_nnz : 0;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = d % 4 == 0 && aligned(x) && aligned(z) && aligned(carry)
      && aligned(out);
  const auto* rw = static_cast<const int32_t*>(row);
  const auto* cl = static_cast<const int32_t*>(col);
  const auto* vl = static_cast<const float*>(val);
  const auto* sr = static_cast<const int32_t*>(span_rows);
  const auto* sf = static_cast<const int32_t*>(span_first);
  const auto* sl = static_cast<const int32_t*>(span_last);
  const auto* er = static_cast<const int32_t*>(empty_rows);
  const auto* xx = static_cast<const float*>(x);
  const auto* zz = static_cast<const float*>(z);
  const auto* al = static_cast<const float*>(alpha);
  const auto* be = static_cast<const float*>(beta);
  auto* cy = static_cast<float*>(carry);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(rw, cl, vl, nnz, slice_nnz, slice_offset,
                            n_slices, sr, sf, sl, n_span, er, n_empty, xx,
                            zz, al, be, cy, o, d, s)
             : launch<false>(rw, cl, vl, nnz, slice_nnz, slice_offset,
                             n_slices, sr, sf, sl, n_span, er, n_empty, xx,
                             zz, al, be, cy, o, d, s);
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
