// K6 — halo pack: pre-scale, cast and send-slab gather of a rank's operand
// slab before the sharded SpMM's exchange (sm_90a).
//
//   own[i, j]  = cast_g(x[i, j] * sign[j] * s[i])                      i < rows
//   send[k, j] = cast_g(x[r, j] * sign[j] * s[r]),  r = send_idx[k]    k < n_send
//   own[i, j] = send[k, j] = 0                                   d <= j < ld
//
// Replaces the per-device prologue of the sharded SpMM in
// acmgnn_tpu/parallel/sharded.py: `_pre_scale_block` (:493-504, the f32
// multiply by the column-uniform transpose's pre-scale and the one
// rounding into the gather dtype) and the send-slab gather of the halo
// bodies (`jnp.take(xs, send_idx)`, :539-541 and :640-641).  `sign` is the
// per-column ±1 of the high-pass transpose (exact in any format), `s` the
// optional pre-scale slab; either may be null (1).  x is f32 [rows, d];
// own and send are bf16 or f32 with row stride ld >= d: K1's row-padded
// operand layout (ops/ell.py `k1_operand_ld`), so the receive buffer the
// exchange fills is K1's operand as it is.  The padding is written as 0.
//
// What bounds it on an H100: bytes.  It reads x (and s) once for own, one
// x row per send row, and writes every padded own and send row once; one
// multiply per factor and element, no reduction.  The design:
// - one output row per thread, own rows then send rows in one launch
//   (thread k < rows writes own row k; the others send row k - rows, from
//   source row send_idx[k - rows], which stays in L2 at the sharded
//   path's slab sizes), so no thread divides an element index;
// - a thread loads its row's d values (16-byte loads where d is a
//   multiple of 4), forms the products in f32, rounds each once, and
//   writes the whole padded row in 16-byte stores (8, 4 or 2 where the
//   row's bytes are not a multiple of 16): a warp's loads cover 32
//   consecutive rows of x, its stores 32 consecutive output rows;
// - d and ld are template parameters for the widths the paths use (4, 7,
//   8, 12 at ld = d or K1's stride); the generic instance is the same
//   kernel with both read at run time.
// Staging a block's tile of x in shared memory first (cp.async) measured
// no faster on the H100 at the sharded headline's shapes, so rows are
// read straight from device memory.
// Rows of kWideMin columns or more (the zoo's hidden widths, layer 1's
// w128 gather, the wide-feature hoist at w600) take a warp per row: its
// lanes write the row's store pieces in turn, so a warp's loads and
// stores cover consecutive bytes of one row.  A thread per row there read
// 2,400-byte strided rows: 14.1 ms for the wiki hoist's [1.9M, 600] pack
// against a 2.1 ms bytes bound (H100, PERF.md).  Same products, same
// order, same rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWideMin = 32;   // columns from which a warp packs a row

// bytes of one store: the largest power of two up to 16 dividing a row's
// bytes (the output's base is 16-byte aligned)
__device__ constexpr int store_bytes(int row_bytes) {
  return (row_bytes & 15) == 0 ? 16
         : (row_bytes & 7) == 0 ? 8
         : (row_bytes & 3) == 0 ? 4
                                : 2;
}

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

template <typename T>
union Piece {
  uint4 u;
  T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void store_piece(T* p, const Piece<T>& v,
                                            int nbytes) {
  switch (nbytes) {
    case 16: *reinterpret_cast<uint4*>(p) = v.u; break;
    case 8: *reinterpret_cast<uint2*>(p) = make_uint2(v.u.x, v.u.y); break;
    case 4: *reinterpret_cast<uint32_t*>(p) = v.u.x; break;
    default:
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v.u.x);
  }
}

// One padded output row: out[j] = cast(src[j] * sg[j] * sc) for j < d, 0
// up to ld.  The product's order is the plain version's: (x·sign)·s.
// With d a template parameter the row's values are loaded first (in
// 16-byte pieces where ``src_vec`` says x is 16-byte aligned and d is a
// multiple of 4) and every loop unrolls.
template <typename T, int D, int LD>
__device__ __forceinline__ void write_row(T* out, const float* src,
                                          bool src_vec, const float* sg,
                                          bool has_sign, float sc,
                                          bool has_scale, int d_rt,
                                          int ld_rt) {
  constexpr int kMax = 16 / sizeof(T);
  const int d = D ? D : d_rt;
  const int ld = D ? LD : ld_rt;
  const int per = store_bytes(ld * static_cast<int>(sizeof(T))) /
                  static_cast<int>(sizeof(T));
  float xv[D ? D : 1];
  if constexpr (D > 0) {
    if constexpr (D % 4 == 0) {
      if (src_vec) {
#pragma unroll
        for (int j = 0; j < D; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(src + j);
          xv[j] = q.x;
          xv[j + 1] = q.y;
          xv[j + 2] = q.z;
          xv[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) xv[j] = src[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) xv[j] = src[j];
    }
    if (has_sign) {
#pragma unroll
      for (int j = 0; j < D; ++j) xv[j] *= sg[j];
    }
    if (has_scale) {
#pragma unroll
      for (int j = 0; j < D; ++j) xv[j] *= sc;
    }
  }
#pragma unroll
  for (int c0 = 0; c0 < ld; c0 += per) {
    Piece<T> v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
      const int j = c0 + k;
      if (k < per && j < d) {
        float y;
        if constexpr (D > 0) {
          y = xv[j];
        } else {
          y = src[j];
          if (has_sign) y *= sg[j];
          if (has_scale) y *= sc;
        }
        v.e[k] = to_out(y, T());
      }
    }
    store_piece(out + c0, v, per * static_cast<int>(sizeof(T)));
  }
}

template <typename T, int D, int LD>
__global__ void __launch_bounds__(kThreads)
halo_pack_kernel(const float* __restrict__ x, const float* __restrict__ sign,
                 const float* __restrict__ s, int rows, int d_rt, int ld_rt,
                 T* __restrict__ own, const int32_t* __restrict__ send_idx,
                 int n_send, T* __restrict__ send) {
  const int d = D ? D : d_rt;
  const int ld = D ? LD : ld_rt;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= static_cast<int64_t>(rows) + n_send) return;
  const bool is_own = k < rows;
  const int64_t r = is_own ? k : static_cast<int64_t>(send_idx[k - rows]);
  T* out = is_own ? own + k * ld : send + (k - rows) * ld;
  write_row<T, D, LD>(out, x + r * d,
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0, sign,
                      sign != nullptr, s != nullptr ? __ldg(s + r) : 1.f,
                      s != nullptr, d_rt, ld_rt);
}

template <typename T, int D, int LD>
cudaError_t launch(const float* x, const float* sign, const float* s,
                   int rows, int d, int ld, T* own, const int32_t* send_idx,
                   int n_send, T* send, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(rows) + n_send;
  if (n == 0) return cudaSuccess;
  const auto blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  halo_pack_kernel<T, D, LD><<<blocks, kThreads, 0, stream>>>(
      x, sign, s, rows, d, ld, own, send_idx, n_send, send);
  return cudaGetLastError();
}

// A warp per output row (rows of at least kWideMin columns): lane l
// writes the row's store pieces l, l + 32, ...; out[j] = cast((x[j]·
// sign[j])·s) for j < d, 0 up to ld, as write_row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_pack_wide_kernel(const float* __restrict__ x,
                      const float* __restrict__ sign,
                      const float* __restrict__ s, int rows, int d, int ld,
                      T* __restrict__ own, const int32_t* __restrict__ send_idx,
                      int n_send, T* __restrict__ send) {
  constexpr int kMax = 16 / sizeof(T);
  const int64_t k =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (k >= static_cast<int64_t>(rows) + n_send) return;  // the whole warp
  const bool is_own = k < rows;
  const int64_t r = is_own ? k : static_cast<int64_t>(send_idx[k - rows]);
  T* out = is_own ? own + k * ld : send + (k - rows) * ld;
  const float* src = x + r * d;
  const float sc = s != nullptr ? __ldg(s + r) : 1.f;
  const int per = store_bytes(ld * static_cast<int>(sizeof(T))) /
                  static_cast<int>(sizeof(T));
  for (int c0 = lane * per; c0 < ld; c0 += 32 * per) {
    Piece<T> v;
    v.u = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < kMax; ++q) {
      const int j = c0 + q;
      if (q < per && j < d) {
        float y = src[j];
        if (sign != nullptr) y *= __ldg(sign + j);
        if (s != nullptr) y *= sc;
        v.e[q] = to_out(y, T());
      }
    }
    store_piece(out + c0, v, per * static_cast<int>(sizeof(T)));
  }
}

template <typename T>
cudaError_t launch_wide(const float* x, const float* sign, const float* s,
                        int rows, int d, int ld, T* own,
                        const int32_t* send_idx, int n_send, T* send,
                        cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(rows) + n_send;
  if (n == 0) return cudaSuccess;
  constexpr int kRowsPerBlock = kThreads / 32;
  const auto blocks =
      static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
  halo_pack_wide_kernel<T><<<blocks, kThreads, 0, stream>>>(
      x, sign, s, rows, d, ld, own, send_idx, n_send, send);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* x, const float* sign, const float* s,
                     int rows, int d, int ld, T* own,
                     const int32_t* send_idx, int n_send, T* send,
                     cudaStream_t st) {
#define ACM_K6_CASE(DD, LL)                                               \
  if (d == DD && ld == LL)                                                \
    return launch<T, DD, LL>(x, sign, s, rows, d, ld, own, send_idx,      \
                             n_send, send, st);
  ACM_K6_CASE(4, 4)
  ACM_K6_CASE(7, 8)
  ACM_K6_CASE(7, 7)
  ACM_K6_CASE(8, 8)
  ACM_K6_CASE(12, 16)
  ACM_K6_CASE(12, 12)
#undef ACM_K6_CASE
  if (d >= kWideMin)
    return launch_wide<T>(x, sign, s, rows, d, ld, own, send_idx, n_send,
                          send, st);
  return launch<T, 0, 0>(x, sign, s, rows, d, ld, own, send_idx, n_send,
                         send, st);
}

}  // namespace

// own (and send, when n_send_rows > 0) must be 16-byte aligned, with row
// stride ld >= d; x is contiguous [rows, d].
extern "C" int acm_k6_halo_pack(const void* x, const void* sign,
                                const void* pre_scale, int rows, int d,
                                int ld, int out_bf16, void* own,
                                const void* send_idx, int n_send_rows,
                                void* send, void* stream) {
  if (d <= 0) return static_cast<int>(cudaGetLastError());
  if (ld < d) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xx = static_cast<const float*>(x);
  const auto* sg = static_cast<const float*>(sign);
  const auto* ps = static_cast<const float*>(pre_scale);
  const auto* si = static_cast<const int32_t*>(send_idx);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_bf16) {
    err = dispatch(xx, sg, ps, rows, d, ld, static_cast<__nv_bfloat16*>(own),
                   si, n_send_rows, static_cast<__nv_bfloat16*>(send), st);
  } else {
    err = dispatch(xx, sg, ps, rows, d, ld, static_cast<float*>(own), si,
                   n_send_rows, static_cast<float*>(send), st);
  }
  return static_cast<int>(err);
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
