// K6 — halo pack: pre-scale, cast and send-slab gather of a rank's operand
// slab before the sharded SpMM's exchange (sm_90a).
//
//   own[i, j]  = cast_g(x[i, j] * sign[j] * s[i])                      i < rows
//   send[k, j] = cast_g(x[r, j] * sign[j] * s[r]),  r = send_idx[k]    k < n_send
//
// Replaces the per-device prologue of the sharded SpMM in
// acmgnn_tpu/parallel/sharded.py: `_pre_scale_block` (:493-504, the f32
// multiply by the column-uniform transpose's pre-scale and the one
// rounding into the gather dtype) and the send-slab gather of the halo
// bodies (`jnp.take(xs, send_idx)`, :539-541 and :640-641).  `sign` is the
// per-column ±1 of the high-pass transpose (exact in any format), `s` the
// optional pre-scale slab; either may be null (1).  x is f32; own and send
// are bf16 or f32.  The send rows are read from x directly, so own is not
// read back.
//
// What bounds it on an H100: bytes.  It reads x (and s) once for own, one
// x row per send row, and writes own and send once; there is one multiply
// per element and no reduction.  Each thread handles 4 consecutive
// elements of the flattened output, so consecutive threads read and write
// consecutive addresses, and stores 16 bytes (f32) or 8 bytes (bf16) at
// once.  The send part gathers its source rows, which stay in L2 at the
// slab sizes of the sharded path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;         // output elements per thread
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[kVec]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Elements [0, n_own) of the flattened work are own's, the next n_send
// are send's; both are row-major with row length d.
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_pack_kernel(const float* __restrict__ x, const float* __restrict__ sign,
                 const float* __restrict__ s, int d, int64_t n_own,
                 T* __restrict__ own, const int32_t* __restrict__ send_idx,
                 int64_t n_send, T* __restrict__ send) {
  const int64_t own_groups = (n_own + kVec - 1) / kVec;
  const int64_t groups = own_groups + (n_send + kVec - 1) / kVec;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * kThreads) {
    const bool is_own = g < own_groups;
    const int64_t e0 = (is_own ? g : g - own_groups) * kVec;
    const int64_t n = is_own ? n_own : n_send;
    T* out = is_own ? own : send;
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = 0.f;
      const int64_t e = e0 + k;
      if (e < n) {
        const int64_t r = e / d;
        const int c = static_cast<int>(e - r * d);
        const int64_t src = is_own ? r : static_cast<int64_t>(send_idx[r]);
        float y = __ldg(x + src * d + c);
        if (sign != nullptr) y *= __ldg(sign + c);
        if (s != nullptr) y *= __ldg(s + src);
        v[k] = y;
      }
    }
    if (e0 + kVec <= n) {
      store_vec(out + e0, v);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (e0 + k < n) store_one(out + e0 + k, v[k]);
      }
    }
  }
}

template <typename T>
void launch(const float* x, const float* sign, const float* s, int rows,
            int d, T* own, const int32_t* send_idx, int n_send_rows, T* send,
            cudaStream_t stream) {
  const int64_t n_own = static_cast<int64_t>(rows) * d;
  const int64_t n_send = static_cast<int64_t>(n_send_rows) * d;
  const int64_t groups = (n_own + kVec - 1) / kVec + (n_send + kVec - 1) / kVec;
  const int64_t want = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  if (blocks > 0) {
    halo_pack_kernel<T><<<blocks, kThreads, 0, stream>>>(
        x, sign, s, d, n_own, own, send_idx, n_send, send);
  }
}

}  // namespace

// own (and send, when n_send_rows > 0) must be 16-byte aligned.
extern "C" int acm_k6_halo_pack(const void* x, const void* sign,
                                const void* pre_scale, int rows, int d,
                                int out_bf16, void* own, const void* send_idx,
                                int n_send_rows, void* send, void* stream) {
  if (d > 0) {
    const auto* xx = static_cast<const float*>(x);
    const auto* sg = static_cast<const float*>(sign);
    const auto* ps = static_cast<const float*>(pre_scale);
    const auto* si = static_cast<const int32_t*>(send_idx);
    auto st = static_cast<cudaStream_t>(stream);
    if (out_bf16) {
      launch(xx, sg, ps, rows, d, static_cast<__nv_bfloat16*>(own), si,
             n_send_rows, static_cast<__nv_bfloat16*>(send), st);
    } else {
      launch(xx, sg, ps, rows, d, static_cast<float*>(own), si, n_send_rows,
             static_cast<float*>(send), st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
