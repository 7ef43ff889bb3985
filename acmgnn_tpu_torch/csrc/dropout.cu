// K8 — counter-based inverted dropout (sm_90a).
//
//   w_i   = word (i mod 4) of Philox4x32-10(counter (i/4 mod 2^32,
//           i/4 >> 32, epoch, site), key (seed, rank))
//   keep  = (w_i >> 8) * 2^-24 < keep_prob            (keep_prob = f32(1 - rate))
//   out_i = keep ? round(f32(h_i) / keep_prob) : 0
//
// Replaces no TPU kernel: the JAX package's dropout is flax's nn.Dropout
// drawing from jax.random.fold_in(run_key, epoch) (acmgnn_tpu/train/
// trainer.py:235, :340, :642), which XLA lowers itself.  It exists so that
// a loop body replayed on the device draws a new mask every epoch: the
// seed and the epoch are read from device memory (`seed`, written once a
// split; `epoch`, the split loop's body counter) when the kernel runs, and
// the mask is a pure function of (seed, rank, epoch, site, i), so nothing
// is carried from one draw to the next and nothing is written from the
// host between epochs.
// ops/dropout.py `dropout_plain` runs the same integer rounds in torch
// int64 arithmetic; the two are equal bit for bit (the threshold compare
// is exact in f32 and the division is IEEE's, -prec-div=true).  Philox is
// written out here (Salmon et al., SC 2011), not taken from curand.
//
// The backward is this kernel on the incoming gradient with the same key:
// the mask is recomputed, nothing is saved (on an H100 that measured
// faster than writing and reading a 1-byte mask: PERF.md).
//
// What bounds it on an H100: bytes.  It reads h once and writes out once:
// 10 Philox rounds of two 32-bit multiplies make four elements' words,
// ~10 integer operations an element against 8 bytes moved, under the
// card's integer rate.  The design: a thread per Philox call (four
// consecutive elements), 16-byte loads and stores for f32 and 8-byte for
// bf16 where both pointers are 16-byte aligned (`vec`), a grid-stride
// loop over the calls.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool keep_of(uint32_t w, float keep_prob) {
  return static_cast<float>(w >> 8) * 5.9604644775390625e-8f < keep_prob;
}

template <typename T>
__device__ __forceinline__ T drop_one(T h, bool keep, float keep_prob) {
  return keep ? from_f32<T>(__fdiv_rn(to_f32(h), keep_prob))
              : from_f32<T>(0.0f);
}

// four consecutive elements as one aligned vector (16 bytes of f32, 8 of bf16)
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ h, T* __restrict__ out, int64_t n,
                   int vec, const int64_t* __restrict__ seed_ptr,
                   uint32_t rank, const int64_t* __restrict__ epoch_ptr,
                   uint32_t site, float keep_prob) {
  const uint32_t seed = static_cast<uint32_t>(*seed_ptr);
  const uint32_t epoch = static_cast<uint32_t>(*epoch_ptr);
  const int64_t calls = (n + 3) / 4;
  for (int64_t b = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       b < calls; b += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t i0 = 4 * b;
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(b),
                   static_cast<uint32_t>(static_cast<uint64_t>(b) >> 32),
                   epoch, site),
        seed, rank);
    const bool keep[4] = {keep_of(w.x, keep_prob), keep_of(w.y, keep_prob),
                          keep_of(w.z, keep_prob), keep_of(w.w, keep_prob)};
    if (vec && i0 + 4 <= n) {
      using V = typename Vec4<T>::type;
      V v = *reinterpret_cast<const V*>(h + i0);
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = drop_one(e[j], keep[j], keep_prob);
      *reinterpret_cast<V*>(out + i0) = v;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < n) out[i0 + j] = drop_one(h[i0 + j], keep[j], keep_prob);
    }
  }
}

int grid_for(int64_t calls) {
  static int sms = 0;   // one card a process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t blocks = (calls + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;   // 2048 threads an SM
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// dtype 0: f32, 1: bf16.  vec: h and out 16-byte aligned.
extern "C" int acm_k8_dropout(const void* h, void* out, int64_t n,
                              int dtype, int vec, const void* seed,
                              uint32_t rank, const void* epoch,
                              uint32_t site, float keep_prob, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int grid = grid_for((n + 3) / 4);
  auto s = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const int64_t*>(seed);
  auto ep = static_cast<const int64_t*>(epoch);
  if (dtype == 0) {
    dropout_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<float*>(out), n, vec, sp,
        rank, ep, site, keep_prob);
  } else if (dtype == 1) {
    dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<__nv_bfloat16*>(out), n, vec, sp, rank, ep, site,
        keep_prob);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
