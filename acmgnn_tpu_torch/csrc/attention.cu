// K2/K3 — ACM channel attention + mix, forward and backward (sm_90a).
//
// Replaces the projected-LayerNorm channel attention of
// acmgnn_tpu/models/layers.py (ACMConv._attention, proj branch) and the
// channel mix that follows it (ACMConv.__call__'s `3 * sum_i att_i h_i`).
// Per row, for the T = 3 channels h_i (already ReLU'd, [N, d] f32):
//
//   mu_i = mean(h_i), var_i = max(mean(h_i^2) - mu_i^2, 0)   (fast variance)
//   score_i = pc_i * rsqrt(var_i + 1e-5) + c_i,  pc_i = sum_j (h_ij - mu_i) v_ij
//             with v_i = scale_i * a_i, c_i = bias_i . a_i
//   (without LayerNorm: score_i = h_i . v_i, v_i = a_i)
//   att = softmax(sigmoid(score) @ W / 3)
//   out = K * (att_0 h_0 + att_1 h_1 + att_2 h_2)
//
// pc_i equals the JAX form h_i . v_i - mu_i * sum(v_i); it is summed
// centred because the uncentred difference cancels on near-constant rows,
// where rsqrt(var + eps) is large and enters the backward cubed (summing
// the two products of a 2-column row in the other order moved gradients
// by 1e-3).  For the same reason the fast variance is rounded one
// operation at a time, without fused multiply-adds.
//
// K2 writes only `out`; nothing [N, T] or [N, d] goes to memory besides.
// K3 recomputes the row scalars from the h_i (nothing was saved) and
// writes dh_i plus 15 scalars per row; the row reductions for the
// parameter gradients are left to the caller (matrix-vector products).
//
// What bounds them on an H100: bytes.  K2 reads 3 [N, d] f32 channels and
// writes one (~172 MB at N = 168,114, d = 64); K3 reads 4 and writes 3.
// The arithmetic is a few operations per byte.  Design: a group of G
// lanes (a power of two, G = min(32, next_pow2(d))) owns a row, each lane
// strides over columns so a group's loads are contiguous, the row sums
// reduce with xor shuffles inside the group, every lane then holds the
// row scalars, and the later passes over the row (L1 hits) finish the
// centred projection and write the outputs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 3;  // channels
constexpr float kEps = 1e-5f;

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct RowScalars {
  float mu[kT], diff[kT], r[kT], pc[kT], g[kT], att[kT];
};

// Row moments, centred projections, scores, gates and softmax weights of
// one row; `q` (optional) also collects gout . h_i.  Every lane of the
// group calls it (the shuffles need the whole warp); `valid` guards the
// loads of rows past the end.
template <int G>
__device__ __forceinline__ void row_scalars(
    RowScalars& s, const float* const (&h)[kT], const float* go,
    float* q, const float* __restrict__ v, const float* __restrict__ c,
    const float* __restrict__ W, int d, int lane, bool valid, int use_ln) {
  float s1[kT] = {0.f, 0.f, 0.f}, s2[kT] = {0.f, 0.f, 0.f},
        p[kT] = {0.f, 0.f, 0.f};
  if (valid) {
    for (int j = lane; j < d; j += G) {
      const float gj = go != nullptr ? go[j] : 0.f;
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const float x = h[i][j];
        s1[i] += x;
        s2[i] += x * x;
        if (q != nullptr) q[i] += x * gj;
        if (!use_ln) p[i] += x * v[i * d + j];
      }
    }
  }
  const float fd = static_cast<float>(d);
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    s1[i] = group_sum<G>(s1[i]);
    s2[i] = group_sum<G>(s2[i]);
    if (q != nullptr) q[i] = group_sum<G>(q[i]);
    s.mu[i] = __fdiv_rn(s1[i], fd);
    s.diff[i] = __fsub_rn(__fdiv_rn(s2[i], fd), __fmul_rn(s.mu[i], s.mu[i]));
  }
  if (use_ln && valid) {
    for (int j = lane; j < d; j += G) {
#pragma unroll
      for (int i = 0; i < kT; ++i) p[i] += (h[i][j] - s.mu[i]) * v[i * d + j];
    }
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    s.pc[i] = group_sum<G>(p[i]);
    s.r[i] = 1.f;
    float score = s.pc[i];
    if (use_ln) {
      s.r[i] = rsqrtf(__fadd_rn(fmaxf(s.diff[i], 0.f), kEps));
      score = __fadd_rn(__fmul_rn(s.pc[i], s.r[i]), c[i]);
    }
    s.g[i] = 1.f / (1.f + expf(-score));
  }
  float l[kT];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kT; ++i) acc += s.g[i] * W[i * kT + j];
    l[j] = acc / static_cast<float>(kT);
    m = fmaxf(m, l[j]);
  }
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    l[j] = expf(l[j] - m);
    tot += l[j];
  }
#pragma unroll
  for (int j = 0; j < kT; ++j) s.att[j] = l[j] / tot;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ h0, const float* __restrict__ h1,
                const float* __restrict__ h2, const float* __restrict__ v,
                const float* __restrict__ c, const float* __restrict__ W,
                float* __restrict__ out, int n, int d, int use_ln,
                float scale) {
  const int lane = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                      threadIdx.x / G;
  const bool valid = row < n;  // no early exit: all lanes shuffle
  const float* const h[kT] = {h0 + row * d, h1 + row * d, h2 + row * d};
  RowScalars s;
  row_scalars<G>(s, h, nullptr, nullptr, v, c, W, d, lane, valid, use_ln);
  if (!valid) return;
  for (int j = lane; j < d; j += G)
    out[row * d + j] =
        scale * (s.att[0] * h[0][j] + s.att[1] * h[1][j] + s.att[2] * h[2][j]);
}

// aux row layout: [dp(3), dS(3), dscore(3), g(3), dl(3)]; dS_i = -dp_i mu_i
// is the row's share of d(sum_j v_ij).
constexpr int kAux = 15;

template <int G>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ h0, const float* __restrict__ h1,
                const float* __restrict__ h2, const float* __restrict__ gout,
                const float* __restrict__ v, const float* __restrict__ S,
                const float* __restrict__ c, const float* __restrict__ W,
                float* __restrict__ dh0, float* __restrict__ dh1,
                float* __restrict__ dh2, float* __restrict__ aux, int n,
                int d, int use_ln, float scale) {
  const int lane = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                      threadIdx.x / G;
  const bool valid = row < n;
  const float* const h[kT] = {h0 + row * d, h1 + row * d, h2 + row * d};
  float* dh[kT] = {dh0 + row * d, dh1 + row * d, dh2 + row * d};
  const float* go = gout + row * d;
  float q[kT] = {0.f, 0.f, 0.f};
  RowScalars s;
  row_scalars<G>(s, h, go, q, v, c, W, d, lane, valid, use_ln);
  if (!valid) return;

  // out = K sum_i att_i h_i  ->  d att_i = K (g . h_i); softmax backward
  float datt[kT], dl[kT];
  float sum_ad = 0.f;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    datt[i] = scale * q[i];
    sum_ad += s.att[i] * datt[i];
  }
#pragma unroll
  for (int j = 0; j < kT; ++j) dl[j] = s.att[j] * (datt[j] - sum_ad);

  const float fd = static_cast<float>(d);
  float dp[kT], dS[kT], dscore[kT], dmu[kT], dm2[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    float dg = 0.f;
#pragma unroll
    for (int j = 0; j < kT; ++j) dg += W[i * kT + j] * dl[j];
    dg /= static_cast<float>(kT);
    dscore[i] = dg * s.g[i] * (1.f - s.g[i]);
    if (use_ln) {
      dp[i] = dscore[i] * s.r[i];
      dS[i] = -dp[i] * s.mu[i];
      const float r3 = __fmul_rn(__fmul_rn(s.r[i], s.r[i]), s.r[i]);
      const float dvar = __fmul_rn(-0.5f * (dscore[i] * s.pc[i]), r3);
      // max(diff, 0): full gradient above 0, half at the tie, none below
      const float f = s.diff[i] > 0.f ? 1.f : (s.diff[i] == 0.f ? 0.5f : 0.f);
      dm2[i] = dvar * f;
      dmu[i] = -dp[i] * S[i] - 2.f * s.mu[i] * dm2[i];
    } else {
      dp[i] = dscore[i];
      dS[i] = 0.f;
      dm2[i] = 0.f;
      dmu[i] = 0.f;
    }
  }
  for (int j = lane; j < d; j += G) {
    const float gj = go[j];
#pragma unroll
    for (int i = 0; i < kT; ++i)
      dh[i][j] = scale * s.att[i] * gj + dp[i] * v[i * d + j] + dmu[i] / fd +
                 dm2[i] * 2.f * h[i][j] / fd;
  }
  if (lane == 0) {
    float* a = aux + row * kAux;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      a[i] = dp[i];
      a[3 + i] = dS[i];
      a[6 + i] = dscore[i];
      a[9 + i] = s.g[i];
      a[12 + i] = dl[i];
    }
  }
}

int group_size(int d) {
  int g = 1;
  while (g < d && g < 32) g <<= 1;
  return g;
}

template <template <int> class Launch, typename... Args>
void dispatch(int g, Args... args) {
  switch (g) {
    case 1: Launch<1>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    case 4: Launch<4>::run(args...); break;
    case 8: Launch<8>::run(args...); break;
    case 16: Launch<16>::run(args...); break;
    default: Launch<32>::run(args...); break;
  }
}

template <int G>
struct FwdLaunch {
  static void run(const float* h0, const float* h1, const float* h2,
                  const float* v, const float* c, const float* W, float* out,
                  int n, int d, int use_ln, float scale,
                  cudaStream_t stream) {
    const int rows = kThreads / G;
    attn_fwd_kernel<G><<<(n + rows - 1) / rows, kThreads, 0, stream>>>(
        h0, h1, h2, v, c, W, out, n, d, use_ln, scale);
  }
};

template <int G>
struct BwdLaunch {
  static void run(const float* h0, const float* h1, const float* h2,
                  const float* gout, const float* v, const float* S,
                  const float* c, const float* W, float* dh0, float* dh1,
                  float* dh2, float* aux, int n, int d, int use_ln,
                  float scale, cudaStream_t stream) {
    const int rows = kThreads / G;
    attn_bwd_kernel<G><<<(n + rows - 1) / rows, kThreads, 0, stream>>>(
        h0, h1, h2, gout, v, S, c, W, dh0, dh1, dh2, aux, n, d, use_ln,
        scale);
  }
};

}  // namespace

extern "C" int acm_k2_attn_fwd(const void* h0, const void* h1, const void* h2,
                               const void* v, const void* c, const void* W,
                               void* out, int n, int d, int use_ln,
                               float scale, void* stream) {
  if (n > 0 && d > 0) {
    dispatch<FwdLaunch>(
        group_size(d), static_cast<const float*>(h0),
        static_cast<const float*>(h1), static_cast<const float*>(h2),
        static_cast<const float*>(v), static_cast<const float*>(c),
        static_cast<const float*>(W), static_cast<float*>(out), n, d, use_ln,
        scale, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int acm_k3_attn_bwd(const void* h0, const void* h1, const void* h2,
                               const void* gout, const void* v, const void* S,
                               const void* c, const void* W, void* dh0,
                               void* dh1, void* dh2, void* aux, int n, int d,
                               int use_ln, float scale, void* stream) {
  if (n > 0 && d > 0) {
    dispatch<BwdLaunch>(
        group_size(d), static_cast<const float*>(h0),
        static_cast<const float*>(h1), static_cast<const float*>(h2),
        static_cast<const float*>(gout), static_cast<const float*>(v),
        static_cast<const float*>(S), static_cast<const float*>(c),
        static_cast<const float*>(W), static_cast<float*>(dh0),
        static_cast<float*>(dh1), static_cast<float*>(dh2),
        static_cast<float*>(aux), n, d, use_ln, scale,
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
