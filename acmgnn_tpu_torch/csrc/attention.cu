// K2/K3 — ACM channel ReLU, attention and mix, forward and backward
// (sm_90a).
//
// Replaces, in acmgnn_tpu/models/layers.py, the channel ReLU and the mix
// of ACMConv.__call__ (:450-480: relu of the channels, then `3 * sum_i
// att_i h_i` over three channels or `1 * sum_i` over four with the
// structure channel), the projected-LayerNorm channel attention
// ACMConv._attention (:191-232, the `proj` branch and the branch without
// LayerNorm), the acmsgc mix without a ReLU (:333-349), and the row
// reductions that JAX's autodiff made of them for the parameter
// gradients.  Per row, for the T = 3 or 4 channels z_i ([N, d] f32):
//
//   h_i = relu(z_i) where bit i of the ReLU mask M is set, else z_i
//   mu_i = mean(h_i), var_i = max(mean(h_i^2) - mu_i^2, 0)   (fast variance)
//   score_i = pc_i * rsqrt(var_i + 1e-5) + c_i,  pc_i = sum_j (h_ij - mu_i) v_ij
//             with v_i = scale_i * a_i, c_i = bias_i . a_i
//   (without LayerNorm: score_i = h_i . v_i, v_i = a_i)
//   att = softmax(sigmoid(score) @ W / T)
//   out = K * sum_i att_i h_i          (K = 3 at T = 3, 1 at T = 4)
//
// T and M are template parameters: the instances are (T, M) = (3, low
// high mlp) for variant 0, (3, mlp) for variant 1 (ACMII: the low and
// high channels were ReLU'd before propagation), (3, none) for acmsgc,
// (4, all) for the structure channel and (4, mlp struc) for variant 1
// with it.  K3 returns dz_i = dh_i [z_i > 0] where the channel has the
// ReLU (its gradient, 0 at 0), dz_i = dh_i where it has not, and the
// parameter gradients summed over the rows: dv_ij = sum_rows dp_i h_ij +
// sum_rows dS_i (dS_i = -dp_i mu_i is the row's share of d sum_j v_ij),
// dc_i = sum_rows dscore_i (with LayerNorm; 0 without), dW_ij = sum_rows
// g_i dl_j / T.
//
// pc_i equals the JAX form h_i . v_i - mu_i * sum(v_i); it is summed
// centred because the uncentred difference cancels on near-constant rows,
// where rsqrt(var + eps) is large and enters the backward cubed (summing
// the two products of a 2-column row in the other order moved gradients
// by 1e-3).  For the same reason the fast variance is rounded one
// operation at a time, without fused multiply-adds.
//
// What bounds them on an H100: bytes.  K2 reads T [N, d] f32 channels and
// writes one (16 N d bytes at T = 3: 172 MB, 0.051 ms at 3.35 TB/s for N
// = 168,114, d = 64); K3 reads T + 1 and writes T (28 N d at T = 3: 301
// MB, 0.090 ms) plus a [grid, T d + 2 T + T^2] partials tensor of a few
// hundred KB.  The first
// form of these kernels gave a row a whole warp at d = 64 (scalar loads,
// five shuffle steps per row sum, the row's scalar tail issued by all 32
// lanes for one row) and read every element three times: about 300 warp
// instructions a row made it issue-bound at 31-44% of the bytes bound,
// and at d = 2 two lanes computed the same tail.  This design:
// - A group of G lanes owns a row and a lane holds E floats of it in
//   registers (d = 64: G = 4, E = 16, four float4 a channel, eight rows
//   a warp, two shuffle steps; d <= 8: one lane a row, no shuffles).
//   Chunk k of lane l covers columns (k G + l) V .. (k G + l) V + V - 1,
//   so each vector load of a group is contiguous.  Vector loads (V = 4,
//   or 2 at d = 2) where d and every row stride allow it, else scalar
//   loads (V = 1) with the same arithmetic.  Channels may be column
//   views of a wider tensor: each has its own row stride.
// - Every element is read once from device memory: the ReLU, the
//   moments, the centred projection, the mix, dz and the dv share all run
//   on the registers.
// - Persistent blocks: the grid is at most the card's SMs times the
//   resident blocks (asked once, before the first launch, so that a
//   launch captures in a CUDA graph) and warps stride over the rows.  v
//   (zero-padded to G E columns), S_i = sum_j v_ij, c and W are loaded
//   into shared memory once a block; v there, not in registers, leaves
//   K3's registers to the row and the dv share.
// - K3 keeps each lane's share of dv in registers across all its rows,
//   and each row group its 2 T + T^2 row sums (dS, dscore, g_i dl_j) in
//   shared
//   memory (at 8 floats a lane and two blocks an SM, 128 registers had
//   spilled).  At
//   the end each warp folds its groups with xor shuffles, the warps add
//   into shared memory in warp order, the row sums add over the groups
//   in order, and the block writes one row of the partials; a second kernel sums the partials over the blocks in a fixed
//   order into dv, dc and dW.  No atomics: on one card (a fixed grid) a
//   run is bit-reproducible.
// - The row sums add products rounded on their own (no fused
//   multiply-add), as the plain version does: at d = 2 with LayerNorm,
//   where one lane sums a whole row, fused products moved the fast
//   variance of near-constant rows enough to put dz at 2.7x its
//   tolerance against the plain version (the first card run).  x / d is a multiply where d is a power
//   of two (exact, so equal to the division); the fast variance and the
//   LayerNorm score are rounded one operation at a time; the gates and the softmax use
//   __expf and __frcp_rn (a correctly rounded reciprocal, equal to 1 / x);
//   rsqrtf as in the first form.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 4;        // channels
constexpr int kFinishThreads = 1024;
constexpr float kEps = 1e-5f;

// per row: dS (T), dscore (T), g_i dl_j (T^2)
__host__ __device__ constexpr int row_sums(int t) { return 2 * t + t * t; }

struct Args {
  const float* z[kMaxT];
  int64_t ld[kMaxT];   // row strides of the channels, in floats
  const float* gout;
  int64_t ldg;
  const float* v;
  const float* c;
  const float* W;
  float* out;          // K2: [n, d]
  float* dz[kMaxT];    // K3: [n, d] each
  float* partials;     // K3: [grid, T d + row_sums(T)]
  int n, d, use_ln;
  float scale;
};

template <int T, int GE>
struct Params {
  float v[T][GE];  // zero beyond d
  float S[T], c[T], W[T * T];
};

// x / d: a multiply where d is a power of two (exact), else the division
struct DivD {
  float fd, inv;
  bool pow2;
  __device__ explicit DivD(int d)
      : fd(static_cast<float>(d)), inv(1.f / static_cast<float>(d)),
        pow2((d & (d - 1)) == 0) {}
  __device__ __forceinline__ float operator()(float x) const {
    return pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, fd);
  }
};

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int V>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = __ldg(src);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// The block's copy of v, S, c and W.
template <int T, int GE>
__device__ void load_params(Params<T, GE>& p, const Args& a) {
  for (int t = threadIdx.x; t < T * GE; t += kThreads) {
    const int i = t / GE, j = t % GE;
    p.v[i][j] = j < a.d ? __ldg(a.v + i * a.d + j) : 0.f;
  }
  if (threadIdx.x < T) p.c[threadIdx.x] = __ldg(a.c + threadIdx.x);
  if (threadIdx.x < T * T) p.W[threadIdx.x] = __ldg(a.W + threadIdx.x);
  __syncthreads();
  if (threadIdx.x < T) {
    float acc = 0.f;
    for (int j = 0; j < a.d; ++j) acc += p.v[threadIdx.x][j];
    p.S[threadIdx.x] = acc;
  }
  __syncthreads();
}

// Loads one row's E floats of each channel (and of gout in K3) for this
// lane, the ReLU applied to the channels of the mask M; zeros past the
// row's end or n.
template <int T, int M, int V, int G, int E, bool kGrad>
__device__ __forceinline__ void load_row(float (&h)[T][E], float (&go)[E],
                                         const Args& a, int64_t row,
                                         bool valid, int lane) {
#pragma unroll
  for (int k = 0; k < E / V; ++k) {
    const int col = (k * G + lane) * V;
    const bool ok = valid && col < a.d;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (ok) {
        load_vec<V>(&h[i][k * V], a.z[i] + row * a.ld[i] + col);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) h[i][k * V + u] = 0.f;
      }
      if ((M >> i) & 1) {
#pragma unroll
        for (int u = 0; u < V; ++u)
          h[i][k * V + u] = fmaxf(h[i][k * V + u], 0.f);
      }
    }
    if constexpr (kGrad) {
      if (ok) {
        load_vec<V>(&go[k * V], a.gout + row * a.ldg + col);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) go[k * V + u] = 0.f;
      }
    }
  }
}

template <int T>
struct Row {
  float mu[T], diff[T], r[T], pc[T], g[T], att[T];
};

// Row moments, centred projections, scores, gates and softmax weights of
// one row; K3 (kGrad) also sums q_i = gout . h_i.  Every lane of the
// warp calls it (the shuffles need the whole warp).
template <int T, int V, int G, int E, bool kGrad>
__device__ __forceinline__ void row_scalars(
    Row<T>& s, float (&q)[T], const float (&h)[T][E], const float (&go)[E],
    const Params<T, G * E>& p, int lane, const DivD& div, int use_ln) {
  float pj[T];
  if (use_ln) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float s1 = 0.f, s2 = 0.f, qi = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = h[i][e];
        s1 += x;
        s2 += __fmul_rn(x, x);
        if constexpr (kGrad) qi += __fmul_rn(x, go[e]);
      }
      s1 = group_sum<G>(s1);
      s2 = group_sum<G>(s2);
      if constexpr (kGrad) q[i] = group_sum<G>(qi);
      s.mu[i] = div(s1);
      s.diff[i] = __fsub_rn(div(s2), __fmul_rn(s.mu[i], s.mu[i]));
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < E / V; ++k) {
#pragma unroll
        for (int u = 0; u < V; ++u)
          acc += __fmul_rn(h[i][k * V + u] - s.mu[i],
                           p.v[i][(k * G + lane) * V + u]);
      }
      pj[i] = acc;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float acc = 0.f, qi = 0.f;
#pragma unroll
      for (int k = 0; k < E / V; ++k) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float x = h[i][k * V + u];
          acc += __fmul_rn(x, p.v[i][(k * G + lane) * V + u]);
          if constexpr (kGrad) qi += __fmul_rn(x, go[k * V + u]);
        }
      }
      pj[i] = acc;
      if constexpr (kGrad) q[i] = group_sum<G>(qi);
      s.mu[i] = 0.f;
      s.diff[i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    s.pc[i] = group_sum<G>(pj[i]);
    s.r[i] = 1.f;
    float score = s.pc[i];
    if (use_ln) {
      s.r[i] = rsqrtf(__fadd_rn(fmaxf(s.diff[i], 0.f), kEps));
      score = __fadd_rn(__fmul_rn(s.pc[i], s.r[i]), p.c[i]);
    }
    s.g[i] = __frcp_rn(1.f + __expf(-score));
  }
  float l[T];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) acc += s.g[i] * p.W[i * T + j];
    l[j] = acc / static_cast<float>(T);
    m = fmaxf(m, l[j]);
  }
  float tot = 0.f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    l[j] = __expf(l[j] - m);
    tot += l[j];
  }
  const float inv = __frcp_rn(tot);
#pragma unroll
  for (int j = 0; j < T; ++j) s.att[j] = l[j] * inv;
}

template <int T, int M, int V, int G, int E>
__global__ void __launch_bounds__(kThreads, (E >= 16 || (T == 4 && E >= 8)) ? 1 : 2)
attn_fwd_kernel(const Args a) {
  constexpr int kRowsPerWarp = 32 / G;
  __shared__ Params<T, G * E> p;
  load_params<T, G * E>(p, a);
  const int lane32 = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lane = lane32 % G, grp = lane32 / G;
  const DivD div(a.d);
  const int64_t step =
      static_cast<int64_t>(gridDim.x) * kWarps * kRowsPerWarp;
  // the loop's bounds are the warp's, so all its lanes shuffle together
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;
       base < a.n; base += step) {
    const int64_t row = base + grp;
    const bool valid = row < a.n;
    float h[T][E], go[E], q[T];
    load_row<T, M, V, G, E, false>(h, go, a, row, valid, lane);
    Row<T> s;
    row_scalars<T, V, G, E, false>(s, q, h, go, p, lane, div, a.use_ln);
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < E / V; ++k) {
      const int col = (k * G + lane) * V;
      if (col >= a.d) continue;
      float o[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int e = k * V + u;
        float acc = s.att[0] * h[0][e];
#pragma unroll
        for (int i = 1; i < T; ++i) acc += s.att[i] * h[i][e];
        o[u] = a.scale * acc;
      }
      store_vec<V>(a.out + row * a.d + col, o);
    }
  }
}

template <int T, int M, int V, int G, int E>
__global__ void __launch_bounds__(kThreads, (E >= 16 || (T == 4 && E >= 8)) ? 1 : 2)
attn_bwd_kernel(const Args a) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int GE = G * E;
  constexpr int RS = row_sums(T);
  __shared__ Params<T, GE> p;
  __shared__ float red[T * GE + RS];
  __shared__ float rsum[kThreads / G][RS];  // each row group's sums
  for (int t = threadIdx.x; t < kThreads / G * RS; t += kThreads)
    (&rsum[0][0])[t] = 0.f;
  load_params<T, GE>(p, a);
  const int lane32 = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lane = lane32 % G, grp = lane32 / G;
  float* const slot = rsum[warp * kRowsPerWarp + grp];
  const DivD div(a.d);
  float dv[T][E];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) dv[i][e] = 0.f;
  }

  const int64_t step =
      static_cast<int64_t>(gridDim.x) * kWarps * kRowsPerWarp;
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kRowsPerWarp;
       base < a.n; base += step) {
    const int64_t row = base + grp;
    const bool valid = row < a.n;
    float h[T][E], go[E], q[T];
    load_row<T, M, V, G, E, true>(h, go, a, row, valid, lane);
    Row<T> s;
    row_scalars<T, V, G, E, true>(s, q, h, go, p, lane, div, a.use_ln);
    if (!valid) continue;

    // out = K sum_i att_i h_i  ->  d att_i = K (g . h_i); softmax backward
    float datt[T], dl[T];
    float sum_ad = 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      datt[i] = a.scale * q[i];
      sum_ad += s.att[i] * datt[i];
    }
#pragma unroll
    for (int j = 0; j < T; ++j) dl[j] = s.att[j] * (datt[j] - sum_ad);

    // dh = K att_i gout + dp_i v_i - dp_i S_i / d + (2 dm2_i / d)(h - mu_i):
    // the variance's share centred, as pc is (uncentred, the two large
    // terms -2 mu dm2 / d and 2 dm2 h / d cancel on near-constant rows)
    float dp[T], dS[T], dscore[T], add[T], mul[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float dg = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) dg += p.W[i * T + j] * dl[j];
      dg = dg / static_cast<float>(T);
      dscore[i] = dg * s.g[i] * (1.f - s.g[i]);
      if (a.use_ln) {
        dp[i] = dscore[i] * s.r[i];
        dS[i] = -dp[i] * s.mu[i];
        const float r3 = __fmul_rn(__fmul_rn(s.r[i], s.r[i]), s.r[i]);
        const float dvar = __fmul_rn(-0.5f * (dscore[i] * s.pc[i]), r3);
        // max(diff, 0): full gradient above 0, half at the tie, none below
        const float f =
            s.diff[i] > 0.f ? 1.f : (s.diff[i] == 0.f ? 0.5f : 0.f);
        const float dm2 = dvar * f;
        add[i] = div(-dp[i] * p.S[i]);
        mul[i] = div(2.f * dm2);
      } else {
        dp[i] = dscore[i];
        dS[i] = 0.f;
        add[i] = 0.f;
        mul[i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < E / V; ++k) {
      const int col = (k * G + lane) * V;
      if (col >= a.d) continue;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        float o[V];
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int e = k * V + u;
          const float x = h[i][e];
          const float dh = a.scale * s.att[i] * go[e] +
                           dp[i] * p.v[i][col + u] + add[i] +
                           mul[i] * (x - s.mu[i]);
          // the ReLU's gradient where the channel has it (h = relu(z): z
          // > 0 exactly where h > 0)
          o[u] = ((M >> i) & 1) ? (x > 0.f ? dh : 0.f) : dh;
          dv[i][e] += dp[i] * x;
        }
        store_vec<V>(a.dz[i] + row * a.d + col, o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        slot[i] += dS[i];
        slot[T + i] += dscore[i];
#pragma unroll
        for (int j = 0; j < T; ++j)
          slot[2 * T + i * T + j] += s.g[i] * dl[j];
      }
    }
  }

  // Fold the warp's row groups (xor shuffles), then add the warps into
  // shared memory in warp order; lanes 0..G-1 then hold their columns.
  // The row sums add over the block's row groups in order.
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        dv[i][e] += __shfl_xor_sync(0xffffffffu, dv[i][e], off);
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane32 < G) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
#pragma unroll
        for (int k = 0; k < E / V; ++k) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const int idx = i * GE + (k * G + lane32) * V + u;
            red[idx] = (w == 0 ? 0.f : red[idx]) + dv[i][k * V + u];
          }
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < RS) {
    float acc = 0.f;
    for (int r = 0; r < kThreads / G; ++r) acc += rsum[r][threadIdx.x];
    red[T * GE + threadIdx.x] = acc;
  }
  __syncthreads();
  const int cols = T * a.d + RS;
  float* prow = a.partials + static_cast<int64_t>(blockIdx.x) * cols;
  for (int t = threadIdx.x; t < cols; t += kThreads) {
    prow[t] = t < T * a.d ? red[(t / a.d) * GE + t % a.d]
                          : red[T * GE + t - T * a.d];
  }
}

// Sums the partials' rows in a fixed order: 32 row slices per column,
// then the slices in order.  dv = the dv share + dS, dc = dscore (0
// without LayerNorm), dW = g (x) dl / T.
template <int T>
__global__ void __launch_bounds__(kFinishThreads)
attn_bwd_finish_kernel(const float* __restrict__ partials, int grid, int d,
                       int use_ln, float* __restrict__ dv,
                       float* __restrict__ dc, float* __restrict__ dW) {
  extern __shared__ float tot[];  // [T d + row_sums(T)]
  __shared__ float part[32][33];
  const int cols = T * d + row_sums(T);
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int col = c0 + x;
    float acc = 0.f;
    if (col < cols) {
      for (int b = y; b < grid; b += 32)
        acc += partials[static_cast<int64_t>(b) * cols + col];
    }
    part[y][x] = acc;
    __syncthreads();
    if (y == 0 && col < cols) {
      float sum = 0.f;
      for (int k = 0; k < 32; ++k) sum += part[k][x];
      tot[col] = sum;
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < T * d; t += kFinishThreads)
    dv[t] = tot[t] + tot[T * d + t / d];
  if (threadIdx.x < T)
    dc[threadIdx.x] = use_ln ? tot[T * d + T + threadIdx.x] : 0.f;
  if (threadIdx.x < T * T)
    dW[threadIdx.x] =
        tot[T * d + 2 * T + threadIdx.x] / static_cast<float>(T);
}

// Blocks of `kernel` the card holds at once (SMs x resident per SM).
template <typename Kernel>
cudaError_t resident(Kernel kernel, int* active) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err == cudaSuccess) *active = sms * per_sm;
  return err;
}

// grid <= 0: ask the residency of the instance (no launch)
template <int T, int M, int V, int G, int E>
cudaError_t run_fwd(const Args& a, int grid, int* active, cudaStream_t st) {
  if (grid <= 0) return resident(attn_fwd_kernel<T, M, V, G, E>, active);
  attn_fwd_kernel<T, M, V, G, E><<<grid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <int T, int M, int V, int G, int E>
cudaError_t run_bwd(const Args& a, float* dv, float* dc, float* dW, int grid,
                    int* active, cudaStream_t st) {
  if (grid <= 0) return resident(attn_bwd_kernel<T, M, V, G, E>, active);
  attn_bwd_kernel<T, M, V, G, E><<<grid, kThreads, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = T * a.d + row_sums(T);
  attn_bwd_finish_kernel<T><<<1, kFinishThreads, cols * sizeof(float), st>>>(
      a.partials, grid, a.d, a.use_ln, dv, dc, dW);
  return cudaGetLastError();
}

// (V, G, E) instances; attention_plan in models/layers.py picks one of
// ACM_K23_INSTANCES.  ACM_K23_SWEEP (8 and 16 lanes a row at d = 64) only
// chip_smoke.py's sweep runs, through layers._launch_forward /
// _launch_backward, and only the variant-0 channels have it.
#define ACM_K23_INSTANCES(X)                                             \
  X(2, 1, 2) X(1, 1, 2) X(4, 1, 8) X(1, 1, 8) X(4, 1, 16) X(1, 1, 16)    \
  X(4, 2, 16) X(1, 2, 16) X(4, 4, 16) X(1, 4, 16) X(4, 8, 16)            \
  X(1, 8, 16) X(4, 16, 16) X(1, 16, 16) X(4, 32, 16) X(1, 32, 16)        \
  X(4, 32, 32) X(1, 32, 32)
#define ACM_K23_SWEEP(X) X(4, 8, 8) X(4, 16, 4)

// (T, ReLU mask) instances: bit i of the mask puts the ReLU on channel i
// (low, high, mlp, struc): variant 0, variant 1, acmsgc, then the
// structure channel with variant 0 and with variant 1
#define ACM_K23_CHANNELS(X) X(3, 7) X(3, 4) X(3, 0) X(4, 15) X(4, 12)

struct Launch {
  int vec, lanes, elems, grid;
  int* active;
  cudaStream_t st;
};

template <int T, int M>
cudaError_t fwd_instance(const Args& a, const Launch& l) {
  cudaError_t err = cudaErrorInvalidValue;  // no such instance
#define ACM_FWD(V, G, E)                                          \
  if (l.vec == V && l.lanes == G && l.elems == E) {               \
    err = run_fwd<T, M, V, G, E>(a, l.grid, l.active, l.st);      \
  } else
  ACM_K23_INSTANCES(ACM_FWD) {
    if constexpr (T == 3 && M == 7) {
      ACM_K23_SWEEP(ACM_FWD) {}
    }
  }
#undef ACM_FWD
  return err;
}

template <int T, int M>
cudaError_t bwd_instance(const Args& a, float* dv, float* dc, float* dW,
                         const Launch& l) {
  cudaError_t err = cudaErrorInvalidValue;  // no such instance
#define ACM_BWD(V, G, E)                                                  \
  if (l.vec == V && l.lanes == G && l.elems == E) {                       \
    err = run_bwd<T, M, V, G, E>(a, dv, dc, dW, l.grid, l.active, l.st);  \
  } else
  ACM_K23_INSTANCES(ACM_BWD) {
    if constexpr (T == 3 && M == 7) {
      ACM_K23_SWEEP(ACM_BWD) {}
    }
  }
#undef ACM_BWD
  return err;
}

void set_channels(Args& a, int t, const void* z0, const void* z1,
                  const void* z2, const void* z3, int64_t ld0, int64_t ld1,
                  int64_t ld2, int64_t ld3) {
  const void* z[kMaxT] = {z0, z1, z2, z3};
  const int64_t ld[kMaxT] = {ld0, ld1, ld2, ld3};
  for (int i = 0; i < kMaxT; ++i) {
    a.z[i] = i < t ? static_cast<const float*>(z[i]) : nullptr;
    a.ld[i] = i < t ? ld[i] : 0;
  }
}

}  // namespace

// t channels z0..z{t-1} (z3 unused at t = 3), relu_mask: bit i puts the
// ReLU on channel i
extern "C" int acm_k2_attn_fwd(const void* z0, const void* z1, const void* z2,
                               const void* z3, int64_t ld0, int64_t ld1,
                               int64_t ld2, int64_t ld3, int t,
                               int relu_mask, const void* v, const void* c,
                               const void* W, void* out, int n, int d,
                               int use_ln, float scale, int vec, int lanes,
                               int elems, int grid, int* active,
                               void* stream) {
  Args a{};
  set_channels(a, t, z0, z1, z2, z3, ld0, ld1, ld2, ld3);
  a.v = static_cast<const float*>(v);
  a.c = static_cast<const float*>(c);
  a.W = static_cast<const float*>(W);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.d = d;
  a.use_ln = use_ln;
  a.scale = scale;
  const Launch l{vec, lanes, elems, grid, active,
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;  // no such instance
#define ACM_CH(T_, M_)                          \
  if (t == T_ && relu_mask == M_) {             \
    err = fwd_instance<T_, M_>(a, l);           \
  } else
  ACM_K23_CHANNELS(ACM_CH) {}
#undef ACM_CH
  return static_cast<int>(err);
}

extern "C" int acm_k3_attn_bwd(
    const void* z0, const void* z1, const void* z2, const void* z3,
    int64_t ld0, int64_t ld1, int64_t ld2, int64_t ld3, int t, int relu_mask,
    const void* gout, int64_t ldg, const void* v, const void* c,
    const void* W, void* dz0, void* dz1, void* dz2, void* dz3,
    void* partials, void* dv, void* dc, void* dW, int n, int d, int use_ln,
    float scale, int vec, int lanes, int elems, int grid, int* active,
    void* stream) {
  Args a{};
  set_channels(a, t, z0, z1, z2, z3, ld0, ld1, ld2, ld3);
  a.gout = static_cast<const float*>(gout);
  a.ldg = ldg;
  a.v = static_cast<const float*>(v);
  a.c = static_cast<const float*>(c);
  a.W = static_cast<const float*>(W);
  void* dz[kMaxT] = {dz0, dz1, dz2, dz3};
  for (int i = 0; i < kMaxT; ++i)
    a.dz[i] = i < t ? static_cast<float*>(dz[i]) : nullptr;
  a.partials = static_cast<float*>(partials);
  a.n = n;
  a.d = d;
  a.use_ln = use_ln;
  a.scale = scale;
  const Launch l{vec, lanes, elems, grid, active,
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;  // no such instance
#define ACM_CH(T_, M_)                                                     \
  if (t == T_ && relu_mask == M_) {                                        \
    err = bwd_instance<T_, M_>(a, static_cast<float*>(dv),                 \
                               static_cast<float*>(dc),                    \
                               static_cast<float*>(dW), l);                \
  } else
  ACM_K23_CHANNELS(ACM_CH) {}
#undef ACM_CH
  return static_cast<int>(err);
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
