// K7 — panel gather: whole rows of a small panel held on chip (sm_90a).
//
//   per element (P1):  out[m, j] = x[idx[m, j], j]     idx int32 [M, D]
//   per row     (P2):  out[m, j] = x[idx[m], j]        idx int32 [M]
//
// x is a [P, D] panel, f32 or bf16; out is [M, D] of the same type.  The
// gather copies bits, so it is exact.
//
// Replaces the two Pallas kernels of tools/pallas_gather_probe.py:
// `make_vmem_gather` (:52-77, pl.pallas_call :62: take_along_axis over a
// P-row panel held whole in VMEM, one grid step per P output rows) and
// `make_vmem_gather_bcast` (:80-106, :91: the same with a [M, 1] index
// stream broadcast across the row inside the kernel).
//
// What bounds it on an H100: bytes.  Per row it reads D int32 indices (P1)
// or one (P2) and writes one output row; the panel (4 KiB to 2 MiB at the
// probe's shapes) is read on chip.  A TPU core's VMEM held the whole
// panel; a block here has at most 227 KB (232,448 B) of shared memory.
// The design (ops/panel_gather.py `panel_plan` computes it on the host):
// - output in whole rows: a warp writes a row in 16-byte units (a 512-byte
//   f32 row is 32 lanes × 16 B, a 256-byte bf16 row 16 lanes × 16 B, two
//   rows per pass); rows whose bytes are not a multiple of 16 use the
//   largest power of two that divides them.  Each warp owns a contiguous
//   range of output rows, walked in chunks of 32 with several units in
//   flight per lane;
// - P2: the warp loads a chunk's 32 row indices in one coalesced load and
//   broadcasts each by shuffle; P1: a lane loads the indices of its unit's
//   elements in one 16-byte load, reads those elements, and stores the
//   unit at once;
// - the panel: where it fits one block's shared memory (P=8) every block
//   loads all of it with 16-byte cp.async pieces and reads rows there
//   ("block" form); a larger panel is read from device memory, where it
//   stays in the 50 MB L2 (the same warp-per-row kernel with __ldg; "l2"
//   form).  The host plan (ops/panel_gather.py `panel_plan`) picks the
//   form by that size rule alone.  A thread-block cluster splitting the
//   panel by rows over distributed shared memory lost to the L2 form at
//   every probe panel that needs one (H100; PERF.md §6), so it is not
//   built.
// The grid holds as many blocks as are resident at once (the occupancy
// query below); in the block form each loads the panel once.  Indices are
// not range-checked, as on the TPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;       // units each lane loads before it stores

enum Form { kL2 = 0, kBlock = 1 };

struct Params {
  const unsigned char* x;
  const int32_t* idx;
  unsigned char* out;
  int p, d;                 // panel rows, row elements
  int row_bytes, units;     // a row's bytes, and its units of sizeof(V)
  int64_t m_rows;
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// E consecutive int32 indices, in 16-, 8- or 4-byte loads
template <int E>
__device__ __forceinline__ void load_idx(const int32_t* p, int (&q)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p + e));
      q[e] = v.x;
      q[e + 1] = v.y;
      q[e + 2] = v.z;
      q[e + 3] = v.w;
    }
  } else if constexpr (E == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    q[0] = v.x;
    q[1] = v.y;
  } else {
    q[0] = __ldg(p);
  }
}

template <typename V, typename T>
union Unit {
  V v;
  T e[sizeof(V) / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ T load_from(const T* p, bool global) {
  return global ? __ldg(p) : *p;
}

// V: the unit of a row moved at once (uint4, uint2, uint32_t, uint16_t);
// T: the element (uint32_t for f32, uint16_t for bf16; bits are copied).
template <typename V, typename T, bool kPerRow, int kForm>
__global__ void __launch_bounds__(kThreads)
panel_gather_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = sizeof(V) / sizeof(T);
  // units in flight: P1 keeps E indices of each, so 8-element units
  // (bf16) take half as many within the 64 registers 1024 threads allow
  constexpr int kFly = !kPerRow && E > 4 ? kInFlight / 2 : kInFlight;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // the whole panel into this block's shared memory
  if constexpr (kForm == kBlock) {
    const int n = a.p * a.units;
    const V* src = reinterpret_cast<const V*>(a.x);
    V* dst = reinterpret_cast<V*>(smem);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if constexpr (sizeof(V) >= 4) {
        cp_async<sizeof(V)>(dst + i, src + i);
      } else {
        dst[i] = src[i];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // the base of panel row q's bytes, wherever it is held
  auto row_ptr = [&](int q) -> const unsigned char* {
    if constexpr (kForm == kL2) {
      return a.x + static_cast<int64_t>(q) * a.row_bytes;
    } else {
      return smem + q * a.row_bytes;
    }
  };
  constexpr bool kGlobal = kForm == kL2;

  // lanes over a row's units, once per thread: rows of at most 32 units
  // take rows_per_pass rows a pass, longer rows one row and upl units a
  // lane
  const int units = a.units;
  const int lanes_per_row = units < 32 ? units : 32;
  const int rows_per_pass = 32 / lanes_per_row;
  const int sub = lane / lanes_per_row;
  const int c_lane = lane - sub * lanes_per_row;
  const bool lane_on = sub < rows_per_pass;
  const int upl = (units + lanes_per_row - 1) / lanes_per_row;

  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t r_end = a.m_rows * (gw + 1) / nw;
  V* out = reinterpret_cast<V*>(a.out);
  for (int64_t base = a.m_rows * gw / nw; base < r_end; base += 32) {
    const int nrows = static_cast<int>(min(static_cast<int64_t>(32),
                                           r_end - base));
    int my_q = 0;
    if constexpr (kPerRow) {
      if (lane < nrows) my_q = __ldg(a.idx + base + lane);
    }
    const int n_pass = (nrows + rows_per_pass - 1) / rows_per_pass;
    for (int pass0 = 0; pass0 < n_pass; pass0 += kFly) {
      for (int k = 0; k < upl; ++k) {
        const int c = c_lane + k * lanes_per_row;
        int j[kFly];
        bool ok[kFly];
        Unit<V, T> v[kFly];
        if constexpr (kPerRow) {
#pragma unroll
          for (int u = 0; u < kFly; ++u) {
            j[u] = (pass0 + u) * rows_per_pass + sub;
            ok[u] = lane_on && j[u] < nrows && c < units;
            const int q = __shfl_sync(0xffffffffu, my_q, j[u] & 31);
            if (ok[u]) {
              v[u].v = load_from(
                  reinterpret_cast<const V*>(row_ptr(q)) + c, kGlobal);
            }
          }
        } else {
          int q[kFly][E];
#pragma unroll
          for (int u = 0; u < kFly; ++u) {
            j[u] = (pass0 + u) * rows_per_pass + sub;
            ok[u] = lane_on && j[u] < nrows && c < units;
            if (ok[u]) {
              load_idx<E>(a.idx + (base + j[u]) * a.d + c * E, q[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kFly; ++u) {
            if (ok[u]) {
#pragma unroll
              for (int e = 0; e < E; ++e) {
                v[u].e[e] = load_from(
                    reinterpret_cast<const T*>(row_ptr(q[u][e])) + c * E + e,
                    kGlobal);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kFly; ++u) {
          if (ok[u]) out[(base + j[u]) * units + c] = v[u].v;
        }
      }
    }
  }
}

// Query (grid_blocks == 0: set the instance's attributes, *active = blocks
// resident at once) or launch one instance.  The wrapper queries every
// panel before its first launch, so a launch sets no attribute (nothing
// but the launch is issued, also under graph capture).
template <typename V, typename T, bool kPerRow, int kForm>
cudaError_t run(const Params& a, int grid_blocks, int* active,
                cudaStream_t stream) {
  auto kernel = panel_gather_kernel<V, T, kPerRow, kForm>;
  const size_t smem =
      kForm == kL2 ? 0 : static_cast<size_t>(a.p) * a.row_bytes;
  if (grid_blocks > 0) {
    kernel<<<grid_blocks, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  // the largest a block may ask for, so any panel of this instance fits
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  *active = sms * per_sm;
  return err;
}

template <typename V, typename T, bool kPerRow>
cudaError_t by_form(const Params& a, int form, int grid_blocks, int* active,
                    cudaStream_t st) {
  switch (form) {
    case kL2:
      return run<V, T, kPerRow, kL2>(a, grid_blocks, active, st);
    case kBlock:
      return run<V, T, kPerRow, kBlock>(a, grid_blocks, active, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// P2 moves units whatever the element; P1 reads elements of T
template <typename V>
cudaError_t by_kind(const Params& a, int elem_bytes, int per_row, int form,
                    int grid_blocks, int* active, cudaStream_t st) {
  if (per_row) {
    return by_form<V, V, true>(a, form, grid_blocks, active, st);
  }
  if (elem_bytes == 4) {
    if constexpr (sizeof(V) >= 4) {
      return by_form<V, uint32_t, false>(a, form, grid_blocks, active, st);
    }
    return cudaErrorInvalidValue;
  }
  return by_form<V, uint16_t, false>(a, form, grid_blocks, active, st);
}

}  // namespace

// x [p, d], out [m_rows, d] of elem_bytes (4: f32, 2: bf16), both 16-byte
// aligned; idx int32 [m_rows, d] (per_row 0, 16-byte aligned: a unit's
// indices are one vector load) or [m_rows] (per_row 1).
// form 0 (l2: the panel read through L2) or 1 (block: each block holds
// the whole panel in shared memory).  grid_blocks 0: no launch, *active
// receives the blocks resident on the card at once.
extern "C" int acm_k7_panel_gather(const void* x, const void* idx, void* out,
                                   int p, int d, int elem_bytes,
                                   int64_t m_rows, int per_row, int form,
                                   int grid_blocks, int* active,
                                   void* stream) {
  if (grid_blocks > 0 && (m_rows <= 0 || d <= 0)) {
    return static_cast<int>(cudaGetLastError());
  }
  if (elem_bytes != 4 && elem_bytes != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a;
  a.x = static_cast<const unsigned char*>(x);
  a.idx = static_cast<const int32_t*>(idx);
  a.out = static_cast<unsigned char*>(out);
  a.p = p;
  a.d = d;
  a.row_bytes = d * elem_bytes;
  a.m_rows = m_rows;
  const int rb = a.row_bytes;
  const int unit = (rb & 15) == 0 ? 16 : (rb & 7) == 0 ? 8 : (rb & 3) == 0 ? 4 : 2;
  a.units = rb / unit;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (unit) {
    case 16:
      err = by_kind<uint4>(a, elem_bytes, per_row, form, grid_blocks,
                           active, st);
      break;
    case 8:
      err = by_kind<uint2>(a, elem_bytes, per_row, form, grid_blocks,
                           active, st);
      break;
    case 4:
      err = by_kind<uint32_t>(a, elem_bytes, per_row, form, grid_blocks,
                              active, st);
      break;
    default:
      err = by_kind<uint16_t>(a, elem_bytes, per_row, form, grid_blocks,
                              active, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
