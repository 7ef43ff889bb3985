// K7 — panel gather: rows of a small panel held in shared memory (sm_90a).
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
// What bounds it on an H100: bytes.  Per element it reads one int32 index
// (P1; P2 one per row) and writes one output element; the panel itself is
// at most 2 MiB and is read from L2.  A TPU core's VMEM held the whole
// panel, but a block here has at most 227 KB (232,448 B) of shared memory,
// and the probe's panels are 4 KiB to 2 MiB.  So the design is column
// slices: block (g, r) holds x[:, c0:c0+Dc] for all P rows in dynamic
// shared memory, where Dc is the widest power of two with P·Dc·s within
// the limit (128 at P=8, 64 at P=512 f32, 8 at P=4096 f32, 16 at P=4096
// bf16), and walks one chunk of output rows of that column group.  The
// grid holds about as many blocks as fit on the card at once, so each
// block loads its slice once and not once per chunk of rows.  A slice of
// 128 KiB leaves room for one block per SM, so a block has 1024 threads
// and each thread keeps four index loads in flight: memory latency, not
// the bytes, is what a block of 256 threads was held by (4.05 ms at
// P=4096 f32 against a 0.321 ms bound, H100 80GB HBM3 at 700 W).  Each
// output element is written from shared memory; neighbouring threads
// write neighbouring columns of a row.  P1 reads its own index element
// (coalesced like the output); P2 loads each row's index once per warp
// and shares it across the row's lanes with a shuffle.
//
// A panel that no Dc >= 1 fits is refused (the wrapper names its bytes);
// there is no global-memory fallback.  Indices are not range-checked, as
// on the TPU: an index outside [0, P) reads outside the slice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;      // elements per thread with their loads in flight

// T is the element's storage: uint32_t for f32, uint16_t for bf16 (a bit
// copy either way).
template <typename T, bool kPerRow>
__global__ void __launch_bounds__(kThreads)
panel_gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                    T* __restrict__ out, int p, int d, int dc,
                    int64_t m_rows, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slice = reinterpret_cast<T*>(smem_raw);
  const int c0 = blockIdx.x * dc;
  const int w = min(dc, d - c0);          // this group's width
  // the slice: slice[q * w + j] = x[q, c0 + j]
  const int n_slice = p * w;
  for (int e = threadIdx.x; e < n_slice; e += kThreads) {
    const int q = e / w;
    slice[e] = x[static_cast<int64_t>(q) * d + c0 + (e - q * w)];
  }
  __syncthreads();

  const int64_t r0 = blockIdx.y * rows_per_block;
  const int64_t r1 =
      r0 + rows_per_block < m_rows ? r0 + rows_per_block : m_rows;
  if (r0 >= r1) return;
  const int64_t n_elem = (r1 - r0) * w;
  const int lane = threadIdx.x & 31;
  // Each pass covers kUnroll * kThreads consecutive elements: the index
  // loads of all kUnroll go out before any is used.  Every lane of a warp
  // runs the same passes, so the per-row form's shuffle has the whole warp.
  for (int64_t base = 0; base < n_elem; base += kUnroll * kThreads) {
    int64_t o[kUnroll];
    int jj[kUnroll], q[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = base + u * kThreads + threadIdx.x;
      valid[u] = e < n_elem;
      const int64_t ee = valid[u] ? e : n_elem - 1;
      const int64_t m = r0 + ee / w;
      jj[u] = static_cast<int>(ee % w);
      o[u] = m * d + c0 + jj[u];
      if (kPerRow) {
        // the row's first lane in this warp loads its index: lane - j when
        // the row starts in this warp, else lane 0, which is in the row
        q[u] = (jj[u] == 0 || lane == 0) ? __ldg(idx + m) : 0;
      } else {
        q[u] = valid[u] ? __ldg(idx + o[u]) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kPerRow) {
        q[u] = __shfl_sync(0xffffffffu, q[u], lane >= jj[u] ? lane - jj[u] : 0);
      }
      if (valid[u]) out[o[u]] = slice[q[u] * w + jj[u]];
    }
  }
}

template <typename T, bool kPerRow>
cudaError_t launch(const void* x, const int32_t* idx, void* out, int p,
                   int d, int dc, int64_t m_rows, cudaStream_t stream) {
  auto kernel = panel_gather_kernel<T, kPerRow>;
  const size_t smem = static_cast<size_t>(p) * dc * sizeof(T);
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (dc < 1 || smem > static_cast<size_t>(max_smem)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int groups = (d + dc - 1) / dc;
  // about as many blocks as fit on the card at once, at least one row each
  int64_t chunks = (static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) +
                    groups - 1) / groups;
  if (chunks > m_rows) chunks = m_rows;
  if (chunks < 1) chunks = 1;
  const int64_t rows_per_block = (m_rows + chunks - 1) / chunks;
  chunks = (m_rows + rows_per_block - 1) / rows_per_block;
  dim3 grid(groups, static_cast<unsigned>(chunks));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), idx, static_cast<T*>(out), p, d, dc, m_rows,
      rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// x [p, d], out [m_rows, d] of elem_bytes (4: f32, 2: bf16); idx int32
// [m_rows, d] (per_row 0) or [m_rows] (per_row 1); dc the column slice
// width (p·dc·elem_bytes within the block's shared memory).
extern "C" int acm_k7_panel_gather(const void* x, const void* idx, void* out,
                                   int p, int d, int dc, int64_t m_rows,
                                   int elem_bytes, int per_row,
                                   void* stream) {
  if (m_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* ix = static_cast<const int32_t*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 4) {
    err = per_row ? launch<uint32_t, true>(x, ix, out, p, d, dc, m_rows, st)
                  : launch<uint32_t, false>(x, ix, out, p, d, dc, m_rows, st);
  } else if (elem_bytes == 2) {
    err = per_row ? launch<uint16_t, true>(x, ix, out, p, d, dc, m_rows, st)
                  : launch<uint16_t, false>(x, ix, out, p, d, dc, m_rows, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
