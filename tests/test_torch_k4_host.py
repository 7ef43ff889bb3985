"""K4's CUDA source (``csrc/rocauc.cu``) run on the host, against its plain
version.

A CUDA kernel has no CPU mode, so this file compiles the kernel's own
source with the host C++ compiler under a small shim of the CUDA features
it uses: one ``std::thread`` per CUDA thread, ``std::barrier`` for
``__syncthreads`` and for each warp's shuffles, blocks one after another.
That runs the kernel's control flow, its scans, its 16-bit fields, its
tile statistics and its ticket protocol as written (a shuffle that some
lanes of a warp skip deadlocks here as it hangs the card), not its
timing, its memory ordering or its rounding on the card (the host's f64
operations are IEEE, as the card's ``__d*_rn`` intrinsics).  Counts must
equal the plain version's exactly and AUCs bit for bit (the nanmean is
summed in the same column order), and the tickets must be back at zero
after every launch.  Skips where no host C++20 compiler is installed.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.train.metrics import (
    K4_TILES,
    MAX_MASKS,
    pack_labels_and_masks,
    rocauc_from_sorted_plain,
    sort_scores,
)

SOURCE = Path(kernels.CSRC_DIR) / "rocauc.cu"

SHIM = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct longlong2 { long long x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* g_block;
inline std::barrier<>* g_warp[32];
inline unsigned long long g_lane[32][32];
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T> T shfl(T v, int src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_lane[warp][lane] = u;
  g_warp[warp]->arrive_and_wait();
  u = g_lane[warp][src];
  g_warp[warp]->arrive_and_wait();
  T out;
  std::memcpy(&out, &u, sizeof(T));
  return out;
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = threadIdx.x & 31;
  return shfl(v, lane >= static_cast<int>(d) ? lane - static_cast<int>(d)
                                             : lane);
}
template <class T> T __shfl_xor_sync(unsigned, T v, int d) {
  return shfl(v, (threadIdx.x & 31) ^ d);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T> T __ldcg(const T* p) { return *p; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __double2float_rn(double a) { return static_cast<float>(a); }
inline void host_launch(dim3 grid, int threads, std::function<void()> fn) {
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::barrier<> block(threads);
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (int w = 0; w < threads / 32; ++w) {
        warps.emplace_back(new std::barrier<>(32));
        g_warp[w] = warps.back().get();
      }
      g_block = &block;
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t) {
        ts.emplace_back([=] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by);
          fn();
        });
      }
      for (auto& t : ts) t.join();
    }
  }
}
#define HOST_LAUNCH(kernel, grid, threads, smem, stream, ...) \
  host_launch(grid, threads, [=] { kernel(__VA_ARGS__); })
"""


@pytest.fixture(scope="module")
def host_k4(tmp_path_factory):
    """``acm_k4_rocauc`` of rocauc.cu compiled for the host under SHIM."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = SOURCE.read_text()
    launch = re.compile(r"([\w:]+<[^<>]*>)<<<([^>]*)>>>\(")
    assert len(launch.findall(src)) == 1, "one launch site in rocauc.cu"
    src = launch.sub(r"HOST_LAUNCH((\1), \2, ", src)
    out = tmp_path_factory.mktemp("k4_host")
    (out / "cuda_runtime.h").write_text(SHIM)
    (out / "rocauc_host.cpp").write_text(src)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", f"-I{out}", "-o", str(out / "librocauc_host.so"),
         str(out / "rocauc_host.cpp")],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip(f"the host compiler lacks C++20 <barrier>: "
                    f"{proc.stderr[:300]}")
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "librocauc_host.so"))
    lib.acm_k4_rocauc.argtypes = \
        kernels._SIGNATURES["rocauc"]["acm_k4_rocauc"]
    lib.acm_k4_rocauc.restype = ctypes.c_int
    return lib


def _inputs(kind, n, n_masks, seed):
    """``(s_sorted, order, packed)``: random, saturated (a tie group of
    70% of the nodes), quantised, all-equal scores, or multilabel (three
    columns); masks of 30%, 100% and 0% of the nodes, in turn."""
    rng = np.random.default_rng(seed)
    cols = 3 if kind == "multilabel" else 1
    scores = rng.random((cols, n)).astype(np.float32)
    if kind == "saturated":
        scores[rng.random((cols, n)) < 0.7] = 1.0
    elif kind in ("quantised", "multilabel"):
        scores = np.round(scores * 8) / 8
    elif kind == "equal":
        scores[:] = 0.5
    labels = ((rng.random((n, 3)) < 0.4).astype(np.int64) if cols > 1
              else rng.integers(0, 2, n))
    masks = tuple(torch.from_numpy(rng.random(n) < (0.3, 1.0, 0.0)[m % 3])
                  for m in range(n_masks))
    packed = pack_labels_and_masks(torch.from_numpy(labels), masks)
    order, s_sorted = sort_scores(torch.from_numpy(scores))
    return s_sorted, order, packed


def _run(lib, s_sorted, order, packed, n_masks, tile, tickets):
    b, n = s_sorted.shape
    n_tiles = -(-n // tile)
    stats = torch.full((b * n_tiles * n_masks * 4,), -7, dtype=torch.int32)
    col_auc = torch.empty(b, n_masks, dtype=torch.float64)
    counts = torch.full((b, n_masks, 3), -1, dtype=torch.int64)
    auc = torch.full((n_masks,), -1.0)
    rc = lib.acm_k4_rocauc(
        s_sorted.data_ptr(), order.data_ptr(), packed.data_ptr(), n, b,
        n_masks, tile, tickets.data_ptr(), stats.data_ptr(),
        col_auc.data_ptr(), counts.data_ptr(), auc.data_ptr(), None)
    assert rc == 0
    return counts, auc


@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("kind", ("random", "saturated", "quantised",
                                  "equal", "multilabel"))
@pytest.mark.parametrize("n_masks", (1, 2, 3, MAX_MASKS))
def test_k4_source_on_the_host_matches_plain(host_k4, tile, kind, n_masks):
    """One tile of one node, a ragged last tile, and several tiles; the
    tickets back at zero after each launch, and two launches on the same
    tickets equal."""
    for n in (1, tile - 1, 2 * tile + 5):
        s_sorted, order, packed = _inputs(kind, n, n_masks, seed=n + tile)
        want, want_auc = rocauc_from_sorted_plain(s_sorted, order, packed,
                                                  n_masks)
        tickets = torch.zeros(s_sorted.shape[0] + 1, dtype=torch.int32)
        for _ in range(2):
            counts, auc = _run(host_k4, s_sorted, order, packed, n_masks,
                               tile, tickets)
            assert torch.equal(counts, want), (n, counts, want)
            assert torch.equal(auc.view(torch.int32)[~auc.isnan()],
                               want_auc.view(torch.int32)[~want_auc.isnan()])
            assert torch.equal(auc.isnan(), want_auc.isnan())
            assert not tickets.any(), tickets


def test_k4_source_refuses_what_it_does_not_compile(host_k4):
    """A tile size it has no instance for, more masks than a packed byte
    holds, and an empty input return an error code and launch nothing."""
    s_sorted, order, packed = _inputs("random", 100, 2, seed=0)
    tickets = torch.zeros(2, dtype=torch.int32)
    for n, n_masks, tile in ((100, 2, 512), (100, MAX_MASKS + 1, 1024),
                             (0, 2, 1024)):
        rc = host_k4.acm_k4_rocauc(
            s_sorted.data_ptr(), order.data_ptr(), packed.data_ptr(), n, 1,
            n_masks, tile, tickets.data_ptr(), None, None, None, None, None)
        assert rc != 0, (n, n_masks, tile)
