"""Build, bind and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Libraries are built at first
use into ``acmgnn_tpu_torch/build/`` (ignored by git) and rebuilt when the
source is newer.  ``build()`` compiles every source in parallel, one
``nvcc`` process each.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.  Wrappers call
``count(name)`` once per launch, so a run can show which kernels its main
path went through (``launches``, ``reset_launches``); ``CountedGraph``
keeps that count true for launches a CUDA graph replays.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("spmm", "attention", "coo", "rocauc", "halo", "panel_gather",
           "dropout", "loop")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: collections.Counter = collections.Counter()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint32
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
# argtypes of every C entry point, by library
_SIGNATURES = {
    "spmm": {
        # indptr, indices, vals, vals_bf16, row_ids, x, x_bf16, ld, z,
        # alpha, beta, row_scale, out, n_rows, d, class_end (host), form,
        # stream
        "acm_k1_spmm": [_P, _P, _P, _I, _P, _P, _I, _L, _P, _P, _P, _P, _P,
                        _I, _I, _IP, _I, _P],
    },
    "attention": {
        # z0..z3, ld0..ld3, t (channels), relu_mask, v, c, W, out, n, d,
        # use_ln, scale, vec, lanes, elems, grid (0: residency query into
        # active), active, stream
        "acm_k2_attn_fwd": [_P] * 4 + [_L] * 4 + [_I, _I, _P, _P, _P, _P, _I,
                                                  _I, _I, _F, _I, _I, _I, _I,
                                                  _IP, _P],
        # z0..z3, ld0..ld3, t, relu_mask, gout, ldg, v, c, W, dz0..dz3,
        # partials, dv, dc, dW, n, d, use_ln, scale, vec, lanes, elems,
        # grid, active, stream
        "acm_k3_attn_bwd": [_P] * 4 + [_L] * 4 + [_I, _I, _P, _L, _P, _P, _P]
        + [_P] * 4 + [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _IP,
                      _P],
    },
    "coo": {
        # row, col, val, nnz, slice_nnz, slice_offset, span_rows,
        # span_first, span_last, n_span, empty_rows, n_empty, x, z, alpha,
        # beta, carry, out, n_rows, d, stream
        "acm_k5_coo_spmm": [_P, _P, _P, _L, _I, _I, _P, _P, _P, _I, _P, _I,
                            _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "rocauc": {
        # s_sorted, order, packed, n, n_cols, n_masks, tile, tickets,
        # stats, col_auc, counts, auc, stream
        "acm_k4_rocauc": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P],
    },
    "halo": {
        # x, sign, pre_scale, rows, d, ld, out_bf16, own, send_idx,
        # n_send_rows, send, stream
        "acm_k6_halo_pack": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P,
                             _P],
    },
    "panel_gather": {
        # x, idx, out, p, d, elem_bytes, m_rows, per_row, form,
        # grid_blocks, active (out), stream
        "acm_k7_panel_gather": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _IP,
                                _P],
    },
    "dropout": {
        # h, out, n, dtype, vec, seed (device), rank, epoch (device), site,
        # keep_prob, stream
        "acm_k8_dropout": [_P, _P, _L, _I, _I, _P, _U, _P, _U, _F, _P],
    },
    "loop": {
        # inner graph, k, limit, stop, exec (out), outer graph (out)
        "acm_k9_loop_build": [_P, _P, _P, _P, _PP, _PP],
        "acm_k9_loop_launch": [_P, _P],          # exec, stream
        "acm_k9_loop_destroy": [_P, _P],         # exec, outer graph
        # graph, types (out), capacity, count (in/out)
        "acm_k9_node_types": [_P, _IP, _I, _IP],
    },
}


def count(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


class CountedGraph:
    """A captured graph whose kernel launches count once per replay.

    A wrapper counts when it is called, which under stream capture is when
    its launch is recorded, not run.  ``record()`` runs the capture into
    ``graph``; the counts it added are taken out again and added once per
    ``replay``, so ``launches`` counts the launches that ran."""

    def __init__(self, graph, record):
        before = launches.copy()
        record()
        self.per_replay = launches - before
        launches.clear()
        launches.update(before)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        self.ran(1)

    def ran(self, bodies: int) -> None:
        """Count ``bodies`` runs of the graph (a device loop's bodies)."""
        for name, n in self.per_replay.items():
            launches[name] += n * bodies


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"libacm_{name}.so"


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = CSRC_DIR / f"{name}.cu"
    return not so.exists() or so.stat().st_mtime < src.stat().st_mtime


def build(names=SOURCES) -> float:
    """Compile the stale sources in parallel; returns the wall seconds.
    The compiler's output (register and spill counts) lands in
    ``build_log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = BUILD_DIR / f".libacm_{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _so_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_so_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.acm_error_string.argtypes = [ctypes.c_int]
        lib.acm_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.acm_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or NULL for ``None``."""
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(*tensors, strided=()) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous;
    those in ``strided`` need only lie on that device."""
    dev = tensors[0].device
    for t in (*tensors, *strided):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel operands must be contiguous")
