"""Host graph preparation through the native ``graphprep`` library —
counterpart of ``acmgnn_tpu/ops/native.py``.

``native/graphprep.cpp`` (symmetrize + dedup of an edge list, the
row-normalized low-pass ``D^-1 (A + I)``, CSR transpose) is compiled with
``g++`` at first use into ``acmgnn_tpu_torch/build/libgraphprep.so``; the
source is read in place.  Every entry point has a scipy path that gives
the same CSR, taken when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.sparse as sp

_SRC = Path(__file__).resolve().parents[2] / "native" / "graphprep.cpp"
_SO = Path(__file__).resolve().parents[1] / "build" / "libgraphprep.so"

_lib: Optional[ctypes.CDLL] = None
_lib_attempted = False


def _build() -> bool:
    """Compile the library (into a file of this process's own, renamed
    into place, so concurrent builds never load a partial file)."""
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                        str(_SRC)], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_attempted
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    if not _SRC.exists():
        return None
    if (not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime) \
            and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.sym_csr_count.restype = ctypes.c_int64
    lib.sym_csr_count.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int, i64p]
    lib.sym_csr_fill.restype = ctypes.c_int64
    lib.sym_csr_fill.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, i64p, i32p]
    lib.lowpass_count.restype = ctypes.c_int64
    lib.lowpass_count.argtypes = [i64p, i32p, ctypes.c_int64, i64p]
    lib.lowpass_fill.restype = None
    lib.lowpass_fill.argtypes = [i64p, i32p, ctypes.c_void_p,
                                 ctypes.c_int64, i64p, i32p, f32p]
    lib.csr_transpose.restype = None
    lib.csr_transpose.argtypes = [i64p, i32p, f32p, ctypes.c_int64, i64p,
                                  i32p, f32p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_sym_adjacency_scipy(src: np.ndarray, dst: np.ndarray, n: int,
                              drop_self_loops: bool = False) -> sp.csr_matrix:
    """``build_sym_adjacency`` through scipy alone (the library returns
    -1 on an endpoint outside ``[0, n)``, and then scipy raises)."""
    a = sp.coo_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))
    out = ((a + a.T) > 0).astype(np.float64).tocsr()
    if drop_self_loops:
        out.setdiag(0)
        out.eliminate_zeros()
    return out


def build_sym_adjacency(src: np.ndarray, dst: np.ndarray, n: int,
                        drop_self_loops: bool = False) -> sp.csr_matrix:
    """Directed edge list -> undirected binary CSR adjacency (symmetrize
    + dedup, sorted columns), through the native library when it builds,
    else through scipy (``build_sym_adjacency_scipy``): the same CSR."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    lib = _load()
    if lib is not None:
        indptr = np.zeros(n + 1, dtype=np.int64)
        nnz = lib.sym_csr_count(src, dst, src.shape[0], n,
                                int(drop_self_loops), indptr)
        if nnz >= 0:
            indices = np.zeros(nnz, dtype=np.int32)
            lib.sym_csr_fill(src, dst, src.shape[0], n,
                             int(drop_self_loops), indptr, indices)
            return sp.csr_matrix(
                (np.ones(nnz, dtype=np.float64), indices, indptr),
                shape=(n, n))
    return build_sym_adjacency_scipy(src, dst, n, drop_self_loops)


def lowpass_operator(adj: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1 (A + I)`` in f32 through the native library (scipy's
    ``row_normalized_adjacency`` without one)."""
    lib = _load()
    if lib is None:
        from acmgnn_tpu_torch.ops.graph import row_normalized_adjacency

        return row_normalized_adjacency(adj)
    csr = sp.csr_matrix(adj)
    n = csr.shape[0]
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    data = np.ascontiguousarray(csr.data, dtype=np.float32)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    nnz = lib.lowpass_count(indptr, indices, n, out_indptr)
    out_indices = np.zeros(nnz, dtype=np.int32)
    out_data = np.zeros(nnz, dtype=np.float32)
    lib.lowpass_fill(indptr, indices, data.ctypes.data_as(ctypes.c_void_p),
                     n, out_indptr, out_indices, out_data)
    return sp.csr_matrix((out_data, out_indices, out_indptr), shape=(n, n))


def csr_transpose(mat: sp.spmatrix) -> sp.csr_matrix:
    """The transpose of a square CSR matrix, f32 values, sorted columns."""
    lib = _load()
    csr = sp.csr_matrix(mat)
    if lib is None:
        return csr.T.tocsr()
    n = csr.shape[0]
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    data = np.ascontiguousarray(csr.data, dtype=np.float32)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    out_indices = np.zeros(csr.nnz, dtype=np.int32)
    out_data = np.zeros(csr.nnz, dtype=np.float32)
    lib.csr_transpose(indptr, indices, data, n, out_indptr, out_indices,
                      out_data)
    return sp.csr_matrix((out_data, out_indices, out_indptr), shape=(n, n))
