"""Sorted-COO sparse operator halves, and their SpMM kernel (K5).

Counterpart of the COO path of ``acmgnn_tpu/ops/spmm.py``
(``_coo_matvec_rows``, ``_coo_spmm`` and its VJP over the transpose
triplets).  A half is one matrix (``A`` or ``Aᵀ``) as row-sorted triplets
``row/col/val`` (f32 values, f32 operand, f32 sum), unpadded: the JAX
package pads to a multiple of 512 with ``row = N``, a TPU shape habit.

K5 balances nonzeros, not rows: the triplets are cut into slices of
``slice_nnz`` nonzeros, one warp each.  A row wholly inside a slice is
reduced and stored there; a row that crosses a slice boundary leaves a
partial sum per slice in a carry buffer, and a second launch adds those
in slice order and stores the row.  Which rows cross a boundary (and from
which slice to which), and which rows hold no triplet at all, depends
only on the structure, so the host finds them once per operator.

A half that is a block of rows of a larger matrix (a rank's share of a
sharded operator) can keep the larger matrix's slice grid: with
``nnz_offset``, the position of its first triplet there, the first slice
is cut short so that every row is split, and so summed, exactly as in
the whole matrix's half.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.ell import _columns, column_constants

# Nonzeros per K5 slice (one warp each: 8 per lane).  A hub row of degree
# k spans about k / SLICE_NNZ slices, whose partial sums one thread adds.
SLICE_NNZ = 256


@dataclasses.dataclass
class CooHalf:
    """One matrix as row-sorted triplets plus K5's slice partition."""

    row: torch.Tensor           # [nnz] int32, ascending
    col: torch.Tensor           # [nnz] int32
    val: torch.Tensor           # [nnz] f32
    num_rows: int
    slice_nnz: int
    span_rows: torch.Tensor     # [S] int32: rows crossing a slice boundary
    span_first: torch.Tensor    # [S] int32: slice holding the row's first nz
    span_last: torch.Tensor     # [S] int32: slice holding the row's last nz
    empty_rows: torch.Tensor    # [E] int32: rows without a triplet
    num_cols: Optional[int] = None  # operand rows; None: square, num_rows
    # the slice grid's phase: slice s holds triplets
    # [s * slice_nnz - slice_offset, (s + 1) * slice_nnz - slice_offset)
    slice_offset: int = 0

    def __post_init__(self):
        if self.num_cols is None:
            self.num_cols = self.num_rows

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def n_slices(self) -> int:
        if self.nnz == 0:
            return 0
        return -(-(self.nnz + self.slice_offset) // self.slice_nnz)

    def to(self, device) -> "CooHalf":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_coo_half(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                  num_rows: int, slice_nnz: int = SLICE_NNZ,
                  num_cols: Optional[int] = None,
                  nnz_offset: int = 0) -> CooHalf:
    """A half from row-sorted triplets, with K5's slice partition;
    ``num_cols`` (default ``num_rows``) is the operand's row count, and
    ``nnz_offset`` the first triplet's position in a larger matrix whose
    slice grid the half keeps."""
    if row.size and np.any(np.diff(row) < 0):
        raise ValueError("COO triplets must be sorted by row")
    offset = nnz_offset % slice_nnz
    counts = np.bincount(row, minlength=num_rows)
    indptr = np.concatenate([[0], np.cumsum(counts)]) + offset
    first = indptr[:-1] // slice_nnz
    last = (indptr[1:] - 1) // slice_nnz
    spans = (counts > 0) & (first != last)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    return CooHalf(
        row=i32(row), col=i32(col),
        val=torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32)),
        num_rows=num_rows, slice_nnz=slice_nnz,
        span_rows=i32(np.flatnonzero(spans)), span_first=i32(first[spans]),
        span_last=i32(last[spans]), empty_rows=i32(np.flatnonzero(counts == 0)),
        num_cols=num_cols, slice_offset=offset,
    )


# ---------------------------------------------------------------------------
# K5: nonzero-balanced COO SpMM with a per-column epilogue
# ---------------------------------------------------------------------------


def coo_spmm_plain(half: CooHalf, x: torch.Tensor, z: Optional[torch.Tensor],
                   alpha, beta) -> torch.Tensor:
    """Plain PyTorch version of K5: a gather and a row scatter-add."""
    dev = x.device
    acc = torch.zeros(half.num_rows, x.shape[1], dtype=torch.float32,
                      device=dev)
    acc.index_add_(0, half.row.long(),
                   x.float()[half.col.long()] * half.val[:, None])
    out = column_constants(beta, dev) * acc
    if z is not None:
        out = column_constants(alpha, dev) * z + out
    return out


def _coo_spmm_cuda(half: CooHalf, x, z, alpha, beta):
    n, d = half.num_rows, x.shape[1]
    if x.dtype != torch.float32:
        raise TypeError(f"K5 takes an f32 operand, got {x.dtype}")
    if x.shape[0] != half.num_cols:
        raise ValueError(f"operand has {x.shape[0]} rows, operator "
                         f"{half.num_cols} columns")
    kernels.require_cuda(half.row, half.col, half.val, half.span_rows,
                         half.span_first, half.span_last, half.empty_rows, x,
                         *(() if z is None else (z,)))
    # K5 reads the operand only through ``col`` and indexes z and out by
    # output row, so z is [num_rows, d] also for a rectangular half
    if z is not None and (z.dtype != torch.float32 or z.shape != (n, d)):
        raise ValueError(f"epilogue operand z must be f32 [{n}, {d}]")
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    carry = torch.empty(2 * half.n_slices, d, dtype=torch.float32,
                        device=x.device)
    lib = kernels.library("coo")
    rc = lib.acm_k5_coo_spmm(
        kernels.ptr(half.row), kernels.ptr(half.col), kernels.ptr(half.val),
        half.nnz, half.slice_nnz, half.slice_offset,
        kernels.ptr(half.span_rows),
        kernels.ptr(half.span_first), kernels.ptr(half.span_last),
        int(half.span_rows.shape[0]), kernels.ptr(half.empty_rows),
        int(half.empty_rows.shape[0]), kernels.ptr(x), kernels.ptr(z),
        kernels.ptr(column_constants(alpha, x.device)),
        kernels.ptr(column_constants(beta, x.device)), kernels.ptr(carry),
        kernels.ptr(out), n, d, kernels.stream(),
    )
    kernels.check(lib, rc, "K5 coo spmm")
    kernels.count(f"k5_coo_w{d}")
    return out


def coo_spmm(half: CooHalf, x: torch.Tensor,
             z: Optional[torch.Tensor] = None, alpha=None, beta=None):
    """``out[r, j] = alpha[j]·z[r, j] + beta[j]·Σ_{k: row[k]=r} val[k]·x[col[k], j]``.

    The epilogue contract of ``row_gather_spmm`` (``ops/ell.py``): ``x``
    is [num_cols, d], ``z`` an optional f32 [num_rows, d] residual, ``alpha`` (default 0) and ``beta``
    (default 1) per-column constants.  ``x`` is f32.  A CPU operand runs
    the plain version; a CUDA operand launches K5.
    """
    d = x.shape[1]
    alpha = _columns(alpha, d, 0.0)
    beta = _columns(beta, d, 1.0)
    if z is not None and not any(alpha):
        z = None
    if x.device.type == "cpu":
        return coo_spmm_plain(half, x, z, alpha, beta)
    return _coo_spmm_cuda(half, x.contiguous(),
                          None if z is None else z.contiguous(), alpha, beta)
