"""Host-side graph representation and operator precompute.

Counterpart of ``acmgnn_tpu/ops/graph.py``: the row-normalized low-pass
``Â = D^-1 (A + I)`` is built on the host with scipy and shipped to the
device once.  The high-pass ``I - Â`` never exists as data; it is computed
as ``z - Â z`` (``spmm_high``/``spmm_multi``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.ops.coo import CooHalf, make_coo_half
from acmgnn_tpu_torch.ops.ell import EllOp, make_ell_op

# Above this node count the "auto" operator format is ELL, at or below it
# dense (the JAX package's threshold; the dense format is not ported yet).
DEFAULT_DENSE_THRESHOLD = 4096


@dataclasses.dataclass
class GraphData:
    """A loaded graph dataset, host-side (NumPy / SciPy)."""

    name: str
    adj: sp.spmatrix                 # [N, N] raw (unnormalized) adjacency
    features: np.ndarray             # [N, F] float32
    labels: np.ndarray               # [N] int labels, or [N, C] multilabel
    splits: Optional[list] = None    # list of dicts {train/valid/test: idx}
    # node permutation applied to adj/features/labels (locality reorder);
    # split masks given in the original node ids are permuted with it
    perm: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_classes(self) -> int:
        if self.labels.ndim > 1 and self.labels.shape[1] > 1:
            return int(self.labels.shape[1])
        return int(self.labels.max()) + 1


@dataclasses.dataclass
class CooOp:
    """Row-sorted COO operator with its transpose triplets (the backward's
    operator), both unpadded.  Values, operand and sums are f32: the JAX
    package's COO path has no gather dtype either."""

    fwd: CooHalf                 # A: row / col / val
    bwd: CooHalf                 # Aᵀ sorted by its own rows
    num_nodes: int
    nnz: int

    def to(self, device) -> "CooOp":
        return dataclasses.replace(self, fwd=self.fwd.to(device),
                                   bwd=self.bwd.to(device))


def _coo_sorted_triplets(mat: sp.spmatrix):
    coo = sp.coo_matrix(mat)
    order = np.lexsort((coo.col, coo.row))
    return (coo.row[order].astype(np.int32), coo.col[order].astype(np.int32),
            coo.data[order].astype(np.float32))


def make_coo_op(mat: sp.spmatrix) -> CooOp:
    """Host build of both halves, in ``acmgnn_tpu.ops.graph.make_coo_op``'s
    lexsort order, without its padding."""
    n = mat.shape[0]
    fwd = make_coo_half(*_coo_sorted_triplets(mat), n)
    bwd = make_coo_half(*_coo_sorted_triplets(mat.T), n)
    return CooOp(fwd=fwd, bwd=bwd, num_nodes=n, nnz=fwd.nnz)


def locality_order(adj: sp.spmatrix, method: str = "rcm") -> np.ndarray:
    """Node permutation that gives neighbours nearby ids (the JAX
    package's): "rcm" is scipy's reverse Cuthill-McKee on the symmetrised
    structure, "degree" sorts by descending degree (stable).  Node
    ``perm[i]`` becomes node i (``permute_graph``, ``x[perm]``)."""
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(
            sp.csr_matrix(adj), symmetric_mode=True)).astype(np.int64)
    if method == "degree":
        deg = np.asarray(sp.csr_matrix(adj).sum(axis=1)).flatten()
        return np.argsort(-deg, kind="stable").astype(np.int64)
    raise ValueError(f"unknown reorder method: {method!r}")


def permute_graph(adj: sp.spmatrix, perm: np.ndarray) -> sp.csr_matrix:
    """``P A Pᵀ`` for the node permutation ``perm`` (node ``perm[i]``
    becomes node i)."""
    return sp.csr_matrix(adj)[perm][:, perm].tocsr()


def row_normalize(mat: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1 M`` row normalization; zero rows stay zero."""
    mat = sp.csr_matrix(mat, dtype=np.float64)
    rowsum = np.asarray(mat.sum(axis=1)).flatten()
    with np.errstate(divide="ignore"):
        r_inv = np.power(rowsum, -1.0)
    r_inv[np.isinf(r_inv)] = 0.0
    return sp.diags(r_inv).dot(mat).tocsr()


def row_normalized_adjacency(adj: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1 (A + I)`` — the reference's default low-pass operator."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    return row_normalize(adj + sp.eye(adj.shape[0], format="csr"))


@dataclasses.dataclass
class Operators:
    """The operator bundle handed to every model forward.

    ``x_agg``: the precomputed ``Â X`` of the first-layer input hoist
    (``Â (X W) == (Â X) W`` for variant-0 ACM layers); None when hoisting
    is off.
    """

    adj_low: Union[EllOp, CooOp]   # or a rank's share of a sharded one
    x_agg: Optional[torch.Tensor] = None

    def to(self, device) -> "Operators":
        return Operators(
            adj_low=self.adj_low.to(device),
            x_agg=None if self.x_agg is None else self.x_agg.to(device),
        )


def precompute_operators(
    adj: sp.spmatrix,
    *,
    normalization: str = "row",
    fmt: str = "auto",
    spmm_dtype: torch.dtype = torch.float32,
) -> Operators:
    """Build the host operator bundle from a raw adjacency matrix.

    ``fmt``: "ell", "coo", or "auto" (dense at or below
    ``DEFAULT_DENSE_THRESHOLD`` nodes, else ELL, as in the JAX package).
    The COO operator ignores ``spmm_dtype``.  The dense format, symmetric
    normalization, k-hop operators and the raw structure operator are
    queued in ROADMAP.md.
    """
    if normalization != "row":
        raise NotImplementedError(f"normalization {normalization!r} is not "
                                  "ported yet")
    n = adj.shape[0]
    if fmt == "auto":
        fmt = "dense" if n <= DEFAULT_DENSE_THRESHOLD else "ell"
    if fmt == "dense":
        raise NotImplementedError(
            f"the dense operator format is not ported yet (fmt='auto' picks "
            f"it for graphs of at most {DEFAULT_DENSE_THRESHOLD} nodes; this "
            f"one has {n}): pass operator_format='ell' or 'coo'")
    adj_low = row_normalized_adjacency(sp.csr_matrix(adj))
    if fmt == "ell":
        return Operators(adj_low=make_ell_op(adj_low, gather_dtype=spmm_dtype))
    if fmt == "coo":
        return Operators(adj_low=make_coo_op(adj_low))
    raise ValueError(f"unknown operator format: {fmt!r}")
