"""Host-side graph representation and operator precompute.

Counterpart of ``acmgnn_tpu/ops/graph.py``: the low-pass operator (row
``Â = D^-1 (A + I)`` or symmetric ``D^-1/2 (A + I) D^-1/2``, optionally
``Â^k`` for acmsgc/sgc), the raw adjacency of the structure channel, and
the 1-hop high-pass base under a k-hop low-pass are built on the host
with scipy and shipped to the device once, as a dense ``[N, N]`` matrix
(``DenseOp``: one cuBLAS GEMM a product), row-gather ELL (``EllOp``, K1)
or COO (``CooOp``, K5).  The high-pass ``I - Â`` never exists as data; it
is computed as ``z - Â z`` (``spmm_high``/``spmm_multi``).
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
# dense (the JAX package's threshold).
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


def sym_normalized_adjacency(adj: sp.spmatrix) -> sp.csr_matrix:
    """``D^-1/2 (A + I) D^-1/2``, the symmetric option (zero-degree rows
    count as degree 1).  Its values are not row-uniform, so its ELL
    halves carry values (``ops/ell.py``); it is its own transpose."""
    adj = sp.coo_matrix(adj, dtype=np.float64)
    adj = (adj + sp.eye(adj.shape[0])).tocsr()
    rowsum = np.asarray(adj.sum(axis=1)).flatten()
    rowsum = np.where(rowsum == 0, 1.0, rowsum)
    d_inv_sqrt = np.power(rowsum, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return d.dot(adj).dot(d).tocsr()


def high_pass(adj_low: sp.spmatrix) -> sp.csr_matrix:
    """``I - Â`` as a matrix (the products never build it: ``z - Âz``)."""
    return (sp.eye(adj_low.shape[0], format="csr")
            - sp.csr_matrix(adj_low)).tocsr()


# k_hop densifies at or below this many nodes (the JAX package's rule)
K_HOP_DENSE_THRESHOLD = 20000


def k_hop(adj_low: sp.spmatrix, hops: int,
          dense_threshold: int = K_HOP_DENSE_THRESHOLD) -> sp.spmatrix:
    """``Â^k`` for the acmsgc/sgc multi-hop operator: chained dense
    products at or below ``dense_threshold`` nodes, sparse ones above."""
    if hops <= 1:
        return adj_low
    if adj_low.shape[0] <= dense_threshold:
        dense = np.asarray(sp.csr_matrix(adj_low).todense())
        out = dense
        for _ in range(hops - 1):
            out = out @ dense
        return sp.csr_matrix(out)
    out = base = sp.csr_matrix(adj_low)
    for _ in range(hops - 1):
        out = out @ base
    return out


@dataclasses.dataclass
class DenseOp:
    """The operator as a dense f32 ``[N, N]`` matrix: a product is one
    GEMM (``ops/spmm.py``), its transpose ``matᵀ @ g``."""

    mat: torch.Tensor
    num_nodes: int

    @property
    def nnz(self) -> int:
        return self.num_nodes * self.num_nodes

    def to(self, device) -> "DenseOp":
        return dataclasses.replace(self, mat=self.mat.to(device))


def make_dense_op(mat: sp.spmatrix) -> DenseOp:
    dense = np.asarray(sp.csr_matrix(mat).todense(), dtype=np.float32)
    return DenseOp(mat=torch.from_numpy(dense), num_nodes=mat.shape[0])


SparseOp = Union[DenseOp, EllOp, CooOp]


@dataclasses.dataclass
class Operators:
    """The operator bundle handed to every model forward.

    ``adj_unnorm``: the raw adjacency of the acmgcnp/pp structure channel
    (None without ``structure_info``).  ``adj_hp_base``: the 1-hop
    operator of the high-pass channel when the low-pass is ``Â^k``
    (acmsgc, ``hops > 1``; the reference builds ``I - Â`` before the
    power).  ``x_agg``: the precomputed ``Â X`` of the first-layer input
    hoist (``Â (X W) == (Â X) W`` for variant-0 ACM layers); None when
    hoisting is off.
    """

    adj_low: SparseOp              # or a rank's share of a sharded one
    adj_unnorm: Optional[SparseOp] = None
    adj_hp_base: Optional[SparseOp] = None
    x_agg: Optional[torch.Tensor] = None

    @property
    def adj_hp(self) -> SparseOp:
        return self.adj_low if self.adj_hp_base is None else self.adj_hp_base

    @property
    def num_nodes(self) -> int:
        return self.adj_low.num_nodes

    def to(self, device) -> "Operators":
        def move(t):
            return None if t is None else t.to(device)

        return Operators(adj_low=self.adj_low.to(device),
                         adj_unnorm=move(self.adj_unnorm),
                         adj_hp_base=move(self.adj_hp_base),
                         x_agg=move(self.x_agg))


def precompute_operators(
    adj: sp.spmatrix,
    *,
    normalization: str = "row",
    hops: int = 1,
    structure_info: bool = False,
    fmt: str = "auto",
    spmm_dtype: torch.dtype = torch.float32,
) -> Operators:
    """Build the host operator bundle from a raw adjacency matrix.

    ``normalization``: "row" (``D^-1 (A + I)``) or "sym"; ``hops > 1``
    makes the low-pass ``Â^k`` and keeps ``Â`` as the high-pass base;
    ``structure_info`` also builds the raw adjacency, in the same format
    and gather dtype.  ``fmt``: "dense", "ell", "coo", or "auto" (dense at
    or below ``DEFAULT_DENSE_THRESHOLD`` nodes, else ELL).  The dense and
    COO operators ignore ``spmm_dtype`` (f32, as in the JAX package).
    """
    adj = sp.csr_matrix(adj)
    n = adj.shape[0]
    if normalization == "row":
        adj_low = row_normalized_adjacency(adj)
    elif normalization == "sym":
        adj_low = sym_normalized_adjacency(adj)
    else:
        raise ValueError(f"unknown normalization: {normalization!r}")
    adj_hp_base = None
    if hops > 1:
        adj_hp_base = adj_low
        adj_low = k_hop(adj_low, hops)
    if fmt == "auto":
        fmt = "dense" if n <= DEFAULT_DENSE_THRESHOLD else "ell"
    if fmt == "dense":
        make = make_dense_op
    elif fmt == "ell":
        def make(mat):
            return make_ell_op(mat, gather_dtype=spmm_dtype)
    elif fmt == "coo":
        make = make_coo_op
    else:
        raise ValueError(f"unknown operator format: {fmt!r}")
    return Operators(
        adj_low=make(adj_low),
        adj_unnorm=make(adj) if structure_info else None,
        adj_hp_base=None if adj_hp_base is None else make(adj_hp_base),
    )
