"""Host-side graph representation and operator precompute.

Counterpart of ``acmgnn_tpu/ops/graph.py``: the row-normalized low-pass
``Â = D^-1 (A + I)`` is built on the host with scipy and shipped to the
device once.  The high-pass ``I - Â`` never exists as data; it is computed
as ``z - Â z`` (``spmm_high``/``spmm_multi``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.ops.ell import EllOp, make_ell_op


@dataclasses.dataclass
class GraphData:
    """A loaded graph dataset, host-side (NumPy / SciPy)."""

    name: str
    adj: sp.spmatrix                 # [N, N] raw (unnormalized) adjacency
    features: np.ndarray             # [N, F] float32
    labels: np.ndarray               # [N] int labels

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1


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

    adj_low: EllOp
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
    fmt: str = "ell",
    spmm_dtype: torch.dtype = torch.float32,
) -> Operators:
    """Build the host operator bundle from a raw adjacency matrix.

    Only the row-normalized ELL operator is ported so far; the dense and
    COO formats, symmetric normalization, k-hop operators and the raw
    structure operator are queued in ROADMAP.md.
    """
    if normalization != "row":
        raise NotImplementedError(f"normalization {normalization!r} is not "
                                  "ported yet")
    if fmt != "ell":
        raise NotImplementedError(f"operator format {fmt!r} is not ported "
                                  "yet")
    adj_low = row_normalized_adjacency(sp.csr_matrix(adj))
    return Operators(adj_low=make_ell_op(adj_low, gather_dtype=spmm_dtype))
