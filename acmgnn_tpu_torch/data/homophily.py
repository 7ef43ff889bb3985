"""Homophily metrics, including the paper's aggregation homophily —
counterpart of ``acmgnn_tpu/data/homophily.py``.

Edge, node, class, compatibility-matrix and aggregation homophily, in
numpy (f64).  All take a dense or scipy adjacency plus integer labels.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _to_dense_no_selfloops(adj) -> np.ndarray:
    a = np.asarray(sp.csr_matrix(adj).todense(), dtype=np.float64)
    a = (a > 0).astype(np.float64)
    np.fill_diagonal(a, 0.0)
    return a


def edge_homophily(adj, labels) -> float:
    """Fraction of (directed) edges whose endpoints share a class."""
    a = _to_dense_no_selfloops(adj)
    labels = np.asarray(labels).reshape(-1)
    same = (labels[:, None] == labels[None, :]).astype(np.float64)
    return float((same * a).sum() / a.sum())


def node_homophily(adj, labels) -> float:
    """Mean over non-isolated nodes of the same-class neighbor fraction."""
    a = _to_dense_no_selfloops(adj)
    labels = np.asarray(labels).reshape(-1)
    deg = a.sum(axis=1)
    same = (labels[:, None] == labels[None, :]).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = (same * a).sum(axis=1) / deg
    return float(frac[deg > 0].mean())


def compat_matrix(adj, labels) -> np.ndarray:
    """H[i, j]: fraction of class-i nodes' edge endpoints in class j."""
    a = _to_dense_no_selfloops(adj)
    labels = np.asarray(labels).reshape(-1)
    c = int(labels.max()) + 1
    h = np.zeros((c, c))
    src, dst = np.nonzero(a)
    np.add.at(h, (labels[src], labels[dst]), 1.0)
    rowsum = h.sum(axis=1, keepdims=True)
    rowsum[rowsum == 0] = 1.0
    return h / rowsum


def class_homophily(adj, labels) -> float:
    """LINKX's \\hat{h}: mean positive excess of diagonal compatibility
    over class prior, normalized by C-1."""
    a = _to_dense_no_selfloops(adj)
    # isolated nodes get a self-loop (the reference's rule)
    iso = a.sum(axis=1) == 0
    a[iso, iso] = 1.0
    labels = np.asarray(labels).reshape(-1)
    c = int(labels.max()) + 1
    h = compat_matrix(a, labels)
    counts = np.bincount(labels[labels >= 0], minlength=c)
    proportions = counts / counts.sum()
    val = 0.0
    for k in range(c):
        add = max(h[k, k] - proportions[k], 0.0)
        if not np.isnan(add):
            val += add
    return float(val / (c - 1))


def aggregation_homophily(features, adj, labels) -> float:
    """The paper's new metric: similarity-based.  For each node, the mean
    post-aggregation inner product with same-class nodes must dominate
    every other class's mean for the node to count as homophilic.

    The reference materializes the [N, N] similarity ``(AX)(AX)^T`` and
    then averages columns per class; since the class average commutes
    with the inner product, ``mean_{j: y_j = c} <ax_i, ax_j> =
    <ax_i, mean-class-row>``, so we compute the [N, C] score directly —
    same value, no N x N densification, safe on LINKX-scale graphs.
    (The reference signature also takes ``modified=True`` but never reads
    it — dead parameter, dropped here rather than given invented
    semantics.)
    """
    a = sp.csr_matrix(adj).astype(np.float64)
    x = np.asarray(features, dtype=np.float64)
    labels = np.asarray(labels).reshape(-1)
    ax = a @ x  # [N, F], sparse aggregation
    c = int(labels.max()) + 1
    class_means = np.zeros((c, ax.shape[1]))
    for i in range(c):
        class_means[i] = ax[labels == i].mean(axis=0)
    weight = ax @ class_means.T  # [N, C]
    return float((np.argmax(weight, axis=1) == labels).mean())
