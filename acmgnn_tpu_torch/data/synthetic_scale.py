"""Synthetic graph with twitch-gamers' shape (the headline training graph).

Same generator as ``bench.py``'s ``_twitch_gamers_scale_graph``: N=168,114
nodes, 6,797,557 random directed pairs symmetrized and deduplicated
without self-loops, 7 normal features and 2 balanced classes, all drawn
from one ``numpy`` generator in the same order.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

TWITCH_NODES = 168_114
TWITCH_PAIRS = 6_797_557


def build_sym_adjacency(
    src: np.ndarray, dst: np.ndarray, n: int, drop_self_loops: bool = False
) -> sp.csr_matrix:
    """Directed edge list -> undirected binary CSR adjacency (symmetrize +
    dedup); the scipy path of ``acmgnn_tpu.ops.native.build_sym_adjacency``,
    which gives the same CSR as its native path."""
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    a = sp.coo_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))
    out = ((a + a.T) > 0).astype(np.float64).tocsr()
    if drop_self_loops:
        out.setdiag(0)
        out.eliminate_zeros()
    return out


def twitch_gamers_scale_graph(
    seed: int = 0, n: int = TWITCH_NODES, pairs: int = TWITCH_PAIRS
):
    """``(adj, features, labels)``; ``n``/``pairs`` shrink it for tests."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=pairs, dtype=np.int64)
    dst = rng.integers(0, n, size=pairs, dtype=np.int64)
    adj = build_sym_adjacency(src, dst, n, drop_self_loops=True)
    features = rng.normal(size=(n, 7)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.int32)
    return adj, features, labels
