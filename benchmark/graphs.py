"""Frozen copies of the graph draws of ``bench.py`` (``bench.py:30-86``,
``_chung_lu_edges`` at ``bench.py:568``), as
``acmgnn_tpu_torch/data/synthetic_scale.py`` ports them.  A later change
to the program cannot move these inputs.

Each draw returns the directed endpoint pairs ``(src, dst)`` as int64
numpy arrays; ``symmetrize`` makes the undirected binary adjacency the
program is given (symmetrized, deduplicated, no self-loops, sorted
columns).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

def twitch_pairs(n: int, pairs: int, graph: str, seed: int,
                 alpha: float = 0.6, halfwidth: int = 64):
    """``pairs`` endpoint pairs on ``n`` nodes, drawn from one numpy
    generator as bench.py draws them: "uniform" (both endpoints uniform),
    "powerlaw" (both endpoints with probability ~ (rank+1)^-``alpha``) or
    "banded" (a uniform source and a destination within ``halfwidth`` ids,
    clipped to the graph)."""
    rng = np.random.default_rng(seed)
    if graph == "uniform":
        src = rng.integers(0, n, size=pairs, dtype=np.int64)
        dst = rng.integers(0, n, size=pairs, dtype=np.int64)
    elif graph == "powerlaw":
        w = (1.0 + np.arange(n)) ** -alpha
        p = w / w.sum()
        src = rng.choice(n, size=pairs, p=p).astype(np.int64)
        dst = rng.choice(n, size=pairs, p=p).astype(np.int64)
    elif graph == "banded":
        src = rng.integers(0, n, size=pairs, dtype=np.int64)
        off = rng.integers(-halfwidth, halfwidth + 1, size=pairs)
        dst = np.clip(src + off, 0, n - 1).astype(np.int64)
    else:
        raise ValueError(f"no twitch-shaped graph {graph!r}")
    return src, dst


def chung_lu_pairs(n: int, pairs: int, max_deg: int, seed: int):
    """``pairs`` endpoint pairs drawn Chung-Lu style, the tail exponent
    solved by bisection so that the top node's expected degree is
    ``max_deg`` (expected degree of rank i ~ 2·pairs·w_i/W for w_i =
    (i+1)^-alpha); ``max_deg=0`` draws uniform pairs."""
    rng = np.random.default_rng(seed)
    if not max_deg:
        return (rng.integers(0, n, size=pairs, dtype=np.int64),
                rng.integers(0, n, size=pairs, dtype=np.int64))
    ranks = 1.0 + np.arange(n)

    def top_expected_degree(a):
        w = ranks ** -a
        return 2.0 * pairs * w[0] / w.sum()

    lo, hi = 0.0, 3.0
    for _ in range(60):   # the top degree grows monotonically in alpha
        mid = (lo + hi) / 2
        if top_expected_degree(mid) < max_deg:
            lo = mid
        else:
            hi = mid
    w = ranks ** -((lo + hi) / 2)
    p = w / w.sum()
    src = rng.choice(n, size=pairs, p=p).astype(np.int64)
    dst = rng.choice(n, size=pairs, p=p).astype(np.int64)
    return src, dst


def draw_pairs(graph: str, n: int, pairs: int, seed: int, **params):
    """The pairs of the traffic's ``graph`` law."""
    if graph == "chunglu":
        return chung_lu_pairs(n, pairs, int(params["max_deg"]), seed)
    return twitch_pairs(n, pairs, graph, seed,
                        **{k: v for k, v in params.items()
                           if k in ("alpha", "halfwidth")})


def symmetrize(src, dst, n: int, device) -> sp.csr_matrix:
    """The undirected binary adjacency of the pairs (both directions,
    deduplicated, self-loops dropped, columns sorted), formed on
    ``device`` and returned as a host CSR matrix of float64 ones."""
    s = torch.from_numpy(np.concatenate([src, dst])).to(device)
    d = torch.from_numpy(np.concatenate([dst, src])).to(device)
    keep = s != d
    key = torch.unique(s[keep] * n + d[keep])     # sorted: row-major
    rows, cols = key // n, key % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    indices = cols.to(torch.int32).cpu().numpy()
    return sp.csr_matrix((np.ones(indices.shape[0]), indices,
                          indptr.cpu().numpy()), shape=(n, n))
