"""Synthetic graphs with the shapes of the benchmarked datasets.

- ``twitch_gamers_scale_graph``: the headline training graph, the same
  generator as ``bench.py``'s ``_twitch_gamers_scale_graph``: N=168,114
  nodes, 6,797,557 random directed pairs symmetrized and deduplicated
  without self-loops, 7 normal features and 2 balanced classes, all drawn
  from one ``numpy`` generator in the same order.
- ``linkx_scale_graph``: the LINKX-scale stand-ins of ``bench.py``'s
  ``bench_epoch_linkx_scale``, a Chung-Lu graph whose top expected degree
  is ``max_deg`` (``chung_lu_edges``), with normal features and uniform
  labels: bench.py's four rows (penn94, arxiv_year, genius, penn94_pp).
"""

from __future__ import annotations

import numpy as np

from acmgnn_tpu_torch.ops.native import build_sym_adjacency

TWITCH_NODES = 168_114
TWITCH_PAIRS = 6_797_557

# Shape of each LINKX-scale stand-in (bench.py's LINKX_SCALE rows): nodes,
# sampled endpoint pairs, features, classes and the top node's expected
# degree.
LINKX_SCALE = {
    "penn94": dict(n=41_554, e=1_362_229, f=4814, c=2, max_deg=4_500),
    "arxiv_year": dict(n=169_343, e=1_166_243, f=128, c=5, max_deg=13_000),
    "genius": dict(n=421_961, e=984_979, f=12, c=2, max_deg=10_000),
    # the ACM-GCN++ row (Table 16): penn94's graph, with the structure
    # channel in its configuration
    "penn94_pp": dict(n=41_554, e=1_362_229, f=4814, c=2, max_deg=4_500),
}


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


def chung_lu_edges(n: int, e: int, max_deg: int, seed: int = 0):
    """``e`` endpoint pairs drawn Chung-Lu style, with the tail exponent
    solved by bisection so the top node's expected degree is ``max_deg``
    (expected degree of rank i is ~2e·w_i/W for w_i = (i+1)^-alpha);
    ``max_deg=0`` draws uniform pairs.  Same draws as ``bench.py``'s
    ``_chung_lu_edges``."""
    rng = np.random.default_rng(seed)
    if not max_deg:
        return (rng.integers(0, n, size=e, dtype=np.int64),
                rng.integers(0, n, size=e, dtype=np.int64))
    ranks = 1.0 + np.arange(n)

    def top_expected_degree(alpha):
        w = ranks ** -alpha
        return 2.0 * e * w[0] / w.sum()

    lo, hi = 0.0, 3.0
    for _ in range(60):   # the top degree grows monotonically in alpha
        mid = (lo + hi) / 2
        if top_expected_degree(mid) < max_deg:
            lo = mid
        else:
            hi = mid
    w = ranks ** -((lo + hi) / 2)
    p = w / w.sum()
    src = rng.choice(n, size=e, p=p).astype(np.int64)
    dst = rng.choice(n, size=e, p=p).astype(np.int64)
    return src, dst


def linkx_scale_graph(name: str, seed: int = 0, n: int | None = None,
                      e: int | None = None, max_deg: int | None = None):
    """``(adj, features, labels)`` of a LINKX-scale stand-in, drawn in
    ``bench.py``'s order (edges from their own generator, then features and
    labels from a second one of the same seed); ``n``/``e``/``max_deg``
    shrink it for tests."""
    spec = LINKX_SCALE[name]
    n = spec["n"] if n is None else n
    e = spec["e"] if e is None else e
    max_deg = spec["max_deg"] if max_deg is None else max_deg
    rng = np.random.default_rng(seed)
    src, dst = chung_lu_edges(n, e, max_deg, seed=seed)
    adj = build_sym_adjacency(src, dst, n, drop_self_loops=True)
    features = rng.normal(size=(n, spec["f"])).astype(np.float32)
    labels = rng.integers(0, spec["c"], size=n).astype(np.int32)
    return adj, features, labels
