"""Synthetic graphs with the shapes of the benchmarked datasets.

- ``twitch_gamers_scale_graph``: the headline training graph, the same
  generator as ``bench.py``'s ``_twitch_gamers_scale_graph``: N=168,114
  nodes, 6,797,557 random directed pairs symmetrized and deduplicated
  without self-loops, 7 normal features and 2 balanced classes, all drawn
  from one ``numpy`` generator in the same order; with ``graph=``
  "powerlaw" or "banded", bench.py's two other stand-ins of the same
  N and E (``_powerlaw_scale_graph``, ``_banded_scale_graph``).
- ``linkx_scale_graph``: the LINKX-scale stand-ins of ``bench.py``'s
  ``bench_epoch_linkx_scale``, a Chung-Lu graph whose top expected degree
  is ``max_deg`` (``chung_lu_edges``), with normal features and uniform
  labels: bench.py's four rows (penn94, arxiv_year, genius, penn94_pp).
- ``wiki_scale_graph``: the wiki-shaped stand-in of ``bench.py``'s wiki
  scenarios (N=1,925,342, 6,500,000 Chung-Lu pairs with a top expected
  degree of 30,000, F=600, C=5), its features drawn on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.ops.native import build_sym_adjacency

TWITCH_NODES = 168_114
TWITCH_PAIRS = 6_797_557
TWITCH_GRAPHS = ("uniform", "powerlaw", "banded")
POWERLAW_ALPHA = 0.6      # powerlaw: expected degree of rank i ~ (i+1)^-0.6
BANDED_HALFWIDTH = 64     # banded: neighbours within +-64 ids
# bench.py's wiki scenarios (bench.py:733-775, :965-982)
WIKI_SCALE = dict(n=1_925_342, e=6_500_000, f=600, c=5, max_deg=30_000)

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
    seed: int = 0, n: int = TWITCH_NODES, pairs: int = TWITCH_PAIRS,
    graph: str = "uniform",
):
    """``(adj, features, labels)``; ``n``/``pairs`` shrink it for tests.

    ``graph`` picks how the ``pairs`` endpoint pairs are drawn, each as
    bench.py draws it (``bench.py:30-86``), from one generator: "uniform"
    (both endpoints uniform), "powerlaw" (both endpoints by
    ``numpy``'s ``choice`` with probability ~ (rank+1)^-``POWERLAW_ALPHA``:
    hub rows of tens of thousands of entries at full size) or "banded"
    (a uniform source and a destination within ``BANDED_HALFWIDTH`` ids
    of it, clipped to the graph: a column-local graph)."""
    rng = np.random.default_rng(seed)
    if graph == "uniform":
        src = rng.integers(0, n, size=pairs, dtype=np.int64)
        dst = rng.integers(0, n, size=pairs, dtype=np.int64)
    elif graph == "powerlaw":
        w = (1.0 + np.arange(n)) ** -POWERLAW_ALPHA
        p = w / w.sum()
        src = rng.choice(n, size=pairs, p=p).astype(np.int64)
        dst = rng.choice(n, size=pairs, p=p).astype(np.int64)
    elif graph == "banded":
        src = rng.integers(0, n, size=pairs, dtype=np.int64)
        off = rng.integers(-BANDED_HALFWIDTH, BANDED_HALFWIDTH + 1,
                           size=pairs)
        dst = np.clip(src + off, 0, n - 1).astype(np.int64)
    else:
        raise ValueError(f"graph must be one of {TWITCH_GRAPHS}, got "
                         f"{graph!r}")
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


def wiki_scale_graph(n: int = WIKI_SCALE["n"], e: int = WIKI_SCALE["e"],
                     f: int = WIKI_SCALE["f"], c: int = WIKI_SCALE["c"],
                     max_deg: int = WIKI_SCALE["max_deg"], device=None):
    """``(adj, features, labels)`` of the wiki-shaped stand-in: bench.py's
    graph (``_wiki_scale_graph``: ``n`` nodes, ``e`` Chung-Lu endpoint
    pairs from ``chung_lu_edges(..., seed=0)`` with a top expected degree
    of ``max_deg``, symmetrized without self-loops).  The ``f`` features
    are drawn on ``device`` (the card unless asked otherwise) by
    ``torch.randn`` from a generator seeded 0 and copied to the host, not
    by numpy as bench.py draws them: the same law, and 1.2e9 numpy draws
    take the host tens of seconds.  The labels are ``c`` uniform classes
    from ``numpy.random.default_rng(1)`` (bench.py buckets a view-count
    draw into quantiles instead).  Smaller arguments shrink it for
    tests."""
    dev = resolve_device(device)
    src, dst = chung_lu_edges(n, e, max_deg, seed=0)
    adj = build_sym_adjacency(src, dst, n, drop_self_loops=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    features = torch.randn(n, f, generator=gen, device=dev).cpu().numpy()
    labels = np.random.default_rng(1).integers(0, c, size=n).astype(
        np.int32)
    return adj, features, labels
