"""Dataset registry — counterpart of ``acmgnn_tpu/data/registry.py``: one
name-based dispatcher over the Planetoid, Geom-GCN and LINKX loaders, and
the feature preprocessing shared by every loader."""

from __future__ import annotations

import numpy as np

from acmgnn_tpu_torch.data.geomgcn import GEOMGCN_DATASETS, load_geomgcn
from acmgnn_tpu_torch.data.planetoid import load_planetoid
from acmgnn_tpu_torch.ops.graph import GraphData

PLANETOID_DATASETS = ("cora", "citeseer", "pubmed")
LINKX_DATASETS = (
    "Penn94",
    "arxiv-year",
    "genius",
    "twitch-gamer",
    "pokec",
    "snap-patents",
    "deezer-europe",
    "yelp-chi",
    "twitch-e",
    "fb100",
    "ogbn-arxiv",
    "ogbn-products",
    "ogbn-proteins",
    "wiki",
)
DATASETS = PLANETOID_DATASETS + GEOMGCN_DATASETS + LINKX_DATASETS


def row_normalize_features(features: np.ndarray) -> np.ndarray:
    """Row-normalize the feature matrix (zero rows stay zero), the
    reference's default preprocessing unless acmgcnp/pp + structure_info.

    Rows whose sum is near but not exactly zero are divided by it as they
    are, exactly as ``acmgnn_tpu.data.registry.row_normalize_features``
    does (large values on real-valued features are that rule's behaviour).
    """
    rowsum = features.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(rowsum != 0, 1.0 / rowsum, 0.0)
    return (features * inv).astype(np.float32)


def load_dataset(name: str, sub_dataset: str = "",
                 directed: bool = False) -> GraphData:
    """Load any supported dataset into a ``GraphData`` from local files
    (``data.paths``; nothing is fetched).  ``directed`` skips the edge
    symmetrization of the temporally directed LINKX graphs."""
    if name in PLANETOID_DATASETS:
        adj, features, labels = load_planetoid(name)
    elif name in GEOMGCN_DATASETS:
        adj, features, labels = load_geomgcn(name)
    elif name in LINKX_DATASETS:
        from acmgnn_tpu_torch.data import linkx

        return linkx.load_linkx_dataset(name, sub_dataset, directed)
    elif name.startswith("synthetic"):
        raise ValueError(
            "synthetic graphs are loaded via acmgnn_tpu_torch.data.synthetic."
            "load_synthetic(base_dir, graph_type, edge_homo, graph_num, ...)")
    else:
        raise ValueError(f"unknown dataset {name!r}; known: {DATASETS}")
    return GraphData(name=name, adj=adj, features=features, labels=labels)
