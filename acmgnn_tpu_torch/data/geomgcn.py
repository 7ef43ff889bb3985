"""Geom-GCN txt dataset loader (texas / wisconsin / cornell / film /
squirrel / chameleon) — counterpart of ``acmgnn_tpu/data/geomgcn.py``.

Two TSV files per dataset under ``new_data/<name>/``
(``out1_graph_edges.txt``, an edge list with a header, and
``out1_node_feature_label.txt`` with comma-separated features), the
undirected binary adjacency over sorted node ids; ``film`` features are
932-dim multi-hot index lists.  Without the feature file, the musae raw
layout (``<name>_features.json`` + ``<name>_target.csv``).
"""

from __future__ import annotations

import json

import numpy as np
import scipy.sparse as sp

from acmgnn_tpu_torch.data.paths import find_data_file

GEOMGCN_DATASETS = ("texas", "wisconsin", "cornell", "film", "squirrel", "chameleon")


def _load_musae(name: str, edge_path):
    """musae wiki raw layout: multi-hot feature index lists + processed
    5-class targets (even-quantile traffic bins, already balanced)."""
    feat_json = find_data_file("new_data", name, f"{name}_features.json")
    target_path = find_data_file("new_data", name, f"{name}_target.csv")
    with open(feat_json) as f:
        feats = json.load(f)
    n = len(feats)
    dim = max(max(v) for v in feats.values() if v) + 1
    features = np.zeros((n, dim), dtype=np.float32)
    for node, idxs in feats.items():
        features[int(node), np.asarray(idxs, dtype=np.int64)] = 1.0
    labels = np.full(n, -1, dtype=np.int32)
    with open(target_path) as f:
        f.readline()
        for line in f:
            nid_s, t_s = line.rstrip().split("\t")
            labels[int(nid_s)] = int(t_s)
    rows, cols = [], []
    with open(edge_path) as f:
        f.readline()
        for line in f:
            u_s, v_s = line.rstrip().split("\t")
            rows.append(int(u_s))
            cols.append(int(v_s))
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    a = sp.coo_matrix(
        (np.ones_like(rows, dtype=np.float64), (rows, cols)), shape=(n, n)
    )
    adj = ((a + a.T) > 0).astype(np.float64).tocsr()
    return adj, features, labels


def load_geomgcn(name: str):
    """Returns ``(adj, features, labels)`` as (csr, float32 [N,F], int32 [N]).

    Falls back to the musae raw layout (``{name}_features.json`` multi-hot
    index lists + ``{name}_target.csv`` preprocessed 5-class labels +
    the Geom-GCN edge file) when the feature file is absent (squirrel is
    distributed in the musae form).
    """
    edge_path = find_data_file("new_data", name, "out1_graph_edges.txt")
    try:
        feat_path = find_data_file(
            "new_data", name, "out1_node_feature_label.txt"
        )
    except FileNotFoundError:
        return _load_musae(name, edge_path)

    features_dict: dict[int, np.ndarray] = {}
    labels_dict: dict[int, int] = {}
    with open(feat_path) as f:
        f.readline()  # header
        for line in f:
            nid_s, feat_s, label_s = line.rstrip().split("\t")
            nid = int(nid_s)
            if nid in features_dict:
                raise ValueError(f"duplicate node {nid} in {name}")
            if name == "film":
                vec = np.zeros(932, dtype=np.float32)
                vec[np.array(feat_s.split(","), dtype=np.int64)] = 1.0
            else:
                vec = np.array(feat_s.split(","), dtype=np.float32)
            features_dict[nid] = vec
            labels_dict[nid] = int(label_s)

    node_ids = sorted(features_dict)
    remap = {nid: i for i, nid in enumerate(node_ids)}
    n = len(node_ids)

    rows, cols = [], []
    with open(edge_path) as f:
        f.readline()  # header
        for line in f:
            u_s, v_s = line.rstrip().split("\t")
            rows.append(remap[int(u_s)])
            cols.append(remap[int(v_s)])
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    a = sp.coo_matrix(
        (np.ones_like(rows, dtype=np.float64), (rows, cols)), shape=(n, n)
    )
    adj = ((a + a.T) > 0).astype(np.float64).tocsr()

    features = np.stack([features_dict[nid] for nid in node_ids])
    labels = np.array([labels_dict[nid] for nid in node_ids], dtype=np.int32)
    return adj, features, labels
