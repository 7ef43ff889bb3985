"""Planetoid (cora / citeseer / pubmed) loader from the ``ind.*`` pickle
files — counterpart of ``acmgnn_tpu/data/planetoid.py``.

Stacks ``allx`` + ``tx``, reorders the test rows into graph order, builds
the undirected binary adjacency from the dict-of-lists graph and argmaxes
the one-hot labels; citeseer's isolated test nodes get zero rows.  The
files are read from ``data/ind.<name>.<part>`` under a data root.
"""

from __future__ import annotations

import pickle

import numpy as np
import scipy.sparse as sp

from acmgnn_tpu_torch.data.paths import find_data_file


def _load_pickle(name: str, part: str):
    path = find_data_file("data", f"ind.{name}.{part}")
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _parse_index_file(name: str) -> np.ndarray:
    path = find_data_file("data", f"ind.{name}.test.index")
    with open(path) as f:
        return np.array([int(line.strip()) for line in f], dtype=np.int64)


def _adj_from_graph_dict(graph: dict, num_nodes: int) -> sp.csr_matrix:
    """Undirected binary adjacency from {node: [neighbors]}.

    Matches ``nx.adjacency_matrix(nx.from_dict_of_lists(graph))``: every
    listed pair becomes a symmetric 1, self-listings become diagonal 1s.
    """
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    data = np.ones_like(rows, dtype=np.float64)
    a = sp.coo_matrix((data, (rows, cols)), shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float64)
    return a.tocsr()


def planetoid_standard_split(name: str, num_nodes: int):
    """The classic semi-supervised split encoded by the ind.* files:
    train = the ``x`` rows, val = the next 500, test = the test index file
    (PyG's Planetoid 'public' split)."""
    x = _load_pickle(name, "x")
    y = _load_pickle(name, "y")
    test_idx = _parse_index_file(name)
    train_idx = np.arange(x.shape[0])
    val_idx = np.arange(x.shape[0], x.shape[0] + 500)
    return {
        "train": train_idx,
        "valid": val_idx,
        "test": np.sort(test_idx),
    }


def load_planetoid(name: str):
    """Returns ``(adj, features, labels)`` as (csr, float32 [N,F], int32 [N])."""
    x, y, tx, ty, allx, ally, graph = (
        _load_pickle(name, p) for p in ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    )
    test_idx_reorder = _parse_index_file(name)
    test_idx_range = np.sort(test_idx_reorder)

    if name == "citeseer":
        # Isolated test nodes: extend tx/ty with zero rows at the gaps.
        full = range(test_idx_reorder.min(), test_idx_reorder.max() + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - test_idx_reorder.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - test_idx_reorder.min(), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    features = np.asarray(features.todense(), dtype=np.float32)

    labels_onehot = np.vstack((ally, ty))
    labels_onehot[test_idx_reorder, :] = labels_onehot[test_idx_range, :]
    labels = np.argmax(labels_onehot, axis=-1).astype(np.int32)

    adj = _adj_from_graph_dict(graph, features.shape[0])
    return adj, features, labels
