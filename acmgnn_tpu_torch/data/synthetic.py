"""Synthetic graph + feature generation over an edge-homophily sweep —
counterpart of ``acmgnn_tpu/data/synthetic.py`` (the same numpy draws and
the same ``.npz`` files):

- ``regular`` graphs: every node gets exactly ``degree_intra`` same-class
  neighbors and ``degree_intra/h - degree_intra`` cross-class neighbors;
- ``random`` graphs: class-block Erdos-Renyi-style edge placement with the
  total intra/inter edge budget chosen to hit target edge homophily ``h``;
- features: per-class sampling (without replacement) from a base dataset's
  rows, or random one-hot-ish noise (N x 1433).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.sparse as sp

from acmgnn_tpu_torch.ops.graph import GraphData

DEFAULT_EDGE_HOMOS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def generate_output_label(num_class: int, node_per_class: int) -> np.ndarray:
    """One-hot [N, C] block labels (class i owns rows i*npc:(i+1)*npc)."""
    labels = np.repeat(np.arange(num_class), node_per_class)
    return np.eye(num_class, dtype=np.float32)[labels]


def generate_regular_graph(
    edge_homo: float,
    num_class: int = 5,
    node_per_class: int = 400,
    degree_intra: int = 2,
    rng=None,
) -> np.ndarray:
    """Directed-regular construction: per node, sample ``degree_intra``
    intra-class and ``round(d/h) - d`` inter-class neighbor slots."""
    rng = np.random.default_rng() if rng is None else rng
    n = num_class * node_per_class
    degree_inter = int(degree_intra / edge_homo - degree_intra)
    adj = np.zeros((n, n), dtype=np.float32)
    for i in range(num_class):
        cls_lo, cls_hi = i * node_per_class, (i + 1) * node_per_class
        cls_nodes = np.arange(cls_lo, cls_hi)
        other_nodes = np.concatenate(
            [np.arange(0, cls_lo), np.arange(cls_hi, n)]
        )
        for j in cls_nodes:
            intra_pool = cls_nodes[cls_nodes != j]
            adj[j, rng.choice(intra_pool, degree_intra, replace=False)] = 1.0
            if degree_inter > 0:
                adj[j, rng.choice(other_nodes, degree_inter, replace=False)] = 1.0
    return adj


def generate_random_graph(
    edge_homo: float,
    num_class: int = 5,
    node_per_class: int = 400,
    degree_intra: int = 2,
    rng=None,
) -> np.ndarray:
    """Random class-block construction with a global intra/inter edge
    budget targeting edge homophily ``h``."""
    rng = np.random.default_rng() if rng is None else rng
    n = num_class * node_per_class
    adj = np.zeros((n, n), dtype=np.float32)
    num_edge_same = degree_intra * node_per_class
    for i in range(num_class):
        lo = i * node_per_class
        # intra-class: symmetric random placement of num_edge_same/2 pairs
        tri_size = node_per_class * (node_per_class - 1) // 2
        upper = np.zeros(tri_size, dtype=np.float32)
        upper[: num_edge_same // 2] = 1.0
        rng.shuffle(upper)
        block = np.zeros((node_per_class, node_per_class), dtype=np.float32)
        block[np.triu_indices(node_per_class, 1)] = upper
        block = block + block.T
        adj[lo : lo + node_per_class, lo : lo + node_per_class] = block

        # inter-class: place the remaining budget toward later classes
        if i != num_class - 1:
            if i == 0:
                n_out = round(num_edge_same * (1 - edge_homo) / edge_homo) + 1
            else:
                existing = adj[lo : lo + node_per_class, 0:lo].sum()
                n_out = (
                    round(num_edge_same * (1 - edge_homo) / edge_homo - existing)
                    + 1
                )
            n_out = max(int(n_out), 0)
            slots = (num_class - 1 - i) * node_per_class**2
            flat = np.zeros(slots, dtype=np.float32)
            flat[: min(n_out, slots)] = 1.0
            rng.shuffle(flat)
            out_block = flat.reshape(
                node_per_class, (num_class - 1 - i) * node_per_class
            )
            adj[lo : lo + node_per_class, (i + 1) * node_per_class :] = out_block
            adj[(i + 1) * node_per_class :, lo : lo + node_per_class] = out_block.T
    return adj


def generate_graphs(
    base_dir: str,
    graph_type: str = "random",
    edge_homos=DEFAULT_EDGE_HOMOS,
    num_graph: int = 10,
    num_class: int = 5,
    node_per_class: int = 400,
    degree_intra: int = 2,
    seed: int = 0,
):
    """Generate + save a sweep of graphs as ``.npz`` (adj/degree/label)."""
    gen = generate_regular_graph if graph_type == "regular" else generate_random_graph
    out_paths = []
    for edge_homo in edge_homos:
        for graph_num in range(num_graph):
            rng = np.random.default_rng(
                seed + graph_num + int(round(edge_homo * 1000)) * 1000
            )
            adj = gen(
                edge_homo,
                num_class=num_class,
                node_per_class=node_per_class,
                degree_intra=degree_intra,
                rng=rng,
            )
            label = generate_output_label(num_class, node_per_class)
            degree = adj.sum(axis=1)
            d = Path(base_dir) / graph_type / f"{edge_homo}"
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"graph_{edge_homo}_{graph_num}.npz"
            adj_sp = sp.csr_matrix(adj)
            np.savez_compressed(
                path,
                adj_data=adj_sp.data,
                adj_indices=adj_sp.indices,
                adj_indptr=adj_sp.indptr,
                adj_shape=adj_sp.shape,
                degree=degree,
                label=label,
            )
            out_paths.append(path)
    return out_paths


def generate_features(
    out_dir: str,
    base_features: np.ndarray | None,
    base_labels: np.ndarray | None,
    num_class: int = 5,
    node_per_class: int = 400,
    num_realizations: int = 10,
    feature_dim: int = 1433,
    seed: int = 0,
):
    """Per-class feature sampling from a base dataset (or random noise)."""
    paths = []
    for r in range(num_realizations):
        rng = np.random.default_rng(seed + r)
        if base_features is None:
            feats = (rng.random((num_class * node_per_class, feature_dim)) < 0.01
                     ).astype(np.float32)
        else:
            rows = []
            for c in range(num_class):
                pool = np.nonzero(base_labels == c)[0]
                replace = pool.shape[0] < node_per_class
                rows.append(rng.choice(pool, node_per_class, replace=replace))
            feats = base_features[np.concatenate(rows)].astype(np.float32)
        d = Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"features_{r}.npz"
        np.savez_compressed(path, features=feats)
        paths.append(path)
    return paths


def load_synthetic(
    base_dir: str,
    graph_type: str,
    edge_homo: float,
    graph_num: int,
    features_path: str | None = None,
) -> GraphData:
    """Load a generated graph (+ optional feature realization).

    The reference loader's cleanup: re-binarize and strip self-loops
    before operator precompute.
    """
    path = (
        Path(base_dir) / graph_type / f"{edge_homo}"
        / f"graph_{edge_homo}_{graph_num}.npz"
    )
    with np.load(path) as f:
        adj = sp.csr_matrix(
            (f["adj_data"], f["adj_indices"], f["adj_indptr"]),
            shape=tuple(f["adj_shape"]),
        )
        label_onehot = f["label"]
    adj = (adj > 0).astype(np.float64)
    adj.setdiag(0)
    adj.eliminate_zeros()
    labels = np.argmax(label_onehot, axis=1).astype(np.int32)
    if features_path is not None:
        with np.load(features_path) as f:
            features = f["features"]
    else:
        features = np.eye(adj.shape[0], dtype=np.float32)
    return GraphData(
        name=f"synthetic-{graph_type}-{edge_homo}-{graph_num}",
        adj=adj.tocsr(),
        features=features,
        labels=labels,
    )
