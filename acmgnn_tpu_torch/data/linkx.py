"""LINKX large-scale dataset loaders (Penn94 / fb100, arXiv-year, genius,
twitch-gamers, pokec, snap-patents, deezer-europe, yelp-chi, twitch-e,
wiki, ogbn-*) — counterpart of ``acmgnn_tpu/data/linkx.py``.

numpy, scipy and the ``csv`` / ``json`` modules only (no pandas, no
scikit-learn), with the same arrays as the JAX package's loaders.  No
file is fetched: every loader reads local files, laid out under
``<root>/large_scale_data/`` for a root of ``data.paths.data_roots()``:

- ``facebook100/<name>.mat``       (fb100 / Penn94)
- ``deezer-europe.mat``, ``genius.mat``, ``pokec.mat``,
  ``snap_patents.mat``, ``YelpChi.mat``
- ``pokec/soc-pokec-{profiles,relationships}.txt`` (raw SNAP dump)
- ``twitch/<lang>/musae_<lang>_{target.csv,edges.csv,features.json}``
- ``twitch-gamer_feat.csv``, ``twitch-gamer_edges.csv``
- ``wiki_features2M.pt``, ``wiki_edges2M.pt``, ``wiki_views2M.pt``
- ``ogbn_arxiv.npz`` or ``ogbn_arxiv/raw/*.csv.gz`` (+ ``split/time``),
  ``ogbn_proteins.npz``, ``ogbn_products.npz``
"""

from __future__ import annotations

import csv
import json

import numpy as np
import scipy.io
import scipy.sparse as sp

from acmgnn_tpu_torch.data.paths import find_data_file
from acmgnn_tpu_torch.data.splits import load_linkx_split_masks
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.ops.native import build_sym_adjacency

LARGE = "large_scale_data"


def even_quantile_labels(vals: np.ndarray, nclasses: int) -> np.ndarray:
    """Quantile-bucket continuous values into class labels."""
    label = -1 * np.ones(vals.shape[0], dtype=np.int64)
    lower = -np.inf
    for k in range(nclasses - 1):
        upper = np.nanquantile(vals, (k + 1) / nclasses)
        inds = (vals >= lower) * (vals < upper)
        label[inds] = k
        lower = upper
    label[vals >= lower] = nclasses - 1
    return label


def _edges_to_adj(edge_index: np.ndarray, num_nodes: int,
                  symmetrize: bool = True) -> sp.csr_matrix:
    """Directed edge list -> binary adjacency: symmetrized through the
    native graph prep (self-loops kept), or as given for the directed
    variants (``symmetrize=False``)."""
    row, col = edge_index[0], edge_index[1]
    if symmetrize:
        return build_sym_adjacency(row, col, num_nodes)
    a = sp.coo_matrix((np.ones(row.shape[0], np.float64), (row, col)),
                      shape=(num_nodes, num_nodes))
    return (a > 0).astype(np.float64).tocsr()


def _onehot_columns(feature_vals: np.ndarray) -> np.ndarray:
    """Each column one-hot over its sorted distinct values (scikit-learn's
    ``label_binarize``): one 0/1 column for exactly 2 values (1 at the
    larger), one zero column for a single value."""
    cols = []
    for c in range(feature_vals.shape[1]):
        col = feature_vals[:, c]
        classes = np.unique(col)
        if classes.shape[0] == 1:
            cols.append(np.zeros((col.shape[0], 1)))
        elif classes.shape[0] == 2:
            cols.append((col == classes[1])[:, None])
        else:
            cols.append(col[:, None] == classes[None, :])
    return np.hstack(cols).astype(np.float32)


def load_fb100(sub_dataset: str = "Penn94") -> GraphData:
    mat = scipy.io.loadmat(
        find_data_file(LARGE, "facebook100", f"{sub_dataset}.mat"))
    a = sp.csr_matrix(mat["A"]).astype(np.float64)
    metadata = mat["local_info"].astype(np.int64)
    label = metadata[:, 1] - 1  # gender; -1 = unlabeled
    feature_vals = np.hstack(
        (np.expand_dims(metadata[:, 0], 1), metadata[:, 2:]))
    features = _onehot_columns(feature_vals)
    return GraphData(name=sub_dataset, adj=a, features=features,
                     labels=label.astype(np.int32))


def load_deezer_europe() -> GraphData:
    mat = scipy.io.loadmat(find_data_file(LARGE, "deezer-europe.mat"))
    a = sp.csr_matrix(mat["A"]).astype(np.float64)
    features = np.asarray(mat["features"].todense(), dtype=np.float32)
    labels = np.asarray(mat["label"]).squeeze().astype(np.int32)
    return GraphData(name="deezer-europe", adj=a, features=features,
                     labels=labels)


def load_genius(directed: bool = False) -> GraphData:
    mat = scipy.io.loadmat(find_data_file(LARGE, "genius.mat"))
    edge_index = np.asarray(mat["edge_index"], dtype=np.int64)
    features = np.asarray(mat["node_feat"], dtype=np.float32)
    labels = np.asarray(mat["label"]).squeeze().astype(np.int32)
    adj = _edges_to_adj(edge_index, labels.shape[0], symmetrize=not directed)
    return GraphData(name="genius", adj=adj, features=features, labels=labels)


def parse_pokec_raw(profiles_path, relationships_path):
    """The raw SNAP soc-pokec dump -> ``(edge_index, labels)``: gender
    (profile column 3; ``null`` -> -1) is the label, the 1-based
    relationship pairs a directed edge list (read in one pass: the file
    has ~30M rows)."""
    labels = []
    with open(profiles_path, encoding="utf-8", errors="replace") as f:
        for line in f:
            g = line.split("\t", 4)[3]
            labels.append(int(g) if g != "null" else -1)
    labels = np.asarray(labels, dtype=np.int32)
    with open(relationships_path, "rb") as f:
        toks = f.read().split()
    pairs = np.array(toks, dtype=np.int64).reshape(-1, 2)
    edge_index = pairs.T - 1  # SNAP ids are 1-based
    return edge_index, labels


def load_pokec(directed: bool = False) -> GraphData:
    """pokec (1.6M nodes): the LINKX ``pokec.mat`` (node features
    included), else the raw SNAP dump through ``parse_pokec_raw`` with one
    constant feature column (the raw dump has no feature matrix)."""
    try:
        mat_path = find_data_file(LARGE, "pokec.mat")
    except FileNotFoundError:
        profiles = find_data_file(LARGE, "pokec", "soc-pokec-profiles.txt")
        rels = find_data_file(LARGE, "pokec", "soc-pokec-relationships.txt")
        edge_index, labels = parse_pokec_raw(profiles, rels)
        num_nodes = int(labels.shape[0])
        features = np.ones((num_nodes, 1), dtype=np.float32)
        adj = _edges_to_adj(edge_index, num_nodes, symmetrize=not directed)
        return GraphData(name="pokec", adj=adj, features=features,
                         labels=labels)
    mat = scipy.io.loadmat(mat_path)
    edge_index = np.asarray(mat["edge_index"], dtype=np.int64)
    features = np.asarray(mat["node_feat"], dtype=np.float32)
    num_nodes = int(np.asarray(mat["num_nodes"]).ravel()[0])
    labels = np.asarray(mat["label"]).flatten().astype(np.int32)
    adj = _edges_to_adj(edge_index, num_nodes, symmetrize=not directed)
    return GraphData(name="pokec", adj=adj, features=features, labels=labels)


def load_snap_patents(nclass: int = 5, directed: bool = False) -> GraphData:
    """snap-patents: labels are the grant years' quantiles; usually
    trained ``directed`` (temporally directed)."""
    mat = scipy.io.loadmat(find_data_file(LARGE, "snap_patents.mat"))
    edge_index = np.asarray(mat["edge_index"], dtype=np.int64)
    features = np.asarray(mat["node_feat"].todense(), dtype=np.float32)
    num_nodes = int(np.asarray(mat["num_nodes"]).ravel()[0])
    years = np.asarray(mat["years"]).flatten()
    labels = even_quantile_labels(years, nclass).astype(np.int32)
    adj = _edges_to_adj(edge_index, num_nodes, symmetrize=not directed)
    return GraphData(name="snap-patents", adj=adj, features=features,
                     labels=labels)


def load_yelpchi() -> GraphData:
    mat = scipy.io.loadmat(find_data_file(LARGE, "YelpChi.mat"))
    a = sp.csr_matrix(mat["homo"]).astype(np.float64)
    features = np.asarray(mat["features"].todense(), dtype=np.float32)
    labels = np.asarray(mat["label"]).flatten().astype(np.int32)
    return GraphData(name="yelp-chi", adj=a, features=features, labels=labels)


def load_twitch_explicit(lang: str = "DE") -> GraphData:
    """twitch-e language graphs (musae csv/json files)."""
    if lang not in ("DE", "ENGB", "ES", "FR", "PTBR", "RU", "TW"):
        raise ValueError(f"unknown twitch-e language {lang!r}")
    base = find_data_file(LARGE, "twitch", lang,
                          f"musae_{lang}_target.csv").parent
    label, node_ids, uniq = [], [], set()
    with open(base / f"musae_{lang}_target.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            node_id = int(row[5])
            if node_id not in uniq:
                uniq.add(node_id)
                label.append(int(row[2] == "True"))
                node_ids.append(node_id)
    label = np.array(label)
    node_ids = np.array(node_ids, dtype=np.int64)
    src, targ = [], []
    with open(base / f"musae_{lang}_edges.csv") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            src.append(int(row[0]))
            targ.append(int(row[1]))
    with open(base / f"musae_{lang}_features.json") as f:
        j = json.load(f)
    n = label.shape[0]
    adj = sp.csr_matrix(
        (np.ones(len(src)), (np.array(src), np.array(targ))), shape=(n, n)
    ).astype(np.float64)
    features = np.zeros((n, 3170), dtype=np.float32)
    for node, feats in j.items():
        if int(node) >= n:
            continue
        features[int(node), np.array(feats, dtype=int)] = 1.0
    features = features[:, features.sum(axis=0) != 0]
    inv = {nid: idx for idx, nid in enumerate(node_ids)}
    reorder = np.array([inv[i] for i in range(n)], dtype=np.int64)
    labels = label[reorder].astype(np.int32)
    return GraphData(name=f"twitch-e-{lang}", adj=adj, features=features,
                     labels=labels)


def _read_csv_columns(path) -> dict:
    """A csv file with a header -> ``{column: [str, ...]}`` in file
    order."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {name: [] for name in header}
        for row in reader:
            for name, v in zip(header, row):
                cols[name].append(v)
    return cols


def load_twitch_gamer(task: str = "mature", normalize: bool = True
                      ) -> GraphData:
    """twitch-gamers (168k nodes, 6.8M edges).  Feature columns in file
    order without ``numeric_id`` and ``task``: dates as ``YYYYMMDD``
    integers, ``language`` as codes in order of first appearance, then
    a z-score per column (constant columns stay zero)."""
    feat_path = find_data_file(LARGE, "twitch-gamer_feat.csv")
    edge_path = find_data_file(LARGE, "twitch-gamer_edges.csv")
    edge_index = np.loadtxt(edge_path, delimiter=",", skiprows=1,
                            dtype=np.int64, ndmin=2).T
    cols = _read_csv_columns(feat_path)
    num_nodes = len(cols["numeric_id"])
    del cols["numeric_id"]
    for date in ("created_at", "updated_at"):
        cols[date] = [int(v.replace("-", "")) for v in cols[date]]
    codes: dict = {}
    cols["language"] = [codes.setdefault(v, len(codes))
                        for v in cols["language"]]
    labels = np.asarray(cols.pop(task), dtype=np.float64).astype(np.int32)
    # column-major, as a data frame's array is: the z-score's sums run
    # down contiguous columns, in the reference's summation order
    features = np.stack([np.asarray(v, dtype=np.float64)
                         for v in cols.values()]).T.astype(np.float32)
    if normalize:
        features = features - features.mean(axis=0, keepdims=True)
        std = features.std(axis=0, keepdims=True)
        std[std == 0] = 1.0  # constant columns stay zero, not inf
        features = features / std
    adj = _edges_to_adj(edge_index, num_nodes)
    return GraphData(name="twitch-gamer", adj=adj, features=features,
                     labels=labels)


def load_wiki() -> GraphData:
    """wiki 2M: torch ``.pt`` tensors."""
    import torch

    def load(name):
        return torch.load(find_data_file(LARGE, name),
                          map_location="cpu").numpy()

    features = load("wiki_features2M.pt").astype(np.float32)
    edges = load("wiki_edges2M.pt").T.astype(np.int64)
    labels = load("wiki_views2M.pt").astype(np.int32)
    adj = _edges_to_adj(edges, labels.shape[0])
    return GraphData(name="wiki", adj=adj, features=features, labels=labels)


def _load_ogb_arxiv_raw():
    """ogbn-arxiv's arrays from a preconverted ``ogbn_arxiv.npz``
    (edge_index / node_feat / node_year), else from the extracted raw
    layout ``ogbn_arxiv/raw/{edge,node-feat,node_year}.csv.gz``."""
    try:
        npz = find_data_file(LARGE, "ogbn_arxiv.npz")
        with np.load(npz) as f:
            return (f["edge_index"].astype(np.int64),
                    f["node_feat"].astype(np.float32),
                    f["node_year"].flatten())
    except FileNotFoundError:
        pass
    base = find_data_file(LARGE, "ogbn_arxiv", "raw", "edge.csv.gz").parent
    edge_index = np.loadtxt(base / "edge.csv.gz", delimiter=",",
                            dtype=np.int64).T
    node_feat = np.loadtxt(base / "node-feat.csv.gz", delimiter=",",
                           dtype=np.float32)
    node_year = np.loadtxt(base / "node_year.csv.gz", delimiter=",",
                           dtype=np.int64).flatten()
    return edge_index, node_feat, node_year


def load_arxiv_year(nclass: int = 5, directed: bool = False) -> GraphData:
    edge_index, node_feat, node_year = _load_ogb_arxiv_raw()
    labels = even_quantile_labels(node_year.astype(np.float64),
                                  nclass).astype(np.int32)
    adj = _edges_to_adj(edge_index, node_feat.shape[0],
                        symmetrize=not directed)
    return GraphData(name="arxiv-year", adj=adj, features=node_feat,
                     labels=labels)


def load_ogbn_proteins() -> GraphData:
    """ogbn-proteins from ``ogbn_proteins.npz`` (edge_index [2,E],
    edge_feat [E,8], labels [N,112]): node features are the mean of the
    incident edges' features; labels are multilabel (BCE + ROC-AUC)."""
    with np.load(find_data_file(LARGE, "ogbn_proteins.npz")) as f:
        edge_index = f["edge_index"].astype(np.int64)
        edge_feat = f["edge_feat"].astype(np.float32)
        labels = f["labels"].astype(np.float32)
    n = labels.shape[0]
    src = np.concatenate([edge_index[0], edge_index[1]])
    ef = np.concatenate([edge_feat, edge_feat], axis=0)
    sums = np.zeros((n, edge_feat.shape[1]), np.float64)
    np.add.at(sums, src, ef)
    counts = np.bincount(src, minlength=n)[:, None].astype(np.float64)
    node_feat = (sums / np.maximum(counts, 1.0)).astype(np.float32)
    adj = _edges_to_adj(edge_index, n)
    return GraphData(name="ogbn-proteins", adj=adj, features=node_feat,
                     labels=labels)


def _maybe_split(npz) -> list | None:
    """The official OGB split indices, if the npz carries them."""
    keys = ("train_idx", "valid_idx", "test_idx")
    if all(k in npz.files for k in keys):
        return [{
            "train": npz["train_idx"].flatten().astype(np.int64),
            "valid": npz["valid_idx"].flatten().astype(np.int64),
            "test": npz["test_idx"].flatten().astype(np.int64),
        }]
    return None


def _load_csv_gz_split(base) -> list | None:
    """An OGB raw split dir (``split/{time,sales_ranking}/{train,valid,
    test}.csv.gz``)."""
    for sub in ("time", "sales_ranking"):
        d = base / "split" / sub
        if (d / "train.csv.gz").exists():
            return [{k: np.loadtxt(d / f"{k}.csv.gz",
                                   dtype=np.int64).flatten()
                     for k in ("train", "valid", "test")}]
    return None


def load_ogbn_arxiv(directed: bool = False) -> GraphData:
    """ogbn-arxiv proper: 40-class subject labels and the official time
    split, from ``ogbn_arxiv.npz`` (``edge_index / node_feat / node_label
    [/ train_idx / valid_idx / test_idx]``) or the raw csv.gz layout."""
    splits = None
    try:
        with np.load(find_data_file(LARGE, "ogbn_arxiv.npz")) as f:
            if "node_label" not in f.files:
                raise FileNotFoundError(
                    "ogbn_arxiv.npz lacks node_label (arxiv-year-only "
                    "conversion); add node_label for ogbn-arxiv proper")
            edge_index = f["edge_index"].astype(np.int64)
            node_feat = f["node_feat"].astype(np.float32)
            labels = f["node_label"].flatten().astype(np.int32)
            splits = _maybe_split(f)
    except FileNotFoundError as npz_err:
        try:
            base = find_data_file(LARGE, "ogbn_arxiv", "raw",
                                  "edge.csv.gz").parent
        except FileNotFoundError:
            raise npz_err
        edge_index = np.loadtxt(base / "edge.csv.gz", delimiter=",",
                                dtype=np.int64).T
        node_feat = np.loadtxt(base / "node-feat.csv.gz", delimiter=",",
                               dtype=np.float32)
        labels = np.loadtxt(base / "node-label.csv.gz",
                            dtype=np.int64).flatten().astype(np.int32)
        splits = _load_csv_gz_split(base.parent)
    adj = _edges_to_adj(edge_index, node_feat.shape[0],
                        symmetrize=not directed)
    return GraphData(name="ogbn-arxiv", adj=adj, features=node_feat,
                     labels=labels, splits=splits)


def load_ogbn_products() -> GraphData:
    """ogbn-products: 47-class labels and the official sales-ranking
    split, from ``ogbn_products.npz``; symmetrized."""
    with np.load(find_data_file(LARGE, "ogbn_products.npz")) as f:
        edge_index = f["edge_index"].astype(np.int64)
        node_feat = f["node_feat"].astype(np.float32)
        labels = f["node_label"].flatten().astype(np.int32)
        splits = _maybe_split(f)
    adj = _edges_to_adj(edge_index, node_feat.shape[0])
    return GraphData(name="ogbn-products", adj=adj, features=node_feat,
                     labels=labels, splits=splits)


_LOADERS = {
    "Penn94": lambda sub, directed: load_fb100("Penn94"),
    "fb100": lambda sub, directed: load_fb100(sub or "Penn94"),
    "deezer-europe": lambda sub, directed: load_deezer_europe(),
    "genius": lambda sub, directed: load_genius(directed),
    "pokec": lambda sub, directed: load_pokec(directed),
    "snap-patents": lambda sub, directed: load_snap_patents(
        directed=directed),
    "yelp-chi": lambda sub, directed: load_yelpchi(),
    "twitch-e": lambda sub, directed: load_twitch_explicit(sub or "DE"),
    "twitch-gamer": lambda sub, directed: load_twitch_gamer(),
    "wiki": lambda sub, directed: load_wiki(),
    "arxiv-year": lambda sub, directed: load_arxiv_year(directed=directed),
    "ogbn-proteins": lambda sub, directed: load_ogbn_proteins(),
    "ogbn-arxiv": lambda sub, directed: load_ogbn_arxiv(directed),
    "ogbn-products": lambda sub, directed: load_ogbn_products(),
}


def load_linkx_dataset(name: str, sub_dataset: str = "",
                       directed: bool = False) -> GraphData:
    """A LINKX dataset by name, with the fixed 50/25/25 split files
    (``ACM-Geometric/splits/<name>-splits.npy``) attached when present."""
    if name not in _LOADERS:
        raise ValueError(
            f"unsupported large-scale dataset {name!r}; supported: "
            f"{sorted(_LOADERS)}")
    data = _LOADERS[name](sub_dataset, directed)
    try:
        data.splits = load_linkx_split_masks(name, sub_dataset)
    except FileNotFoundError:
        pass
    return data
