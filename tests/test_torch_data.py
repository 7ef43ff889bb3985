"""The port's data layer against acmgnn_tpu's, on files each test writes in
the loader's own layout under ``tmp_path`` (``ACMGNN_DATA_PATH``): every
loader (adjacency CSR, features, labels and attached splits exactly
equal, dtypes included), the split helpers under the same ``rng``, the
homophily metrics (f64, equal), the synthetic generators (equal files for
one seed) and the host graph prep (the compiled library against JAX's
and against its own scipy path)."""

from __future__ import annotations

import gzip
import json
import pickle

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from acmgnn_tpu.data import homophily as jhom
from acmgnn_tpu.data import paths as jpaths
from acmgnn_tpu.data import splits as jsplits
from acmgnn_tpu.data import synthetic as jsyn
from acmgnn_tpu.data.registry import load_dataset as jload
from acmgnn_tpu.ops import native as jnative
from acmgnn_tpu_torch.data import homophily as hom
from acmgnn_tpu_torch.data import paths
from acmgnn_tpu_torch.data import splits
from acmgnn_tpu_torch.data import synthetic as syn
from acmgnn_tpu_torch.data.linkx import _onehot_columns
from acmgnn_tpu_torch.data.registry import load_dataset
from acmgnn_tpu_torch.ops import native


@pytest.fixture()
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("ACMGNN_DATA_PATH", str(tmp_path))
    (tmp_path / "large_scale_data").mkdir()
    return tmp_path


def _edges(n, e, rng, self_loops=True):
    ei = np.vstack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if self_loops:
        ei[1, :3] = ei[0, :3]
    return ei.astype(np.int64)


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.dtype == b.data.dtype


def _array_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def assert_same_graph(j, p):
    assert j.name == p.name
    _csr_equal(j.adj, p.adj)
    _array_equal(j.features, p.features)
    _array_equal(j.labels, p.labels)
    assert (j.splits is None) == (p.splits is None)
    if j.splits is not None:
        assert len(j.splits) == len(p.splits)
        for sj, sp_ in zip(j.splits, p.splits):
            assert set(sj) == set(sp_)
            for k in sj:
                _array_equal(sj[k], sp_[k])


# ---------------------------------------------------------------------------
# Writers, one per on-disk layout
# ---------------------------------------------------------------------------


def _planetoid(root, name, rng):
    """ind.<name>.* pickles: 25 allx rows (x the first 10), the test rows
    (citeseer: ids with two gaps, its isolated test nodes)."""
    f, c, n_allx = 10, 3, 25
    test_ids = np.arange(n_allx, n_allx + 17)
    if name == "citeseer":
        test_ids = np.delete(test_ids, [5, 10])
    n = n_allx + 17

    def onehot(k):
        return np.eye(c)[rng.integers(0, c, k)]

    def feats(k):
        return sp.csr_matrix((rng.random((k, f)) < 0.3).astype(np.float32))

    allx = feats(n_allx)
    parts = {"x": allx[:10], "y": onehot(n_allx)[:10], "allx": allx,
             "ally": onehot(n_allx), "tx": feats(len(test_ids)),
             "ty": onehot(len(test_ids)),
             "graph": {i: [int(v) for v in rng.integers(0, n, 3)]
                       for i in range(n)}}
    (root / "data").mkdir(exist_ok=True)
    for part, obj in parts.items():
        with open(root / "data" / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh)
    (root / "data" / f"ind.{name}.test.index").write_text(
        "\n".join(str(i) for i in rng.permutation(test_ids)) + "\n")
    return name, ""


def _geomgcn(root, name, rng, musae=False):
    """new_data/<name>/out1_* (node ids out of order, sparse ids), or the
    musae layout (features json + target csv) beside the edge file."""
    n = 30
    d = root / "new_data" / name
    d.mkdir(parents=True)
    ids = rng.permutation(n) * 3 + 5 if not musae else np.arange(n)
    with open(d / "out1_graph_edges.txt", "w") as fh:
        fh.write("node_id\tnode_id\n")
        for u, v in _edges(n, 80, rng).T:
            fh.write(f"{ids[u]}\t{ids[v]}\n")
    if musae:
        json.dump({str(i): [int(k) for k in rng.integers(0, 40, 4)]
                   for i in range(n)}, open(d / f"{name}_features.json", "w"))
        with open(d / f"{name}_target.csv", "w") as fh:
            fh.write("id\ttarget\n")
            for i in range(n):
                fh.write(f"{i}\t{rng.integers(0, 5)}\n")
        return name, ""
    with open(d / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        for i in rng.permutation(n):
            if name == "film":
                feat = ",".join(str(k) for k in rng.integers(0, 932, 5))
            else:
                feat = ",".join(str(k) for k in rng.integers(0, 2, 12))
            fh.write(f"{ids[i]}\t{feat}\t{rng.integers(0, 5)}\n")
    return name, ""


def _fb100(root, rng, classes):
    """facebook100/<sub>.mat; ``classes``: the values of the attribute
    columns (2: single 0/1 columns, >2: one-hot)."""
    n = 40
    a = sp.random(n, n, density=0.1, random_state=int(rng.integers(100)))
    a = ((a + a.T) > 0).astype(np.float64)
    meta = rng.integers(0, classes, size=(n, 7))
    meta[:, 1] = rng.integers(0, 3, n)       # gender; 0 = unlabeled
    meta[:, 4] = 7                           # a constant column
    (root / "large_scale_data" / "facebook100").mkdir()
    scipy.io.savemat(root / "large_scale_data" / "facebook100" / "Amherst41.mat",
                     {"A": a, "local_info": meta})
    return "fb100", "Amherst41"


def _genius(root, rng, directed=False):
    n = 50
    scipy.io.savemat(root / "large_scale_data" / "genius.mat", {
        "edge_index": _edges(n, 200, rng),
        "node_feat": rng.normal(size=(n, 12)).astype(np.float32),
        "label": rng.integers(0, 2, n)})
    (root / "ACM-Geometric" / "splits").mkdir(parents=True)
    lab = np.zeros(n)
    split_list = [dict(zip(("train", "valid", "test"),
                           splits.rand_train_test_idx(lab, rng=rng)))
                  for _ in range(2)]
    np.save(root / "ACM-Geometric" / "splits" / "genius-splits.npy",
            np.array(split_list, dtype=object), allow_pickle=True)
    return "genius", "", directed


def _snap_patents(root, rng):
    n = 60
    scipy.io.savemat(root / "large_scale_data" / "snap_patents.mat", {
        "edge_index": _edges(n, 150, rng),
        "node_feat": sp.csr_matrix(rng.normal(size=(n, 6))),
        "num_nodes": n, "years": rng.integers(1970, 2010, n)})
    return "snap-patents", "", True


def _pokec_raw(root, rng):
    d = root / "large_scale_data" / "pokec"
    d.mkdir()
    n = 20
    with open(d / "soc-pokec-profiles.txt", "w") as fh:
        for i in range(n):
            g = rng.choice(["0", "1", "null"])
            fh.write(f"{i + 1}\t1\t50\t{g}\tregion\tmore\n")
    with open(d / "soc-pokec-relationships.txt", "w") as fh:
        for u, v in _edges(n, 60, rng).T + 1:
            fh.write(f"{u}\t{v}\n")
    return "pokec", ""


def _pokec_mat(root, rng):
    n = 30
    scipy.io.savemat(root / "large_scale_data" / "pokec.mat", {
        "edge_index": _edges(n, 90, rng),
        "node_feat": rng.normal(size=(n, 4)).astype(np.float32),
        "num_nodes": n, "label": rng.integers(-1, 2, n)})
    return "pokec", ""


def _yelpchi(root, rng):
    n = 40
    scipy.io.savemat(root / "large_scale_data" / "YelpChi.mat", {
        "homo": sp.random(n, n, density=0.2, random_state=1),
        "features": sp.csr_matrix(rng.normal(size=(n, 5))),
        "label": rng.integers(0, 2, n)})
    return "yelp-chi", ""


def _deezer(root, rng):
    n = 40
    a = sp.random(n, n, density=0.1, random_state=2)
    scipy.io.savemat(root / "large_scale_data" / "deezer-europe.mat", {
        "A": ((a + a.T) > 0).astype(np.float64),
        "features": sp.csr_matrix((rng.random((n, 9)) < 0.3) * 1.0),
        "label": rng.integers(0, 2, n)})
    return "deezer-europe", ""


def _twitch_e(root, rng):
    n = 25
    d = root / "large_scale_data" / "twitch" / "PTBR"
    d.mkdir(parents=True)
    new_ids = rng.permutation(n)
    with open(d / "musae_PTBR_target.csv", "w") as fh:
        fh.write("id,days,mature,views,partner,new_id\n")
        for i in range(n):
            fh.write(f"{i},100,{rng.choice(['True', 'False'])},10,False,"
                     f"{new_ids[i]}\n")
    with open(d / "musae_PTBR_edges.csv", "w") as fh:
        fh.write("from,to\n")
        for u, v in _edges(n, 60, rng).T:
            fh.write(f"{u},{v}\n")
    json.dump({str(i): [int(k) for k in rng.integers(0, 3170, 4)]
               for i in range(n + 2)},
              open(d / "musae_PTBR_features.json", "w"))
    return "twitch-e", "PTBR"


def _twitch_gamer(root, rng):
    """twitch-gamer csv files: dates, a language column whose codes follow
    first appearance (not sorted order), a constant column."""
    n = 30
    with open(root / "large_scale_data" / "twitch-gamer_edges.csv",
              "w") as fh:
        fh.write("numeric_id_1,numeric_id_2\n")
        for u, v in _edges(n, 100, rng).T:
            fh.write(f"{u},{v}\n")
    with open(root / "large_scale_data" / "twitch-gamer_feat.csv",
              "w") as fh:
        fh.write("views,mature,life_time,created_at,updated_at,numeric_id,"
                 "dead_account,language,affiliate\n")
        langs = ["FR", "EN", "DE", "OTHER"]
        for i in range(n):
            fh.write(f"{rng.integers(0, 10**6)},{rng.integers(0, 2)},"
                     f"{rng.integers(0, 3000)},"
                     f"20{rng.integers(10, 20)}-0{rng.integers(1, 9)}-1"
                     f"{rng.integers(0, 9)},2021-10-0{rng.integers(1, 9)},"
                     f"{i},0,{langs[rng.integers(0, 4)]},"
                     f"{rng.integers(0, 2)}\n")
    return "twitch-gamer", ""


def _arxiv_npz(root, rng, label=False, split=False):
    n = 70
    arrs = dict(edge_index=_edges(n, 250, rng),
                node_feat=rng.normal(size=(n, 16)).astype(np.float32),
                node_year=rng.integers(1990, 2020, n))
    if label:
        arrs["node_label"] = rng.integers(0, 40, n)
    if split:
        perm = rng.permutation(n)
        arrs.update(train_idx=perm[:40], valid_idx=perm[40:55],
                    test_idx=perm[55:])
    np.savez(root / "large_scale_data" / "ogbn_arxiv.npz", **arrs)


def _gz(path, rows, fmt):
    with gzip.open(path, "wt") as fh:
        for r in rows:
            fh.write(fmt(r) + "\n")


def _arxiv_raw(root, rng, split=True):
    n = 50
    base = root / "large_scale_data" / "ogbn_arxiv"
    (base / "raw").mkdir(parents=True)
    _gz(base / "raw" / "edge.csv.gz", _edges(n, 120, rng).T,
        lambda r: f"{r[0]},{r[1]}")
    _gz(base / "raw" / "node-feat.csv.gz",
        rng.normal(size=(n, 6)).astype(np.float32),
        lambda r: ",".join(repr(float(v)) for v in r))
    _gz(base / "raw" / "node_year.csv.gz", rng.integers(1990, 2020, n),
        str)
    _gz(base / "raw" / "node-label.csv.gz", rng.integers(0, 40, n), str)
    if split:
        (base / "split" / "time").mkdir(parents=True)
        perm = rng.permutation(n)
        for k, idx in (("train", perm[:30]), ("valid", perm[30:40]),
                       ("test", perm[40:])):
            _gz(base / "split" / "time" / f"{k}.csv.gz", idx, str)


def _proteins(root, rng):
    n, e = 40, 150
    np.savez(root / "large_scale_data" / "ogbn_proteins.npz",
             edge_index=_edges(n, e, rng),
             edge_feat=rng.random((e, 8)).astype(np.float32),
             labels=(rng.random((n, 112)) < 0.1).astype(np.float32))
    return "ogbn-proteins", ""


def _products(root, rng):
    n = 60
    perm = rng.permutation(n)
    np.savez(root / "large_scale_data" / "ogbn_products.npz",
             edge_index=_edges(n, 200, rng),
             node_feat=rng.normal(size=(n, 12)).astype(np.float32),
             node_label=rng.integers(0, 47, n), train_idx=perm[:30],
             valid_idx=perm[30:45], test_idx=perm[45:])
    return "ogbn-products", ""


def _wiki(root, rng):
    n = 40
    torch.save(torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)),
               root / "large_scale_data" / "wiki_features2M.pt")
    torch.save(torch.from_numpy(_edges(n, 100, rng).T.copy()),
               root / "large_scale_data" / "wiki_edges2M.pt")
    torch.save(torch.from_numpy(rng.integers(0, 5, n)),
               root / "large_scale_data" / "wiki_views2M.pt")
    return "wiki", ""


LOADER_CASES = {
    "cora": lambda r, g: _planetoid(r, "cora", g),
    "citeseer": lambda r, g: _planetoid(r, "citeseer", g),
    "texas": lambda r, g: _geomgcn(r, "texas", g),
    "film": lambda r, g: _geomgcn(r, "film", g),
    "squirrel_musae": lambda r, g: _geomgcn(r, "squirrel", g, musae=True),
    "fb100_2class": lambda r, g: _fb100(r, g, 2),
    "fb100_multiclass": lambda r, g: _fb100(r, g, 5),
    "genius": lambda r, g: _genius(r, g),
    "genius_directed": lambda r, g: _genius(r, g, directed=True),
    "snap_patents": _snap_patents,
    "pokec_raw": _pokec_raw,
    "pokec_mat": _pokec_mat,
    "yelp_chi": _yelpchi,
    "deezer": _deezer,
    "twitch_e": _twitch_e,
    "twitch_gamer": _twitch_gamer,
    "arxiv_year_npz": lambda r, g: (_arxiv_npz(r, g), ("arxiv-year", ""))[1],
    "arxiv_year_raw": lambda r, g: (_arxiv_raw(r, g, split=False),
                                    ("arxiv-year", ""))[1],
    "ogbn_arxiv_split": lambda r, g: (_arxiv_npz(r, g, True, True),
                                      ("ogbn-arxiv", ""))[1],
    "ogbn_arxiv_raw_split": lambda r, g: (_arxiv_raw(r, g),
                                          ("ogbn-arxiv", ""))[1],
    "ogbn_proteins": _proteins,
    "ogbn_products": _products,
    "wiki": _wiki,
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_matches_jax(root, case):
    """Both packages' ``load_dataset`` on the same files: equal CSR,
    features, labels and attached splits."""
    rng = np.random.default_rng(sorted(LOADER_CASES).index(case))
    args = LOADER_CASES[case](root, rng)
    name, sub = args[:2]
    directed = args[2] if len(args) > 2 else False
    j = jload(name, sub, directed=directed)
    p = load_dataset(name, sub, directed=directed)
    assert_same_graph(j, p)
    if case == "genius":
        assert p.splits is not None and len(p.splits) == 2
        assert abs(p.adj - p.adj.T).nnz == 0
        assert p.adj.diagonal().sum() > 0      # self-loops are kept
    if case == "genius_directed":
        assert abs(p.adj - p.adj.T).nnz > 0


@pytest.mark.parametrize("ncls", (1, 2, 3, 6))
def test_onehot_columns_is_label_binarize(ncls):
    """scikit-learn's ``label_binarize`` per column, with the column's
    sorted values as classes: one zero column for a single value, one 0/1
    column (1 at the larger value) for two, else one-hot."""
    from sklearn.preprocessing import label_binarize

    rng = np.random.default_rng(ncls)
    vals = rng.choice(np.array([-3, 0, 4, 9, 11, 20])[:ncls], size=(30, 2))
    vals[:ncls, :] = np.array([-3, 0, 4, 9, 11, 20])[:ncls, None]
    want = np.hstack([label_binarize(vals[:, c], classes=np.unique(vals[:, c]))
                      for c in range(2)]).astype(np.float32)
    _array_equal(_onehot_columns(vals), want)


def test_unknown_dataset_and_missing_file(root):
    for fn in (jload, load_dataset):
        with pytest.raises(ValueError, match="unknown dataset"):
            fn("nope")
    with pytest.raises(FileNotFoundError) as je:
        jload("genius")
    with pytest.raises(FileNotFoundError) as pe:
        load_dataset("genius")
    assert str(je.value) == str(pe.value)


def test_data_roots(monkeypatch, tmp_path):
    """``ACMGNN_DATA_PATH`` roots as JAX's; ``ACMGNN_DATA_HOME`` as the
    first default root (JAX's default list is fixed at its import)."""
    monkeypatch.setenv("ACMGNN_DATA_PATH", f"{tmp_path}/a::{tmp_path}/b")
    assert paths.data_roots() == jpaths.data_roots()
    monkeypatch.delenv("ACMGNN_DATA_PATH")
    monkeypatch.setenv("ACMGNN_DATA_HOME", str(tmp_path / "home"))
    assert paths.data_roots() == [tmp_path / "home"]
    monkeypatch.delenv("ACMGNN_DATA_HOME")
    assert paths.data_roots()[0] == jpaths._DEFAULT_ROOTS[0]


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------


def test_fixed_split_masks_match_jax(root):
    rng = np.random.default_rng(0)
    d = root / "ACM-Pytorch" / "splits"
    d.mkdir(parents=True)
    for i in range(2):
        np.savez(d / f"texas_split_0.6_0.2_{i}.npz",
                 **{k: (rng.random(30) < 0.4).astype(np.uint8)
                    for k in ("train_mask", "val_mask", "test_mask")})
        for a, b in zip(jsplits.load_fixed_split_masks("texas", i),
                        splits.load_fixed_split_masks("texas", i)):
            _array_equal(a, b)


@pytest.mark.parametrize("ignore_negative", (True, False))
def test_rand_train_test_idx_matches_jax(ignore_negative):
    labels = np.random.default_rng(1).integers(-1, 3, 101)
    for seed in range(3):
        got = splits.rand_train_test_idx(labels, 0.6, 0.2, ignore_negative,
                                         rng=np.random.default_rng(seed))
        want = jsplits.rand_train_test_idx(labels, 0.6, 0.2, ignore_negative,
                                           rng=np.random.default_rng(seed))
        for a, b in zip(got, want):
            _array_equal(a, b)


def test_disassortative_splits_match_jax():
    labels = np.random.default_rng(2).integers(0, 5, 97)
    for seed in range(3):
        for a, b in zip(
                splits.random_disassortative_splits(
                    labels, 5, rng=np.random.default_rng(seed)),
                jsplits.random_disassortative_splits(
                    labels, 5, rng=np.random.default_rng(seed))):
            _array_equal(a, b)


def test_linkx_split_masks_match_jax(root):
    rng = np.random.default_rng(3)
    d = root / "ACM-Geometric" / "splits"
    d.mkdir(parents=True)
    lst = [dict(zip(("train", "valid", "test"),
                    splits.rand_train_test_idx(np.zeros(40), rng=rng)))
           for _ in range(3)]
    np.save(d / "twitch-e-DE-splits.npy", np.array(lst, dtype=object),
            allow_pickle=True)
    got = splits.load_linkx_split_masks("twitch-e", "DE")
    want = jsplits.load_linkx_split_masks("twitch-e", "DE")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("train", "valid", "test"):
            _array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# Homophily metrics
# ---------------------------------------------------------------------------


def _homophily_graph(seed):
    rng = np.random.default_rng(seed)
    n = 60
    a = sp.random(n, n, density=0.08, random_state=seed)
    a = ((a + a.T) > 0).astype(np.float64).tolil()
    a[4, :] = 0
    a[:, 4] = 0                    # an isolated node
    a.setdiag(1.0)                 # self-loops, which the metrics drop
    labels = rng.integers(0, 4, n).astype(np.int32)
    feats = rng.random((n, 7)).astype(np.float32)
    return a.tocsr(), feats, labels


@pytest.mark.parametrize("metric", ("edge_homophily", "node_homophily",
                                    "class_homophily", "compat_matrix",
                                    "aggregation_homophily"))
@pytest.mark.parametrize("seed", (0, 1))
def test_homophily_matches_jax(metric, seed):
    adj, feats, labels = _homophily_graph(seed)
    args = (feats, adj, labels) if metric == "aggregation_homophily" \
        else (adj, labels)
    got, want = getattr(hom, metric)(*args), getattr(jhom, metric)(*args)
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------


def _npz_equal(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert set(fa.files) == set(fb.files)
        for k in fa.files:
            _array_equal(fa[k], fb[k])


@pytest.mark.parametrize("graph_type", ("regular", "random"))
def test_generate_graphs_matches_jax(tmp_path, graph_type):
    kw = dict(graph_type=graph_type, edge_homos=(0.2, 0.7), num_graph=2,
              num_class=3, node_per_class=20, degree_intra=2, seed=5)
    got = syn.generate_graphs(str(tmp_path / "port"), **kw)
    want = jsyn.generate_graphs(str(tmp_path / "jax"), **kw)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        _npz_equal(a, b)
    feats = tmp_path / "f.npz"
    np.savez(feats, features=np.random.default_rng(0).random(
        (60, 5)).astype(np.float32))
    for fp in (None, str(feats)):
        assert_same_graph(
            jsyn.load_synthetic(str(tmp_path / "jax"), graph_type, 0.7, 1,
                                features_path=fp),
            syn.load_synthetic(str(tmp_path / "port"), graph_type, 0.7, 1,
                               features_path=fp))


@pytest.mark.parametrize("base", ("dataset", "random"))
def test_generate_features_matches_jax(tmp_path, base):
    rng = np.random.default_rng(6)
    feats = labels = None
    if base == "dataset":
        feats = rng.random((50, 9)).astype(np.float32)
        labels = rng.integers(0, 3, 50)
    kw = dict(num_class=3, node_per_class=20, num_realizations=2,
              feature_dim=33, seed=4)
    got = syn.generate_features(str(tmp_path / "port"), feats, labels, **kw)
    want = jsyn.generate_features(str(tmp_path / "jax"), feats, labels, **kw)
    for a, b in zip(got, want):
        _npz_equal(a, b)


# ---------------------------------------------------------------------------
# Host graph prep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_self_loops", (False, True))
def test_build_sym_adjacency_matches_jax_and_scipy(drop_self_loops):
    """The compiled library equals JAX's ``build_sym_adjacency`` and the
    port's own scipy path, self-loops kept or dropped."""
    assert native.native_available()
    n = 300
    src, dst = _edges(n, 2000, np.random.default_rng(7))
    got = native.build_sym_adjacency(src, dst, n, drop_self_loops)
    _csr_equal(got, jnative.build_sym_adjacency(src, dst, n,
                                                drop_self_loops))
    _csr_equal(got, native.build_sym_adjacency_scipy(src, dst, n,
                                                     drop_self_loops))
    assert (got.diagonal().sum() == 0) == drop_self_loops


def test_lowpass_and_transpose_match_jax():
    n = 200
    src, dst = _edges(n, 900, np.random.default_rng(8))
    adj = native.build_sym_adjacency(src, dst, n)
    _csr_equal(native.lowpass_operator(adj), jnative.lowpass_operator(adj))
    low = native.lowpass_operator(adj)
    _csr_equal(native.csr_transpose(low), jnative.csr_transpose(low))
