"""The frozen graph draws reproduce fixed checksums, and the draws the
port and bench.py make; the inputs made from a seed repeat."""

import hashlib

import numpy as np
import pytest
import torch

from acmgnn_tpu_torch.data import synthetic_scale
from acmgnn_tpu_torch.ops.native import build_sym_adjacency_scipy
from benchmark import graphs, inputs, manifest

SUMS = {"uniform": "7104085d59e44f79", "powerlaw": "3ad7b7723db7afd3",
        "banded": "a45dce457c5dbb5b"}


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("graph", sorted(SUMS))
def test_twitch_draws_keep_their_checksums(graph):
    assert digest(*graphs.twitch_pairs(1000, 5000, graph, 0)) == SUMS[graph]


def test_chung_lu_draws_keep_their_checksum():
    assert digest(*graphs.chung_lu_pairs(1000, 5000, 60, 0)) \
        == "b5baf9445582d4bc"


@pytest.mark.parametrize("graph", sorted(SUMS))
def test_twitch_draws_are_the_ports(graph):
    adj, _, _ = synthetic_scale.twitch_gamers_scale_graph(
        seed=3, n=800, pairs=4000, graph=graph)
    mine = graphs.symmetrize(*graphs.twitch_pairs(800, 4000, graph, 3), 800,
                             "cpu")
    assert (mine != adj).nnz == 0 and mine.nnz == adj.nnz


def test_chung_lu_draws_are_the_ports():
    src, dst = synthetic_scale.chung_lu_edges(700, 3000, 50, seed=2)
    s2, d2 = graphs.chung_lu_pairs(700, 3000, 50, 2)
    assert np.array_equal(src, s2) and np.array_equal(dst, d2)


def test_symmetrize_is_the_scipy_build():
    src, dst = graphs.twitch_pairs(1000, 5000, "powerlaw", 0)
    got = graphs.symmetrize(src, dst, 1000, "cpu")
    want = build_sym_adjacency_scipy(src, dst, 1000, drop_self_loops=True)
    assert got.has_sorted_indices
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert digest(got.indptr.astype(np.int64),
                  got.indices.astype(np.int32)) == "2760ebde7f742915"


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    cell = manifest.Cell("acmgcnpp-penn94.chunglu", manifest.manifest())
    adj = graphs.symmetrize(*graphs.twitch_pairs(50, 200, "uniform", 0), 50,
                            "cpu")
    config = dict(cell.config, data=dict(cell.config["data"], nodes=50,
                                         features=9))
    big = 2**31 + 11

    def make(seed):
        inp = inputs.Inputs(config, cell.traffic, seed, "cpu", adj,
                            cell.reference)
        return (inp.features(), inp.labels(), inp.masks(1), inp.params(1),
                inp.dropout_seed(1))

    a, b, c = make(big), make(big), make(big + 1)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert all(torch.equal(a[3][k], b[3][k]) for k in a[3])
    assert a[4] == b[4] and 0 <= a[4] < 2**32
    assert not torch.equal(a[0], c[0])
    train, val, test = a[2]
    assert int(train.sum()) == 25 and int(val.sum()) == 12
    assert not (train & val).any() and bool((train | val | test).all())
