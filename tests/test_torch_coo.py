"""The port's COO operator against acmgnn_tpu's: the host build (triplets
in the same lexsort order, unpadded), ``spmm``, ``spmm_transpose`` and
``spmm_multi`` with ``grad_prefix`` (forward and VJP), agreement with the
ELL operator, and the "auto" operator format.

Tolerance: ``1e-5·sqrt(max degree)`` relative and absolute — both sides
sum the same f32 products over a row in different orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import make_coo_op as jax_make_coo_op
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu.ops.spmm import spmm_multi as jax_spmm_multi
from acmgnn_tpu.ops.spmm import spmm_transpose as jax_spmm_transpose
from acmgnn_tpu_torch.data.synthetic_scale import linkx_scale_graph
from acmgnn_tpu_torch.ops.coo import CooHalf, make_coo_half
from acmgnn_tpu_torch.ops.ell import make_ell_op
from acmgnn_tpu_torch.ops.graph import (
    CooOp,
    DenseOp,
    EllOp,
    GraphData,
    make_coo_op,
    precompute_operators,
    row_normalized_adjacency,
)
from acmgnn_tpu_torch.ops.spmm import spmm, spmm_high, spmm_multi, \
    spmm_transpose
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import prepare_data


def assert_close(ours, theirs, n_terms, msg=""):
    tol = 1e-5 * max(1.0, float(n_terms) ** 0.5)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(theirs, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _graph(kind: str, small_graph):
    """The test matrices: the genius-shaped low-pass, a binary symmetric
    one with an isolated node, and directed ones whose transposes have
    rows without a triplet."""
    if kind == "genius_lowpass":
        adj = linkx_scale_graph("genius", n=300, e=800, max_deg=60)[0]
        return row_normalized_adjacency(adj)
    if kind == "binary_sym":
        return sp.csr_matrix(small_graph[0])
    rng = np.random.default_rng(3)
    n = 90
    dense = (rng.random((n, n)) < 0.06).astype(np.float64)
    dense[:, 10:20] = 0.0              # columns without entries: empty Aᵀ rows
    directed = sp.csr_matrix(dense)
    if kind == "lowpass_directed":
        return row_normalized_adjacency(directed)
    directed.data = rng.uniform(0.1, 2.0, size=directed.nnz)
    return directed                    # "weighted"


KINDS = ("genius_lowpass", "binary_sym", "lowpass_directed", "weighted")


def _max_deg(mat):
    csr = sp.csr_matrix(mat)
    return int(max(np.diff(csr.indptr).max(),
                   np.diff(csr.T.tocsr().indptr).max()))


@pytest.mark.parametrize("kind", KINDS)
def test_make_coo_op_matches_jax(kind, small_graph):
    """Same triplets in the same order as JAX's unpadded prefix; every row
    without a triplet is listed for K5."""
    mat = _graph(kind, small_graph)
    op, jop = make_coo_op(mat), jax_make_coo_op(mat)
    assert isinstance(op, CooOp) and op.nnz == jop.nnz
    for half, suffix in ((op.fwd, ""), (op.bwd, "_t")):
        for name in ("row", "col", "val"):
            np.testing.assert_array_equal(
                getattr(half, name).numpy(),
                np.asarray(getattr(jop, name + suffix))[:op.nnz],
                err_msg=name + suffix)
    for half, csr in ((op.fwd, sp.csr_matrix(mat)),
                      (op.bwd, sp.csr_matrix(mat.T))):
        deg = np.diff(csr.indptr)
        np.testing.assert_array_equal(half.empty_rows.numpy(),
                                      np.flatnonzero(deg == 0))


@pytest.mark.parametrize("kind", KINDS)
def test_coo_spmm_and_transpose_match_jax(kind, small_graph):
    mat = _graph(kind, small_graph)
    n = mat.shape[0]
    x = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
    op, jop = make_coo_op(mat), jax_make_coo_op(mat)
    k = _max_deg(mat)
    assert_close(spmm(op, torch.from_numpy(x)),
                 jax_spmm(jop, jnp.asarray(x)), k, "forward")
    assert_close(spmm_transpose(op, torch.from_numpy(x)),
                 jax_spmm_transpose(jop, jnp.asarray(x)), k, "transpose")
    dense = np.asarray(sp.csr_matrix(mat).todense(), np.float32)
    assert_close(spmm_high(op, torch.from_numpy(x)), x - dense @ x, k,
                 "high")


@pytest.mark.parametrize("kind", ("genius_lowpass", "lowpass_directed"))
def test_coo_spmm_multi_prefix_gradient_matches_jax(kind, small_graph):
    """The paired layer-2 gather [zL_tr, zH_tr, zL_ev, zH_ev], flags
    [F, T, F, T], grad_prefix 2: forward and VJP through the transpose
    triplets."""
    mat = _graph(kind, small_graph)
    n = mat.shape[0]
    rng = np.random.default_rng(1)
    zs = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4)]
    gs = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4)]
    flags = [False, True, False, True]
    jop = jax_make_coo_op(mat)
    jouts, vjp = jax.vjp(
        lambda *z: jax_spmm_multi(jop, list(z), flags, grad_prefix=2),
        *(jnp.asarray(z) for z in zs))
    jgrads = vjp([jnp.asarray(g) for g in gs])
    tz = [torch.from_numpy(z).requires_grad_(True) for z in zs]
    outs = spmm_multi(make_coo_op(mat), tz, flags, grad_prefix=2)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    k = _max_deg(mat)
    for i in range(4):
        assert_close(outs[i], jouts[i], k, f"out {i}")
        assert_close(tz[i].grad if tz[i].grad is not None
                     else torch.zeros(n, 2), jgrads[i], k, f"grad {i}")


def test_coo_and_ell_spmm_multi_agree():
    """The same fused gather and prefix gradient on both formats."""
    adj = linkx_scale_graph("genius", n=500, e=1500, max_deg=80)[0]
    mat = row_normalized_adjacency(adj)
    n = mat.shape[0]
    rng = np.random.default_rng(2)
    zs = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4)]
    g = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
         for _ in range(4)]
    res = []
    for op in (make_coo_op(mat), make_ell_op(mat)):
        tz = [torch.from_numpy(z).requires_grad_(True) for z in zs]
        outs = spmm_multi(op, tz, [False, True, False, True], grad_prefix=2)
        torch.autograd.backward(outs, g)
        res.append([*outs, tz[0].grad, tz[1].grad])
    for a, b in zip(*res):
        assert_close(a, b.detach().numpy(), _max_deg(mat))


def test_auto_format_builds_the_genius_operator():
    """A default ``TrainConfig()`` ("auto") builds ELL above 4096 nodes;
    at or below it picks the dense format."""
    adj, feats, labels = linkx_scale_graph("genius", n=5000, e=12_000,
                                           max_deg=200)
    cfg = TrainConfig()
    assert cfg.operator_format == "auto"
    _, ops, x, _, _, _ = prepare_data(GraphData("g", adj, feats, labels), cfg,
                                      device="cpu")
    assert isinstance(ops.adj_low, EllOp) and ops.adj_low.num_nodes == 5000
    assert isinstance(precompute_operators(adj[:4096, :4096]).adj_low,
                      DenseOp)
    coo = precompute_operators(adj, fmt="coo", spmm_dtype=torch.bfloat16)
    assert isinstance(coo.adj_low, CooOp)
    assert coo.adj_low.fwd.val.dtype == torch.float32


def test_coo_half_partition():
    """K5's host partition: rows crossing a slice boundary with their
    first and last slice, and the rows without a triplet."""
    row = np.array([0, 0, 0, 0, 0, 0, 0, 2, 3, 3, 3, 5], np.int32)
    half = make_coo_half(row, np.zeros_like(row), np.ones(12, np.float32),
                         num_rows=7, slice_nnz=4)
    assert isinstance(half, CooHalf) and half.nnz == 12
    # slices: [0:4] row 0 | [4:8] rows 0, 2 | [8:12] rows 3, 5
    assert half.span_rows.tolist() == [0]
    assert (half.span_first.tolist(), half.span_last.tolist()) == ([0], [1])
    assert half.empty_rows.tolist() == [1, 4, 6]
    with pytest.raises(ValueError, match="sorted"):
        make_coo_half(row[::-1].copy(), row, np.ones(12, np.float32), 7)
