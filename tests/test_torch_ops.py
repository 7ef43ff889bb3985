"""The port's operator layer against acmgnn_tpu's: host build, spmm,
spmm_transpose and spmm_multi (forward and prefix gradient), plus the
data helpers.  Inputs come from numpy seeds and go to both packages.

Tolerance: ``1e-5·sqrt(reduction length)`` relative and absolute, the
scale of tests/test_torch_oracle_parity.py — both sides accumulate in f32
over the same operands, in different orders.  With a bf16 gather dtype
both sides round the same operands the same way, so the same bound holds.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.data.registry import (
    row_normalize_features as jax_row_normalize_features,
)
from acmgnn_tpu.ops.ell import make_ell_op as jax_make_ell_op
from acmgnn_tpu.ops.graph import (
    row_normalized_adjacency as jax_row_normalized_adjacency,
)
from acmgnn_tpu.ops.native import build_sym_adjacency as jax_build_sym
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu.ops.spmm import spmm_multi as jax_spmm_multi
from acmgnn_tpu.ops.spmm import spmm_transpose as jax_spmm_transpose
from acmgnn_tpu_torch.data.registry import row_normalize_features
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.ops.ell import (
    make_ell_op,
    row_gather_spmm,
    row_gather_spmm_plain,
)
from acmgnn_tpu_torch.ops.graph import (
    DenseOp,
    precompute_operators,
    row_normalized_adjacency,
)
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.spmm import (
    spmm,
    spmm_high,
    spmm_multi,
    spmm_transpose,
)


def assert_close(ours, theirs, n_terms, msg=""):
    tol = 1e-5 * max(1.0, float(n_terms) ** 0.5)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(theirs, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _graph(kind: str, small_graph):
    """The test matrices; each takes a different half-building branch."""
    adj = sp.csr_matrix(small_graph[0])
    if kind == "lowpass_sym":     # row_scale + shared pre-scaled transpose
        return row_normalized_adjacency(adj)
    if kind == "binary_sym":      # Aᵀ == A, zero-degree row (node 5)
        return adj
    rng = np.random.default_rng(3)
    n = 90
    dense = (rng.random((n, n)) < 0.06).astype(np.float64)
    np.fill_diagonal(dense, 0.0)   # keeps D^-1(A+I) row-uniform
    directed = sp.csr_matrix(dense)
    if kind == "lowpass_directed":  # own transpose structure, pre-scaled
        return row_normalized_adjacency(directed)
    if kind == "weighted":        # per-nonzero values both ways
        w = directed.copy()
        w.data = rng.uniform(0.1, 2.0, size=w.nnz)
        return w
    raise ValueError(kind)


KINDS = ("lowpass_sym", "binary_sym", "lowpass_directed", "weighted")


def _max_deg(mat):
    csr = sp.csr_matrix(mat)
    return int(max(np.diff(csr.indptr).max(), np.diff(csr.T.tocsr().indptr)
                   .max()))


@pytest.mark.parametrize("kind", KINDS)
def test_spmm_and_transpose_match_jax(kind, small_graph):
    mat = _graph(kind, small_graph)
    n = mat.shape[0]
    x = np.random.default_rng(0).normal(size=(n, 6)).astype(np.float32)
    op = make_ell_op(mat)
    jop = jax_make_ell_op(mat)
    k = _max_deg(mat)
    assert_close(spmm(op, torch.from_numpy(x)),
                 jax_spmm(jop, jnp.asarray(x)), k, "forward")
    assert_close(spmm_transpose(op, torch.from_numpy(x)),
                 jax_spmm_transpose(jop, jnp.asarray(x)), k, "transpose")
    dense = np.asarray(sp.csr_matrix(mat).todense(), np.float32)
    assert_close(spmm(op, torch.from_numpy(x)), dense @ x, k, "dense")
    assert_close(spmm_high(op, torch.from_numpy(x)), x - dense @ x, k, "high")


def test_half_layouts(small_graph):
    """Value-free halves drop their values; a symmetric structure shares
    its arrays with the transpose half; zero-degree rows give zero."""
    op = make_ell_op(_graph("lowpass_sym", small_graph))
    assert op.fwd.vals is None and op.fwd.row_scale is not None
    assert op.bwd.pre_scale is not None and op.bwd.indices is op.fwd.indices
    binary = make_ell_op(_graph("binary_sym", small_graph))
    assert binary.bwd is binary.fwd
    out = spmm(binary, torch.ones(binary.num_nodes, 3))
    deg = np.diff(sp.csr_matrix(small_graph[0]).indptr)
    assert deg[5] == 0 and torch.all(out[5] == 0)
    np.testing.assert_array_equal(out[:, 0].numpy(), deg)
    directed = make_ell_op(_graph("lowpass_directed", small_graph))
    assert directed.bwd.indices is not directed.fwd.indices
    assert make_ell_op(_graph("weighted", small_graph)).fwd.vals is not None
    # degree-sorted rows, every output row written once
    deg = np.diff(op.fwd.indptr.numpy())
    assert np.all(deg[:-1] >= deg[1:])
    assert sorted(op.fwd.row_ids.tolist()) == list(range(op.num_nodes))


@pytest.mark.parametrize("gather_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("lowpass_sym", "lowpass_directed"))
@pytest.mark.parametrize("width,flags", [(2, (False, True, False, True)),
                                         (64, (False, True))])
def test_spmm_multi_prefix_gradient_matches_jax(kind, gather_dtype,
                                                small_graph, width, flags):
    """The paired layer-2 gather: [zL_tr, zH_tr, zL_ev, zH_ev] with flags
    [F, T, F, T] and grad_prefix 2, forward and vjp; and layer 1's
    [z_low | z_high] gather at w128 (two operands of 64 columns, the
    second through the high-pass epilogue: K1's wide form on the card),
    forward and vjp."""
    mat = _graph(kind, small_graph)
    n = mat.shape[0]
    rng = np.random.default_rng(1)
    zs = [rng.normal(size=(n, width)).astype(np.float32) for _ in flags]
    gs = [rng.normal(size=(n, width)).astype(np.float32) for _ in flags]
    op = make_ell_op(mat, gather_dtype=getattr(torch, gather_dtype))
    jop = jax_make_ell_op(mat, gather_dtype=getattr(jnp, gather_dtype))

    def jfun(*z):
        return jax_spmm_multi(jop, list(z), flags, grad_prefix=2)

    jouts, vjp = jax.vjp(jfun, *(jnp.asarray(z) for z in zs))
    jgrads = vjp([jnp.asarray(g) for g in gs])

    tz = [torch.from_numpy(z).requires_grad_(True) for z in zs]
    outs = spmm_multi(op, tz, flags, grad_prefix=2)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    k = _max_deg(mat)
    for i in range(len(flags)):
        assert_close(outs[i], jouts[i], k, f"out {i}")
        assert_close(tz[i].grad if tz[i].grad is not None
                     else torch.zeros(n, width), jgrads[i], k, f"grad {i}")


def test_spmm_gradient_matches_jax(small_graph):
    mat = _graph("lowpass_sym", small_graph)
    n = mat.shape[0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    g = rng.normal(size=(n, 5)).astype(np.float32)
    jop = jax_make_ell_op(mat)
    _, vjp = jax.vjp(lambda a: jax_spmm(jop, a), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    spmm(make_ell_op(mat), tx).backward(torch.from_numpy(g))
    assert_close(tx.grad, vjp(jnp.asarray(g))[0], _max_deg(mat))


def test_precompute_operators_matches_jax_lowpass(small_graph):
    adj = small_graph[0]
    ops = precompute_operators(adj, fmt="ell")
    n = adj.shape[0]
    dense = spmm(ops.adj_low, torch.eye(n)).numpy()
    ref = np.asarray(jax_row_normalized_adjacency(adj).todense())
    np.testing.assert_allclose(dense, ref, rtol=1e-6, atol=1e-7)
    dense_op = precompute_operators(adj, fmt="dense").adj_low
    assert isinstance(dense_op, DenseOp)
    np.testing.assert_allclose(dense_op.mat.numpy(), ref, rtol=1e-6,
                               atol=1e-7)


def test_row_normalize_features_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.normal(size=(50, 7)).astype(np.float32)
    f[3] = 0.0                                  # zero row stays zero
    f[7] = np.array([1, -1, 0, 0, 0, 0, 1e-6], np.float32)  # near-zero sum
    np.testing.assert_array_equal(row_normalize_features(f),
                                  jax_row_normalize_features(f))


def test_twitch_generator_matches_bench_recipe():
    """Same draws, same CSR as bench.py's generator (reduced n/pairs)."""
    n, pairs = 3000, 20000
    adj, feats, labels = twitch_gamers_scale_graph(0, n=n, pairs=pairs)
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, size=pairs, dtype=np.int64)
    dst = rng.integers(0, n, size=pairs, dtype=np.int64)
    ref = jax_build_sym(src, dst, n, drop_self_loops=True)
    ref_feats = rng.normal(size=(n, 7)).astype(np.float32)
    ref_labels = (rng.random(n) < 0.5).astype(np.int32)
    ref.sort_indices()
    adj.sort_indices()
    np.testing.assert_array_equal(adj.indptr, ref.indptr)
    np.testing.assert_array_equal(adj.indices, ref.indices)
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(labels, ref_labels)
    assert adj.diagonal().sum() == 0


def test_kernel_wrappers_count_only_launches(small_graph):
    """On CPU tensors the wrappers run the plain version and count
    nothing; the counter belongs to the kernel launch alone."""
    kernels.reset_launches()
    op = make_ell_op(_graph("lowpass_sym", small_graph))
    x = torch.randn(op.num_nodes, 4)
    out = row_gather_spmm(op.fwd, x, z=x, alpha=[1, 0, 1, 0],
                          beta=[-1, 1, -1, 1])
    ref = row_gather_spmm_plain(op.fwd, x, x, (1.0, 0.0, 1.0, 0.0),
                                (-1.0, 1.0, -1.0, 1.0))
    torch.testing.assert_close(out, ref)
    assert sum(kernels.launches.values()) == 0

