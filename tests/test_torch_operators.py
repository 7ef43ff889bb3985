"""The port's operator layer against acmgnn_tpu's.

The host constructors (``sym_normalized_adjacency``, ``high_pass``, ``k_hop``,
``precompute_operators``) and the products over every operator format
(dense, ELL, COO): ``spmm``, ``spmm_multi`` (with the paired prefix
gradient) and ``spmm_dual``, forward and gradient, with row and
symmetric normalization, f32 and bf16 gathers, on the unweighted
``small_graph`` and on a weighted variant whose ELL halves carry values.
The same numpy operands go through both packages.

Tolerance: ``1e-5·sqrt(reduction length)·max(1, max|JAX|)``
(tests/test_torch_oracle_parity.py's scale), the reduction being a row
of the operator: the two packages sum the same terms (bf16 gathers: the
same bf16 operand and, on valued halves, the same bf16-rounded products)
in different orders.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops import graph as jgraph
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu.ops.spmm import spmm_dual as jax_spmm_dual
from acmgnn_tpu.ops.spmm import spmm_multi as jax_spmm_multi
from acmgnn_tpu_torch.ops import graph
from acmgnn_tpu_torch.ops.coo import CooHalf
from acmgnn_tpu_torch.ops.ell import EllOp, make_ell_op
from acmgnn_tpu_torch.ops.spmm import spmm, spmm_dual, spmm_multi

DTYPES = {"f32": (torch.float32, None), "bf16": (torch.bfloat16,
                                                  jnp.bfloat16)}


def assert_close(ours, theirs, n_terms, msg=""):
    theirs = np.asarray(theirs, np.float32)
    tol = 1e-5 * max(1.0, float(n_terms) ** 0.5) \
        * max(1.0, float(np.abs(theirs).max()))
    ours = ours.detach().cpu().float().numpy()
    err = float(np.abs(ours - theirs).max())
    assert err <= tol, f"{msg}: max_abs_err {err:.3e} > {tol:.3e}"


def _weighted(adj):
    """``adj`` with symmetric positive weights: no operator built from
    it is row-uniform, so its ELL halves carry values."""
    rng = np.random.default_rng(7)
    w = sp.triu(sp.csr_matrix(adj), k=1).tocoo()
    w = sp.coo_matrix((rng.uniform(0.2, 3.0, w.nnz), (w.row, w.col)),
                      shape=adj.shape)
    return (w + w.T).tocsr()


@pytest.fixture(scope="module", params=("binary", "weighted"))
def adj(request, small_graph):
    a = small_graph[0]
    return a if request.param == "binary" else _weighted(a)


def _dense(m):
    return np.asarray(sp.csr_matrix(m).todense())


@pytest.mark.parametrize("fn", ("sym_normalized_adjacency", "high_pass",
                                "row_normalized_adjacency"))
def test_host_normalizations_match_jax(fn, adj):
    src = graph.row_normalized_adjacency(adj) if fn == "high_pass" else adj
    np.testing.assert_array_equal(_dense(getattr(graph, fn)(src)),
                                  _dense(getattr(jgraph, fn)(src)))


@pytest.mark.parametrize("hops,threshold", [(1, 20000), (2, 20000),
                                            (3, 20000), (3, 10)])
def test_k_hop_matches_jax(hops, threshold, adj):
    """``Â^k`` through the dense chain and (a threshold below N) the
    sparse one, as the JAX package builds it."""
    low = graph.row_normalized_adjacency(adj)
    np.testing.assert_array_equal(
        _dense(graph.k_hop(low, hops, dense_threshold=threshold)),
        _dense(jgraph.k_hop(low, hops, dense_threshold=threshold)))


@pytest.mark.parametrize("fmt", ("dense", "ell", "coo"))
@pytest.mark.parametrize("norm", ("row", "sym"))
def test_precompute_operators_matches_jax(fmt, norm, adj):
    """Every operator of the bundle (``hops`` 2 and ``structure_info``)
    equals the JAX package's as a matrix, and ``fmt="auto"`` on this
    graph of 80 nodes is dense, as there."""
    ops = graph.precompute_operators(adj, normalization=norm, hops=2,
                                     structure_info=True, fmt=fmt)
    jops = jgraph.precompute_operators(adj, normalization=norm, hops=2,
                                       structure_info=True, fmt=fmt)
    n = adj.shape[0]
    eye = np.eye(n, dtype=np.float32)
    for name in ("adj_low", "adj_unnorm", "adj_hp_base"):
        got = spmm(getattr(ops, name), torch.from_numpy(eye))
        want = jax_spmm(getattr(jops, name), jnp.asarray(eye))
        assert_close(got, want, n, name)
    assert ops.adj_hp is ops.adj_hp_base
    auto = graph.precompute_operators(adj, normalization=norm)
    assert isinstance(auto.adj_low, graph.DenseOp)
    assert auto.adj_unnorm is None and auto.adj_hp is auto.adj_low


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
def test_valued_planes_in_the_gather_dtype(dtype, adj):
    """A symmetric-normalized operator stores its values in the gather
    dtype (as the JAX package's value planes) and, where it is its own
    transpose to the last bit (always on the binary graph; the weighted
    one rounds ``d_i w d_j`` in two orders), one half for both
    directions, moved to a device once; a row-normalized weighted graph
    keeps two valued halves."""
    tdt = DTYPES[dtype][0]
    mat = graph.sym_normalized_adjacency(adj)
    sym = make_ell_op(mat, gather_dtype=tdt)
    assert sym.fwd.vals.dtype == tdt and sym.fwd.row_scale is None
    own_transpose = (mat != mat.T).nnz == 0
    assert own_transpose or (adj.data != 1).any()
    assert (sym.bwd is sym.fwd) == own_transpose
    moved = sym.to("cpu")
    assert (moved.bwd is moved.fwd) == own_transpose
    assert moved.fwd.vals.dtype == tdt
    row = make_ell_op(graph.row_normalized_adjacency(adj), gather_dtype=tdt)
    if (adj.data == 1).all():          # row-uniform: value-free halves
        assert row.fwd.vals is None and row.bwd.vals is None
    else:
        assert row.fwd.vals.dtype == row.bwd.vals.dtype == tdt
        assert row.bwd is not row.fwd


def _operators(adj, fmt, norm, dtype):
    tdt, jdt = DTYPES[dtype]
    ops = graph.precompute_operators(adj, normalization=norm, fmt=fmt,
                                     spmm_dtype=tdt)
    jops = jgraph.precompute_operators(adj, normalization=norm, fmt=fmt,
                                       spmm_dtype=jdt)
    return ops.adj_low, jops.adj_low


def _row_terms(adj):
    return int(np.diff(sp.csr_matrix(adj).indptr).max()) + 1


FORMATS = [("dense", "f32"), ("ell", "f32"), ("ell", "bf16"), ("coo", "f32")]


@pytest.mark.parametrize("fmt,dtype", FORMATS)
@pytest.mark.parametrize("norm", ("row", "sym"))
@pytest.mark.parametrize("fn", ("spmm", "spmm_multi", "spmm_multi_prefix",
                                "spmm_dual"))
def test_products_and_gradients_match_jax(fn, fmt, dtype, norm, adj):
    """Forward and gradient (``jax.vjp`` against autograd, the same
    cotangent) of each product.  ``spmm_multi`` fuses a low-pass and two
    high-pass operands; ``spmm_multi_prefix`` marks only the first two
    differentiable (the joint loop's paired eval branch)."""
    op, jop = _operators(adj, fmt, norm, dtype)
    n = adj.shape[0]
    rng = np.random.default_rng(3)
    widths = {"spmm": (5,), "spmm_multi": (3, 4, 2),
              "spmm_multi_prefix": (3, 4, 2, 4), "spmm_dual": (3, 3)}[fn]
    zs_np = [rng.normal(size=(n, w)).astype(np.float32) for w in widths]
    gs_np = [rng.normal(size=(n, w)).astype(np.float32) for w in widths]
    flags = {"spmm": [False], "spmm_multi": [False, True, True],
             "spmm_multi_prefix": [False, True, False, True],
             "spmm_dual": [False, True]}[fn]
    prefix = 2 if fn == "spmm_multi_prefix" else None

    def jfun(*zs):
        if fn == "spmm":
            return [jax_spmm(jop, zs[0])]
        if fn == "spmm_dual":
            return list(jax_spmm_dual(jop, *zs))
        return jax_spmm_multi(jop, list(zs), flags, grad_prefix=prefix)

    jouts, vjp = jax.vjp(jfun, *map(jnp.asarray, zs_np))
    jgrads = vjp([jnp.asarray(g) for g in gs_np])

    zs = [torch.from_numpy(z).requires_grad_(True) for z in zs_np]
    if fn == "spmm":
        outs = [spmm(op, zs[0])]
    elif fn == "spmm_dual":
        outs = list(spmm_dual(op, *zs))
    else:
        outs = spmm_multi(op, zs, flags, grad_prefix=prefix)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs_np])
    terms = n if fmt == "dense" else _row_terms(adj)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        assert_close(o, jo, terms, f"out {i}")
    for i, (z, jg) in enumerate(zip(zs, jgrads)):
        if prefix is not None and i >= prefix and not flags[i]:
            continue              # no gradient path outside the prefix
        assert z.grad is not None, i
        assert_close(z.grad, jg, terms, f"grad {i}")


@pytest.mark.parametrize("fmt", ("ell", "coo"))
def test_structure_operator_is_the_raw_adjacency(fmt, adj):
    """The structure channel's operator keeps the raw values (ones on
    the binary graph, the weights on the weighted one): value-free ELL
    halves with a unit row scale, or f32 triplets."""
    ops = graph.precompute_operators(adj, structure_info=True, fmt=fmt,
                                     spmm_dtype=torch.bfloat16)
    op = ops.adj_unnorm
    if fmt == "ell":
        assert isinstance(op, EllOp) and op.bwd is op.fwd
        if (adj.data == 1).all():
            assert op.fwd.vals is None
            has_entries = torch.from_numpy(np.diff(adj.indptr) > 0)
            assert (op.fwd.row_scale[has_entries] == 1).all()
    else:
        assert isinstance(op.fwd, CooHalf)
        assert op.fwd.val.dtype == torch.float32


def test_valued_hub_rows_round_every_product():
    """A deviation (ROADMAP.md §C): the JAX package sends rows of more
    than 2048 nonzeros (``ACMGNN_ELL_HUB``) to a dense hub matmul whose
    bf16 products are not rounded, while K1 (and its plain version)
    rounds every valued term to bf16, as JAX's own bucketed rows do.  On
    a symmetric-normalized star of 2,100 leaves with bf16 gathers the
    hub row parts from JAX's by more than the rows below the threshold
    do; each side equals its own rule computed in f64."""
    import ml_dtypes

    n = 2101
    rows = np.zeros(n - 1, np.int64)
    cols = np.arange(1, n)
    adj = sp.coo_matrix((np.ones(n - 1), (rows, cols)), shape=(n, n))
    adj = (adj + adj.T).tocsr()
    op, jop = _operators(adj, "ell", "sym", "bf16")
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    got = spmm(op, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_spmm(jop, jnp.asarray(x)), np.float32)
    mat = graph.sym_normalized_adjacency(adj).tocsr()
    bf = ml_dtypes.bfloat16
    xb = x.astype(bf).astype(np.float64)
    vals = mat.data.astype(np.float32).astype(bf).astype(np.float64)
    hub = slice(mat.indptr[0], mat.indptr[1])
    terms = vals[hub, None] * xb[mat.indices[hub]]
    rounded = terms.astype(np.float32).astype(bf).astype(np.float64).sum(0)
    exact = terms.sum(0)
    tol = 1e-5 * np.sqrt(n)
    for side, rule in ((got[0], rounded), (want[0], exact)):
        assert np.abs(side - rule).max() <= tol * max(1, np.abs(rule).max())
    gap = np.abs(got[0] - want[0]).max()
    assert gap > tol * max(1.0, np.abs(want[0]).max()), gap
    assert_close(torch.from_numpy(got[1:]), want[1:], 3, "leaf rows")
