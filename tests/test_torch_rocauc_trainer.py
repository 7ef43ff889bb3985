"""The genius-shaped ROC-AUC training path against acmgnn_tpu's: the
LINKX-scale generator, label preparation, and the joint loop (ELL and COO
operators) and the sequential loop with early stopping, from the same
flax initial parameters.

Tolerances are those of tests/test_torch_trainer.py at f32: parameters to
1e-4 (Adam divides by the gradient's running RMS, so f32 summation-order
noise grows on near-zero gradient entries), best metrics and losses to
1e-5, ``epochs_run`` exactly (the early stop included).  Dropout is 0
(the frameworks draw different dropout streams) and the features are made
non-negative, for the conditioning reason given in that file.
"""

from __future__ import annotations

import numpy as np
import pytest

import bench
import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.ops.native import build_sym_adjacency as jax_build_sym
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train.trainer import build_model as jax_build_model
from acmgnn_tpu.train.trainer import make_split_runner as jax_split_runner
from acmgnn_tpu.train.trainer import prepare_data as jax_prepare_data
from acmgnn_tpu_torch.data.synthetic_scale import linkx_scale_graph
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_split_runner,
    prepare_data,
)

# bench.py's genius configuration at test size (hidden cut to 16)
GENIUS = dict(
    model_type="acmgcn", hidden=16, dropout=0.0, lr=0.01, weight_decay=1e-3,
    epochs=20, early_stopping=0, selection="val_metric", metric="rocauc",
    loss="bce", operator_format="ell", spmm_dtype="float32",
    gemm_dtype="float32", joint=True, hoist_first=True,
)
N, E, MAX_DEG = 400, 1000, 60


@pytest.fixture(scope="module")
def graph():
    return linkx_scale_graph("genius", n=N, e=E, max_deg=MAX_DEG)


def _masks(n):
    """bench.py's 50/25/25 split from ``default_rng(1)``."""
    perm = np.random.default_rng(1).permutation(n)
    m = np.zeros((3, n), bool)
    m[0, perm[: n // 2]] = True
    m[1, perm[n // 2: 3 * n // 4]] = True
    m[2, perm[3 * n // 4:]] = True
    return m


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def test_linkx_generator_matches_bench_recipe():
    """Same draws and the same CSR as bench.py's genius scenario
    (``_chung_lu_edges`` and ``bench.py:622-627``) at reduced size."""
    n, e, max_deg = 3000, 8000, 300
    adj, feats, labels = linkx_scale_graph("genius", n=n, e=e,
                                           max_deg=max_deg)
    rng = np.random.default_rng(0)
    src, dst = bench._chung_lu_edges(n, e, max_deg, seed=0)
    ref = jax_build_sym(src, dst, n, drop_self_loops=True)
    spec = bench.LINKX_SCALE["genius"]
    ref_feats = rng.normal(size=(n, spec["f"])).astype(np.float32)
    ref_labels = rng.integers(0, spec["c"], size=n).astype(np.int32)
    ref.sort_indices()
    adj.sort_indices()
    np.testing.assert_array_equal(adj.indptr, ref.indptr)
    np.testing.assert_array_equal(adj.indices, ref.indices)
    np.testing.assert_array_equal(feats, ref_feats)
    np.testing.assert_array_equal(labels, ref_labels)
    assert adj.diagonal().sum() == 0
    assert np.diff(adj.indptr).max() > 10 * np.median(np.diff(adj.indptr))


@pytest.mark.parametrize("shape", ("n", "n1", "nc"))
def test_prepare_data_labels_match_jax(graph, shape):
    """``[N]`` and ``[N, 1]`` labels give the same one-hot; ``[N, C]``
    multilabel targets are their own one-hot."""
    adj, feats, labels = graph
    if shape == "n1":
        labels = labels[:, None]
    elif shape == "nc":
        labels = (np.random.default_rng(4).random((N, 3)) < 0.4).astype(
            np.int64)
    cfg = dict(GENIUS, operator_format="coo", hoist_first=False)
    _, _, _, jy, jy1h, jnc = jax_prepare_data(
        JaxGraphData("g", adj, feats, labels), JaxTrainConfig(**cfg))
    _, _, _, y, y1h, nc = prepare_data(GraphData("g", adj, feats, labels),
                                       TrainConfig(**cfg), device="cpu")
    assert nc == jnc
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(y1h.numpy(), np.asarray(jy1h))
    assert y1h.dtype == torch.float32


def _run_both(graph, cfg_kw):
    """Both runners from the same flax initial parameters."""
    adj, feats, labels = graph
    feats = np.abs(feats)
    masks = _masks(N)
    jcfg = JaxTrainConfig(**cfg_kw)
    _, jops, jx, jy, jy1h, nclass = jax_prepare_data(
        JaxGraphData("g", adj, feats, labels), jcfg)
    jmodel = jax_build_model(jcfg, nclass, N)
    variables = jmodel.init(jax.random.key(0), jx, jops)
    jres, jstate = jax_split_runner(jmodel, jcfg)(
        variables, jax.random.key(1), jops, jx, jy, jy1h,
        tuple(jnp.asarray(m) for m in masks), return_state=True)

    cfg = TrainConfig(**cfg_kw)
    _, ops, x, y, y1h, _ = prepare_data(GraphData("g", adj, feats, labels),
                                        cfg, device="cpu")
    model = build_model(cfg, x.shape[1], nclass, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    res = make_split_runner(model, cfg)(
        ops, x, y, tuple(torch.from_numpy(m) for m in masks),
        labels_onehot=y1h)
    return jres, jstate, res, model


RUNS = {
    "joint_ell": dict(),
    "joint_coo": dict(operator_format="coo"),
    "sequential_es": dict(joint=False, epochs=40, early_stopping=5),
    "joint_es": dict(epochs=40, early_stopping=5),
}


@pytest.mark.parametrize("run", tuple(RUNS))
def test_rocauc_training_matches_jax(graph, run):
    cfg_kw = dict(GENIUS, **RUNS[run])
    jres, jstate, res, model = _run_both(graph, cfg_kw)
    assert res.epochs_run == int(jres.epochs_run)
    if cfg_kw["early_stopping"]:
        assert res.epochs_run < cfg_kw["epochs"], "the stop must fire"
    else:
        assert res.epochs_run == cfg_kw["epochs"]
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(getattr(res, field)) == pytest.approx(
            float(getattr(jres, field)), rel=1e-5, abs=1e-5), field
    jparams = _flat(jstate.variables["params"])
    params = dict(model.named_parameters())
    assert set(jparams) == set(params)
    for name, ref in jparams.items():
        np.testing.assert_allclose(params[name].detach().numpy(), ref,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_card_check_window_is_well_conditioned():
    """chip_smoke.py holds the card's genius runs against the CPU's on a
    small stand-in (n=2000, dropout 0, f32, 40 epochs, and an early stop
    with window 5 inside 60).  That comparison can only find faults where
    the training does not amplify rounding differences: there, a 1e-7
    relative change of the features moves the trained parameters by less
    than 1e-6, and the early stop fires at the same epoch, before 60."""
    adj, feats, labels = linkx_scale_graph("genius", n=2000, e=5000,
                                           max_deg=150)
    feats = np.abs(feats)
    noisy = (feats * (1 + 1e-7 * np.random.default_rng(9).standard_normal(
        feats.shape))).astype(np.float32)
    masks = tuple(torch.from_numpy(m) for m in _masks(2000))
    for cfg_kw in (dict(epochs=40), dict(joint=False, epochs=60,
                                         early_stopping=5)):
        cfg = TrainConfig(**dict(GENIUS, **cfg_kw))
        runs = []
        for f in (feats, noisy):
            _, ops, x, y, y1h, nc = prepare_data(
                GraphData("g", adj, f, labels), cfg, device="cpu")
            model = build_model(cfg, x.shape[1], nc, device="cpu", seed=3)
            res = make_split_runner(model, cfg)(ops, x, y, masks,
                                                labels_onehot=y1h)
            runs.append((res.epochs_run, {k: p.detach() for k, p
                                          in model.named_parameters()}))
        (e0, p0), (e1, p1) = runs
        assert e0 == e1 and (e0 < 60 if cfg.early_stopping else e0 == 40)
        worst = max(float((p0[k] - p1[k]).abs().max()) for k in p0)
        assert worst < 1e-6, (cfg_kw, worst)
