"""The port's data preparation, metrics, optimizer and joint training loop
against acmgnn_tpu's, on a small twitch-shaped graph.

``run_joint`` is compared after 20+ epochs at dropout 0 (the two
frameworks draw different dropout streams) from the same flax initial
parameters.  Tolerances are stated at each comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train.metrics import masked_accuracy as jax_masked_accuracy
from acmgnn_tpu.train.metrics import masked_nll as jax_masked_nll
from acmgnn_tpu.train.trainer import build_model as jax_build_model
from acmgnn_tpu.train.trainer import make_optimizer as jax_make_optimizer
from acmgnn_tpu.train.trainer import make_split_runner as jax_split_runner
from acmgnn_tpu.train.trainer import prepare_data as jax_prepare_data
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.metrics import masked_accuracy, masked_nll
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_optimizer,
    make_split_runner,
    prepare_data,
)

# the headline configuration at test size (bench.py's, hidden cut to 16)
HEADLINE = dict(
    model_type="acmgcnp", hidden=16, dropout=0.0, lr=0.01,
    weight_decay=1e-3, epochs=20, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=True, hoist_first=True,
)


@pytest.fixture(scope="module")
def graph():
    return twitch_gamers_scale_graph(0, n=300, pairs=3000)


def _masks(n):
    perm = np.random.default_rng(0).permutation(n)
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


@pytest.mark.parametrize("spmm_dtype", ("float32", "bfloat16"))
def test_prepare_data_matches_jax(graph, spmm_dtype):
    """Row-normalized features exactly; the hoisted aggregate to f32
    summation order over a row (1e-5·sqrt(max degree), relative)."""
    adj, feats, labels = graph
    cfg = dict(HEADLINE, spmm_dtype=spmm_dtype)
    _, jops, jx, jy, jy1h, jnc = jax_prepare_data(
        JaxGraphData("g", adj, feats, labels), JaxTrainConfig(**cfg))
    _, ops, x, y, y1h, nc = prepare_data(GraphData("g", adj, feats, labels),
                                         TrainConfig(**cfg), device="cpu")
    assert nc == jnc
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(y1h.numpy(), np.asarray(jy1h))
    k = int(np.diff(adj.indptr).max()) + 1
    tol = 1e-5 * k ** 0.5
    ref = np.asarray(jops.x_agg)
    np.testing.assert_allclose(ops.x_agg.numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(60, 3)).astype(np.float32)
    logits[0] = logits[0, 0]              # an argmax tie picks the first
    labels = rng.integers(0, 3, 60)
    mask = rng.random(60) < 0.5
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=1)
    t_lp = torch.log_softmax(torch.from_numpy(logits), dim=1)
    tl, tm = torch.from_numpy(labels), torch.from_numpy(mask)
    assert float(masked_accuracy(torch.from_numpy(logits), tl, tm)) == \
        pytest.approx(float(jax_masked_accuracy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))))
    assert float(masked_nll(t_lp, tl, tm)) == pytest.approx(
        float(jax_masked_nll(lp, jnp.asarray(labels), jnp.asarray(mask))),
        rel=1e-6)


def test_adam_matches_optax_chain():
    """torch Adam(weight_decay) == add_decayed_weights -> scale_by_adam ->
    scale(-lr), over a few steps (f32 rounding, 1e-6 relative)."""
    cfg = TrainConfig(lr=0.01, weight_decay=1e-3)
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    tx = jax_make_optimizer(JaxTrainConfig(lr=0.01, weight_decay=1e-3))
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(cfg, [tp])
    for _ in range(4):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)


def _run_both(graph, cfg_kw):
    """Both runners from the same flax initial parameters.

    The features are made non-negative here.  The stand-in's normal
    features have rows whose sum is near zero, so row normalization
    gives values up to ~430 at this size; on such rows the fast variance
    ``E[h²] − E[h]²`` cancels catastrophically and f32 summation order
    alone moves the two runs apart (measured: 1.2e-3 on
    ``gcn_0.weight_mlp`` after 10 epochs, while the JAX package's own ELL
    and COO runs agree to 2e-6).  Non-negative rows keep the comparison
    about the port, not about that conditioning."""
    adj, feats, labels = graph
    feats = np.abs(feats)
    n = adj.shape[0]
    masks = _masks(n)
    jcfg = JaxTrainConfig(**cfg_kw)
    _, jops, jx, jy, jy1h, nclass = jax_prepare_data(
        JaxGraphData("g", adj, feats, labels), jcfg)
    jmodel = jax_build_model(jcfg, nclass, n)
    variables = jmodel.init(jax.random.key(0), jx, jops)
    jres, jstate = jax_split_runner(jmodel, jcfg)(
        variables, jax.random.key(1), jops, jx, jy, jy1h,
        tuple(jnp.asarray(m) for m in masks), return_state=True)

    cfg = TrainConfig(**cfg_kw)
    _, ops, x, y, _, _ = prepare_data(GraphData("g", adj, feats, labels),
                                      cfg, device="cpu")
    model = build_model(cfg, x.shape[1], nclass, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    res = make_split_runner(model, cfg)(
        ops, x, y, tuple(torch.from_numpy(m) for m in masks))
    return jres, jstate, res, model


@pytest.mark.parametrize("variant", ("headline_f32", "headline_bf16",
                                     "acmgcn_val_loss"))
def test_run_joint_matches_jax(graph, variant):
    """21+ joint iterations (the epochs plus the final evaluation).

    f32: final parameters agree to 1e-4 (absolute and relative; measured
    at most 3e-5): Adam divides each step by the gradient's running RMS,
    so f32 summation-order noise grows on near-zero gradient entries.
    bf16 gathers: 1e-2, since a one-ulp f32 difference in an operand can
    flip its bf16 rounding (2^-8 relative; measured 2.8e-3).  Best
    metrics, losses and ``epochs_run`` agree to 1e-5 (f32) / 1e-4 (bf16).
    """
    cfg_kw = dict(HEADLINE)
    tol_params, tol_scalars = 1e-4, 1e-5
    if variant == "headline_bf16":
        cfg_kw["spmm_dtype"] = "bfloat16"
        tol_params, tol_scalars = 1e-2, 1e-4
    elif variant == "acmgcn_val_loss":
        cfg_kw.update(model_type="acmgcn", selection="val_loss", epochs=24)
    jres, jstate, res, model = _run_both(graph, cfg_kw)
    assert res.epochs_run == int(jres.epochs_run) == cfg_kw["epochs"]
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(getattr(res, field)) == pytest.approx(
            float(getattr(jres, field)), rel=tol_scalars, abs=tol_scalars), \
            field
    jparams = _flat(jstate.variables["params"])
    params = dict(model.named_parameters())
    assert set(jparams) == set(params)
    for name, ref in jparams.items():
        np.testing.assert_allclose(params[name].detach().numpy(), ref,
                                   rtol=tol_params, atol=tol_params,
                                   err_msg=name)


def test_run_joint_trains_with_dropout(graph):
    """The headline path with dropout 0.5 (the port's own stream): finite,
    falling loss and a selected epoch."""
    adj, feats, labels = graph
    cfg = TrainConfig(**dict(HEADLINE, dropout=0.5, epochs=30))
    _, ops, x, y, _, nclass = prepare_data(
        GraphData("g", adj, feats, labels), cfg, device="cpu")
    model = build_model(cfg, x.shape[1], nclass, device="cpu")
    masks = tuple(torch.from_numpy(m) for m in _masks(adj.shape[0]))
    res, state = make_split_runner(model, cfg)(ops, x, y, masks,
                                               return_state=True)
    losses = state.train_losses
    assert losses.shape == (31,) and torch.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert torch.isfinite(res.val_metric) and 0 < float(res.val_metric) <= 1
    assert dataclasses.asdict(res).keys() >= {"test_metric", "epochs_run"}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(TrainConfig(**HEADLINE), 7, 2)
