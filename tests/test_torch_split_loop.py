"""The port's device-state split loop against acmgnn_tpu's ``lax.while_loop``.

``make_split_runner`` keeps the loop's state on the device (``LoopState``:
the epoch counter, the best metrics, the val-loss and train-loss
histories, the stop flag) and updates it in place, so that on the card one
body can be captured as a CUDA graph and replayed.  The CPU runs the same
body eagerly, so these tests cover the logic the card replays: joint and
sequential loops, selection by val metric and by val loss, NLL/accuracy
and BCE/ROC-AUC, and early stops that fire.

Both runners start from the same flax parameters (``models/convert.py``)
at dropout 0 (the frameworks draw different dropout streams), on
non-negative features (the conditioning reason in
tests/test_torch_trainer.py).  Tolerance: tests/test_torch_oracle_parity.py's
``1e-5·sqrt(reduction length)``, relative and absolute, with the node count
N as the length: the losses are means over masked nodes and the weight
gradients sum over the N rows.  ``epochs_run`` must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train.trainer import build_model as jax_build_model
from acmgnn_tpu.train.trainer import make_split_runner as jax_split_runner
from acmgnn_tpu.train.trainer import prepare_data as jax_prepare_data
from acmgnn_tpu_torch.data.synthetic_scale import (
    linkx_scale_graph,
    twitch_gamers_scale_graph,
)
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_split_runner,
    prepare_data,
    stop_window,
)

# the headline and genius configurations at test size (hidden cut to 8)
HEADLINE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.0, lr=0.01, weight_decay=1e-3,
    epochs=12, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=True, hoist_first=True)
GENIUS = dict(HEADLINE, model_type="acmgcn", metric="rocauc", loss="bce")

# (graph, configuration): every loop, both selections, both losses and
# metrics, and an early stop that fires in each loop (window 5): on the
# twitch graph after four readings of the rule, on genius at the first
# (its hidden width 16: at 8 the genius val loss plateaus and the rule
# fires on a margin of 3.5e-6, which rounding decides)
CASES = {
    "joint_acc_val_metric": ("twitch", HEADLINE),
    "joint_acc_val_loss": ("twitch", dict(HEADLINE, model_type="acmgcn",
                                          selection="val_loss")),
    "sequential_acc_val_metric": ("twitch", dict(HEADLINE, joint=False)),
    "sequential_acc_val_loss": ("twitch", dict(HEADLINE, joint=False,
                                               selection="val_loss")),
    "joint_rocauc": ("genius", GENIUS),
    "sequential_rocauc_val_loss": ("genius", dict(GENIUS, joint=False,
                                                  selection="val_loss")),
    "joint_acc_stop": ("twitch", dict(HEADLINE, epochs=40,
                                      early_stopping=5)),
    "sequential_rocauc_stop": ("genius", dict(GENIUS, joint=False, hidden=16,
                                              epochs=40, early_stopping=5)),
}


@pytest.fixture(scope="module")
def graphs():
    return {"twitch": twitch_gamers_scale_graph(0, n=300, pairs=3000),
            "genius": linkx_scale_graph("genius", n=400, e=1000,
                                        max_deg=60)}


def _masks(n):
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


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("case", tuple(CASES))
def test_split_loop_matches_jax(graphs, case):
    """Same ``epochs_run``; best metrics, last train loss, the val-loss
    history of every epoch run and the final parameters within
    ``1e-5·sqrt(N)``."""
    _matches_jax(graphs, *CASES[case])


# the card's optimizer arithmetic (torch's capturable form: step count and
# bias corrections on the device in f32) on the CPU, Adam and AdamW
CARD_FORM_CASES = {
    "joint_acc_val_metric": CASES["joint_acc_val_metric"],
    "joint_acc_adamw": ("twitch", dict(HEADLINE, optimizer="adamw")),
    "sequential_rocauc_val_loss": CASES["sequential_rocauc_val_loss"],
    "joint_acc_stop_adamw": ("twitch", dict(HEADLINE, epochs=40,
                                            early_stopping=5,
                                            optimizer="adamw")),
}


@pytest.mark.parametrize("case", tuple(CARD_FORM_CASES))
def test_split_loop_in_the_cards_optimizer_form_matches_jax(graphs, case):
    """The same body under ``capturable=True``, the optimizer arithmetic
    every card run uses (``make_optimizer``), against optax's update in
    JAX's loop, to the same tolerance."""
    _matches_jax(graphs, *CARD_FORM_CASES[case], capturable=True)


def _matches_jax(graphs, name, cfg_kw, capturable=None):
    adj, feats, labels = graphs[name]
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
    _, ops, x, y, y1h, _ = prepare_data(GraphData("g", adj, feats, labels),
                                        cfg, device="cpu")
    model = build_model(cfg, x.shape[1], nclass, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    res, state = make_split_runner(model, cfg, capturable=capturable)(
        ops, x, y, tuple(torch.from_numpy(m) for m in masks),
        labels_onehot=y1h, return_state=True)
    assert state.opt_state["param_groups"][0]["capturable"] == bool(capturable)

    tol = 1e-5 * n ** 0.5
    run = int(jres.epochs_run)
    assert res.epochs_run == run
    es = cfg_kw["early_stopping"]
    if es:
        assert run < cfg_kw["epochs"], "the stop must fire"
        # every reading of the rule is decided by more than the tolerance
        hist = np.asarray(jstate.val_hist)
        assert all(abs(hist[e] - hist[e - es:e].mean()) > tol
                   for e in range(es + 1, run))
    else:
        assert run == cfg_kw["epochs"]
    bodies = run + 1 if cfg.joint else run
    assert state.epoch == bodies and state.train_losses.shape == (bodies,)
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        _close(float(getattr(res, field)), float(getattr(jres, field)), tol,
               field)
    _close(state.train_losses[-1], jres.train_loss, tol, "train loss")
    _close(state.val_hist, np.asarray(jstate.val_hist)[:run], tol,
           "val_hist")
    params = dict(model.named_parameters())
    jparams = _flat(jstate.variables["params"])
    assert set(params) == set(jparams)
    for key, ref in jparams.items():
        _close(params[key].detach(), ref, tol, key)


ES, HIST = 5, 13      # the window; a history of epochs + 1 = 13 entries


@pytest.mark.parametrize("e", (0, 1, ES, ES + 1, HIST - 1))
def test_stop_window_gathers_the_dynamic_slice(e):
    """The window gathered at a device index equals JAX's
    ``dynamic_slice(hist, (e - es,), (es,))`` bit for bit (a negative start
    counts from the end, then clamps into the history), and its mean
    equals the mean of the same slice taken with a Python index (the same
    summation order)."""
    hist = np.random.default_rng(e).normal(size=HIST).astype(np.float32)
    got = stop_window(torch.from_numpy(hist), torch.tensor(e), ES)
    want = np.asarray(jax.lax.dynamic_slice(jnp.asarray(hist), (e - ES,),
                                            (ES,)))
    np.testing.assert_array_equal(got.numpy(), want)
    start = min(e - ES + (HIST if e < ES else 0), HIST - ES)
    assert float(got.mean()) == float(
        torch.from_numpy(hist)[start:start + ES].mean())


class _StandInGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_counted_graph_counts_launches_per_replay():
    """The counts a capture records are taken out again and added once
    per replay: ``kernels.launches`` counts the launches that ran."""
    kernels.reset_launches()
    try:
        kernels.count("k1_spmm_w7")              # an eager body's launch

        def record():                             # the capture's launches
            kernels.count("k1_spmm_w7")
            kernels.count("k1_spmm_w7")
            kernels.count("k4_auc_m2")

        graph = _StandInGraph()
        counted = kernels.CountedGraph(graph, record)
        assert dict(kernels.launches) == {"k1_spmm_w7": 1}
        assert dict(counted.per_replay) == {"k1_spmm_w7": 2, "k4_auc_m2": 1}
        for _ in range(3):
            counted.replay()
        assert graph.replays == 3
        assert dict(kernels.launches) == {"k1_spmm_w7": 7, "k4_auc_m2": 3}
    finally:
        kernels.reset_launches()


def test_cpu_runs_the_body_eagerly_in_either_form(graphs):
    """Without a card there is no capture: ``graph=True`` (the default)
    and ``graph=False`` run the same eager body, report no capture, and
    train alike bit for bit."""
    adj, feats, labels = graphs["twitch"]
    cfg = TrainConfig(**dict(HEADLINE, epochs=2))
    _, ops, x, y, _, nclass = prepare_data(GraphData("g", adj, feats, labels),
                                           cfg, device="cpu")
    masks = tuple(torch.from_numpy(m) for m in _masks(adj.shape[0]))
    runs = []
    for graph in (True, False):
        model = build_model(cfg, x.shape[1], nclass, device="cpu")
        res, state = make_split_runner(model, cfg, graph=graph)(
            ops, x, y, masks, return_state=True)
        assert state.capture_ms is None and state.setup_ms is None
        runs.append((res, state, dict(model.named_parameters())))
    (r0, s0, p0), (r1, s1, p1) = runs
    assert torch.equal(s0.train_losses, s1.train_losses)
    assert torch.equal(r0.val_loss, r1.val_loss)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
