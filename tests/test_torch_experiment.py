"""The port's single-card entry points and their knobs against acmgnn_tpu's:
``run_experiment``, ``run_experiment_stepwise``, remat, AdamW, bf16 GEMMs,
bf16 feature storage, ``locality_order`` / ``maybe_reorder`` and
``resolve_split``, on a small twitch-shaped graph.

The two frameworks draw different initial parameters and dropout
streams, so the comparisons run at dropout 0 from JAX's initial
parameters, carried over with ``params_from_flax`` (``run_experiment``
through both packages' ``runner`` hooks).  Features are non-negative for
the conditioning reason given in tests/test_torch_trainer.py.
Tolerances, stated where used, are that file's: f32 parameters to 1e-4,
best metrics and losses to 1e-5, accuracies and ``epochs_run`` equal.
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
from acmgnn_tpu.ops.graph import locality_order as jax_locality_order
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models import layers
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops import dropout as dropout_mod
from acmgnn_tpu_torch.ops import ell
from acmgnn_tpu_torch.ops.graph import GraphData, locality_order
from acmgnn_tpu_torch.train import TrainConfig, run_experiment
from acmgnn_tpu_torch.train import trainer

# the headline model at test size: hidden 8, dropout 0, f32
BASE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.0, lr=0.01, weight_decay=1e-3,
    epochs=15, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=True, hoist_first=True, num_splits=2, seed=3)
# one split held to JAX's parameters: hidden 16, where f32 summation order
# moves this graph's parameters by 2.5e-6 in 15 epochs (at hidden 8 by
# 1.8e-4, with or without remat)
SPLIT = dict(BASE, hidden=16, num_splits=1)


@pytest.fixture(scope="module")
def graph():
    adj, feats, labels = twitch_gamers_scale_graph(0, n=300, pairs=3000)
    return adj, np.abs(feats), labels


def _data(graph, jax_side=False, **extra):
    cls = JaxGraphData if jax_side else GraphData
    return cls("g", *graph, **extra)


def _state_dict(variables):
    return params_from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


# ---------------------------------------------------------------------------
# run_experiment
# ---------------------------------------------------------------------------


def _both_experiments(graph, cfg_kw):
    """JAX's ``run_experiment`` with its runner hook recording each
    split's initial variables, masks and result; then the port's, whose
    runner hook starts each split from those variables."""
    jcfg = JaxTrainConfig(**cfg_kw)
    jdata = _data(graph, jax_side=True)
    jmodel = jtrainer.build_model(jcfg, int(graph[2].max()) + 1,
                                  graph[0].shape[0])
    jrun = jax.jit(jtrainer.make_split_runner(jmodel, jcfg))
    jseen = []

    def jhook(variables, key, ops, x, labels, labels_onehot, masks):
        res = jrun(variables, key, ops, x, labels, labels_onehot, masks)
        jseen.append((variables, [np.asarray(m) for m in masks], res))
        return res

    jout = jtrainer.run_experiment(jdata, jcfg, runner=jhook)
    cfg = TrainConfig(**cfg_kw)
    seen = []

    def hook(model, ops, x, labels, masks, *, seed, labels_onehot, hparams):
        model.load_state_dict(_state_dict(jseen[len(seen)][0]))
        res = trainer.make_split_runner(model, cfg)(
            ops, x, labels, masks, seed=seed, labels_onehot=labels_onehot,
            hparams=hparams)
        seen.append(([m.numpy() for m in masks], res))
        return res

    out = run_experiment(_data(graph), cfg, runner=hook, device="cpu")
    return jout, jseen, out, seen


@pytest.mark.parametrize("loop", ("joint", "sequential", "sequential_es"))
def test_run_experiment_matches_jax(graph, loop):
    """Two splits: equal masks, per-split test metric (an accuracy) and
    ``epochs_run`` (the early stop included), best val metric to 1e-5,
    and the same result keys."""
    cfg_kw = dict(BASE)
    if loop != "joint":
        cfg_kw["joint"] = False
    if loop == "sequential_es":
        cfg_kw.update(epochs=40, early_stopping=3, lr=0.05,
                      selection="val_loss")
    jout, jseen, out, seen = _both_experiments(graph, cfg_kw)
    assert len(seen) == len(jseen) == 2
    for (jvars, jmasks, jres), (masks, res) in zip(jseen, seen):
        for a, b in zip(jmasks, masks):
            np.testing.assert_array_equal(a, b)
        assert res.epochs_run == int(jres.epochs_run)
        assert float(res.test_metric) == pytest.approx(
            float(jres.test_metric), abs=1e-6)
        assert float(res.val_metric) == pytest.approx(
            float(jres.val_metric), rel=1e-5, abs=1e-5)
    if loop == "sequential_es":
        assert all(res.epochs_run < cfg_kw["epochs"] for _, res in seen)
    assert set(out) == set(jout)
    assert out["per_split"] == pytest.approx(jout["per_split"], abs=1e-6)
    assert out["epochs_total"] == jout["epochs_total"]
    assert out["epoch_ms_steady"] > 0


def test_run_experiment_hooks(graph):
    """``prepared`` skips preprocessing, ``splits`` gives the masks,
    ``hparams`` builds the optimizer from its (lr, wd), and a logger
    hears every split and the result."""
    cfg = TrainConfig(**dict(BASE, epochs=4))
    prepared = trainer.prepare_data(_data(graph), cfg, device="cpu")
    n = graph[0].shape[0]
    fixed = [tuple(np.arange(n) % 3 == k for k in range(3))] * 2
    lrs = []

    def hook(model, *args, hparams, **kwargs):
        run = trainer.make_split_runner(model, cfg)
        res, state = run(*args, hparams=hparams, return_state=True, **kwargs)
        lrs.append(state.opt_state["param_groups"][0]["lr"])
        assert state.opt_state["param_groups"][0]["weight_decay"] == 0.0
        return res

    class Log:
        def __init__(self):
            self.calls = []

        def info(self, *a):
            self.calls.append("info")

        def log_split(self, idx, res):
            self.calls.append(("split", idx))

        def log_result(self, out):
            self.calls.append("result")

    log = Log()
    out = run_experiment(None, cfg, splits=fixed, prepared=prepared,
                         runner=hook, hparams=(0.2, 0.0), logger=log)
    assert lrs == [0.2, 0.2]
    assert log.calls == [("split", 0), ("split", 1), "result"]
    assert out["epochs_total"] == 2 * cfg.epochs


# ---------------------------------------------------------------------------
# run_experiment_stepwise
# ---------------------------------------------------------------------------


class _EpochLog:
    """Records the per-epoch rows an entry point logs with display_step=1
    (loss, train, val, test) and its result dict."""

    def __init__(self):
        self.rows, self.out = [], None

    def info(self, msg, *args):
        if "epoch" in msg:
            self.rows.append(args)

    def log_result(self, out):
        self.out = out


def _stepwise_matches_jax(graph, monkeypatch, cfg_kw):
    """Both packages' ``run_experiment_stepwise`` on ``cfg_kw``, the
    port's splits from JAX's initial variables (its ``fold_in(key(seed),
    idx)`` init, given to the port's ``build_model``): per-epoch rows
    (split, epoch, loss, train/val/test metric) to 1e-6 and an equal
    summary."""
    jcfg = JaxTrainConfig(**cfg_kw)
    jlog = _EpochLog()
    jtrainer.run_experiment_stepwise(_data(graph, jax_side=True), jcfg,
                                     logger=jlog, display_step=1)
    _, jops, jx, *_ = jtrainer.prepare_data(_data(graph, jax_side=True), jcfg)
    jmodel = jtrainer.build_model(jcfg, 2, graph[0].shape[0])
    key = jax.random.key(jcfg.seed)
    inits = {jcfg.seed + idx: jmodel.init(jax.random.split(
        jax.random.fold_in(key, idx))[0], jx, jops)
        for idx in range(jcfg.num_splits)}
    build = trainer.build_model

    def from_jax(cfg, nfeat, nclass, *, device=None, seed=0, nnodes=None):
        model = build(cfg, nfeat, nclass, device=device, seed=seed,
                      nnodes=nnodes)
        model.load_state_dict(_state_dict(inits[seed]))
        return model

    monkeypatch.setattr(trainer, "build_model", from_jax)
    log = _EpochLog()
    out = trainer.run_experiment_stepwise(_data(graph), TrainConfig(**cfg_kw),
                                          logger=log, display_step=1,
                                          device="cpu")
    assert len(log.rows) == len(jlog.rows) == 2 * cfg_kw["epochs"]
    np.testing.assert_allclose(np.asarray(log.rows, np.float64),
                               np.asarray(jlog.rows, np.float64),
                               rtol=1e-6, atol=1e-6)
    for k in ("test_mean", "test_std", "valid_mean", "valid_std",
              "per_split", "epochs_total"):
        assert out[k] == pytest.approx(jlog.out[k], abs=1e-6), k
    assert set(out) == set(jlog.out)


def test_run_experiment_stepwise_matches_jax(graph, monkeypatch):
    """Accuracies, as ``_stepwise_matches_jax``."""
    _stepwise_matches_jax(graph, monkeypatch,
                          dict(BASE, epochs=8, joint=False))


def test_run_experiment_stepwise_rocauc_matches_jax(graph, monkeypatch):
    """BCE and ROC-AUC (train, val and test masks from one sort and one
    rank pass, the packed words built once a split), as
    ``_stepwise_matches_jax``."""
    _stepwise_matches_jax(graph, monkeypatch,
                          dict(BASE, epochs=8, joint=False, metric="rocauc",
                               loss="bce"))


def test_stepwise_refuses_checkpointing(graph, tmp_path):
    """Checkpointing runs on both paths and refuses nothing: the stepwise
    path writes the best and the whole-state snapshots and the history;
    the sharded path, with ``checkpoint_every``, its segments' state alone
    (dropout keeps no generator state to save; without it, as in the JAX
    package, nothing; ``resume`` without snapshots starts afresh)."""
    cfg = TrainConfig(**dict(BASE, epochs=2, num_splits=1))
    for kw in (dict(checkpoint_dir=str(tmp_path / "none")),
               dict(checkpoint_every=2), dict(resume=True)):
        trainer.run_experiment_sharded(_data(graph), cfg, device="cpu",
                                       **kw)
    assert not (tmp_path / "none").exists()
    trainer.run_experiment_sharded(_data(graph), cfg, device="cpu",
                                   checkpoint_dir=str(tmp_path / "sharded"),
                                   checkpoint_every=1)
    assert {p.name for p in (tmp_path / "sharded").iterdir()} == {
        "split0_state"}
    trainer.run_experiment_stepwise(_data(graph), cfg, device="cpu",
                                    checkpoint_dir=str(tmp_path / "step"),
                                    checkpoint_every=1)
    assert {p.name for p in (tmp_path / "step").iterdir()} == {
        "split0_best", "split0_last", "split0_history.npy"}


# ---------------------------------------------------------------------------
# remat, AdamW, bf16 GEMMs, bf16 features
# ---------------------------------------------------------------------------


def _one_split(graph, cfg_kw, variables=None, seed=0, counting=None):
    """The port's runner on the first random split: (result, parameters);
    ``counting``: a dict that receives the plain versions' calls of K1
    and K2 by name."""
    cfg = TrainConfig(**cfg_kw)
    data, ops, x, y, y1h, nclass = trainer.prepare_data(_data(graph), cfg,
                                                        device="cpu")
    masks = trainer.resolve_split(data, cfg, 0, np.random.default_rng(0),
                                  data.labels, nclass)
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                seed=seed)
    if variables is not None:
        model.load_state_dict(_state_dict(variables))
    run = trainer.make_split_runner(model, cfg)
    res = run(ops, x, y, tuple(torch.from_numpy(m) for m in masks),
              seed=seed, labels_onehot=y1h)
    return res, {k: p.detach().numpy() for k, p in model.named_parameters()}


def _jax_split(graph, cfg_kw):
    """JAX's runner on the same split: (initial variables, result,
    final parameters flattened to the port's names)."""
    jcfg = JaxTrainConfig(**cfg_kw)
    data, ops, x, y, y1h, nclass = jtrainer.prepare_data(
        _data(graph, jax_side=True), jcfg)
    masks = jtrainer.resolve_split(data, jcfg, 0, np.random.default_rng(0),
                                   np.asarray(data.labels), nclass)
    model = jtrainer.build_model(jcfg, nclass, data.num_nodes)
    variables = model.init(jax.random.key(0), x, ops)
    res, state = jax.jit(jtrainer.make_split_runner(model, jcfg),
                         static_argnames=("return_state",))(
        variables, jax.random.key(1), ops, x, y, y1h,
        tuple(jnp.asarray(m) for m in masks), return_state=True)
    return variables, res, _flat(state.variables["params"])


def _assert_split_close(res, params, jres, jparams, tol_params, tol_scalars):
    assert res.epochs_run == int(jres.epochs_run)
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(getattr(res, field)) == pytest.approx(
            float(getattr(jres, field)), rel=tol_scalars, abs=tol_scalars), \
            field
    assert set(params) == set(jparams)
    for name, ref in jparams.items():
        np.testing.assert_allclose(params[name], ref, rtol=tol_params,
                                   atol=tol_params, err_msg=name)


@pytest.mark.parametrize("joint", (True, False))
def test_remat_leaves_training_unchanged_with_dropout(graph, joint):
    """remat's recompute draws the forward's dropout masks with no twin
    generator and nothing restored (a mask is a function of the key and
    the site, and the recompute numbers its sites as the forward did): at
    dropout 0.5 the parameters after 6 epochs equal the plain run's (the
    same arithmetic; 1e-6 for the backward's rounding)."""
    cfg_kw = dict(BASE, dropout=0.5, epochs=6, joint=joint)
    res0, p0 = _one_split(graph, cfg_kw, seed=4)
    res1, p1 = _one_split(graph, dict(cfg_kw, remat=True), seed=4)
    assert res0.epochs_run == res1.epochs_run
    for name, ref in p0.items():
        np.testing.assert_allclose(p1[name], ref, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_remat_recomputes_every_forward_launch(graph, monkeypatch):
    """What chip_smoke.py's remat launch counts assume: with remat, the
    backward re-runs every K1 and K2 call of the train forward once (the
    paired eval branch included, since its layer-2 aggregate shares the
    train branch's gather) up to the last one whose inputs autograd saved
    (torch's non-reentrant checkpoint stops there): the eval branch's
    layer-2 K2, the forward's last launch, feeds metrics only and is not
    re-run; the set-up gather and the backward's K1/K3 calls are
    unchanged.  Dropout (K8's plain version) is called at the forward's
    two sites, the input and layer 1's output, in the train branch only;
    remat's recompute calls both again, and the backward calls none on
    the CPU (the plain version's gradient is autograd's)."""
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name in ((ell, "row_gather_spmm"),
                      (layers, "attention_mix_forward"),
                      (layers, "attention_mix_backward"),
                      (dropout_mod, "dropout_plain")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    import acmgnn_tpu_torch.ops.spmm as spmm_mod
    monkeypatch.setattr(spmm_mod, "row_gather_spmm", ell.row_gather_spmm)
    counts = []
    for remat in (False, True):
        calls.clear()
        _one_split(graph, dict(BASE, dropout=0.5, epochs=3, remat=remat))
        counts.append(dict(calls))
    plain, remat = counts
    bodies = 3 + 1                                # joint: epochs + 1
    fwd_gathers = 2 * bodies                      # input + layer-2 gathers
    assert plain == {"row_gather_spmm": 1 + fwd_gathers + bodies,
                     "attention_mix_forward": 4 * bodies,
                     "attention_mix_backward": 2 * bodies,
                     "dropout_plain": 2 * bodies}
    assert remat == {"row_gather_spmm": 1 + 2 * fwd_gathers + bodies,
                     "attention_mix_forward": 7 * bodies,
                     "attention_mix_backward": 2 * bodies,
                     "dropout_plain": 4 * bodies}


def test_remat_matches_jax_remat(graph):
    """remat on both sides at dropout 0: the joint loop's result and
    parameters as tests/test_torch_trainer.py holds them (1e-4 / 1e-5)."""
    cfg_kw = dict(SPLIT, remat=True)
    variables, jres, jparams = _jax_split(graph, cfg_kw)
    res, params = _one_split(graph, cfg_kw, variables)
    _assert_split_close(res, params, jres, jparams, 1e-4, 1e-5)


def test_adamw_matches_optax():
    """torch AdamW == optax.adamw (decoupled decay) over a few steps, to
    1e-6 (f32 rounding)."""
    cfg = TrainConfig(optimizer="adamw", lr=0.01, weight_decay=1e-2)
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    tx = jtrainer.make_optimizer(JaxTrainConfig(optimizer="adamw", lr=0.01,
                                                weight_decay=1e-2))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = trainer.make_optimizer(cfg, [tp])
    assert isinstance(opt, torch.optim.AdamW)
    for _ in range(5):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="optimizer"):
        trainer.make_optimizer(dataclasses.replace(cfg, optimizer="sgd"),
                               [tp])


def test_adamw_split_matches_jax(graph):
    cfg_kw = dict(SPLIT, optimizer="adamw", weight_decay=1e-2)
    variables, jres, jparams = _jax_split(graph, cfg_kw)
    res, params = _one_split(graph, cfg_kw, variables)
    _assert_split_close(res, params, jres, jparams, 1e-4, 1e-5)


def test_bf16_gemm_matches_jax_grad():
    """``bf16_matmul`` (the bf16 channel projection) against JAX's
    ``dot(a.bf16, w.bf16, preferred_element_type=f32)``: the f32 output
    and ``jax.vjp``'s dA / dW, both rounded to bf16 and returned as f32.
    f32 sums of the same exact bf16 products in two orders:
    ``1e-5·sqrt(K)·Σ|terms|``, plus one bf16 step (2^-7 relative) for the
    gradients, whose rounding a last-bit f32 difference can flip; the
    gradients are bf16 values, as JAX's."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(50, 24)).astype(np.float32)
    w = rng.normal(size=(24, 6)).astype(np.float32)
    g = rng.normal(size=(50, 6)).astype(np.float32)

    def jdot(a_, w_):
        return jnp.dot(a_.astype(jnp.bfloat16), w_.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)

    jout, vjp = jax.vjp(jdot, jnp.asarray(a), jnp.asarray(w))
    jda, jdw = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = layers.bf16_matmul(ta, tw)
    out.backward(torch.from_numpy(g))
    assert out.dtype == ta.grad.dtype == tw.grad.dtype == torch.float32
    ab, wb = (np.abs(np.asarray(jnp.asarray(t).astype(jnp.bfloat16)
                                .astype(jnp.float32))) for t in (a, w))
    scales = (ab @ wb, np.abs(g) @ wb.T, ab.T @ np.abs(g))
    for got, want, scale, k, rounded in (
            (out.detach(), jout, scales[0], 24, False),
            (ta.grad, jda, scales[1], 6, True),
            (tw.grad, jdw, scales[2], 50, True)):
        want = np.asarray(want)
        tol = 1e-5 * k ** 0.5 * scale
        if rounded:
            tol = tol + 2.0 ** -7 * np.abs(want)
        assert np.all(np.abs(got.numpy() - want) <= tol)
    for grad in (ta.grad, tw.grad):
        assert torch.equal(grad, grad.bfloat16().float())
    assert layers.make_mm("bfloat16") is layers.bf16_matmul
    with pytest.raises(ValueError, match="gemm_dtype"):
        layers.make_mm("float16")


@pytest.mark.parametrize("knobs", ("bf16_features", "bf16_features_gemm"))
def test_bf16_knobs_split_matches_jax(graph, knobs):
    """bf16 feature storage (and bf16 GEMMs) through ``prepare_data`` and
    one joint split: the stored features equal JAX's bf16 copy, the
    hoisted aggregate agrees to f32 summation order, and the split agrees
    with JAX's at tests/test_torch_trainer.py's bf16 tolerances (1e-2 on
    parameters: a one-ulp f32 difference can flip a bf16 rounding; 1e-4
    on the best metrics and losses)."""
    cfg_kw = dict(SPLIT, feature_dtype="bfloat16")
    if knobs == "bf16_features_gemm":
        cfg_kw["gemm_dtype"] = "bfloat16"
    jcfg = JaxTrainConfig(**cfg_kw)
    _, jops, jx, *_ = jtrainer.prepare_data(_data(graph, jax_side=True), jcfg)
    _, ops, x, *_ = trainer.prepare_data(_data(graph), TrainConfig(**cfg_kw),
                                         device="cpu")
    assert x.dtype == torch.bfloat16 and jx.dtype == jnp.bfloat16
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    k = int(np.diff(graph[0].tocsr().indptr).max()) + 1
    ref = np.asarray(jops.x_agg)
    np.testing.assert_allclose(ops.x_agg.numpy(), ref, rtol=1e-5 * k ** 0.5,
                               atol=1e-5 * k ** 0.5 * np.abs(ref).max())
    variables, jres, jparams = _jax_split(graph, cfg_kw)
    res, params = _one_split(graph, cfg_kw, variables)
    _assert_split_close(res, params, jres, jparams, 1e-2, 1e-4)


def test_bad_feature_dtype_is_refused(graph):
    with pytest.raises(ValueError, match="feature_dtype"):
        trainer.prepare_data(_data(graph), TrainConfig(
            **dict(BASE, feature_dtype="float16")), device="cpu")


# ---------------------------------------------------------------------------
# Reordering and splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ("rcm", "degree"))
def test_locality_order_matches_jax(graph, method):
    got = locality_order(graph[0], method)
    np.testing.assert_array_equal(got, jax_locality_order(graph[0], method))
    assert got.dtype == np.int64
    with pytest.raises(ValueError, match="reorder"):
        locality_order(graph[0], "metis")


@pytest.mark.parametrize("method", ("rcm", "degree"))
def test_maybe_reorder_matches_jax(graph, method):
    """The permuted graph, features, labels and ``perm`` equal JAX's; a
    permuted graph is not permuted again."""
    cfg = TrainConfig(reorder=method)
    got = trainer.maybe_reorder(_data(graph), cfg)
    want = jtrainer.maybe_reorder(_data(graph, jax_side=True),
                                  JaxTrainConfig(reorder=method))
    np.testing.assert_array_equal(got.perm, want.perm)
    assert (got.adj != want.adj).nnz == 0
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert trainer.maybe_reorder(got, cfg) is got


def test_resolve_split_matches_jax(graph, tmp_path, monkeypatch):
    """Dataset-attached splits (index lists in original node ids, wrapped
    by ``idx % len``), the same after a locality reorder (masks permuted
    by ``perm``), random splits drawn in the permuted label space, and
    the mask files of a dataset without attached splits."""
    n = graph[0].shape[0]
    rng = np.random.default_rng(2)
    splits = [{k: rng.permutation(n)[:m] for k, m in
               (("train", 120), ("valid", 60), ("test", 60))}
              for _ in range(2)]
    for reorder in ("none", "rcm"):
        cfg = TrainConfig(reorder=reorder, fixed_splits=True)
        jcfg = JaxTrainConfig(reorder=reorder, fixed_splits=True)
        data = trainer.maybe_reorder(_data(graph, splits=splits), cfg)
        jdata = jtrainer.maybe_reorder(_data(graph, jax_side=True,
                                             splits=splits), jcfg)
        for idx in range(3):
            got = trainer.resolve_split(data, cfg, idx, None, data.labels, 2)
            want = jtrainer.resolve_split(jdata, jcfg, idx, None,
                                          jdata.labels, 2)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        rand = [f(d, dataclasses.replace(c, fixed_splits=False), 0,
                  np.random.default_rng(5), d.labels, 2)
                for f, d, c in ((trainer.resolve_split, data, cfg),
                                (jtrainer.resolve_split, jdata, jcfg))]
        for a, b in zip(*rand):
            np.testing.assert_array_equal(a, b)
    # without attached splits: the Geom-GCN mask files of the data roots
    root = tmp_path / "ACM-Pytorch" / "splits"
    root.mkdir(parents=True)
    monkeypatch.setenv("ACMGNN_DATA_PATH", str(tmp_path))
    masks = rng.random((3, n)) < 0.3
    np.savez(root / "g_split_0.6_0.2_1.npz", train_mask=masks[0],
             val_mask=masks[1], test_mask=masks[2])
    for reorder in ("none", "rcm"):
        cfg = TrainConfig(reorder=reorder, fixed_splits=True)
        jcfg = JaxTrainConfig(reorder=reorder, fixed_splits=True)
        data = trainer.maybe_reorder(_data(graph), cfg)
        jdata = jtrainer.maybe_reorder(_data(graph, jax_side=True), jcfg)
        got = trainer.resolve_split(data, cfg, 1, None, data.labels, 2)
        want = jtrainer.resolve_split(jdata, jcfg, 1, None, jdata.labels, 2)
        for a, b, m in zip(got, want, masks):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                a, m if data.perm is None else m[data.perm])


def test_card_check_of_bf16_knobs_is_well_conditioned():
    """chip_smoke.py phase 7c holds the card to the CPU within 1e-2 after
    20 epochs of bf16 features with bf16 GEMMs (``bf16_check_config``).
    Only a configuration that does not amplify rounding can show a fault
    that way: there, two summation orders of the CPU port (ELL and COO)
    part by less than a tenth of that."""
    import chip_smoke

    cfg0 = chip_smoke.bf16_check_config()
    assert (cfg0.feature_dtype, cfg0.gemm_dtype, cfg0.epochs) == \
        ("bfloat16", "bfloat16", 20)
    data = chip_smoke._small_twitch()
    params = []
    for fmt in ("ell", "coo"):
        cfg = dataclasses.replace(cfg0, operator_format=fmt)
        _, ops, x, y, _, nclass = trainer.prepare_data(data, cfg,
                                                       device="cpu")
        masks = trainer.resolve_split(data, cfg, 0,
                                      np.random.default_rng(cfg.seed),
                                      data.labels, nclass)
        model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                    seed=cfg.seed)
        trainer.make_split_runner(model, cfg)(
            ops, x, y, tuple(torch.from_numpy(m) for m in masks),
            seed=cfg.seed)
        params.append({k: p.detach() for k, p in model.named_parameters()})
    worst = max(float((params[0][k] - params[1][k]).abs().max())
                for k in params[0])
    assert worst < 1e-3, worst


def test_card_check_of_adamw_is_well_conditioned():
    """chip_smoke.py phase 7c holds AdamW's 20-epoch trajectory on the card
    to the CPU within 1e-4, the CPU running the card's optimizer
    arithmetic (``capturable=True``), at lr 1e-3 (``adamw_check_config``).
    There two summation orders of the CPU port (ELL and COO) under that
    arithmetic part by less than a tenth of the tolerance."""
    import chip_smoke

    cfg0 = chip_smoke.adamw_check_config()
    assert (cfg0.optimizer, cfg0.lr, cfg0.weight_decay, cfg0.epochs) == \
        ("adamw", 1e-3, 1e-3, 20)
    adj, feats, labels = twitch_gamers_scale_graph(0, n=2000, pairs=40_000)
    data = GraphData("small", adj, np.abs(feats), labels)
    masks = tuple(torch.from_numpy(m) for m in chip_smoke._masks(2000))
    params = []
    for fmt in ("ell", "coo"):
        cfg = dataclasses.replace(cfg0, operator_format=fmt)
        _, ops, x, y, _, nclass = trainer.prepare_data(data, cfg,
                                                       device="cpu")
        model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                    seed=3)
        _, state = trainer.make_split_runner(model, cfg, capturable=True)(
            ops, x, y, masks, return_state=True)
        assert state.opt_state["param_groups"][0]["capturable"]
        params.append({k: p.detach() for k, p in model.named_parameters()})
    worst = max(float((params[0][k] - params[1][k]).abs().max())
                for k in params[0])
    assert worst < 1e-5, worst


def test_adamw_at_lr_0_01_parts_at_a_relu_input_near_zero(monkeypatch):
    """Why 7c's AdamW trajectory runs at lr 1e-3: at phase 4's lr 0.01 the
    card parted from the CPU by 1.092e-2 after 20 epochs (H100 80GB HBM3,
    700 W, the model seeded 3), and so do two summation orders of the CPU
    port with no card involved (ELL and COO at 8 threads).  The two runs
    agree to rounding until one ReLU input lies within rounding of zero
    and takes opposite signs in them; from there the final parameters
    part past 1e-4.  Whether a realization meets such an input depends on
    the rounding: since the CPU's card form divides by lr as the card
    does (a multiply by its f32 reciprocal, not the CPU's division) the
    model seeded 3 crosses none in 20 epochs here, the one seeded 8 does.
    The optimizer's arithmetic at lr 0.01 is held apart from any
    trajectory (``test_optimizer_check_holds_the_cards_form``)."""
    import chip_smoke

    cfg0 = chip_smoke.knob_check_config(optimizer="adamw")
    assert (cfg0.lr, cfg0.weight_decay, cfg0.epochs) == (0.01, 1e-3, 20)
    adj, feats, labels = twitch_gamers_scale_graph(0, n=2000, pairs=40_000)
    data = GraphData("small", adj, np.abs(feats), labels)
    masks = tuple(torch.from_numpy(m) for m in chip_smoke._masks(2000))
    relu = torch.relu
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        for fmt in ("ell", "coo"):
            inputs = []

            def recorded(z):
                inputs.append(z.detach().clone())
                return relu(z)

            cfg = dataclasses.replace(cfg0, operator_format=fmt)
            _, ops, x, y, _, nclass = trainer.prepare_data(data, cfg,
                                                           device="cpu")
            model = trainer.build_model(cfg, x.shape[1], nclass,
                                        device="cpu", seed=8)
            monkeypatch.setattr(torch, "relu", recorded)
            trainer.make_split_runner(model, cfg, capturable=True)(
                ops, x, y, masks)
            monkeypatch.setattr(torch, "relu", relu)
            runs.append((inputs, {k: p.detach()
                                  for k, p in model.named_parameters()}))
    finally:
        torch.set_num_threads(threads)
    (za, pa), (zb, pb) = runs
    assert len(za) == len(zb)
    flips = [i for i, (a, b) in enumerate(zip(za, zb))
             if not torch.equal(a > 0, b > 0)]
    assert flips, "the two orders cross no ReLU input"
    first = flips[0]
    before = max(float((a - b).abs().max())
                 for a, b in zip(za[:first], zb[:first]))
    crossed = (za[first] > 0) != (zb[first] > 0)
    assert before < 1e-5, before
    assert float(za[first][crossed].abs().max()) < 1e-6
    assert float(zb[first][crossed].abs().max()) < 1e-6
    worst = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    assert worst > 1e-4, worst


@pytest.mark.parametrize("optimizer", ("adam", "adamw"))
def test_optimizer_check_holds_the_cards_form(optimizer):
    """chip_smoke.py's ``optimizer_check`` (7c: the card's optimizer at
    lr 0.01 against optax's update in f64) passes torch's capturable form,
    which the card runs, here on the CPU, and fails the same form against
    a reference with the decay left out."""
    import chip_smoke

    cfg = chip_smoke.knob_check_config(optimizer=optimizer)
    assert (cfg.lr, cfg.weight_decay) == (0.01, 1e-3)
    err, no_decay = chip_smoke.optimizer_check(cfg, "cpu", capturable=True)
    assert err <= 1.0, err
    assert no_decay > 10.0, no_decay


def test_ulp_nudged_moves_each_nonzero_feature_one_ulp():
    """chip_smoke.py's ``ulp_nudged`` (the inputs of 9c's ``cpu_witness``):
    each non-zero feature one ulp up or down, both directions drawn,
    zeros and the original left alone, the draw reproducible."""
    import chip_smoke

    rng = np.random.default_rng(0)
    feats = rng.random((50, 40)).astype(np.float32)
    feats[feats < 0.5] = 0.0
    data = GraphData("g", None, feats, np.zeros(50, np.int32))
    nudged = chip_smoke.ulp_nudged(data, 1).features
    nz = feats != 0
    assert np.array_equal(nudged[~nz], feats[~nz])
    up = np.nextafter(feats, np.float32(np.inf))
    down = np.nextafter(feats, np.float32(-np.inf))
    assert np.all((nudged[nz] == up[nz]) | (nudged[nz] == down[nz]))
    assert (nudged[nz] > feats[nz]).any() and (nudged[nz] < feats[nz]).any()
    assert np.array_equal(chip_smoke.ulp_nudged(data, 1).features, nudged)
    assert np.array_equal(data.features, feats)
