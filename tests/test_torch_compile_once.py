"""One capture a run: the port's loops set up once and rewritten in place.

JAX compiles each loop once a run: ``run_experiment`` jits its split
runner outside the split loop and passes each split new ``variables``,
and ``run_experiment_stepwise`` jits ``train_epoch`` / ``eval_epoch``
once.  The port keeps one model and one split runner a run
(``make_split_runner``: its optimizer, dropout seed tensor, ``LoopState``
and mask buffers made once, each later split and segment written into them
in place), and one model, optimizer and dropout key for the stepwise path.  On
the card that is what lets one CUDA graph serve the whole run; the CPU
runs the same code eagerly, so these tests hold its in-place rewrites:

- ``run_experiment`` with its one runner against a fresh model and
  runner a split, bit for bit (joint and sequential, NLL/accuracy and
  BCE/ROC-AUC, dropout 0.5, 3 splits, and an early stop that fires in
  split 0 and not in split 1), and against JAX's ``run_experiment`` at
  dropout 0 (test_torch_experiment.py's tolerances);
- every tensor a capture reads or writes keeps its identity and storage
  across splits, segments and a resume from disk;
- the stepwise path built once a run against a loop written here with a
  fresh model, optimizer and ``DropoutKey`` per split and epoch, bit for
  bit, and a resume cut inside split 1 against the uninterrupted run;
- a transient failure in split 1 retried gives the undisturbed result.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import pytest

import jax
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu_torch.data.synthetic_scale import (
    linkx_scale_graph,
    twitch_gamers_scale_graph,
)
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.dropout import DropoutKey
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.metrics import pack_labels_and_masks
from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

# the headline model at test size: hidden 8, dropout 0.5, f32 gathers
BASE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.5, lr=0.01, weight_decay=1e-3,
    epochs=10, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=True, hoist_first=True, num_splits=3, seed=3)
ROCAUC = dict(BASE, model_type="acmgcn", metric="rocauc", loss="bce")

# (graph, configuration); in "sequential_stop_in_split_0" the stop rule
# fires in split 0 (epoch 5) and not in split 1 (nor does it in 18 epochs)
RUN_CASES = {
    "joint_acc": ("twitch", BASE),
    "sequential_acc": ("twitch", dict(BASE, joint=False)),
    "joint_rocauc": ("genius", ROCAUC),
    "sequential_rocauc": ("genius", dict(ROCAUC, joint=False)),
    "sequential_stop_in_split_0": ("twitch", dict(
        BASE, joint=False, epochs=18, early_stopping=3,
        selection="val_loss", seed=29)),
}


@pytest.fixture(scope="module")
def graphs():
    adj, feats, labels = twitch_gamers_scale_graph(0, n=300, pairs=3000)
    g_adj, g_feats, g_labels = linkx_scale_graph("genius", n=400, e=1000,
                                                 max_deg=60)
    return {"twitch": (adj, np.abs(feats), labels),
            "genius": (g_adj, np.abs(g_feats), g_labels)}


class _Log:
    """Records each split's result, the per-epoch rows logged at
    ``display_step=1`` and the result dict."""

    def __init__(self):
        self.splits, self.rows, self.out = [], [], None

    def info(self, msg, *args):
        if "epoch" in msg and "resumed" not in msg:
            self.rows.append(args)

    def log_split(self, idx, res):
        self.splits.append(res)

    def log_result(self, out):
        self.out = out


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _results_equal(a, b):
    assert a.epochs_run == b.epochs_run
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _tree_equal(a, b, what=""):
    """Nested dicts and lists of tensors and numbers, equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tree_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{what}/{i}")
    else:
        assert a == b, what


# ---------------------------------------------------------------------------
# run_experiment: one runner a run
# ---------------------------------------------------------------------------


def _one_runner_run(graph, cfg, monkeypatch):
    """``run_experiment`` as it runs (one model, one runner), with the
    model's parameters recorded after each split: (result dict, split
    results, parameters by split, runners made)."""
    made, params = [], []
    make = trainer.make_split_runner

    def recorded(model, cfg, **kw):
        runner = make(model, cfg, **kw)
        made.append(runner)

        def run(*args, **kwargs):
            res = runner(*args, **kwargs)
            params.append(_params(model))
            return res
        return run

    monkeypatch.setattr(trainer, "make_split_runner", recorded)
    log = _Log()
    out = trainer.run_experiment(GraphData("g", *graph), cfg, device="cpu",
                                 logger=log)
    monkeypatch.setattr(trainer, "make_split_runner", make)
    return out, log.splits, params, made


def _fresh_runner_run(graph, cfg):
    """The same run with a new model and a new runner for every split,
    each built from the split's seed (the port's form before one runner a
    run)."""
    params = []
    nclass = int(np.max(graph[2])) + 1

    def fresh(model, ops, x, labels, masks, *, seed, labels_onehot,
              hparams):
        mdl = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                  seed=seed, nnodes=x.shape[0])
        res = trainer.make_split_runner(mdl, cfg)(
            ops, x, labels, masks, seed=seed, labels_onehot=labels_onehot,
            hparams=hparams)
        params.append(_params(mdl))
        return res

    log = _Log()
    out = trainer.run_experiment(GraphData("g", *graph), cfg, device="cpu",
                                 runner=fresh, logger=log)
    return out, log.splits, params


@pytest.mark.parametrize("case", tuple(RUN_CASES))
def test_one_runner_a_run_equals_a_runner_a_split(graphs, case,
                                                  monkeypatch):
    """Each split's result (best metrics, last train loss, ``epochs_run``)
    and final parameters, and the result dict's per-split metrics, equal
    bit for bit; the run made one runner."""
    name, cfg_kw = RUN_CASES[case]
    cfg = TrainConfig(**cfg_kw)
    out, splits, params, made = _one_runner_run(graphs[name], cfg,
                                                monkeypatch)
    ref, ref_splits, ref_params = _fresh_runner_run(graphs[name], cfg)
    assert len(made) == 1 and len(splits) == cfg.num_splits == 3
    for a, b in zip(splits, ref_splits):
        _results_equal(a, b)
    for a, b in zip(params, ref_params):
        _tree_equal(a, b)
    assert out["per_split"] == ref["per_split"]
    assert out["epochs_total"] == ref["epochs_total"]
    if case == "sequential_stop_in_split_0":
        assert splits[0].epochs_run < cfg.epochs
        assert splits[1].epochs_run == cfg.epochs


JAX_CASES = ("joint_acc", "sequential_rocauc", "sequential_stop")


@pytest.mark.parametrize("case", JAX_CASES)
def test_one_runner_a_run_matches_jax(graphs, case):
    """At dropout 0, JAX's ``run_experiment`` against the port's with one
    runner for the run (its hook reuses the runner made at split 0 on the
    run's one model, each split from JAX's initial variables): equal masks,
    per-split test metric to 1e-6, best val metric to 1e-5, equal
    ``epochs_run`` (the early stops included) and result keys."""
    if case == "sequential_stop":
        name, cfg_kw = "twitch", dict(BASE, joint=False, epochs=40,
                                      early_stopping=3, lr=0.05,
                                      selection="val_loss")
    else:
        name, cfg_kw = RUN_CASES[case]
    cfg_kw = dict(cfg_kw, dropout=0.0)
    graph = graphs[name]
    jcfg = JaxTrainConfig(**cfg_kw)
    jmodel = jtrainer.build_model(jcfg, int(graph[2].max()) + 1,
                                  graph[0].shape[0])
    jrun = jax.jit(jtrainer.make_split_runner(jmodel, jcfg))
    jseen = []

    def jhook(variables, key, ops, x, labels, labels_onehot, masks):
        res = jrun(variables, key, ops, x, labels, labels_onehot, masks)
        jseen.append((variables, [np.asarray(m) for m in masks], res))
        return res

    jout = jtrainer.run_experiment(JaxGraphData("g", *graph), jcfg,
                                   runner=jhook)
    cfg = TrainConfig(**cfg_kw)
    seen, runners, models = [], [], []

    def hook(model, ops, x, labels, masks, *, seed, labels_onehot, hparams):
        params = jseen[len(seen)][0]["params"]
        model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
            np.asarray, params)))
        if not runners:
            runners.append(trainer.make_split_runner(model, cfg))
        models.append(model)
        res = runners[0](ops, x, labels, masks, seed=seed,
                         labels_onehot=labels_onehot, hparams=hparams)
        seen.append(([m.numpy() for m in masks], res))
        return res

    out = trainer.run_experiment(GraphData("g", *graph), cfg, runner=hook,
                                 device="cpu")
    assert len(seen) == len(jseen) == 3
    assert all(m is models[0] for m in models)
    for (_, jmasks, jres), (masks, res) in zip(jseen, seen):
        for a, b in zip(jmasks, masks):
            np.testing.assert_array_equal(a, b)
        assert res.epochs_run == int(jres.epochs_run)
        assert float(res.test_metric) == pytest.approx(
            float(jres.test_metric), abs=1e-6)
        assert float(res.val_metric) == pytest.approx(
            float(jres.val_metric), rel=1e-5, abs=1e-5)
    if case == "sequential_stop":
        assert any(res.epochs_run < cfg.epochs for _, res in seen)
    assert set(out) == set(jout)
    assert out["per_split"] == pytest.approx(jout["per_split"], abs=1e-6)


# ---------------------------------------------------------------------------
# the tensors a capture holds keep their storage
# ---------------------------------------------------------------------------


def _storage(model, runner):
    """Every tensor the runner's body reads or writes, by name: (the
    object's id, its storage address)."""
    kept = runner.kept()
    named = {f"model/{k}": v for k, v in model.named_parameters()}
    named.update({f"buffer/{k}": v for k, v in model.named_buffers()})
    for i, p in enumerate(model.parameters()):
        for k, v in kept.opt.state[p].items():
            named[f"opt/{i}/{k}"] = v
    for f in dataclasses.fields(kept.state):
        named[f"loop/{f.name}"] = getattr(kept.state, f.name)
    for i, m in enumerate(kept.masks):
        named[f"mask/{i}"] = m
    named["packed"] = kept.packed
    named["dropout/seed"] = kept.drop.seed
    named["loop/limit"] = kept.limit
    named["opt/hparams"] = kept.opt.hp
    return {k: (id(v), v.data_ptr()) for k, v in named.items()}


def test_runner_keeps_its_tensors_across_splits_segments_and_resume(
        graphs, tmp_path):
    """acmgcnpp with BatchNorm (``init_layers_X`` 2), remat (the recompute
    keyed as its forward), BCE + ROC-AUC (the packed words), early
    stopping: after split 0, split 1 (other masks, seed and initial
    parameters), split 1 in segments and split 1 resumed from a snapshot
    on disk (the state alone: no generator state exists), every
    parameter, BatchNorm buffer, optimizer state tensor, ``LoopState``
    tensor, mask buffer, the packed words, the dropout seed tensor, the
    loop's bound and the optimizer's hyperparameter tensor keep their
    identity and storage; the segmented and the resumed split equal the
    uninterrupted one bit for bit."""
    cfg = TrainConfig(**dict(ROCAUC, model_type="acmgcnpp", init_layers_X=2,
                             remat=True, epochs=12, early_stopping=8))
    data, ops, x, y, y1h, nclass = trainer.prepare_data(
        GraphData("g", *graphs["genius"]), cfg, device="cpu")
    rng = np.random.default_rng(0)
    masks = [tuple(torch.from_numpy(m) for m in trainer.resolve_split(
        data, cfg, idx, rng, data.labels, nclass)) for idx in range(2)]
    inits = [trainer.initial_params(cfg, x.shape[1], nclass, seed=s,
                                    nnodes=x.shape[0]) for s in (0, 1)]
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                nnodes=x.shape[0])
    runner = trainer.make_split_runner(model, cfg)

    def call(idx, **kw):
        return runner(ops, x, y, masks[idx], seed=idx, labels_onehot=y1h,
                      return_state=True, **kw)

    call(0, init_params=inits[0])
    kept, ref = runner.kept(), _storage(model, runner)
    whole, whole_state = call(1, init_params=inits[1])
    whole_params = _params(model)
    assert _storage(model, runner) == ref
    _, st = call(1, init_params=inits[1], epoch_limit=4)
    _, st = call(1, init_state=st.runner, epoch_limit=8)
    assert _storage(model, runner) == ref
    prefix = str(tmp_path / "split1")
    trainer.save_checkpoint(f"{prefix}_state", st.runner.variables,
                            opt_state=st.runner.opt_state,
                            step=st.runner.bodies,
                            extra={"loop": dataclasses.asdict(st.runner.loop)})
    restored = trainer._restore_segment(f"{prefix}_state", "cpu")
    for init in (st.runner, restored):
        res, state = call(1, init_state=init)
        assert _storage(model, runner) == ref
        _results_equal(res, whole)
        assert torch.equal(state.train_losses, whole_state.train_losses)
        _tree_equal(_params(model), whole_params)
        _tree_equal(state.opt_state, whole_state.opt_state)
    assert runner.kept() is kept and runner.captures == []


# ---------------------------------------------------------------------------
# the stepwise path: set up once a run
# ---------------------------------------------------------------------------

STEP_CASES = {
    "acc": ("twitch", dict(BASE, epochs=6, num_splits=2, joint=False)),
    "rocauc_remat": ("genius", dict(ROCAUC, epochs=6, num_splits=2,
                                    joint=False, remat=True)),
}


def _reference_stepwise(graph, cfg):
    """The stepwise path as a loop written here: a fresh model (the split's
    seed), a fresh optimizer and epoch functions for each split, a fresh
    ``DropoutKey`` (the split's seed, the epoch) for each epoch.  Returns the per-epoch rows
    (split, epoch, loss, train, val, test) and each split's final
    parameters and optimizer state."""
    data, ops, x, y, y1h, nclass = trainer.prepare_data(
        GraphData("g", *graph), cfg, device="cpu")
    rng = np.random.default_rng(cfg.seed)
    labels = trainer._host_labels(data.labels)
    rows, finals = [], []
    for idx in range(cfg.num_splits):
        masks = tuple(torch.from_numpy(m) for m in trainer.resolve_split(
            data, cfg, idx, rng, labels, nclass))
        packed = (pack_labels_and_masks(y, masks) if cfg.metric == "rocauc"
                  else None)
        model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                    seed=cfg.seed + idx, nnodes=x.shape[0])
        opt = trainer.make_optimizer(cfg, list(model.parameters()))
        train_epoch, eval_epoch = trainer.make_epoch_fns(model, cfg)
        for epoch in range(cfg.epochs):
            key = DropoutKey.new(cfg.seed + idx, 0, torch.tensor(epoch))
            loss = train_epoch(opt, key, ops, x, y, y1h, masks[0])
            ev = eval_epoch(ops, x, y, y1h, masks, packed)
            rows.append((idx, epoch, float(loss), float(ev["train_metric"]),
                         float(ev["val_metric"]), float(ev["test_metric"])))
        finals.append((_params(model), copy.deepcopy(opt.state_dict())))
    return rows, finals


def _stepwise(graph, cfg, ckpt, every, resume=False):
    log = _Log()
    out = trainer.run_experiment_stepwise(
        GraphData("g", *graph), cfg, logger=log, display_step=1,
        checkpoint_dir=str(ckpt), checkpoint_every=every, resume=resume,
        device="cpu")
    return out, log


@pytest.mark.parametrize("case", tuple(STEP_CASES))
def test_stepwise_built_once_equals_a_build_a_split(graphs, case, tmp_path,
                                                    monkeypatch):
    """Dropout 0.5, 2 splits: every epoch's (loss, train, val, test) and
    each split's final parameters, Adam's moments and step equal the
    reference loop's bit for bit; the run made one model and one
    optimizer, whose parameters and state tensors keep their storage
    across the splits."""
    name, cfg_kw = STEP_CASES[case]
    cfg = TrainConfig(**cfg_kw)
    rows, finals = _reference_stepwise(graphs[name], cfg)
    make = trainer.make_epoch_fns
    seen = []

    def recorded(model, cfg):
        train_epoch, eval_epoch = make(model, cfg)

        def train(opt, *args, **kwargs):
            seen.append((id(model), id(opt)))
            loss = train_epoch(opt, *args, **kwargs)
            seen.append(tuple(t.data_ptr() for t in (
                *model.parameters(), *model.buffers(),
                *(v for st in opt.state.values() for v in st.values()))))
            return loss
        return train, eval_epoch

    monkeypatch.setattr(trainer, "make_epoch_fns", recorded)
    _, log = _stepwise(graphs[name], cfg, tmp_path, cfg.epochs)
    assert len(set(seen[0::2])) == 1 and len(set(seen[1::2])) == 1
    assert len(seen) == 2 * cfg.num_splits * cfg.epochs
    assert log.rows == rows
    for idx, (params, opt_state) in enumerate(finals):
        snap = restore_checkpoint(tmp_path / f"split{idx}_last")
        _tree_equal(snap["variables"], params, f"split {idx}")
        _tree_equal(snap["opt_state"], opt_state, f"split {idx}")


class _Cut(Exception):
    pass


def test_stepwise_resume_inside_split_1_is_bit_exact(graphs, tmp_path,
                                                     monkeypatch):
    """Dropout 0.5, 2 splits x 8 epochs, snapshots every 2: cut after
    split 1's snapshot at epoch 4 (its weights, optimizer and history
    written), then resumed, the run's result, every
    split's last snapshot (weights, Adam's moments and step, best val),
    best weights and history equal the uninterrupted run's bit for bit."""
    name, cfg_kw = STEP_CASES["rocauc_remat"]
    cfg = TrainConfig(**dict(cfg_kw, epochs=8))
    whole, _ = _stepwise(graphs[name], cfg, tmp_path / "whole", 2)
    save, forward = trainer.save_checkpoint, trainer.train_forward
    cut = []

    def save_then_mark(path, *args, step=0, **kwargs):
        out = save(path, *args, step=step, **kwargs)
        if str(path).endswith("split1_last") and step == 4:
            cut.append(path)
        return out

    def forward_or_cut(*args, **kwargs):   # the next epoch, after the history
        if cut:
            raise _Cut(cut[0])
        return forward(*args, **kwargs)

    monkeypatch.setattr(trainer, "save_checkpoint", save_then_mark)
    monkeypatch.setattr(trainer, "train_forward", forward_or_cut)
    with pytest.raises(_Cut):
        _stepwise(graphs[name], cfg, tmp_path / "cut", 2)
    monkeypatch.setattr(trainer, "save_checkpoint", save)
    monkeypatch.setattr(trainer, "train_forward", forward)
    resumed, log = _stepwise(graphs[name], cfg, tmp_path / "cut", 2,
                             resume=True)
    assert [r[:2] for r in log.rows] == [(1, e) for e in range(4, 8)]
    for k in ("test_mean", "test_std", "valid_mean", "valid_std",
              "per_split", "epochs_total"):
        assert resumed[k] == whole[k], k
    for idx in range(2):
        for f in ("last", "best"):
            _tree_equal(restore_checkpoint(tmp_path / "cut" / f"split{idx}_{f}"),
                        restore_checkpoint(tmp_path / "whole" / f"split{idx}_{f}"),
                        f"split{idx}_{f}")
        np.testing.assert_array_equal(
            np.load(tmp_path / "cut" / f"split{idx}_history.npy"),
            np.load(tmp_path / "whole" / f"split{idx}_history.npy"))


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------


def _fail_once_at(monkeypatch, call: int):
    """``train_forward`` raises a transient error at its ``call``-th call
    (before it draws or computes anything), once; retries do not wait."""
    forward = trainer.train_forward
    calls = [0]

    def flaky(*args, **kwargs):
        calls[0] += 1
        if calls[0] == call:
            raise RuntimeError("UNAVAILABLE: an injected failure")
        return forward(*args, **kwargs)

    monkeypatch.setattr(trainer, "train_forward", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    return calls


@pytest.mark.parametrize("case", ("joint_acc", "sequential_rocauc"))
def test_retry_in_split_1_gives_the_undisturbed_result(graphs, case,
                                                       monkeypatch):
    """A transient failure in split 1's third body: the split is retried
    by ``run_experiment`` and every split's result equals the undisturbed
    run's bit for bit."""
    name, cfg_kw = RUN_CASES[case]
    cfg = TrainConfig(**dict(cfg_kw, num_splits=2))
    data = GraphData("g", *graphs[name])
    clean = _Log()
    trainer.run_experiment(data, cfg, device="cpu", logger=clean)
    bodies = cfg.epochs + (1 if cfg.joint else 0)
    calls = _fail_once_at(monkeypatch, bodies + 3)
    retried = _Log()
    trainer.run_experiment(data, cfg, device="cpu", logger=retried)
    assert calls[0] == 2 * bodies + 3
    for a, b in zip(retried.splits, clean.splits):
        _results_equal(a, b)


def test_stepwise_retry_in_split_1_gives_the_undisturbed_result(
        graphs, tmp_path, monkeypatch):
    """A transient failure at the start of split 1's third epoch: the
    epoch is retried (from the parameters it found, which it had not yet
    changed) and every epoch's row and the result equal the undisturbed
    run's bit for bit."""
    name, cfg_kw = STEP_CASES["rocauc_remat"]
    cfg = TrainConfig(**cfg_kw)
    clean, clean_log = _stepwise(graphs[name], cfg, tmp_path / "a", 0)
    calls = _fail_once_at(monkeypatch, cfg.epochs + 3)
    retried, log = _stepwise(graphs[name], cfg, tmp_path / "b", 0)
    assert calls[0] == 2 * cfg.epochs + 1
    assert log.rows == clean_log.rows
    assert retried["per_split"] == clean["per_split"]
