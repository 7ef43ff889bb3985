"""(lr, wd) as data: one split runner for every (lr, wd) pair, and one per
dropout value in the sweep, as the JAX package jits one runner per
dropout value with ``hparams`` traced.

- a second pair rewrites the optimizer's tensors, keeps the runner,
  equals a runner built for that pair bit for bit and JAX's
  ``make_split_runner(hparams=...)`` at dropout 0;
- the port's sweep builds one runner per dropout value and matches JAX's
  sweep on a 2 x 2 x 2 grid at the harness's ``1e-5·sqrt(reduction
  length)`` (a per-split accuracy: a mean over the N nodes' test mask).
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.train import sweep as jsweep
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train import sweep, trainer
from acmgnn_tpu_torch.train.config import TrainConfig

N = 300
# the headline model at test size: hidden 8, sequential loop
BASE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.0, lr=0.01, weight_decay=1e-3,
    epochs=6, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=False, hoist_first=True, num_splits=2, seed=3)


@pytest.fixture(scope="module")
def graph():
    adj, feats, labels = twitch_gamers_scale_graph(0, n=N, pairs=3000)
    return adj, np.abs(feats), labels


def _jax_inits(graph, cfg_kw):
    """JAX's initial variables of each split's seed (``fold_in(key(seed),
    idx)``), as the port's ``state_dict``s, by the split's seed."""
    jcfg = JaxTrainConfig(**cfg_kw)
    _, jops, jx, *_ = jtrainer.prepare_data(JaxGraphData("g", *graph), jcfg)
    jmodel = jtrainer.build_model(jcfg, 2, graph[0].shape[0])
    key = jax.random.key(jcfg.seed)
    return {jcfg.seed + idx: params_from_flax(jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.split(
            jax.random.fold_in(key, idx))[0], jx, jops)["params"]))
        for idx in range(jcfg.num_splits)}


def test_other_hparams_keep_the_runner(graph):
    """A second call with another (lr, wd), at dropout 0 from JAX's
    initial variables: the runner keeps what it made (no new runner),
    equals a runner built for that pair bit for bit, and matches JAX's
    runner with ``hparams`` (traced f32 scalars): test metric to 1e-6,
    val metric and val loss to 1e-5 (test_torch_experiment.py's)."""
    cfg_kw = dict(BASE, num_splits=1, epochs=8)
    init = _jax_inits(graph, cfg_kw)[cfg_kw["seed"]]
    cfg = TrainConfig(**cfg_kw)
    data, ops, x, y, y1h, nclass = trainer.prepare_data(
        GraphData("g", *graph), cfg, device="cpu")
    masks_np = trainer.resolve_split(data, cfg, 0, np.random.default_rng(0),
                                     data.labels, nclass)
    masks = tuple(torch.from_numpy(m) for m in masks_np)
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu")
    run = trainer.make_split_runner(model, cfg)
    run(ops, x, y, masks, labels_onehot=y1h, init_params=init)
    kept = run.kept()
    hp = (0.05, 5e-4)
    res = run(ops, x, y, masks, labels_onehot=y1h, init_params=init,
              hparams=hp)
    assert run.kept() is kept and run.captures == []
    params = {k: v.clone() for k, v in model.state_dict().items()}
    fresh_cfg = TrainConfig(**dict(cfg_kw, lr=hp[0], weight_decay=hp[1]))
    fresh = trainer.make_split_runner(model, fresh_cfg)(
        ops, x, y, masks, labels_onehot=y1h, init_params=init)
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert torch.equal(getattr(res, f), getattr(fresh, f)), f
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v), k

    jcfg = JaxTrainConfig(**cfg_kw)
    jdata, jops, jx, jy, jy1h, jnclass = jtrainer.prepare_data(
        JaxGraphData("g", *graph), jcfg)
    jmodel = jtrainer.build_model(jcfg, jnclass, N)
    variables = jmodel.init(jax.random.split(jax.random.fold_in(
        jax.random.key(jcfg.seed), 0))[0], jx, jops)
    jres = jax.jit(jtrainer.make_split_runner(jmodel, jcfg))(
        variables, jax.random.key(1), jops, jx, jy, jy1h,
        tuple(jnp.asarray(m) for m in masks_np),
        (jnp.asarray(hp[0], jnp.float32), jnp.asarray(hp[1], jnp.float32)))
    assert res.epochs_run == int(jres.epochs_run)
    assert float(res.test_metric) == pytest.approx(float(jres.test_metric),
                                                   abs=1e-6)
    for f in ("val_metric", "val_loss"):
        assert float(getattr(res, f)) == pytest.approx(
            float(getattr(jres, f)), rel=1e-5, abs=1e-5), f


GRID = {"lr": [0.01, 0.05], "weight_decay": [0.0, 5e-4],
        "dropout": [0.0, 0.5]}


def test_sweep_builds_one_runner_per_dropout_and_matches_jax(graph, tmp_path,
                                                             monkeypatch):
    """The 2 x 2 x 2 grid, 2 splits x 6 epochs, every split from JAX's
    initial variables: the port's sweep builds one runner per dropout
    value (2), each keeping what it made across its four (lr, wd) points;
    at dropout 0 every point's per-split test accuracy matches JAX's
    sweep within ``1e-5·sqrt(N)``; at dropout 0.5 the two frameworks draw
    from different generator families (threefry, Philox), so each point
    is held bit for bit to the port's own ``run_experiment`` of that
    configuration (a runner of its own)."""
    cfg_kw = dict(BASE)
    inits = _jax_inits(graph, cfg_kw)
    monkeypatch.setattr(trainer, "initial_params",
                        lambda cfg, nfeat, nclass, *, seed, nnodes=None:
                        inits[seed])
    make = trainer.make_split_runner
    kept = []

    def recorded(model, cfg, **kw):
        runner = make(model, cfg, **kw)
        seen = []
        kept.append((cfg.dropout, seen))

        def call(*args, **kwargs):
            out = runner(*args, **kwargs)
            seen.append(runner.kept())
            return out
        call.release, call.model = runner.release, runner.model
        return call

    monkeypatch.setattr(trainer, "make_split_runner", recorded)
    out = tmp_path / "grid.json"
    sweep.grid_search(GraphData("g", *graph), TrainConfig(**cfg_kw), GRID,
                      out_path=out, device="cpu")
    results = json.loads(out.read_text())["grid"]
    assert [d for d, _ in kept] == [0.0, 0.5]
    for _, seen in kept:
        assert len(seen) == 4 * 2 and all(k is seen[0] for k in seen)
    monkeypatch.setattr(trainer, "make_split_runner", make)

    jresults = []
    jrun = jtrainer.run_experiment

    def jrecord(*args, **kwargs):
        res = jrun(*args, **kwargs)
        jresults.append(res)
        return res

    monkeypatch.setattr(jsweep, "run_experiment", jrecord)
    jsweep.grid_search(JaxGraphData("g", *graph), JaxTrainConfig(**cfg_kw),
                       GRID)
    assert len(results) == len(jresults) == 8
    tol = 1e-5 * math.sqrt(N)
    for got, want in zip(results, jresults):
        cfg = got["config"]
        if cfg["dropout"] == 0.0:
            assert got["per_split"] == pytest.approx(want["per_split"],
                                                     abs=tol), cfg
            assert got["epochs_total"] == want["epochs_total"]
        else:
            ref = trainer.run_experiment(GraphData("g", *graph),
                                         TrainConfig(**cfg), device="cpu")
            assert got["per_split"] == ref["per_split"], cfg


@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 0.0),
                                                    ("adam", 1e-3),
                                                    ("adamw", 1e-2)])
def test_card_form_is_torchs_capturable_step(optimizer, weight_decay,
                                             monkeypatch):
    """``make_optimizer(..., capturable=True)`` (lr and decay as device
    data, the step written out) equals torch's capturable multi-tensor
    Adam/AdamW with Python hyperparameters, as the card runs it, bit for
    bit over 20 steps: on the CPU the reference's foreach division by a
    Python number is made the card's, a multiply by its f32 reciprocal
    (read on an H100, torch 2.11; the card's own test holds the CUDA
    form), and torch's device check is widened to the CPU.  A second
    (lr, wd) written with ``set_hparams`` equals an optimizer built with
    it; the host form (not capturable) equals torch's own step."""
    import importlib

    for name in ("torch.optim.adam", "torch.optim.adamw"):
        mod = importlib.import_module(name)
        if hasattr(mod, "_get_capturable_supported_devices"):
            check = mod._get_capturable_supported_devices
            monkeypatch.setattr(mod, "_get_capturable_supported_devices",
                                lambda *a, _c=check, **k: [*_c(*a, **k),
                                                           "cpu"])
    rng = np.random.default_rng(2)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((64, 7), (64,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 1e-3
              for p in p0] for _ in range(20)]
    cfg = TrainConfig(optimizer=optimizer, lr=1e-3, weight_decay=weight_decay)
    cls = torch.optim.Adam if optimizer == "adam" else torch.optim.AdamW

    def run(make):
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        opt = make(ps)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
        return ps

    def rewritten(ps):
        opt = trainer.make_optimizer(
            TrainConfig(optimizer=optimizer, lr=0.05, weight_decay=0.1), ps,
            capturable=True)
        opt.set_hparams(1e-3, weight_decay)
        return opt

    ours = [run(lambda ps: trainer.make_optimizer(cfg, ps, capturable=True)),
            run(rewritten)]
    div = torch._foreach_div_

    def card_div(tensors, other):
        if isinstance(other, (int, float)):
            return torch._foreach_mul_(
                tensors, torch.tensor(1.0 / other, dtype=torch.float32))
        return div(tensors, other)

    monkeypatch.setattr(torch, "_foreach_div_", card_div)
    ref = run(lambda ps: cls(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay, capturable=True,
                             foreach=True))
    for got in ours:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    monkeypatch.setattr(torch, "_foreach_div_", div)
    host = run(lambda ps: trainer.make_optimizer(cfg, ps))
    for a, b in zip(host, run(lambda ps: cls(
            ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay))):
        assert torch.equal(a, b)
