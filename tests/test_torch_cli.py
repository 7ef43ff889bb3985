"""The port's command line and run utilities against acmgnn_tpu's, on the
CPU (``--device cpu``), on a small Geom-GCN-format dataset each test writes
under ``tmp_path`` (``ACMGNN_DATA_PATH``):

- ``config_from_args`` gives JAX's ``TrainConfig`` field for field;
- ``train`` gives the JAX CLI's per-split test metrics within one test
  node's share, the port's splits started from JAX's initial parameters
  (the two frameworks draw different ones), at dropout 0, lr 1e-3 and no
  weight decay (a configuration that does not amplify rounding:
  ROADMAP.md §C);
- ``train_single_split`` gives JAX's parameters within
  ``1e-5·sqrt(reduction length)``;
- a stepwise run cut short and resumed equals the uninterrupted run under
  ``torch.equal`` (acmgcnpp: BatchNorm buffers in the snapshot);
- ``predict``, ``homophily``, ``sweep``, ``gen-graphs``, ``gen-feats``,
  ``synthetic-train``, ``--profile_dir`` and the refusals.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

import jax
import torch

from acmgnn_tpu import cli as jcli
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu_torch import cli
from acmgnn_tpu_torch.data.registry import load_dataset
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.train import sweep, trainer
from acmgnn_tpu_torch.utils import profiling
from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

N, F, C = 48, 12, 3


@pytest.fixture()
def root(tmp_path, monkeypatch):
    """A texas-named Geom-GCN dataset (node ids out of order, binary
    features, labels from the features) with two fixed split files."""
    monkeypatch.setenv("ACMGNN_DATA_PATH", str(tmp_path))
    rng = np.random.default_rng(0)
    d = tmp_path / "new_data" / "texas"
    d.mkdir(parents=True)
    feats = (rng.random((N, F)) < 0.35).astype(int)
    labels = np.argmax(feats @ rng.normal(size=(F, C)), axis=1)
    ids = rng.permutation(N) + 100
    with open(d / "out1_graph_edges.txt", "w") as fh:
        fh.write("node_id\tnode_id\n")
        for u, v in rng.integers(0, N, size=(150, 2)):
            fh.write(f"{ids[u]}\t{ids[v]}\n")
    with open(d / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        for i in rng.permutation(N):
            fh.write(f"{ids[i]}\t{','.join(map(str, feats[i]))}\t"
                     f"{labels[i]}\n")
    s = tmp_path / "ACM-Pytorch" / "splits"
    s.mkdir(parents=True)
    for i in range(2):
        perm = rng.permutation(N)
        masks = [np.isin(np.arange(N), perm[a:b])
                 for a, b in ((0, 24), (24, 36), (36, N))]
        np.savez(s / f"texas_split_0.6_0.2_{i}.npz",
                 **dict(zip(("train_mask", "val_mask", "test_mask"), masks)))
    return tmp_path


def _run(main, argv):
    """``main(argv)`` with stdout captured; returns its last line's JSON
    (None when it is not JSON)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    try:
        return json.loads(buf.getvalue().strip().splitlines()[-1])
    except json.JSONDecodeError:
        return None


@contextlib.contextmanager
def recording(monkeypatch, module, name):
    """Wrap ``module.name`` to append every return value to the yielded
    list."""
    seen, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)
    yield seen
    monkeypatch.setattr(module, name, fn)


def _args(parser_of, argv):
    """Parse ``argv`` the way ``main`` does (``parser_of``: a CLI module),
    through ``main`` with the subcommand's function replaced."""
    got = []
    orig = parser_of.cmd_train
    parser_of.cmd_train = got.append
    try:
        parser_of.main(["train"] + argv)
    finally:
        parser_of.cmd_train = orig
    return got[0]


# ---------------------------------------------------------------------------
# config_from_args
# ---------------------------------------------------------------------------

ARGVS = {
    "defaults": [],
    "genius_rocauc": ["--dataset", "genius", "--fixed_splits", "1",
                      "--joint", "1", "--hoist_first", "1",
                      "--spmm_dtype", "bfloat16", "--operator_format", "ell"],
    "deezer_forced": ["--dataset", "deezer-europe", "--epochs", "20"],
    "aliases": ["--dataset_name", "chameleon", "--method", "acmgcnpp",
                "--hidden_channels", "32", "--runs", "3", "--nlayers", "2",
                "--link_init_layers_X", "2", "--structure_info", "1",
                "--variant", "1"],
    "knobs": ["--optimizer", "adamw", "--selection", "val_metric",
              "--rocauc", "--normalization", "sym", "--reorder", "rcm",
              "--remat", "1", "--feature_dtype", "bfloat16", "--gemm_dtype",
              "bfloat16", "--hoist_agg_dtype", "float32", "--directed",
              "--sub_dataset", "DE", "--partition", "fennel", "--hops", "3",
              "--alpha", "0.3", "--lamda", "0.7", "--seed", "7"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_config_from_args_matches_jax(case):
    argv = ARGVS[case]
    want = dataclasses.asdict(jcli.config_from_args(_args(jcli, argv)))
    got = dataclasses.asdict(cli.config_from_args(_args(cli, argv)))
    assert got == want
    if case == "genius_rocauc":
        assert (got["metric"], got["loss"], got["selection"]) == \
            ("rocauc", "bce", "val_metric")
    if case == "deezer_forced":
        assert (got["optimizer"], got["epochs"], got["fixed_splits"]) == \
            ("adamw", 500, True)


# ---------------------------------------------------------------------------
# train, against the JAX CLI
# ---------------------------------------------------------------------------

TRAIN = ["--dataset", "texas", "--fixed_splits", "1", "--num_splits", "2",
         "--epochs", "20", "--early_stopping", "0", "--dropout", "0",
         "--lr", "1e-3", "--weight_decay", "0", "--hidden", "16",
         "--model", "acmgcnp"]


def _jax_inits(argv, num_splits):
    """JAX's run_experiment's initial variables of each split:
    ``model.init(split(fold_in(key(seed), idx))[0], ...)``."""
    jcfg = jcli.config_from_args(_args(jcli, argv))
    _, jops, jx, _, _, nclass = jtrainer.prepare_data("texas", jcfg)
    jmodel = jtrainer.build_model(jcfg, nclass, N)
    key = jax.random.key(jcfg.seed)
    return [jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.split(jax.random.fold_in(key, idx))[0], jx, jops))
        for idx in range(num_splits)]


def _from_inits(monkeypatch, inits, cfg_seed):
    build = trainer.build_model

    def from_jax(cfg, nfeat, nclass, *, device=None, seed=0, nnodes=None):
        model = build(cfg, nfeat, nclass, device=device, seed=seed,
                      nnodes=nnodes)
        model.load_state_dict(params_from_flax(inits[seed - cfg_seed]))
        return model

    monkeypatch.setattr(trainer, "build_model", from_jax)


def test_cli_train_matches_jax_cli(root, monkeypatch, tmp_path):
    argv = ["train"] + TRAIN + ["--log_dir", str(tmp_path / "logs")]
    with recording(monkeypatch, jtrainer, "run_experiment") as jouts:
        jline = _run(jcli.main, argv)
    _from_inits(monkeypatch, _jax_inits(TRAIN, 2), 42)
    with recording(monkeypatch, trainer, "run_experiment") as outs:
        line = _run(cli.main, argv + ["--device", "cpu"])
    assert set(line) == set(jline)
    n_test = min(int(np.load(root / "ACM-Pytorch" / "splits" /
                             f"texas_split_0.6_0.2_{i}.npz")["test_mask"].sum())
                 for i in range(2))
    np.testing.assert_allclose(outs[0]["per_split"], jouts[0]["per_split"],
                               atol=1.0 / n_test + 1e-6)
    assert line["epochs_total"] == jline["epochs_total"] == 40
    assert line["test_mean"] == outs[0]["test_mean"]


def test_cli_train_without_a_card_raises(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train"] + TRAIN + ["--log_dir", str(tmp_path / "logs")])


def test_train_single_split_matches_jax(root):
    """One split from JAX's initial variables: the port's parameters
    within ``1e-5·sqrt(N)`` of JAX's, equal best metrics."""
    argv = TRAIN + ["--epochs", "15"]
    jcfg = jcli.config_from_args(_args(jcli, argv))
    cfg = cli.config_from_args(_args(cli, argv))
    jdata, jops, jx, jy, jy1h, nclass = jtrainer.prepare_data("texas", jcfg)
    masks = jtrainer.resolve_split(jdata, jcfg, 0, None, None, nclass)
    jmodel = jtrainer.build_model(jcfg, nclass, N)
    key = jax.random.key(3)
    variables = jmodel.init(jax.random.split(key)[0], jx, jops)
    jres = jtrainer.train_single_split(jmodel, jcfg, jops, jx, jy, jy1h,
                                       masks, key)
    _, state = jax.jit(jtrainer.make_split_runner(jmodel, jcfg),
                       static_argnames=("return_state",))(
        variables, jax.random.split(key)[1], jops, jx, jy, jy1h, masks,
        return_state=True)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   state.variables))
    data, ops, x, y, y1h, _ = trainer.prepare_data("texas", cfg,
                                                   device="cpu")
    model = trainer.build_model(cfg, F, nclass, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
        np.asarray, variables)))
    res = trainer.train_single_split(
        model, cfg, ops, x, y, y1h,
        tuple(torch.from_numpy(np.asarray(m)) for m in masks), seed=3)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=1e-5 * np.sqrt(N), err_msg=name)
    assert float(res.test_metric) == pytest.approx(float(jres.test_metric),
                                                   abs=1e-6)
    assert int(res.epochs_run) == int(jres.epochs_run)


# ---------------------------------------------------------------------------
# Checkpoints, resume, predict
# ---------------------------------------------------------------------------

STEPWISE = ["--dataset", "texas", "--fixed_splits", "1", "--num_splits",
            "2", "--model", "acmgcnpp", "--link_init_layers_X", "2",
            "--hidden", "8", "--stepwise",
            "--checkpoint_every", "3", "--device", "cpu"]


def _snapshot_equal(a, b):
    sa, sb = restore_checkpoint(a), restore_checkpoint(b)
    assert set(sa) == set(sb) == {"variables", "opt_state", "step", "extra"}
    assert sa["step"] == sb["step"] and sa["extra"] == sb["extra"]
    assert sa["variables"].keys() == sb["variables"].keys()
    for k, v in sa["variables"].items():
        assert torch.equal(v, sb["variables"][k]), k
    oa, ob = sa["opt_state"], sb["opt_state"]
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    return sa


def test_stepwise_resume_is_bit_exact(root, tmp_path):
    """acmgcnpp at dropout 0.5 (each epoch's masks from (seed, epoch)),
    8 epochs uninterrupted, against 5 epochs then a resume to 8: equal
    snapshots (weights, BatchNorm statistics, Adam's moments and step),
    histories, best weights and results."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    logs = ["--log_dir", str(tmp_path / "logs")]
    out = _run(cli.main, ["train"] + STEPWISE + logs + [
        "--checkpoint_dir", str(whole), "--epochs", "8"])
    _run(cli.main, ["train"] + STEPWISE + logs + [
        "--checkpoint_dir", str(cut), "--epochs", "5"])
    assert restore_checkpoint(cut / "split0_last")["step"] == 5
    resumed = _run(cli.main, ["train"] + STEPWISE + logs + [
        "--checkpoint_dir", str(cut), "--epochs", "8", "--resume"])
    for idx in range(2):
        snap = _snapshot_equal(whole / f"split{idx}_last",
                               cut / f"split{idx}_last")
        assert snap["step"] == 8
        assert any(k.endswith(".mean") for k in snap["variables"])
        np.testing.assert_array_equal(
            np.load(whole / f"split{idx}_history.npy"),
            np.load(cut / f"split{idx}_history.npy"))
        best_w = restore_checkpoint(whole / f"split{idx}_best")
        best_c = restore_checkpoint(cut / f"split{idx}_best")
        assert best_w["step"] == best_c["step"]
        for k, v in best_w["variables"].items():
            assert torch.equal(v, best_c["variables"][k]), k
    for k in ("test_mean", "test_std", "valid_mean", "valid_std",
              "epochs_total"):
        assert out[k] == resumed[k], k


@pytest.mark.parametrize("reorder", ("none", "rcm"))
def test_predict_round_trip(root, tmp_path, reorder):
    """``predict`` writes the eval logits of a checkpoint's weights (an
    in-process forward, bit for bit) in the original node ids: under
    ``--reorder rcm`` the same weights give the same logits within
    summation-order rounding."""
    ckpt = tmp_path / "ckpt"
    base = ["--dataset", "texas", "--fixed_splits", "1", "--num_splits",
            "1", "--epochs", "6", "--hidden", "8", "--device", "cpu",
            "--log_dir", str(tmp_path / "logs")]
    _run(cli.main, ["train"] + base + ["--checkpoint_dir", str(ckpt)])
    out_npz = tmp_path / f"pred_{reorder}.npz"
    summary = _run(cli.main, ["predict"] + base + [
        "--checkpoint", str(ckpt / "split0_best"), "--output", str(out_npz),
        "--reorder", reorder])
    assert summary["nodes"] == N and summary["classes"] == C
    got = np.load(out_npz)
    cfg = cli.config_from_args(_args(cli, base))
    data, ops, x, _, _, nclass = trainer.prepare_data("texas", cfg,
                                                      device="cpu")
    model = trainer.build_model(cfg, F, nclass, device="cpu")
    model.load_state_dict(restore_checkpoint(ckpt / "split0_best")[
        "variables"])
    with torch.no_grad():
        want = model(x, ops, training=False).numpy()
    if reorder == "none":
        np.testing.assert_array_equal(got["logits"], want)
    else:
        np.testing.assert_allclose(got["logits"], want, atol=1e-5)
    np.testing.assert_array_equal(got["preds"], got["logits"].argmax(1))
    np.testing.assert_allclose(got["probs"].sum(1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# homophily, sweep, generators, profile, refusals
# ---------------------------------------------------------------------------


def test_homophily_matches_jax_cli(root):
    want = _run(jcli.main, ["homophily", "--dataset", "texas"])
    got = _run(cli.main, ["homophily", "--dataset", "texas"])
    assert got == want


@pytest.mark.parametrize("grid", (
    {"lr": [0.01, 0.05], "weight_decay": [0.0, 5e-4], "dropout": [0.5]},
    {"lr": [0.01], "weight_decay": [5e-4], "dropout": [0.5],
     "hidden": [4, 8]}))
def test_sweep_equals_per_config_runs(root, monkeypatch, tmp_path, grid):
    """Every grid point of the sweep (the fast path: one data prep, one
    runner per dropout, (lr, wd) as hparams; or per-configuration runs
    for another key) equals its own ``run_experiment``; the printed best
    is the highest test mean."""
    argv = ["sweep", "--dataset", "texas", "--fixed_splits", "1",
            "--num_splits", "2", "--epochs", "6", "--device", "cpu",
            "--log_dir", str(tmp_path / "logs"), "--grid", json.dumps(grid)]
    with recording(monkeypatch, trainer, "run_experiment") as outs:
        best = _run(cli.main, argv)
    assert len(outs) == (4 if "hidden" not in grid else 2)
    assert best["test_mean"] == max(o["test_mean"] for o in outs)
    for out in outs:
        cfg = trainer.TrainConfig(**out["config"])
        ref = trainer.run_experiment("texas", cfg, device="cpu")
        assert ref["per_split"] == out["per_split"]
        assert ref["epochs_total"] == out["epochs_total"]
    base = cli.config_from_args(_args(cli, argv[1:-2]))
    assert len(sweep.build_grid(base, grid, "texas")) == len(outs)


def test_gen_graphs_and_feats_match_jax(root, tmp_path):
    for main, tag in ((jcli.main, "jax"), (cli.main, "port")):
        main(["gen-graphs", "--base_dir", str(tmp_path / tag / "g"),
              "--graph_type", "regular", "--edge_homos", "0.3", "0.6",
              "--num_graph", "2", "--num_class", "3", "--num_node_total",
              "60", "--seed", "3"])
        for base in ("texas", "random"):
            main(["gen-feats", "--base_dataset", base, "--out_dir",
                  str(tmp_path / tag / base), "--num_class", "3",
                  "--node_per_class", "20", "--num_realizations", "2"])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.npz"))
    assert len(files) == 4 + 4
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.npz"))
    for rel in files:
        with np.load(tmp_path / "jax" / rel) as a, \
                np.load(tmp_path / "port" / rel) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_train_runs(root, tmp_path):
    cli.main(["gen-graphs", "--base_dir", str(tmp_path / "g"),
              "--edge_homos", "0.5", "--num_graph", "1", "--num_node_total",
              "100"])
    cli.main(["gen-feats", "--base_dataset", "random", "--out_dir",
              str(tmp_path / "f"), "--node_per_class", "20",
              "--num_realizations", "1"])
    out = _run(cli.main, ["synthetic-train", "--base_dir",
                          str(tmp_path / "g"), "--edge_homo", "0.5",
                          "--num_graph", "1", "--features_dir",
                          str(tmp_path / "f"), "--epochs", "5",
                          "--num_splits", "1", "--device", "cpu",
                          "--log_dir", str(tmp_path / "logs")])
    assert out["edge_homo"] == 0.5 and len(out["per_graph"]) == 1
    assert 0.0 <= out["test_mean"] <= 1.0


def test_profile_dir_writes_a_trace(root, tmp_path):
    prof = tmp_path / "prof"
    _run(cli.main, ["train", "--dataset", "texas", "--fixed_splits", "1",
                    "--num_splits", "1", "--epochs", "3", "--device", "cpu",
                    "--log_dir", str(tmp_path / "logs"), "--profile_dir",
                    str(prof), "--results_csv", str(tmp_path / "r.csv")])
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
    # the program's spans are ranges in the trace, and off again after it
    names = {e.get("name") for e in events}
    assert {"prepare_data", "split", "split.prepare", "runner.call",
            "runner.first_body", "runner.loop"} <= names
    assert not profiling.spans_enabled()
    assert (tmp_path / "r.csv").read_text().startswith("dataset,model,")


@pytest.mark.parametrize("flag", (["--model", "acmgcnpp",
                                   "--link_init_layers_X", "2"],
                                  ["--model", "acmsgc", "--hops", "2"],
                                  ["--model", "sgc", "--hops", "3"]))
def test_sharded_train_refuses_by_name(root, tmp_path, flag):
    """``train --sharded`` refuses by name only the k-hop operator
    (ROADMAP.md A8); acmgcnpp with ``--link_init_layers_X 2`` (BatchNorm
    across ranks) trains."""
    argv = ["train", "--dataset", "texas", "--sharded", "1", "--device",
            "cpu", "--num_splits", "1", "--epochs", "3", "--log_dir",
            str(tmp_path / "logs")] + flag
    if "--hops" not in flag:
        out = _run(cli.main, argv)
        assert out["model"] == "acmgcnpp" and out["epochs_total"] == 3
        return
    with pytest.raises(NotImplementedError, match="hops"):
        cli.main(argv)


SHARDED_ARGV = ["train", "--dataset", "texas", "--fixed_splits", "1",
                "--num_splits", "2", "--epochs", "12", "--model", "acmgcnp",
                "--structure_info", "1", "--joint", "1", "--lr", "0.01",
                "--hidden", "16", "--dropout", "0", "--device", "cpu"]


def test_sharded_train_checkpoints_and_resumes(root, tmp_path):
    """``train --sharded 1 --checkpoint_dir D --checkpoint_every 5`` writes
    each split's state (no generator state: dropout's keys follow from
    the loop's counter); a second call with ``--resume``
    finds every split done and prints the same JSON (but the timings)."""
    argv = SHARDED_ARGV + ["--sharded", "1", "--log_dir",
                           str(tmp_path / "logs"), "--checkpoint_dir",
                           str(tmp_path / "ckpt"), "--checkpoint_every", "5"]
    first = _run(cli.main, argv)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "split0_state", "split1_state"]
    again = _run(cli.main, argv + ["--resume"])
    timing = ("runtime_s", "epoch_ms_avg", "epoch_ms_steady")
    assert {k: v for k, v in again.items() if k not in timing} == {
        k: v for k, v in first.items() if k not in timing}


def test_torchrun_sharded_train_on_two_ranks(root, tmp_path):
    """``torchrun --nproc_per_node 2 -m acmgnn_tpu_torch.cli train
    --sharded 2 --device cpu``: two ranks joined by gloo through
    torchrun's environment, per-rank slab loading on; each rank's JSON
    equals ``run_experiment_sharded`` in this process (one rank) but for
    ``devices`` and the timings (at dropout 0: a rank's dropout draws
    from a generator seeded by its rank)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "acmgnn_tpu_torch.cli"]
        + SHARDED_ARGV + ["--sharded", "2", "--log_dir",
                          str(tmp_path / "logs")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    outs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert len(outs) == 2
    args = _args(cli, SHARDED_ARGV[1:])
    want = trainer.run_experiment_sharded(
        "texas", cli.config_from_args(args), device="cpu")
    timing = ("runtime_s", "epoch_ms_avg", "epoch_ms_steady", "devices")
    for out in outs:
        assert out["devices"] == 2
        assert {k: v for k, v in out.items() if k not in timing} == {
            k: v for k, v in want.items()
            if k not in timing and k != "per_split"}
    logs = sorted(p.name for p in (tmp_path / "logs").iterdir())
    assert len(logs) == 2 and "_rank0_" in logs[0] and "_rank1_" in logs[1]


def test_loaded_dataset_is_the_files(root):
    data = load_dataset("texas")
    assert data.num_nodes == N and data.features.shape == (N, F)
    assert data.num_classes == C
