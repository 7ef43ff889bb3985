"""The port's sharded path against the JAX package's on a 4-device mesh.

The port runs as 4 ranks of a gloo group on the CPU, each a process of
``tests/_torch_sharded_worker.py`` (torch only) over a ``FileStore``
under the test's temporary directory; the JAX package runs its sharded
functions on 4 of conftest's 8 virtual CPU devices.  One world of 4 ranks
runs every job of the module once (the ranks write their slabs, the tests
compare them); a world of 2 runs the entry point again, also with a
locality reorder and bf16 feature storage.

The zoo on 4 ranks (acmgcnpp with the structure channel, variant 1,
symmetric normalization on ELL and COO, gcnII, BCE + ROC-AUC) is held to
JAX's sharded forward and runner the same way; acmgcnpp's BatchNorm
(``init_layers_X`` 2 and 3) on 2 and 4 ranks to the single-card port and
to JAX's single-chip model (JAX's sharded BatchNorm also averages the pad
rows, and departs from its own single-chip model); per-rank slab loading to
JAX's ``shard_node_array_per_host`` / ``host_local_rows``; at one rank the
sharded ROC-AUC path equals the single-card port bit for bit; a
checkpointed run cut at half its epochs and resumed equals the
uninterrupted run bit for bit at world sizes 1 and 2; a transient failure
is retried at one rank, and at two only when every rank failed.

Tolerances, stated where used: partitions, schedules and the plain pack
exactly; sparse products per element ``1e-5·sqrt(row terms)·max(1,
Σ|terms|)`` (f32 sums in another order); the model forward
``1e-5·sqrt(reduction length)`` relative; 20 training epochs within
``tests/test_torch_trainer.py``'s 1e-4 for f32.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.data.registry import row_normalize_features as jax_rownorm
from acmgnn_tpu.data.splits import indices_to_masks as jax_indices_to_masks
from acmgnn_tpu.data.splits import (
    random_disassortative_splits as jax_random_splits,
)
from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.ops.graph import permute_graph as jax_permute_graph
from acmgnn_tpu.ops.graph import row_normalized_adjacency as jax_a_hat
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu.parallel import partition as jpart
from acmgnn_tpu.parallel.sharded import (
    _pre_scale_block,
    make_graph_mesh,
    make_sharded_coo_op,
    make_sharded_ell_op,
    make_sharded_operators,
    shard_node_array,
    sharded_ell_spmm,
    sharded_ell_spmm_transpose,
    sharded_spmm,
    sharded_spmm_transpose,
)
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train.trainer import build_model as jax_build_model
from acmgnn_tpu.train.trainer import make_split_runner as jax_split_runner
from acmgnn_tpu.train.trainer import prepare_data as jax_prepare_data
from acmgnn_tpu.train.trainer import run_experiment as jax_run_experiment
from acmgnn_tpu_torch.data.splits import (
    indices_to_masks,
    random_disassortative_splits,
)
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.ell import k1_operand, make_ell_op, row_gather_spmm
from acmgnn_tpu_torch.ops.graph import (
    GraphData,
    make_coo_op,
    permute_graph,
    row_normalized_adjacency,
)
from acmgnn_tpu_torch.ops.halo import halo_pack, halo_pack_plain, padded_rows
from acmgnn_tpu_torch.parallel import partition as tpart
from acmgnn_tpu_torch.parallel import sharded as tsharded
from acmgnn_tpu_torch.parallel.multihost import init_distributed
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_split_runner,
    prepare_data,
    prepare_sharded_data,
    run_experiment,
    run_experiment_sharded,
)

WORKER = Path(__file__).parent / "_torch_sharded_worker.py"
WORLD = 4
TIMEOUT_S = 240

# the headline configuration at test size (hidden cut to 16), f32 gathers
# and dropout 0 for parity
MODEL_CFG = dict(
    model_type="acmgcnp", hidden=16, dropout=0.0, lr=0.01, weight_decay=1e-3,
    epochs=20, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", joint=True,
    hoist_first=True)
SPMM_CASES = [(g, ex, fmt, dt) for g in ("small", "banded")
              for ex in ("allgather", "halo") for fmt in ("ell", "coo")
              for dt in ("float32", "bfloat16")]
FORWARD_CASES = [(ex, fmt) for ex in ("allgather", "halo")
                 for fmt in ("ell", "coo")]
RUNNER_CASES = [("allgather", "ell"), ("halo", "coo")]
# the zoo on 4 ranks: config over ZOO_CFG, exchange, format; each case's
# forward (but ROC-AUC's, the default model) and 20-epoch runner are held
# to JAX's.  ZOO_CFG trains at lr 1e-3 without weight decay: at the
# headline's lr 0.01 + decay, 20 epochs of the structure channel part the
# port's own single-card summation orders by ~1e-3 (ROADMAP.md §C), so
# only a configuration that does not amplify rounding shows a fault at
# 1e-4
ZOO_CFG = dict(MODEL_CFG, lr=1e-3, weight_decay=0.0)
ZOO_CASES = {
    "pp_struct": (dict(model_type="acmgcnpp", structure_info=True), "halo",
                  "ell"),
    "variant1": (dict(variant=True), "allgather", "ell"),
    "sym_ell": (dict(normalization="sym"), "halo", "ell"),
    "sym_coo": (dict(normalization="sym"), "allgather", "coo"),
    "gcnII": (dict(model_type="gcnII"), "allgather", "ell"),
    "rocauc": (dict(loss="bce", metric="rocauc"), "allgather", "ell"),
}
ZOO_FORWARD = [k for k in ZOO_CASES if k != "rocauc"]
# acmgcnpp's skip MLP with BatchNorm at each depth, on 2 ranks (all-gather)
# and 4 (halo), held to the single-card port and JAX's single-chip model;
# BN_EXPERIMENT: run_experiment_sharded on 2 ranks against JAX's
# run_experiment (dropout 0, each split from JAX's initial variables).
# BN_CFG trains at lr 1e-3 with weight decay 1e-3: without decay, the bias
# of lin_0 (Linear -> ReLU -> BatchNorm) has, for a unit that every row
# passes, a gradient of zero in exact arithmetic, and Adam turns its
# rounding into steps of ±lr, so any two summation orders of one card
# part there by ~1e-2 in 20 epochs; the decay term sets the step's
# direction (test_sharded_batchnorm_check_is_well_conditioned)
BN_LAYERS = (2, 3)
BN_EXCHANGE = {2: "allgather", 4: "halo"}
BN_CFG = dict(ZOO_CFG, model_type="acmgcnpp", weight_decay=1e-3)
BN_EXPERIMENT = dict(BN_CFG, init_layers_X=2, num_splits=2, seed=5)


def _bn_cfg(layers, **over):
    return dict(BN_CFG, init_layers_X=layers, **over)


def _banded():
    """Ring lattice, i ~ i±1..3: a contiguous partition references only a
    thin band of its neighbours (the JAX tests' banded graph)."""
    n = 256
    rows, cols = [], []
    for i in range(n):
        for d in (1, 2, 3):
            rows += [i, (i + d) % n]
            cols += [(i + d) % n, i]
    adj = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    adj.sum_duplicates()
    adj.data[:] = 1.0
    return adj


@pytest.fixture(scope="module")
def graphs(small_graph):
    adj, _, _ = small_graph
    rng = np.random.default_rng(11)
    out = {}
    for name, a in (("small", adj), ("banded", _banded())):
        a = sp.csr_matrix(a)
        out[name] = dict(adj=a, x=rng.normal(size=(a.shape[0], 7)).astype(
            np.float32), g=rng.normal(size=(a.shape[0], 4)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def model_graph():
    """Twitch-shaped, non-negative features (the fast LayerNorm variance
    cancels on the stand-in's near-zero row sums: tests/test_torch_trainer.py)."""
    adj, feats, labels = twitch_gamers_scale_graph(0, n=300, pairs=3000)
    return adj, np.abs(feats), labels


@pytest.fixture(scope="module")
def mesh():
    return make_graph_mesh(jax.devices()[:WORLD])


def _masks(n, seed=0):
    perm = np.random.default_rng(seed).permutation(n)
    m = np.zeros((3, n), bool)
    m[0, perm[: n // 2]] = True
    m[1, perm[n // 2: 3 * n // 4]] = True
    m[2, perm[3 * n // 4:]] = True
    return m


def _jax_model(cfg_kw, adj, feats, labels, mesh, exchange, fmt, init=True):
    """JAX's sharded operators, placed arrays and flax init (None without
    ``init``), as its ``run_experiment_sharded`` builds them."""
    jcfg = JaxTrainConfig(**dict(cfg_kw, operator_format=fmt))
    ops, b, rpp = make_sharded_operators(
        adj, mesh, pad_multiple=64, exchange=exchange, fmt=fmt,
        ell_hub_threshold=0, normalization=jcfg.normalization,
        structure_info=jcfg.structure_info)
    x = shard_node_array(jax_rownorm(feats) if jcfg.resolve_feature_normalize()
                         else feats, b, rpp, mesh)
    ops = ops.replace(x_agg=jax.jit(jax_spmm)(ops.adj_low, x))
    nclass = int(labels.max()) + 1
    model = jax_build_model(jcfg, nclass, int(x.shape[0]))
    variables = (jax.jit(model.init)(jax.random.key(0), x, ops) if init
                 else None)
    return jcfg, model, variables, ops, x, b, rpp


@pytest.fixture(scope="module")
def jax_models(model_graph, mesh):
    adj, feats, labels = model_graph
    return {case: _jax_model(MODEL_CFG, adj, feats, labels, mesh, *case)
            for case in FORWARD_CASES}


@pytest.fixture(scope="module")
def jax_zoo(model_graph, mesh):
    adj, feats, labels = model_graph
    return {key: _jax_model(dict(ZOO_CFG, **over), adj, feats, labels,
                            mesh, exchange, fmt)
            for key, (over, exchange, fmt) in ZOO_CASES.items()}


@pytest.fixture(scope="module")
def jax_bn(model_graph):
    """JAX's single-chip side of the BatchNorm cases, by depth: config,
    prepared data, model and initial variables (key 0); under
    "experiment", ``run_experiment``'s initial variables of each split of
    ``BN_EXPERIMENT``, drawn as its loop draws them."""
    jdata = JaxGraphData("g", *model_graph)
    out = {}
    for layers in BN_LAYERS:
        jcfg = JaxTrainConfig(**_bn_cfg(layers))
        prepared = jax_prepare_data(jdata, jcfg)
        _, ops, x, _, _, nclass = prepared
        model = jax_build_model(jcfg, nclass, int(x.shape[0]))
        init = jax.jit(model.init)
        out[layers] = (jcfg, prepared, model,
                       init(jax.random.key(0), x, ops))
    _, (_, ops, x, _, _, _), model, _ = out[BN_EXPERIMENT["init_layers_X"]]
    init = jax.jit(model.init)
    key = jax.random.key(BN_EXPERIMENT["seed"])
    out["experiment"] = [
        init(jax.random.split(jax.random.fold_in(key, idx))[0], x, ops)
        for idx in range(BN_EXPERIMENT["num_splits"])]
    return out


def _bn_state(variables):
    """Flax variables (parameters and BatchNorm statistics) as the port's
    ``state_dict`` (numpy)."""
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(variables))).items()}


def _bn_inputs(jax_bn, world, n, nclass):
    """The BatchNorm jobs of a world of ``world`` ranks and their inputs:
    each depth's initial state, the gradient's node weights and the masks
    (2 ranks: also ``BN_EXPERIMENT``'s initial states by split)."""
    inputs = {"masks": _masks(n), "bn_weights": np.random.default_rng(
        7).normal(size=(n, nclass)).astype(np.float32)}
    jobs = []
    for layers in BN_LAYERS:
        prefix = f"params/bn{layers}/"
        inputs.update({prefix + k: v for k, v in
                       _bn_state(jax_bn[layers][3]).items()})
        jobs.append(dict(kind="batchnorm", key=f"bn/{layers}", graph="model",
                         exchange=BN_EXCHANGE[world], cfg=_bn_cfg(layers),
                         params=prefix, weights="bn_weights", masks="masks"))
    if world == 2:
        for idx, variables in enumerate(jax_bn["experiment"]):
            inputs.update({f"params/bnexp/{idx}/{k}": v
                           for k, v in _bn_state(variables).items()})
        jobs.append(dict(kind="experiment_from", key="bn/experiment",
                         graph="model", exchange="allgather",
                         cfg=BN_EXPERIMENT, params="params/bnexp/"))
    return inputs, jobs


def _start(tmp: Path, world: int, inputs: dict, jobs: list) -> list:
    """Start ``jobs`` on ``world`` worker ranks; their processes."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    task = dict(world=world, store=str(tmp / "store"), out=str(tmp),
                inputs=str(tmp / "inputs.npz"), jobs=jobs)
    (tmp / "task.json").write_text(json.dumps(task))
    procs = []
    for r in range(world):
        with open(tmp / f"log{r}", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(tmp / "task.json"),
                 str(r)], stdout=log, stderr=subprocess.STDOUT))
    return procs


def _join(tmp: Path, procs: list) -> list:
    """Wait for the ranks ``_start`` started; their outputs by rank."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} failed:\n{(tmp / f'log{r}').read_text()}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(procs))]


def _spawn(tmp: Path, world: int, inputs: dict, jobs: list) -> list:
    """Run ``jobs`` on ``world`` worker ranks; their outputs by rank."""
    return _join(tmp, _start(tmp, world, inputs, jobs))


def _graph_inputs(name, adj, **arrays):
    out = {f"{name}_data": adj.data, f"{name}_indices": adj.indices,
           f"{name}_indptr": adj.indptr,
           f"{name}_shape": np.asarray(adj.shape)}
    out.update({f"{name}_{k}": v for k, v in arrays.items()})
    return out


def _port_params(params, b=None, rpp=None):
    """JAX's flax parameters as the port's ``state_dict`` (numpy): the
    structure embedding's rows in node order (JAX's has one row per
    padded node slot, ``P·rows_per_part``; the port's the graph's N)."""
    out = {}
    for k, v in params_from_flax(jax.tree_util.tree_map(
            np.asarray, params)).items():
        v = v.numpy()
        if k.endswith("struc_low"):
            v = jpart.unpad_node_array(v, b, rpp)
        out[k] = v
    return out


def _state_dict(variables, b=None, rpp=None):
    return _port_params(variables["params"], b, rpp)


EXPERIMENT_CFG = dict(MODEL_CFG, num_splits=2, epochs=12, seed=5)
# the single-card knobs the sharded entry takes too: a locality reorder
# before partitioning and bf16 feature storage
KNOBS_CFG = dict(EXPERIMENT_CFG, reorder="rcm", feature_dtype="bfloat16")


@pytest.fixture(scope="module")
def world4_started(world2_started, tmp_path_factory, graphs, model_graph,
                   jax_models, jax_zoo, jax_bn):
    """Every job of the module on 4 ranks, once: started (``world4``
    waits for them)."""
    inputs = {}
    for name, g in graphs.items():
        inputs.update(_graph_inputs(name, g["adj"], x=g["x"], g=g["g"]))
    adj, feats, labels = model_graph
    inputs.update(_graph_inputs("model", sp.csr_matrix(adj), features=feats,
                                labels=labels))
    inputs["masks"] = _masks(adj.shape[0])
    jobs = [dict(kind="spmm", key=f"spmm/{g}/{ex}/{fmt}/{dt}", graph=g,
                 exchange=ex, fmt=fmt, dtype=dt)
            for g, ex, fmt, dt in SPMM_CASES]
    jobs += [dict(kind="spmm", key=f"spmm/{g}/auto/ell/float32", graph=g,
                  exchange="auto", fmt="ell", dtype="float32")
             for g in ("small", "banded")]
    for ex, fmt in FORWARD_CASES:
        prefix = f"params/{ex}/{fmt}/"
        inputs.update({prefix + k: v for k, v in _state_dict(
            jax_models[(ex, fmt)][2]).items()})
        cfg = dict(MODEL_CFG, operator_format=fmt)
        jobs.append(dict(kind="forward", key=f"forward/{ex}/{fmt}",
                         graph="model", exchange=ex, cfg=cfg, params=prefix))
        if (ex, fmt) in RUNNER_CASES:
            jobs.append(dict(kind="runner", key=f"runner/{ex}/{fmt}",
                             graph="model", exchange=ex, cfg=cfg,
                             params=prefix, masks="masks"))
    for key, (over, exchange, fmt) in ZOO_CASES.items():
        prefix = f"params/zoo/{key}/"
        _, _, variables, _, _, b, rpp = jax_zoo[key]
        inputs.update({prefix + k: v for k, v in _state_dict(
            variables, b, rpp).items()})
        cfg = dict(ZOO_CFG, operator_format=fmt, **over)
        kinds = ("forward", "runner") if key in ZOO_FORWARD else ("runner",)
        jobs += [dict(kind=kind, key=f"{kind}/zoo/{key}", graph="model",
                      exchange=exchange, cfg=cfg, params=prefix,
                      masks="masks") for kind in kinds]
    jobs.append(dict(kind="experiment", key="experiment", graph="model",
                     exchange="auto", cfg=EXPERIMENT_CFG))
    bn_inputs, bn_jobs = _bn_inputs(jax_bn, WORLD, adj.shape[0],
                                    int(labels.max()) + 1)
    inputs.update(bn_inputs)
    jobs += bn_jobs
    tmp = tmp_path_factory.mktemp("world4")
    procs = _start(tmp, WORLD, inputs, jobs)
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_zoo_runs(world4_started, jax_zoo, model_graph, mesh):
    """JAX's side of each zoo case, computed while the 4 ranks run: its
    eval forward (unpadded logits; not ROC-AUC's, the default model) and
    its runner's result and final parameters (20 epochs)."""
    adj, _, labels = model_graph
    onehot = np.eye(int(labels.max()) + 1, dtype=np.float32)[labels]
    out = {}
    for key in ZOO_CASES:
        jcfg, model, variables, ops, x, b, rpp = jax_zoo[key]
        logits = None
        if key in ZOO_FORWARD:
            logits = jpart.unpad_node_array(np.asarray(jax.jit(
                lambda v, x_, o: model.apply(v, x_, o, training=False))(
                    variables, x, ops)), b, rpp)
        place = (lambda v: shard_node_array(v, b, rpp, mesh))
        masks = tuple(place(m) for m in _masks(adj.shape[0]))
        jres, jstate = jax_split_runner(model, jcfg)(
            variables, jax.random.key(1), ops, x,
            place(labels.astype(np.int32)), place(onehot), masks,
            return_state=True)
        out[key] = (logits, jres,
                    _port_params(jstate.variables["params"], b, rpp))
    return out


@pytest.fixture(scope="module")
def jax_bn_runs(world4_started, jax_zoo_runs, jax_bn, model_graph, mesh):
    """JAX's single-chip side of the BatchNorm cases, computed while the
    ranks run, by depth: the train-mode forward (dropout 0), the
    gradients of ``Σ logits·weights`` and the statistics after it, and a
    20-epoch runner's result and final parameters; under "experiment",
    ``run_experiment`` on ``BN_EXPERIMENT`` through the same compiled
    runner (its splits' initial variables and final parameters
    recorded); "sharded_logits", JAX's sharded train-mode forward of
    depth 2 on 4 devices from the same variables (unpadded); and
    "boundaries", the port's (boundaries, rows per part) by world size."""
    adj, feats, labels = model_graph
    n, nclass = adj.shape[0], int(labels.max()) + 1
    out = {"boundaries": {}}
    for world in (2, WORLD):
        ops, b = tsharded.make_sharded_ell_op(row_normalized_adjacency(adj),
                                              world, None)
        out["boundaries"][world] = (b, ops[0].rows_per_part)
    _, smodel, _, sops, sx, sb, srpp = _jax_model(
        _bn_cfg(2), adj, feats, labels, mesh, "allgather", "ell", init=False)
    slogits, _ = jax.jit(lambda v, x_, o: smodel.apply(
        v, x_, o, training=True, rngs={"dropout": jax.random.key(0)},
        mutable=["batch_stats"]))(jax_bn[2][3], sx, sops)
    out["sharded_logits"] = jpart.unpad_node_array(np.asarray(slogits), sb,
                                                   srpp)
    weights = jnp.asarray(np.random.default_rng(7).normal(
        size=(n, nclass)).astype(np.float32))
    masks = tuple(jnp.asarray(m) for m in _masks(n))
    for layers in BN_LAYERS:
        jcfg, (_, ops, x, y, y1h, _), model, variables = jax_bn[layers]

        def loss(p, model=model, variables=variables, ops=ops, x=x):
            logits, upd = model.apply(
                {**variables, "params": p}, x, ops, training=True,
                rngs={"dropout": jax.random.key(0)},
                mutable=["batch_stats"])
            return jnp.sum(logits * weights), (logits, upd)

        (_, (logits, upd)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
        run = jax.jit(lambda *a, model=model, jcfg=jcfg: jax_split_runner(
            model, jcfg)(*a, return_state=True))
        jres, jstate = run(variables, jax.random.key(1), ops, x, y, y1h,
                           masks)
        out[layers] = dict(
            logits=np.asarray(logits),
            grads={k: v.numpy() for k, v in params_from_flax(
                jax.tree_util.tree_map(np.asarray, grads)).items()},
            stats=_bn_state({"params": {}, "batch_stats":
                             upd["batch_stats"]}),
            result=jres,
            params=_bn_state({"params": jstate.variables["params"]}))
        if layers == BN_EXPERIMENT["init_layers_X"]:
            seen = []

            def hook(*args, run=run):
                res, state = run(*args)
                seen.append((args[0], state.variables["params"]))
                return res

            jout = jax_run_experiment(
                JaxGraphData("g", *model_graph),
                JaxTrainConfig(**BN_EXPERIMENT), runner=hook)
            out["experiment"] = (jout, seen)
    return out


@pytest.fixture(scope="module")
def world4(world4_started, jax_zoo_runs, jax_bn_runs):
    """The 4 ranks' outputs (after JAX's zoo runs, which overlap them)."""
    return _join(*world4_started)


# cut-and-resume: 2 splits of 12 epochs in 3-epoch segments, dropout on
RESUME_CFG = {
    "joint": dict(EXPERIMENT_CFG, dropout=0.5),
    "sequential": dict(EXPERIMENT_CFG, dropout=0.5, joint=False,
                       model_type="acmgcnpp", structure_info=True),
}
RESUME_EVERY = 3
# the ranks of the world of 2 on which a transient failure is injected
RETRY_FAILS = {"every_rank": [0, 1], "one_rank": [0]}


def _resume_jobs(tmp):
    return [dict(kind="resume", key=f"resume/{loop}", graph="model",
                 cfg=cfg, every=RESUME_EVERY, dir=str(tmp))
            for loop, cfg in RESUME_CFG.items()]


@pytest.fixture(scope="module")
def world2_started(tmp_path_factory, model_graph, jax_bn):
    """The entry point on 2 ranks, with the knobs, retries,
    cut-and-resume and BatchNorm: started first (``world2`` waits for
    them), so that they run while JAX builds and runs its side of the
    world of 4."""
    adj, feats, labels = model_graph
    inputs = _graph_inputs("model", sp.csr_matrix(adj), features=feats,
                           labels=labels)
    bn_inputs, bn_jobs = _bn_inputs(jax_bn, 2, adj.shape[0],
                                    int(labels.max()) + 1)
    inputs.update(bn_inputs)
    tmp = tmp_path_factory.mktemp("world2")
    procs = _start(tmp, 2, inputs,
                   [dict(kind="experiment", key="experiment", graph="model",
                         exchange="auto", cfg=EXPERIMENT_CFG),
                    dict(kind="experiment", key="knobs", graph="model",
                         exchange="halo", cfg=KNOBS_CFG)]
                   + [dict(kind="retry", key=f"retry/{name}", graph="model",
                           exchange="auto", cfg=EXPERIMENT_CFG, fail=fail)
                      for name, fail in RETRY_FAILS.items()]
                   + _resume_jobs(tmp / "ckpt") + bn_jobs)
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def world2(world2_started):
    return _join(*world2_started)


def _gather(ranks, key):
    """The ranks' slabs of ``key``, stacked in rank order (the padded node
    layout of the JAX package's sharded arrays)."""
    return np.concatenate([r[key] for r in ranks], axis=0)


def _spmm_close(got, want, mat, operand, what):
    """Per element ``1e-5·sqrt(row terms)·max(1, Σ|terms|)``."""
    absmat = abs(sp.csr_matrix(mat))
    terms = np.diff(absmat.indptr)[:, None]
    absref = absmat @ np.abs(operand.astype(np.float64))
    tol = 1e-5 * np.sqrt(np.maximum(terms, 1)) * np.maximum(absref, 1.0)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol).all(), f"{what}: worst err/tol {(err / tol).max():.3e}"


# ---------------------------------------------------------------------------
# Partition, schedule and pack: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ("small", "banded", "model"))
def test_partitions_match_jax(graphs, model_graph, name):
    adj = model_graph[0] if name == "model" else graphs[name]["adj"]
    for p in (1, 3, WORLD):
        np.testing.assert_array_equal(tpart.partition_rows(adj, p),
                                      jpart.partition_rows(adj, p))
        for fn in ("degree_balanced_partition", "fennel_partition"):
            part = getattr(tpart, fn)(adj, p)
            np.testing.assert_array_equal(part, getattr(jpart, fn)(adj, p))
            for got, want in zip(tpart.partition_to_perm(part, p),
                                 jpart.partition_to_perm(part, p)):
                np.testing.assert_array_equal(got, want)


def test_pad_unpad_match_jax(graphs):
    x = graphs["small"]["x"]
    b = tpart.partition_rows(graphs["small"]["adj"], WORLD)
    rpp = int(np.diff(b).max())
    padded = tpart.pad_node_array(x, b, rpp)
    np.testing.assert_array_equal(padded, jpart.pad_node_array(x, b, rpp))
    np.testing.assert_array_equal(tpart.unpad_node_array(padded, b, rpp), x)


@pytest.mark.parametrize("name", ("small", "banded"))
def test_sharded_coo_blocks_match_jax(graphs, name):
    """Each rank's triplets equal the unpadded prefix of JAX's blocks."""
    a_hat = jax_a_hat(graphs[name]["adj"])
    got = tpart.build_sharded_coo(a_hat, WORLD)
    want = jpart.build_sharded_coo(a_hat, WORLD, pad_multiple=64)
    for k in ("rows_per_part", "num_nodes", "nnz"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["boundaries"], want["boundaries"])
    for keys in (("row_l", "col", "val"), ("row_l_t", "col_t", "val_t")):
        for p in range(WORLD):
            k = got[keys[0]][p].size
            assert (want[keys[0]][p, k:] == want["rows_per_part"]).all()
            for key in keys:
                np.testing.assert_array_equal(got[key][p], want[key][p, :k])


@pytest.mark.parametrize("name", ("small", "banded"))
def test_halo_schedule_matches_jax(graphs, name):
    a_hat = jax_a_hat(graphs[name]["adj"])
    blocks = tpart.build_sharded_coo(a_hat, WORLD)
    got = tpart.build_halo_schedule(blocks)
    want = jpart.build_halo_schedule(
        jpart.build_sharded_coo(a_hat, WORLD, pad_multiple=64))
    for sfx in ("", "_t"):
        assert got["halo_pad" + sfx] == want["halo_pad" + sfx]
        assert got["halo_rows" + sfx] == want["halo_rows" + sfx]
        np.testing.assert_array_equal(got["send_idx" + sfx],
                                      want["send_idx" + sfx])
        for p in range(WORLD):
            k = got["col_h" + sfx][p].size
            np.testing.assert_array_equal(got["col_h" + sfx][p],
                                          want["col_h" + sfx][p, :k])


@pytest.mark.parametrize("ld", (7, 8))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("with_scale,with_sign", [(False, False), (True, True),
                                                  (True, False)])
def test_halo_pack_plain_matches_jax(dtype, with_scale, with_sign, ld):
    """K6's plain version against ``_pre_scale_block`` and the send-slab
    ``take``, bit for bit (the sign is the cotangent's negation JAX's
    autodiff applies before the block), into contiguous rows of d = 7
    and into K1's row-padded layout (row stride 8), whose padding columns
    it writes as 0 in the own and the send rows."""
    rng = np.random.default_rng(2)
    rows, d, halo_pad = 50, 7, 8
    x = (rng.normal(size=(rows, d)) * 100).astype(np.float32)
    pre = rng.random(rows).astype(np.float32) if with_scale else None
    sign = [(-1.0) ** j for j in range(d)] if with_sign else None
    send_idx = rng.integers(0, rows, (WORLD, halo_pad)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x_in = x * np.asarray(sign, np.float32) if with_sign else x
    want = _pre_scale_block(jnp.asarray(x_in),
                            None if pre is None else jnp.asarray(pre)[None],
                            jdt)
    want_send = jnp.take(want, jnp.asarray(send_idx).reshape(-1), axis=0)
    buf = torch.full((rows, ld), float("nan"), dtype=getattr(torch, dtype))
    own = buf[:, :d]
    send = halo_pack_plain(torch.from_numpy(x), own,
                           None if pre is None else torch.from_numpy(pre),
                           sign, torch.from_numpy(send_idx), ld=ld)
    assert own.stride(0) == send.stride(0) == ld
    np.testing.assert_array_equal(own.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(send.float().numpy(),
                                  np.asarray(want_send, np.float32))
    for t in (buf, padded_rows(send)):
        assert t.shape[1] == ld and not t[:, d:].float().any()


@pytest.mark.parametrize("pack", (halo_pack, halo_pack_plain))
@pytest.mark.parametrize("ld", (None, 8, 12))
def test_halo_pack_refuses_a_column_slice(pack, ld):
    """The pack zeroes the columns ``d`` to ``ld`` of every row only where
    the caller names ``ld``: a column slice of a wider tensor (rows of 12)
    whose stride is not the ``ld`` passed, or that is passed without one,
    is refused, and its neighbouring columns keep their values."""
    x = torch.ones(5, 7)
    wide = torch.full((5, 12), 3.0)
    with pytest.raises(ValueError, match="pass ld"):
        pack(x, wide[:, 2:9], ld=ld)
    if ld != 12:
        with pytest.raises(ValueError, match="pass ld"):
            pack(x, wide[:, :7], ld=ld)
    assert torch.equal(wide, torch.full((5, 12), 3.0))


def test_world_size_1_receive_buffer_is_k1s_padded_operand(model_graph):
    """World size 1 (no group): a bf16 w7 ELL operator's receive buffer
    is a ``[:, :7]`` view of rows of 8 (K1's ``k1_operand`` layout) with
    zero padding, holding what ``k1_operand`` holds; the sharded product
    and its transpose (sign and pre-scale applied in f32, one rounding)
    equal the single-chip port's K1 on the same operand bit for bit."""
    adj = row_normalized_adjacency(sp.csr_matrix(model_graph[0]))
    n = adj.shape[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    sign = [1.0, 1.0, -1.0, -1.0]
    op, _ = tsharded.make_sharded_ell_op(adj, 1, 0,
                                         gather_dtype=torch.bfloat16)
    one = make_ell_op(adj, gather_dtype=torch.bfloat16)
    assert op.bwd.pre_scale is not None      # the column-uniform transpose
    recv = tsharded.receive_buffer(op, x)
    assert recv.shape == (n, 7) and recv.stride() == (8, 1)
    assert not padded_rows(recv)[:, 7:].float().any()
    assert torch.equal(recv, k1_operand(x, torch.bfloat16))
    assert torch.equal(tsharded.sharded_ell_spmm(op, x),
                       row_gather_spmm(one.fwd, k1_operand(x,
                                                           torch.bfloat16)))
    signed = g * torch.tensor(sign)
    recv_t = tsharded.receive_buffer(op, g, True, sign)
    assert recv_t.stride() == (4, 1)        # bf16 rows of 4 are 8 bytes
    want_t = k1_operand(signed, torch.bfloat16, one.bwd.pre_scale)
    assert torch.equal(recv_t, want_t)
    assert torch.equal(tsharded.sharded_ell_spmm_transpose(op, g, sign),
                       row_gather_spmm(one.bwd, want_t))


# ---------------------------------------------------------------------------
# The sharded SpMM, the model, the runner and the entry point on 4 ranks
# ---------------------------------------------------------------------------


def _jax_spmm(a_hat, mesh, exchange, fmt, dtype, x, g):
    if fmt == "ell":
        op, b = make_sharded_ell_op(
            a_hat, mesh, pad_multiple=64, exchange=exchange,
            gather_dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
            hub_threshold=0)
        fwd, bwd = sharded_ell_spmm, sharded_ell_spmm_transpose
    else:
        op, b = make_sharded_coo_op(a_hat, mesh, pad_multiple=64,
                                    exchange=exchange)
        fwd, bwd = sharded_spmm, sharded_spmm_transpose

    def run(fn, v):
        # jit: eager shard_map dispatches every degree class on its own
        out = jax.jit(lambda o, w: fn(o, w, mesh))(
            op, shard_node_array(v, b, op.rows_per_part, mesh))
        return jpart.unpad_node_array(np.asarray(out, np.float64), b,
                                      op.rows_per_part)

    return run(fwd, x), run(bwd, g), b, op


@pytest.mark.parametrize("name,exchange,fmt,dtype", SPMM_CASES)
def test_sharded_spmm_matches_jax(world4, graphs, mesh, name, exchange, fmt,
                                  dtype):
    """``Â x`` and ``Âᵀ g`` on 4 ranks against JAX's ``sharded_ell_spmm``
    / ``sharded_spmm`` and their transposes; the same rounding of the
    operand into the gather dtype, f32 sums in another order."""
    g = graphs[name]
    a_hat = jax_a_hat(g["adj"])
    want_f, want_b, b, op = _jax_spmm(a_hat, mesh, exchange, fmt, dtype,
                                      g["x"], g["g"])
    key = f"spmm/{name}/{exchange}/{fmt}/{dtype}"
    rpp = op.rows_per_part
    assert all(bool(r[key + "/halo"]) == (exchange == "halo") for r in world4)
    got_f = jpart.unpad_node_array(_gather(world4, key + "/fwd"), b, rpp)
    got_b = jpart.unpad_node_array(_gather(world4, key + "/bwd"), b, rpp)
    # both sides gather the same bf16 operands: the f32 ones set the scale
    _spmm_close(got_f, want_f, a_hat, g["x"], key + " forward")
    _spmm_close(got_b, want_b, a_hat.T, g["g"], key + " transpose")


@pytest.mark.parametrize("name", ("small", "banded"))
def test_auto_exchange_matches_jax(world4, graphs, mesh, name):
    """"auto" picks what JAX picks (halo on the banded graph, all-gather
    on the random one); the ranks' sent and received halo rows add up to
    JAX's real halo row count."""
    a_hat = jax_a_hat(graphs[name]["adj"])
    op, _ = make_sharded_coo_op(a_hat, mesh, pad_multiple=64,
                                exchange="auto")
    key = f"spmm/{name}/auto/ell/float32"
    assert bool(world4[0][key + "/halo"]) == (op.col_h is not None)
    assert (name == "banded") == (op.col_h is not None)
    rows = np.stack([r[key + "/rows"] for r in world4])
    if op.col_h is not None:
        assert rows[:, 0].sum() == rows[:, 1].sum() == op.halo_rows


@pytest.mark.parametrize("exchange,fmt", FORWARD_CASES)
def test_sharded_forward_matches_jax(world4, jax_models, exchange, fmt):
    """The acmgcnp forward (hoisted layer 1, projected LayerNorm) on 4
    ranks against JAX's on its mesh, from the same flax parameters."""
    _, model, variables, ops, x, b, rpp = jax_models[(exchange, fmt)]
    want = jpart.unpad_node_array(np.asarray(jax.jit(
        lambda v, x_, o: model.apply(v, x_, o, training=False))(
            variables, x, ops)), b, rpp)
    got = jpart.unpad_node_array(
        _gather(world4, f"forward/{exchange}/{fmt}/logits"), b, rpp)
    tol = 1e-5 * MODEL_CFG["hidden"] ** 0.5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("exchange,fmt", RUNNER_CASES)
def test_split_runner_matches_jax(world4, jax_models, model_graph, mesh,
                                  exchange, fmt):
    """20 joint epochs on 4 ranks (global loss and metrics, all-reduced
    gradients) against JAX's runner on the mesh: equal best metrics and
    epochs, parameters within 1e-4 (tests/test_torch_trainer.py's f32
    rule), and every rank holding rank 0's parameters."""
    adj, _, labels = model_graph
    jcfg, model, variables, ops, x, b, rpp = jax_models[(exchange, fmt)]
    place = (lambda v: shard_node_array(v, b, rpp, mesh))
    onehot = np.eye(int(labels.max()) + 1, dtype=np.float32)[labels]
    masks = tuple(place(m) for m in _masks(adj.shape[0]))
    jres, jstate = jax_split_runner(model, jcfg)(
        variables, jax.random.key(1), ops, x, place(labels.astype(np.int32)),
        place(onehot), masks, return_state=True)
    key = f"runner/{exchange}/{fmt}"
    r0 = world4[0]
    assert all(bool(r[key + "/replicas_equal"]) for r in world4)
    assert int(r0[key + "/epochs_run"]) == int(jres.epochs_run)
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(r0[f"{key}/{field}"]) == pytest.approx(
            float(getattr(jres, field)), rel=1e-5, abs=1e-5), field
    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.variables["params"]))
    for name, ref in want.items():
        np.testing.assert_allclose(r0[f"{key}/param/{name}"], ref.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("key", ZOO_FORWARD)
def test_sharded_zoo_forward_matches_jax(world4, jax_zoo, jax_zoo_runs, key):
    """Each zoo case's eval forward on 4 ranks against JAX's on its mesh,
    from the same flax parameters: the structure channel's raw adjacency
    on ``adj_low``'s boundaries (halo), the valued symmetric halves (ELL
    halo, COO), variant 1, gcnII; ``1e-5·sqrt(hidden)`` relative."""
    b, rpp = jax_zoo[key][5:]
    want = jax_zoo_runs[key][0]
    got = jpart.unpad_node_array(_gather(world4, f"forward/zoo/{key}/logits"),
                                 b, rpp)
    tol = 1e-5 * MODEL_CFG["hidden"] ** 0.5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("key", list(ZOO_CASES))
def test_sharded_zoo_runner_matches_jax(world4, jax_zoo_runs, key):
    """20 epochs of each zoo case on 4 ranks against JAX's runner on the
    mesh (ROC-AUC: every rank ranks the gathered logits; JAX's over its
    sharded ones): best metrics within 1e-5, equal epochs, parameters
    within 1e-4, the replicas equal."""
    _, jres, want = jax_zoo_runs[key]
    tag = f"runner/zoo/{key}"
    r0 = world4[0]
    assert all(bool(r[tag + "/replicas_equal"]) for r in world4)
    assert int(r0[tag + "/epochs_run"]) == int(jres.epochs_run)
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(r0[f"{tag}/{field}"]) == pytest.approx(
            float(getattr(jres, field)), rel=1e-5, abs=1e-5), field
    for name, ref in want.items():
        np.testing.assert_allclose(r0[f"{tag}/param/{name}"], ref,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _close(got, want, n_terms, what):
    """Within ``1e-5·sqrt(n_terms)`` of ``max(1, max|want|)``."""
    want = np.asarray(want, np.float64)
    tol = 1e-5 * np.sqrt(n_terms) * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, f"{what}: max |err| {err:.3e} > {tol:.3e}"


def _single_card_bn(model_graph, layers, state, **over):
    """The single-card port on the BatchNorm case (``over``: config
    changes) from ``state``: the train-mode forward, the gradients of
    ``Σ logits·weights``, the statistics after it, and the runner's
    result and parameters."""
    adj, feats, labels = model_graph
    cfg = TrainConfig(**_bn_cfg(layers, **over))
    _, ops, x, y, _, nclass = prepare_data(GraphData("g", *model_graph), cfg,
                                           device="cpu")

    def model():
        m = build_model(cfg, x.shape[1], nclass, device="cpu")
        m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        return m

    net = model()
    logits = net(x, ops, training=True)
    weights = np.random.default_rng(7).normal(
        size=(adj.shape[0], nclass)).astype(np.float32)
    (logits * torch.from_numpy(weights)).sum().backward()
    out = dict(logits=logits.detach().numpy(),
               grads={k: p.grad.numpy() for k, p in net.named_parameters()},
               stats={k: b.numpy() for k, b in net.named_buffers()})
    net = model()
    out["result"] = make_split_runner(net, cfg)(
        ops, x, y, tuple(torch.from_numpy(m) for m in _masks(adj.shape[0])))
    out["params"] = {k: p.detach().numpy() for k, p in net.named_parameters()}
    return out


@pytest.mark.parametrize("layers", BN_LAYERS)
@pytest.mark.parametrize("world", (2, WORLD))
def test_sharded_batchnorm_matches_single_chip(world, layers, world2, world4,
                                               jax_bn, jax_bn_runs,
                                               model_graph):
    """acmgcnpp's skip MLP with BatchNorm (``init_layers_X`` 2, 3) on 2
    ranks (all-gather) and 4 (halo), from JAX's initial variables:
    against the single-card port and JAX's single-chip model, the
    train-mode forward (dropout 0; the statistics over every rank's real
    rows, summed over the ranks), the gradients of ``Σ logits·weights``
    (the statistics' backward summed over the ranks), the running
    statistics after it (equal on every rank), and 20 joint epochs at lr
    1e-3 without decay (best metrics, epochs, parameters; the replicas
    equal).  Each within ``1e-5·sqrt(N)``: N rows is the statistics'
    reduction length."""
    n = model_graph[0].shape[0]
    ranks = world2 if world == 2 else world4
    b, rpp = jax_bn_runs["boundaries"][world]
    key = f"bn/{layers}"
    single = _single_card_bn(model_graph, layers,
                             _bn_state(jax_bn[layers][3]))
    jax_side = jax_bn_runs[layers]
    got = jpart.unpad_node_array(_gather(ranks, f"{key}/logits"), b, rpp)
    for ref, who in ((single, "port"), (jax_side, "jax")):
        _close(got, ref["logits"], n, f"{who} logits")
        for name, want in ref["grads"].items():
            _close(ranks[0][f"{key}/grad/{name}"], want, n,
                   f"{who} d {name}")
        for name, want in ref["stats"].items():
            for r in ranks:
                np.testing.assert_array_equal(r[f"{key}/buffer/{name}"],
                                              ranks[0][f"{key}/buffer/{name}"])
            _close(ranks[0][f"{key}/buffer/{name}"], want, n,
                   f"{who} {name}")
        res = ref["result"]
        assert int(ranks[0][f"{key}/runner/epochs_run"]) == int(
            res.epochs_run)
        for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
            _close(ranks[0][f"{key}/runner/{field}"],
                   float(getattr(res, field)), n, f"{who} {field}")
        for name, want in ref["params"].items():
            _close(ranks[0][f"{key}/runner/param/{name}"], want, n,
                   f"{who} trained {name}")
    assert all(bool(r[f"{key}/runner/replicas_equal"]) for r in ranks)


def test_sharded_batchnorm_experiment_matches_jax(world2, jax_bn,
                                                  jax_bn_runs, model_graph):
    """``run_experiment_sharded`` on 2 ranks (acmgcnpp with BatchNorm,
    dropout 0, 2 splits x 20 epochs, each split from the initial
    variables JAX's ``run_experiment`` draws) against JAX's
    ``run_experiment``: equal per-split test accuracies and epochs, the
    last split's parameters within ``1e-5·sqrt(N)``."""
    jout, seen = jax_bn_runs["experiment"]
    for (variables, _), want in zip(seen, jax_bn["experiment"]):
        for a, b in zip(jax.tree_util.tree_leaves(variables),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r0 = world2[0]
    np.testing.assert_allclose(r0["bn/experiment/per_split"],
                               jout["per_split"], rtol=0, atol=1e-6)
    assert int(r0["bn/experiment/epochs_total"]) == jout["epochs_total"]
    assert all(bool(r["bn/experiment/replicas_equal"]) for r in world2)
    for name, want in _bn_state({"params": seen[-1][1]}).items():
        _close(r0[f"bn/experiment/param/{name}"], want,
               model_graph[0].shape[0], name)


def test_sharded_batchnorm_check_is_well_conditioned(jax_bn, model_graph):
    """The BatchNorm runs above can show a fault at ``1e-5·sqrt(N)`` only
    where one card's own two summation orders (ELL, dense) part by far
    less after the same 20 epochs: so with ``BN_CFG``'s weight decay
    (every parameter within a tenth of the tolerance, equal metrics),
    and not without it, where lin_0's bias parts by more than 1e-3."""
    n = model_graph[0].shape[0]
    tol = 1e-5 * np.sqrt(n)
    for layers in BN_LAYERS:
        state = _bn_state(jax_bn[layers][3])
        for wd, conditioned in ((BN_CFG["weight_decay"], True), (0.0, False)):
            ell, dense = (_single_card_bn(model_graph, layers, state,
                                          weight_decay=wd,
                                          operator_format=fmt)
                          for fmt in ("ell", "dense"))
            worst = max(float(np.abs(ell["params"][k]
                                     - dense["params"][k]).max())
                        for k in ell["params"])
            if conditioned:
                assert worst < tol / 10, (layers, worst)
                for f in ("test_metric", "val_metric"):
                    assert float(getattr(ell["result"], f)) == float(
                        getattr(dense["result"], f)), (layers, f)
            else:
                assert worst > 1e-3, (layers, worst)


def test_jax_sharded_batchnorm_counts_pad_rows(world4, jax_bn, jax_bn_runs,
                                               model_graph):
    """Where the last slab has pad rows, JAX's sharded BatchNorm (the
    JAX package's ``shard_map`` model on 4 devices, train mode) departs
    from its own single-chip model by far more than the tolerance: it
    averages over every padded row, whose values after ``lin_0`` and the
    ReLU are ``relu(bias)``.  The port's 4 ranks count the real rows
    only and stay within ``1e-5·sqrt(N)`` of the single-chip model
    (ROADMAP.md §C)."""
    n = model_graph[0].shape[0]
    b, rpp = jax_bn_runs["boundaries"][WORLD]
    assert rpp > b[-1] - b[-2]            # the last slab has pad rows
    want = jax_bn_runs[2]["logits"]
    jax_sharded = jax_bn_runs["sharded_logits"]
    tol = 1e-5 * np.sqrt(n) * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(jax_sharded - want).max()) > 100 * tol
    got = jpart.unpad_node_array(_gather(world4, "bn/2/logits"), b, rpp)
    _close(got, want, n, "the port's 4 ranks")


@pytest.mark.parametrize("joint,per_body", ((True, 1), (False, 2)))
def test_sharded_body_all_reduces(group_of_one, model_graph, monkeypatch,
                                  joint, per_body):
    """The runner's all-reduces (``trainer.all_reduce_sum``): the mask
    counts once a split, then one a joint body (the metric shares ride
    behind the gradients) and two a sequential one (the train-loss share
    with the gradients, then the eval shares).  BatchNorm's own, through
    ``sum_over_ranks``, are apart: one in the train forward and one in
    its backward a body."""
    from acmgnn_tpu_torch.parallel import multihost
    from acmgnn_tpu_torch.train import trainer

    calls = {"runner": 0, "all": 0}

    def counted(key, fn):
        def wrapper(t, group=None):
            calls[key] += 1
            return fn(t, group)
        return wrapper

    monkeypatch.setattr(trainer, "all_reduce_sum",
                        counted("runner", trainer.all_reduce_sum))
    monkeypatch.setattr(multihost, "all_reduce_sum",
                        counted("all", multihost.all_reduce_sum))
    cfg = TrainConfig(**dict(_bn_cfg(2), joint=joint, epochs=6,
                             dropout=0.5))
    prep = prepare_sharded_data(GraphData("g", *model_graph), cfg,
                                group=group_of_one, device="cpu")
    model = build_model(cfg, prep.x.shape[1], prep.nclass, device="cpu")
    _, state = make_split_runner(model, cfg, group=group_of_one)(
        prep.ops, prep.x, prep.labels,
        tuple(prep.place(m) for m in _masks(model_graph[0].shape[0])),
        return_state=True)
    bodies = state.epoch
    assert bodies == cfg.epochs + int(joint)
    assert calls["runner"] == 1 + per_body * bodies
    assert calls["all"] == 2 * bodies


def test_runner_captures_exactly_on_nccl_cards(group_of_one, model_graph,
                                               monkeypatch):
    """``capture_device``: the split loop is captured on a card, alone or
    in a group whose backend is NCCL, and never on the CPU, on a gloo
    group, or with ``graph=False`` (the backend stubbed: the CPU has no
    NCCL).  The runner asks it with its device, group and ``graph``, and
    a gloo run ends with ``capture_ms`` None."""
    import torch.distributed as dist

    from acmgnn_tpu_torch.train import trainer

    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert trainer.capture_device(card) == card
    assert trainer.capture_device(card, graph=False) is None
    assert trainer.capture_device(card, group_of_one) is None      # gloo
    assert trainer.capture_device(cpu) is None
    backend = dist.get_backend
    monkeypatch.setattr(dist, "get_backend",
                        lambda group=None: "nccl")
    assert trainer.capture_device(card, group_of_one) == card
    assert trainer.capture_device(card, group_of_one, graph=False) is None
    assert trainer.capture_device(cpu, group_of_one) is None
    monkeypatch.setattr(dist, "get_backend", backend)
    asked = []
    choose = trainer.capture_device
    monkeypatch.setattr(trainer, "capture_device", lambda *a: asked.append(
        a) or choose(*a))
    cfg = TrainConfig(**dict(EXPERIMENT_CFG, epochs=2))
    prep = prepare_sharded_data(GraphData("g", *model_graph), cfg,
                                group=group_of_one, device="cpu")
    model = build_model(cfg, prep.x.shape[1], prep.nclass, device="cpu")
    _, state = make_split_runner(model, cfg, group=group_of_one)(
        prep.ops, prep.x, prep.labels,
        tuple(prep.place(m) for m in _masks(model_graph[0].shape[0])),
        return_state=True)
    assert asked == [(cpu, group_of_one, True)]
    assert state.capture_ms is None


def _single_chip(model_graph, cfg_kw):
    """The single-chip port under ``run_experiment_sharded``'s protocol
    (its masks and initial parameters): the splits' test metrics and the
    last split's parameters."""
    adj, feats, labels = model_graph
    cfg = TrainConfig(**cfg_kw)
    _, ops, x, y, _, nclass = prepare_data(GraphData("g", adj, feats, labels),
                                           cfg, device="cpu")
    rng = np.random.default_rng(cfg.seed)
    tests = []
    for idx in range(cfg.num_splits):
        masks = random_disassortative_splits(labels, nclass, rng=rng)
        model = build_model(cfg, x.shape[1], nclass, device="cpu",
                            seed=cfg.seed + idx)
        res = make_split_runner(model, cfg)(
            ops, x, y, tuple(torch.from_numpy(m) for m in masks),
            seed=cfg.seed + idx)
        tests.append(float(res.test_metric))
    return tests, {k: p.detach().numpy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("world", (1, 2, WORLD))
def test_entry_point_world_sizes_agree(world, world2, world4, model_graph):
    """``run_experiment_sharded`` at world sizes 1 (in this process, no
    group), 2 and 4 against the single-chip port on the same splits and
    initial parameters: equal test metrics and epochs, the last split's
    parameters within 1e-5, the replicas equal from start to end."""
    adj, feats, labels = model_graph
    tests, want = _single_chip(model_graph, EXPERIMENT_CFG)
    if world == 1:
        out, model = run_experiment_sharded(
            GraphData("g", adj, feats, labels), TrainConfig(**EXPERIMENT_CFG),
            device="cpu", return_model=True)
        got = {k: p.detach().numpy() for k, p in model.named_parameters()}
        test_mean, devices = out["test_mean"], out["devices"]
    else:
        ranks = world2 if world == 2 else world4
        r0 = ranks[0]
        assert all(bool(r["experiment/start_equal"])
                   and bool(r["experiment/replicas_equal"]) for r in ranks)
        got = {k[len("experiment/param/"):]: v for k, v in r0.items()
               if k.startswith("experiment/param/")}
        test_mean, devices = r0["experiment/test_mean"], r0["experiment/devices"]
    assert int(devices) == world
    assert float(test_mean) == float(np.mean(tests))
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_entry_point_takes_reorder_and_bf16_features(world2, model_graph):
    """World size 2 with ``reorder="rcm"`` (applied before partitioning)
    and bf16 feature storage, halo exchange, against the single-card
    ``run_experiment`` with the same knobs: the same masks (drawn in the
    reordered label space) and initial parameters, so equal test metrics
    and the last split's parameters within 1e-5."""
    models = []

    def keep(model, *args, **kwargs):
        models.append(model)
        return make_split_runner(model, cfg)(*args, **kwargs)

    cfg = TrainConfig(**KNOBS_CFG)
    want = run_experiment(GraphData("g", *model_graph), cfg, runner=keep,
                          device="cpu")
    ranks = world2
    assert all(bool(r["knobs/start_equal"]) and bool(r["knobs/replicas_equal"])
               for r in ranks)
    assert int(ranks[0]["knobs/devices"]) == 2
    assert float(ranks[0]["knobs/test_mean"]) == pytest.approx(
        want["test_mean"], abs=1e-6)
    assert int(ranks[0]["knobs/epochs_total"]) == want["epochs_total"]
    for name, p in models[-1].named_parameters():
        np.testing.assert_allclose(ranks[0][f"knobs/param/{name}"],
                                   p.detach().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _buffer_nodes(ops, boundaries, p, transpose=False):
    """The node whose value each row of rank p's receive buffer holds."""
    rpp = ops[p].rows_per_part
    own = [int(boundaries[q]) + np.arange(rpp) for q in range(len(ops))]
    send = [op.send_idx_t if transpose else op.send_idx for op in ops]
    if send[p] is None:                     # all-gather: every rank's slab
        return np.concatenate(own)
    return np.concatenate([own[p]] + [int(boundaries[q]) + send[q][p].numpy()
                                      for q in range(len(ops))])


def _ell_terms(half, nodes, row0=0):
    """An ELL half's (output node, column node) pairs in its summation
    order, rows ascending."""
    deg = np.diff(half.indptr.numpy())
    rows = np.repeat(half.row_ids.numpy().astype(np.int64), deg) + row0
    order = np.argsort(rows, kind="stable")
    return rows[order], nodes[half.indices.numpy()][order]


def test_sharded_card_check_is_well_conditioned():
    """chip_smoke.py phase 6c holds each 4-rank run to the single-chip
    port within 1e-4 after ``SHARDED_CHECK_EPOCHS`` epochs.  Only a
    configuration that does not amplify rounding can show faults that
    way: there, the single-chip port with its two summation orders (ELL,
    COO) parts by less than a tenth of that.  And the sharded halves sum
    every row in the single-chip order, so a rank's rounding differs
    from one card's only in the reductions split over ranks: a rank's
    ELL rows list their columns, mapped back to nodes, in the single-chip
    half's order, and a rank's COO half holds the single-chip triplets in
    order on the single-chip slice grid."""
    import chip_smoke

    assert chip_smoke.SHARDED_CHECK_EPOCHS == 20
    data = chip_smoke._small_twitch()
    params = []
    for fmt in ("ell", "coo"):
        cfg = chip_smoke.sharded_check_config(fmt)
        _, ops, x, y, _, nclass = prepare_data(data, cfg, device="cpu")
        masks = random_disassortative_splits(
            data.labels, nclass, rng=np.random.default_rng(cfg.seed))
        model = build_model(cfg, x.shape[1], nclass, device="cpu",
                            seed=cfg.seed)
        make_split_runner(model, cfg)(
            ops, x, y, tuple(torch.from_numpy(m) for m in masks),
            seed=cfg.seed)
        params.append({k: p.detach() for k, p in model.named_parameters()})
    worst = max(float((params[0][k] - params[1][k]).abs().max())
                for k in params[0])
    assert worst < 1e-5, worst

    a_hat = row_normalized_adjacency(data.adj)
    ell1, coo1 = make_ell_op(a_hat), make_coo_op(a_hat)
    world = chip_smoke.SHARDED_P
    for exchange in ("allgather", "halo"):
        ells, b = tsharded.make_sharded_ell_op(a_hat, world, None,
                                               exchange=exchange)
        coos, _ = tsharded.make_sharded_coo_op(a_hat, world, None,
                                               exchange=exchange,
                                               boundaries=b)
        if exchange == "halo":
            assert ells[0].send_idx is not None
        for p in range(world):
            for tr in (False, True):
                nodes = _buffer_nodes(ells, b, p, tr)
                got = _ell_terms(ells[p].bwd if tr else ells[p].fwd, nodes,
                                 int(b[p]))
                rows, cols = _ell_terms(ell1.bwd if tr else ell1.fwd,
                                        np.arange(data.num_nodes))
                mine = (rows >= b[p]) & (rows < b[p + 1])
                np.testing.assert_array_equal(got[0], rows[mine])
                np.testing.assert_array_equal(got[1], cols[mine])

                half = coos[p].bwd if tr else coos[p].fwd
                whole = coo1.bwd if tr else coo1.fwd
                lo = int(np.searchsorted(whole.row.numpy(), b[p]))
                hi = lo + half.nnz
                np.testing.assert_array_equal(half.row.numpy() + b[p],
                                              whole.row.numpy()[lo:hi])
                np.testing.assert_array_equal(
                    _buffer_nodes(coos, b, p, tr)[half.col.numpy()],
                    whole.col.numpy()[lo:hi])
                k = np.arange(half.nnz)
                grid = ((lo + k) // whole.slice_nnz
                        - (k + half.slice_offset) // half.slice_nnz)
                assert np.all(grid == grid[0])


# ---------------------------------------------------------------------------
# Host pieces and refusals
# ---------------------------------------------------------------------------


def test_splits_match_jax(model_graph):
    _, _, labels = model_graph
    got = random_disassortative_splits(labels, 2, rng=np.random.default_rng(3))
    want = jax_random_splits(labels, 2, rng=np.random.default_rng(3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    idx = (np.arange(5), np.arange(5, 9), np.arange(9, 12))
    for a, b in zip(indices_to_masks(14, *idx),
                    jax_indices_to_masks(14, *idx)):
        np.testing.assert_array_equal(a, b)


def test_permute_graph_matches_jax(graphs):
    adj = graphs["small"]["adj"]
    perm = np.random.default_rng(4).permutation(adj.shape[0])
    assert (permute_graph(adj, perm) != jax_permute_graph(adj, perm)).nnz == 0


def test_init_distributed_needs_a_group_or_the_card(monkeypatch):
    """Without torchrun's variables it joins nothing; asking for the card
    where there is none raises before any group is made."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed(rank=0, world_size=1,
                         init_method="tcp://127.0.0.1:1")


def test_sharded_path_refuses_what_is_not_ported(model_graph, monkeypatch,
                                                 tmp_path):
    """The sharded path refuses by name only the k-hop operator
    (acmsgc/sgc ``hops > 1``); acmgcnpp's BatchNorm (``init_layers_X >
    1``), ROC-AUC with a group, checkpointing and per-rank slab loading
    run.  Without a card and without ``device="cpu"`` it raises;
    fixed splits without attached ones read the mask files by name."""
    monkeypatch.setenv("ACMGNN_DATA_PATH", str(tmp_path))
    adj, feats, labels = model_graph
    data = GraphData("g", adj, feats, labels)
    cfg = TrainConfig(**dict(EXPERIMENT_CFG, epochs=2, num_splits=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_experiment_sharded(data, cfg)
    for over, name in ((dict(model_type="acmsgc", hops=2), "hops 2"),
                       (dict(model_type="sgc", hops=3), "hops 3")):
        with pytest.raises(NotImplementedError, match=name):
            run_experiment_sharded(data, dataclasses.replace(cfg, **over),
                                   device="cpu")
    assert run_experiment_sharded(data, dataclasses.replace(
        cfg, model_type="acmgcnpp", init_layers_X=2),
        device="cpu")["epochs_total"] == 2
    model = build_model(cfg, feats.shape[1], 2, device="cpu")
    make_split_runner(model, dataclasses.replace(cfg, metric="rocauc"),
                      group=object())
    out = run_experiment_sharded(data, cfg, device="cpu",
                                 checkpoint_dir=str(tmp_path / "ckpt"),
                                 checkpoint_every=1, per_host_loading=True)
    assert out["epochs_total"] == 2
    assert (tmp_path / "ckpt" / "split0_state").exists()
    # no generator state: dropout's keys follow from the loop's counter
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "split0_state"]
    # fixed splits without attached ones: the mask files, searched by name
    with pytest.raises(FileNotFoundError, match="g_split_0.6_0.2_0.npz"):
        run_experiment_sharded(data, dataclasses.replace(
            cfg, fixed_splits=True), device="cpu")


# ---------------------------------------------------------------------------
# Per-rank slab loading, ROC-AUC at one rank, cut-and-resume, retries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trailing", ((), (7,)))
def test_per_rank_slabs_match_jax(graphs, mesh, trailing):
    """``rank_rows`` gives JAX's ``host_local_rows`` (one range a rank;
    JAX's single process owns all four); ``shard_node_array_per_host``
    calls its loader once a rank with that range, as JAX's does once a
    partition, and its slabs equal JAX's and ``shard_node_array``'s bit
    for bit (a 1-D and a 2-D node array)."""
    from acmgnn_tpu.parallel.multihost import (
        host_local_rows,
        shard_node_array_per_host as jax_per_host,
    )
    from acmgnn_tpu_torch.parallel.multihost import (
        rank_rows,
        shard_node_array_per_host,
    )

    adj = graphs["small"]["adj"]
    b = tpart.partition_rows(adj, WORLD)
    rpp = int(np.diff(b).max())
    n = adj.shape[0]
    arr = np.random.default_rng(3).normal(size=(n,) + trailing).astype(
        np.float32)
    assert [(p,) + rank_rows(b, p) for p in range(WORLD)] == [
        (int(p), int(r0), int(r1))
        for p, r0, r1, _ in host_local_rows(b, rpp, mesh)]
    calls = {"jax": [], "port": []}

    def loader(who):
        def load(r0, r1):
            calls[who].append((r0, r1))
            return arr[r0:r1]
        return load

    want = np.asarray(jax_per_host(loader("jax"), b, rpp, mesh, np.float32,
                                   trailing_shape=trailing))
    for p in range(WORLD):
        got = shard_node_array_per_host(loader("port"), b, rpp, p,
                                        np.float32, trailing)
        assert got.shape == (rpp,) + trailing
        assert torch.equal(got, tsharded.shard_node_array(arr, b, rpp, p))
        np.testing.assert_array_equal(got.numpy(),
                                      want[p * rpp:(p + 1) * rpp])
    assert sorted(calls["port"]) == sorted(calls["jax"]) == [
        (int(b[p]), int(b[p + 1])) for p in range(WORLD)]


@pytest.fixture()
def group_of_one():
    """A gloo group of this process alone: the sharded path's collectives
    (gathers, all-reduces) run, at world size 1."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("joint", (True, False))
def test_sharded_rocauc_at_one_rank_is_the_single_card(group_of_one,
                                                       model_graph, joint):
    """ROC-AUC on the sharded path in a group of one rank (the logits and
    the packed words gathered, one rank pass) against the single-card
    port: the split's best val and test AUCs, val loss, train loss,
    epochs and parameters bit for bit, and ``run_experiment_sharded``'s
    per-split AUCs bit for bit against ``run_experiment``'s."""
    adj, feats, labels = model_graph
    data = GraphData("g", adj, feats, labels)
    cfg = TrainConfig(**dict(EXPERIMENT_CFG, loss="bce", metric="rocauc",
                             joint=joint, dropout=0.5, early_stopping=4))
    masks = tuple(torch.from_numpy(m) for m in _masks(adj.shape[0]))
    prep = prepare_sharded_data(data, cfg, group=group_of_one, device="cpu")
    _, ops, x, y, y1h, nclass = prepare_data(data, cfg, device="cpu")
    runs = []
    for args, group in (((prep.ops, prep.x, prep.labels,
                          tuple(prep.place(m.numpy()) for m in masks),
                          prep.labels_onehot), group_of_one),
                        ((ops, x, y, masks, y1h), None)):
        model = build_model(cfg, x.shape[1], nclass, device="cpu", seed=2)
        res = make_split_runner(model, cfg, group=group)(
            *args[:4], seed=2, labels_onehot=args[4])
        runs.append((res, model))
    (got, m_got), (want, m_want) = runs
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert got.epochs_run == want.epochs_run
    for (name, a), b in zip(m_got.named_parameters(), m_want.parameters()):
        assert torch.equal(a, b), name
    sharded = run_experiment_sharded(data, cfg, device="cpu")
    single = run_experiment(data, cfg, device="cpu")
    assert sharded["per_split"] == single["per_split"]
    assert sharded["epochs_total"] == single["epochs_total"]


def _assert_resumed(ranks, loop):
    """Each rank's four runs (no checkpoints; checkpointed whole; cut at
    half the last split's epochs and resumed; checkpointed whole with a
    fresh split runner for every segment, where the others keep one
    runner a run) equal bit for bit: per-split test metrics, epochs, the
    last split's parameters; and the whole, the resumed and the fresh
    runners' last snapshots (parameters, Adam's moments and step, the
    loop state with the loss and val histories and best metrics) equal,
    key for key."""
    for r, out in enumerate(ranks):
        key = f"resume/{loop}"
        for name in ("whole", "resumed", "fresh"):
            for field in ("per_split", "epochs_total"):
                np.testing.assert_array_equal(
                    out[f"{key}/{name}/{field}"],
                    out[f"{key}/plain/{field}"], err_msg=f"{r} {name}")
            params = [k for k in out if k.startswith(f"{key}/plain/param/")]
            assert params
            for k in params:
                np.testing.assert_array_equal(
                    out[k.replace("/plain/", f"/{name}/")], out[k],
                    err_msg=f"rank {r} {name} {k}")
        snaps = {k[len(f"{key}/whole/snap/"):] for k in out
                 if k.startswith(f"{key}/whole/snap/")}
        assert any("val_hist" in k for k in snaps)
        for other in ("cut", "fresh"):
            assert snaps == {k[len(f"{key}/{other}/snap/"):] for k in out
                             if k.startswith(f"{key}/{other}/snap/")}
            for k in snaps:
                np.testing.assert_array_equal(
                    out[f"{key}/{other}/snap/{k}"],
                    out[f"{key}/whole/snap/{k}"], err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("loop", list(RESUME_CFG))
@pytest.mark.parametrize("world", (1, 2))
def test_sharded_resume_is_bit_exact(world, loop, world2, model_graph,
                                     tmp_path):
    """``run_experiment_sharded`` with ``checkpoint_every=3`` (2 splits x
    12 epochs, dropout 0.5: each segment's masks follow from the loop's
    counter in the snapshot), cut right
    after the last split's snapshot at half its epochs and resumed,
    equals the uninterrupted run and the run without checkpoints bit for
    bit, and so does the checkpointed run with a fresh split runner for
    every segment (the run's one runner rewrites its tensors in place
    between segments); the joint loop (budget 13 bodies) and the
    sequential one (acmgcnpp with the structure channel).  World size 1
    in this process, 2 in the module's world of 2 ranks."""
    if world == 2:
        _assert_resumed(world2, loop)
        return
    import _torch_sharded_worker as worker

    adj, feats, labels = model_graph
    inputs = _graph_inputs("model", sp.csr_matrix(adj), features=feats,
                           labels=labels)
    out: dict = {}
    worker.run_resume(next(j for j in _resume_jobs(tmp_path)
                           if j["key"] == f"resume/{loop}"),
                      inputs, 0, 1, out)
    _assert_resumed([out], loop)


@pytest.mark.parametrize("name", list(RETRY_FAILS))
def test_sharded_retry_needs_every_rank_to_fail(world2, name):
    """On 2 ranks a transient failure after split 0's first attempt is
    retried only when every rank failed (the ranks vote): then the run
    equals the undisturbed one bit for bit; when one rank failed alone,
    every rank raises, the failed one its own error and the other the
    peer's, and no rank retries."""
    for r, out in enumerate(world2):
        key = f"retry/{name}"
        if name == "every_rank":
            assert f"{key}/raised" not in out
            assert out[f"{key}/test_mean"] == out["experiment/test_mean"]
            assert bool(out[f"{key}/replicas_equal"])
            params = [k for k in out if k.startswith("experiment/param/")]
            for k in params:
                np.testing.assert_array_equal(
                    out[k.replace("experiment/", f"{key}/")], out[k],
                    err_msg=f"rank {r} {k}")
        else:
            raised = str(out[f"{key}/raised"])
            assert ("UNAVAILABLE" in raised if r == 0
                    else "a peer rank's attempt failed" in raised), raised


@pytest.mark.parametrize("every", (0, 4))
def test_sharded_retries_a_transient_failure(model_graph, monkeypatch,
                                             tmp_path, every):
    """A transient failure ("UNAVAILABLE") raised after a split (or a
    segment) has trained is retried from the split's initial parameters
    (or the segment's state): the result equals an undisturbed run bit
    for bit, and the logger records the retry."""
    import time

    from acmgnn_tpu_torch.train import trainer

    monkeypatch.setattr(time, "sleep", lambda s: None)   # the retry's backoff
    adj, feats, labels = model_graph
    data = GraphData("g", adj, feats, labels)
    cfg = TrainConfig(**dict(EXPERIMENT_CFG, dropout=0.5))
    kw = dict(device="cpu", return_model=True, checkpoint_every=every,
              checkpoint_dir=str(tmp_path / "a") if every else None)
    want, m_want = run_experiment_sharded(data, cfg, **kw)

    make = trainer.make_split_runner
    failed = []

    def flaky(*args, **kwargs):
        runner = make(*args, **kwargs)

        def run(*a, **k):
            out = runner(*a, **k)
            if not failed and k.get("epoch_limit", 1):
                failed.append(True)
                raise RuntimeError("UNAVAILABLE: an injected failure")
            return out
        return run

    class Log:
        lines: list = []

        def info(self, msg, *args):
            self.lines.append(msg % args)

        def log_split(self, idx, res):
            pass

        def log_result(self, out):
            pass

    monkeypatch.setattr(trainer, "make_split_runner", flaky)
    if every:
        kw["checkpoint_dir"] = str(tmp_path / "b")
    got, m_got = run_experiment_sharded(data, cfg, logger=Log(), **kw)
    assert failed and any("transient failure" in ln for ln in Log.lines)
    assert got["per_split"] == want["per_split"]
    for (name, a), b in zip(m_got.named_parameters(), m_want.parameters()):
        assert torch.equal(a, b), name
