"""The port's model zoo against acmgnn_tpu's: all twelve ``MODEL_TYPES``
on the dense and the ELL operator, the structure channel, variant 1
(ACMII), acmsgc over ``Â^k`` with its 1-hop high-pass, acmgcnpp's skip
MLP with a BatchNorm, the three ``ACMGNN_LN_MODE`` lowerings, the joint
loop's paired forward, and whole ``run_experiment`` runs.

The same numpy graph and the same flax variables (copied over with
``params_from_flax``, ``batch_stats`` included) go through both
packages; outputs and ``jax.grad`` gradients are compared.  Tolerance:
``1e-5·sqrt(reduction length)·max(1, max|JAX|)`` with the reduction
over the graph's nodes (the parameter gradients' sums), as
tests/test_torch_oracle_parity.py scales it.  Whole runs are held as
tests/test_torch_experiment.py holds them (accuracies and epochs equal,
the best validation metric to 1e-5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.models.models import ACMGNN as JaxACMGNN
from acmgnn_tpu.models.models import MODEL_TYPES as JAX_MODEL_TYPES
from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.ops.graph import precompute_operators as jax_precompute
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.models.layers import MODEL_TYPES
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops.graph import GraphData, precompute_operators
from acmgnn_tpu_torch.ops.spmm import spmm
from acmgnn_tpu_torch.train import TrainConfig, run_experiment
from acmgnn_tpu_torch.train import trainer

NHID, NCLASS = 8, 4


def assert_close(ours, theirs, n_terms, msg=""):
    theirs = np.asarray(theirs, np.float32)
    tol = 1e-5 * max(1.0, float(n_terms) ** 0.5) \
        * max(1.0, float(np.abs(theirs).max()))
    ours = ours.detach().cpu().float().numpy()
    err = float(np.abs(ours - theirs).max())
    assert err <= tol, f"{msg}: max_abs_err {err:.3e} > {tol:.3e}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def _randomize(variables, rng):
    """Non-trivial LayerNorm and BatchNorm scale/bias (and BatchNorm
    running statistics), so those paths are really tested."""
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict) and {"scale", "bias"} <= set(val):
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape) \
                    .astype(np.float32)
                val["bias"] = (rng.normal(size=val["bias"].shape) * 0.1) \
                    .astype(np.float32)
            elif isinstance(val, dict) and {"mean", "var"} <= set(val):
                val["mean"] = (rng.normal(size=val["mean"].shape) * 0.1) \
                    .astype(np.float32)
                val["var"] = rng.uniform(0.5, 2.0, val["var"].shape) \
                    .astype(np.float32)
            elif isinstance(val, dict):
                walk(val)

    walk(variables)
    return variables


def _setup(small_graph, *, fmt, model_type, ops_kw=None, hoist=False,
           **model_kw):
    """Both packages' operators (with ``x_agg``) and models, the port's
    loaded with the flax variables: ``(jmodel, variables, jops, model,
    ops, x)``."""
    adj, feats, _ = small_graph
    ops_kw = dict(ops_kw or {})
    x = np.abs(feats)
    jops = jax_precompute(adj, fmt=fmt, **ops_kw)
    ops = precompute_operators(adj, fmt=fmt, **ops_kw)
    if hoist:
        jops = jops.replace(x_agg=jax_spmm(jops.adj_low, jnp.asarray(x)))
        ops.x_agg = spmm(ops.adj_low, torch.from_numpy(x))
    n, f_in = x.shape
    kw = dict(model_type=model_type, hoist_first=hoist, **model_kw)
    if kw.get("structure_info"):
        kw["nnodes"] = n
    jmodel = JaxACMGNN(nhid=NHID, nclass=NCLASS, **kw)
    variables = jmodel.init(jax.random.key(1), jnp.asarray(x), jops)
    variables = _randomize(dict(variables), np.random.default_rng(2))
    model = ACMGNN(f_in, NHID, NCLASS, **kw)
    model.load_state_dict(params_from_flax(variables))
    return jmodel, variables, jops, model, ops, x


def _check_forward_and_grads(setup, training=False, paired=False,
                             mutable=False):
    """Logits (``paired``: both branches) and the gradients of
    ``Σ logits·g`` (the train branch) over every parameter; with
    ``mutable``, the BatchNorm statistics after the call too."""
    jmodel, variables, jops, model, ops, x = setup
    n = x.shape[0]
    g = np.random.default_rng(5).normal(size=(n, NCLASS)).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rest = {k: jax.tree_util.tree_map(jnp.asarray, v)
            for k, v in variables.items() if k != "params"}

    def jloss(p):
        out = jmodel.apply({"params": p, **rest}, jnp.asarray(x), jops,
                           training=training, paired_eval=paired,
                           mutable=list(rest) if mutable else False)
        out, upd = out if mutable else (out, {})
        train = out[0] if paired else out
        return jnp.sum(train * g), (out, upd)

    (_, (jout, jupd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    out = model(torch.from_numpy(x), ops, training=training,
                paired_eval=paired)
    train = out[0] if paired else out
    (train * torch.from_numpy(g)).sum().backward()
    if paired:
        assert_close(out[0], jout[0], n, "train logits")
        assert_close(out[1], jout[1], n, "eval logits")
    else:
        assert_close(out, jout, n, "logits")
    grads = {k: p.grad for k, p in model.named_parameters()}
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for name, jg in jflat.items():
        assert grads[name] is not None, name
        assert_close(grads[name], jg, n, f"d {name}")
    if mutable:
        stats = _flat(jax.tree_util.tree_map(np.asarray,
                                             jupd["batch_stats"]))
        buffers = dict(model.named_buffers())
        assert set(stats) == set(buffers)
        for name, want in stats.items():
            assert_close(buffers[name], want, n, name)
    return model


def test_the_zoo_is_jaxs():
    assert MODEL_TYPES == JAX_MODEL_TYPES


@pytest.mark.parametrize("fmt", ("dense", "ell"))
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_model_matches_jax(model_type, fmt, small_graph):
    """Every model type: eval logits and every parameter's gradient (2
    snowball blocks, 2 GCNII layers)."""
    setup = _setup(small_graph, fmt=fmt, model_type=model_type, nlayers=2,
                   use_layernorm=model_type in ("acmgcnp", "acmgcnpp"))
    _check_forward_and_grads(setup)


CASES = {
    "acmgcnp_structure": dict(model_type="acmgcnp", structure_info=True,
                              use_layernorm=True,
                              ops_kw=dict(structure_info=True)),
    "acmgcnpp_structure": dict(model_type="acmgcnpp", structure_info=True,
                               use_layernorm=True,
                               ops_kw=dict(structure_info=True)),
    "acmgcnpp_structure_hoist": dict(
        model_type="acmgcnpp", structure_info=True, use_layernorm=True,
        hoist=True, ops_kw=dict(structure_info=True)),
    "acmgcn_variant1": dict(model_type="acmgcn", variant=True),
    "acmgcnp_variant1_structure": dict(
        model_type="acmgcnp", variant=True, structure_info=True,
        use_layernorm=True, ops_kw=dict(structure_info=True)),
    "acmsnowball_variant1": dict(model_type="acmsnowball", variant=True,
                                 nlayers=2),
    "acmsgc_hops2": dict(model_type="acmsgc", ops_kw=dict(hops=2)),
    "sgc_hops2_hoist": dict(model_type="sgc", hoist=True,
                            ops_kw=dict(hops=2)),
    "acmgcnp_sym": dict(model_type="acmgcnp", use_layernorm=True,
                        ops_kw=dict(normalization="sym")),
    "acmgcn_hoist": dict(model_type="acmgcn", hoist=True),
}


@pytest.mark.parametrize("fmt", ("dense", "ell"))
@pytest.mark.parametrize("case", tuple(CASES))
def test_model_case_matches_jax(case, fmt, small_graph):
    """The structure channel (four channels, scale 1; with the hoist),
    variant 1 (the ReLU before the propagation; with the structure
    channel), acmsgc and sgc with ``hops`` 2 (``adj_hp_base``), symmetric
    normalization."""
    kw = dict(CASES[case])
    setup = _setup(small_graph, fmt=fmt, **kw)
    _check_forward_and_grads(setup)


@pytest.mark.parametrize("mode", ("proj", "modules", "batched"))
def test_layernorm_modes_match_jax(mode, small_graph, monkeypatch):
    """``ACMGNN_LN_MODE``: each lowering of the JAX package against the
    port, which runs all three as K2/K3's projected LayerNorm; an
    unknown mode is refused."""
    monkeypatch.setenv("ACMGNN_LN_MODE", mode)
    setup = _setup(small_graph, fmt="ell", model_type="acmgcnp",
                   use_layernorm=True, structure_info=True,
                   ops_kw=dict(structure_info=True))
    _check_forward_and_grads(setup)
    monkeypatch.setenv("ACMGNN_LN_MODE", "fused")
    with pytest.raises(ValueError, match="ACMGNN_LN_MODE"):
        setup[3](torch.from_numpy(setup[5]), setup[4])


@pytest.mark.parametrize("fmt", ("dense", "ell"))
@pytest.mark.parametrize("paired", (False, True))
def test_batchnorm_in_train_mode_matches_jax(paired, fmt, small_graph):
    """acmgcnpp with ``init_layers_X = 2``: in train mode (dropout 0) the
    skip MLP's BatchNorm normalizes with the batch statistics and
    updates its running ones (biased variance, momentum 0.9), which the
    paired eval branch then reads; logits, gradients and the statistics
    after the call against flax's ``mutable=["batch_stats"]``; then eval
    logits on the updated statistics."""
    setup = _setup(small_graph, fmt=fmt, model_type="acmgcnpp",
                   init_layers_X=2, dropout=0.0, use_layernorm=True)
    jmodel, variables, jops, model, ops, x = setup
    _check_forward_and_grads(setup, training=True, paired=paired,
                             mutable=True)
    _, upd = jmodel.apply(
        {k: jax.tree_util.tree_map(jnp.asarray, v)
         for k, v in variables.items()}, jnp.asarray(x), jops,
        training=True, mutable=["batch_stats"])
    jeval = jmodel.apply({"params": variables["params"], **upd},
                         jnp.asarray(x), jops, training=False)
    with torch.no_grad():
        assert_close(model(torch.from_numpy(x), ops), jeval, x.shape[0],
                     "eval logits on the updated statistics")


@pytest.mark.parametrize("fmt", ("dense", "ell"))
def test_paired_forward_with_structure_matches_jax(fmt, small_graph):
    """The joint loop's paired forward of acmgcnpp with the structure
    channel (one structure gather shared by both branches) against JAX's
    ``paired_eval=True``, the hoisted layer 1 included."""
    setup = _setup(small_graph, fmt=fmt, model_type="acmgcnpp",
                   structure_info=True, use_layernorm=True, hoist=True,
                   dropout=0.0, ops_kw=dict(structure_info=True))
    _check_forward_and_grads(setup, training=True, paired=True)


@pytest.mark.parametrize("fmt", ("dense", "ell"))
@pytest.mark.parametrize("case", ("acmgcnpp_structure_hoist",
                                  "acmgcnp_variant1_structure",
                                  "acmgcn_variant1"))
def test_paired_eval_branch_takes_no_gradient(case, fmt, small_graph):
    """The port detaches the paired eval branch (its channels, attention
    operands and acmgcnpp's ``mlpX`` output), to which JAX's gradient of
    the train loss gives a zero cotangent: under ``paired_eval`` the
    parameter gradients equal JAX's and the port's own without the eval
    branch."""
    setup = _setup(small_graph, fmt=fmt, dropout=0.0, **CASES[case])
    model = _check_forward_and_grads(setup, training=True, paired=True)
    paired = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    x, ops = setup[5], setup[4]
    g = np.random.default_rng(5).normal(size=(x.shape[0], NCLASS))
    out = model(torch.from_numpy(x), ops, training=True)
    (out * torch.from_numpy(g.astype(np.float32))).sum().backward()
    for name, p in model.named_parameters():
        assert torch.equal(p.grad, paired[name]), name


def test_paired_eval_is_refused_outside_the_joint_models(small_graph):
    setup = _setup(small_graph, fmt="dense", model_type="acmsgc")
    with pytest.raises(ValueError, match="paired_eval"):
        setup[3](torch.from_numpy(setup[5]), setup[4], paired_eval=True)


# ---------------------------------------------------------------------------
# whole runs through both packages' run_experiment
# ---------------------------------------------------------------------------

RUNS = {
    # joint loop, ELL, LayerNorm, hoist, the structure channel
    "acmgcnpp_structure_joint": dict(
        model_type="acmgcnpp", structure_info=True, operator_format="ell",
        joint=True, hoist_first=True),
    # sequential loop on the dense operator over Â²
    "acmsgc_hops2_sequential": dict(model_type="acmsgc", hops=2,
                                    operator_format="dense", joint=False),
}


@pytest.mark.parametrize("run", tuple(RUNS))
def test_run_experiment_matches_jax(run, small_graph):
    """One split of ``run_experiment`` in each package from JAX's
    initial variables (the runner hooks): masks, test accuracy and
    epochs equal, best val accuracy to 1e-5, parameters to 1e-4.

    At lr 1e-3 without weight decay: at the headline's lr 0.01 and decay
    1e-3 on these random labels the joint acmgcnpp run crosses a ReLU
    input within rounding of zero, and the port's own ELL, COO and dense
    summation orders part by 3.3e-3 to 7.4e-3 after 15 epochs, as far as
    it parts from JAX (8.0e-3; ROADMAP.md §C, conditioning); at 1e-3 all
    four agree to 4.8e-7."""
    adj, feats, labels = small_graph
    graph = (adj, np.abs(feats), labels)
    cfg_kw = dict(hidden=16, dropout=0.0, lr=1e-3, weight_decay=0.0,
                  epochs=15, early_stopping=0, selection="val_metric",
                  spmm_dtype="float32", num_splits=1, seed=3, **RUNS[run])
    jcfg = JaxTrainConfig(**cfg_kw)
    jmodel = jtrainer.build_model(jcfg, int(labels.max()) + 1, adj.shape[0])
    jrun = jax.jit(jtrainer.make_split_runner(jmodel, jcfg),
                   static_argnames=("return_state",))
    jseen = []

    def jhook(variables, key, ops, x, y, y1h, masks):
        res, state = jrun(variables, key, ops, x, y, y1h, masks,
                          return_state=True)
        jseen.append((variables, [np.asarray(m) for m in masks], res,
                      state.variables["params"]))
        return res

    jtrainer.run_experiment(JaxGraphData("g", *graph), jcfg, runner=jhook)
    cfg = TrainConfig(**cfg_kw)
    seen = []

    def hook(model, ops, x, y, masks, *, seed, labels_onehot, hparams):
        model.load_state_dict(params_from_flax(jax.tree_util.tree_map(
            np.asarray, jseen[0][0])))
        res = trainer.make_split_runner(model, cfg)(
            ops, x, y, masks, seed=seed, labels_onehot=labels_onehot)
        seen.append(([m.numpy() for m in masks], res, model))
        return res

    run_experiment(GraphData("g", *graph), cfg, runner=hook, device="cpu")
    (_, jmasks, jres, jparams), (masks, res, model) = jseen[0], seen[0]
    for a, b in zip(jmasks, masks):
        np.testing.assert_array_equal(a, b)
    assert res.epochs_run == int(jres.epochs_run)
    assert float(res.test_metric) == pytest.approx(float(jres.test_metric),
                                                   abs=1e-6)
    assert float(res.val_metric) == pytest.approx(float(jres.val_metric),
                                                  rel=1e-5, abs=1e-5)
    params = dict(model.named_parameters())
    for name, want in _flat(jax.tree_util.tree_map(np.asarray,
                                                   jparams)).items():
        np.testing.assert_allclose(params[name].detach().numpy(), want,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_remat_updates_batchnorm_statistics_once(small_graph):
    """Under ``remat`` the backward recomputes the train forward; the
    recompute leaves BatchNorm's running statistics alone (JAX's
    ``jax.checkpoint`` has no side effect to repeat), so a joint run of
    acmgcnpp with ``init_layers_X = 2`` ends with the statistics and
    parameters of the run without remat."""
    adj, feats, labels = small_graph
    data = GraphData("g", adj, np.abs(feats), labels)
    n = adj.shape[0]
    masks = tuple(torch.from_numpy(np.arange(n) % 3 == k) for k in range(3))
    states = []
    for remat in (False, True):
        cfg = TrainConfig(model_type="acmgcnpp", init_layers_X=2, hidden=8,
                          dropout=0.5, lr=1e-3, weight_decay=0.0, epochs=5,
                          early_stopping=0, operator_format="ell",
                          joint=True, remat=remat)
        _, ops, x, y, y1h, nclass = trainer.prepare_data(data, cfg,
                                                         device="cpu")
        model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                    seed=4, nnodes=n)
        trainer.make_split_runner(model, cfg)(ops, x, y, masks, seed=6,
                                              labels_onehot=y1h)
        states.append(model.state_dict())
    plain, remat = states
    assert not torch.equal(plain["mlpX.bn_0.mean"], torch.zeros(NHID))
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=1e-6,
                                   atol=1e-7, msg=name)


@pytest.mark.parametrize("over,name", [
    (dict(model_type="acmgcnpp"), "model_type 'acmgcnpp'"),
    (dict(model_type="gcnII"), "model_type 'gcnII'"),
    (dict(variant=True), "variant 1"),
    (dict(model_type="acmgcnp", structure_info=True), "structure channel"),
    (dict(normalization="sym"), "normalization 'sym'"),
    (dict(operator_format="dense"), "dense operator format"),
    (dict(model_type="acmgcnpp", init_layers_X=2), "init_layers_X 2"),
    (dict(model_type="acmsgc", hops=2), "hops 2"),
])
def test_sharded_path_refuses_what_it_does_not_port(over, name, small_graph):
    """The sharded path (``prepare_sharded_data``, hence
    ``run_experiment_sharded``) refuses by name only the k-hop operator
    (``hops > 1``).  The rest runs: every model type, variant 1, the
    structure channel (the raw adjacency on ``adj_low``'s boundaries, its
    own transpose), symmetric normalization (valued halves in the gather
    dtype, one for both directions), the dense format, which maps to ELL,
    and acmgcnpp's BatchNorm (``init_layers_X > 1``: a whole sharded run
    at one rank equals the single card's ``run_experiment``)."""
    from acmgnn_tpu_torch.parallel.sharded import (
        ShardedEllOp,
        make_sharded_operators,
    )

    adj, feats, labels = small_graph
    cfg = TrainConfig(**dict(dict(model_type="acmgcn", epochs=2), **over))
    data = GraphData("g", adj, feats, labels)
    if "hops" in over:
        with pytest.raises(NotImplementedError, match=name):
            trainer.prepare_sharded_data(data, cfg, device="cpu")
        return
    if "init_layers_X" in over:
        run = dataclasses.replace(cfg, operator_format="ell", num_splits=1)
        got = trainer.run_experiment_sharded(data, run, device="cpu")
        want = trainer.run_experiment(data, run, device="cpu")
        assert got["per_split"] == want["per_split"]
        assert got["epochs_total"] == want["epochs_total"]
    prep = trainer.prepare_sharded_data(data, cfg, device="cpu")
    low = prep.ops.adj_low
    assert isinstance(low, ShardedEllOp)
    assert low.rows_per_part == adj.shape[0]
    if cfg.structure_info:
        unnorm = prep.ops.adj_unnorm
        assert unnorm.bwd is unnorm.fwd and unnorm.fwd.vals is None
        np.testing.assert_array_equal(unnorm.boundaries, low.boundaries)
    if cfg.normalization == "sym":
        assert low.bwd is low.fwd and low.fwd.vals is not None
    ops, _, _ = make_sharded_operators(adj, 1, 0, normalization="sym",
                                       spmm_dtype=torch.bfloat16)
    assert ops.adj_low.fwd.vals.dtype == torch.bfloat16
