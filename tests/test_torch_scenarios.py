"""The JAX package's single-card scenarios on the port, against acmgnn_tpu
on the CPU: bench.py's graphs and the training configurations of its
penn94, arxiv_year, single-card wiki and powerlaw/banded twitch scenarios.

- Generators: ``twitch_gamers_scale_graph(graph="powerlaw" | "banded")``
  equal ``bench._powerlaw_scale_graph(0)`` / ``_banded_scale_graph(0)``
  bit for bit at full size (CSR arrays, features, labels);
  ``wiki_scale_graph``'s graph equals ``bench._chung_lu_edges`` with the
  JAX package's symmetrized build at a shrunk N and E.
- Each configuration at test size through both packages'
  ``make_split_runner`` at dropout 0 from JAX's initial variables
  (``params_from_flax``): f32 parameters within 1e-4, best metrics and
  losses within 1e-5 (tests/test_torch_trainer.py's); where a bf16 GEMM or
  bf16 feature storage is on, 1e-2 and 1e-4 (a one-ulp f32 difference can
  flip a bf16 rounding: tests/test_torch_experiment.py's bf16 bounds).
  Features are non-negative, for the conditioning reason given in
  tests/test_torch_trainer.py.
- The launches each scenario's runner makes, counted on the CPU through
  the plain versions' wrappers by width, equal what ``chip_smoke.py``'s
  count rules say the card launches (``joint_counts``,
  ``sequential_counts``).
"""

from __future__ import annotations

import numpy as np
import pytest

import bench
import chip_smoke
import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.ops.native import build_sym_adjacency as jax_build_sym
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu_torch.data.synthetic_scale import (
    linkx_scale_graph,
    twitch_gamers_scale_graph,
    wiki_scale_graph,
)
from acmgnn_tpu_torch.models import layers
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops import ell
from acmgnn_tpu_torch.ops import spmm as spmm_mod
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig

# bench.py's configurations at test size: hidden 16, dropout 0, 15 epochs
COMMON = dict(hidden=16, dropout=0.0, lr=0.01, weight_decay=1e-3,
              epochs=15, early_stopping=0, selection="val_metric",
              operator_format="ell", num_splits=1, seed=3)
# bench.py:551-553, :633-657: acmgcn, joint, hoist, bf16 gathers and GEMMs
PENN94 = dict(COMMON, model_type="acmgcn", joint=True, hoist_first=True,
              spmm_dtype="bfloat16", gemm_dtype="bfloat16")
# bench.py:554-556: acmgcn, joint, hoist at F = 128 (the aggregate in f32)
ARXIV = dict(COMMON, model_type="acmgcn", joint=True, hoist_first=True,
             spmm_dtype="bfloat16", gemm_dtype="float32")
# bench.py:796-824: acmgcnp, sequential, no hoist, remat, bf16 features
WIKI = dict(COMMON, model_type="acmgcnp", joint=False, hoist_first=False,
            remat=True, feature_dtype="bfloat16", spmm_dtype="bfloat16",
            gemm_dtype="float32")
# bench.py:434-451: the headline on the powerlaw graph, f32 gathers, with
# JAX's dense hub blocks for rows above 48 entries (the port has no such
# threshold: K1 gives rows above K1_HUB_DEGREE a block, on the card), at
# lr 1e-3 without decay.  At the headline's lr 0.01 the two packages part
# by 2.5e-4 after the second step on this graph, where each package's own
# summation orders (JAX with and without hub blocks, the port's ELL and
# COO) agree to 2e-7: a rounding-level difference of the two packages'
# arithmetic that Adam's early steps amplify on a gradient within
# rounding of zero; at lr 1e-3 without decay they agree to 4e-7.
POWERLAW = dict(COMMON, model_type="acmgcnp", joint=True, hoist_first=True,
                spmm_dtype="float32", gemm_dtype="float32",
                ell_hub_threshold=48, ell_block=1, lr=1e-3,
                weight_decay=0.0)
SMALL = dict(n=300, e=3000, max_deg=60)
SMALL_POWERLAW = dict(n=600, pairs=10_000)


def _graphs():
    """Each scenario's graph at test size, non-negative features."""
    def small_linkx(name):
        adj, f, y = linkx_scale_graph(name, **SMALL)
        return adj, np.abs(f), y

    adj, f, y = wiki_scale_graph(n=SMALL["n"], e=SMALL["e"],
                                 max_deg=SMALL["max_deg"], device="cpu")
    wiki = (adj, np.abs(f), y)
    adj, f, y = twitch_gamers_scale_graph(0, graph="powerlaw",
                                          **SMALL_POWERLAW)
    return {"penn94": small_linkx("penn94"),
            "arxiv_year": small_linkx("arxiv_year"), "wiki": wiki,
            "powerlaw": (adj, np.abs(f), y)}


SCENARIOS = {"penn94": PENN94, "arxiv_year": ARXIV, "wiki": WIKI,
             "powerlaw": POWERLAW}
# (parameter, scalar) tolerances: bf16 GEMMs or features, else f32
TOL = {"penn94": (1e-2, 1e-4), "arxiv_year": (1e-4, 1e-5),
       "wiki": (1e-2, 1e-4), "powerlaw": (1e-4, 1e-5)}


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


def _same_graph(got, want):
    (a, x, y), (b, u, v) = got, want
    for name in ("indptr", "indices", "data"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert ga.dtype == gb.dtype and np.array_equal(ga, gb), name
    assert a.shape == b.shape
    assert x.dtype == u.dtype and np.array_equal(x, u)
    assert y.dtype == v.dtype and np.array_equal(y, v)


@pytest.mark.parametrize("graph", ("powerlaw", "banded"))
def test_twitch_graphs_equal_bench_at_full_size(graph):
    want = {"powerlaw": bench._powerlaw_scale_graph,
            "banded": bench._banded_scale_graph}[graph](0)
    _same_graph(twitch_gamers_scale_graph(0, graph=graph), want)


def test_twitch_graph_names_are_checked():
    with pytest.raises(ValueError, match="graph must be one of"):
        twitch_gamers_scale_graph(0, n=10, pairs=20, graph="ring")


def test_wiki_graph_equals_bench_construction():
    """bench.py's wiki graph (``_wiki_scale_graph``: ``_chung_lu_edges``
    with a top degree of 30,000, then the self-loop-free symmetrized build)
    at N=20,000 and E=80,000; features and labels as documented (a
    ``torch.randn`` draw seeded 0, ``default_rng(1)`` classes)."""
    n, e = 20_000, 80_000
    adj, feats, labels = wiki_scale_graph(n=n, e=e, f=6, device="cpu")
    src, dst = bench._chung_lu_edges(n, e, 30_000, seed=0)
    want = jax_build_sym(src, dst, n, drop_self_loops=True)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(adj, name), getattr(want,
                                                                  name))
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        feats, torch.randn(n, 6, generator=gen).numpy())
    np.testing.assert_array_equal(
        labels, np.random.default_rng(1).integers(0, 5, size=n))
    assert labels.dtype == np.int32 and feats.dtype == np.float32


# ---------------------------------------------------------------------------
# The scenario configurations against JAX
# ---------------------------------------------------------------------------


def _masks(n):
    perm = np.random.default_rng(0).permutation(n)
    m = np.zeros((3, n), bool)
    m[0, perm[: n // 2]] = True
    m[1, perm[n // 2: 3 * n // 4]] = True
    m[2, perm[3 * n // 4:]] = True
    return m


def _jax_split(graph, cfg_kw):
    """JAX's runner on bench.py's 50/25/25 split: (initial variables,
    result, final parameters flattened to the port's names)."""
    jcfg = JaxTrainConfig(**cfg_kw)
    _, ops, x, y, y1h, nclass = jtrainer.prepare_data(
        JaxGraphData("g", *graph), jcfg)
    model = jtrainer.build_model(jcfg, nclass, graph[0].shape[0])
    variables = model.init(jax.random.key(0), x, ops)
    res, state = jax.jit(jtrainer.make_split_runner(model, jcfg),
                         static_argnames=("return_state",))(
        variables, jax.random.key(1), ops, x, y, y1h,
        tuple(jnp.asarray(m) for m in _masks(graph[0].shape[0])),
        return_state=True)
    return variables, res, params_from_flax(jax.device_get(
        state.variables["params"]))


def _port_split(graph, cfg_kw, variables=None):
    """The port's runner on the same split from ``variables``: (result,
    final parameters)."""
    cfg = TrainConfig(**cfg_kw)
    _, ops, x, y, y1h, nclass = trainer.prepare_data(GraphData("g", *graph),
                                                     cfg, device="cpu")
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu")
    if variables is not None:
        model.load_state_dict(params_from_flax(jax.device_get(
            variables["params"])))
    res = trainer.make_split_runner(model, cfg)(
        ops, x, y, tuple(torch.from_numpy(m)
                         for m in _masks(graph[0].shape[0])),
        labels_onehot=y1h)
    return res, {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", tuple(SCENARIOS))
def test_scenario_split_matches_jax(graphs, name):
    """One split of the scenario's configuration: equal ``epochs_run``,
    the best metrics and losses and the final parameters within the
    scenario's ``TOL``."""
    graph, cfg_kw = graphs[name], SCENARIOS[name]
    if name == "powerlaw":
        deg = np.diff(graph[0].indptr)
        # JAX builds its hub blocks, and the port its K1 hub class
        assert deg.max() > max(cfg_kw["ell_hub_threshold"],
                               ell.K1_HUB_DEGREE)
    variables, jres, jparams = _jax_split(graph, cfg_kw)
    res, params = _port_split(graph, cfg_kw, variables)
    tol_params, tol_scalars = TOL[name]
    assert res.epochs_run == int(jres.epochs_run) == cfg_kw["epochs"]
    for field in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert float(getattr(res, field)) == pytest.approx(
            float(getattr(jres, field)), rel=tol_scalars,
            abs=tol_scalars), field
    assert set(params) == set(jparams)
    for key, ref in jparams.items():
        np.testing.assert_allclose(params[key].numpy(), ref.numpy(),
                                   rtol=tol_params, atol=tol_params,
                                   err_msg=key)


def test_wiki_bf16_features_reach_the_projection_as_jax_promotes(graphs):
    """bf16-stored features at F = 600 > ``HOIST_MAX_COLS``, no hoist:
    ``prepare_data`` stores JAX's bf16 copy, and layer 1's f32 projection
    reads it promoted to f32, under remat's recompute too."""
    graph = graphs["wiki"]
    cfg = TrainConfig(**WIKI)
    _, _, x, *_ = trainer.prepare_data(GraphData("g", *graph), cfg,
                                       device="cpu")
    _, _, jx, *_ = jtrainer.prepare_data(JaxGraphData("g", *graph),
                                         JaxTrainConfig(**WIKI))
    assert x.dtype == torch.bfloat16 and x.shape[1] > layers.HOIST_MAX_COLS
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    assert cfg.resolve_hoist() is False
    w = torch.randn(x.shape[1], 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(layers.f32_matmul(x, w), x.float() @ w)


# ---------------------------------------------------------------------------
# Launch counts: what chip_smoke.py's rules say the card launches
# ---------------------------------------------------------------------------


def _counted_split(graph, cfg_kw, monkeypatch):
    """The port's split with K1's and K2/K3's wrappers counted by the
    name the card's counter gives them (``k1_spmm_w<d>``,
    ``k2_attn_fwd_d<d>``, ``k3_attn_bwd_d<d>``: T = 3, every channel
    ReLU'd, the instance of these models)."""
    calls: dict = {}

    def counted(fmt, fn, width):
        def wrapper(*args, **kwargs):
            key = fmt.format(width(*args, **kwargs))
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    gather = counted("k1_spmm_w{}", ell.row_gather_spmm,
                     lambda half, x, *a, **k: x.shape[1])
    monkeypatch.setattr(ell, "row_gather_spmm", gather)
    monkeypatch.setattr(spmm_mod, "row_gather_spmm", gather)
    monkeypatch.setattr(layers, "attention_mix_forward", counted(
        "k2_attn_fwd_d{}", layers.attention_mix_forward,
        lambda zs, *a, **k: zs[0].shape[1]))
    monkeypatch.setattr(layers, "attention_mix_backward", counted(
        "k3_attn_bwd_d{}", layers.attention_mix_backward,
        lambda zs, *a, **k: zs[0].shape[1]))
    res, _ = _port_split(graph, dict(cfg_kw, dropout=0.5, hidden=64),
                         None)
    return calls, int(res.epochs_run)


@pytest.mark.parametrize("name", ("penn94", "arxiv_year", "wiki"))
def test_scenario_launches_follow_chip_smoke_rules(graphs, name,
                                                   monkeypatch):
    """K1 by width and K2/K3 by width on the CPU, at bench.py's hidden 64
    and dropout 0.5: the counts ``chip_smoke.py`` 13's paths hold the card
    to.  The wiki row pins remat's recompute on the sequential loop: every
    K1 and K2 launch of the train forward runs again, layer 2's K2
    included (the joint loop's last launch, the detached eval branch's
    K2, is not: tests/test_torch_experiment.py)."""
    graph, cfg_kw = graphs[name], SCENARIOS[name]
    calls, epochs = _counted_split(graph, cfg_kw, monkeypatch)
    nclass = int(graph[2].max()) + 1
    feats = graph[1].shape[1]
    if cfg_kw["joint"]:
        want = chip_smoke.joint_counts(epochs + 1, "k1_spmm", feats,
                                       nclass=nclass)
    else:
        want = chip_smoke.sequential_counts(epochs, "k1_spmm", None,
                                            k4=False, nclass=nclass,
                                            remat=True)
    assert calls == want
