"""A split start to finish on the device, as JAX's ``lax.while_loop`` runs
it: counter-based dropout keys, the loop's condition, and (lr, wd) as data.

- Philox4x32-10 (``ops/dropout.py``) against Random123's known-answer
  vectors, the masks a function of (seed, rank, epoch, site) alone, their
  keep share within 4 sigma of ``1 - rate``, and K8's plain version as
  flax's dropout arithmetic (``h / (1 - rate)`` or 0);
- the fault the keys repair: JAX's ``run_experiment_stepwise`` and its
  sequential ``run_experiment`` draw the same masks (``fold_in(run_key,
  epoch)``) and agree at dropout 0.5; so do the port's two paths now;
- no body draws from a torch generator (the guard every capture runs
  under), and K9's plain condition;
- (lr, wd) as data, one runner per dropout value: tests/test_torch_hparams.py.

Tolerances are stated where used.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import torch

from acmgnn_tpu.ops.graph import GraphData as JaxGraphData
from acmgnn_tpu.train import trainer as jtrainer
from acmgnn_tpu.train.config import TrainConfig as JaxTrainConfig
from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.dropout import (
    Dropout,
    DropoutKey,
    dropout_plain,
    keep_mask,
    philox4x32,
)
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.ops.loop import loop_condition
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig

N = 300
# the headline model at test size: hidden 8, dropout 0.5, sequential loop
BASE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.5, lr=0.01, weight_decay=1e-3,
    epochs=8, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=False, hoist_first=True, num_splits=2, seed=3)


@pytest.fixture(scope="module")
def graph():
    adj, feats, labels = twitch_gamers_scale_graph(0, n=N, pairs=3000)
    return adj, np.abs(feats), labels


def _key(seed=5, rank=0, epoch=17):
    return DropoutKey.new(seed, rank, torch.tensor(epoch))


# ---------------------------------------------------------------------------
# Philox and the masks
# ---------------------------------------------------------------------------

# Random123's known-answer vectors for philox4x32-10 (kat_vectors)
KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    """The plain version's rounds (int64 arithmetic, 16-bit halves of the
    multipliers), broadcast over a batch of counters, and the keys as
    ints or as tensors."""
    c = [torch.tensor([v, v]) for v in ctr]
    for k in (key, tuple(torch.tensor(v) for v in key)):
        got = philox4x32(*c, *k)
        assert [int(w[0]) for w in got] == list(want)
        assert all(int(w[1]) == int(w[0]) for w in got)


def test_masks_are_a_function_of_seed_rank_epoch_site():
    """The same (seed, rank, epoch, site) gives the same mask, however the
    key was made; a change of any one gives another; element ``i`` of a
    larger tensor takes the same bit as in a smaller one (the counter is
    the element's index)."""
    shape = (257, 9)
    mask = keep_mask(shape, _key(), 2, 0.5)
    assert torch.equal(mask, keep_mask(shape, _key(), 2, 0.5))
    for other in (dict(seed=6), dict(rank=1), dict(epoch=18)):
        assert not torch.equal(mask, keep_mask(shape, _key(**other), 2, 0.5))
    assert not torch.equal(mask, keep_mask(shape, _key(), 3, 0.5))
    bigger = keep_mask((300, 9), _key(), 2, 0.5)
    assert torch.equal(bigger.reshape(-1)[:mask.numel()], mask.reshape(-1))


@pytest.mark.parametrize("start", (0, 4, 7, 1001))
def test_a_slab_is_the_same_elements_of_the_whole(start):
    """``dropout_plain(slab, start=s)`` is the whole tensor's result at its
    elements ``s ..``, whether ``s`` is a multiple of 4 or not (the slab
    check of K8 at wiki's element count reads its slabs so)."""
    whole = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1200, 3)).astype(np.float32))
    flat = dropout_plain(whole, 0.5, _key(), 4).reshape(-1)
    slab = whole.reshape(-1)[start:start + 301]
    assert torch.equal(dropout_plain(slab, 0.5, _key(), 4, start=start),
                       flat[start:start + 301])


@pytest.mark.parametrize("rate", (0.1, 0.5, 0.9))
def test_keep_share_within_four_sigma(rate):
    n = 200_000
    share = float(keep_mask((n,), _key(epoch=3), 0, rate).float().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(share - (1 - rate)) < 4 * sigma


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_dropout_plain_is_flax_arithmetic(dtype):
    """Kept elements are ``h / f32(1 - rate)`` in f32, rounded once to the
    input's dtype; dropped ones 0."""
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 33)).astype(np.float32)).to(dtype)
    out = dropout_plain(h, 0.3, _key(), 1)
    keep = keep_mask(h.shape, _key(), 1, 0.3)
    want = (h.float().numpy() / np.float32(0.7)).astype(np.float32)
    want = torch.from_numpy(want).to(dtype)
    assert out.dtype == dtype
    assert torch.equal(out[keep], want[keep])
    assert bool((out[~keep] == 0).all())


def test_dropout_sites_number_calls_in_order():
    """A forward's calls take sites 0, 1, ...; a call at rate 0 or outside
    training is the identity and takes none; train mode at a rate above 0
    needs a key."""
    h = torch.ones(40, 8)
    drop = Dropout(0.5, True, _key())
    a, b = drop(h), drop(h, 0.0)
    c = drop(h)
    assert torch.equal(a, dropout_plain(h, 0.5, _key(), 0))
    assert b is h
    assert torch.equal(c, dropout_plain(h, 0.5, _key(), 1))
    assert Dropout(0.5, False, None)(h) is h
    with pytest.raises(ValueError, match="DropoutKey"):
        Dropout(0.5, True, None)(h)
    with pytest.raises(ValueError, match="seed"):
        _key(seed=2**32)


# ---------------------------------------------------------------------------
# The fault: the stepwise and the sequential paths draw the same masks
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.rows, self.splits = [], []

    def info(self, msg, *args):
        if "epoch" in msg:
            self.rows.append(args)

    def log_split(self, idx, res):
        self.splits.append(res)

    def log_result(self, out):
        pass


def test_jax_stepwise_and_sequential_runs_agree_with_dropout(graph):
    """The reference's property: at dropout 0.5 JAX's stepwise run and its
    fused sequential run of one seed draw the same masks, so each split's
    test metric (at the best val epoch) agrees to 1e-6."""
    jcfg = JaxTrainConfig(**BASE)
    data = JaxGraphData("g", *graph)
    stepwise = jtrainer.run_experiment_stepwise(data, jcfg)
    fused = jtrainer.run_experiment(data, jcfg)
    assert stepwise["per_split"] == pytest.approx(fused["per_split"],
                                                  abs=1e-6)


def test_port_stepwise_and_sequential_runs_agree_with_dropout(graph,
                                                              monkeypatch):
    """The port's two paths, as JAX's (the runner keyed by its body
    counter, the stepwise path by the epoch): each split's test metric to
    1e-6, as JAX's, and each epoch's train loss bit for bit (the same
    arithmetic on the CPU).  With the stateful generators of the port's
    earlier form the two trained on different masks."""
    cfg = TrainConfig(**BASE)
    log = _Log()
    stepwise = trainer.run_experiment_stepwise(
        GraphData("g", *graph), cfg, logger=log, display_step=1,
        device="cpu")
    run = trainer.make_split_runner
    states = []

    def recorded(model, cfg, **kw):
        runner = run(model, cfg, **kw)

        def call(*args, **kwargs):
            res, st = runner(*args, return_state=True, **kwargs)
            states.append(st)
            return res
        return call

    monkeypatch.setattr(trainer, "make_split_runner", recorded)
    fused = trainer.run_experiment(GraphData("g", *graph), cfg,
                                   device="cpu")
    assert stepwise["per_split"] == pytest.approx(fused["per_split"],
                                                  abs=1e-6)
    losses = np.asarray([r[2] for r in log.rows], np.float32)
    np.testing.assert_array_equal(
        losses, np.concatenate([st.train_losses.numpy() for st in states]))


# ---------------------------------------------------------------------------
# No generator in a captured body; K9's plain condition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draw", (
    lambda: torch.rand(3),
    lambda: torch.bernoulli(torch.full((3,), 0.5)),
    lambda: torch.nn.functional.dropout(torch.ones(3), 0.5, True),
    lambda: torch.empty(3).uniform_(generator=torch.Generator()),
))
def test_a_torch_generator_draw_in_a_captured_body_raises(draw):
    with pytest.raises(RuntimeError, match="torch generator"):
        with trainer.no_random_draws():
            draw()


@pytest.mark.parametrize("joint", (True, False))
def test_the_loop_body_draws_from_no_generator(graph, joint):
    """The runner's body at dropout 0.5, with remat, run under the guard
    every capture uses: it draws nothing from a torch generator."""
    cfg = TrainConfig(**dict(BASE, joint=joint, remat=True, epochs=2))
    data, ops, x, y, y1h, nclass = trainer.prepare_data(
        GraphData("g", *graph), cfg, device="cpu")
    masks = tuple(torch.from_numpy(m) for m in trainer.resolve_split(
        data, cfg, 0, np.random.default_rng(0), data.labels, nclass))
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu")
    run = trainer.make_split_runner(model, cfg)
    run(ops, x, y, masks, labels_onehot=y1h)
    kept = run.kept()
    kept.state.reset()
    with trainer.no_random_draws():
        kept.body()
    assert int(kept.state.k) == 1


def test_loop_condition_plain():
    k, limit = torch.tensor([0, 3, 5, 5]), torch.tensor([5, 5, 5, 9])
    stop = torch.tensor([False, True, False, False])
    assert loop_condition(k, limit).tolist() == [True, True, False, True]
    assert loop_condition(k, limit, stop).tolist() == [True, False, False,
                                                       True]


def test_counted_graph_counts_a_device_loops_bodies():
    """``CountedGraph.ran(n)``: n bodies' launches, none at the capture."""
    before = kernels.launches.copy()

    class Graph:
        def replay(self):
            pass

    g = kernels.CountedGraph(Graph(), lambda: kernels.count("k_test"))
    assert kernels.launches == before
    g.ran(7)
    g.replay()
    assert kernels.launches["k_test"] == before["k_test"] + 8
    kernels.launches.clear()
    kernels.launches.update(before)
