"""The port's spans and counters (``utils/profiling.py``) where the work
happens: ``prepare_data``, ``run_experiment``'s splits, the split runner's
call and its phases (``make_split_runner``, ``Replay.run``).

Off (the default) a runner call records nothing, creates no CUDA event,
adds no synchronize, and a ``torch.profiler`` trace holds no program
range.  On, the spans nest as the program runs (``runner.call`` over its
start or rewrite, the eager first body with its four phases, the loop and
the results), the ``loop_bodies`` counter counts the bodies after the
eager first, the profiler shows the spans as ranges nested and ordered as
the records say, and every number the program computes is the same bit
for bit.  The CPU runs every body eagerly; the card's capture, device
loop and ``body_nodes`` counter are held by the ``gpu`` test at the end.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.utils import profiling

BASE = dict(
    model_type="acmgcnp", hidden=8, dropout=0.5, lr=0.01, weight_decay=1e-3,
    epochs=6, early_stopping=0, selection="val_metric",
    operator_format="ell", spmm_dtype="float32", gemm_dtype="float32",
    joint=True, hoist_first=True, num_splits=2, seed=3)
LOOPS = {"joint": BASE, "sequential": dict(BASE, joint=False)}
BODY = ["body.forward", "body.backward", "body.step", "body.eval"]
PROGRAM = ("split", "runner.", "body.", "prepare")


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and no records."""
    profiling.disable_spans()
    profiling.reset_spans()
    yield
    profiling.disable_spans()
    profiling.reset_spans()


@pytest.fixture(scope="module")
def graph():
    adj, feats, labels = twitch_gamers_scale_graph(0, n=300, pairs=3000)
    return GraphData(name="spans", adj=adj, features=np.abs(feats),
                     labels=labels)


def _masks(n, seed=1):
    perm = np.random.default_rng(seed).permutation(n)
    m = np.zeros((3, n), bool)
    m[0, perm[: n // 2]] = True
    m[1, perm[n // 2: 3 * n // 4]] = True
    m[2, perm[3 * n // 4:]] = True
    return tuple(torch.from_numpy(r) for r in m)


def _runner(graph, cfg_kw, device="cpu"):
    cfg = TrainConfig(**cfg_kw)
    _, ops, x, y, y1h, nclass = trainer.prepare_data(graph, cfg,
                                                     device=device)
    model = trainer.build_model(cfg, x.shape[1], nclass, device=device,
                                seed=0, nnodes=x.shape[0])
    init = copy.deepcopy(model.state_dict())
    runner = trainer.make_split_runner(model, cfg)
    masks = tuple(m.to(device) for m in _masks(x.shape[0]))

    def call(**kw):
        kw.setdefault("init_params", init)
        return runner(ops, x, y, masks, seed=7, labels_onehot=y1h, **kw)

    return call, runner


def _children(recs, i):
    return [r["name"] for r in recs if r["parent"] == i]


def _index(recs, name, nth=0):
    return [i for i, r in enumerate(recs) if r["name"] == name][nth]


def test_spans_off_record_nothing_and_no_program_range(graph):
    call, _ = _runner(graph, BASE)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call(return_state=True)
    assert profiling.spans() == [] and not profiling.counts
    names = {e.name for e in prof.events()}
    assert not [n for n in names if n.startswith(PROGRAM)], names


@pytest.mark.parametrize("loop", tuple(LOOPS))
def test_runner_call_spans_nest(graph, loop):
    """First call: ``runner.start``, the eager first body with its four
    phases, the loop over the rest, the results; ``loop_bodies`` is the
    bodies less the eager first.  A second call (a new split) rewrites
    the kept tensors and runs every body in the loop."""
    call, _ = _runner(graph, LOOPS[loop])
    profiling.enable_spans()
    _, first = call(return_state=True)
    recs = profiling.spans()
    root = _index(recs, "runner.call")
    assert recs[root]["parent"] is None
    assert _children(recs, root) == ["runner.start", "runner.first_body",
                                     "runner.loop", "runner.results"]
    assert _children(recs, _index(recs, "runner.first_body")) == BODY
    bodies = first.epoch
    assert profiling.counts["loop_bodies"] == bodies - 1
    # on the CPU every later body runs eagerly, inside the loop's span
    loop_i = _index(recs, "runner.loop")
    assert _children(recs, loop_i) == BODY * (bodies - 1)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    if not torch.cuda.is_initialized():   # no card in use: no events
        assert "device_start_ms" not in recs[loop_i]

    call(return_state=True)
    recs = profiling.spans()
    second = _index(recs, "runner.call", 1)
    assert _children(recs, second) == ["runner.rewrite", "runner.loop",
                                       "runner.results"]
    assert profiling.counts["loop_bodies"] == 2 * bodies - 1
    table = profiling.table()
    assert table.splitlines()[0].split() == ["span", "calls", "host", "ms",
                                             "device", "ms"]
    assert any(line.split()[:2] == ["runner.call", "2"]
               for line in table.splitlines())


def test_spans_sit_on_the_profilers_clock(graph):
    """Under a profile each span is a ``record_function`` range: the
    program's ranges nest and open in the order the records say."""
    call, _ = _runner(graph, BASE)
    profiling.enable_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    recs = profiling.spans()
    events = sorted((e for e in prof.events()
                     if e.name.startswith(PROGRAM)),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in events] == [r["name"] for r in recs]
    for e, r in zip(events, recs):
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith(PROGRAM):
            parent = parent.cpu_parent
        want = None if r["parent"] is None else recs[r["parent"]]["name"]
        assert (None if parent is None else parent.name) == want, e.name
        if parent is not None:
            assert parent.time_range.start <= e.time_range.start
            assert e.time_range.end <= parent.time_range.end


def _tensors_equal(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _tensors_equal(a[k], b[k], f"{what}/{k}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _tensors_equal(getattr(a, f.name), getattr(b, f.name),
                           f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _tensors_equal(x, y, f"{what}/{i}")
    else:
        assert a == b, what


@pytest.mark.parametrize("loop", tuple(LOOPS))
def test_spans_change_no_number(graph, loop):
    """Two splits' results and ``SplitState`` (segments included), spans
    off against on, bit for bit."""
    def two_splits():
        call, runner = _runner(graph, LOOPS[loop])
        out = [call(return_state=True)]
        _, st = call(return_state=True, epoch_limit=2)
        out.append(call(return_state=True, init_params=None,
                        init_state=st.runner))
        return out, {k: v.clone() for k, v in
                     runner.model.state_dict().items()}

    off = two_splits()
    profiling.enable_spans()
    on = two_splits()
    assert profiling.spans()
    _tensors_equal(off, on)


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def test_spans_off_make_no_cuda_event_and_no_synchronize(graph, monkeypatch):
    """With the card's clock in use (faked here), spans on record two
    events a ``runner.loop`` and synchronize at the end of the eager first
    body and of ``prepare_data``; off, a split makes neither."""
    syncs = []
    monkeypatch.setattr(profiling, "_on_card", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    _Event.made = 0
    call, _ = _runner(graph, BASE)
    call(return_state=True)
    call(return_state=True)
    assert (_Event.made, syncs) == (0, [])

    profiling.enable_spans()
    call, _ = _runner(graph, BASE)   # prepare_data synchronizes once
    call(return_state=True)
    call(return_state=True)
    assert _Event.made == 2 * 2
    assert len(syncs) == 2
    recs = profiling.spans()
    assert [r["device_end_ms"] for r in recs
            if r["name"] == "runner.loop"] == [0.0, 0.0]


def test_prepare_data_and_split_spans(graph):
    """``prepare_data`` over its four steps; ``run_experiment`` a
    ``split`` span a split over ``split.prepare`` and the runner's call."""
    profiling.enable_spans()
    trainer.run_experiment(graph, TrainConfig(**BASE), device="cpu")
    recs = profiling.spans()
    prep = _index(recs, "prepare_data")
    assert recs[prep]["parent"] is None
    assert _children(recs, prep) == ["prepare.load", "prepare.operators",
                                     "prepare.features", "prepare.hoist"]
    splits = [i for i, r in enumerate(recs) if r["name"] == "split"]
    assert len(splits) == BASE["num_splits"]
    for i in splits:
        assert recs[i]["parent"] is None
        assert _children(recs, i) == ["split.prepare", "runner.call"]


def test_profile_trace_turns_spans_on_for_its_body(graph, tmp_path):
    with profiling.profile_trace(str(tmp_path)):
        assert profiling.spans_enabled()
        call, _ = _runner(graph, BASE)
        call()
    assert not profiling.spans_enabled()
    names = [r["name"] for r in profiling.spans()]
    assert names[0] == "prepare_data" and "runner.call" in names
    assert (tmp_path / profiling.TRACE_FILE).is_file()


@pytest.mark.gpu
def test_card_spans_loop_and_body_nodes(graph):
    """On the card: the eager first body, one capture (the body's phases
    under it, host time), the device loop on the card's clock, and
    ``body_nodes`` equal to the captured body's kernel, memcpy and memset
    nodes; results equal bit for bit with spans off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from acmgnn_tpu_torch.ops.loop import node_types

    off_call, _ = _runner(graph, BASE, "cuda")
    off = [off_call(return_state=True), off_call(return_state=True)]
    profiling.enable_spans()
    call, runner = _runner(graph, BASE, "cuda")
    on = [call(return_state=True), call(return_state=True)]
    _tensors_equal([r for r, _ in off], [r for r, _ in on])
    for (_, a), (_, b) in zip(off, on):
        _tensors_equal((a.train_losses, a.val_hist, a.opt_state),
                       (b.train_losses, b.val_hist, b.opt_state))
    recs = profiling.spans()
    call0 = _index(recs, "runner.call")
    assert _children(recs, call0) == ["runner.start", "runner.first_body",
                                      "runner.capture", "runner.loop",
                                      "runner.results"]
    cap = _index(recs, "runner.capture")
    assert [n for n in _children(recs, cap)
            if n != "runner.cache_release"] == BODY + ["runner.loop_build"]
    loops = [r for r in recs if r["name"] == "runner.loop"]
    assert len(loops) == 2
    for r in loops:
        assert 0 <= r["device_start_ms"] < r["device_end_ms"]
    assert loops[0]["device_end_ms"] <= loops[1]["device_start_ms"]
    bodies = on[0][1].epoch
    assert profiling.counts["loop_bodies"] == (bodies - 1) + bodies
    nodes = node_types(runner.kept().loop.graph.graph)
    assert profiling.counts["body_nodes"] == sum(
        t in ("kernel", "memcpy", "memset") for t in nodes) > 0
