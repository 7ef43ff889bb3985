"""One run of one cell: set-up, the measured window (or, traced, a profile
of replays), then the comparison that decides ``correct``.

Set-up (``setup_s``, from the process's start to the first timed split):
the kernels built where stale (``kernels.build``, into the checkout's
``acmgnn_tpu_torch/build/``), the inputs made from the seed
(``inputs.py``), ``prepare_data``, ``build_model``, ``make_split_runner``,
and set-up's warm-up split: split 0 run through the runner in three
segments of one step each with ``return_state``, which makes the one
capture of the run and the trajectory the reference follows
(``check.py``).

The window (``--trace 0``): split after split, each as ``run_experiment``
runs one (``trainer.py``): its masks, its initial parameters loaded into
the model, one call of the kept runner with ``return_state``, a
synchronize and a read of its losses; it holds the whole splits that
begin before ``--seconds`` is up.  ``epoch_ms`` is its wall time over the
epochs trained in it.

Traced (``--trace 1``): instead of the window, one split is begun and
its captured body is replayed ``trace_epochs`` times one replay at a
time under ``torch.profiler`` (in the device loop the profiler misfiles
kernels); the per-layer metrics read that record.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import torch

from benchmark import check, inputs, manifest, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "acmgnn_tpu", "bench", "chip_smoke")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark's runs may
    not load (compared whole: ``acmgnn_tpu_torch`` is not
    ``acmgnn_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it (None without
    it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def train_config(cell: manifest.Cell):
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**cell.config["model"],
                       epochs=int(cell.traffic["epochs"]),
                       early_stopping=int(cell.traffic["early_stopping"]))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """The state of one run on ``device``."""

    def __init__(self, cell: manifest.Cell, seed: int, device, t0: float):
        self.cell, self.seed, self.t0 = cell, int(seed), t0
        self.dev = torch.device(device)
        self.cfg = train_config(cell)

    # -- set-up ------------------------------------------------------------

    def setup(self, adj=None) -> None:
        """``adj``: the cell's graph, where the caller has drawn it."""
        from acmgnn_tpu_torch.ops import kernels
        from acmgnn_tpu_torch.ops.graph import GraphData
        from acmgnn_tpu_torch.train.trainer import (
            build_model,
            make_split_runner,
            prepare_data,
        )

        cell, dev = self.cell, self.dev
        self.phases = {"imports": time.perf_counter() - self.t0}
        mark = time.perf_counter()

        def phase(name):
            nonlocal mark
            now = time.perf_counter()
            self.phases[name] = now - mark
            mark = now

        self.build_s = None
        if dev.type == "cuda":
            # only a run that finds a source newer than its library builds
            self.build_s = kernels.build()
            torch.empty(1, device=dev)      # the CUDA context
        phase("build and context")
        if adj is None:
            adj = inputs.graph(cell.config, cell.traffic, dev)
        phase("graph")
        self.inp = inputs.Inputs(cell.config, cell.traffic, self.seed, dev,
                                 adj, cell.reference)
        data = GraphData(
            name=cell.name, adj=adj,
            features=self.inp.features().cpu().numpy(),
            labels=self.inp.labels().to(torch.int32).cpu().numpy())
        _sync(dev)
        phase("inputs")
        if dev.type == "cuda":
            # the peak is the program's: from its first call on
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        _, ops, x, y, y1h, nclass = prepare_data(data, self.cfg, device=dev)
        _sync(dev)
        self.prepare_s = time.perf_counter() - t
        phase("prepare_data")
        del data
        self.ops, self.x, self.y, self.y1h = ops, x, y, y1h
        n, f = x.shape
        if nclass != self.inp.c:
            raise RuntimeError(f"the labels hold {nclass} classes, the "
                               f"configuration {self.inp.c}")
        self.model = build_model(self.cfg, f, nclass, device=dev, nnodes=n)
        self.names = [k for k, _ in self.model.named_parameters()]
        if sorted(self.names) != sorted(self.inp.shapes):
            raise RuntimeError(
                f"the program's parameters {sorted(self.names)} are not the "
                f"reference's {sorted(self.inp.shapes)}")
        self.runner = make_split_runner(self.model, self.cfg)
        phase("model and runner")
        # set-up's warm-up split: three segments of one step each, through
        # the window's own call; the second makes the run's one capture
        masks, init = self.inp.masks(0), self.inp.params(0)
        seed0 = self.inp.dropout_seed(0)
        states, resume = [], None
        for t in range(1, check.STEPS + 1):
            _, st = self.runner(ops, x, y, masks, seed=seed0,
                                return_state=True, labels_onehot=y1h,
                                init_params=init if resume is None else None,
                                init_state=resume, epoch_limit=t)
            states.append(st)
            resume = st.runner
            _sync(dev)
            phase(f"warm-up step {t}")
        self.capture_ms = next((st.capture_ms for st in states
                                if st.capture_ms is not None), None)
        self.trajectory = check.program_trajectory(init, states, self.names)
        self.nnz = dict(nnz_low=int(adj.nnz) + n, nnz_raw=int(adj.nnz))
        self.adj = adj
        del states, resume, masks
        log("set-up seconds: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in self.phases.items()))

    # -- the window --------------------------------------------------------

    def _split(self, idx: int):
        masks, init = self.inp.masks(idx), self.inp.params(idx)
        self.model.load_state_dict(init)
        res, state = self.runner(self.ops, self.x, self.y, masks,
                                 seed=self.inp.dropout_seed(idx),
                                 return_state=True, labels_onehot=self.y1h)
        _sync(self.dev)
        finite = bool(torch.isfinite(state.train_losses).all())
        return int(res.epochs_run), finite

    def window(self, seconds: float) -> dict:
        attempted = failed = epochs = 0
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            attempted += 1
            try:
                ran, finite = self._split(attempted)
            except RuntimeError as exc:
                log(f"split {attempted} raised: {exc!r}")
                failed += 1
                continue
            epochs += ran
            failed += int(not finite)
        wall = time.perf_counter() - t
        self.attempted, self.failed = attempted, failed
        log(f"window: {attempted} splits, {epochs} epochs in {wall:.3f} s")
        if not epochs:
            raise RuntimeError("the window trained no epoch")
        return {"epoch_ms": 1e3 * wall / epochs}

    def profile(self, bodies: int) -> dict:
        """``bodies`` replays of the captured body under the profiler,
        reduced to the traced run's record (``trace.py``)."""
        from torch.profiler import ProfilerActivity, profile

        self.attempted, self.failed = 1, 0
        masks, init = self.inp.masks(1), self.inp.params(1)
        self.model.load_state_dict(init)
        # a new split's state, one body run; then the body replayed alone
        self.runner(self.ops, self.x, self.y, masks,
                    seed=self.inp.dropout_seed(1), labels_onehot=self.y1h,
                    epoch_limit=1)
        kept = self.runner.kept()
        body, side = kept.loop.graph, kept.loop.side
        warm = 2
        if 1 + warm + bodies > int(self.cfg.epochs):
            raise ValueError(f"trace_epochs {bodies} exceeds the split")
        _sync(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            for _ in range(warm):      # the first replay instantiates
                body.replay()
        _sync(self.dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(side):
                for _ in range(bodies):
                    body.replay()
            _sync(self.dev)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        k = int(kept.state.k)
        if not bool(torch.isfinite(kept.state.train_losses[:k]).all()):
            self.failed = 1
        record = trace.record_from_events(prof.events(), bodies)
        del prof
        shape = dict(self.cell.config,
                     data=dict(self.cell.config["data"], **self.nnz))
        record.update(prepare_s=self.prepare_s, capture_ms=self.capture_ms,
                      counts=self.cell.counts.epoch(shape))
        return record

    # -- after the window --------------------------------------------------

    def free_program(self) -> None:
        self.runner.release()
        for name in ("runner", "model", "ops", "x", "y", "y1h"):
            delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        """The cell's reference step by step along the program's
        trajectory, from the same inputs, and the compared numbers."""
        self.followed = self.cell.reference.follow(
            reference_trainer(self.cell, self.inp, self.adj), self.trajectory)
        return check.gaps(self.followed,
                          self.cell.workload.get("leaf", "worst"))


def reference_trainer(cell, inp, adj, lower=None, device=None,
                      masks=None):
    """The cell's reference's trainer on split 0 of ``inp``'s inputs (made
    on their device, computed on ``device``), lowered to ``lower``."""
    ref = cell.reference
    dev = inp.device if device is None else torch.device(device)
    model = cell.config["model"]
    x = torch.from_numpy(ref.preprocess(inp.features().cpu().numpy(),
                                        model)).to(dev)
    masks = inp.masks(0) if masks is None else masks
    return ref.Trainer(x, ref.Graph(adj, dev), inp.labels().to(dev),
                       tuple(m.to(dev) for m in masks), model,
                       inp.dropout_seed(0), lower)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0=None) -> dict:
    """One run; returns the result line's object."""
    t0 = time.perf_counter() if t0 is None else t0
    run = Run(cell, seed, device, t0)
    run.setup()
    setup_s = time.perf_counter() - t0
    if traced:
        record = run.profile(int(cell.workload["trace_epochs"]))
        values = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(record)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        measured = run.window(seconds)
    peak = (torch.cuda.max_memory_allocated(run.dev)
            if run.dev.type == "cuda" else 0)
    if not traced:
        measured.update(peak_gib=peak / 2**30, setup_s=setup_s)
        values = {m["name"]: {"value": measured[m["name"]],
                              "unit": m["unit"]}
                  for m in cell.end_to_end}
    run.free_program()
    numbers = run.compare()
    limits = cell.workload["limits"]
    correct = check.judge(numbers, limits) and run.failed == 0
    device = {"platform": "gpu" if run.dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.dev)
                       if run.dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak),
              "power_limit_w": (power_limit_w() if run.dev.type == "cuda"
                                else None)}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": values, "device": device}
    if traced:
        device.update(busy_s=record["busy_us"] * 1e-6,
                      window_s=record["window_us"] * 1e-6)
        out["breakdown"] = trace.breakdown(record)
    # the kernels' build, which only the first run in a checkout pays
    out["build"] = {"seconds": run.build_s}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in check.NUMBERS}
    return out


def _finite(obj):
    """``obj`` with every non-finite float written as a string (JSON has
    no NaN)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(args, t0: float) -> int:
    cell = manifest.Cell(args.workload, manifest.manifest())
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    found = forbidden_modules()
    if found:
        log(f"modules the benchmark may not load were loaded: {found}")
        return 4
    for k, v in out["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(_finite(out)), flush=True)
    return 0
