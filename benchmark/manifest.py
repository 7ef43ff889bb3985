"""``BENCHMARK.json`` and the files it names, found by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, which the
  one generator in ``inputs.py`` reads;
- ``workloads/<cell>.json``: the cell: its configuration, traffic, chips,
  the bodies its traced run profiles and the limits of its comparison;
- ``counts/<config>.py``: ``epoch(config) -> countlib.Counts``, the
  operations and bytes of one epoch from the configuration's shapes;
- ``metrics/<metric>.py``: ``read(record) -> float | None``, a per-layer
  metric from a traced run's record;
- ``reference/<reference>.py``: the plain reference that decides
  ``correct``, named by the configuration file's top-level key
  ``"reference"`` (``"acm"`` where the file has none), loaded once as
  ``Cell.reference``.

A reference module provides the names of ``REFERENCE``, with the
signatures of ``reference/acm.py``:

- ``param_shapes(model, nfeat, nclass, nnodes)``: every parameter by the
  program's name, its shape and initial law;
- ``init_params(shapes, gen, device)``: one draw of them from ``gen``;
- ``preprocess(features, model)``: the features as the model reads them
  (numpy in, numpy out);
- ``Graph(adj, device)``: the operators worked out from the raw
  adjacency;
- ``Trainer(x, graph, labels, masks, model, dropout_seed, lower)``: one
  split's training step, with ``.x``, ``.mm`` (the projection, which the
  control may replace), ``loss_and_grad(p, epoch)``, ``val_loss(p)`` and
  ``step(p, m, v, t)``; ``lower`` names the control's precision or is
  None;
- ``train(trainer, p0, steps)``: a trajectory of its own;
- ``follow(trainer, traj)``: the reference step by step along a
  trajectory, in the form ``check.gaps`` reads.

A new reference may import ``acm``'s building blocks instead of copying
them.  A new cell, configuration, traffic mix, reference or metric is new
files and a new entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
MANIFEST = REPO / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
DEFAULT_REFERENCE = "acm"
REFERENCE = ("param_shapes", "init_params", "preprocess", "Graph", "Trainer",
             "train", "follow")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark manifest at {path}")
    return load_json(path)


def _module(path: Path, name: str):
    if not path.is_file():   # named from the benchmark's folder down
        raise FileNotFoundError(f"no {path.relative_to(path.parents[2])}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_found_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict, root: Path = ROOT):
    """The plain reference module that the configuration ``config``
    names, checked for every name of ``REFERENCE``."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"configuration {config.get('name')!r} names the "
                         f"reference {name!r}, which is no name")
    mod = _module(root / "reference" / f"{name}.py", "reference_" + name)
    missing = [n for n in REFERENCE if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"reference/{name}.py lacks {missing}, which "
                             f"every reference provides")
    return mod


class Cell:
    """One entry of ``workloads`` and everything found by its names."""

    def __init__(self, name: str, bench: dict, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.workload = load_json(root / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} "
                                 f"{self.workload[key]!r}, BENCHMARK.json "
                                 f"{self.entry[key]!r}")
        self.config = load_json(root / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = load_json(root / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.reference = reference(self.config, root)
        self.counts = _module(root / "counts" / f"{self.entry['config']}.py",
                              "counts_" + self.entry["config"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.readers = {m["name"]: _module(root / "metrics"
                                           / f"{m['name']}.py",
                                           "metric_" + m["name"])
                        for m in self.per_layer}
        self.chips = int(self.entry["chips"])
