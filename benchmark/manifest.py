"""``BENCHMARK.json`` and the files it names, found by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, which the
  one generator in ``inputs.py`` reads;
- ``workloads/<cell>.json``: the cell: its configuration, traffic, chips,
  the bodies its traced run profiles and the limits of its comparison;
- ``counts/<config>.py``: ``epoch(config) -> countlib.Counts``, the
  operations and bytes of one epoch from the configuration's shapes;
- ``metrics/<metric>.py``: ``read(record) -> float | None``, a per-layer
  metric from a traced run's record.

A new cell, configuration, traffic mix or metric is new files and a new
entry in ``BENCHMARK.json``; nothing here names one.
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


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark manifest at {path}")
    return load_json(path)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(ROOT.parent)}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_found_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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
