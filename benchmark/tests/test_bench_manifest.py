"""``BENCHMARK.json`` keeps to the contract's shapes, and a cell, a
configuration or a metric is found by name, so a new one is new files."""

import json
import re
import shutil

import pytest

from benchmark import manifest
from benchmark.tests.conftest import CELLS

BENCH = manifest.manifest()
LINE = re.compile(r"[^\n\t]{1,200}")


def test_top_level_keys_are_the_contracts():
    assert sorted(BENCH) == sorted(["command", "paths", "run_seconds",
                                    "configs", "workloads", "end_to_end",
                                    "per_layer"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(LINE.fullmatch(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(set(names)) == len(names)
    for e in BENCH[section]:
        assert manifest.NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads",
                                        "per_layer"):
                assert LINE.fullmatch(e[key]), (key, e[key])


def test_every_metric_is_reported_where_it_says():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m.get("workloads", CELLS):
            assert w in CELLS
    for w in CELLS:
        reported = [m for m in BENCH["per_layer"]
                    if w in m.get("workloads", CELLS)]
        assert reported, w


def test_configs_lie_under_paths_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert (manifest.REPO / c["file"]).is_file()
        data = manifest.load_json(manifest.REPO / c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert manifest.NAME.fullmatch(key)


@pytest.mark.parametrize("name", CELLS)
def test_every_workload_finds_its_files_by_name(name):
    cell = manifest.Cell(name, BENCH)
    assert cell.chips in (1, 4)
    assert callable(cell.counts.epoch)
    assert sorted(cell.readers) == sorted(m["name"] for m in cell.per_layer)
    assert all(callable(r.read) for r in cell.readers.values())
    assert set(cell.workload["limits"]) >= {"loss_gap", "val_loss_gap",
                                            "grad_gap", "change_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_a_workload_and_a_metric_added_as_files_are_picked_up(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(manifest.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = "acmgcnp-twitch_gamers.uniform"
    (root / "traffic" / "uniform.json").write_text(json.dumps(dict(
        manifest.load_json(root / "traffic" / "powerlaw.json"),
        graph="uniform")))
    (root / "workloads" / f"{new}.json").write_text(json.dumps(dict(
        manifest.load_json(root / "workloads"
                           / "acmgcnp-twitch_gamers.powerlaw.json"),
        traffic="uniform")))
    (root / "metrics" / "k1_share.py").write_text(
        "def read(record):\n"
        "    return 42.0 if record['bodies'] else None\n")
    bench["workloads"].append(dict(name=new, config="acmgcnp-twitch_gamers",
                                   traffic="uniform", chips=1, why="K1 idle"))
    bench["per_layer"].append(dict(name="k1_share", unit="%",
                                   better="higher", source="device_trace",
                                   layer="kernels", moves="epoch_ms",
                                   workloads=[new]))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = manifest.Cell(new, manifest.manifest(path), root=root)
    assert cell.traffic["graph"] == "uniform"
    assert cell.readers["k1_share"].read({"bodies": 3}) == 42.0
    # the cells already there are untouched by it
    old = manifest.Cell(CELLS[0], manifest.manifest(path), root=root)
    assert "k1_share" not in old.readers
