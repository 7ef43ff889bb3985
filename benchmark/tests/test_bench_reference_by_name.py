"""The plain reference is found by the name its configuration gives it
(``manifest.reference``): a configuration with a reference of its own is
new files alone, every use goes through ``Cell.reference``, and the
default, ``acm``, gives what calling ``benchmark.reference.acm`` directly
gives, bit for bit."""

import json
import shutil

import pytest
import torch

from benchmark import check, harness, inputs, manifest
from benchmark.reference import acm
from benchmark.tests.conftest import CELLS, tiny_cell

SEED = 2**31 + 777
BASE = "acmgcnp-twitch_gamers"
BASE_CELL = "acmgcnp-twitch_gamers.powerlaw"

RECORDING = '''"""``acm`` under another name, recording each call."""
from benchmark.reference import acm

CALLS = []


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.append(name)
        return getattr(acm, name)(*args, **kwargs)
    return call


for _name in ("param_shapes", "init_params", "preprocess", "Graph",
              "Trainer", "train", "follow"):
    globals()[_name] = _recorded(_name)
'''

EXTRA_PARAMETER = '''"""``acm`` with one parameter the program does not have."""
from benchmark.reference import acm
from benchmark.reference.acm import (Graph, Trainer, follow, init_params,
                                     preprocess, train)


def param_shapes(model, nfeat, nclass, nnodes):
    return dict(acm.param_shapes(model, nfeat, nclass, nnodes),
                **{"gcn_2.weight_low": ((nclass, nclass), ("uniform", 1.0))})
'''

NO_FOLLOW = '''from benchmark.reference.acm import (Graph, Trainer, init_params,
                                     param_shapes, preprocess, train)
'''


def added(tmp_path, reference: str, source: str | None = None):
    """A copy of the benchmark with one more configuration, ``BASE`` under
    the reference ``reference`` (its module ``source`` where given), and
    one cell of it, each as new files: ``(manifest, root, cell name)``."""
    root = tmp_path / "benchmark"
    shutil.copytree(manifest.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = f"{BASE}-{reference.replace('/', '_')}"
    name = f"{config}.powerlaw"
    if source is not None:
        (root / "reference" / f"{reference}.py").write_text(source)
    (root / "configs" / f"{config}.json").write_text(json.dumps(dict(
        manifest.load_json(root / "configs" / f"{BASE}.json"), name=config,
        reference=reference)))
    shutil.copy(root / "counts" / f"{BASE}.py",
                root / "counts" / f"{config}.py")
    shutil.copy(root / "tests" / "tiny" / f"{BASE}.json",
                root / "tests" / "tiny" / f"{config}.json")
    (root / "workloads" / f"{name}.json").write_text(json.dumps(dict(
        manifest.load_json(root / "workloads" / f"{BASE_CELL}.json"),
        config=config)))
    bench = json.loads(json.dumps(manifest.manifest()))
    entry = next(c for c in bench["configs"] if c["name"] == BASE)
    bench["configs"].append(dict(entry, name=config,
                                 file=f"benchmark/configs/{config}.json"))
    bench["workloads"].append(dict(name=name, config=config,
                                   traffic="powerlaw", chips=1,
                                   why="the reference found by name"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if BASE_CELL in m.get("workloads", []):
            m["workloads"].append(name)
    return bench, root, name


def test_a_reference_added_as_files_decides_correct(tmp_path):
    bench, root, name = added(tmp_path, "mine", RECORDING)
    cell = tiny_cell(name, bench, root)
    mine = cell.reference
    assert mine.__file__ == str(root / "reference" / "mine.py")
    d = cell.config["data"]
    adj = inputs.graph(cell.config, cell.traffic, "cpu")
    inp = inputs.Inputs(cell.config, cell.traffic, SEED, "cpu", adj, mine)
    assert mine.CALLS == ["param_shapes"]
    assert inp.shapes == acm.param_shapes(cell.config["model"],
                                          d["features"], d["classes"],
                                          d["nodes"])
    mine.CALLS.clear()
    out = harness.run_cell(cell, SEED, 0.2, False, device="cpu")
    assert set(mine.CALLS) >= {"param_shapes", "init_params", "preprocess",
                               "Graph", "Trainer", "follow"}
    assert out["correct"], out["checks"]
    base = harness.run_cell(tiny_cell(BASE_CELL), SEED, 0.2, False,
                            device="cpu")
    assert out["checks"] == base["checks"]


def test_a_reference_with_a_parameter_the_program_lacks_fails_at_set_up(
        tmp_path):
    bench, root, name = added(tmp_path, "extra", EXTRA_PARAMETER)
    cell = tiny_cell(name, bench, root)
    with pytest.raises(RuntimeError, match="are not the reference's"):
        harness.run_cell(cell, SEED, 0.2, False, device="cpu")


@pytest.mark.parametrize("reference,source,error,named", [
    ("nothere", None, FileNotFoundError, "reference/nothere.py"),
    ("nofollow", NO_FOLLOW, AttributeError, r"reference/nofollow.py lacks "
                                            r"\['follow'\]"),
    ("../acm", None, ValueError, r"'\.\./acm', which is no name"),
], ids=["missing", "incomplete", "not_a_name"])
def test_a_reference_that_is_not_there_whole_fails_by_name(
        tmp_path, reference, source, error, named):
    bench, root, name = added(tmp_path, reference, source)
    with pytest.raises(error, match=named):
        manifest.Cell(name, bench, root)


def test_a_configuration_without_a_tiny_shape_is_skipped_by_name(tmp_path):
    bench, root, name = added(tmp_path, "acm")
    assert manifest.Cell(name, bench, root).reference.__file__ == str(
        root / "reference" / "acm.py")
    (root / "tests" / "tiny" / f"{BASE}-acm.json").unlink()
    with pytest.raises(pytest.skip.Exception,
                       match=f"configuration {BASE}-acm has no tiny"):
        tiny_cell(name, bench, root)


@pytest.mark.parametrize("name", CELLS)
def test_the_default_reference_is_acm_bit_for_bit(name):
    cell = tiny_cell(name)
    assert "reference" not in cell.config
    assert cell.reference.__file__ == acm.__file__
    adj = inputs.graph(cell.config, cell.traffic, "cpu")
    got = inputs.Inputs(cell.config, cell.traffic, SEED, "cpu", adj,
                        cell.reference)
    want = inputs.Inputs(cell.config, cell.traffic, SEED, "cpu", adj, acm)
    assert got.shapes == want.shapes
    assert torch.equal(got.features(), want.features())
    assert torch.equal(got.labels(), want.labels())
    assert all(torch.equal(a, b) for a, b in zip(got.masks(0),
                                                 want.masks(0)))
    p_got, p_want = got.params(0), want.params(0)
    assert list(p_got) == list(p_want)
    assert all(torch.equal(p_got[k], p_want[k]) for k in p_want)

    # the reference's own three steps, then followed, by either route
    model = cell.config["model"]
    direct = acm.Trainer(
        torch.from_numpy(acm.preprocess(want.features().numpy(), model)),
        acm.Graph(adj, "cpu"), want.labels(), want.masks(0), model,
        want.dropout_seed(0), None)
    routed = harness.reference_trainer(cell, got, adj)
    assert torch.equal(routed.x, direct.x)
    t_want = acm.train(direct, p_want, check.STEPS)
    t_got = cell.reference.train(routed, p_got, check.STEPS)
    assert t_got["losses"] == t_want["losses"]
    assert t_got["val_losses"] == t_want["val_losses"]
    for key in ("params", "m", "v"):
        for a, b in zip(t_got[key], t_want[key]):
            assert all(torch.equal(a[k], b[k]) for k in b), key
    assert (cell.reference.follow(routed, t_got)
            == acm.follow(direct, t_want))
