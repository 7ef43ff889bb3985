"""What a run loads: no JAX and no JAX package (top-level names compared
whole, since ``acmgnn_tpu_torch`` begins with ``acmgnn_tpu``), and a
reference that loads nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, manifest

REPO = manifest.REPO


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = loaded_after(
        "from benchmark import run, harness, control, manifest\n"
        "from benchmark.tests.conftest import CELLS\n"
        "for c in CELLS: manifest.Cell(c, manifest.manifest())\n"
        "import acmgnn_tpu_torch.train.trainer, acmgnn_tpu_torch.ops.kernels")
    assert "acmgnn_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


REFERENCES = sorted((REPO / "benchmark" / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_the_reference_loads_nothing_of_the_program(path):
    module = ".".join(("benchmark", "reference", path.stem)).removesuffix(
        ".__init__")
    mods = loaded_after(f"import {module}, benchmark.check, "
                        "benchmark.inputs, benchmark.graphs")
    assert "acmgnn_tpu_torch" not in mods
    assert not mods & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_reference_sources_import_no_program_and_no_jax(path):
    banned = set(harness.FORBIDDEN) | {"acmgnn_tpu_torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        assert not {n.split(".")[0] for n in names} & banned, names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "acmgnn_tpu_torch_probe",
                        types.ModuleType("acmgnn_tpu_torch_probe"))
    assert "acmgnn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "acmgnn_tpu.probe",
                        types.ModuleType("acmgnn_tpu.probe"))
    assert harness.forbidden_modules() == ["acmgnn_tpu"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "acmgcnp-twitch_gamers.powerlaw", "--seed", "5", "--seconds", "1",
         *extra], cwd=cwd, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        timeout=300)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_with_only_the_benchmarks_files_a_run_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
