"""Shared fixtures of the benchmark's tests (CPU; ``gpu`` tests skip
without a card)."""

import copy
from pathlib import Path

import pytest
import torch

from benchmark import manifest

# Each configuration's tiny shape for the CPU is ``tiny/<config>.json``:
# the keys of its ``data`` that change (widths kept where the path depends
# on them: F > 128 takes penn94's projected training branch).  A test of a
# configuration without one is skipped, by name.
TINY_EPOCHS = 20


def tiny_cell(name: str, bench: dict | None = None,
              root: Path = manifest.ROOT) -> manifest.Cell:
    cell = manifest.Cell(name, manifest.manifest() if bench is None
                         else bench, root)
    config = cell.entry["config"]
    path = root / "tests" / "tiny" / f"{config}.json"
    if not path.is_file():
        pytest.skip(f"configuration {config} has no tiny CPU shape "
                    f"(tests/tiny/{config}.json)")
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"].update(manifest.load_json(path))
    cell.traffic = dict(cell.traffic, epochs=TINY_EPOCHS)
    return cell


@pytest.fixture
def card():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
