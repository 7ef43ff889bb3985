"""Shared fixtures of the benchmark's tests (CPU; ``gpu`` tests skip
without a card)."""

import copy

import pytest
import torch

from benchmark import manifest

# tiny shapes of each configuration for the CPU (widths kept where the
# path depends on them: F > 128 takes penn94's projected training branch)
TINY = {
    "acmgcnp-twitch_gamers": dict(nodes=400, pairs=3000),
    "acmgcnpp-penn94": dict(nodes=300, pairs=2000, features=200,
                            top_expected_degree=40),
}
TINY_EPOCHS = 20


def tiny_cell(name: str) -> manifest.Cell:
    cell = manifest.Cell(name, manifest.manifest())
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"].update(TINY[cell.entry["config"]])
    cell.traffic = dict(cell.traffic, epochs=TINY_EPOCHS)
    return cell


@pytest.fixture
def card():
    """The card, or a skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
