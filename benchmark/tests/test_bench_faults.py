"""The comparison fails what it must: the control (the reference in the
precision below the configuration's) and each fault of the timed path a
training cell can have (a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced), planted
under a whole run at a tiny size on the CPU."""

import pytest
import torch

from acmgnn_tpu_torch.train import trainer
from benchmark import check, control, harness, inputs
from benchmark.tests.conftest import CELLS, tiny_cell

SEED = 2**31 + 333


@pytest.mark.parametrize("side", ["control", "half_batch", "stale_eval"])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_in_the_programs_place_are_not_correct(
        name, side):
    cell = tiny_cell(name)
    adj = inputs.graph(cell.config, cell.traffic, "cpu")
    kw = (dict(lower=control.CONTROL[cell.config["model"]["gemm_dtype"]])
          if side == "control" else dict(fault=side))
    numbers, _ = control.in_the_programs_place(cell, SEED, "cpu", adj, **kw)
    assert not check.judge(numbers, cell.workload["limits"]), numbers


def _unchanged(make):
    """``make_optimizer`` whose optimizers take no step (an instance
    attribute: torch wraps the class's ``step`` once it has one)."""
    def wrapper(*args, **kwargs):
        opt = make(*args, **kwargs)
        opt.step = lambda closure=None: None
        return opt
    return wrapper


def _half_batch_nll(nll):
    def wrapper(log_probs, labels, mask, count=None):
        keep = torch.zeros_like(mask)
        keep[torch.nonzero(mask).flatten()[::2]] = True
        return nll(log_probs, labels, keep, count)
    return wrapper


def _altered_evaluation(write_at):
    """The joint loop's validation loss (its one masked history write)
    altered where it is produced."""
    def wrapper(hist, idx, value, valid=None):
        if valid is not None:
            value = value * (1.0 + 2.0**-10)
        return write_at(hist, idx, value, valid)
    return wrapper


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(trainer, "make_optimizer",
                            _unchanged(trainer.make_optimizer))
    elif fault == "half_batch":
        monkeypatch.setattr(trainer, "masked_nll",
                            _half_batch_nll(trainer.masked_nll))
    else:
        monkeypatch.setattr(trainer, "write_at",
                            _altered_evaluation(trainer.write_at))
    out = harness.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]


def test_the_half_batch_fault_leaves_out_every_second_node():
    masks = (torch.tensor([True, True, False, True, True]),)
    assert control.half_batch(masks)[0].tolist() == [True, False, False,
                                                     True, False]
