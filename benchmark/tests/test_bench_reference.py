"""The plain reference agrees with the port's CPU path at a tiny size, and
its frozen pieces with what they copy."""

import numpy as np
import pytest
import torch

from acmgnn_tpu_torch.ops import dropout as port_dropout
from benchmark import check, harness
from benchmark.reference import acm, philox
from benchmark.tests.conftest import CELLS, tiny_cell


@pytest.mark.parametrize("seed,epoch,site", [(0, 0, 0), (7, 3, 2),
                                             (2**32 - 1, 499, 1)])
def test_philox_copy_is_the_ports_rule(seed, epoch, site):
    h = torch.randn(37, 13, generator=torch.Generator().manual_seed(seed % 97))
    key = port_dropout.DropoutKey.new(seed, 0, torch.tensor(epoch))
    want = port_dropout.dropout_plain(h, 0.5, key, site)
    got = philox.dropout(h, 0.5, seed, epoch, site)
    assert torch.equal(got, want)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    r = acm._round_tf32(x)
    assert not bool((r.view(torch.int32) & 0x1FFF).any())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(name):
    out = harness.run_cell(tiny_cell(name), 2**31 + 101, 0.5, False,
                           device="cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    for k, v in out["checks"].items():
        assert v["value"] < 1e-3 * v["limit"] or v["value"] < 1e-4, (k, v)


def test_preprocess_divides_rows_by_their_sum():
    f = np.array([[1.0, 3.0], [0.0, 0.0], [2.0, -1.0]], np.float32)
    model = {"structure_info": False, "model_type": "acmgcnp"}
    assert np.array_equal(acm.preprocess(f, model),
                          np.array([[0.25, 0.75], [0, 0], [2, -1]],
                                   np.float32))
    model = {"structure_info": True, "model_type": "acmgcnpp"}
    assert np.array_equal(acm.preprocess(f, model), f)


def test_gaps_measure_the_worst_leaf_against_the_median_floor():
    followed = dict(
        loss=[(1.0, 1.0), (2.2, 2.0)], val_loss=[(1.0, 1.0)],
        grad=[({"a": 1.0, "b": 2e-9, "c": 4.0},
               {"a": 1.0, "b": 1e-9, "c": 4.0})],
        change=[({"a": 1.5, "b": 5.0, "c": 4.0},
                 {"a": 1.0, "b": 1e-9, "c": 4.0})])
    g = check.gaps(followed)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_gap"] == pytest.approx(1e-9)      # floor: median 1.0
    # "b" left out; the floor is the median of "a" and "c": 2.5
    assert g["change_gap"] == pytest.approx(0.2)
    followed["grad"][0][0]["a"] = float("nan")
    assert check.gaps(followed)["grad_gap"] != check.gaps(followed)[
        "grad_gap"]


def test_following_a_trajectory_of_its_own_reads_nought():
    cell = tiny_cell(CELLS[1])
    from benchmark import inputs
    adj = inputs.graph(cell.config, cell.traffic, "cpu")
    inp = inputs.Inputs(cell.config, cell.traffic, 5, "cpu", adj,
                        cell.reference)
    tr = harness.reference_trainer(cell, inp, adj)
    traj = cell.reference.train(tr, inp.params(0), check.STEPS)
    g = check.gaps(cell.reference.follow(tr, traj))
    assert g["loss_gap"] == 0.0 and g["val_loss_gap"] == 0.0
    assert g["grad_gap"] < 1e-5 and g["change_gap"] < 1e-5


def test_the_reference_in_a_second_order_passes_the_limits_by_the_median():
    """Rounding alone (the projections summed in another order) stays
    within every limit of an f32 cell, whose gradient and change are taken
    by the median leaf because their worst leaf moves far on it."""
    from benchmark import control, inputs
    cell = tiny_cell(CELLS[0])
    assert cell.config["model"]["gemm_dtype"] == "float32"
    assert cell.workload["leaf"] == "median"
    adj = inputs.graph(cell.config, cell.traffic, "cpu")
    for seed in (3, 2**31 + 5):
        numbers = control.second_order(cell, seed, "cpu", adj)
        assert check.judge(numbers["median"], cell.workload["limits"]), \
            numbers
        assert numbers["worst"]["grad_gap"] >= numbers["median"]["grad_gap"]


def test_the_variance_clamp_halves_the_gradient_at_the_tie():
    """flax's ``max(mean(h²) − mean(h)², 0)``: part of the gradient where
    the difference is exactly 0 (``jnp.maximum`` gives half), not all of
    it (torch's clamp) and not none of it (a ReLU)."""
    h = torch.tensor([[1000.0, 1000.0 + 2.0**-7]], requires_grad=True)
    p = {"l.att_vec": torch.eye(3)}
    for nm in acm.CHANNELS[:3]:
        p[f"l.layer_norm_{nm}.scale"] = torch.full((2,), 0.01)
        p[f"l.layer_norm_{nm}.bias"] = torch.zeros(2)
        p[f"l.att_vec_{nm}"] = torch.tensor([[1.0], [-1.0]])
    zs = [h, torch.tensor([[0.5, 2.0]]), torch.tensor([[2.0, 0.25]])]
    with torch.no_grad():
        mu = h.mean(dim=1, keepdim=True)
        assert float((h * h).mean(dim=1, keepdim=True) - mu * mu) == 0.0

    def grad(clamp):
        real = torch.maximum
        torch.maximum = clamp
        try:
            return torch.autograd.grad(acm._mix(p, "l.", zs, True).sum(),
                                       h)[0]
        finally:
            torch.maximum = real

    half = grad(torch.maximum)
    whole = grad(lambda a, b: torch.clamp_min(a, 0.0))
    none = grad(lambda a, b: torch.relu(a))
    low, high = torch.minimum(whole, none), torch.maximum(whole, none)
    assert bool(((low < half) & (half < high)).all()), (half, whole, none)
