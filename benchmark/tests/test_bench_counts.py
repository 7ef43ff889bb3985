"""The operation and byte counts equal sums worked by hand from each
configuration's shapes."""

import pytest

from benchmark import manifest, peaks
from benchmark.tests.conftest import CELLS

L, R = 13_759_942, 13_591_828       # entries of A + I and of A


def shape(name):
    cell = manifest.Cell(name, manifest.manifest())
    config = dict(cell.config, data=dict(cell.config["data"], nnz_low=L,
                                         nnz_raw=R))
    return cell, config


def test_twitch_counts_by_hand():
    cell, config = shape("acmgcnp-twitch_gamers.powerlaw")
    n, f, h, c = 168_114, 7, 64, 2
    got = cell.counts.epoch(config)
    # f32 projections: 9 of [N, F] x [F, H] (train fwd 3, dW 3, eval 3),
    # 12 of [N, H] x [H, C] (train fwd 3, dW 3, dh 3, eval 3); sparse
    # products 2·L·(F + 3 · 2C); the mix 4·T·N·d fwd, 8·T·N·d bwd
    flops = (9 * 2 * n * f * h + 12 * 2 * n * h * c + 2 * L * (f + 6 * c)
             + 48 * n * (h + c))
    assert got.flops() == flops
    assert got.seconds_at_peak(peaks.FLOPS_PER_S) == pytest.approx(
        flops / 67e12, rel=1e-12)
    # three traversals: A x (w7 bf16), both branches' layer 2 (w8, 4
    # residual columns), its transpose (w4, 2 residual columns)
    assert len(got.traversals) == 3
    assert got.traversal_bytes() == 12 * L + n * (42 + 64 + 32)


def test_penn94_counts_by_hand():
    cell, config = shape("acmgcnpp-penn94.chunglu")
    n, f, h, c = 41_554, 4814, 64, 2
    got = cell.counts.epoch(config)
    bf16 = 13 * 2 * n * f * h + 12 * 2 * n * h * c
    f32 = 2 * L * (4 * h + 6 * c) + 4 * R * (h + c) + 64 * n * (h + c)
    assert got.flops() == bf16 + f32
    assert got.seconds_at_peak(peaks.FLOPS_PER_S) == pytest.approx(
        bf16 / 989e12 + f32 / 67e12, rel=1e-12)
    # eight traversals: w128 on Â both ways, w64 and w2 on A both ways,
    # layer 2's w8 and its w4 transpose
    assert len(got.traversals) == 8
    assert got.traversal_bytes() == 16 * L + 16 * R + n * (
        2 * 1024 + 2 * 384 + 2 * 12 + 64 + 32)


@pytest.mark.parametrize("name", CELLS)
def test_counts_depend_on_shapes_alone(name):
    cell, config = shape(name)
    a, b = cell.counts.epoch(config), cell.counts.epoch(config)
    assert a.flops() == b.flops() > 0
    assert a.traversal_bytes() == b.traversal_bytes() > 0
