"""The traced run's reduction and its metric readers, on a made-up
profiler window; on the card, whole runs of each cell."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import countlib, manifest, trace
from benchmark.tests.conftest import CELLS


def event(name, start, end, device=True):
    return SimpleNamespace(name=name, key=name,
                           device_type="DeviceType.CUDA" if device
                           else "DeviceType.CPU",
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


EVENTS = [
    event("cudaGraphLaunch", 0.0, 5.0, device=False),
    event("cudaDeviceSynchronize", 5.0, 100.0, device=False),
    event("void spmm_rows_kernel<...>", 10.0, 30.0),
    event("sm90_xmma_gemm_f32f32", 30.0, 40.0),
    event("void at::native::direct_copy_kernel_cuda(...)", 50.0, 55.0),
    event("void at::native::bfloat16_copy_kernel_cuda(...)", 52.0, 60.0),
    event("Memcpy DtoD", 70.0, 80.0),
    event("Optimizer.step#Adam.step", 10.0, 80.0),
]


def test_record_unions_intervals_and_labels_gaps():
    rec = trace.record_from_events(EVENTS, bodies=2)
    assert len(rec["ops"]) == 5                     # the annotation left out
    assert rec["window_us"] == 70.0
    assert rec["busy_us"] == 20 + 10 + 10 + 10
    assert sorted(g[1] for g in rec["gaps"]) == [10.0, 10.0]
    assert {g[0] for g in rec["gaps"]} == {"cudaDeviceSynchronize"}
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0] == "void spmm_rows_kernel<...>"
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    assert len(b["idle_gaps"]) == 2


def test_kernel_groups_and_casts():
    assert trace.kernel_group("void spmm_wide_kernel<2>") == "K1 spmm"
    assert trace.kernel_group("sm80_xmma_gemm_bf16") == "cuBLAS GEMM"
    assert trace.is_cast("bfloat16_copy_kernel_cuda")
    assert not trace.is_cast("Memcpy DtoD (Device -> Device)")


@pytest.mark.parametrize("name", CELLS)
def test_every_metric_reader_reads_the_record(name):
    cell = manifest.Cell(name, manifest.manifest())
    rec = trace.record_from_events(EVENTS, bodies=2)
    config = dict(cell.config, data=dict(cell.config["data"], nnz_low=1000,
                                         nnz_raw=900))
    rec.update(prepare_s=1.5, capture_ms=30.0,
               counts=cell.counts.epoch(config))
    got = {k: r.read(rec) for k, r in cell.readers.items()}
    assert got["launches_per_epoch"] == 2.5
    assert got["gemm_ms"] == pytest.approx(0.005)
    assert got["cast_ms"] == pytest.approx(0.0065)
    assert got["device_idle_share"] == pytest.approx(100 * (1 - 50 / 70))
    assert got["prepare_s"] == 1.5 and got["capture_ms"] == 30.0
    assert got["spmm_roofline"] == pytest.approx(
        100 * rec["counts"].traversal_bytes() / 3.35e12 / 10e-6)
    empty = trace.record_from_events([], bodies=2)
    empty.update(prepare_s=None, capture_ms=None,
                 counts=countlib.Counts())
    assert all(r.read(empty) is None for r in cell.readers.values())


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_runs_correct_on_the_card(name, traced, card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "2147483999", "--seconds", "3", "--trace", str(traced)],
        cwd=manifest.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
