"""Profiling hooks — counterpart of ``acmgnn_tpu/utils/profiling.py``:
``torch.profiler`` traces (``jax.profiler`` there) and step timing."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str = "./acmgnn_trace", enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the body (host operations,
    and the card's kernels when CUDA is available) and write it as a
    Chrome trace, ``<log_dir>/trace.json`` (chrome://tracing, Perfetto)."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def sync_devices():
    """Block until every local card has finished the work queued on it
    (nothing to wait for on the CPU, which runs eagerly)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def timed(label: str, sink=None, sync=True):
    """Wall-clock bracket; appends ``(label, seconds)`` to ``sink`` or
    prints the ms.  ``sync`` drains the cards before and after the body
    (``sync_devices``): without it an asynchronous launch would leave
    the bracket before its work is done."""
    if sync:
        sync_devices()
    t0 = time.perf_counter()
    yield
    if sync:
        sync_devices()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.append((label, dt))
    else:
        print(f"[timed] {label}: {dt * 1000:.2f} ms")
