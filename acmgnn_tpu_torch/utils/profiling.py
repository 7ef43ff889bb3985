"""Profiling hooks — counterpart of ``acmgnn_tpu/utils/profiling.py``:
``torch.profiler`` traces (``jax.profiler`` there), and the program's own
spans and counters.

Spans (``span``) mark where the program's work happens: a split, a
runner call and its phases, ``prepare_data`` and its steps.  They are off
by default; then ``span`` is one flag check and records nothing, creates
no CUDA event and synchronizes nothing.  ``enable_spans`` turns them on
(from code only).  On, each span records its name, its parent and
``time.perf_counter_ns`` at entry and exit; ``device=True`` also records a
CUDA event on the current stream at each edge, which puts the span on the
card's clock; ``sync=True`` waits for the card at exit (only for set-up
spans outside any capture).  While a ``torch.profiler`` profile is active
each span is also a ``record_function`` range, so the profile's kernels
and idle gaps sit under the program span that was open.  ``spans()``
returns the records, ``counts`` holds the counters (``count``), and
``reset_spans`` clears both.
"""

from __future__ import annotations

import collections
import contextlib
import time
from pathlib import Path
from typing import Optional

import torch

TRACE_FILE = "trace.json"

counts: collections.Counter = collections.Counter()
_on = False
_records: list = []      # one dict a span, in the order the spans opened
_open: list = []         # indices into _records of the spans still open
_origin = None           # the first device span's start event: the card
#                          clock's zero
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def profile_trace(log_dir: str = "./acmgnn_trace", enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the body (host operations,
    and the card's kernels when CUDA is available) and write it as a
    Chrome trace, ``<log_dir>/trace.json`` (chrome://tracing, Perfetto).
    Spans are on for the body (their ranges in the trace, over the
    kernels), and ``spans()`` holds the body's alone afterwards."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = _on
    reset_spans()
    enable_spans()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            disable_spans()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def enable_spans() -> None:
    global _on
    _on = True


def disable_spans() -> None:
    global _on
    _on = False


def spans_enabled() -> bool:
    return _on


def reset_spans() -> None:
    """Forget every span and counter; call it with no span open."""
    global _origin
    _records.clear()
    counts.clear()
    _origin = None


def count(name: str, n: int = 1) -> None:
    """``counts[name] += n`` while spans are on."""
    if _on:
        counts[name] += n


def _on_card() -> bool:
    """Whether CUDA is in use in this process (device spans record events
    only then)."""
    return torch.cuda.is_initialized()


class _Span:
    __slots__ = ("rec", "device", "sync", "range")

    def __init__(self, name: str, device: bool, sync: bool):
        self.rec = {"name": name, "parent": None, "start_ns": None,
                    "end_ns": None}
        self.device = device and _on_card()
        self.sync = sync
        self.range = None

    def __enter__(self):
        global _origin
        self.rec["parent"] = _open[-1] if _open else None
        _open.append(len(_records))
        _records.append(self.rec)
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.autograd.profiler.record_function(
                self.rec["name"])
            self.range.__enter__()
        if self.device:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            _origin = ev if _origin is None else _origin
            self.rec["events"] = [ev, None]
        self.rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync and _on_card():
            torch.cuda.synchronize()
        self.rec["end_ns"] = time.perf_counter_ns()
        if self.device:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.rec["events"][1] = ev
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, device: bool = False, sync: bool = False):
    """A context manager that records one span while spans are on (see the
    module's docstring); off, a shared no-op."""
    if not _on:
        return _OFF
    return _Span(name, device, sync)


def spans() -> list:
    """The spans recorded, in the order they opened: dicts of ``name``,
    ``parent`` (the index of the enclosing span, or None), ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``; None while open) and, for a
    device span, ``device_start_ms`` and ``device_end_ms``: its edges on
    the card's clock, from the first device span's start (waits for the
    card to reach them)."""
    out = []
    for rec in _records:
        row = {k: rec[k] for k in ("name", "parent", "start_ns", "end_ns")}
        if "events" in rec:
            row.update(device_start_ms=_device_ms(rec["events"][0]),
                       device_end_ms=_device_ms(rec["events"][1]))
        out.append(row)
    return out


def _device_ms(ev) -> Optional[float]:
    if ev is None:
        return None
    ev.synchronize()
    return _origin.elapsed_time(ev)


def table() -> str:
    """The spans recorded, one line a name in order of first appearance:
    its calls, its host ms and its device ms (device spans) summed over
    the calls."""
    rows: dict = {}
    for rec in spans():
        if rec["end_ns"] is None:
            continue
        row = rows.setdefault(rec["name"], [0, 0.0, None])
        row[0] += 1
        row[1] += (rec["end_ns"] - rec["start_ns"]) / 1e6
        if rec.get("device_end_ms") is not None:
            row[2] = (row[2] or 0.0) + (rec["device_end_ms"]
                                        - rec["device_start_ms"])
    width = max([len("span")] + [len(n) for n in rows])
    lines = [f"{'span':<{width}} {'calls':>7} {'host ms':>12} "
             f"{'device ms':>12}"]
    for name, (calls, host, dev) in rows.items():
        lines.append(f"{name:<{width}} {calls:>7} {host:>12.3f} "
                     + (f"{dev:>12.3f}" if dev is not None else f"{'-':>12}"))
    return "\n".join(lines)
