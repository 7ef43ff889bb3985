"""Probe: row gathers from a small panel held in shared memory (K7).

Counterpart of ``tools/pallas_gather_probe.py``: the same configurations
in the same order, printing the same fields (name, ms per call, M rows/s):

- the yardstick, ``torch.index_select`` of M rows from a
  ``[168114, 128]`` f32 table in device memory (the headline graph's
  node count);
- K7 with per-element indices (P1) from f32 panels of P = 8, 512, 4096
  rows, the row index broadcast across the row as in the TPU probe;
- K7 with per-row indices (P2) from f32 panels of P = 512, 4096 and a
  bf16 panel of P = 4096.

Each call returns the f32 column sum of its ``[M, 128]`` output, as the
TPU probe's functions do.  Calls are timed with CUDA events; a failing
configuration fails the run.

    python -m acmgnn_tpu_torch.tools.gather_probe
"""

from __future__ import annotations

import numpy as np
import torch

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.ops.panel_gather import panel_gather

D = 128           # feature width
M = 1 << 20       # gathered rows per call
HBM_ROWS = 168114
WARMUP, ITERS = 3, 20   # calls per configuration: untimed, then timed


def make_panel_gather(m: int = M):
    """``fn(x, idx)``: K7 over M rows (per-element or per-row indices,
    as ``idx`` is ``[m, D]`` or ``[m]``), returning the output's f32
    column sum ``[1, D]``.  The TPU probe added a salt to ``x`` to defeat
    its remote backend's dedup of identical calls; CUDA has none, so
    there is no salt."""

    def fn(x, idx):
        if idx.shape[0] != m:
            raise ValueError(f"expected {m} index rows, got {idx.shape[0]}")
        return panel_gather(x, idx).sum(dim=0, keepdim=True,
                                        dtype=torch.float32)

    return fn


def index_select_sum(x, idx):
    """The yardstick: ``torch.index_select`` from a table in device
    memory, f32 column sum."""
    return torch.index_select(x, 0, idx).sum(dim=0, keepdim=True,
                                             dtype=torch.float32)


def configs(device, m: int = M, seed: int = 0):
    """``[(name, fn, x, idx)]``: the yardstick, then the six K7
    configurations, drawn from ``numpy.random.default_rng(seed)`` in the
    TPU probe's order."""
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = []
    xb = rng.standard_normal((HBM_ROWS, D), dtype=np.float32)
    idxb = rng.integers(0, HBM_ROWS, size=(m,), dtype=np.int32)
    out.append((f"torch.index_select (HBM, P={HBM_ROWS})", index_select_sum,
                dev(xb), dev(idxb)))
    gather = make_panel_gather(m)
    for p in (8, 512, 4096):
        x = rng.standard_normal((p, D), dtype=np.float32)
        idx = rng.integers(0, p, size=(m,), dtype=np.int32)
        out.append((f"K7 panel gather f32 P={p}", gather, dev(x),
                    dev(np.broadcast_to(idx[:, None], (m, D)))))
    for p in (512, 4096):
        x = rng.standard_normal((p, D), dtype=np.float32)
        idx = rng.integers(0, p, size=(m, 1), dtype=np.int32)
        out.append((f"K7 panel gather f32 bcast P={p}", gather, dev(x),
                    dev(idx[:, 0])))
    p = 4096
    xh = dev(rng.standard_normal((p, D)).astype(np.float32)).bfloat16()
    idx = rng.integers(0, p, size=(m, 1), dtype=np.int32)
    out.append((f"K7 panel gather bf16 bcast P={p}", gather, xh,
                dev(idx[:, 0])))
    return out


def time_ms(fn, *args, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(device=None, m: int = M):
    """Time every configuration; returns ``[(name, ms, M rows/s)]``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card; it has no CPU mode")
    rows = []
    for name, fn, x, idx in configs(dev, m):
        ms = time_ms(fn, x, idx)
        rate = m / ms * 1e3 / 1e6
        print(f"{name:40s} {ms:7.3f} ms  {rate:8.1f} M rows/s", flush=True)
        rows.append((name, ms, rate))
    return rows


if __name__ == "__main__":
    print("device:", torch.cuda.get_device_name(0), flush=True)
    main()
