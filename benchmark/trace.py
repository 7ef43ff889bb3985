"""The traced run's record, reduced from a ``torch.profiler`` window of
replays of the program's captured loop body.

The window holds replays and nothing else: the card is idle before and
after, and the host issues only the replays between.  Its device
operations (kernels, copies, sets) give each per-layer metric its
numbers (``metrics/``); the union of their intervals is the device's busy
time, and the gaps between them are labelled by what the host was doing
then.

``kernel_group`` is a frozen copy of the name rules of ``chip_smoke.py``
``_kernel_group`` (the groups of PERF.md's profiles).
"""

from __future__ import annotations

import re

ANNOTATION = re.compile(r"[\w.]+#[\w.]+")
NAME_CHARS = 160


def kernel_group(name: str) -> str:
    low = name.lower()
    if "spmm_rows_kernel" in name or "spmm_wide_kernel" in name:
        return "K1 spmm"
    if "attn_fwd_kernel" in name:
        return "K2 attention fwd"
    if "attn_bwd" in name:           # attn_bwd_kernel and its finish
        return "K3 attention bwd"
    if "rocauc_pass_kernel" in name:
        return "K4 auc"
    if "coo_slices_kernel" in name or "coo_spans_kernel" in name:
        return "K5 coo"
    if "halo_pack_kernel" in name:
        return "K6 halo pack"
    if "dropout_kernel" in name:
        return "K8 dropout"
    if "loop_cond_kernel" in name:
        return "K9 loop condition"
    if "nccl" in low:
        return "NCCL collectives"
    if "sort" in low:
        return "torch.sort"
    if any(k in low for k in ("cusparse", "csrmm", "spmm", "csr2")):
        return "torch.sparse (cuSPARSE)"
    if "index" in low or "scatter" in low:
        return "indexing (index_add/gather/scatter)"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                              "splitk")):
        return "cuBLAS GEMM"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (ATen elementwise, reductions, Adam)"


def is_cast(name: str) -> bool:
    """An ATen copy or dtype-conversion kernel (``direct_copy_kernel_cuda``,
    ``bfloat16_copy_kernel_cuda``), not a memcpy or memset."""
    return "_copy_kernel" in name and "memcpy" not in name.lower()


def _is_device(e) -> bool:
    return "cuda" in str(e.device_type).lower()


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)
                or ANNOTATION.fullmatch(e.key))


def union(intervals):
    """Disjoint sorted intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def record_from_events(events, bodies: int) -> dict:
    """``ops``: (name, start µs, end µs) of every device operation;
    ``window_us``: first start to last end; ``busy_us``: the union of
    their intervals; ``gaps``: (host label, µs) of every idle gap inside
    the window; ``bodies``: the replays the window holds."""
    ops, host = [], []
    for e in events:
        if e.time_range.end <= 0:
            continue
        if _is_device(e):
            if not _is_annotation(e):
                ops.append((e.name, e.time_range.start, e.time_range.end))
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    if not ops:
        return dict(ops=[], window_us=0.0, busy_us=0.0, gaps=[],
                    bodies=bodies)
    busy = union((a, b) for _, a, b in ops)
    gaps = []
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        inside = [(a, nm) for a, b, nm in host if a <= end < b]
        label = (max(inside)[1] if inside
                 else "no host call recorded")
        gaps.append((label, start - end))
    return dict(ops=ops, window_us=busy[-1][1] - busy[0][0],
                busy_us=sum(b - a for a, b in busy), gaps=gaps,
                bodies=bodies)


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, in seconds over the window."""
    by_name: dict = {}
    for name, a, b in record["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(record["gaps"], key=lambda g: -g[1])[:top]
    return dict(device_ops=[[n[:NAME_CHARS], us * 1e-6] for n, us in ops],
                idle_gaps=[[n[:NAME_CHARS], us * 1e-6] for n, us in gaps])


def device_us(record: dict, keep) -> float:
    """Device µs of the operations whose name ``keep`` accepts."""
    return sum(b - a for name, a, b in record["ops"] if keep(name))
