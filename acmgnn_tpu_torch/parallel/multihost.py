"""Process groups, per-rank node data and the collectives of the sharded path.

Counterpart of ``acmgnn_tpu/parallel/multihost.py``.  The JAX package is
single-controller: one process drives a mesh, and each host places the
row slabs of its addressable devices.  Here every row partition is one
process (a rank) under ``torch.distributed``, so a rank materializes only
its own ``rows_per_part`` rows of every node array, and every collective
of the path is explicit:

- ``all_gather_rows`` / ``all_to_all_rows``: the SpMM's exchange of
  packed operand rows (all-gather, or the halo slabs);
- ``all_reduce_sum``: gradients, mask counts and the epoch's metric
  shares.

Backends: ``nccl`` for ranks on cards (one card per rank), ``gloo`` for
ranks on the CPU, or when several ranks share one card (NCCL refuses two
ranks of one communicator on the same device).  A gloo collective on
CUDA tensors is staged here through pinned host memory: the card's
tensors are copied to the host, gloo runs on the host copies, and the
result is copied back.  The port does not rely on gloo's own handling of
CUDA tensors (a probe on the H100 read one bf16 ``all_to_all_single``
wrong that way; PERF.md).  The NCCL branch never stages.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from acmgnn_tpu_torch import resolve_device


def init_distributed(*, backend: str | None = None, device=None,
                     init_method: str | None = None, store=None,
                     rank: int | None = None,
                     world_size: int | None = None) -> bool:
    """Join the process group of a sharded run.

    With no arguments it reads ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (``init_method="env://"``) and returns
    False, joining nothing, when they are absent (a single-process run).
    Otherwise pass ``rank``, ``world_size`` and either an ``init_method``
    (``tcp://host:port``, ``file://path``) or a ``store``.

    ``backend`` defaults to ``nccl`` on the card (``device``, the card
    unless asked otherwise; this rank's card is ``LOCAL_RANK`` or ``rank``
    modulo the card count) and ``gloo`` on the CPU.  ``gloo`` may be asked
    for on the card, for several ranks on one card.  Asking for the card
    where there is none raises.
    """
    env = os.environ
    explicit = (rank is not None or world_size is not None
                or init_method is not None or store is not None)
    if not explicit and not ("RANK" in env and "WORLD_SIZE" in env):
        return False
    rank = int(env["RANK"]) if rank is None else int(rank)
    world_size = (int(env["WORLD_SIZE"]) if world_size is None
                  else int(world_size))
    if store is None and init_method is None:
        init_method = "env://"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs ranks on cards")
        index = dev.index
        if index is None:
            index = int(env.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size)
    return True


def local_node_slab(arr: np.ndarray, boundaries, rows_per_part: int,
                    rank: int, dtype=None) -> np.ndarray:
    """This rank's ``[rows_per_part, ...]`` slab of the node array ``arr``
    (its rows ``boundaries[rank]:boundaries[rank + 1]``), zero padded."""
    arr = np.asarray(arr)
    r0, r1 = int(boundaries[rank]), int(boundaries[rank + 1])
    block = np.zeros((rows_per_part,) + arr.shape[1:],
                     dtype=arr.dtype if dtype is None else dtype)
    block[: r1 - r0] = arr[r0:r1]
    return block


def _staged(t: torch.Tensor, group) -> bool:
    """A gloo collective on a CUDA tensor: run it on a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(t: torch.Tensor, fill: bool = True) -> torch.Tensor:
    """A pinned host tensor shaped like ``t`` (holding ``t``'s values
    when ``fill``; the copy waits for the card)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if fill:
        host.copy_(t)
    return host


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the group's ranks; returns ``t``."""
    if _staged(t, group):
        host = _pinned(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_rows(out: torch.Tensor, own: torch.Tensor, group=None) -> None:
    """``out[q * rows:(q + 1) * rows] = own`` of rank q, for every q."""
    if _staged(out, group):
        host = _pinned(out, fill=False)
        dist.all_gather_into_tensor(host, _pinned(own), group=group)
        out.copy_(host)
    else:
        dist.all_gather_into_tensor(out, own, group=group)


def all_to_all_rows(out: torch.Tensor, send: torch.Tensor,
                    group=None) -> None:
    """Equal split along rows: slot q of ``send`` goes to rank q, and slot
    q of ``out`` (a contiguous view, written in place) receives what rank
    q sent."""
    if _staged(out, group):
        host = _pinned(out, fill=False)
        dist.all_to_all_single(host, _pinned(send), group=group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, send, group=group)
