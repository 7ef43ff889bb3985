"""Process groups, per-rank node data and the collectives of the sharded path.

Counterpart of ``acmgnn_tpu/parallel/multihost.py``.  The JAX package is
single-controller: one process drives a mesh, and each host places the
row slabs of its addressable devices.  Here every row partition is one
process (a rank) under ``torch.distributed``, so a rank materializes only
its own ``rows_per_part`` rows of every node array, and every collective
of the path is explicit:

- ``all_gather_rows`` / ``all_to_all_rows``: the SpMM's exchange of
  packed operand rows (all-gather, or the halo slabs); ``gather_rows``:
  every rank's slab of the logits and of the split's packed label/mask
  words, for a ROC-AUC over all nodes;
- ``all_reduce_sum``: mask counts, and the gradients with the epoch's
  metric shares behind them; ``sum_over_ranks``, its autograd form: the
  BatchNorm statistics of acmgcnpp's skip MLP, forward and backward.

Per-rank loading (``rank_rows``, ``shard_node_array_per_host``): a rank
reads only its own row range of a node array through a loader, the
counterpart of the JAX package's per-host loading, and the one way the
port places a node array.

Backends: ``nccl`` for ranks on cards (one card per rank), ``gloo`` for
ranks on the CPU, or when several ranks share one card (NCCL refuses two
ranks of one communicator on the same device).  A gloo collective on
CUDA tensors is staged here through pinned host memory: the card's
tensors are copied to the host, gloo runs on the host copies, and the
result is copied back.  The port does not rely on gloo's own handling of
CUDA tensors (a probe on the H100 read one bf16 ``all_to_all_single``
wrong that way; PERF.md).  The NCCL branch never stages: it issues the
collective on the card from the current stream, reads nothing back and
waits on no host event, so it may be recorded inside a CUDA-graph
capture (``capture_safe``), and the split runner captures a sharded body
on NCCL as it does one card's.  A gloo collective cannot be captured:
issued during a capture it raises.
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


def rank_rows(boundaries, rank: int) -> tuple:
    """``(r0, r1)``: the node rows this rank owns.  The counterpart of the
    JAX package's ``host_local_rows``, whose list holds one such range
    (with its partition and offset) per partition a host owns: here a
    rank owns one."""
    return int(boundaries[rank]), int(boundaries[rank + 1])


def shard_node_array_per_host(loader, boundaries, rows_per_part: int,
                              rank: int, dtype, trailing_shape=(),
                              device=None) -> torch.Tensor:
    """This rank's zero-padded ``[rows_per_part, *trailing_shape]`` slab of
    a node array, read through ``loader(r0, r1)``, called once with this
    rank's rows (``rank_rows``; a rank that owns none calls nothing).
    Every node array of the sharded path is placed through it: the loader
    may read just those rows from a file or a memory map, or slice an
    array in memory (``parallel.sharded.shard_node_array``)."""
    r0, r1 = rank_rows(boundaries, rank)
    block = np.zeros((rows_per_part,) + tuple(trailing_shape), dtype=dtype)
    if r1 > r0:
        block[: r1 - r0] = loader(r0, r1)
    return torch.from_numpy(block).to(device)


_issued = 0   # collectives this process has issued through this module


def _issue() -> None:
    global _issued
    _issued += 1


def failure_vote(group=None):
    """An ``agree`` hook for ``utils.resilience.retry_transient`` on every
    rank of ``group``: after each attempt the ranks all-reduce, over a
    gloo group of their own (so that the vote cannot be matched with a
    collective a peer still waits in), whether the attempt failed,
    whether the failure is transient, and how many collectives of this
    module each rank had issued.  The attempt is retried only when every
    rank failed transiently at the same count, that is in the same
    collective or between the same two, so that every rank restarts from
    the same point of the group's sequence; if any rank failed otherwise,
    all of them raise.  A rank whose peer failed alone still waits in its
    pending collective until that fails or times out, then votes."""
    from acmgnn_tpu_torch.utils.resilience import is_transient

    vote_group = dist.new_group(backend="gloo")

    def agree(exc) -> str:
        failed = int(exc is not None)
        flags = torch.tensor([failed, -failed,
                              int(failed and is_transient(exc)),
                              _issued, -_issued], dtype=torch.int64)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=vote_group)
        every, neg_any, transient, lo, neg_hi = flags.tolist()
        if not -neg_any:
            return "done"
        return "retry" if every and transient and lo == -neg_hi else "raise"
    return agree


def capture_safe(group=None) -> bool:
    """Whether the collectives of ``group`` may be recorded in a CUDA
    graph: NCCL's run on the card from the current stream; gloo's run on
    the host (on CUDA tensors, over host copies)."""
    return dist.get_backend(group) == "nccl"


def _staged(t: torch.Tensor, group) -> bool:
    """A gloo collective on a CUDA tensor: run it on a host copy (never
    inside a capture, which would record the copies and not gloo)."""
    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return False
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a gloo collective cannot be captured in a CUDA "
                           "graph (its sum runs on the host)")
    return True


def _pinned(t: torch.Tensor, fill: bool = True) -> torch.Tensor:
    """A pinned host tensor shaped like ``t`` (holding ``t``'s values
    when ``fill``; the copy waits for the card)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if fill:
        host.copy_(t)
    return host


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the group's ranks; returns ``t``."""
    _issue()
    if _staged(t, group):
        host = _pinned(t)
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t.clone(memory_format=torch.contiguous_format),
                              group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(
            grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, as a new tensor that
    autograd differentiates: the backward sums the incoming gradients
    over the ranks, since every rank's loss reads the sum.  One
    collective in the forward, one in the backward."""
    return _SumOverRanks.apply(t, group)


def all_gather_rows(out: torch.Tensor, own: torch.Tensor, group=None) -> None:
    """``out[q * rows:(q + 1) * rows] = own`` of rank q, for every q."""
    _issue()
    if _staged(out, group):
        host = _pinned(out, fill=False)
        dist.all_gather_into_tensor(host, _pinned(own), group=group)
        out.copy_(host)
    else:
        dist.all_gather_into_tensor(out, own, group=group)


def gather_rows(own: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``own`` (``[rows, ...]``, the same shape on each),
    stacked in rank order: ``[world · rows, ...]``."""
    world = dist.get_world_size(group)
    out = own.new_empty((world * own.shape[0],) + tuple(own.shape[1:]))
    all_gather_rows(out, own.contiguous(), group)
    return out


def all_to_all_rows(out: torch.Tensor, send: torch.Tensor,
                    group=None) -> None:
    """Equal split along rows: slot q of ``send`` goes to rank q, and slot
    q of ``out`` (a contiguous view, written in place) receives what rank
    q sent."""
    _issue()
    if _staged(out, group):
        host = _pinned(out, fill=False)
        dist.all_to_all_single(host, _pinned(send), group=group)
        out.copy_(host)
    else:
        dist.all_to_all_single(out, send, group=group)
