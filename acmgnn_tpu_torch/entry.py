"""Driver entry points of the port: the counterpart of ``__graft_entry__.py``.

- ``entry(device=None)``: ``(forward, args)`` of the flagship model's
  eval forward, ACM-GCN+ over a bf16 ELL operator of a 4,096-node graph
  (K1 and K2 on the card);
- ``dryrun(n, device=None)``: one explicit full training step (loss,
  gradients, Adam) with the graph row-partitioned over ``n`` ranks on tiny
  shapes, then ``run_experiment_sharded`` on a mini-split with the
  headline's configuration, as JAX's ``dryrun_multichip(n)`` runs them.

On the card ``dryrun(1)`` is one rank over NCCL in this process (its
mini-split captured, as every NCCL run is); ``n > 1`` spawns ``n`` gloo
ranks on the one card (NCCL refuses two ranks of one communicator on one
device), and on the CPU every ``n`` spawns ``n`` gloo ranks.  Run both as
the JAX file's ``__main__`` does::

    python -m acmgnn_tpu_torch.entry                  # the card
    python -m acmgnn_tpu_torch.entry --device cpu     # gloo ranks on the CPU
    python -m acmgnn_tpu_torch.entry --ranks 4        # 4 gloo ranks
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import socket
import tempfile
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops.dropout import DropoutKey
from acmgnn_tpu_torch.ops.graph import GraphData, precompute_operators
from acmgnn_tpu_torch.parallel.multihost import all_reduce_sum, init_distributed
from acmgnn_tpu_torch.parallel.sharded import (
    make_sharded_operators,
    shard_node_array,
)
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.metrics import masked_nll
from acmgnn_tpu_torch.train.trainer import (
    make_optimizer,
    run_experiment_sharded,
)

# entry(): __graft_entry__.py:36-38
ENTRY_SHAPE = dict(n=4096, avg_degree=16, nfeat=128, nhid=64, nclass=8)
# dryrun(n): __graft_entry__.py:83-84, 64 nodes a rank
DRYRUN_SHAPE = dict(rows_per_rank=64, avg_degree=8, nfeat=32, nhid=16,
                    nclass=4)
DRYRUN_LR = 1e-2
DRYRUN_DROPOUT = 0.1
RANK_DEADLINE_S = 600


def synthetic_graph(n: int, avg_degree: int, nfeat: int, nclass: int,
                    seed: int = 0):
    """``(adj, features, labels)``: ``__graft_entry__.py``'s
    ``_synthetic_graph``, drawn in its order: ``n·avg_degree/2`` uniform
    pairs (self-pairs kept) symmetrized into a binary CSR, normal
    features, uniform labels."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree // 2
    src = rng.integers(0, n, size=e)
    dst = rng.integers(0, n, size=e)
    a = sp.coo_matrix((np.ones(e), (src, dst)), shape=(n, n))
    adj = ((a + a.T) > 0).astype(np.float64).tocsr()
    features = rng.normal(size=(n, nfeat)).astype(np.float32)
    labels = rng.integers(0, nclass, size=n).astype(np.int32)
    return adj, features, labels


def forward(model: ACMGNN, x: torch.Tensor, ops) -> torch.Tensor:
    """The eval forward ``entry`` returns (JAX's ``model.apply``)."""
    return model(x, ops)


def entry(device=None):
    """``(forward, (model, x, ops))``: ACM-GCN+ (hidden 64, dropout 0, the
    JAX model's defaults otherwise: no LayerNorm, no hoist) on
    ``synthetic_graph(4096, 16, 128, 8)`` with an ELL operator whose
    gathers run in bf16 (the production format, as the JAX entry builds
    it; the graph keeps its self-pairs, so A + I is not row-uniform and
    the halves carry values), on the card unless asked otherwise.  The
    model's parameters come from ``seed=0``; load a flax tree's with
    ``models.convert.params_from_flax``."""
    dev = resolve_device(device)
    s = ENTRY_SHAPE
    adj, features, _ = synthetic_graph(s["n"], s["avg_degree"], s["nfeat"],
                                       s["nclass"])
    ops = precompute_operators(adj, fmt="ell",
                               spmm_dtype=torch.bfloat16).to(dev)
    x = torch.from_numpy(features).to(dev)
    model = ACMGNN(s["nfeat"], s["nhid"], s["nclass"], model_type="acmgcnp",
                   dropout=0.0, seed=0).to(dev)
    return forward, (model, x, ops)


def dryrun_graph(n_ranks: int):
    """The dryrun's graph: ``synthetic_graph(64·n, 8, 32, 4)``."""
    s = DRYRUN_SHAPE
    return synthetic_graph(s["rows_per_rank"] * n_ranks, s["avg_degree"],
                           s["nfeat"], s["nclass"])


def dryrun_model(nnodes: int, dropout: float, device,
                 init_params: Optional[dict] = None) -> ACMGNN:
    """ACM-GCN+ with the structure channel (hidden 16, 4 classes; the JAX
    model's defaults otherwise) for a graph of ``nnodes`` nodes, from
    ``init_params`` (a ``state_dict``) or ``seed=0``."""
    s = DRYRUN_SHAPE
    model = ACMGNN(s["nfeat"], s["nhid"], s["nclass"], model_type="acmgcnp",
                   structure_info=True, nnodes=nnodes, dropout=dropout,
                   seed=0)
    if init_params is not None:
        model.load_state_dict(init_params)
    return model.to(device)


def dryrun_step(model: ACMGNN, ops, x: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, *, rank: int = 0, group=None) -> float:
    """One full training step, JAX's ``train_step``: the dropout train
    forward (key seed 1, epoch 0), the masked NLL over every rank's masked
    nodes, its gradients summed over the ranks in one all-reduce (the
    loss's share behind them), and one Adam step at lr 1e-2 without decay
    (``make_optimizer``).  ``group`` None: one card, no collective.
    Returns the loss."""
    params = list(model.parameters())
    opt = make_optimizer(TrainConfig(lr=DRYRUN_LR, weight_decay=0.0), params)
    count = None
    if group is not None:
        count = all_reduce_sum(mask.sum().float().reshape(1), group)[0]
    key = DropoutKey.new(1, rank, torch.zeros((), dtype=torch.int64,
                                              device=x.device))
    logits = model(x, ops, training=True, key=key)
    loss = masked_nll(torch.log_softmax(logits, dim=1), labels, mask, count)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None:
        flat = all_reduce_sum(torch.cat(
            [p.grad.reshape(-1) for p in params] + [loss.detach()[None]]),
            group)
        *grads, loss = flat.split([p.numel() for p in params] + [1])
        for p, g in zip(params, grads):
            p.grad = g.view_as(p)
    opt.step()
    return float(loss.detach())


def mini_split_config(dropout: float = DRYRUN_DROPOUT) -> TrainConfig:
    """``__graft_entry__.py:144-166``'s mini-split: acmgcnp, hidden 16, 3
    epochs, 1 split, the joint loop, the hoist, bf16 gathers.

    ``ell_hub_threshold=6`` is JAX's, so that this small graph builds its
    dense hub blocks; the port has none (the field is a TPU layout knob
    and changes nothing here): K1 gives every row above ``K1_HUB_DEGREE``
    a block of its own (``ops/ell.py`` ``k1_lanes``), which covers those
    rows, and no row of this graph is that deep."""
    return TrainConfig(
        model_type="acmgcnp", hidden=DRYRUN_SHAPE["nhid"], epochs=3,
        early_stopping=0, num_splits=1, dropout=dropout, joint=True,
        hoist_first=True, spmm_dtype="bfloat16", ell_hub_threshold=6)


def _run_rank(rank: int, world: int, dev: torch.device, dropout: float,
              init_params: Optional[dict]) -> dict:
    """The dryrun on this rank of the default process group."""
    group = dist.group.WORLD
    adj, features, labels = dryrun_graph(world)
    n = adj.shape[0]
    # JAX's pad_multiple=64 pads each part's nonzeros for the TPU; the
    # port's local halves keep their own nonzero counts
    ops, bnd, rpp = make_sharded_operators(
        adj, world, rank, structure_info=True, exchange="halo")
    for op in (ops.adj_low, ops.adj_unnorm):
        op.group = group
    ops = ops.to(dev)

    def place(arr):
        return shard_node_array(arr, bnd, rpp, rank, dev)

    model = dryrun_model(n, dropout, dev, init_params)
    loss = dryrun_step(model, ops, place(features),
                       place(labels.astype(np.int64)), place(np.ones(n, bool)),
                       rank=rank, group=group)
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun({world}): non-finite loss {loss}")
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    data = GraphData(name="dryrun", adj=adj, features=features,
                     labels=labels)
    out = run_experiment_sharded(data, mini_split_config(dropout),
                                 device=dev, exchange="halo")
    if not math.isfinite(out["test_mean"]):
        raise RuntimeError(f"dryrun({world}): non-finite mini-split "
                           f"result {out}")
    return dict(loss=loss, params=params, mini_split=out)


def _spawned_rank(rank: int, world: int, store: str, device: str,
                  dropout: float, init_params: Optional[dict],
                  out_dir: str) -> None:
    """One spawned gloo rank: joins the group over the file ``store``,
    runs the dryrun and saves what it returns to ``out_dir``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)   # the ranks share the host's cores
    init_distributed(backend="gloo", device=dev, init_method=f"file://{store}",
                     rank=rank, world_size=world)
    try:
        torch.save(_run_rank(rank, world, dev, dropout, init_params),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(world: int, device: str, dropout: float,
           init_params: Optional[dict]) -> list:
    """Every rank's dryrun, each a spawned process; raises if a rank
    fails or all do not finish within ``RANK_DEADLINE_S``."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="acm_dryrun_")
    try:
        ctx = mp.start_processes(
            _spawned_rank, args=(world, f"{tmp}/store", device, dropout,
                                 init_params, tmp),
            nprocs=world, join=False, start_method="spawn")
        t0 = time.perf_counter()
        try:
            while not ctx.join(timeout=1):
                if time.perf_counter() - t0 > RANK_DEADLINE_S:
                    raise TimeoutError(f"dryrun({world}): the ranks did not "
                                       f"finish in {RANK_DEADLINE_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun(n: int, device=None, *, dropout: float = DRYRUN_DROPOUT,
           init_params: Optional[dict] = None) -> dict:
    """``__graft_entry__.py``'s ``dryrun_multichip(n)`` on the port: the
    graph row-partitioned over ``n`` ranks (halo exchange, ELL, the
    structure channel), one explicit training step (``dryrun_step``) from
    ``init_params`` or ``seed=0``'s, then ``run_experiment_sharded`` on
    ``mini_split_config``.  On the card (the default) ``n = 1`` is one
    NCCL rank in this process, captured; otherwise ``n`` spawned gloo
    ranks, on the card or the CPU (``device="cpu"``).  The ranks must end
    the step with equal parameters (the replicas), else it raises.

    Returns rank 0's ``loss``, ``params`` (the ``state_dict`` after the
    step, on the host) and ``mini_split`` (the run's result dict), with
    ``world_size`` and ``backend``.  Prints the counterparts of JAX's two
    lines."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"dryrun needs at least one rank, got {n}")
    if dev.type == "cuda" and n == 1:
        if dist.is_initialized():
            raise RuntimeError("dryrun(1) joins a process group of its own; "
                               "one is already initialized")
        backend = "nccl"
        init_distributed(backend=backend, device=dev,
                         init_method=f"tcp://localhost:{_free_port()}",
                         rank=0, world_size=1)
        try:
            ranks = [_run_rank(0, 1, torch.device("cuda",
                                                  torch.cuda.current_device()),
                               dropout, init_params)]
        finally:
            dist.destroy_process_group()
    else:
        backend = "gloo"
        ranks = _spawn(n, str(dev), dropout, init_params)
    for r, res in enumerate(ranks[1:], 1):
        for name, p in res["params"].items():
            if not torch.equal(p, ranks[0]["params"][name]):
                raise RuntimeError(f"dryrun({n}): rank {r}'s {name} differs "
                                   f"from rank 0's after the step")
    out = dict(ranks[0], world_size=n, backend=backend)
    print(f"dryrun({n}): one sharded train step OK ({backend}, {dev.type}), "
          f"loss={out['loss']:.4f}")
    print(f"dryrun({n}): sharded joint mini-split OK, "
          f"test={out['mini_split']['test_mean']:.3f}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's entry forward, then its dryrun "
                    "(__graft_entry__.py's __main__).")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--ranks", type=int, default=None,
                        help="dryrun ranks (default: min(8, cards) on the "
                             "card, 1 on the CPU)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fargs = entry(dev)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry forward:", tuple(out.shape))
    ranks = args.ranks
    if ranks is None:
        ranks = min(8, torch.cuda.device_count()) if dev.type == "cuda" else 1
    dryrun(ranks, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
