"""Training harness — counterpart of ``acmgnn_tpu/train/trainer.py``.

Ported so far: ``make_split_runner``'s two loops with torch-style Adam
(coupled L2), the NLL or BCE loss, accuracy or ROC-AUC, best-val
selection and the early-stopping window:

- ``run_joint``, where epoch k's dropout train forward and epoch k-1's
  eval forward share one paired pass and every sparse gather;
- ``run``, the sequential loop: a train step, then a separate eval
  forward;

and the sharded path, ``prepare_sharded_data`` and
``run_experiment_sharded``: the graph row-partitioned over the ranks of
a process group, the same runner with global losses and metrics and
all-reduced gradients.

The JAX package fuses the whole split into one ``lax.while_loop``; here
it is a plain Python epoch loop whose selection state stays on the device
(``torch.where``), so no epoch waits for the host, except that with early
stopping on the host reads the stop flag once per epoch after the window
is full.  The model's parameters are trained in place.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.data.registry import row_normalize_features
from acmgnn_tpu_torch.data.splits import random_disassortative_splits
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops.graph import (
    GraphData,
    Operators,
    permute_graph,
    precompute_operators,
)
from acmgnn_tpu_torch.ops.spmm import spmm
from acmgnn_tpu_torch.parallel.multihost import all_reduce_sum
from acmgnn_tpu_torch.parallel.partition import (
    degree_balanced_partition,
    fennel_partition,
    partition_to_perm,
)
from acmgnn_tpu_torch.parallel.sharded import (
    make_sharded_operators,
    shard_node_array,
)
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.metrics import (
    masked_accuracy,
    masked_bce_with_logits,
    masked_correct,
    masked_nll,
    masked_rocauc_multi,
    pack_labels_and_masks,
)

JOINT_CAPABLE = ("acmgcn", "acmgcnp", "acmgcnpp")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Torch Adam with coupled L2, which is optax's
    ``add_decayed_weights -> scale_by_adam -> scale(-lr)``: L2 folded into
    the gradient before the moments."""
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not "
                                  "ported yet")
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def build_model(cfg: TrainConfig, nfeat: int, nclass: int, *, device=None,
                seed: int = 0) -> ACMGNN:
    """The model of ``cfg`` on ``device`` (the card unless asked
    otherwise), initialised from ``seed``."""
    return ACMGNN(
        nfeat, cfg.hidden, nclass,
        model_type=cfg.model_type,
        dropout=cfg.dropout,
        variant=cfg.variant,
        structure_info=cfg.structure_info,
        use_layernorm=cfg.resolve_layernorm(),
        hoist_first=cfg.resolve_hoist(),
        gemm_dtype=None if cfg.gemm_dtype == "float32" else cfg.gemm_dtype,
        seed=seed,
    ).to(resolve_device(device))


@dataclasses.dataclass
class SplitResult:
    test_metric: torch.Tensor
    val_metric: torch.Tensor
    val_loss: torch.Tensor
    train_loss: torch.Tensor
    epochs_run: int


@dataclasses.dataclass
class SplitState:
    """The loop's end state besides its ``SplitResult``."""

    epoch: int                     # bodies run (joint: epochs + 1 unstopped)
    train_losses: torch.Tensor     # every body's train loss
    optimizer: torch.optim.Optimizer


def make_split_runner(model: ACMGNN, cfg: TrainConfig, joint=None,
                      group=None):
    """``run(ops, x, labels, masks, seed=0, return_state=False,
    labels_onehot=None)`` — one split's training from the model's current
    parameters (the joint loop for joint-capable models when
    ``cfg.joint``, else the sequential one).  ``labels_onehot`` is the BCE
    target, ``prepare_data``'s ``labels_onehot``.

    ``group``: the process group of a sharded run, whose ranks each pass
    their slabs of the node arrays and their share of a sharded operator
    (``prepare_sharded_data``).  Losses and accuracies are then global:
    each rank's loss is its masked sum over the all-reduced mask count,
    and one all-reduce per epoch sums the loss shares and the correct
    counts.  The gradients are all-reduced (summed) in one flat buffer
    before the optimizer step, so the replicas stay equal, and every rank
    reads the same stop flag.  Dropout draws from a generator seeded by
    ``(seed, rank)``."""
    if cfg.loss not in ("nll", "bce"):
        raise ValueError(f"unknown loss {cfg.loss!r}")
    if cfg.metric not in ("acc", "rocauc"):
        raise ValueError(f"unknown metric {cfg.metric!r}")
    use_bce = cfg.loss == "bce"
    use_rocauc = cfg.metric == "rocauc"
    epochs = int(cfg.epochs)
    es = int(cfg.early_stopping)
    if es >= epochs:   # the stop rule could never fire (JAX: disabled)
        es = 0
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet")
    if joint is None:
        joint = bool(cfg.joint) and cfg.model_type in JOINT_CAPABLE
    sel_metric = cfg.selection == "val_metric"
    if group is not None and use_rocauc:
        raise NotImplementedError("ROC-AUC on the sharded path is not "
                                  "ported yet (ROADMAP.md)")
    params = list(model.parameters())

    def loss_of(logits, labels, labels_onehot, mask, count=None):
        if use_bce:
            return masked_bce_with_logits(logits, labels_onehot, mask, count)
        return masked_nll(torch.log_softmax(logits, dim=1), labels, mask,
                          count)

    def metrics_from_logits(logits, labels, labels_onehot, masks, packed,
                            counts, loss):
        """``((val_loss, val_metric, test_metric), train_loss)``, global
        over the ranks when sharded (``counts``: the all-reduced mask
        counts; ``loss``: this rank's train-loss share)."""
        _, val_mask, test_mask = masks
        if counts is not None:
            shares = torch.stack([
                loss.detach(),
                loss_of(logits, labels, labels_onehot, val_mask, counts[1]),
                masked_correct(logits, labels, val_mask).float(),
                masked_correct(logits, labels, test_mask).float()])
            all_reduce_sum(shares, group)
            return ((shares[1], shares[2] / counts[1], shares[3] / counts[2]),
                    shares[0])
        if use_rocauc:
            # one score sort and one rank pass serve both masks
            val_metric, test_metric = masked_rocauc_multi(
                logits, labels, (val_mask, test_mask), packed=packed)
        else:
            val_metric = masked_accuracy(logits, labels, val_mask)
            test_metric = masked_accuracy(logits, labels, test_mask)
        return ((loss_of(logits, labels, labels_onehot, val_mask), val_metric,
                 test_metric), loss.detach())

    def global_counts(masks):
        """The masks' node counts over all ranks (None unless sharded)."""
        if group is None:
            return None
        counts = torch.stack([m.sum() for m in masks]).float()
        return all_reduce_sum(counts, group).clamp_min(1)

    def step(opt, loss):
        """Backward, the sharded gradient all-reduce, the update."""
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            all_reduce_sum(flat, group)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad = g.view_as(p)
        opt.step()

    def generator(dev, seed):
        if group is not None:
            seed = seed * dist.get_world_size(group) + dist.get_rank(group)
        return torch.Generator(device=dev).manual_seed(seed)

    def packed_words(labels, masks, labels_onehot):
        """The rank pass's packed label/mask words (val and test masks),
        fixed for the split."""
        if use_bce and labels_onehot is None:
            raise ValueError("the BCE loss needs labels_onehot "
                             "(prepare_data's)")
        return (pack_labels_and_masks(labels, masks[1:]) if use_rocauc
                else None)

    def select(best, evals):
        """Best (val_loss, val_metric, test_metric) after one evaluation;
        a NaN metric never improves, as under JAX's ``>``."""
        val_loss, val_metric, _ = evals
        improved = (val_metric > best[1] if sel_metric
                    else val_loss < best[0])
        return tuple(torch.where(improved, new, old)
                     for new, old in zip(evals, best))

    def stop_flag(val_hist, e: int, val_loss):
        """The early-stopping rule for epoch ``e``: val_loss above the
        mean of the ``es`` epochs before it (None while it cannot fire)."""
        if es == 0 or e <= es:
            return None
        return val_loss > val_hist[e - es:e].mean()

    def initial_best(dev):
        return (torch.tensor(math.inf, device=dev),
                torch.tensor(-math.inf, device=dev),
                torch.tensor(0.0, device=dev))

    def finish(best, loss, epochs_run, bodies, losses, opt, return_state):
        result = SplitResult(
            test_metric=best[2], val_metric=best[1], val_loss=best[0],
            train_loss=loss, epochs_run=epochs_run)
        if return_state:
            return result, SplitState(
                epoch=bodies, optimizer=opt,
                train_losses=(torch.stack(losses) if losses
                              else torch.zeros(0)))
        return result

    def run(ops, x, labels, masks, seed: int = 0,
            return_state: bool = False, labels_onehot=None):
        """Sequential loop: each epoch trains, then evaluates the updated
        parameters in a separate forward; stops after ``epochs`` or when
        the early-stopping rule fires (that epoch counts)."""
        dev = x.device
        gen = generator(dev, seed)
        opt = make_optimizer(cfg, params)
        packed = packed_words(labels, masks, labels_onehot)
        counts = global_counts(masks)
        best = initial_best(dev)
        val_hist = torch.zeros(max(epochs, 1), device=dev)
        loss = torch.tensor(0.0, device=dev)
        losses = []
        epoch = 0
        while epoch < epochs:
            logits = model(x, ops, training=True, generator=gen)
            loss = loss_of(logits, labels, labels_onehot, masks[0],
                           None if counts is None else counts[0])
            step(opt, loss)
            with torch.no_grad():
                evals, loss = metrics_from_logits(
                    model(x, ops, training=False), labels, labels_onehot,
                    masks, packed, counts, loss)
                losses.append(loss)
                best = select(best, evals)
                val_hist[epoch] = evals[0]
                stop = stop_flag(val_hist, epoch, evals[0])
            epoch += 1
            if stop is not None and bool(stop):   # host reads the flag
                break
        return finish(best, loss, epoch, epoch, losses, opt, return_state)

    def run_joint(ops, x, labels, masks, seed: int = 0,
                  return_state: bool = False, labels_onehot=None):
        """Iteration k evaluates epoch k-1 (parameters after k updates)
        and trains epoch k in one paired forward; ``epochs + 1``
        iterations, the first one's evaluation is skipped.  An iteration
        whose evaluation fires the early-stopping rule still applies its
        update, then the loop ends."""
        dev = x.device
        gen = generator(dev, seed)
        opt = make_optimizer(cfg, params)
        packed = packed_words(labels, masks, labels_onehot)
        counts = global_counts(masks)
        best = initial_best(dev)
        val_hist = torch.zeros(epochs + 1, device=dev)
        loss = torch.tensor(0.0, device=dev)
        losses = []
        k = 0
        while k < epochs + 1:
            logits_train, logits_eval = model(
                x, ops, training=True, paired_eval=True, generator=gen)
            loss_share = loss_of(logits_train, labels, labels_onehot,
                                 masks[0],
                                 None if counts is None else counts[0])
            stop = None
            with torch.no_grad():
                evals, loss = metrics_from_logits(
                    logits_eval, labels, labels_onehot, masks, packed,
                    counts, loss_share)
                if k > 0:   # selection and history for epoch k - 1
                    best = select(best, evals)
                    val_hist[k - 1] = evals[0]
                    stop = stop_flag(val_hist, k - 1, evals[0])
            step(opt, loss_share)
            losses.append(loss)
            k += 1
            if stop is not None and bool(stop):   # host reads the flag
                break
        return finish(best, loss, max(k - 1, 0), k, losses, opt,
                      return_state)

    return run_joint if joint else run


def prepare_data(dataset: GraphData, cfg: TrainConfig, device=None):
    """Preprocess a graph into device tensors and operators:
    ``(data, ops, x, labels, labels_onehot, nclass)``."""
    dev = resolve_device(device)
    if not isinstance(dataset, GraphData):
        raise NotImplementedError("dataset loaders are not ported yet; "
                                  "pass a GraphData")
    if cfg.reorder != "none":
        raise NotImplementedError("locality reordering is not ported yet")
    if cfg.ell_block not in (0, 1):
        raise NotImplementedError("block-column ELL is a TPU layout")
    if cfg.feature_dtype != "float32":
        raise NotImplementedError("bf16 feature storage is not ported yet")
    data = dataset
    features = data.features
    if cfg.resolve_feature_normalize():
        features = row_normalize_features(features)
    ops = precompute_operators(
        data.adj, normalization=cfg.normalization, fmt=cfg.operator_format,
        spmm_dtype=_DTYPES[cfg.spmm_dtype],
    ).to(dev)
    labels = _host_labels(data.labels)
    nclass = data.num_classes
    labels_onehot = _one_hot(labels, nclass)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    y = torch.from_numpy(labels.astype(np.int64)).to(dev)
    y1h = torch.from_numpy(labels_onehot).to(dev)
    if cfg.resolve_hoist():
        # Â X once, through the same gather as the model's (the eval
        # forward's layer-1 aggregate; exact for training at dropout 0)
        agg = spmm(ops.adj_low, x)
        agg_dtype = cfg.resolve_hoist_agg_dtype(*x.shape)
        ops.x_agg = agg if agg_dtype is None else agg.to(agg_dtype)
    return data, ops, x, y, y1h, nclass


# ---------------------------------------------------------------------------
# Sharded path: one row partition per rank (parallel/sharded.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedData:
    """A rank's view of a prepared graph: ``data`` is the whole (possibly
    partition-permuted) graph on the host, the tensors are this rank's
    zero-padded ``[rows_per_part, ...]`` slabs on its device."""

    data: GraphData
    ops: Operators
    x: torch.Tensor
    labels: torch.Tensor
    labels_onehot: torch.Tensor
    nclass: int
    boundaries: np.ndarray
    rows_per_part: int
    rank: int
    world_size: int

    def place(self, arr) -> torch.Tensor:
        """This rank's slab of a ``[N, ...]`` node array, on its device."""
        return shard_node_array(arr, self.boundaries, self.rows_per_part,
                                self.rank, self.x.device)


def _host_labels(labels):
    """``[N]`` or ``[N, C]`` host labels (a ``[N, 1]`` column squeezed)."""
    labels = np.asarray(labels)
    return labels[:, 0] if labels.ndim > 1 and labels.shape[1] == 1 \
        else labels


def _one_hot(labels: np.ndarray, nclass: int) -> np.ndarray:
    """BCE targets: one-hot rows, or ``[N, C]`` multilabel targets as
    they are."""
    if labels.ndim == 1:
        return np.eye(nclass, dtype=np.float32)[labels]
    return labels.astype(np.float32)


def _rank_and_world(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def prepare_sharded_data(dataset: GraphData, cfg: TrainConfig, *,
                         group=None, device=None,
                         exchange: str = "auto") -> ShardedData:
    """Sharded counterpart of ``prepare_data`` for this rank of ``group``
    (None: one rank, no collectives): the partition (``cfg.partition``:
    "contiguous" nnz-balanced blocks, or "fennel" / "balanced" with a
    contiguity permutation of the whole graph), this rank's share of the
    operator (``exchange``: "allgather", "halo" or "auto"), its slabs of
    the features, labels and one-hot labels, and the hoisted ``Â X``
    through the sharded operator."""
    dev = resolve_device(device)
    rank, world = _rank_and_world(group)
    if not isinstance(dataset, GraphData):
        raise NotImplementedError("dataset loaders are not ported yet; "
                                  "pass a GraphData")
    if cfg.reorder != "none":
        raise NotImplementedError("locality reordering is not ported yet")
    if cfg.feature_dtype != "float32":
        raise NotImplementedError("bf16 feature storage is not ported yet")
    data = dataset
    boundaries = None
    if cfg.partition in ("fennel", "balanced"):
        part = (fennel_partition(data.adj, world) if cfg.partition == "fennel"
                else degree_balanced_partition(data.adj, world))
        perm, boundaries = partition_to_perm(part, world)
        data = dataclasses.replace(
            data, adj=permute_graph(data.adj, perm),
            features=np.asarray(data.features)[perm],
            labels=np.asarray(data.labels)[perm])
    elif cfg.partition != "contiguous":
        raise ValueError(f"unknown partition {cfg.partition!r}")
    features = data.features
    if cfg.resolve_feature_normalize():
        features = row_normalize_features(features)
    ops, boundaries, rpp = make_sharded_operators(
        data.adj, world, rank, normalization=cfg.normalization,
        fmt="coo" if cfg.operator_format == "coo" else "ell",
        exchange=exchange, boundaries=boundaries,
        spmm_dtype=_DTYPES[cfg.spmm_dtype])
    ops.adj_low.group = group
    ops = ops.to(dev)

    def place(arr):
        return shard_node_array(arr, boundaries, rpp, rank, dev)

    labels = _host_labels(data.labels)
    x = place(np.asarray(features, np.float32))
    if cfg.resolve_hoist():
        # Â X once, through the sharded operator (lands row-partitioned)
        agg = spmm(ops.adj_low, x)
        agg_dtype = cfg.resolve_hoist_agg_dtype(world * rpp, x.shape[1])
        ops.x_agg = agg if agg_dtype is None else agg.to(agg_dtype)
    return ShardedData(
        data=data, ops=ops, x=x, labels=place(labels.astype(np.int64)),
        labels_onehot=place(_one_hot(labels, data.num_classes)),
        nclass=data.num_classes, boundaries=boundaries, rows_per_part=rpp,
        rank=rank, world_size=world)


def resolve_split(cfg: TrainConfig, rng, labels, nclass: int):
    """One (train, val, test) bool-mask triple: the random disassortative
    60/20/20 split drawn from ``rng`` (the JAX package's
    ``resolve_split`` without its file-based splits, which wait for the
    data layer)."""
    if cfg.fixed_splits:
        raise NotImplementedError("file-based splits wait for the data "
                                  "layer; use random splits")
    return random_disassortative_splits(np.asarray(labels), nclass, rng=rng)


def run_experiment_sharded(dataset: GraphData, cfg: TrainConfig, *,
                           device=None, exchange: str = "auto",
                           checkpoint_dir=None, return_model: bool = False):
    """Multi-split full-batch training with the graph row-partitioned
    over the ranks of the default process group (``init_distributed``;
    without one, a single rank): the counterpart of the JAX package's
    ``run_experiment_sharded``, for random splits.

    Every rank calls it with the same arguments.  Split ``idx`` draws its
    masks from ``numpy.random.default_rng(cfg.seed)`` (the JAX package's
    random disassortative splits) and starts from ``build_model(...,
    seed=cfg.seed + idx)`` on every rank, so the replicas start equal;
    ``make_split_runner`` keeps them equal.  Returns the JAX package's
    result dict (``devices`` is the world size); with ``return_model``
    also the last split's model, ``(result, model)``.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpointing is not ported yet")
    group = dist.group.WORLD if dist.is_initialized() else None
    prep = prepare_sharded_data(dataset, cfg, group=group, device=device,
                                exchange=exchange)
    masks_rng = np.random.default_rng(cfg.seed)
    labels_np = _host_labels(prep.data.labels)
    results = []
    t_total = time.time()
    epochs_total = 0
    steady_time = 0.0
    steady_epochs = 0
    model = None
    for idx in range(cfg.num_splits):
        masks = tuple(prep.place(m) for m in resolve_split(
            cfg, masks_rng, labels_np, prep.nclass))
        model = build_model(cfg, prep.x.shape[1], prep.nclass,
                            device=prep.x.device, seed=cfg.seed + idx)
        t_split = time.time()
        res = make_split_runner(model, cfg, group=group)(
            prep.ops, prep.x, prep.labels, masks, seed=cfg.seed + idx,
            labels_onehot=prep.labels_onehot)
        if prep.x.device.type == "cuda":
            torch.cuda.synchronize()
        results.append(res)
        epochs_total += int(res.epochs_run)
        if idx > 0:   # split 0 pays the warm-up; excluded from the rate
            steady_time += time.time() - t_split
            steady_epochs += int(res.epochs_run)
    elapsed = time.time() - t_total
    test = np.array([float(r.test_metric) for r in results])
    out = {
        "dataset": prep.data.name,
        "model": cfg.model_type,
        "devices": prep.world_size,
        "test_mean": float(test.mean()),
        "test_std": float(test.std()),
        "per_split": test.tolist(),
        "epochs_total": epochs_total,
        "runtime_s": elapsed,
        "epoch_ms_avg": 1000.0 * elapsed / max(epochs_total, 1),
        "epoch_ms_steady": (1000.0 * steady_time / steady_epochs
                            if steady_epochs else None),
    }
    return (out, model) if return_model else out
