"""Training harness — counterpart of ``acmgnn_tpu/train/trainer.py``.

Ported: ``make_split_runner``'s two loops with torch-style Adam (coupled
L2) or AdamW, the NLL or BCE loss, accuracy or ROC-AUC, best-val
selection, the early-stopping window and ``remat``:

- ``run_joint``, where epoch k's dropout train forward and epoch k-1's
  eval forward share one paired pass and every sparse gather;
- ``run``, the sequential loop: a train step, then a separate eval
  forward (every model type outside ``JOINT_CAPABLE``);

``build_model`` for the twelve model types, the single-card entry points
``run_experiment`` (multi-split, the fast path), ``train_single_split``
and ``run_experiment_stepwise`` (one epoch at a time with ``RunStats``,
checkpointing and bit-exact resume), ``prepare_data`` (a ``GraphData`` or
a dataset name, through ``data.registry.load_dataset``) with
``maybe_reorder`` and bf16 feature storage; and the sharded path,
``prepare_sharded_data`` and ``run_experiment_sharded``: the graph
row-partitioned over the ranks of a process group, the same runner with
global losses and metrics (ROC-AUC over the gathered logits) and
all-reduced gradients, every model type, per-rank slab loading, and
checkpointed segments with bit-exact resume (``refuse_unported_sharded``
names what it still refuses); on NCCL the sharded loop is captured as
one card's.

The JAX package fuses the whole split into one ``lax.while_loop`` whose
body carries a ``SplitState`` on the device.  Here the loop body keeps the
same state on the device (``LoopState``) and updates it in place, so no
body waits for the host; on the card the runner captures one body as a
CUDA graph and replays it once an epoch (``make_split_runner``).  With
early stopping on, the host reads the stop flag once after every body.
The model's parameters are trained in place.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.data.registry import (
    load_dataset,
    row_normalize_features,
)
from acmgnn_tpu_torch.data.splits import (
    indices_to_masks,
    load_fixed_split_masks,
    random_disassortative_splits,
)
from acmgnn_tpu_torch.models.layers import batch_stats_frozen
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.graph import (
    GraphData,
    Operators,
    locality_order,
    permute_graph,
    precompute_operators,
)
from acmgnn_tpu_torch.ops.spmm import spmm
from acmgnn_tpu_torch.parallel.multihost import (
    all_reduce_sum,
    capture_safe,
    failure_vote,
    gather_rows,
)
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
from acmgnn_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from acmgnn_tpu_torch.utils.logging import RunStats
from acmgnn_tpu_torch.utils.resilience import retry_transient

JOINT_CAPABLE = ("acmgcn", "acmgcnp", "acmgcnpp")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_optimizer(cfg: TrainConfig, params, lr=None, weight_decay=None,
                   capturable: Optional[bool] = None) -> torch.optim.Optimizer:
    """The optimizer of ``cfg`` (``lr`` / ``weight_decay`` override the
    config's values, as ``hparams`` does):

    - "adam": torch Adam with coupled L2, which is optax's
      ``add_decayed_weights -> scale_by_adam -> scale(-lr)``: L2 folded
      into the gradient before the moments;
    - "adamw": torch AdamW, which is ``optax.adamw``'s decoupled decay
      (``p -= lr·(adam step + wd·p)``).

    ``capturable`` (None: whether a parameter lies on the card) is torch's
    form with the step count and bias corrections on the device, in f32
    (optax's form as well), through its multi-tensor path, so that a CUDA
    graph can capture the step; on the card every step runs it, eager or
    replayed.  Without it torch forms the bias corrections on the host in
    f64.  ``capturable=True`` on CPU parameters runs the card's form on
    the CPU (``_CPU_CARD_FORM``): the CPU references of the card checks."""
    params = list(params)
    lr = cfg.lr if lr is None else float(lr)
    wd = cfg.weight_decay if weight_decay is None else float(weight_decay)
    on_card = any(p.is_cuda for p in params)
    if capturable is None:
        capturable = on_card
    if cfg.optimizer not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    cls = torch.optim.Adam if cfg.optimizer == "adam" else torch.optim.AdamW
    if capturable and not on_card:
        cls = _CPU_CARD_FORM[cls]
    return cls(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
               capturable=capturable, foreach=True if capturable else None)


@contextlib.contextmanager
def _capturable_admits_cpu():
    """torch asserts in a capturable Adam step that every tensor lies on a
    device its ``_get_capturable_supported_devices`` lists, which names
    no CPU; the step's arithmetic itself runs on any device.  For the
    length of the block the list also names the CPU, in each optimizer
    module of torch that looks it up."""
    import importlib

    mods = [m for m in map(importlib.import_module,
                           ("torch.optim.adam", "torch.optim.adamw"))
            if hasattr(m, "_get_capturable_supported_devices")]
    if not mods:
        raise RuntimeError(
            "torch.optim.adam has no _get_capturable_supported_devices: "
            "this torch cannot run the card's optimizer form on the CPU")
    checks = [m._get_capturable_supported_devices for m in mods]
    for m, check in zip(mods, checks):
        m._get_capturable_supported_devices = (
            lambda *a, _check=check, **k: [*_check(*a, **k), "cpu"])
    try:
        yield
    finally:
        for m, check in zip(mods, checks):
            m._get_capturable_supported_devices = check


def _card_form_cpu(cls):
    class CardForm(cls):
        """``cls`` in the card's capturable form on CPU parameters."""

        def step(self, closure=None):
            with _capturable_admits_cpu():
                return super().step(closure)

    CardForm.__name__ = CardForm.__qualname__ = f"{cls.__name__}CardForm"
    return CardForm


_CPU_CARD_FORM = {cls: _card_form_cpu(cls)
                for cls in (torch.optim.Adam, torch.optim.AdamW)}


def train_forward(model: ACMGNN, x, ops, generator, *,
                  paired_eval: bool = False, remat: bool = False,
                  recompute_generator=None):
    """The dropout train forward (with ``paired_eval``, also the eval
    logits of the same parameters).

    ``remat`` (JAX ``jax.checkpoint`` around the train forward) runs it
    under non-reentrant activation checkpointing: the backward recomputes
    the forward instead of holding its activations.  The recompute must
    draw the same dropout masks, and checkpointing's own RNG stash covers
    only the default generators, not the explicit ``generator``: the
    recompute draws from ``recompute_generator``, a twin of ``generator``
    (the same state when the loop started) that only recomputes draw
    from, so each recompute starts where its forward started.  Neither
    generator's state is read or set on the host, so a CUDA graph that
    registers both replays the pair."""

    def run(x_, gen):
        return model(x_, ops, training=True, paired_eval=paired_eval,
                     generator=gen)

    if not remat:
        return run(x, generator)
    if (generator is None) != (recompute_generator is None):
        raise ValueError("remat with a dropout generator needs its twin "
                         "(recompute_generator)")
    calls = [0]

    def region(x_):
        calls[0] += 1
        if calls[0] == 1:
            return run(x_, generator)
        # the recompute: BatchNorm's running statistics were updated once
        with batch_stats_frozen():
            return run(x_, recompute_generator)

    return checkpoint(region, x, use_reentrant=False,
                      preserve_rng_state=False)


def build_model(cfg: TrainConfig, nfeat: int, nclass: int, *, device=None,
                seed: int = 0, nnodes: Optional[int] = None) -> ACMGNN:
    """The model of ``cfg`` on ``device`` (the card unless asked
    otherwise), initialised from ``seed``; ``nnodes`` sizes the structure
    channel's embedding (``cfg.structure_info``)."""
    return ACMGNN(
        nfeat, cfg.hidden, nclass,
        model_type=cfg.model_type,
        nlayers=cfg.nlayers,
        dropout=cfg.dropout,
        variant=cfg.variant,
        structure_info=cfg.structure_info,
        use_layernorm=cfg.resolve_layernorm(),
        nnodes=nnodes,
        init_layers_X=cfg.init_layers_X,
        alpha=cfg.alpha,
        lamda=cfg.lamda,
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
    val_hist: torch.Tensor         # every epoch's val loss
    optimizer: torch.optim.Optimizer
    capture_ms: Optional[float] = None   # host ms of the capture (eager: None)
    setup_ms: Optional[float] = None     # host ms from the call to the first
    #                                      replay (eager: None)
    runner: Optional["RunnerState"] = None   # a segment's (``epoch_limit``)
    #                                          state, for the next one


@dataclasses.dataclass
class LoopState:
    """The split loop's state on the device: JAX's ``SplitState`` without
    the parameters and the optimizer state, which the model and the
    optimizer hold.  Every loop body updates it in place, so a CUDA graph
    of a body replays on the same tensors; no body reads it on the host."""

    k: torch.Tensor                # int64: bodies run
    best_val_loss: torch.Tensor
    best_val_metric: torch.Tensor
    best_test_metric: torch.Tensor
    val_hist: torch.Tensor         # [epochs + 1]: val loss by epoch
    train_losses: torch.Tensor     # [epochs + 1]: train loss by body
    stop: torch.Tensor             # bool: the early-stopping rule fired

    @classmethod
    def initial(cls, epochs: int, dev) -> "LoopState":
        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        return cls(k=torch.zeros((), dtype=torch.int64, device=dev),
                   best_val_loss=scalar(math.inf),
                   best_val_metric=scalar(-math.inf),
                   best_test_metric=scalar(0.0),
                   val_hist=torch.zeros(epochs + 1, device=dev),
                   train_losses=torch.zeros(epochs + 1, device=dev),
                   stop=torch.zeros((), dtype=torch.bool, device=dev))

    def select(self, evals, improved) -> None:
        """Keep ``evals`` = (val_loss, val_metric, test_metric) where
        ``improved``."""
        for best, new in zip((self.best_val_loss, self.best_val_metric,
                              self.best_test_metric), evals):
            best.copy_(torch.where(improved, new, best))

    def clone(self, dev=None) -> "LoopState":
        """A copy (on ``dev``, or where it is)."""
        return LoopState(**{
            f.name: getattr(self, f.name).detach().to(dev, copy=True)
            for f in dataclasses.fields(self)})

    def result(self, joint: bool, bodies: Optional[int] = None
               ) -> "SplitResult":
        """The split's result after ``bodies`` bodies (default: read
        ``k`` on the host)."""
        if bodies is None:
            bodies = int(self.k)
        return SplitResult(
            test_metric=self.best_test_metric, val_metric=self.best_val_metric,
            val_loss=self.best_val_loss,
            train_loss=self.train_losses[max(bodies - 1, 0)],
            epochs_run=max(bodies - 1, 0) if joint else bodies)


@dataclasses.dataclass
class RunnerState:
    """A split runner's whole state between two segments of one split
    (``make_split_runner``'s ``init_state``): the model's ``state_dict``
    (parameters and buffers), the optimizer's (Adam's moments and step),
    the loop's device state, and the state of this rank's dropout
    generator and of its remat twin (None without remat).  JAX's keys are
    stateless (``fold_in(key, epoch)``); the port's generators are
    stateful and seeded by ``(seed, rank)``, so their states are part of
    it, one per rank.  Held as copies: running a segment from it leaves
    it as it was, so a failed segment can be run again."""

    variables: dict
    opt_state: dict
    loop: LoopState
    generators: list

    @property
    def bodies(self) -> int:
        return int(self.loop.k)


def write_at(hist: torch.Tensor, idx: torch.Tensor, value: torch.Tensor,
             valid=None) -> None:
    """``hist[idx] = value`` at a device index ``idx`` (with ``valid``,
    only where it holds), without a host read."""
    i = idx.reshape(1)
    value = value.reshape(1).to(hist.dtype)
    if valid is not None:
        value = torch.where(valid, value, hist.index_select(0, i))
    hist.index_copy_(0, i, value)


def stop_window(hist: torch.Tensor, e: torch.Tensor, es: int) -> torch.Tensor:
    """``hist[e - es : e]`` at a device index ``e``, as JAX's
    ``lax.dynamic_slice(hist, (e - es,), (es,))`` reads it: a negative
    start counts from the end, then the start is clamped into ``[0, len -
    es]``; the ``es`` entries are gathered in order, so their mean sums in
    the slice's order.  (The stop rule reads it only at ``e > es``.)"""
    n = hist.shape[0]
    start = e - es
    start = torch.where(start < 0, start + n, start).clamp(0, n - es)
    return hist.index_select(0, start + torch.arange(es, device=hist.device))


def _capture(body, generators) -> kernels.CountedGraph:
    """``body`` captured once as a CUDA graph on the current stream, the
    dropout ``generators`` registered with it, so that each replay
    advances their Philox offsets as an eager body does.  Unlike
    ``torch.cuda.graph``, no device-wide synchronize and no
    ``empty_cache`` come first: in a process holding a large cache they
    made a capture take 28-214 ms on an H100 (``chip_smoke.py`` 8b)."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)

    def record():
        graph.capture_begin()
        try:
            body()
        finally:
            graph.capture_end()

    return kernels.CountedGraph(graph, record)


def capture_device(dev: torch.device, group=None, graph: bool = True):
    """Where the split loop captures its body: ``dev`` when ``graph`` is
    on, ``dev`` is a card and the run's collectives can be recorded in a
    CUDA graph (one card: none; a process group on NCCL:
    ``multihost.capture_safe``); None, an eager loop, on the CPU and on a
    gloo group, whose collectives run on the host."""
    if not graph or dev.type != "cuda":
        return None
    if group is not None and not capture_safe(group):
        return None
    return dev


def _room_for_capture(dev) -> None:
    """Release the caching allocator's free blocks when the card has less
    free memory than they hold.  A capture allocates its graph's private
    pool anew and cannot release cached blocks while it captures, so on a
    card whose memory sits in the cache (the eager first body's working
    set, earlier work) an allocation of the capture would fail; on a card
    with room nothing is released (a release made a capture take 28-214
    ms on an H100, ``_capture``)."""
    free, _ = torch.cuda.mem_get_info(dev)
    if free < torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(
            dev):
        torch.cuda.empty_cache()


def _run_loop(body, limit: int, stop, generators, capture_on, t0: float):
    """``body`` up to ``limit`` times; after each, the host reads ``stop``
    (None: never) and ends the loop if it is set.  ``capture_on``: a CUDA
    device, or None to run every body eagerly.  On the card the loop runs
    on a side stream, which is also the capture's: the first body eagerly
    (it makes, on that stream, what a capture needs to exist already),
    the second captured, the rest replays.  Returns (bodies run, capture
    ms, setup ms since ``t0``: the host's time to the first replay)."""
    bodies, capture_ms, setup_ms = 0, None, None
    step = body
    side = None
    if capture_on is not None:
        side = torch.cuda.Stream(device=capture_on)
        side.wait_stream(torch.cuda.current_stream(capture_on))
    with (torch.cuda.stream(side) if side is not None
          else contextlib.nullcontext()):
        while bodies < limit:
            if side is not None and bodies == 1:
                t1 = time.perf_counter()
                _room_for_capture(capture_on)
                step = _capture(body, generators).replay
                capture_ms = 1e3 * (time.perf_counter() - t1)
                setup_ms = 1e3 * (time.perf_counter() - t0)
            step()
            bodies += 1
            if stop is not None and bool(stop):   # the host reads the flag
                break
    if side is not None:
        torch.cuda.current_stream(capture_on).wait_stream(side)
    return bodies, capture_ms, setup_ms


def make_split_runner(model: ACMGNN, cfg: TrainConfig, joint=None,
                      group=None, graph: bool = True,
                      capturable: Optional[bool] = None):
    """``run(ops, x, labels, masks, seed=0, return_state=False,
    labels_onehot=None, hparams=None, init_state=None, epoch_limit=None)``
    — one split's training from the model's current parameters (the joint
    loop for joint-capable models when ``cfg.joint``, else the sequential
    one).  ``labels_onehot`` is the BCE target, ``prepare_data``'s
    ``labels_onehot``; ``hparams``, an ``(lr, weight_decay)`` pair, builds
    the optimizer from those values in place of the config's.  With
    ``cfg.remat`` the train forward runs under activation checkpointing
    (``train_forward``).

    Segments (JAX's ``init_state`` / ``epoch_limit``): the loop runs while
    its body counter is under ``epoch_limit`` (and its budget: ``epochs``,
    the joint loop's ``epochs + 1``), and with ``return_state`` returns
    the ``RunnerState`` the next segment starts from (``SplitState.runner``);
    ``init_state``, such a state, restores the model's
    parameters and buffers, the optimizer, the loop state and the dropout
    generators first, so a split run in segments equals the uninterrupted
    run bit for bit, and a segment run twice from one state gives the same
    result.

    The loop body is JAX's (``acmgnn_tpu/train/trainer.py:234-305``,
    ``:338-426``): it keeps the split's state on the device
    (``LoopState``) and calls nothing that waits for the card.  With
    ``graph`` (the default), on a CUDA device the first body runs
    eagerly, the second is captured once as a ``torch.cuda.CUDAGraph``
    and every later body replays it; ``graph=False`` runs every body
    eagerly (the same body: the card tests and ``chip_smoke.py`` hold the
    two forms equal bit for bit).  ``capturable`` is
    ``make_optimizer``'s: True on the CPU runs the card's optimizer
    arithmetic there.

    Eager by rule: the CPU; a gloo group, whose collectives run on the
    host (``capture_device``); ``run_experiment_stepwise`` (the host
    observes every epoch).  A sharded run on NCCL is captured as one
    card's: the collectives, the K6 packs and exchanges and ROC-AUC's
    gathered logits with K4 are recorded in the graph, and the eager
    first body creates the NCCL communicator.  A capture or replay that
    fails raises; nothing falls back to eager.
    The first body makes what a capture needs first: K2/K3's occupancy
    answers, K4's workspace, Adam's moments and cuBLAS's workspace on the
    capture stream.  The dropout generator (with ``cfg.remat``, also its
    twin for the recompute) is registered with the graph.  With
    ``cfg.early_stopping`` the host reads the stop flag once after every
    body (its one wait for the card in a body); without it, not until
    the run ends.  ``kernels.launches`` counts the launches that ran
    (``kernels.CountedGraph``).

    ``group``: the process group of a sharded run, whose ranks each pass
    their slabs of the node arrays and their share of a sharded operator
    (``prepare_sharded_data``).  Losses and accuracies are then global:
    each rank's loss is its masked sum over the all-reduced mask count
    (one all-reduce a split).  The gradients are summed over the ranks
    in one flat buffer before the optimizer step, so the replicas stay
    equal, and the epoch's metric shares (loss shares, correct counts)
    ride in the same buffer behind them: one all-reduce a joint body,
    the counterpart of XLA combining the independent psums of JAX's
    loop body; the sequential body takes two (its eval forward reads the
    updated parameters: the train-loss share with the gradients, then
    the eval shares); acmgcnpp's BatchNorm adds its own.  Every rank
    reads the same stop flag.  Dropout draws from a generator seeded by
    ``(seed, rank)``.  ROC-AUC ranks all nodes on every rank: each rank
    gathers every rank's logits slab (``[P·rows_per_part, C]``) and the
    split's packed label/mask words in that layout (gathered once a
    split), then sorts and runs one K4 launch, so every rank reads the
    same AUCs and the same stop flag.  Pad rows carry mask 0, and K4
    counts average ranks over the masked nodes alone, so where the pad
    rows fall among ties cannot move an AUC; at one rank the gathered
    logits are the single card's, and so are the AUCs, bit for bit."""
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
    if joint is None:
        joint = bool(cfg.joint) and cfg.model_type in JOINT_CAPABLE
    sel_metric = cfg.selection == "val_metric"
    params = list(model.parameters())

    def loss_of(logits, labels, labels_onehot, mask, count=None):
        if use_bce:
            return masked_bce_with_logits(logits, labels_onehot, mask, count)
        return masked_nll(torch.log_softmax(logits, dim=1), labels, mask,
                          count)

    def shares_of(logits, labels, labels_onehot, masks, counts, loss=None):
        """This rank's shares of the global metrics (None on one card):
        ``loss``'s (the train-loss share) if given, the val loss's, and
        (accuracy) the val and test correct counts."""
        if group is None:
            return None
        _, val_mask, test_mask = masks
        shares = [] if loss is None else [loss.detach()]
        shares.append(loss_of(logits, labels, labels_onehot, val_mask,
                              counts[1]))
        if not use_rocauc:
            shares += [masked_correct(logits, labels, val_mask).float(),
                       masked_correct(logits, labels, test_mask).float()]
        return torch.stack(shares)

    def evaluations(logits, labels, labels_onehot, masks, packed, counts,
                    shares):
        """``(val_loss, val_metric, test_metric)``: on one card from the
        logits; sharded from ``shares``, ``shares_of``'s summed over the
        ranks without the train loss (``counts``: the all-reduced mask
        counts); ROC-AUC from every rank's logits, gathered."""
        _, val_mask, test_mask = masks
        if group is not None:
            if use_rocauc:
                # every rank ranks all nodes (``packed`` is gathered too)
                metrics = masked_rocauc_multi(gather_rows(logits, group),
                                              labels, masks[1:],
                                              packed=packed)
            else:
                metrics = (shares[1] / counts[1], shares[2] / counts[2])
            return (shares[0], *metrics)
        if use_rocauc:
            # one score sort and one rank pass serve both masks
            val_metric, test_metric = masked_rocauc_multi(
                logits, labels, (val_mask, test_mask), packed=packed)
        else:
            val_metric = masked_accuracy(logits, labels, val_mask)
            test_metric = masked_accuracy(logits, labels, test_mask)
        return (loss_of(logits, labels, labels_onehot, val_mask), val_metric,
                test_metric)

    def global_counts(masks):
        """The masks' node counts over all ranks (None unless sharded)."""
        if group is None:
            return None
        counts = torch.stack([m.sum() for m in masks]).float()
        return all_reduce_sum(counts, group).clamp_min(1)

    def step(opt, loss, shares=None):
        """Backward and the update.  Sharded, the gradients are summed
        over the ranks first in one all-reduce of a flat buffer
        ``[gradients | shares]``: this rank's metric ``shares`` ride
        behind the gradients, and come back summed (None on one card)."""
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            flat = all_reduce_sum(torch.cat(
                [p.grad.reshape(-1) for p in params] + [shares]), group)
            *grads, shares = flat.split([p.numel() for p in params]
                                        + [shares.numel()])
            for p, g in zip(params, grads):
                p.grad = g.view_as(p)
        opt.step()
        return shares

    def generators(dev, seed):
        """The dropout generator and, with remat, its twin for the
        recompute (None)."""
        if group is not None:
            seed = seed * dist.get_world_size(group) + dist.get_rank(group)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return gen, (gen.clone_state() if cfg.remat else None)

    def packed_words(labels, masks, labels_onehot):
        """The rank pass's packed label/mask words (val and test masks),
        fixed for the split; sharded, every rank's in the gathered
        layout."""
        if use_bce and labels_onehot is None:
            raise ValueError("the BCE loss needs labels_onehot "
                             "(prepare_data's)")
        if not use_rocauc:
            return None
        packed = pack_labels_and_masks(labels, masks[1:])
        if group is not None:
            packed = gather_rows(packed.T, group).T.contiguous()
        return packed

    def improved(state, evals):
        """Whether ``evals`` beat the best so far; a NaN metric never
        improves, as under JAX's ``>``."""
        return (evals[1] > state.best_val_metric if sel_metric
                else evals[0] < state.best_val_loss)

    def optimizer(hparams):
        if hparams is None:
            return make_optimizer(cfg, params, capturable=capturable)
        return make_optimizer(cfg, params, lr=hparams[0],
                              weight_decay=hparams[1], capturable=capturable)

    def restore(init, dev, gens, opt):
        """The loop state of ``init`` (a ``RunnerState``), with the model,
        the optimizer and the generators set from it."""
        if init is None:
            return LoopState.initial(epochs, dev)
        model.load_state_dict(init.variables)
        opt.load_state_dict(copy.deepcopy(init.opt_state))
        for gen, st in zip(gens, init.generators):
            if gen is not None:
                gen.set_state(st)
        return init.loop.clone(dev)

    def drive(body_of, budget, ops, x, labels, masks, seed, return_state,
              labels_onehot, hparams, init_state, epoch_limit):
        """Set-up, the loop up to ``budget`` bodies in all (or to
        ``epoch_limit``) from ``init_state``, and the results;
        ``body_of(state, gens, opt, packed, counts)`` makes the body."""
        t0 = time.perf_counter()
        dev = x.device
        gens = generators(dev, seed)
        opt = optimizer(hparams)
        packed = packed_words(labels, masks, labels_onehot)
        counts = global_counts(masks)
        state = restore(init_state, dev, gens, opt)
        limit = budget if epoch_limit is None else min(int(epoch_limit),
                                                        budget)
        done = 0 if init_state is None else init_state.bodies
        if init_state is not None and bool(init_state.loop.stop):
            limit = done
        body = body_of(state, gens, opt, packed, counts)
        ran, capture_ms, setup_ms = _run_loop(
            body, max(limit - done, 0), state.stop if es else None,
            [g for g in gens if g is not None],
            capture_device(dev, group, graph), t0)
        opt.zero_grad(set_to_none=True)   # frees the graph's gradients
        bodies = done + ran
        result = state.result(joint, bodies)
        if not return_state:
            return result
        runner = None
        if epoch_limit is not None:   # a segment: what the next starts from
            runner = RunnerState(
                variables={k: v.detach().clone()
                           for k, v in model.state_dict().items()},
                opt_state=copy.deepcopy(opt.state_dict()),
                loop=state.clone(),
                generators=[None if g is None else g.get_state()
                            for g in gens])
        return result, SplitState(
            epoch=bodies, train_losses=state.train_losses[:bodies],
            val_hist=state.val_hist[:result.epochs_run], optimizer=opt,
            capture_ms=capture_ms, setup_ms=setup_ms, runner=runner)

    def run(ops, x, labels, masks, seed: int = 0,
            return_state: bool = False, labels_onehot=None, hparams=None,
            init_state=None, epoch_limit=None):
        """Sequential loop: each epoch trains, then evaluates the updated
        parameters in a separate forward; stops after ``epochs`` or when
        the early-stopping rule fires (that epoch counts)."""

        def body_of(s, gens, opt, packed, counts):
            def body():
                logits = train_forward(model, x, ops, gens[0],
                                       remat=cfg.remat,
                                       recompute_generator=gens[1])
                loss = loss_of(logits, labels, labels_onehot, masks[0],
                               None if counts is None else counts[0])
                # sharded: the train-loss share rides the gradients'
                # all-reduce, the eval shares take a second one
                summed = step(opt, loss, None if group is None
                              else loss.detach().reshape(1))
                loss = loss.detach() if summed is None else summed[0]
                with torch.no_grad():
                    logits = model(x, ops, training=False)
                    shares = shares_of(logits, labels, labels_onehot, masks,
                                       counts)
                    if shares is not None:
                        all_reduce_sum(shares, group)
                    evals = evaluations(logits, labels, labels_onehot, masks,
                                        packed, counts, shares)
                    s.select(evals, improved(s, evals))
                    write_at(s.val_hist, s.k, evals[0])
                    if es:
                        s.stop.copy_((s.k > es) & (evals[0] > stop_window(
                            s.val_hist, s.k, es).mean()))
                    write_at(s.train_losses, s.k, loss)
                    s.k.add_(1)
            return body

        return drive(body_of, epochs, ops, x, labels, masks, seed,
                     return_state, labels_onehot, hparams, init_state,
                     epoch_limit)

    def run_joint(ops, x, labels, masks, seed: int = 0,
                  return_state: bool = False, labels_onehot=None,
                  hparams=None, init_state=None, epoch_limit=None):
        """Iteration k evaluates epoch k-1 (parameters after k updates)
        and trains epoch k in one paired forward; ``epochs + 1``
        iterations, the first one's evaluation is skipped.  An iteration
        whose evaluation fires the early-stopping rule still applies its
        update, then the loop ends."""

        def body_of(s, gens, opt, packed, counts):
            def body():
                logits_train, logits_eval = train_forward(
                    model, x, ops, gens[0], paired_eval=True,
                    remat=cfg.remat, recompute_generator=gens[1])
                loss_share = loss_of(logits_train, labels, labels_onehot,
                                     masks[0],
                                     None if counts is None else counts[0])
                with torch.no_grad():
                    shares = shares_of(logits_eval, labels, labels_onehot,
                                       masks, counts, loss_share)
                # sharded: one all-reduce, the shares behind the gradients
                shares = step(opt, loss_share, shares)
                with torch.no_grad():
                    if shares is None:
                        loss = loss_share.detach()
                    else:
                        loss, shares = shares[0], shares[1:]
                    evals = evaluations(logits_eval, labels, labels_onehot,
                                        masks, packed, counts, shares)
                    # selection and history for epoch e = k - 1 (k > 0)
                    valid = s.k > 0
                    e = (s.k - 1).clamp_min(0)
                    s.select(evals, valid & improved(s, evals))
                    write_at(s.val_hist, e, evals[0], valid)
                    if es:
                        s.stop.copy_(valid & (s.k - 1 > es) & (
                            evals[0] > stop_window(s.val_hist, e, es).mean()))
                    write_at(s.train_losses, s.k, loss)
                    s.k.add_(1)
            return body

        return drive(body_of, epochs + 1, ops, x, labels, masks, seed,
                     return_state, labels_onehot, hparams, init_state,
                     epoch_limit)

    return run_joint if joint else run


def train_single_split(model: ACMGNN, cfg: TrainConfig, ops: Operators,
                       x: torch.Tensor, labels: torch.Tensor,
                       labels_onehot: torch.Tensor, masks,
                       seed: int = 0) -> SplitResult:
    """One split, one shot (JAX ``train_single_split``): the split runner
    of ``cfg`` from the model's current parameters, dropout drawn from
    ``seed``.  JAX's ``key`` also initialises the model; here the model
    holds its initial parameters (``build_model(..., seed=...)``)."""
    return make_split_runner(model, cfg)(ops, x, labels, masks, seed=seed,
                                         labels_onehot=labels_onehot)


def maybe_reorder(data: GraphData, cfg: TrainConfig) -> GraphData:
    """Apply ``cfg.reorder``'s locality permutation ("rcm", "degree") to
    the whole graph (adjacency, features, labels) once and record it in
    ``data.perm``; a no-op if the graph is permuted already or reorder is
    "none"."""
    if cfg.reorder == "none" or data.perm is not None:
        return data
    perm = locality_order(data.adj, cfg.reorder)
    return dataclasses.replace(
        data, adj=permute_graph(data.adj, perm),
        features=np.asarray(data.features)[perm],
        labels=np.asarray(data.labels)[perm], perm=perm)


def _features_on(features: torch.Tensor, cfg: TrainConfig, dev):
    """A host f32 feature tensor in ``cfg.feature_dtype`` on ``dev``: a
    bf16 copy is made on the host, so only it crosses to the device (the
    model promotes it at each use)."""
    if cfg.feature_dtype == "bfloat16":
        features = features.to(torch.bfloat16)
    elif cfg.feature_dtype != "float32":
        raise ValueError(f"unknown feature_dtype {cfg.feature_dtype!r}")
    return features.to(dev)


def load_graph(dataset: GraphData | str, cfg: TrainConfig) -> GraphData:
    """``dataset`` itself, or the dataset of that name loaded from local
    files (``load_dataset`` with ``cfg.sub_dataset`` and
    ``cfg.directed``)."""
    if isinstance(dataset, str):
        return load_dataset(dataset, cfg.sub_dataset, directed=cfg.directed)
    return dataset


def prepare_data(dataset: GraphData | str, cfg: TrainConfig, device=None):
    """Load (``load_graph``) and preprocess a graph into device tensors
    and operators: ``(data, ops, x, labels, labels_onehot, nclass)``,
    where ``data`` is the graph after ``maybe_reorder``."""
    dev = resolve_device(device)
    if cfg.ell_block not in (0, 1):
        raise NotImplementedError("block-column ELL is a TPU layout")
    data = maybe_reorder(load_graph(dataset, cfg), cfg)
    features = data.features
    if cfg.resolve_feature_normalize():
        features = row_normalize_features(features)
    ops = precompute_operators(
        data.adj, normalization=cfg.normalization,
        hops=cfg.hops if cfg.model_type in ("acmsgc", "sgc") else 1,
        structure_info=cfg.structure_info, fmt=cfg.operator_format,
        spmm_dtype=_DTYPES[cfg.spmm_dtype],
    ).to(dev)
    labels = _host_labels(data.labels)
    nclass = data.num_classes
    labels_onehot = _one_hot(labels, nclass)
    x = _features_on(torch.from_numpy(
        np.ascontiguousarray(features, np.float32)), cfg, dev)
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


def refuse_unported_sharded(cfg: TrainConfig) -> None:
    """The sharded path runs every model type, variant 1, the structure
    channel, acmgcnpp's skip MLP with BatchNorm (``init_layers_X > 1``:
    statistics over every rank's real rows, ``layers.BatchNorm``), row or
    symmetric normalization on the ELL or COO operator (the dense format
    maps to ELL, as in the JAX package), and refuses by name the one case
    it does not port (ROADMAP.md A8): acmsgc/sgc with ``hops > 1``, since
    there is no sharded k-hop operator (the JAX package's sharded bundle
    has none either and trains over ``Â`` instead; ROADMAP.md §C)."""
    if cfg.model_type in ("acmsgc", "sgc") and cfg.hops > 1:
        raise NotImplementedError(
            "the sharded path does not port the k-hop operator "
            f"(hops {cfg.hops} > 1) yet (ROADMAP.md A8)")


def prepare_sharded_data(dataset: GraphData | str, cfg: TrainConfig, *,
                         group=None, device=None, exchange: str = "auto"
                         ) -> ShardedData:
    """Sharded counterpart of ``prepare_data`` for this rank of ``group``
    (None: one rank, no collectives): ``maybe_reorder`` first (a
    locality order shrinks each part's halo), the partition
    (``cfg.partition``: "contiguous" nnz-balanced blocks, or "fennel" /
    "balanced" with a contiguity permutation of the whole graph, composed
    into ``data.perm``), this rank's share of the operators (``exchange``:
    "allgather", "halo" or "auto"; ``cfg.normalization``, the structure
    channel's raw adjacency with ``cfg.structure_info``; the "dense" and
    "auto" formats map to ELL, as in the JAX package), its slabs of the
    features (in ``cfg.feature_dtype``), labels and one-hot labels, and
    the hoisted ``Â X`` through the sharded operator.  Every node array
    is placed through a loader of this rank's rows alone
    (``shard_node_array``)."""
    dev = resolve_device(device)
    rank, world = _rank_and_world(group)
    refuse_unported_sharded(cfg)
    data = maybe_reorder(load_graph(dataset, cfg), cfg)
    boundaries = None
    if cfg.partition in ("fennel", "balanced"):
        part = (fennel_partition(data.adj, world) if cfg.partition == "fennel"
                else degree_balanced_partition(data.adj, world))
        perm, boundaries = partition_to_perm(part, world)
        data = dataclasses.replace(
            data, adj=permute_graph(data.adj, perm),
            features=np.asarray(data.features)[perm],
            labels=np.asarray(data.labels)[perm],
            perm=perm if data.perm is None else np.asarray(data.perm)[perm])
    elif cfg.partition != "contiguous":
        raise ValueError(f"unknown partition {cfg.partition!r}")
    features = data.features
    if cfg.resolve_feature_normalize():
        features = row_normalize_features(features)
    ops, boundaries, rpp = make_sharded_operators(
        data.adj, world, rank, normalization=cfg.normalization,
        structure_info=cfg.structure_info,
        fmt="coo" if cfg.operator_format == "coo" else "ell",
        exchange=exchange, boundaries=boundaries,
        spmm_dtype=_DTYPES[cfg.spmm_dtype])
    for op in (ops.adj_low, ops.adj_unnorm):
        if op is not None:
            op.group = group
    ops = ops.to(dev)

    def place(arr, device=dev):
        return shard_node_array(arr, boundaries, rpp, rank, device)

    labels = _host_labels(data.labels)
    x = _features_on(place(np.asarray(features, np.float32), "cpu"), cfg,
                     dev)
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


def resolve_split(data: GraphData, cfg: TrainConfig, idx: int, rng, labels,
                  nclass: int):
    """One (train, val, test) bool-mask triple, as the JAX package's:

    - with ``cfg.fixed_splits``, the dataset's own ``data.splits[idx]``
      (index lists, e.g. the LINKX split files), else the Geom-GCN mask
      file ``idx`` of ``data.name`` (``load_fixed_split_masks``); both in
      the original node ids, permuted by ``data.perm``;
    - else the random disassortative 60/20/20 split drawn from ``rng`` in
      the (possibly permuted) label space ``labels``."""
    n = data.num_nodes
    if data.splits is not None and cfg.fixed_splits:
        s = data.splits[idx % len(data.splits)]
        masks = indices_to_masks(n, s["train"], s["valid"], s["test"])
    elif cfg.fixed_splits:
        masks = load_fixed_split_masks(data.name, idx)
    else:
        return random_disassortative_splits(np.asarray(labels), nclass,
                                            rng=rng)
    if data.perm is not None:
        masks = tuple(m[data.perm] for m in masks)
    return masks


def run_experiment_sharded(dataset: GraphData | str, cfg: TrainConfig, *,
                           device=None, exchange: str = "auto", logger=None,
                           checkpoint_dir=None, checkpoint_every: int = 0,
                           resume: bool = False,
                           per_host_loading: bool = False,
                           return_model: bool = False):
    """Multi-split full-batch training with the graph row-partitioned
    over the ranks of the default process group (``init_distributed``;
    without one, a single rank): the counterpart of the JAX package's
    ``run_experiment_sharded``.

    Every rank calls it with the same arguments.  Split ``idx`` takes its
    masks from ``resolve_split`` (random ones from
    ``numpy.random.default_rng(cfg.seed)``) and starts from ``build_model(...,
    seed=cfg.seed + idx)`` on every rank (the structure channel's
    embedding has the graph's N rows, each rank gathering from its own),
    so the replicas start equal; ``make_split_runner`` keeps them equal.
    Every rank places only its own rows of the features, labels, one-hot
    labels and masks, through a loader of its row range
    (``shard_node_array_per_host``): ``per_host_loading``, the JAX
    package's switch for that, is accepted and changes nothing.  Returns
    the JAX package's result dict (``devices`` is the world size); with
    ``return_model`` also the last split's model, ``(result, model)``.

    ``checkpoint_dir`` with ``checkpoint_every=k`` runs each split in
    k-epoch segments (the joint loop's budget is ``epochs + 1`` bodies)
    and snapshots the runner's state between them (``utils/checkpoint.py``):
    rank 0 writes the replicated state to ``split<idx>_state`` (the
    model's ``state_dict``, the optimizer's, the loop state) and every
    rank its dropout generators' state to ``split<idx>_rng_rank<r>``;
    ``resume`` continues each split from them, equal bit for bit to the
    uninterrupted run.  (Without ``checkpoint_every`` nothing is saved,
    as in the JAX package.)

    ``logger``: an ``ExperimentLogger`` or any object with its ``info`` /
    ``log_split`` / ``log_result``.  Each split, or each segment when
    checkpointing, runs under ``retry_transient`` from its initial state
    (the split's initial parameters, or the segment's ``RunnerState``).
    At several ranks a retry is sound only when every rank fails
    together: a rank that retried alone would issue its collectives again
    while the others wait in later ones, and sum gradients of different
    steps.  So the ranks vote after every attempt
    (``multihost.failure_vote``) and retry only when every rank failed
    transiently in the same collective; otherwise every rank raises.
    """
    group = dist.group.WORLD if dist.is_initialized() else None
    prep = prepare_sharded_data(dataset, cfg, group=group, device=device,
                                exchange=exchange)
    dev = prep.x.device
    agree = failure_vote() if prep.world_size > 1 else None
    checkpointing = checkpoint_dir is not None and checkpoint_every > 0
    joint = bool(cfg.joint) and cfg.model_type in JOINT_CAPABLE
    budget = cfg.epochs + (1 if joint else 0)
    masks_rng = np.random.default_rng(cfg.seed)
    labels_np = _host_labels(prep.data.labels)
    results = []
    t_total = time.time()
    steady_time = 0.0
    steady_epochs = 0
    model = None
    for idx in range(cfg.num_splits):
        masks = tuple(prep.place(m) for m in resolve_split(
            prep.data, cfg, idx, masks_rng, labels_np, prep.nclass))

        def new_runner(idx=idx):
            mdl = build_model(cfg, prep.x.shape[1], prep.nclass, device=dev,
                              seed=cfg.seed + idx,
                              nnodes=prep.data.num_nodes)
            return mdl, make_split_runner(mdl, cfg, group=group)

        args = (prep.ops, prep.x, prep.labels, masks)
        kwargs = dict(seed=cfg.seed + idx, labels_onehot=prep.labels_onehot)
        t_split = time.time()
        if checkpointing:
            model, res = _segmented_split(
                new_runner, args, kwargs, budget, joint, checkpoint_every,
                f"{checkpoint_dir}/split{idx}", resume, prep.rank, dev,
                logger, agree)
        else:
            def run_once():
                mdl, runner = new_runner()
                out = runner(*args, **kwargs)
                _sync(dev)
                return mdl, out

            model, res = retry_transient(run_once, logger=logger,
                                         agree=agree)()
        results.append(res)
        if idx > 0:   # split 0 pays the warm-up; excluded from the rate
            steady_time += time.time() - t_split
            steady_epochs += int(res.epochs_run)
        if logger is not None:
            logger.log_split(idx, res)
    out = _experiment_result(prep.data, cfg, results, time.time() - t_total,
                             steady_time, steady_epochs,
                             devices=prep.world_size)
    if logger is not None:
        logger.log_result(out)
    return (out, model) if return_model else out


def _segmented_split(new_runner, args, kwargs, budget: int, joint: bool,
                     every: int, prefix: str, resume: bool, rank: int, dev,
                     logger, agree):
    """One split of ``run_experiment_sharded`` in ``every``-body segments
    (the JAX package's ``run_segment`` loop): the zero-body state first
    (the split's initial parameters, moments, loop state and generators),
    or the snapshot at ``prefix`` when resuming; then segment after
    segment until the budget or the stop flag, each snapshotted.
    Returns (the model with the split's final parameters, its result)."""
    model, runner = new_runner()

    def run_segment(init, limit):
        _, st = runner(*args, **kwargs, init_state=init, epoch_limit=limit,
                       return_state=True)
        _sync(dev)
        return st.runner

    run_segment = retry_transient(run_segment, logger=logger, agree=agree)
    state = run_segment(None, 0)
    state_path, rng_path = f"{prefix}_state", f"{prefix}_rng_rank{rank}"
    if resume and Path(state_path).exists():
        state = _restore_segment(state_path, rng_path, dev)
        if logger is not None:
            logger.info("%s: resumed after %d bodies", prefix, state.bodies)
    while not bool(state.loop.stop) and state.bodies < budget:
        state = run_segment(state, state.bodies + every)
        if rank == 0:
            save_checkpoint(state_path, state.variables,
                            opt_state=state.opt_state, step=state.bodies,
                            extra={"loop": dataclasses.asdict(state.loop)})
        save_checkpoint(rng_path, {"generators": state.generators},
                        step=state.bodies)
    model.load_state_dict(state.variables)
    return model, state.loop.result(joint)


def _restore_segment(state_path: str, rng_path: str, dev) -> RunnerState:
    """A ``RunnerState`` from rank 0's snapshot and this rank's
    generators, which must come from the same segment's end."""
    snap = restore_checkpoint(state_path, map_location=dev)
    rng = restore_checkpoint(rng_path, map_location="cpu")
    if rng["step"] != snap["step"]:
        raise RuntimeError(
            f"{rng_path} holds the generators after {rng['step']} bodies, "
            f"{state_path} the state after {snap['step']}: not one "
            f"segment's end")
    return RunnerState(variables=snap["variables"],
                       opt_state=snap["opt_state"],
                       loop=LoopState(**snap["extra"]["loop"]),
                       generators=rng["variables"]["generators"])


def _experiment_result(data, cfg, results, elapsed, steady_time,
                       steady_epochs, **extra):
    """The JAX package's result dict of a multi-split run;
    ``epoch_ms_steady`` covers the splits after the first (split 0 pays
    the warm-up)."""
    test = np.array([float(r.test_metric) for r in results])
    epochs_total = sum(int(r.epochs_run) for r in results)
    return {
        "dataset": data.name,
        "model": cfg.model_type,
        **extra,
        "test_mean": float(test.mean()),
        "test_std": float(test.std()),
        "per_split": test.tolist(),
        "epochs_total": epochs_total,
        "runtime_s": elapsed,
        "epoch_ms_avg": 1000.0 * elapsed / max(epochs_total, 1),
        "epoch_ms_steady": (1000.0 * steady_time / steady_epochs
                            if steady_epochs else None),
    }


# ---------------------------------------------------------------------------
# Single-card entry points
# ---------------------------------------------------------------------------


def _sync(dev) -> None:
    """Wait for the card, so an asynchronous fault surfaces here (inside
    a retry scope)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_experiment(dataset: GraphData | str, cfg: TrainConfig, *, splits=None,
                   logger=None, prepared=None, runner=None, hparams=None,
                   device=None) -> dict:
    """Multi-split experiment, the counterpart of the JAX package's
    ``run_experiment``: returns its result dict (test mean/std, per-split
    test metrics, epochs, run time, ``epoch_ms_avg`` and
    ``epoch_ms_steady`` over the splits after the first).

    Split ``idx`` takes its masks from ``splits[idx]`` or ``resolve_split``
    (random ones from ``numpy.random.default_rng(cfg.seed)``) and starts
    from ``build_model(..., seed=cfg.seed + idx)``; each split runs under
    ``retry_transient`` from its initial parameters.  The reuse hooks keep
    the JAX package's meaning: ``prepared`` is ``prepare_data``'s output
    (skips preprocessing); ``runner(model, ops, x, labels, masks, *, seed,
    labels_onehot, hparams)`` runs one split from the model's current
    parameters in place of ``make_split_runner(model, cfg)`` (JAX's
    runner takes the split's initial variables; here the model holds
    them); ``hparams = (lr, weight_decay)`` builds the optimizer from
    those values.  ``logger``: an ``ExperimentLogger`` or any object with
    its ``info`` / ``log_split`` / ``log_result``."""
    data, ops, x, labels, labels_onehot, nclass = (
        prepared if prepared is not None
        else prepare_data(dataset, cfg, device=device))
    if runner is None:
        def runner(model, *args, **kwargs):
            return make_split_runner(model, cfg)(*args, **kwargs)
    dev = x.device
    rng = np.random.default_rng(cfg.seed)
    labels_np = _host_labels(data.labels)
    results = []
    t_total = time.time()
    steady_time = 0.0
    steady_epochs = 0
    for idx in range(cfg.num_splits):
        if splits is not None:
            split = splits[idx]
        else:
            split = resolve_split(data, cfg, idx, rng, labels_np, nclass)
        masks = tuple(torch.as_tensor(np.asarray(m)).to(dev) for m in split)
        t_split = time.time()

        def run_once():
            model = build_model(cfg, x.shape[1], nclass, device=dev,
                                seed=cfg.seed + idx, nnodes=x.shape[0])
            res = runner(model, ops, x, labels, masks, seed=cfg.seed + idx,
                         labels_onehot=labels_onehot, hparams=hparams)
            _sync(dev)
            return res

        res = retry_transient(run_once, logger=logger)()
        results.append(res)
        if idx > 0:   # split 0 pays the warm-up; excluded from the rate
            steady_time += time.time() - t_split
            steady_epochs += int(res.epochs_run)
        if logger is not None:
            logger.log_split(idx, res)
    out = _experiment_result(data, cfg, results, time.time() - t_total,
                             steady_time, steady_epochs)
    if logger is not None:
        logger.log_result(out)
    return out


def make_epoch_fns(model: ACMGNN, cfg: TrainConfig):
    """One-epoch-at-a-time train and eval functions of the observable
    path (JAX ``make_epoch_fns``):

    - ``train_epoch(opt, generator, ops, x, labels, labels_onehot,
      train_mask)``: one dropout forward (checkpointed with
      ``cfg.remat``), backward and optimizer step, in place; returns the
      train loss;
    - ``eval_epoch(ops, x, labels, labels_onehot, masks, packed)``: one
      eval forward; ``{"train_metric", "val_metric", "test_metric",
      "val_loss"}`` (ROC-AUC: one score sort serves the three masks;
      ``packed``: the split's ``pack_labels_and_masks(labels, masks)``,
      None for accuracies)."""
    use_bce = cfg.loss == "bce"
    use_rocauc = cfg.metric == "rocauc"

    def loss_of(logits, labels, labels_onehot, mask):
        if use_bce:
            return masked_bce_with_logits(logits, labels_onehot, mask)
        return masked_nll(torch.log_softmax(logits, dim=1), labels, mask)

    def train_epoch(opt, generator, ops, x, labels, labels_onehot,
                    train_mask):
        logits = train_forward(
            model, x, ops, generator, remat=cfg.remat,
            recompute_generator=(generator.clone_state() if cfg.remat
                                 and generator is not None else None))
        loss = loss_of(logits, labels, labels_onehot, train_mask)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_epoch(ops, x, labels, labels_onehot, masks, packed):
        logits = model(x, ops, training=False)
        if use_rocauc:
            metrics = masked_rocauc_multi(logits, labels, masks,
                                          packed=packed)
        else:
            metrics = tuple(masked_accuracy(logits, labels, m) for m in masks)
        return {"train_metric": metrics[0], "val_metric": metrics[1],
                "test_metric": metrics[2],
                "val_loss": loss_of(logits, labels, labels_onehot, masks[1])}

    return train_epoch, eval_epoch


def epoch_generator(device, seed: int, epoch: int) -> torch.Generator:
    """Epoch ``epoch``'s dropout generator of the stepwise path, derived
    from ``(seed, epoch)`` (JAX ``fold_in(run_key, epoch)``): an epoch
    draws the same masks however it is reached."""
    state = np.random.SeedSequence((seed, epoch)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def run_experiment_stepwise(dataset: GraphData | str, cfg: TrainConfig, *,
                            splits=None, logger=None, display_step: int = 25,
                            checkpoint_dir: Optional[str] = None,
                            checkpoint_every: int = 0, resume: bool = False,
                            device=None) -> dict:
    """Observable multi-split run (JAX ``run_experiment_stepwise``): every
    epoch trains, then evaluates on the host's request, and ``RunStats``
    collects (train, val, test) per epoch; a split's test metric is the one
    at its best-val epoch.  Split ``idx`` starts from ``build_model(...,
    seed=cfg.seed + idx)``; its masks come as in ``run_experiment``.  Each
    epoch runs under ``retry_transient``; it trains in place, so a retry
    continues from the parameters the failed attempt left (JAX's epoch is
    a pure function of its inputs).  ``epoch_ms_steady`` excludes the
    first executed epoch.

    Checkpointing (``utils/checkpoint.py``): ``checkpoint_dir`` saves the
    best-val weights of split ``idx`` (``split<idx>_best``: the model's
    ``state_dict``, BatchNorm statistics included); ``checkpoint_every=k``
    also snapshots the whole training state (``split<idx>_last``: weights,
    the optimizer's state with its step count, the epochs done and the
    best val metric; ``split<idx>_history.npy``: the per-epoch metrics)
    every k epochs and at the split's end, and ``resume`` restores it and
    continues.  An epoch's dropout depends on (seed, epoch) alone
    (``epoch_generator``), so a resumed run equals the uninterrupted one
    bit for bit."""
    data, ops, x, labels, labels_onehot, nclass = prepare_data(
        dataset, cfg, device=device)
    dev = x.device
    rng = np.random.default_rng(cfg.seed)
    labels_np = _host_labels(data.labels)
    stats = RunStats(cfg.num_splits)
    t_total = time.time()
    steady_time = 0.0
    steady_epochs = 0
    first_epoch_done = False
    for idx in range(cfg.num_splits):
        if splits is not None:
            split = splits[idx]
        else:
            split = resolve_split(data, cfg, idx, rng, labels_np, nclass)
        masks = tuple(torch.as_tensor(np.asarray(m)).to(dev) for m in split)
        # the rank pass's label/mask words, fixed for the split
        packed = (pack_labels_and_masks(labels, masks)
                  if cfg.metric == "rocauc" else None)
        model = build_model(cfg, x.shape[1], nclass, device=dev,
                            seed=cfg.seed + idx, nnodes=x.shape[0])
        opt = make_optimizer(cfg, list(model.parameters()))
        train_epoch, eval_epoch = make_epoch_fns(model, cfg)
        best_val = -math.inf
        start_epoch = 0
        last_path = hist_path = None
        if checkpoint_dir is not None:
            last_path = f"{checkpoint_dir}/split{idx}_last"
            hist_path = f"{checkpoint_dir}/split{idx}_history.npy"
        if resume and last_path is not None and Path(last_path).exists():
            snap = restore_checkpoint(last_path, map_location=dev)
            model.load_state_dict(snap["variables"])
            opt.load_state_dict(snap["opt_state"])
            start_epoch = int(snap["step"])
            best_val = float(snap["extra"]["best_val"])
            for row in np.load(hist_path)[:start_epoch]:
                stats.add_result(idx, tuple(row))
            if logger is not None:
                logger.info("split %d: resumed at epoch %d (best val %.4f)",
                            idx, start_epoch, best_val)

        def save_state(epochs_done):
            save_checkpoint(last_path, model.state_dict(),
                            opt_state=opt.state_dict(), step=epochs_done,
                            extra={"best_val": float(best_val)})
            np.save(hist_path, np.asarray(stats.results[idx], np.float64))

        for epoch in range(start_epoch, cfg.epochs):

            def do_epoch():
                gen = epoch_generator(dev, cfg.seed + idx, epoch)
                loss_ = train_epoch(opt, gen, ops, x, labels, labels_onehot,
                                    masks[0])
                ev_ = eval_epoch(ops, x, labels, labels_onehot, masks,
                                 packed)
                return float(loss_), {k: float(v) for k, v in ev_.items()}

            t_epoch = time.time()
            loss, ev = retry_transient(do_epoch, logger=logger)()
            if first_epoch_done:   # the first executed epoch is warm-up
                steady_time += time.time() - t_epoch
                steady_epochs += 1
            first_epoch_done = True
            stats.add_result(idx, (ev["train_metric"], ev["val_metric"],
                                   ev["test_metric"]))
            if ev["val_metric"] > best_val:
                best_val = ev["val_metric"]
                if checkpoint_dir is not None:
                    save_checkpoint(f"{checkpoint_dir}/split{idx}_best",
                                    model.state_dict(), step=epoch,
                                    extra={"val_metric": best_val})
            if logger is not None and epoch % display_step == 0:
                logger.info(
                    "split %d epoch %d: loss %.4f train %.4f val %.4f "
                    "test %.4f", idx, epoch, loss, ev["train_metric"],
                    ev["val_metric"], ev["test_metric"])
            if (checkpoint_every and last_path is not None
                    and (epoch + 1) % checkpoint_every == 0):
                save_state(epoch + 1)
        if (checkpoint_every and last_path is not None
                and start_epoch < cfg.epochs):
            save_state(cfg.epochs)
    summary = stats.summary()
    elapsed = time.time() - t_total
    epochs_total = cfg.num_splits * cfg.epochs
    out = {
        "dataset": data.name,
        "model": cfg.model_type,
        "test_mean": summary["test_mean"],
        "test_std": summary["test_std"],
        "valid_mean": summary["valid_mean"],
        "valid_std": summary["valid_std"],
        "per_split": [s["final_test"] for s in summary["per_run"]],
        "epochs_total": epochs_total,
        "runtime_s": elapsed,
        "epoch_ms_avg": 1000.0 * elapsed / max(epochs_total, 1),
        "epoch_ms_steady": (1000.0 * steady_time / steady_epochs
                            if steady_epochs else None),
    }
    if logger is not None:
        logger.log_result(out)
    return out
