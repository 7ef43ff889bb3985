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
body carries a ``SplitState`` on the device, and compiles it once a
(dataset, config, dropout).  Here the loop body keeps the same state on
the device (``LoopState``) and updates it in place, so no body waits for
the host; on the card the runner captures one body as a CUDA graph once
a run and runs a split (or a checkpoint segment) to its stop rule in one
launch of a device loop around it (``make_split_runner``, ``Replay``,
``ops/loop.py``); the stepwise path captures its epoch likewise and
replays it once an epoch.  Dropout draws from counter-based keys
(``ops/dropout.py``: seed, rank, epoch, site), as JAX's ``fold_in(key,
epoch)``, and the learning rate and weight decay are device tensors, so
one capture serves every split, segment and (lr, wd) of a dropout value.
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
from torch.utils._python_dispatch import TorchDispatchMode
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
from acmgnn_tpu_torch.ops.dropout import DropoutKey
from acmgnn_tpu_torch.ops.graph import (
    GraphData,
    Operators,
    locality_order,
    permute_graph,
    precompute_operators,
)
from acmgnn_tpu_torch.ops.loop import DeviceLoop, count_bodies, node_types
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
from acmgnn_tpu_torch.utils import profiling
from acmgnn_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from acmgnn_tpu_torch.utils.logging import RunStats
from acmgnn_tpu_torch.utils.profiling import span
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

    The learning rate and the weight decay are device data, written in
    place by ``set_hparams`` (``_HparamForm``), so one captured step serves
    every (lr, wd), as JAX's traced ``hparams`` do.

    ``capturable`` (None: whether a parameter lies on the card) is the
    card's form: torch's capturable multi-tensor Adam arithmetic, with
    the step count and bias corrections on the device in f32 (optax's
    form as well), which a CUDA graph captures; on the card every step
    runs it, eager or replayed, and ``capturable=True`` runs the same
    arithmetic on CPU parameters (the CPU references of the card checks).
    Without it torch's own step forms the bias corrections on the host in
    f64."""
    params = list(params)
    lr = cfg.lr if lr is None else float(lr)
    wd = cfg.weight_decay if weight_decay is None else float(weight_decay)
    if capturable is None:
        capturable = any(p.is_cuda for p in params)
    if cfg.optimizer not in _HPARAM_FORMS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return _HPARAM_FORMS[cfg.optimizer](params, lr, wd, capturable=capturable)


class _HparamForm:
    """Adam (coupled L2) or, ``decoupled``, AdamW (mixed into torch's
    class), whose learning rate and weight decay live in a device tensor
    the step reads, ``hp = [1/lr, decay]`` in f32, each rounded once from
    its f64 value on the host:

    - ``1/lr``: torch's capturable step divides the bias correction by a
      Python ``lr``, and a CUDA foreach division by a number is a
      multiply by ``f32(1/lr)`` (H100, torch 2.11: bit for bit); the card
      form multiplies by ``hp[0]`` on either device, so it runs the
      card's arithmetic on the CPU too, whose own foreach divides;
    - ``decay``: the decoupled factor ``1 - lr·wd``, multiplied into the
      parameters before the step (torch AdamW's order and rounding), or
      the coupled L2 ``wd``, added to the gradient before the step as
      ``addcmul(g, p, wd)`` with ``wd`` also filled into one tensor per
      parameter (``wd_full``, so the add is one multi-tensor launch),
      which rounds as torch's ``add(g, p, alpha=wd)`` (bit for bit on
      the H100 and on the CPU).

    So the card form is torch's capturable step with Python
    hyperparameters bit for bit on the card, and its host form torch's
    own step (tests/test_torch_hparams.py, the card's
    tests/test_torch_kernels.py).

    The card form (``capturable``) is torch's capturable multi-tensor
    step written out (``_card_step``); otherwise torch's own step runs
    with ``weight_decay=0`` after the decay.  ``group["lr"]`` holds the
    Python value."""

    decoupled = False

    def __init__(self, params, lr: float, weight_decay: float, *,
                 capturable: bool):
        params = list(params)
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=0.0, capturable=capturable,
                         foreach=True if capturable else None)
        self.hp = torch.zeros(2, dtype=torch.float32, device=params[0].device)
        # the coupled decay as a tensor a parameter: ``hp[1].expand_as(p)``
        # rounds alike but is a stride-0 view, which foreach ops refuse
        # for their multi-tensor kernel (ATen ForeachUtils.h: every tensor
        # non-overlapping and dense), so the add would be one launch a
        # parameter
        self.wd_full = ({} if self.decoupled else
                        {p: torch.empty_like(p) for g in self.param_groups
                         for p in g["params"]})
        self.set_hparams(lr, weight_decay)

    def set_hparams(self, lr: float, weight_decay: float) -> None:
        """New values written into ``hp`` (and ``group["lr"]``) in place."""
        lr, weight_decay = float(lr), float(weight_decay)
        if not lr > 0.0:
            raise ValueError(f"learning rate {lr} is not positive")
        for group in self.param_groups:
            group["lr"] = lr
        self.hp[0].fill_(1.0 / lr)
        self.hp[1].fill_(1.0 - lr * weight_decay if self.decoupled
                         else weight_decay)
        for t in self.wd_full.values():
            t.fill_(weight_decay)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if self.decoupled:
                torch._foreach_mul_(params, self.hp[1])
            else:
                torch._foreach_addcmul_([p.grad for p in params], params,
                                        [self.wd_full[p] for p in params])
            if group["capturable"]:
                self._card_step(group, params)
        if not self.param_groups[0]["capturable"]:
            super().step()
        return loss

    def _card_step(self, group, params) -> None:
        """torch's capturable multi-tensor Adam step (torch 2.11,
        ``torch/optim/adam.py`` ``_multi_tensor_adam``, its ``capturable``
        branch without ``amsgrad``, ``maximize`` or decay; the decay is
        applied before it), its division of the bias correction by ``lr``
        as the card carries it out.  A copy that must follow torch's:
        ``tests/test_torch_kernels.py``
        ``test_card_step_is_torchs_capturable_step`` holds it to torch's
        own capturable step bit for bit on the card, and fails when the
        two part."""
        beta1, beta2 = group["betas"]
        grads, exp_avgs, exp_avg_sqs, steps = [], [], [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = torch.zeros((), dtype=torch.float32,
                                         device=p.device)
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            grads.append(p.grad)
            exp_avgs.append(st["exp_avg"])
            exp_avg_sqs.append(st["exp_avg_sq"])
            steps.append(st["step"])
        torch._foreach_add_(steps, 1)
        torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
        bc1 = torch._foreach_pow(beta1, steps)
        bc2 = torch._foreach_pow(beta2, steps)
        torch._foreach_sub_(bc1, 1)
        torch._foreach_sub_(bc2, 1)
        torch._foreach_neg_(bc2)
        torch._foreach_mul_(bc1, self.hp[0])   # -(1 - beta1^t) / lr
        torch._foreach_reciprocal_(bc1)
        torch._foreach_sqrt_(bc2)
        denom = torch._foreach_sqrt(exp_avg_sqs)
        torch._foreach_div_(denom, bc2)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(denom, bc1)
        torch._foreach_addcdiv_(params, exp_avgs, denom)


class HparamAdam(_HparamForm, torch.optim.Adam):
    """torch Adam, coupled L2, with device hyperparameters
    (``_HparamForm``)."""


class HparamAdamW(_HparamForm, torch.optim.AdamW):
    """torch AdamW with device hyperparameters (``_HparamForm``)."""

    decoupled = True


_HPARAM_FORMS = {"adam": HparamAdam, "adamw": HparamAdamW}


def train_forward(model: ACMGNN, x, ops, key: Optional[DropoutKey], *,
                  paired_eval: bool = False, remat: bool = False):
    """The dropout train forward (with ``paired_eval``, also the eval
    logits of the same parameters), its dropout drawn under ``key``.

    ``remat`` (JAX ``jax.checkpoint`` around the train forward) runs it
    under non-reentrant activation checkpointing: the backward recomputes
    the forward instead of holding its activations.  The recompute draws
    the same masks with nothing restored: a mask is a function of the key
    and the site, and the recompute numbers its sites from 0 as the
    forward did."""

    def run(x_):
        return model(x_, ops, training=True, paired_eval=paired_eval,
                     key=key)

    if not remat:
        return run(x)
    calls = [0]

    def region(x_):
        calls[0] += 1
        if calls[0] == 1:
            return run(x_)
        # the recompute: BatchNorm's running statistics were updated once
        with batch_stats_frozen():
            return run(x_)

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
    """The loop's end state besides its ``SplitResult``: copies, which a
    later call of the runner does not overwrite."""

    epoch: int                     # bodies run (joint: epochs + 1 unstopped)
    train_losses: torch.Tensor     # every body's train loss
    val_hist: torch.Tensor         # every epoch's val loss
    opt_state: dict                # the optimizer's ``state_dict``
    capture_ms: Optional[float] = None   # host ms of this call's capture
    #                                      (None: it made none)
    setup_ms: Optional[float] = None     # host ms from the call to its first
    #                                      replay (eager: None)
    replays: int = 0                     # bodies that were replays
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

    def reset(self) -> None:
        """Back to ``initial``'s values, in place."""
        for t in (self.k, self.best_test_metric, self.val_hist,
                  self.train_losses, self.stop):
            t.zero_()
        self.best_val_loss.fill_(math.inf)
        self.best_val_metric.fill_(-math.inf)

    def copy_(self, other: "LoopState") -> None:
        """``other``'s values, in place."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))

    def clone(self, dev=None) -> "LoopState":
        """A copy (on ``dev``, or where it is)."""
        return LoopState(**{
            f.name: getattr(self, f.name).detach().to(dev, copy=True)
            for f in dataclasses.fields(self)})

    def result(self, joint: bool, bodies: Optional[int] = None
               ) -> "SplitResult":
        """The split's result after ``bodies`` bodies (default: read
        ``k`` on the host), in copies of the state's tensors."""
        if bodies is None:
            bodies = int(self.k)
        test, val, val_loss, train_loss = torch.stack([
            self.best_test_metric, self.best_val_metric, self.best_val_loss,
            self.train_losses[max(bodies - 1, 0)]]).unbind()   # one copy
        return SplitResult(
            test_metric=test, val_metric=val, val_loss=val_loss,
            train_loss=train_loss,
            epochs_run=max(bodies - 1, 0) if joint else bodies)


@dataclasses.dataclass
class RunnerState:
    """A split runner's whole state between two segments of one split
    (``make_split_runner``'s ``init_state``): the model's ``state_dict``
    (parameters and buffers), the optimizer's (Adam's moments and step)
    and the loop's device state.  Dropout carries no state: its keys are
    (seed, rank, epoch, site), the epoch the loop's ``k``, as JAX's
    ``fold_in(key, epoch)``.  Held as copies: running a segment from it
    leaves it as it was, so a failed segment can be run again."""

    variables: dict
    opt_state: dict
    loop: LoopState

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


class _NoRandomDraws(TorchDispatchMode):
    """Raises on any operation that draws from a torch generator
    (``torch.Tag.nondeterministic_seeded``: ``rand``, ``bernoulli``,
    ``native_dropout``, ...).  A graph replays such a draw with the
    generator's offset advanced only by ``replay()``'s host prologue, so
    inside a device loop every epoch would repeat one draw; the port's
    dropout draws through ``ops/dropout.py``'s keys instead."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise RuntimeError(
                f"{func} draws from a torch generator inside a captured "
                f"loop body: its replays would repeat one draw (dropout "
                f"draws through ops/dropout.py's counter-based keys)")
        return func(*args, **(kwargs or {}))


def no_random_draws():
    """The guard every capture runs its body under (``_NoRandomDraws``)."""
    return _NoRandomDraws()


def _capture(body, keep_graph: bool = False) -> kernels.CountedGraph:
    """``body`` captured once as a CUDA graph on the current stream, under
    ``no_random_draws`` (no generator state is registered with the graph,
    and nothing in the body may draw from one); ``keep_graph`` keeps the
    ``cudaGraph_t`` for a device loop (``ops/loop.py``) and instantiates
    nothing.  Unlike ``torch.cuda.graph``, no device-wide synchronize and
    no ``empty_cache`` come first: in a process holding a large cache they
    made a capture take 28-214 ms on an H100 (``chip_smoke.py`` 8b)."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)

    def record():
        graph.capture_begin()
        try:
            with no_random_draws():
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
        with span("runner.cache_release"):
            torch.cuda.empty_cache()


class Replay:
    """A loop body compiled once and replayed, as JAX runs a jitted one.

    On ``capture_on`` (a CUDA device; None: every body eagerly) the body
    runs on a side stream kept for the object's life: the first time
    eagerly (it makes, on that stream, what a capture needs to exist
    already: K2/K3's occupancy answers, K4's workspace, Adam's moments,
    cuBLAS's workspace), the second time captured once as a CUDA graph
    (``_capture``), and every later time, in this ``run`` or a later one,
    from that graph: with ``device_loop``, every body of a ``run`` after
    the eager first in ONE launch of a device loop around the graph
    (``ops/loop.DeviceLoop``: the condition ``k < limit and not stop``
    evaluated by K9 on the device after each body, JAX's
    ``lax.while_loop``), else one replay a body (the stepwise path).  So
    the body must read and write the same tensors for as long as the
    graph lives: its callers write each new input into them in place.

    A ``run`` that raised leaves its graph discarded: the next ``run``
    runs the body eagerly again and captures anew (a graph whose replay
    failed is never replayed again).  A failed capture or replay raises;
    nothing falls back to eager.  ``release`` discards the device loop,
    the graph and its private memory pool; so does dropping the object.

    With spans on (``utils/profiling.py``) a ``run`` records
    ``runner.first_body`` (synchronized at its end), ``runner.capture``
    (over ``runner.cache_release`` when the cache is emptied, and
    ``runner.loop_build``) and ``runner.loop`` (on the card's clock: the
    bodies after the eager first, through the host's read of ``k``), and
    counts ``loop_bodies`` and, at a looped capture, ``body_nodes``."""

    def __init__(self, capture_on):
        self.capture_on = capture_on
        self.side = (None if capture_on is None
                     else torch.cuda.Stream(device=capture_on))
        self.graph: Optional[kernels.CountedGraph] = None
        self.loop: Optional[DeviceLoop] = None
        self.warm = False      # the body ran eagerly on ``side``
        self.busy = False      # a ``run`` is under way, or raised

    def release(self) -> None:
        if self.loop is not None:
            self.loop.destroy()
        if self.graph is not None:
            self.graph.graph.reset()
        self.graph, self.loop, self.warm = None, None, False

    def run(self, body, limit: int, stop=None, t0: Optional[float] = None,
            device_loop=None):
        """``body`` up to ``limit`` times.  Eager (and for the eager first
        body): after each, the host reads ``stop`` (None: never) and ends
        the loop if it is set.  ``device_loop`` = (``k``, ``bound``,
        ``start``): the body's counter, the device int64 that ``k`` must
        stay under, and ``k``'s value when the call starts; on the card
        the bodies after the eager first then run in one device-loop
        launch, which stops at ``bound`` or ``stop``, and the host reads
        ``k`` once after it.  Returns (bodies run, of them replays, the
        capture's ms or None, set-up ms: the host's time from ``t0``
        (default: now) to the first replay or loop launch, or None)."""
        if self.busy:
            self.release()
        self.busy = True
        t0 = time.perf_counter() if t0 is None else t0
        bodies = replays = 0
        capture_ms = setup_ms = None
        looped = self.side is not None and device_loop is not None

        def halted():   # the host reads the flag (a device loop's K9 does)
            return stop is not None and not looped and bool(stop)

        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(self.capture_on))
        try:
            with (torch.cuda.stream(self.side) if self.side is not None
                  else contextlib.nullcontext()):
                if limit > 0 and not self.warm:
                    with span("runner.first_body", sync=True):
                        body()
                    self.warm = True
                    bodies = 1
                more = bodies < limit and not (bodies and halted())
                if more and self.side is not None:
                    if self.graph is None:
                        capture_ms = self._capture(body, looped, device_loop,
                                                   stop)
                    setup_ms = 1e3 * (time.perf_counter() - t0)
                first = bodies
                if more:
                    with span("runner.loop", device=True):
                        if looped:
                            k, _, start = device_loop
                            self.loop.launch()
                            replays = int(k) - start - bodies   # one read
                            self.graph.ran(replays)
                            count_bodies(replays)
                            bodies += replays
                        else:
                            while bodies < limit:
                                if self.side is None:
                                    body()
                                else:
                                    self.graph.replay()
                                    replays += 1
                                bodies += 1
                                if halted():
                                    break
                    profiling.count("loop_bodies", bodies - first)
        finally:
            # raised or not: what the caller writes next (a retry rewrites
            # the parameters and moments in place) waits for every body
            # already issued on the side stream
            if self.side is not None:
                torch.cuda.current_stream(self.capture_on).wait_stream(
                    self.side)
        self.busy = False
        return bodies, replays, capture_ms, setup_ms

    def _capture(self, body, looped: bool, device_loop, stop) -> float:
        """The body captured (and, ``looped``, the device loop built around
        it); returns the capture's host ms.  With spans on, counts the
        captured body's kernel, memcpy and memset nodes (``body_nodes``)
        after the timed part."""
        t1 = time.perf_counter()
        with span("runner.capture"):
            _room_for_capture(self.capture_on)
            self.graph = _capture(body, keep_graph=looped)
            if looped:
                with span("runner.loop_build"):
                    k, bound, _ = device_loop
                    self.loop = DeviceLoop(self.graph.graph, k, bound, stop)
        capture_ms = 1e3 * (time.perf_counter() - t1)
        if looped and profiling.spans_enabled():
            profiling.count("body_nodes", sum(
                t in ("kernel", "memcpy", "memset")
                for t in node_types(self.graph.graph)))
        return capture_ms


def initial_params(cfg: TrainConfig, nfeat: int, nclass: int, *, seed: int,
                   nnodes: Optional[int] = None) -> dict:
    """The initial parameters and buffers of the split seeded ``seed``
    (JAX's ``variables``): ``build_model(..., seed=seed)``'s
    ``state_dict``, drawn on the host (the draw does not depend on the
    device)."""
    return build_model(cfg, nfeat, nclass, device="cpu", seed=seed,
                       nnodes=nnodes).state_dict()


def set_optimizer_state(opt: torch.optim.Optimizer,
                        state: Optional[dict] = None) -> None:
    """``opt``'s state set in place: zeroed (Adam's moments and step, as a
    fresh optimizer's first step makes them) or copied from ``state``, an
    optimizer ``state_dict``.  The tensors keep their storage, so a
    captured step replays on them; an optimizer that has taken no step
    yet loads ``state`` instead."""
    src = {} if state is None else state["state"]
    if not opt.state:
        if src:
            opt.load_state_dict(copy.deepcopy(state))
        return
    params = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        mine = opt.state.get(p, {})
        if i in src and mine.keys() != src[i].keys():
            raise ValueError(f"optimizer state of parameter {i} has "
                             f"{sorted(src[i])}, in place {sorted(mine)}")
        for key, t in mine.items():
            if i in src:
                t.copy_(src[i][key])
            else:
                t.zero_()


@dataclasses.dataclass
class _Kept:
    """What a split runner keeps across its calls (``make_split_runner``):
    the tensors its body reads and writes, the body and its ``Replay``."""

    key: tuple        # (ops, x, labels, labels_onehot)
    drop: DropoutKey  # the seed tensor (per split); its epoch is state.k
    opt: torch.optim.Optimizer   # its lr and weight decay in tensors
    state: LoopState
    limit: torch.Tensor          # int64: the bound k stays under this call
    masks: tuple
    packed: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    loop: Replay
    body: object
    cause: str        # why its capture is (to be) made

    def same(self, key) -> bool:
        """Whether a call with ``key`` runs the same program: the same
        objects (the hparams are data: ``set_hparams``)."""
        return all(a is b for a, b in zip(self.key, key))


def make_split_runner(model: ACMGNN, cfg: TrainConfig, joint=None,
                      group=None, graph: bool = True,
                      capturable: Optional[bool] = None):
    """``run(ops, x, labels, masks, seed=0, return_state=False,
    labels_onehot=None, hparams=None, init_params=None, init_state=None,
    epoch_limit=None)`` — one split's training from the model's current
    parameters, or from ``init_params``, a ``state_dict`` that the model
    loads first (JAX's ``variables``); the joint loop for joint-capable
    models when ``cfg.joint``, else the sequential one.
    ``labels_onehot`` is the BCE target, ``prepare_data``'s
    ``labels_onehot``; ``hparams``, an ``(lr, weight_decay)`` pair, runs
    the optimizer with those values in place of the config's (written
    into its tensors: ``make_optimizer``).  With ``cfg.remat`` the train
    forward runs under activation checkpointing (``train_forward``).
    Dropout draws under the key (``seed``, rank, epoch ``k``, site)
    (``ops/dropout.py``), as JAX's ``fold_in(key, k)``: the sequential
    body ``k`` and the joint body ``k`` each train epoch ``k``.

    Segments (JAX's ``init_state`` / ``epoch_limit``): the loop runs while
    its body counter is under ``epoch_limit`` (and its budget: ``epochs``,
    the joint loop's ``epochs + 1``), and with ``return_state`` returns
    the ``RunnerState`` the next segment starts from (``SplitState.runner``);
    ``init_state``, such a state, restores the model's
    parameters and buffers, the optimizer and the loop state first (the
    dropout keys follow from ``k``), so a split run in segments equals
    the uninterrupted run bit for bit, and a segment run twice from one
    state gives the same result.

    The loop body is JAX's (``acmgnn_tpu/train/trainer.py:234-305``,
    ``:338-426``): it keeps the split's state on the device
    (``LoopState``) and calls nothing that waits for the card.  With
    ``graph`` (the default), on a CUDA device the runner is compiled once,
    as ``jax.jit(make_split_runner(...))`` is: its first body runs
    eagerly, the second is captured once as a ``torch.cuda.CUDAGraph``,
    and every call then runs its bodies in ONE launch of a device loop
    around that graph, whose condition ``k < limit and not stop`` K9
    evaluates on the device after each body (``Replay``,
    ``ops/loop.py``; JAX's ``lax.while_loop``); the host reads ``k`` once
    after it.  ``graph=False`` runs every body eagerly from a host loop
    that reads the stop flag after each body (the same body: the card
    tests and ``chip_smoke.py`` hold the two forms equal bit for bit).  ``capturable`` is ``make_optimizer``'s: True on the
    CPU runs the card's optimizer arithmetic there.

    Kept across calls: the optimizer (its lr and weight decay in
    tensors), the dropout key's seed tensor, the ``LoopState``, the loop's
    bound and buffers of the split's masks, packed label/mask words and
    mask counts, all made by the first call.  A later call (a new split,
    a new segment, other ``hparams``) writes its inputs into those
    tensors in place: the parameters (``init_params``, ``init_state``),
    the optimizer's moments and step (zeroed, or ``init_state``'s:
    ``set_optimizer_state``), its lr and weight decay, the loop state, the
    masks, the words, the counts and the seed, then runs from its first
    body.  The runner is made anew, with a new capture, only when the
    captured program would differ: another ``ops``, ``x``, ``labels`` or
    ``labels_onehot`` object; ``run.captures`` records why each capture
    was made, and ``run.kept()`` returns what it keeps (None before the
    first call).  A call that raised (a retry under ``retry_transient``)
    leaves the capture discarded: the next call runs its first body
    eagerly and captures anew.  ``run.release()`` discards the capture
    and its memory pool; dropping the runner does too.  The results a
    call returns are copies, which a later call does not overwrite.

    Eager by rule: the CPU, and a gloo group, whose collectives run on
    the host (``capture_device``).  A sharded run on NCCL is captured as
    one card's: the collectives, the K6 packs and exchanges and ROC-AUC's
    gathered logits with K4 are recorded in the graph, and the eager
    first body creates the NCCL communicator.  In the eager form, with
    ``cfg.early_stopping`` the host reads the stop flag once after every
    body; in the captured form the device loop reads it.
    ``kernels.launches`` counts the launches that ran
    (``kernels.CountedGraph``, K9's ``count_bodies``).

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
    reads the same stop flag.  Dropout's key holds the rank, so each
    rank's slab draws its own masks.  ROC-AUC ranks all nodes on every rank: each rank
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
        with span("body.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:
                flat = all_reduce_sum(torch.cat(
                    [p.grad.reshape(-1) for p in params] + [shares]), group)
                *grads, shares = flat.split([p.numel() for p in params]
                                            + [shares.numel()])
                for p, g in zip(params, grads):
                    p.grad = g.view_as(p)
        with span("body.step"):
            opt.step()
        return shares

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

    live: Optional[_Kept] = None   # what the runner keeps across calls
    captures = []                  # why each capture was made

    def start(body_of, key, masks, seed, cause):
        """The runner's tensors and body for ``key``'s inputs, the split's
        masks (copied: later splits are written into them) and ``seed``."""
        ops, x, labels, labels_onehot = key
        dev = x.device
        opt = make_optimizer(cfg, params, capturable=capturable)
        masks = tuple(m.clone() for m in masks)
        packed = packed_words(labels, masks, labels_onehot)
        counts = global_counts(masks)
        state = LoopState.initial(epochs, dev)
        drop = DropoutKey.new(seed, _rank_and_world(group)[0], state.k)
        return _Kept(key=key, drop=drop, opt=opt, state=state,
                     limit=torch.zeros((), dtype=torch.int64, device=dev),
                     masks=masks, packed=packed, counts=counts,
                     loop=Replay(capture_device(dev, group, graph)),
                     body=body_of(state, drop, opt, masks, packed, counts),
                     cause=cause)

    def rewrite(lv, masks, seed):
        """A new split's inputs written into ``lv``'s tensors, its state
        back to a fresh runner's."""
        for buf, m in zip(lv.masks, masks):
            buf.copy_(m)
        packed = packed_words(lv.key[2], masks, lv.key[3])
        if packed is not None:
            lv.packed.copy_(packed)
        counts = global_counts(masks)
        if counts is not None:
            lv.counts.copy_(counts)
        lv.drop.set_seed(seed)
        set_optimizer_state(lv.opt)
        lv.state.reset()

    def release():
        """Discard the capture and what the runner keeps."""
        nonlocal live
        if live is not None:
            live.loop.release()
        live = None

    def drive(body_of, budget, ops, x, labels, masks, seed, return_state,
              labels_onehot, hparams, init_params, init_state, epoch_limit):
        """The runner's tensors set up or rewritten for this call, the
        model and state set from ``init_params`` / ``init_state``, the loop
        up to ``budget`` bodies in all (or to ``epoch_limit``), and the
        results; ``body_of(state, drop, opt, masks, packed, counts)``
        makes the body."""
        nonlocal live
        t0 = time.perf_counter()
        key = (ops, x, labels, labels_onehot)
        fresh = live is None or not live.same(key)
        with span("runner.start" if fresh else "runner.rewrite"):
            if fresh:
                cause = ("the first call" if live is None else
                         "other ops, x or labels")
                release()
                live = start(body_of, key, masks, seed, cause)
            else:
                if live.loop.busy:
                    live.cause = "a retry: the last call raised"
                rewrite(live, masks, seed)
            lv = live
            lv.opt.set_hparams(*((cfg.lr, cfg.weight_decay) if hparams is None
                                 else map(float, hparams)))
            if init_params is not None:
                model.load_state_dict(init_params)
            if init_state is not None:
                model.load_state_dict(init_state.variables)
                set_optimizer_state(lv.opt, init_state.opt_state)
                lv.state.copy_(init_state.loop)
            limit = budget if epoch_limit is None else min(int(epoch_limit),
                                                            budget)
            done = 0 if init_state is None else init_state.bodies
            if init_state is not None and bool(init_state.loop.stop):
                limit = done
            lv.limit.fill_(limit)
        ran, replays, capture_ms, setup_ms = lv.loop.run(
            lv.body, max(limit - done, 0), lv.state.stop if es else None, t0,
            device_loop=(lv.state.k, lv.limit, done))
        if capture_ms is not None:
            captures.append(lv.cause)
        with span("runner.results"):
            lv.opt.zero_grad(set_to_none=True)   # frees the graph's gradients
            bodies = done + ran
            result = lv.state.result(joint, bodies)
            if not return_state:
                return result
            opt_state = copy.deepcopy(lv.opt.state_dict())
            runner = None
            if epoch_limit is not None:   # a segment: the next one's start
                runner = RunnerState(
                    variables={k: v.detach().clone()
                               for k, v in model.state_dict().items()},
                    opt_state=opt_state, loop=lv.state.clone())
            return result, SplitState(
                epoch=bodies,
                train_losses=lv.state.train_losses[:bodies].clone(),
                val_hist=lv.state.val_hist[:result.epochs_run].clone(),
                opt_state=opt_state, capture_ms=capture_ms, setup_ms=setup_ms,
                replays=replays, runner=runner)

    def run(ops, x, labels, masks, seed: int = 0,
            return_state: bool = False, labels_onehot=None, hparams=None,
            init_params=None, init_state=None, epoch_limit=None):
        """Sequential loop: each epoch trains, then evaluates the updated
        parameters in a separate forward; stops after ``epochs`` or when
        the early-stopping rule fires (that epoch counts)."""

        def body_of(s, drop, opt, masks, packed, counts):
            def body():
                with span("body.forward"):
                    logits = train_forward(model, x, ops, drop,
                                           remat=cfg.remat)
                    loss = loss_of(logits, labels, labels_onehot, masks[0],
                                   None if counts is None else counts[0])
                # sharded: the train-loss share rides the gradients'
                # all-reduce, the eval shares take a second one
                summed = step(opt, loss, None if group is None
                              else loss.detach().reshape(1))
                loss = loss.detach() if summed is None else summed[0]
                with span("body.eval"), torch.no_grad():
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

        with span("runner.call"):
            return drive(body_of, epochs, ops, x, labels, masks, seed,
                         return_state, labels_onehot, hparams, init_params,
                         init_state, epoch_limit)

    def run_joint(ops, x, labels, masks, seed: int = 0,
                  return_state: bool = False, labels_onehot=None,
                  hparams=None, init_params=None, init_state=None,
                  epoch_limit=None):
        """Iteration k evaluates epoch k-1 (parameters after k updates)
        and trains epoch k in one paired forward; ``epochs + 1``
        iterations, the first one's evaluation is skipped.  An iteration
        whose evaluation fires the early-stopping rule still applies its
        update, then the loop ends."""

        def body_of(s, drop, opt, masks, packed, counts):
            def body():
                with span("body.forward"):
                    logits_train, logits_eval = train_forward(
                        model, x, ops, drop, paired_eval=True,
                        remat=cfg.remat)
                    loss_share = loss_of(logits_train, labels, labels_onehot,
                                         masks[0], None if counts is None
                                         else counts[0])
                    with torch.no_grad():
                        shares = shares_of(logits_eval, labels,
                                           labels_onehot, masks, counts,
                                           loss_share)
                # sharded: one all-reduce, the shares behind the gradients
                shares = step(opt, loss_share, shares)
                with span("body.eval"), torch.no_grad():
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

        with span("runner.call"):
            return drive(body_of, epochs + 1, ops, x, labels, masks, seed,
                         return_state, labels_onehot, hparams, init_params,
                         init_state, epoch_limit)

    runner = run_joint if joint else run
    runner.release, runner.captures = release, captures
    runner.kept = lambda: live
    runner.model = model
    return runner


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
    with span("prepare_data", sync=True):
        with span("prepare.load"):
            data = maybe_reorder(load_graph(dataset, cfg), cfg)
        with span("prepare.operators"):
            ops = precompute_operators(
                data.adj, normalization=cfg.normalization,
                hops=cfg.hops if cfg.model_type in ("acmsgc", "sgc") else 1,
                structure_info=cfg.structure_info, fmt=cfg.operator_format,
                spmm_dtype=_DTYPES[cfg.spmm_dtype],
            ).to(dev)
        with span("prepare.features"):
            features = data.features
            if cfg.resolve_feature_normalize():
                features = row_normalize_features(features)
            labels = _host_labels(data.labels)
            nclass = data.num_classes
            labels_onehot = _one_hot(labels, nclass)
            x = _features_on(torch.from_numpy(
                np.ascontiguousarray(features, np.float32)), cfg, dev)
            y = torch.from_numpy(labels.astype(np.int64)).to(dev)
            y1h = torch.from_numpy(labels_onehot).to(dev)
        if cfg.resolve_hoist():
            with span("prepare.hoist"):
                # Â X once, through the same gather as the model's (the
                # eval forward's layer-1 aggregate; exact for training at
                # dropout 0)
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

    Every rank calls it with the same arguments.  The run builds its model
    and its split runner once (JAX jits its runner once): split ``idx``
    takes its masks from ``resolve_split`` (random ones from
    ``numpy.random.default_rng(cfg.seed)``) and starts from
    ``build_model(..., seed=cfg.seed + idx)``'s parameters on every rank
    (``initial_params``, the runner's ``init_params``; the structure
    channel's embedding has the graph's N rows, each rank gathering from
    its own), so the replicas start equal; ``make_split_runner`` keeps
    them equal.  On NCCL every split and every checkpoint segment after
    the first replays the run's one capture.
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
    model's ``state_dict``, the optimizer's, the loop state; the dropout
    keys follow from the loop's ``k``); ``resume`` continues each split
    from it, equal bit for bit to the uninterrupted run.  (Without ``checkpoint_every`` nothing is saved,
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
    nfeat, nnodes = prep.x.shape[1], prep.data.num_nodes
    model = build_model(cfg, nfeat, prep.nclass, device=dev, seed=cfg.seed,
                        nnodes=nnodes)
    runner = make_split_runner(model, cfg, group=group)
    results = []
    t_total = time.time()
    steady_time = 0.0
    steady_epochs = 0
    for idx in range(cfg.num_splits):
        with span("split"):
            with span("split.prepare"):
                masks = tuple(prep.place(m) for m in resolve_split(
                    prep.data, cfg, idx, masks_rng, labels_np, prep.nclass))
                init = initial_params(cfg, nfeat, prep.nclass,
                                      seed=cfg.seed + idx, nnodes=nnodes)
            args = (prep.ops, prep.x, prep.labels, masks)
            kwargs = dict(seed=cfg.seed + idx,
                          labels_onehot=prep.labels_onehot)
            t_split = time.time()
            if checkpointing:
                res = _segmented_split(
                    runner, model, init, args, kwargs, budget, joint,
                    checkpoint_every, f"{checkpoint_dir}/split{idx}", resume,
                    prep.rank, dev, logger, agree)
            else:
                def run_once():
                    out = runner(*args, **kwargs, init_params=init)
                    _sync(dev)
                    return out

                res = retry_transient(run_once, logger=logger, agree=agree)()
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


def _segmented_split(runner, model, init, args, kwargs, budget: int,
                     joint: bool, every: int, prefix: str, resume: bool,
                     rank: int, dev, logger, agree):
    """One split of ``run_experiment_sharded`` in ``every``-body segments
    (the JAX package's ``run_segment`` loop), each a call of the run's
    ``runner`` (which replays the run's capture): the zero-body state
    first (the split's initial parameters ``init``, moments and loop
    state), or the snapshot at ``prefix`` when resuming; then
    segment after segment until the budget or the stop flag, each
    snapshotted.  Leaves the split's final parameters in ``model`` and
    returns its result."""

    def run_segment(init_state, limit):
        _, st = runner(*args, **kwargs, epoch_limit=limit, return_state=True,
                       init_params=init if init_state is None else None,
                       init_state=init_state)
        _sync(dev)
        return st.runner

    run_segment = retry_transient(run_segment, logger=logger, agree=agree)
    state = run_segment(None, 0)
    state_path = f"{prefix}_state"
    if resume and Path(state_path).exists():
        state = _restore_segment(state_path, dev)
        if logger is not None:
            logger.info("%s: resumed after %d bodies", prefix, state.bodies)
    while not bool(state.loop.stop) and state.bodies < budget:
        state = run_segment(state, state.bodies + every)
        if rank == 0:
            save_checkpoint(state_path, state.variables,
                            opt_state=state.opt_state, step=state.bodies,
                            extra={"loop": dataclasses.asdict(state.loop)})
    model.load_state_dict(state.variables)
    return state.loop.result(joint)


def _restore_segment(state_path: str, dev) -> RunnerState:
    """A ``RunnerState`` from rank 0's snapshot."""
    snap = restore_checkpoint(state_path, map_location=dev)
    return RunnerState(variables=snap["variables"],
                       opt_state=snap["opt_state"],
                       loop=LoopState(**snap["extra"]["loop"]))


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
                   split_runner=None, device=None) -> dict:
    """Multi-split experiment, the counterpart of the JAX package's
    ``run_experiment``: returns its result dict (test mean/std, per-split
    test metrics, epochs, run time, ``epoch_ms_avg`` and
    ``epoch_ms_steady`` over the splits after the first).

    The run builds its model and its split runner once, as JAX jits its
    runner once outside the split loop: split ``idx`` takes its masks
    from ``splits[idx]`` or ``resolve_split`` (random ones from
    ``numpy.random.default_rng(cfg.seed)``), loads
    ``build_model(..., seed=cfg.seed + idx)``'s parameters into the model
    (``initial_params``: JAX's per-split ``variables``) and runs, under
    ``retry_transient``, from them; on the card every split after the
    first replays the first split's capture.  The reuse hooks keep the
    JAX package's meaning: ``prepared`` is ``prepare_data``'s output
    (skips preprocessing); ``runner(model, ops, x, labels, masks, *,
    seed, labels_onehot, hparams)`` runs one split from the model's
    current parameters (the split's initial ones) in place of the run's
    split runner; ``hparams = (lr, weight_decay)`` runs the optimizer with
    those values in place of the config's (written into the runner's
    optimizer tensors).  ``split_runner``, a ``make_split_runner`` runner
    kept across runs (the sweep keeps one a dropout value), takes the
    place of the run's own: its model takes each split's initial
    parameters, and the run builds no model and no runner.  ``logger``: an
    ``ExperimentLogger`` or any object with its ``info`` / ``log_split`` /
    ``log_result``."""
    data, ops, x, labels, labels_onehot, nclass = (
        prepared if prepared is not None
        else prepare_data(dataset, cfg, device=device))
    dev = x.device
    nfeat, nnodes = x.shape[1], x.shape[0]
    if split_runner is not None:
        model = split_runner.model
    else:
        model = build_model(cfg, nfeat, nclass, device=dev, seed=cfg.seed,
                            nnodes=nnodes)
    if runner is None:
        split_runner = split_runner or make_split_runner(model, cfg)

        def runner(model, *args, **kwargs):
            return split_runner(*args, **kwargs)
    rng = np.random.default_rng(cfg.seed)
    labels_np = _host_labels(data.labels)
    results = []
    t_total = time.time()
    steady_time = 0.0
    steady_epochs = 0
    for idx in range(cfg.num_splits):
        with span("split"):
            with span("split.prepare"):
                if splits is not None:
                    split = splits[idx]
                else:
                    split = resolve_split(data, cfg, idx, rng, labels_np,
                                          nclass)
                masks = tuple(torch.as_tensor(np.asarray(m)).to(dev)
                              for m in split)
                init = initial_params(cfg, nfeat, nclass,
                                      seed=cfg.seed + idx, nnodes=nnodes)
            t_split = time.time()

            def run_once():
                model.load_state_dict(init)
                res = runner(model, ops, x, labels, masks,
                             seed=cfg.seed + idx,
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

    - ``train_epoch(opt, key, ops, x, labels, labels_onehot,
      train_mask)``: one dropout forward under ``key``
      (``ops/dropout.DropoutKey``: the split's seed, the epoch;
      checkpointed with ``cfg.remat``), backward and optimizer step, in
      place; returns the train loss;
    - ``eval_epoch(ops, x, labels, labels_onehot, masks, packed)``: one
      eval forward; ``{"train_metric", "val_metric", "test_metric",
      "val_loss"}`` (ROC-AUC: one score sort serves the three masks;
      ``packed``: the split's ``pack_labels_and_masks(labels, masks)``,
      None for accuracies).

    Neither waits for the card, so ``run_experiment_stepwise`` captures
    the pair as one CUDA graph."""
    use_bce = cfg.loss == "bce"
    use_rocauc = cfg.metric == "rocauc"

    def loss_of(logits, labels, labels_onehot, mask):
        if use_bce:
            return masked_bce_with_logits(logits, labels_onehot, mask)
        return masked_nll(torch.log_softmax(logits, dim=1), labels, mask)

    def train_epoch(opt, key, ops, x, labels, labels_onehot, train_mask):
        logits = train_forward(model, x, ops, key, remat=cfg.remat)
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


# the stepwise epoch's readings, in the order of its device buffer
EPOCH_READS = ("loss", "train_metric", "val_metric", "test_metric",
               "val_loss")


def run_experiment_stepwise(dataset: GraphData | str, cfg: TrainConfig, *,
                            splits=None, logger=None, display_step: int = 25,
                            checkpoint_dir: Optional[str] = None,
                            checkpoint_every: int = 0, resume: bool = False,
                            device=None, graph: bool = True) -> dict:
    """Observable multi-split run (JAX ``run_experiment_stepwise``): every
    epoch trains, then evaluates, and the host reads the epoch's loss and
    metrics; ``RunStats`` collects (train, val, test) per epoch, and a
    split's test metric is the one at its best-val epoch.

    Set up once per run, as JAX jits ``train_epoch`` and ``eval_epoch``
    once: the model, the optimizer, the dropout key and the epoch
    functions.
    Split ``idx`` loads ``build_model(..., seed=cfg.seed + idx)``'s
    parameters into the model (``initial_params``), zeroes the optimizer's
    state in place and writes its masks (as in ``run_experiment``) and
    packed label/mask words into the run's buffers.  One epoch, the train
    step then the eval forward, writes its loss and four metrics into one
    device buffer, which the host reads once after the epoch.  With
    ``graph`` (the default) on the card the epoch is one CUDA graph
    (``Replay``): the run's first executed epoch runs eagerly, the second
    is captured, and every later epoch, of every split, replays it;
    ``graph=False`` (and the CPU) runs the same epoch eagerly.  Dropout
    draws under the key (``cfg.seed + idx``, rank 0, epoch, site), the
    epoch written into its device tensor before each epoch: JAX's
    ``fold_in(run_key, epoch)``, so an epoch draws the same masks however
    it is reached, and the same masks as ``run_experiment``'s sequential
    loop in the same split.
    ``epoch_ms_steady`` leaves out the epochs that pay set-up: the eager
    first epoch and the capturing one (without a capture, the first
    executed epoch).

    Each epoch runs under ``retry_transient``; it trains in place, so a
    retry continues from the parameters the failed attempt left (JAX's
    epoch is a pure function of its inputs), and the retried epoch runs
    eagerly and the next one captures anew.

    Checkpointing (``utils/checkpoint.py``): ``checkpoint_dir`` saves the
    best-val weights of split ``idx`` (``split<idx>_best``: the model's
    ``state_dict``, BatchNorm statistics included); ``checkpoint_every=k``
    also snapshots the whole training state (``split<idx>_last``: weights,
    the optimizer's state with its step count, the epochs done and the
    best val metric; ``split<idx>_history.npy``: the per-epoch metrics)
    every k epochs and at the split's end, and ``resume`` copies it into
    the run's tensors and continues: a resumed run equals the
    uninterrupted one bit for bit."""
    data, ops, x, labels, labels_onehot, nclass = prepare_data(
        dataset, cfg, device=device)
    dev = x.device
    nfeat, nnodes = x.shape[1], x.shape[0]
    model = build_model(cfg, nfeat, nclass, device=dev, seed=cfg.seed,
                        nnodes=nnodes)
    opt = make_optimizer(cfg, list(model.parameters()))
    train_epoch, eval_epoch = make_epoch_fns(model, cfg)
    key = DropoutKey.new(cfg.seed, 0, torch.zeros((), dtype=torch.int64,
                                                  device=dev))
    loop = Replay(capture_device(dev, graph=graph))
    reads = torch.zeros(len(EPOCH_READS), dtype=torch.float64, device=dev)
    bufs = []        # the split's masks and packed words, written in place

    def one_epoch():
        masks, packed = bufs
        loss = train_epoch(opt, key, ops, x, labels, labels_onehot,
                           masks[0])
        ev = eval_epoch(ops, x, labels, labels_onehot, masks, packed)
        reads.copy_(torch.stack([
            v.reshape(()).to(torch.float64)
            for v in (loss, *(ev[k] for k in EPOCH_READS[1:]))]))

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
        if not bufs:
            bufs += [tuple(m.clone() for m in masks), packed]
        else:
            for buf, m in zip(bufs[0], masks):
                buf.copy_(m)
            if packed is not None:
                bufs[1].copy_(packed)
        model.load_state_dict(initial_params(
            cfg, nfeat, nclass, seed=cfg.seed + idx, nnodes=nnodes))
        set_optimizer_state(opt)
        key.set_seed(cfg.seed + idx)
        best_val = -math.inf
        start_epoch = 0
        last_path = hist_path = None
        if checkpoint_dir is not None:
            last_path = f"{checkpoint_dir}/split{idx}_last"
            hist_path = f"{checkpoint_dir}/split{idx}_history.npy"
        if resume and last_path is not None and Path(last_path).exists():
            snap = restore_checkpoint(last_path, map_location=dev)
            model.load_state_dict(snap["variables"])
            set_optimizer_state(opt, snap["opt_state"])
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

        for e in range(start_epoch, cfg.epochs):

            def do_epoch():
                key.epoch.fill_(e)
                _, replays, capture_ms, _ = loop.run(one_epoch, 1)
                return replays, capture_ms, reads.tolist()

            t_epoch = time.time()
            replays, capture_ms, vals = retry_transient(do_epoch,
                                                        logger=logger)()
            # the epochs that pay set-up: the eager first and the capture
            if loop.side is not None:
                set_up = capture_ms is not None or not replays
            else:
                set_up = not first_epoch_done
            if not set_up:
                steady_time += time.time() - t_epoch
                steady_epochs += 1
            first_epoch_done = True
            loss, *metrics = vals
            ev = dict(zip(EPOCH_READS[1:], metrics))
            stats.add_result(idx, (ev["train_metric"], ev["val_metric"],
                                   ev["test_metric"]))
            if ev["val_metric"] > best_val:
                best_val = ev["val_metric"]
                if checkpoint_dir is not None:
                    save_checkpoint(f"{checkpoint_dir}/split{idx}_best",
                                    model.state_dict(), step=e,
                                    extra={"val_metric": best_val})
            if logger is not None and e % display_step == 0:
                logger.info(
                    "split %d epoch %d: loss %.4f train %.4f val %.4f "
                    "test %.4f", idx, e, loss, ev["train_metric"],
                    ev["val_metric"], ev["test_metric"])
            if (checkpoint_every and last_path is not None
                    and (e + 1) % checkpoint_every == 0):
                save_state(e + 1)
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
