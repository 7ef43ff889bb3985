"""Training harness — counterpart of ``acmgnn_tpu/train/trainer.py``.

Ported so far: ``make_split_runner``'s two loops with torch-style Adam
(coupled L2), the NLL or BCE loss, accuracy or ROC-AUC, best-val
selection and the early-stopping window:

- ``run_joint``, where epoch k's dropout train forward and epoch k-1's
  eval forward share one paired pass and every sparse gather;
- ``run``, the sequential loop: a train step, then a separate eval
  forward.

The JAX package fuses the whole split into one ``lax.while_loop``; here
it is a plain Python epoch loop whose selection state stays on the device
(``torch.where``), so no epoch waits for the host, except that with early
stopping on the host reads the stop flag once per epoch after the window
is full.  The model's parameters are trained in place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from acmgnn_tpu_torch import resolve_device
from acmgnn_tpu_torch.data.registry import row_normalize_features
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops.graph import GraphData, precompute_operators
from acmgnn_tpu_torch.ops.spmm import spmm
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.metrics import (
    masked_accuracy,
    masked_bce_with_logits,
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


def make_split_runner(model: ACMGNN, cfg: TrainConfig, joint=None):
    """``run(ops, x, labels, masks, seed=0, return_state=False,
    labels_onehot=None)`` — one split's training from the model's current
    parameters (the joint loop for joint-capable models when
    ``cfg.joint``, else the sequential one).  ``labels_onehot`` is the BCE
    target, ``prepare_data``'s ``labels_onehot``."""
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

    def loss_of(logits, labels, labels_onehot, mask):
        if use_bce:
            return masked_bce_with_logits(logits, labels_onehot, mask)
        return masked_nll(torch.log_softmax(logits, dim=1), labels, mask)

    def metrics_from_logits(logits, labels, labels_onehot, masks, packed):
        _, val_mask, test_mask = masks
        if use_rocauc:
            # one score sort and one rank pass serve both masks
            val_metric, test_metric = masked_rocauc_multi(
                logits, labels, (val_mask, test_mask), packed=packed)
        else:
            val_metric = masked_accuracy(logits, labels, val_mask)
            test_metric = masked_accuracy(logits, labels, test_mask)
        return (loss_of(logits, labels, labels_onehot, val_mask), val_metric,
                test_metric)

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
        gen = torch.Generator(device=dev).manual_seed(seed)
        opt = make_optimizer(cfg, model.parameters())
        packed = packed_words(labels, masks, labels_onehot)
        best = initial_best(dev)
        val_hist = torch.zeros(max(epochs, 1), device=dev)
        loss = torch.tensor(0.0, device=dev)
        losses = []
        epoch = 0
        while epoch < epochs:
            logits = model(x, ops, training=True, generator=gen)
            loss = loss_of(logits, labels, labels_onehot, masks[0])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss = loss.detach()
            losses.append(loss)
            with torch.no_grad():
                evals = metrics_from_logits(model(x, ops, training=False),
                                            labels, labels_onehot, masks,
                                            packed)
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
        gen = torch.Generator(device=dev).manual_seed(seed)
        opt = make_optimizer(cfg, model.parameters())
        packed = packed_words(labels, masks, labels_onehot)
        best = initial_best(dev)
        val_hist = torch.zeros(epochs + 1, device=dev)
        loss = torch.tensor(0.0, device=dev)
        losses = []
        k = 0
        while k < epochs + 1:
            logits_train, logits_eval = model(
                x, ops, training=True, paired_eval=True, generator=gen)
            loss = loss_of(logits_train, labels, labels_onehot, masks[0])
            stop = None
            with torch.no_grad():
                evals = metrics_from_logits(logits_eval, labels,
                                            labels_onehot, masks, packed)
                if k > 0:   # selection and history for epoch k - 1
                    best = select(best, evals)
                    val_hist[k - 1] = evals[0]
                    stop = stop_flag(val_hist, k - 1, evals[0])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss = loss.detach()
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
    labels = np.asarray(data.labels)
    if labels.ndim > 1 and labels.shape[1] == 1:
        labels = labels[:, 0]
    nclass = data.num_classes
    if labels.ndim == 1:
        labels_onehot = np.eye(nclass, dtype=np.float32)[labels]
    else:   # [N, C] multilabel targets are their own one-hot
        labels_onehot = labels.astype(np.float32)
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
