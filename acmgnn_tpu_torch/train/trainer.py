"""Training harness — counterpart of ``acmgnn_tpu/train/trainer.py``.

Ported so far: the joint loop (``run_joint``), where epoch k's dropout
train forward and epoch k-1's eval forward share one paired pass and
every sparse gather, with torch-style Adam (coupled L2), masked NLL,
accuracy and best-val selection.  The JAX package fuses the whole split
into one ``lax.while_loop``; here it is a plain Python epoch loop whose
selection state stays on the device (``torch.where``), so no epoch waits
for the host.  The model's parameters are trained in place.
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
from acmgnn_tpu_torch.train.metrics import masked_accuracy, masked_nll

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

    epoch: int                     # iterations run (epochs + 1)
    train_losses: torch.Tensor     # every iteration's train loss
    optimizer: torch.optim.Optimizer


def _eval_metrics(logits, labels, masks):
    _, val_mask, test_mask = masks
    log_probs = torch.log_softmax(logits, dim=1)
    return (masked_nll(log_probs, labels, val_mask),
            masked_accuracy(logits, labels, val_mask),
            masked_accuracy(logits, labels, test_mask))


def make_split_runner(model: ACMGNN, cfg: TrainConfig, joint=None):
    """``run(ops, x, labels, masks, seed=0, return_state=False)`` — one
    split's training from the model's current parameters."""
    if cfg.loss != "nll" or cfg.metric != "acc":
        raise NotImplementedError("only the nll loss with accuracy is "
                                  "ported yet")
    epochs = int(cfg.epochs)
    es = int(cfg.early_stopping)
    if es >= epochs:   # the stop rule could never fire (JAX: disabled)
        es = 0
    if es > 0:
        raise NotImplementedError("early stopping is not ported yet")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet")
    if joint is None:
        joint = bool(cfg.joint) and cfg.model_type in JOINT_CAPABLE
    if not joint:
        raise NotImplementedError("the sequential runner is not ported yet")
    sel_metric = cfg.selection == "val_metric"

    def run_joint(ops, x, labels, masks, seed: int = 0,
                  return_state: bool = False):
        """Iteration k evaluates epoch k-1 (parameters after k updates)
        and trains epoch k in one paired forward; ``epochs + 1``
        iterations, the first one's evaluation is skipped."""
        dev = x.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        opt = make_optimizer(cfg, model.parameters())
        train_mask = masks[0]
        best_val_loss = torch.tensor(math.inf, device=dev)
        best_val_metric = torch.tensor(-math.inf, device=dev)
        best_test_metric = torch.tensor(0.0, device=dev)
        loss = torch.tensor(0.0, device=dev)
        losses = []
        for k in range(epochs + 1):
            logits_train, logits_eval = model(
                x, ops, training=True, paired_eval=True, generator=gen)
            loss = masked_nll(torch.log_softmax(logits_train, dim=1), labels,
                              train_mask)
            with torch.no_grad():
                val_loss, val_metric, test_metric = _eval_metrics(
                    logits_eval, labels, masks)
                if k > 0:   # selection for epoch k - 1
                    improved = (val_metric > best_val_metric if sel_metric
                                else val_loss < best_val_loss)
                    best_val_loss = torch.where(improved, val_loss,
                                                best_val_loss)
                    best_val_metric = torch.where(improved, val_metric,
                                                  best_val_metric)
                    best_test_metric = torch.where(improved, test_metric,
                                                   best_test_metric)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss = loss.detach()
            losses.append(loss)
        result = SplitResult(
            test_metric=best_test_metric, val_metric=best_val_metric,
            val_loss=best_val_loss, train_loss=loss,
            epochs_run=max(epochs, 0),
        )
        if return_state:
            return result, SplitState(epoch=epochs + 1,
                                      train_losses=torch.stack(losses),
                                      optimizer=opt)
        return result

    return run_joint


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
    nclass = data.num_classes
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    y = torch.from_numpy(labels.astype(np.int64)).to(dev)
    y1h = torch.eye(nclass, device=dev)[y]
    if cfg.resolve_hoist():
        # Â X once, through the same gather as the model's (the eval
        # forward's layer-1 aggregate; exact for training at dropout 0)
        agg = spmm(ops.adj_low, x)
        agg_dtype = cfg.resolve_hoist_agg_dtype(*x.shape)
        ops.x_agg = agg if agg_dtype is None else agg.to(agg_dtype)
    return data, ops, x, y, y1h, nclass
