"""Masked evaluation metrics on the device — counterpart of
``acmgnn_tpu/train/metrics.py``.

On the sharded path (``make_split_runner`` with a process group) each
rank holds a slab of the nodes: a loss takes ``count``, the mask's
all-reduced node count, and returns this rank's share of the global mean
(the local masked sum over ``count``; the shares sum to the mean), and an
accuracy all-reduces ``masked_correct`` counts.

The ROC-AUC is the Mann-Whitney statistic with average-rank ties
(``sklearn.metrics.roc_auc_score`` on each mask's subset), for several
masks over one score sort.  ``torch.sort`` orders the scores; the rank
pass over the sorted order is kernel K4 (``csrc/rocauc.cu``), whose plain
PyTorch version is ``auc_rank_pass_plain``.  The rank pass counts in
int64, so twice the positives' rank sum is exact, and the AUC is formed
from those counts in f64: the JAX package sums the average ranks in f32.
"""

from __future__ import annotations

import torch

from acmgnn_tpu_torch.ops import kernels

# bit 0 of a node's packed word is its label, bits 1..7 its masks
MAX_MASKS = 7


def masked_correct(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked nodes whose argmax matches the label (int64 count)."""
    if labels.ndim > 1 and labels.shape[-1] > 1:
        raise ValueError("accuracy got a [N, C] multilabel matrix; it is "
                         "undefined for multilabel targets")
    return ((logits.argmax(dim=-1) == labels) & mask).sum()


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fraction of masked nodes whose argmax matches the label."""
    return masked_correct(logits, labels, mask) / mask.sum().clamp_min(1)


def _mean_over(total: torch.Tensor, mask: torch.Tensor, count):
    return total / (mask.sum().clamp_min(1) if count is None else count)


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean negative log-likelihood over masked nodes (torch NLLLoss);
    with ``count`` (all-reduced) this rank's share of the global mean."""
    picked = log_probs.gather(1, labels[:, None].long())[:, 0]
    return _mean_over(-(picked * mask).sum(), mask, count)


def masked_bce_with_logits(logits: torch.Tensor, targets_onehot: torch.Tensor,
                           mask: torch.Tensor, count=None) -> torch.Tensor:
    """torch BCEWithLogitsLoss, mean over masked rows and all columns, in
    the ``max(x, 0) - x·t + log1p(exp(-|x|))`` form; ``count`` as in
    ``masked_nll``."""
    x, t = logits, targets_onehot
    per_elt = torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return _mean_over((per_elt.mean(dim=-1) * mask).sum(), mask, count)


def is_multilabel(labels: torch.Tensor) -> bool:
    return labels.ndim > 1 and labels.shape[-1] > 1


def pack_labels_and_masks(labels: torch.Tensor, masks) -> torch.Tensor:
    """``[B, N]`` uint8 words: bit 0 the label of score column b (B=1 for
    single-label targets, C for ``[N, C]`` multilabel ones), bit m+1 mask
    m.  Labels and masks are fixed for a split, so this is built once per
    split, not per evaluation."""
    if len(masks) > MAX_MASKS:
        raise ValueError(f"at most {MAX_MASKS} masks per rank pass")
    if is_multilabel(labels):
        lab = (labels == 1).T
    else:
        lab = (labels.reshape(-1) == 1)[None]
    word = lab.to(torch.uint8)
    for m, mask in enumerate(masks):
        word = word | (mask.to(torch.uint8) << (m + 1))[None]
    return word.contiguous()


def sort_scores(scores: torch.Tensor):
    """Ascending sort of each row of ``[B, N]`` scores: ``(order,
    s_sorted)``, shared by every mask evaluated on them.  The tie groups
    (runs of equal sorted scores) are read from ``s_sorted`` by the rank
    pass itself."""
    s_sorted, order = torch.sort(scores, dim=-1)
    return order, s_sorted


def auc_rank_pass_plain(s_sorted: torch.Tensor, order: torch.Tensor,
                        packed: torch.Tensor, n_masks: int) -> torch.Tensor:
    """Plain PyTorch version of K4: ``[B, M, 3]`` int64 ``(n_pos, n_neg,
    2·rank_sum)`` per score column and mask, by the JAX package's
    formulation: masked prefix ranks, each tie group's first and last
    position by a forward max-scan and a reverse min-scan, and
    ``lo + 1 + hi`` (twice the average rank) summed over the positives."""
    b, n = s_sorted.shape
    dev = s_sorted.device
    bits = torch.gather(packed, 1, order).long()
    label = bits & 1
    new_group = torch.ones(b, n, dtype=torch.bool, device=dev)
    new_group[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
    end = torch.ones(b, n, dtype=torch.bool, device=dev)
    end[:, :-1] = new_group[:, 1:]
    idx = torch.arange(n, device=dev).expand(b, n)
    start_pos = torch.cummax(torch.where(new_group, idx, 0), dim=1).values
    end_pos = torch.cummin(torch.where(end, idx, n - 1).flip(1),
                           dim=1).values.flip(1)
    out = torch.empty(b, n_masks, 3, dtype=torch.int64, device=dev)
    for m in range(n_masks):
        masked = (bits >> (m + 1)) & 1
        ranks = torch.cumsum(masked, dim=1)
        lo = torch.gather(ranks - masked, 1, start_pos)
        hi = torch.gather(ranks, 1, end_pos)
        pos = masked & label
        n_pos = pos.sum(dim=1)
        out[:, m, 0] = n_pos
        out[:, m, 1] = ranks[:, -1] - n_pos
        out[:, m, 2] = (pos * (lo + 1 + hi)).sum(dim=1)
    return out


def _auc_rank_pass_cuda(s_sorted, order, packed, n_masks: int):
    b, n = s_sorted.shape
    if s_sorted.dtype != torch.float32 or order.dtype != torch.int64 \
            or packed.dtype != torch.uint8:
        raise TypeError("K4 takes f32 sorted scores, an int64 order and "
                        "uint8 packed words")
    if order.shape != (b, n) or packed.shape != (b, n):
        raise ValueError("sorted scores, order and packed words must all "
                         "be [B, N]")
    if not 1 <= n_masks <= MAX_MASKS:
        raise ValueError(f"K4 takes 1..{MAX_MASKS} masks, got {n_masks}")
    kernels.require_cuda(s_sorted, order, packed)
    lib = kernels.library("rocauc")
    n_tiles = max(1, -(-n // lib.acm_k4_tile_size()))
    dev = s_sorted.device
    scratch = torch.empty(4, b, n_tiles, n_masks, dtype=torch.int64,
                          device=dev)
    out = torch.empty(b, n_masks, 3, dtype=torch.int64, device=dev)
    rc = lib.acm_k4_auc_rank_pass(
        kernels.ptr(s_sorted), kernels.ptr(order), kernels.ptr(packed), n, b,
        n_masks, n_tiles, kernels.ptr(scratch), kernels.ptr(out),
        kernels.stream(),
    )
    kernels.check(lib, rc, "K4 ROC-AUC rank pass")
    kernels.count(f"k4_auc_m{n_masks}")
    return out


def auc_rank_pass(s_sorted: torch.Tensor, order: torch.Tensor,
                  packed: torch.Tensor, n_masks: int) -> torch.Tensor:
    """``[B, M, 3]`` int64 ``(n_pos, n_neg, 2·rank_sum)`` from ``[B, N]``
    ascending scores, their ``torch.sort`` order and the packed label/mask
    words (``pack_labels_and_masks``).  CPU tensors run the plain
    version; CUDA tensors launch K4."""
    if s_sorted.device.type == "cpu":
        return auc_rank_pass_plain(s_sorted, order, packed, n_masks)
    return _auc_rank_pass_cuda(s_sorted.contiguous(), order.contiguous(),
                               packed.contiguous(), n_masks)


def auc_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` rank-pass counts -> AUC in f64, NaN where a class is
    absent from the mask."""
    c = counts.double()
    n_pos, n_neg, rank2 = c[..., 0], c[..., 1], c[..., 2]
    auc = (rank2 - n_pos * (n_pos + 1)) / (2 * n_pos * n_neg)
    return torch.where((n_pos > 0) & (n_neg > 0), auc,
                       torch.full_like(auc, float("nan")))


def masked_rocauc_multi(logits: torch.Tensor, labels: torch.Tensor, masks,
                        packed: torch.Tensor | None = None):
    """ROC-AUC for several masks over one set of logits, one f32 scalar
    per mask, as the reference evaluates it:

    - single-label (``[N]`` or ``[N, 1]``): score ``softmax(logits)[:, 1]``;
    - multilabel ``[N, C]``: each column's AUC on the raw logits (one batch
      of C sorts and one rank pass), then their nanmean.

    ``packed``: the split's ``pack_labels_and_masks(labels, masks)``,
    made here when not given.
    """
    if packed is None:
        packed = pack_labels_and_masks(labels, masks)
    if is_multilabel(labels):
        scores = logits.T.contiguous()
    else:
        scores = torch.softmax(logits, dim=-1)[:, 1][None]
    order, s_sorted = sort_scores(scores.float())
    aucs = auc_from_counts(auc_rank_pass(s_sorted, order, packed, len(masks)))
    if not is_multilabel(labels):
        return tuple(aucs[0].float())
    return tuple(torch.nanmean(aucs, dim=0).float())


def masked_rocauc(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """ROC-AUC on one mask (``masked_rocauc_multi`` with one mask)."""
    return masked_rocauc_multi(logits, labels, (mask,))[0]
