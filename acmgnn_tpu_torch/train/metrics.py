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
pass over the sorted order and the AUC it gives are one launch of kernel
K4 (``csrc/rocauc.cu``), whose plain PyTorch version is
``rocauc_from_sorted_plain`` (``auc_rank_pass_plain``'s counts, then
``auc_from_counts``); ``k4_tile_replay`` replays K4's tile algebra.  The
rank pass counts in int64, so twice the positives' rank sum is exact,
and the AUC is formed from those counts in f64: the JAX package sums the
average ranks in f32.
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


def k4_tile_replay(s_sorted: torch.Tensor, order: torch.Tensor,
                   packed: torch.Tensor, n_masks: int,
                   tile: int) -> torch.Tensor:
    """K4's one-pass algebra in plain PyTorch, at ``tile`` sorted positions
    a tile: the ``[B, M, 3]`` counts from each tile's statistics (its
    masked and masked-positive counts ``M_t``, ``Q_t``; whether a tie group
    ends in it; the tile-local counts ``m``, ``q`` at its first and last
    group end ``f_1``, ``f_r``; ``S1 = Σ_{j≥2} (q(f_j) − q(f_{j−1}))·(1 +
    m(f_{j−1}) + m(f_j))``), then the finish: with ``(M_B, Q_B)`` the
    counts before the tile and ``(M_C, Q_C)`` those at the last group end
    before it, the tile adds ``(Q_B + q(f_1) − Q_C)·(M_C + 1 + M_B +
    m(f_1)) + S1 + 2·M_B·(q(f_r) − q(f_1))`` to ``2·rank_sum``.  Equals
    ``auc_rank_pass_plain`` exactly at any tile size."""
    b, n = s_sorted.shape
    dev = s_sorted.device
    n_tiles = -(-n // tile)
    pad = n_tiles * tile - n
    bits = torch.gather(packed, 1, order).long()
    end = torch.ones(b, n, dtype=torch.bool, device=dev)
    end[:, :-1] = s_sorted[:, 1:] != s_sorted[:, :-1]
    bits = torch.nn.functional.pad(bits, (0, pad)).view(b, n_tiles, tile)
    end = torch.nn.functional.pad(end, (0, pad)).view(b, n_tiles, tile)
    pos = torch.arange(tile, device=dev)
    has = end.any(dim=2)
    first = torch.where(end, pos, tile - 1).amin(dim=2, keepdim=True)
    last = torch.where(end, pos, 0).amax(dim=2, keepdim=True)
    # each position's previous group end in its tile (-1: none)
    prev = torch.cummax(torch.where(end, pos, -1), dim=2).values
    prev = torch.cat([torch.full_like(prev[..., :1], -1), prev[..., :-1]],
                     dim=2)
    later = end & (prev >= 0)          # f_j with j >= 2
    prev = prev.clamp_min(0)
    # per tile, the last earlier tile in which a group ends (-1: none)
    tiles = torch.arange(n_tiles, device=dev).expand(b, n_tiles)
    c_tile = torch.cummax(torch.where(has, tiles, -1), dim=1).values
    c_tile = torch.cat([torch.full_like(c_tile[:, :1], -1), c_tile[:, :-1]],
                       dim=1)
    label = bits & 1
    out = torch.empty(b, n_masks, 3, dtype=torch.int64, device=dev)
    for m in range(n_masks):
        masked = (bits >> (m + 1)) & 1
        mc = torch.cumsum(masked, dim=2)
        qc = torch.cumsum(masked & label, dim=2)
        m_t, q_t = mc[..., -1], qc[..., -1]
        m1, q1 = mc.gather(2, first)[..., 0], qc.gather(2, first)[..., 0]
        mr, qr = mc.gather(2, last)[..., 0], qc.gather(2, last)[..., 0]
        s1 = torch.where(later, (qc - qc.gather(2, prev))
                         * (1 + mc.gather(2, prev) + mc), 0).sum(dim=2)
        m_b = torch.cumsum(m_t, dim=1) - m_t
        q_b = torch.cumsum(q_t, dim=1) - q_t
        k = c_tile.clamp_min(0)
        found = c_tile >= 0
        m_c = torch.where(found, (m_b + mr).gather(1, k), 0)
        q_c = torch.where(found, (q_b + qr).gather(1, k), 0)
        share = ((q_b + q1 - q_c) * (m_c + 1 + m_b + m1) + s1
                 + 2 * m_b * (qr - q1))
        n_pos = q_t.sum(dim=1)
        out[:, m, 0] = n_pos
        out[:, m, 1] = m_t.sum(dim=1) - n_pos
        out[:, m, 2] = torch.where(has, share, 0).sum(dim=1)
    return out


# K4's tile, sorted positions a block reads (256 threads): the fastest of
# the sizes csrc/rocauc.cu compiles (K4_TILES) at genius scale, by
# chip_smoke.py phase 5a's sweep
K4_TILE = 2048
K4_TILES = (1024, 2048, 4096)

_k4_workspaces: dict = {}


def _k4_workspace(device, n_cols: int, n_tiles: int, n_masks: int):
    """K4's scratch for one shape, made once and kept: ``n_cols + 1``
    tickets (zero when made; every launch leaves them at zero), the tiles'
    statistics and the columns' f64 AUCs.  A CUDA graph that captured a
    launch replays it on the same buffers, so the first call at a shape
    must come before a capture."""
    key = (device, n_cols, n_tiles, n_masks)
    ws = _k4_workspaces.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("call K4 once at this shape before a CUDA "
                               "graph captures it")
        ws = (torch.zeros(n_cols + 1, dtype=torch.int32, device=device),
              torch.empty(n_cols * n_tiles * n_masks * 4, dtype=torch.int32,
                          device=device),
              torch.empty(n_cols, n_masks, dtype=torch.float64,
                          device=device))
        _k4_workspaces[key] = ws
    return ws


def _launch(s_sorted, order, packed, n_masks: int, tile: int = K4_TILE):
    """One K4 launch: ``([B, M, 3] int64 counts, [M] f32 AUCs)``."""
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
    dev = s_sorted.device
    tickets, stats, col_auc = _k4_workspace(dev, b, -(-n // tile), n_masks)
    counts = torch.empty(b, n_masks, 3, dtype=torch.int64, device=dev)
    auc = torch.empty(n_masks, dtype=torch.float32, device=dev)
    rc = lib.acm_k4_rocauc(
        kernels.ptr(s_sorted), kernels.ptr(order), kernels.ptr(packed), n, b,
        n_masks, tile, kernels.ptr(tickets), kernels.ptr(stats),
        kernels.ptr(col_auc), kernels.ptr(counts), kernels.ptr(auc),
        kernels.stream(),
    )
    kernels.check(lib, rc, "K4 ROC-AUC")
    kernels.count(f"k4_auc_m{n_masks}")
    return counts, auc


def auc_rank_pass(s_sorted: torch.Tensor, order: torch.Tensor,
                  packed: torch.Tensor, n_masks: int) -> torch.Tensor:
    """``[B, M, 3]`` int64 ``(n_pos, n_neg, 2·rank_sum)`` from ``[B, N]``
    ascending scores, their ``torch.sort`` order and the packed label/mask
    words (``pack_labels_and_masks``).  CPU tensors run the plain
    version; CUDA tensors launch K4 (whose AUCs are dropped)."""
    if s_sorted.device.type == "cpu":
        return auc_rank_pass_plain(s_sorted, order, packed, n_masks)
    return _launch(s_sorted.contiguous(), order.contiguous(),
                   packed.contiguous(), n_masks)[0]


def auc_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` rank-pass counts -> AUC in f64, NaN where a class is
    absent from the mask."""
    c = counts.double()
    n_pos, n_neg, rank2 = c[..., 0], c[..., 1], c[..., 2]
    auc = (rank2 - n_pos * (n_pos + 1)) / (2 * n_pos * n_neg)
    return torch.where((n_pos > 0) & (n_neg > 0), auc,
                       torch.full_like(auc, float("nan")))


def rocauc_from_sorted_plain(s_sorted: torch.Tensor, order: torch.Tensor,
                             packed: torch.Tensor, n_masks: int):
    """Plain PyTorch version of K4: ``auc_rank_pass_plain``'s counts and
    the ``[M]`` f32 AUCs, formed in f64 by ``auc_from_counts`` and, over
    the score columns, averaged over those that are not NaN, summed in
    column order (K4's order) and rounded once to f32."""
    counts = auc_rank_pass_plain(s_sorted, order, packed, n_masks)
    total = torch.zeros(n_masks, dtype=torch.float64, device=counts.device)
    seen = torch.zeros_like(total)
    for col in auc_from_counts(counts):
        ok = ~torch.isnan(col)
        total = total + torch.where(ok, col, 0.0)
        seen = seen + ok
    return counts, (total / seen).float()


def rocauc_from_sorted(s_sorted: torch.Tensor, order: torch.Tensor,
                       packed: torch.Tensor, n_masks: int,
                       multilabel: bool):
    """``([B, M, 3] int64 counts, [M] f32 AUCs)`` from ``[B, N]`` ascending
    scores, their order and the packed words: each mask's AUC, for
    ``multilabel`` scores (one column a class) the nanmean over the
    columns.  CPU tensors run the plain version; CUDA tensors one K4
    launch, which forms the AUCs too."""
    if not multilabel and s_sorted.shape[0] != 1:
        raise ValueError("single-label scores are one column")
    if s_sorted.device.type == "cpu":
        return rocauc_from_sorted_plain(s_sorted, order, packed, n_masks)
    return _launch(s_sorted.contiguous(), order.contiguous(),
                   packed.contiguous(), n_masks)


def masked_rocauc_multi(logits: torch.Tensor, labels: torch.Tensor, masks,
                        packed: torch.Tensor | None = None):
    """ROC-AUC for several masks over one set of logits, one f32 scalar
    per mask, as the reference evaluates it:

    - single-label (``[N]`` or ``[N, 1]``): score ``softmax(logits)[:, 1]``;
    - multilabel ``[N, C]``: each column's AUC on the raw logits (one batch
      of C sorts and one rank pass), then their nanmean.

    ``packed``: the split's ``pack_labels_and_masks(labels, masks)``,
    made here when not given.  On the card: the softmax, ``torch.sort``
    and one K4 launch; the scalars are views of K4's output.
    """
    if packed is None:
        packed = pack_labels_and_masks(labels, masks)
    multilabel = is_multilabel(labels)
    if multilabel:
        scores = logits.T.contiguous()
    else:
        scores = torch.softmax(logits, dim=-1)[:, 1][None]
    order, s_sorted = sort_scores(scores.float())
    _, aucs = rocauc_from_sorted(s_sorted, order, packed, len(masks),
                                 multilabel)
    return tuple(aucs)


def masked_rocauc(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """ROC-AUC on one mask (``masked_rocauc_multi`` with one mask)."""
    return masked_rocauc_multi(logits, labels, (mask,))[0]
