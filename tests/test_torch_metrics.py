"""The port's BCE loss and ROC-AUC against acmgnn_tpu's, and the ROC-AUC
against an exact f64 Mann-Whitney reference (``scipy.stats.rankdata``).

Tolerances: the BCE loss to 1e-6 relative (f32 elementwise work and one
mean).  ROC-AUCs to 1e-6 against JAX, which sums the average ranks in f32
(``metrics.py:117-123``); the port counts them in int64 and forms the AUC
in f64, so against the f64 reference it is exact.  JAX's binary path
scores ``softmax(logits)[:, 1]``, and two frameworks' softmax can differ
by an ulp, which can split a tie group: the binary cases use logits whose
ties come from identical rows or from saturation (a logit gap above 20
gives exactly 1.0 in f32), which both frameworks reproduce; the tie-heavy
rank cases run on raw-logit (multilabel) scores, the same arrays on both
sides.
"""

from __future__ import annotations

import numpy as np
import pytest
from scipy.stats import rankdata

import jax.numpy as jnp
import torch

from acmgnn_tpu.train.metrics import (
    masked_bce_with_logits as jax_masked_bce_with_logits,
)
from acmgnn_tpu.train.metrics import masked_rocauc_multi as jax_rocauc_multi
from acmgnn_tpu_torch.train.metrics import (
    auc_from_counts,
    auc_rank_pass,
    masked_bce_with_logits,
    masked_rocauc,
    masked_rocauc_multi,
    pack_labels_and_masks,
    rocauc_from_sorted_plain,
    sort_scores,
)

N = 600


@pytest.mark.parametrize("targets", ("onehot", "multilabel"))
def test_bce_matches_jax(targets):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(N, 3)) * 4).astype(np.float32)
    if targets == "onehot":
        t = np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)]
    else:
        t = (rng.random((N, 3)) < 0.3).astype(np.float32)
    mask = rng.random(N) < 0.4
    ours = masked_bce_with_logits(torch.from_numpy(logits),
                                  torch.from_numpy(t), torch.from_numpy(mask))
    ref = jax_masked_bce_with_logits(jnp.asarray(logits), jnp.asarray(t),
                                     jnp.asarray(mask))
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)


def _case(name: str):
    """(logits, labels, masks) of one ROC-AUC case."""
    rng = np.random.default_rng(sum(name.encode()))
    perm = rng.permutation(N)
    masks = np.zeros((2, N), bool)
    masks[0, perm[: N // 3]] = True
    masks[1, perm[N // 3: 2 * N // 3]] = True
    labels = rng.integers(0, 2, N)
    logits = rng.normal(size=(N, 2)).astype(np.float32)
    if name == "quantised":          # few distinct rows: large tie groups
        logits = np.round(logits * 2) / 2
    elif name == "saturated":        # one group of exactly 1.0 scores
        logits[:250] = [0.0, 25.0]
        logits[250:300] = [0.0, 40.0]
    elif name == "empty_mask":
        masks[1] = False
    elif name == "class_absent":
        labels[masks[1]] = 0
    elif name.startswith("multilabel"):
        labels = (rng.random((N, 4)) < 0.4).astype(np.int64)
        logits = rng.normal(size=(N, 4)).astype(np.float32)
        labels[:, 3] = 0             # a column without positives: NaN
        if name == "multilabel_ties":
            logits = np.round(logits)
            logits[:200, 1] = 7.0
    return logits, labels, masks


ROC_CASES = ("random", "quantised", "saturated", "empty_mask",
             "class_absent", "multilabel", "multilabel_ties")


@pytest.mark.parametrize("name", ROC_CASES)
def test_rocauc_matches_jax(name):
    logits, labels, masks = _case(name)
    ours = masked_rocauc_multi(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               tuple(torch.from_numpy(m) for m in masks))
    ref = jax_rocauc_multi(jnp.asarray(logits), jnp.asarray(labels),
                           tuple(jnp.asarray(m) for m in masks))
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.dtype == torch.float32
        if np.isnan(float(b)):
            assert np.isnan(float(a)), f"mask {i}"
        else:
            assert float(a) == pytest.approx(float(b), rel=1e-6, abs=1e-6), \
                f"mask {i}"
    if name in ("empty_mask", "class_absent"):
        assert np.isnan(float(ours[1]))
    single = masked_rocauc(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(masks[0]))
    assert float(single) == float(ours[0]) or np.isnan(float(single))


@pytest.mark.parametrize("name", ROC_CASES)
@pytest.mark.parametrize("n_masks", (1, 2, 3))
def test_rocauc_from_sorted_plain_matches_jax(name, n_masks):
    """K4's plain version (counts, AUC in f64, the multilabel nanmean as a
    column loop) against JAX's ``masked_rocauc_multi`` on 1 to 3 masks
    (the stepwise path evaluates three: train, val, test), at the
    tolerance of ``test_rocauc_matches_jax``."""
    logits, labels, masks = _case(name)
    rest = ~(masks[0] | masks[1])
    masks = (masks[0], masks[1], rest)[:n_masks]
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    if labels.ndim == 1:
        scores = torch.softmax(t_logits, dim=-1)[:, 1][None]
    else:
        scores = t_logits.T.contiguous()
    packed = pack_labels_and_masks(t_labels,
                                   tuple(torch.from_numpy(m) for m in masks))
    order, s_sorted = sort_scores(scores)
    counts, aucs = rocauc_from_sorted_plain(s_sorted, order, packed,
                                            n_masks)
    assert counts.shape == (scores.shape[0], n_masks, 3)
    assert aucs.dtype == torch.float32 and aucs.shape == (n_masks,)
    ref = jax_rocauc_multi(jnp.asarray(logits), jnp.asarray(labels),
                           tuple(jnp.asarray(m) for m in masks))
    for i, (a, b) in enumerate(zip(aucs.tolist(), ref)):
        if np.isnan(float(b)):
            assert np.isnan(a), f"mask {i}"
        else:
            assert a == pytest.approx(float(b), rel=1e-6, abs=1e-6), \
                f"mask {i}"


def _reference_counts(scores: np.ndarray, labels: np.ndarray,
                      mask: np.ndarray):
    """Exact (n_pos, n_neg, 2·rank_sum) on the mask's subset: average
    ranks from scipy in f64; twice each is an integer."""
    s, y = scores[mask], labels[mask]
    ranks2 = 2 * rankdata(s, method="average")
    n_pos = int((y == 1).sum())
    return n_pos, int(s.size - n_pos), int(round(ranks2[y == 1].sum()))


@pytest.mark.parametrize("name", ("random", "quantised", "saturated",
                                  "multilabel_ties"))
def test_rocauc_is_exact_against_rankdata(name):
    """The rank pass's counts equal the f64 reference's integers, so the
    AUC equals the same f64 formula on them bit for bit."""
    logits, labels, masks = _case(name)
    t_logits = torch.from_numpy(logits)
    if labels.ndim == 1:
        scores = torch.softmax(t_logits, dim=-1)[:, 1][None]
        lab = labels[None]
    else:
        scores = t_logits.T.contiguous()
        lab = labels.T
    packed = pack_labels_and_masks(torch.from_numpy(labels),
                                   tuple(torch.from_numpy(m) for m in masks))
    order, s_sorted = sort_scores(scores)
    counts = auc_rank_pass(s_sorted, order, packed, len(masks))
    aucs = auc_from_counts(counts)
    for b in range(scores.shape[0]):
        for m in range(len(masks)):
            want = _reference_counts(scores[b].numpy().astype(np.float64),
                                     lab[b], masks[m])
            assert tuple(counts[b, m].tolist()) == want, (b, m)
            n_pos, n_neg, rank2 = want
            if n_pos and n_neg:
                ref = (rank2 - n_pos * (n_pos + 1)) / (2.0 * n_pos * n_neg)
                assert float(aucs[b, m]) == ref
            else:
                assert np.isnan(float(aucs[b, m]))


def test_packed_words_and_large_tie_group():
    """Bit 0 is the label, bit m+1 mask m; a tie group covering most of
    the nodes (the saturated softmax of a trained model) counts exactly."""
    labels = torch.tensor([1, 0, 1, 1, 0])
    masks = (torch.tensor([1, 1, 0, 0, 1], dtype=torch.bool),
             torch.tensor([0, 1, 1, 0, 0], dtype=torch.bool))
    packed = pack_labels_and_masks(labels, masks)
    assert packed.tolist() == [[0b011, 0b110, 0b101, 0b001, 0b010]]
    n = 20_000
    rng = np.random.default_rng(3)
    scores = np.where(rng.random(n) < 0.7, 1.0, rng.random(n)).astype(
        np.float32)
    y = rng.integers(0, 2, n)
    mask = rng.random(n) < 0.5
    packed = pack_labels_and_masks(torch.from_numpy(y),
                                   (torch.from_numpy(mask),))
    order, s_sorted = sort_scores(torch.from_numpy(scores)[None])
    counts = auc_rank_pass(s_sorted, order, packed, 1)
    assert tuple(counts[0, 0].tolist()) == _reference_counts(
        scores.astype(np.float64), y, mask)
