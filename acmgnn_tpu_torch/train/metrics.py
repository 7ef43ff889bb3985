"""Masked evaluation metrics on the device (no host sync)."""

from __future__ import annotations

import torch


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Fraction of masked nodes whose argmax matches the label."""
    if labels.ndim > 1 and labels.shape[-1] > 1:
        raise ValueError("masked_accuracy got a [N, C] multilabel matrix; "
                         "accuracy is undefined for multilabel targets")
    correct = (logits.argmax(dim=-1) == labels) & mask
    return correct.sum() / mask.sum().clamp_min(1)


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over masked nodes (torch NLLLoss)."""
    picked = log_probs.gather(1, labels[:, None].long())[:, 0]
    return -(picked * mask).sum() / mask.sum().clamp_min(1)
