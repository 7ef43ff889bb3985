"""Dataset preprocessing shared by every loader (loaders come later)."""

from __future__ import annotations

import numpy as np


def row_normalize_features(features: np.ndarray) -> np.ndarray:
    """Row-normalize the feature matrix (zero rows stay zero), the
    reference's default preprocessing unless acmgcnp/pp + structure_info.

    Rows whose sum is near but not exactly zero are divided by it as they
    are, exactly as ``acmgnn_tpu.data.registry.row_normalize_features``
    does (large values on real-valued features are that rule's behaviour).
    """
    rowsum = features.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(rowsum != 0, 1.0 / rowsum, 0.0)
    return (features * inv).astype(np.float32)
