"""Train/val/test masks — counterpart of ``acmgnn_tpu/data/splits.py``.

Ported so far: the random "disassortative" 60/20/20 splits with a
class-balanced train set (the same draws from the same ``numpy``
generator as the JAX package) and index lists to masks.  The fixed
Geom-GCN masks and the LINKX split files wait for the data layer
(ROADMAP "What is left" 5).
"""

from __future__ import annotations

import numpy as np


def random_disassortative_splits(labels: np.ndarray, num_classes: int,
                                 rng=None):
    """60/20/20 with a class-balanced train set: per class ``round(0.6 *
    N / C)`` nodes to train; the pooled rest is shuffled, the first
    ``round(0.2 * N)`` to val, the others to test.  Returns three bool
    masks."""
    rng = np.random.default_rng() if rng is None else rng
    labels = np.asarray(labels)
    n = labels.shape[0]
    indices = [rng.permutation(np.nonzero(labels == i)[0])
               for i in range(num_classes)]
    percls_trn = int(round(0.6 * (n / num_classes)))
    val_lb = int(round(0.2 * n))
    train_index = np.concatenate([i[:percls_trn] for i in indices])
    rest_index = rng.permutation(
        np.concatenate([i[percls_trn:] for i in indices]))
    return indices_to_masks(n, train_index, rest_index[:val_lb],
                            rest_index[val_lb:])


def indices_to_masks(n: int, train_idx, valid_idx, test_idx):
    """Three index lists -> three ``[n]`` bool masks."""
    masks = []
    for idx in (train_idx, valid_idx, test_idx):
        m = np.zeros(n, dtype=bool)
        m[np.asarray(idx)] = True
        masks.append(m)
    return tuple(masks)
