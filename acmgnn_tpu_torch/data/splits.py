"""Train/val/test masks — counterpart of ``acmgnn_tpu/data/splits.py``.

Three split regimes, with the same ``numpy`` draws as the JAX package:

- fixed Geom-GCN ``.npz`` mask files (``load_fixed_split_masks``);
- random "disassortative" 60/20/20 splits with a class-balanced train set
  (``random_disassortative_splits``);
- LINKX random proportional splits without the unlabeled (-1) nodes
  (``rand_train_test_idx``) and the LINKX ``*-splits.npy`` index files
  (``load_linkx_split_masks``).

All masks are numpy bool arrays; callers ship them to the device.
"""

from __future__ import annotations

import numpy as np

from acmgnn_tpu_torch.data.paths import find_data_file


def load_fixed_split_masks(dataset_name: str, idx: int):
    """Geom-GCN fixed split ``idx`` -> (train, val, test) bool masks, from
    ``ACM-Pytorch/splits/<name>_split_0.6_0.2_<idx>.npz`` under a data
    root."""
    path = find_data_file(
        "ACM-Pytorch", "splits", f"{dataset_name}_split_0.6_0.2_{idx}.npz"
    )
    with np.load(path) as f:
        return (
            f["train_mask"].astype(bool),
            f["val_mask"].astype(bool),
            f["test_mask"].astype(bool),
        )


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


def rand_train_test_idx(label: np.ndarray, train_prop: float = 0.5,
                        valid_prop: float = 0.25,
                        ignore_negative: bool = True, rng=None):
    """LINKX-style random proportional split over the labeled nodes (all
    nodes without ``ignore_negative``); returns three index arrays."""
    rng = np.random.default_rng() if rng is None else rng
    label = np.asarray(label).squeeze()
    if ignore_negative:
        labeled_nodes = np.where(label != -1)[0]
    else:
        labeled_nodes = np.arange(label.shape[0])
    n = labeled_nodes.shape[0]
    train_num = int(n * train_prop)
    valid_num = int(n * valid_prop)
    perm = rng.permutation(n)
    train_idx = labeled_nodes[perm[:train_num]]
    valid_idx = labeled_nodes[perm[train_num:train_num + valid_num]]
    test_idx = labeled_nodes[perm[train_num + valid_num:]]
    return train_idx, valid_idx, test_idx


def indices_to_masks(n: int, train_idx, valid_idx, test_idx):
    """Three index lists -> three ``[n]`` bool masks."""
    masks = []
    for idx in (train_idx, valid_idx, test_idx):
        m = np.zeros(n, dtype=bool)
        m[np.asarray(idx)] = True
        masks.append(m)
    return tuple(masks)


def load_linkx_split_masks(dataset_name: str, sub_dataset: str = ""):
    """LINKX ``ACM-Geometric/splits/<name>[-<sub>]-splits.npy`` -> a list
    of ``{"train", "valid", "test"}`` index dicts."""
    name = dataset_name
    if sub_dataset and sub_dataset != "None":
        name += f"-{sub_dataset}"
    path = find_data_file("ACM-Geometric", "splits", f"{name}-splits.npy")
    splits_lst = np.load(path, allow_pickle=True)
    return [
        {k: np.asarray(s[k]) for k in ("train", "valid", "test")}
        for s in splits_lst
    ]
