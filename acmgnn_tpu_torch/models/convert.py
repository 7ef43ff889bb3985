"""Parameter transplant from a flax parameter tree to the port's modules."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax parameter tree (numpy arrays), or a variables dict
    ``{"params": ..., "batch_stats": ...}``, into a ``state_dict``.

    Names and orientations are the same on both sides, so the copy is
    flat: ``gcn_0/weight_low`` ([F_in, F_out], used as ``x @ W``) becomes
    ``gcn_0.weight_low``, ``gcn_0/layer_norm_low/scale`` becomes
    ``gcn_0.layer_norm_low.scale``; a BatchNorm's ``batch_stats`` entries
    ``mlpX/bn_0/{mean,var}`` become its buffers ``mlpX.bn_0.mean`` /
    ``mlpX.bn_0.var``.
    """
    trees = [params]
    if "params" in params:
        trees = [params["params"]]
        if "batch_stats" in params:
            trees.append(params["batch_stats"])
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, val in tree.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = torch.from_numpy(np.array(val, dtype=np.float32))

    for tree in trees:
        walk(tree, "")
    return out
