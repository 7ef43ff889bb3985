"""Synthetic-benchmark experiments — counterpart of
``acmgnn_tpu/train/synthetic_exp.py``: at one edge-homophily level, train
over the generated graphs (``data/synthetic.py``, each with its feature
realization) and aggregate."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

from acmgnn_tpu_torch.data.synthetic import load_synthetic
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig


def run_synthetic_experiment(base_dir: str, edge_homo: float, *,
                             graph_type: str = "random",
                             model_type: str = "acmgcn",
                             num_graph: int = 10,
                             features_dir: Optional[str] = None,
                             cfg: Optional[TrainConfig] = None,
                             logger=None, device=None) -> dict:
    """Train over all generated graphs at one homophily level.

    Graph ``g`` takes ``features_<g>.npz`` from ``features_dir`` when it
    is there (identity features otherwise) and ``cfg.num_splits`` random
    disassortative splits, seeded ``cfg.seed + g``."""
    base = cfg or TrainConfig(
        model_type=model_type, hidden=64, lr=0.05, weight_decay=5e-4,
        dropout=0.5, epochs=1000, early_stopping=40, num_splits=1,
        fixed_splits=False)
    accs = []
    per_graph = []
    for g in range(num_graph):
        feat_path = None
        if features_dir is not None:
            cand = Path(features_dir) / f"features_{g}.npz"
            if cand.exists():
                feat_path = str(cand)
        data = load_synthetic(base_dir, graph_type, edge_homo, g,
                              features_path=feat_path)
        cfg_g = dataclasses.replace(base, seed=base.seed + g)
        out = trainer.run_experiment(data, cfg_g, device=device)
        accs.extend(out["per_split"])
        per_graph.append(out["test_mean"])
        if logger is not None:
            logger.info("homo %.1f graph %d: %.4f", edge_homo, g,
                        out["test_mean"])
    accs = np.asarray(accs)
    result = {
        "edge_homo": edge_homo,
        "graph_type": graph_type,
        "model": base.model_type,
        "test_mean": float(accs.mean()),
        "test_std": float(accs.std()),
        "per_graph": per_graph,
    }
    if logger is not None:
        logger.info("homo %.1f summary: %s", edge_homo, result)
    return result


def run_homophily_sweep(base_dir: str,
                        edge_homos=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                                    0.9),
                        **kwargs) -> list[dict]:
    """The paper's synthetic experiment: accuracy against edge
    homophily."""
    return [run_synthetic_experiment(base_dir, h, **kwargs)
            for h in edge_homos]
