"""Hyperparameter grid search — counterpart of ``acmgnn_tpu/train/sweep.py``.

A grid that varies only (lr, weight_decay, dropout) takes the fast path,
as the JAX package's (``acmgnn_tpu/train/sweep.py:124-145``): the data is
prepared once for the whole search (``prepare_data``), one model and one
split runner are built per dropout value, and each (lr, weight_decay)
point is one ``run_experiment`` on them with the pair as ``hparams``,
which the runner writes into its optimizer's tensors: on the card one
capture per dropout value, every split of every (lr, wd) point running
in the device loop around it (JAX compiles once a dropout value, its
``hparams`` traced).  A grid over any other key runs ``run_experiment``
once per configuration.

The default grids are the reference search scripts' (9 weight decays;
deezer-europe shrinks both the lr and the weight-decay lists; acmsgc
takes no dropout).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Optional

from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig

DEFAULT_GRID = {
    "lr": [0.01, 0.05, 0.1],
    "weight_decay": [0.0, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2],
    "dropout": [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9],
}

# per-dataset overrides of the reference search scripts
DATASET_GRIDS = {
    "deezer-europe": {
        "lr": [0.002, 0.01, 0.05],
        "weight_decay": [0.0, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3],
    },
}
MODEL_GRIDS = {
    "acmsgc": {"dropout": [0.0]},
}
FAST_KEYS = {"lr", "weight_decay", "dropout"}


def resolve_grid(base_cfg: TrainConfig, grid: Optional[dict] = None,
                 dataset: str = "") -> dict:
    """The default grid, then the dataset's and the model's overrides,
    then ``grid``'s."""
    g = dict(DEFAULT_GRID)
    g.update(DATASET_GRIDS.get(dataset, {}))
    g.update(MODEL_GRIDS.get(base_cfg.model_type, {}))
    if grid:
        g.update(grid)
    return g


def build_grid(base_cfg: TrainConfig, grid: Optional[dict] = None,
               dataset: str = "") -> list[TrainConfig]:
    """Every configuration of the grid, keys in sorted order."""
    g = resolve_grid(base_cfg, grid, dataset)
    keys = sorted(g)
    return [dataclasses.replace(base_cfg, **dict(zip(keys, values)))
            for values in itertools.product(*(g[k] for k in keys))]


def grid_search(dataset, base_cfg: TrainConfig, grid: Optional[dict] = None,
                logger=None, select: str = "test_mean",
                out_path: str | Path | None = None, device=None) -> dict:
    """Run the grid; returns the best result dict (by ``select``) with its
    ``config``.  ``out_path`` keeps every configuration's result as JSON;
    ``device`` is the entry points' (the card unless asked otherwise)."""
    name = dataset if isinstance(dataset, str) else dataset.name
    g = resolve_grid(base_cfg, grid, dataset=name)
    all_results = []

    def note(i, total, cfg, out):
        if logger is not None:
            logger.info(
                "grid %d/%d lr=%g wd=%g dropout=%g -> %.4f +- %.4f",
                i + 1, total, cfg.lr, cfg.weight_decay, cfg.dropout,
                out["test_mean"], out["test_std"])

    if set(g) - FAST_KEYS:
        configs = build_grid(base_cfg, grid, dataset=name)
        for i, cfg in enumerate(configs):
            out = trainer.run_experiment(dataset, cfg, device=device)
            out["config"] = dataclasses.asdict(cfg)
            note(i, len(configs), cfg, out)
            all_results.append(out)
    else:
        prepared = trainer.prepare_data(dataset, base_cfg, device=device)
        x, nclass = prepared[2], prepared[5]
        total = len(g["dropout"]) * len(g["lr"]) * len(g["weight_decay"])
        i = 0
        for dropout in g["dropout"]:
            cfg_d = dataclasses.replace(base_cfg, dropout=dropout)
            model = trainer.build_model(cfg_d, x.shape[1], nclass,
                                        device=x.device, seed=cfg_d.seed,
                                        nnodes=x.shape[0])
            split_runner = trainer.make_split_runner(model, cfg_d)
            for lr, wd in itertools.product(g["lr"], g["weight_decay"]):
                cfg = dataclasses.replace(cfg_d, lr=lr, weight_decay=wd)
                out = trainer.run_experiment(
                    dataset, cfg, prepared=prepared,
                    split_runner=split_runner, hparams=(lr, wd))
                out["config"] = dataclasses.asdict(cfg)
                note(i, total, cfg, out)
                all_results.append(out)
                i += 1
            split_runner.release()

    best = max(all_results, key=lambda r: r[select])
    if logger is not None:
        logger.info(
            "grid best: %.4f +- %.4f with %s", best["test_mean"],
            best["test_std"],
            {k: best["config"][k] for k in ("lr", "weight_decay", "dropout")})
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({
            "dataset": name,
            "model": base_cfg.model_type,
            "variant": base_cfg.variant,
            "structure_info": base_cfg.structure_info,
            "fixed_splits": base_cfg.fixed_splits,
            "select": select,
            "best": best,
            "grid": all_results,
        }, indent=1))
    return best
