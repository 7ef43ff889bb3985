"""Logging and run statistics — a copy of ``acmgnn_tpu/utils/logging.py``.

``ExperimentLogger`` is a timestamped file + stdout logger; the entry
points take any object with its ``info`` / ``log_split`` / ``log_result``
methods as ``logger=``.  ``RunStats`` is the OGB-style accumulator of
``run_experiment_stepwise``.
"""

from __future__ import annotations

import csv
import datetime
import logging
import sys
from pathlib import Path
from typing import Optional

import numpy as np


class ExperimentLogger:
    """Timestamped file + stdout logger (one file per run under log_dir)."""

    def __init__(self, name: str = "acmgnn", log_dir: str = "./logs",
                 to_file: bool = True):
        self.name = name
        self.logger = logging.getLogger(f"{name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        self.log_path: Optional[Path] = None
        if to_file:
            stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
            path = Path(log_dir)
            path.mkdir(parents=True, exist_ok=True)
            self.log_path = path / f"{name}_{stamp}.log"
            fh = logging.FileHandler(self.log_path)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def info(self, msg: str, *args):
        self.logger.info(msg, *args)

    def log_split(self, idx: int, result):
        self.info(
            "split %d: test=%.4f val=%.4f epochs=%d",
            idx,
            float(result.test_metric),
            float(result.val_metric),
            int(result.epochs_run),
        )

    def log_result(self, out: dict):
        self.info(
            "%s/%s: test %.4f +- %.4f (%d splits, %.1fms/epoch)",
            out.get("dataset"),
            out.get("model"),
            out["test_mean"],
            out["test_std"],
            len(out.get("per_split", [])),
            out.get("epoch_ms_avg", float("nan")),
        )

    def append_csv(self, path: str, row: dict):
        """Reference-style results CSV appender."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        exists = p.exists()
        with open(p, "a+", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not exists:
                writer.writeheader()
            writer.writerow(row)


class RunStats:
    """OGB-style accumulator: per-run (train, valid, test) per epoch;
    final test reported at the argmax-valid epoch, mean ± std across
    runs."""

    def __init__(self, runs: int):
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result):
        if len(result) != 3:
            raise ValueError("a result is (train, valid, test)")
        self.results[run].append(tuple(float(r) for r in result))

    def run_summary(self, run: int):
        r = np.asarray(self.results[run])
        best_epoch = int(r[:, 1].argmax())
        return {
            "highest_train": float(r[:, 0].max()),
            "highest_valid": float(r[:, 1].max()),
            "final_test": float(r[best_epoch, 2]),
            "best_epoch": best_epoch,
        }

    def summary(self):
        per_run = [self.run_summary(i) for i in range(len(self.results))]
        valid = np.asarray([s["highest_valid"] for s in per_run])
        test = np.asarray([s["final_test"] for s in per_run])
        return {
            "valid_mean": float(valid.mean()),
            "valid_std": float(valid.std()),
            "test_mean": float(test.mean()),
            "test_std": float(test.std()),
            "per_run": per_run,
        }
