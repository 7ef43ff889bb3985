"""Unified training configuration — a copy of ``acmgnn_tpu/train/config.py``.

The fields and defaults are the JAX package's, so one config reads the
same in both.  Fields whose code paths are not ported yet are accepted
here and refused where they would take effect.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TrainConfig:
    # model
    model_type: str = "acmgcn"
    hidden: int = 64
    nlayers: int = 1                  # acmsnowball depth
    variant: bool = False             # ACMII
    structure_info: bool = False      # 4th structure channel
    use_layernorm: Optional[bool] = None  # None => per-pipeline default
    init_layers_X: int = 1            # acmgcnpp skip-MLP depth
    hops: int = 1                     # acmsgc k-hop
    alpha: float = 0.1                # gcnII initial-residual strength
    lamda: float = 0.5                # gcnII identity-map decay

    # optimization
    lr: float = 0.05
    weight_decay: float = 5e-4
    dropout: float = 0.5
    epochs: int = 1000
    early_stopping: int = 200         # 0 disables; mean-val-loss window
    optimizer: str = "adam"           # "adam" (torch-style L2) | "adamw"

    # protocol
    selection: str = "val_loss"       # "val_loss" | "val_metric"
    metric: str = "acc"               # "acc" | "rocauc"
    loss: str = "nll"                 # "nll" | "bce"
    num_splits: int = 10
    fixed_splits: bool = False
    directed: bool = False
    sub_dataset: str = ""
    seed: int = 42

    # data/operators
    normalization: str = "row"        # low-pass normalization
    operator_format: str = "auto"     # "auto" | "dense" | "coo" | "ell"
    spmm_dtype: str = "float32"       # "bfloat16": halve gather traffic
    gemm_dtype: str = "float32"       # "float32" | "bfloat16"
    reorder: str = "none"             # "rcm"|"degree": gather-locality perm
    partition: str = "contiguous"
    ell_hub_threshold: int = 0        # TPU layout knob; no effect here
    ell_block: int = 0                # TPU layout knob; 0/1 only here
    joint: bool = False               # paired train+eval loop
    hoist_first: bool = False         # first-layer input hoist
    hoist_agg_dtype: str = "auto"     # "auto" | "float32" | "bfloat16"
    remat: bool = False
    feature_dtype: str = "float32"    # "float32" | "bfloat16"
    feature_normalize: Optional[bool] = None  # None => reference rule

    def resolve_layernorm(self) -> bool:
        """LN-pre-attention default: live for acmgcnp/pp."""
        if self.use_layernorm is not None:
            return self.use_layernorm
        return self.model_type in ("acmgcnp", "acmgcnpp")

    def resolve_hoist(self) -> bool:
        """Hoisting applies only to variant-0 layer-1s whose input is the
        feature matrix."""
        return (
            self.hoist_first
            and not self.variant
            and self.model_type
            in ("acmgcn", "acmgcnp", "acmgcnpp", "acmsnowball",
                "gcn", "sgc", "snowball")
        )

    def resolve_hoist_agg_dtype(self, num_nodes: int, num_features: int):
        """Storage dtype of the precomputed hoist aggregate: a torch dtype,
        or None for float32 (no cast)."""
        if self.hoist_agg_dtype == "bfloat16":
            return torch.bfloat16
        if self.hoist_agg_dtype == "float32":
            return None
        if self.hoist_agg_dtype != "auto":
            raise ValueError(
                f"unknown hoist_agg_dtype {self.hoist_agg_dtype!r}")
        from acmgnn_tpu_torch.models.layers import HOIST_MAX_COLS

        if (
            self.spmm_dtype == "bfloat16"
            and num_features > HOIST_MAX_COLS
            and 4 * num_nodes * num_features > 2**30
        ):
            return torch.bfloat16
        return None

    def resolve_for_dataset(self, dataset_name: str) -> "TrainConfig":
        """deezer-europe's forced protocol (AdamW, 500 epochs, fixed
        splits, best-val-metric selection)."""
        if dataset_name == "deezer-europe":
            return dataclasses.replace(
                self, optimizer="adamw", epochs=500, fixed_splits=True,
                selection="val_metric",
            )
        return self

    def resolve_feature_normalize(self) -> bool:
        """Features are row-normalized unless acmgcnp/pp with
        structure_info."""
        if self.feature_normalize is not None:
            return self.feature_normalize
        return not (
            self.model_type in ("acmgcnp", "acmgcnpp") and self.structure_info
        )
