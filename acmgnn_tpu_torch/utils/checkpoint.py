"""Checkpoint / resume — counterpart of ``acmgnn_tpu/utils/checkpoint.py``
(orbax there, ``torch.save`` here).

A snapshot is one file holding ``{"variables", "step"[, "opt_state"][,
"extra"]}``: ``variables`` is a model's ``state_dict()`` (parameters and
buffers, e.g. BatchNorm's running statistics), ``opt_state`` an
optimizer's ``state_dict()`` (Adam's moments and its step count, on the
device for the capturable form).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import torch


def save_checkpoint(path: str, variables: Any, opt_state: Any = None,
                    step: int = 0, extra: Optional[dict] = None) -> str:
    """Save a training snapshot; replaces any existing one at ``path``
    atomically (written beside it, then renamed), so an interrupted save
    leaves the previous snapshot whole."""
    payload = {"variables": variables, "step": step}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    if extra:
        payload["extra"] = extra
    p = Path(path).absolute()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, p)
    return str(p)


def restore_checkpoint(path: str, map_location=None) -> dict:
    """Restore a snapshot (tensors onto ``map_location``, default where
    they were saved).  Only tensors and plain containers are unpickled."""
    return torch.load(Path(path).absolute(), map_location=map_location,
                      weights_only=True)
