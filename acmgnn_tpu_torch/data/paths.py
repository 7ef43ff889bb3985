"""Data path resolution — counterpart of ``acmgnn_tpu/data/paths.py``.

Raw dataset files are searched across a list of roots: the colon-separated
``ACMGNN_DATA_PATH`` when it is set, else ``ACMGNN_DATA_HOME`` (default
``./data``).  The roots are read from the environment at each call.  The
JAX package also searches its bundled reference tree as a last default
root; the port bundles no dataset and searches only the roots above.
"""

from __future__ import annotations

import os
from pathlib import Path


def data_roots() -> list[Path]:
    env = os.environ.get("ACMGNN_DATA_PATH")
    if env:
        return [Path(p) for p in env.split(":") if p]
    return [Path(os.environ.get("ACMGNN_DATA_HOME", Path.cwd() / "data"))]


def find_data_file(*relparts: str) -> Path:
    """Resolve a data file across the search roots; raises with guidance."""
    rel = Path(*relparts)
    tried = []
    for root in data_roots():
        cand = root / rel
        tried.append(str(cand))
        if cand.exists():
            return cand
    raise FileNotFoundError(
        f"dataset file {rel} not found; searched: {tried}. "
        "Place the file under one of these roots or set ACMGNN_DATA_PATH."
    )
