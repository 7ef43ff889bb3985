"""acmgnn_tpu_torch — the PyTorch/CUDA port of acmgnn_tpu for NVIDIA Hopper.

The JAX package ``acmgnn_tpu`` is the reference; this package mirrors its
file layout and names so each counterpart is easy to find.  It imports
torch, numpy and scipy only.  Its device kernels are hand-written CUDA C++
under ``csrc/`` (built with ``nvcc`` at first use, see ``ops/kernels.py``);
on a CPU tensor every kernel wrapper runs its plain PyTorch version.

Entry points place their tensors on the card unless the caller passes
``device="cpu"``; asking for the card on a host without one raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Raises when the card is asked for but missing — an
    entry point never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
