"""Row gather from a small panel held in shared memory, and its kernel (K7).

Counterpart of the two Pallas kernels of ``tools/pallas_gather_probe.py``
(``make_vmem_gather``, ``make_vmem_gather_bcast``): a P-row panel ``x``
``[P, D]`` and int32 indices, either per element ``[M, D]``
(``take_along_axis`` along the rows, P1) or per row ``[M]`` (P2).  On the
TPU the panel sat whole in VMEM; a Hopper block holds at most
``SMEM_BYTES`` of shared memory, so K7 (``csrc/panel_gather.cu``) gives
each block a slice of ``panel_columns`` columns for all P rows.
``panel_gather_plain`` is the plain PyTorch version.
"""

from __future__ import annotations

import torch

from acmgnn_tpu_torch.ops import kernels

# dynamic shared memory one Hopper block may use (H100: 227 KB)
SMEM_BYTES = 232_448


def panel_columns(p: int, d: int, elem_bytes: int) -> int:
    """K7's column slice width: the widest power of two ``dc`` with
    ``p·dc·elem_bytes <= SMEM_BYTES``, no wider than the panel needs.
    Raises when not even one column of the panel fits."""
    need = p * elem_bytes
    if need > SMEM_BYTES:
        raise ValueError(
            f"panel of {p} rows: one column takes {need} bytes of shared "
            f"memory, more than a block's {SMEM_BYTES}")
    dc = 1
    while dc < d and 2 * dc * need <= SMEM_BYTES:
        dc *= 2
    return dc


def panel_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: ``take_along_dim(x, idx, 0)`` for
    ``[M, D]`` indices, ``x[idx]`` for ``[M]``."""
    if idx.dim() == 1:
        return x[idx.long()]
    return torch.take_along_dim(x, idx.long(), 0)


def _check(x: torch.Tensor, idx: torch.Tensor):
    if x.dim() != 2:
        raise ValueError(f"the panel must be [P, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K7 gathers f32 or bf16, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"K7 takes int32 indices, got {idx.dtype}")
    if not (idx.dim() == 1 or (idx.dim() == 2 and idx.shape[1] == x.shape[1])):
        raise ValueError(f"indices must be [M] or [M, {x.shape[1]}], got "
                         f"{tuple(idx.shape)}")


def panel_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[m, j] = x[idx[m, j], j]`` (per-element indices ``[M, D]``)
    or ``x[idx[m], j]`` (per-row indices ``[M]``), in ``x``'s dtype.
    Indices are not range-checked.  A CPU panel runs the plain version;
    a CUDA panel launches K7."""
    _check(x, idx)
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return panel_gather_plain(x, idx)
    kernels.require_cuda(x, idx)
    p, d = x.shape
    m = idx.shape[0]
    dc = panel_columns(p, d, x.element_size())
    out = torch.empty(m, d, dtype=x.dtype, device=x.device)
    lib = kernels.library("panel_gather")
    rc = lib.acm_k7_panel_gather(
        kernels.ptr(x), kernels.ptr(idx), kernels.ptr(out), p, d, dc, m,
        x.element_size(), int(idx.dim() == 1), kernels.stream())
    kernels.check(lib, rc, "K7 panel gather")
    kernels.count("K7")
    return out
