"""Row gather from a small panel held on chip, and its kernel (K7).

Counterpart of the two Pallas kernels of ``tools/pallas_gather_probe.py``
(``make_vmem_gather``, ``make_vmem_gather_bcast``): a P-row panel ``x``
``[P, D]`` and int32 indices, either per element ``[M, D]``
(``take_along_axis`` along the rows, P1) or per row ``[M]`` (P2).  On the
TPU the panel sat whole in VMEM; a Hopper block holds at most
``SMEM_BYTES`` of shared memory, so K7 (``csrc/panel_gather.cu``) keeps a
panel that fits in every block's shared memory and reads a larger one
through L2; every warp writes whole output rows.  ``panel_plan`` is that
size rule, a pure function; ``panel_gather_plain`` is the plain PyTorch
version.
"""

from __future__ import annotations

import ctypes

import torch

from acmgnn_tpu_torch.ops import kernels

# dynamic shared memory one Hopper block may use (H100: 227 KB)
SMEM_BYTES = 232_448
# the kernel's panel source, as csrc/panel_gather.cu numbers it
FORMS = {"l2": 0, "block": 1}


def panel_plan(p: int, d: int, elem_bytes: int) -> str:
    """Where K7 reads the rows of a ``[p, d]`` panel of ``elem_bytes``
    elements: "block" (every block holds the whole panel in shared
    memory) where one block's shared memory holds it, else "l2" (from
    device memory through L2), which beat a thread-block cluster holding
    the panel split by rows at every probe panel that needs one (H100,
    PERF.md §6).  Every size has a form."""
    return "block" if p * d * elem_bytes <= SMEM_BYTES else "l2"


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


_resident: dict = {}


def resident(form: str, x: torch.Tensor, per_row: bool) -> int:
    """Blocks of K7 in ``form`` that the card holds at once for the panel
    ``x``, asked of the occupancy API once per shape and kernel instance
    (the first query also sets the instance's shared-memory limit).
    Raises, naming the panel's bytes, when none fits."""
    key = (form, tuple(x.shape), x.element_size(), per_row, x.device)
    n = _resident.get(key)
    if n is None:
        active = ctypes.c_int(0)
        lib = kernels.library("panel_gather")
        rc = lib.acm_k7_panel_gather(
            None, None, None, x.shape[0], x.shape[1], x.element_size(), 0,
            int(per_row), FORMS[form], 0, ctypes.byref(active), None)
        kernels.check(lib, rc, "K7 occupancy query")
        n = active.value
        if n <= 0:
            raise ValueError(
                f"K7 {form} form: no block fits the card (panel of "
                f"{x.numel() * x.element_size()} bytes)")
        _resident[key] = n
    return n


def _launch(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """K7 on CUDA tensors in ``form``: ``panel_gather`` with the plan's
    form; another form only to time it against the plan's."""
    kernels.require_cuda(x, idx)
    p, d = x.shape
    s = x.element_size()
    if form == "block" and p * d * s > SMEM_BYTES:
        raise ValueError(f"K7 block form: a panel of {p * d * s} bytes "
                         f"exceeds a block's {SMEM_BYTES} bytes of shared "
                         f"memory")
    per_row = idx.dim() == 1
    if x.data_ptr() % 16:
        raise ValueError("K7's panel must be 16-byte aligned")
    if not per_row and idx.data_ptr() % 16:
        # a unit's indices are one vector load
        raise ValueError("K7's per-element indices must be 16-byte aligned")
    n = resident(form, x, per_row)
    m = idx.shape[0]
    out = torch.empty(m, d, dtype=x.dtype, device=x.device)
    lib = kernels.library("panel_gather")
    rc = lib.acm_k7_panel_gather(
        kernels.ptr(x), kernels.ptr(idx), kernels.ptr(out), p, d, s, m,
        int(per_row), FORMS[form], n, None, kernels.stream())
    kernels.check(lib, rc, "K7 panel gather")
    kernels.count("K7")
    return out


def panel_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[m, j] = x[idx[m, j], j]`` (per-element indices ``[M, D]``)
    or ``x[idx[m], j]`` (per-row indices ``[M]``), in ``x``'s dtype.
    Indices are not range-checked.  A CPU panel runs the plain version;
    a CUDA panel launches K7 in ``panel_plan``'s form."""
    _check(x, idx)
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return panel_gather_plain(x, idx)
    p, d = x.shape
    return _launch(x, idx, panel_plan(p, d, x.element_size()))
