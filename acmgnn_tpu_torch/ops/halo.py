"""The sharded SpMM's pack of a rank's operand slab, and its kernel (K6).

Before the exchange, each rank turns its own f32 slab ``x`` ``[rows, d]``
into the rows the others receive: the optional per-column sign of the
high-pass transpose and the optional ``pre_scale`` of a column-uniform
transpose half are applied in f32, then the result is rounded once into
the gather dtype (``acmgnn_tpu/parallel/sharded.py`` ``_pre_scale_block``).
In halo mode the same pass also gathers the send slab ``send[k] =
own[send_idx[k]]`` for every destination rank, reading ``x`` directly.
Both are written in K1's row-padded operand layout when the caller passes
its row stride ``ld`` (``ops/ell.py`` ``k1_operand_ld``) and a ``[rows,
d]`` view of ``[rows, ld]`` rows: the padding columns hold 0, and the
exchange moves whole padded rows.
``halo_pack_plain`` is the plain PyTorch version; ``halo_pack`` launches K6
(``csrc/halo.cu``) on a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.ell import column_constants


def _scaled(x, pre_scale, sign):
    y = x.float()
    if sign is not None:
        y = y * column_constants(sign, x.device)
    if pre_scale is not None:
        y = y * pre_scale[:, None]
    return y


def padded_rows(t: torch.Tensor) -> torch.Tensor:
    """The ``[rows, ld]`` rows a row-padded ``[rows, d]`` view lies in
    (``ld = t.stride(0)``; ``t`` itself where it is contiguous), for
    reading a packed buffer whole."""
    if t.dim() != 2 or t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"expected a [rows, d] view with unit column "
                         f"stride and row stride >= d, got shape "
                         f"{tuple(t.shape)} strides {t.stride()}")
    return t.as_strided((t.shape[0], t.stride(0)), (t.stride(0), 1))


def _out_rows(out: torch.Tensor, d: int, ld: Optional[int]) -> int:
    """The row stride the pack writes: ``ld`` where the caller names it
    (its columns ``d`` to ``ld`` are padding the pack zeroes), else ``d``;
    ``out`` must have it, so a view the caller did not declare padded
    (a column slice of a wider tensor), or whose last row's padding
    would fall past its storage, is refused."""
    ld = d if ld is None else ld
    if (out.dim() != 2 or out.shape[1] != d or ld < d or out.stride(1) != 1
            or (out.shape[0] > 1 and out.stride(0) != ld)
            or out.storage_offset() + out.shape[0] * ld
            > out.untyped_storage().nbytes() // out.element_size()):
        raise ValueError(f"the own slab must be a [rows, {d}] view of rows "
                         f"of {ld} (pass ld for a row-padded buffer), got "
                         f"shape {tuple(out.shape)} strides {out.stride()}")
    return ld


def halo_pack_plain(x: torch.Tensor, out: torch.Tensor,
                    pre_scale: Optional[torch.Tensor] = None, sign=None,
                    send_idx: Optional[torch.Tensor] = None,
                    ld: Optional[int] = None):
    """Plain PyTorch version of K6: writes ``out`` (the own slab, in the
    gather dtype ``out.dtype``, row stride ``ld``) with zero padding, and
    returns the ``[n_send, d]`` send rows at the same row stride, padding
    zero too (None without ``send_idx``)."""
    d = x.shape[1]
    ld = _out_rows(out, d, ld)
    own = _scaled(x, pre_scale, sign).to(out.dtype)
    full = out.as_strided((out.shape[0], ld), (ld, 1))
    full[:, d:] = 0
    out.copy_(own)
    if send_idx is None:
        return None
    send = torch.zeros(send_idx.numel(), ld, dtype=out.dtype,
                       device=out.device)
    send[:, :d] = own[send_idx.reshape(-1).long()]
    return send[:, :d]


def _halo_pack_cuda(x, out, pre_scale, sign, send_idx, ld):
    rows, d = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"K6 takes an f32 slab, got {x.dtype}")
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K6 writes bf16 or f32, got {out.dtype}")
    if out.shape != x.shape:
        raise ValueError(f"own slab {tuple(out.shape)} != operand "
                         f"{tuple(x.shape)}")
    ld = _out_rows(out, d, ld)
    if pre_scale is not None and pre_scale.shape != (rows,):
        raise ValueError("pre_scale must hold one value per slab row")
    sign_t = None if sign is None else column_constants(sign, x.device)
    arrays = [x] + [t for t in (pre_scale, sign_t, send_idx)
                    if t is not None]
    kernels.require_cuda(*arrays, strided=(out,))
    n_send = 0 if send_idx is None else send_idx.numel()
    send = None
    if send_idx is not None:
        if send_idx.dtype != torch.int32:
            raise TypeError("send_idx must be int32")
        send = torch.empty(n_send, ld, dtype=out.dtype,
                           device=x.device)[:, :d]
    for t in (out, send):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("K6 outputs must be 16-byte aligned")
    lib = kernels.library("halo")
    rc = lib.acm_k6_halo_pack(
        kernels.ptr(x), kernels.ptr(sign_t), kernels.ptr(pre_scale), rows, d,
        ld, int(out.dtype == torch.bfloat16), kernels.ptr(out),
        kernels.ptr(send_idx), n_send, kernels.ptr(send), kernels.stream(),
    )
    kernels.check(lib, rc, "K6 halo pack")
    kernels.count(f"k6_pack_w{d}")
    return send


def halo_pack(x: torch.Tensor, out: torch.Tensor,
              pre_scale: Optional[torch.Tensor] = None, sign=None,
              send_idx: Optional[torch.Tensor] = None,
              ld: Optional[int] = None):
    """``out[i, j] = cast(x[i, j]·sign[j]·pre_scale[i])`` into the
    preallocated own slab ``out`` (its dtype is the gather dtype), and
    with ``send_idx`` (int32, any shape) the send rows ``out[send_idx]``,
    returned as ``[send_idx.numel(), d]`` at ``out``'s row stride
    (``padded_rows`` gives the whole rows).  ``out`` has rows of ``d``,
    or with ``ld`` it is the ``[:, :d]`` view of ``[rows, ld]`` rows
    (K1's operand layout), whose padding columns are written as 0.  A CPU
    slab runs the plain version; a CUDA slab launches K6."""
    if x.device.type == "cpu":
        return halo_pack_plain(x, out, pre_scale, sign, send_idx, ld)
    return _halo_pack_cuda(x.contiguous(), out, pre_scale, sign,
                           None if send_idx is None else send_idx.contiguous(),
                           ld)
