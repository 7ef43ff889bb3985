"""The sharded SpMM's pack of a rank's operand slab, and its kernel (K6).

Before the exchange, each rank turns its own f32 slab ``x`` ``[rows, d]``
into the rows the others receive: the optional per-column sign of the
high-pass transpose and the optional ``pre_scale`` of a column-uniform
transpose half are applied in f32, then the result is rounded once into
the gather dtype (``acmgnn_tpu/parallel/sharded.py`` ``_pre_scale_block``).
In halo mode the same pass also gathers the send slab ``send[k] =
own[send_idx[k]]`` for every destination rank, reading ``x`` directly.
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


def halo_pack_plain(x: torch.Tensor, out: torch.Tensor,
                    pre_scale: Optional[torch.Tensor] = None, sign=None,
                    send_idx: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K6: writes ``out`` (the own slab, in the
    gather dtype ``out.dtype``) and returns the ``[n_send, d]`` send rows
    (None without ``send_idx``)."""
    own = _scaled(x, pre_scale, sign).to(out.dtype)
    out.copy_(own)
    if send_idx is None:
        return None
    return own[send_idx.reshape(-1).long()]


def _halo_pack_cuda(x, out, pre_scale, sign, send_idx):
    rows, d = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"K6 takes an f32 slab, got {x.dtype}")
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K6 writes bf16 or f32, got {out.dtype}")
    if out.shape != x.shape:
        raise ValueError(f"own slab {tuple(out.shape)} != operand "
                         f"{tuple(x.shape)}")
    if pre_scale is not None and pre_scale.shape != (rows,):
        raise ValueError("pre_scale must hold one value per slab row")
    sign_t = None if sign is None else column_constants(sign, x.device)
    arrays = [x, out] + [t for t in (pre_scale, sign_t, send_idx)
                         if t is not None]
    kernels.require_cuda(*arrays)
    n_send = 0 if send_idx is None else send_idx.numel()
    send = None
    if send_idx is not None:
        if send_idx.dtype != torch.int32:
            raise TypeError("send_idx must be int32")
        send = torch.empty(n_send, d, dtype=out.dtype, device=x.device)
    for t in (out, send):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("K6 outputs must be 16-byte aligned")
    lib = kernels.library("halo")
    rc = lib.acm_k6_halo_pack(
        kernels.ptr(x), kernels.ptr(sign_t), kernels.ptr(pre_scale), rows, d,
        int(out.dtype == torch.bfloat16), kernels.ptr(out),
        kernels.ptr(send_idx), n_send, kernels.ptr(send), kernels.stream(),
    )
    kernels.check(lib, rc, "K6 halo pack")
    kernels.count(f"k6_pack_w{d}")
    return send


def halo_pack(x: torch.Tensor, out: torch.Tensor,
              pre_scale: Optional[torch.Tensor] = None, sign=None,
              send_idx: Optional[torch.Tensor] = None):
    """``out[i, j] = cast(x[i, j]·sign[j]·pre_scale[i])`` into the
    preallocated own slab ``out`` (its dtype is the gather dtype), and with
    ``send_idx`` (int32, any shape) the send rows ``out[send_idx]``,
    returned as ``[send_idx.numel(), d]``.  A CPU slab runs the plain
    version; a CUDA slab launches K6."""
    if x.device.type == "cpu":
        return halo_pack_plain(x, out, pre_scale, sign, send_idx)
    return _halo_pack_cuda(x.contiguous(), out, pre_scale, sign,
                           None if send_idx is None else send_idx.contiguous())
