"""Counter-based dropout keyed as the JAX package keys it (K8).

The JAX package draws each epoch's dropout from ``fold_in(run_key,
epoch)``: a pure function of the split's key and the epoch trained, so a
fused run and a stepwise run of one seed draw the same masks, and a body
repeated by a device loop draws a new mask each epoch.  Here a mask is a
pure function of (seed, rank, epoch, site, element index) through
Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011), with nothing carried from one draw to the next:

- the Philox key is ``(seed, rank)``: the split's seed (``cfg.seed +
  idx``) and, sharded, the rank, whose slab of rows draws its own stream;
- the counter of element ``i`` is ``(i // 4 mod 2^32, i // 4 >> 32,
  epoch, site)``, and the element takes word ``i % 4`` of the output;
- the seed and ``epoch`` are read from device int64 tensors when the
  kernel runs (the seed written once a split, the epoch the split loop's
  body counter ``LoopState.k``), so one captured body serves every split
  of a run, and a replayed or device-looped body draws each epoch's mask
  with nothing written from the host;
- ``site`` numbers the dropout calls of one forward in call order
  (``Dropout``); remat's recompute is a new forward and numbers them
  alike.

An element is kept when ``u < 1 - rate``, ``u`` the top 24 bits of its
word times 2^-24 (exact in f32), and a kept element is ``h / (1 - rate)``
in f32 (rounded once to bf16 for bf16 inputs), a dropped one 0: flax's
``nn.Dropout``.  The backward is the same function of the incoming
gradient with the same key: the mask is recomputed, nothing is saved
(on an H100 that measured faster than writing and reading a 1-byte mask:
PERF.md).

``dropout`` launches K8 (``csrc/dropout.cu``) on CUDA tensors and runs
``dropout_plain``, the same integer rounds in torch int64 arithmetic, on
CPU tensors; on the card the two are equal bit for bit.  K8 replaces no
TPU kernel: flax's dropout is not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from acmgnn_tpu_torch.ops import kernels

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """What a forward's dropout draws from: ``seed``, a 0-d int64 tensor
    on the device holding the split's seed (``set_seed``), this process's
    ``rank`` on the host, and ``epoch``, a 0-d int64 tensor on the device
    holding the epoch being trained (the split loop's ``k``)."""

    seed: torch.Tensor
    rank: int
    epoch: torch.Tensor

    def __post_init__(self):
        if not 0 <= self.rank <= M32:
            raise ValueError(f"rank {self.rank} outside [0, 2^32)")
        for t in (self.seed, self.epoch):
            if t.dtype != torch.int64 or t.dim() != 0:
                raise ValueError("DropoutKey's seed and epoch must be 0-d "
                                 "int64 tensors")

    @classmethod
    def new(cls, seed: int, rank: int, epoch: torch.Tensor) -> "DropoutKey":
        """A key whose seed tensor (on ``epoch``'s device) holds ``seed``."""
        key = cls(torch.zeros((), dtype=torch.int64, device=epoch.device),
                  rank, epoch)
        key.set_seed(seed)
        return key

    def set_seed(self, seed: int) -> None:
        """Write ``seed`` into the seed tensor, in place."""
        if not 0 <= seed <= M32:
            raise ValueError(f"dropout seed {seed} outside [0, 2^32)")
        self.seed.fill_(seed)


class Dropout:
    """One forward's dropout sites: each call that drops takes the next
    site (0, 1, ... in call order).  A call is the identity, and takes no
    site, unless ``training`` and its rate (``rate``, or the call's own)
    is above 0; a key is then required."""

    def __init__(self, rate: float, training: bool,
                 key: Optional[DropoutKey]):
        self.rate = float(rate)
        self.training = bool(training)
        self.key = key
        self.site = 0

    def __call__(self, h: torch.Tensor, rate: Optional[float] = None
                 ) -> torch.Tensor:
        rate = self.rate if rate is None else float(rate)
        if not self.training or rate == 0.0:
            return h
        if self.key is None:
            raise ValueError("dropout in train mode needs a DropoutKey")
        out = dropout(h, rate, self.key, self.site)
        self.site += 1
        return out


def keep_probability(rate: float) -> float:
    """``1 - rate`` rounded to f32: the threshold and the divisor."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return float(np.float32(1.0 - rate))


# ---------------------------------------------------------------------------
# The plain version: Philox4x32-10 in int64 arithmetic
# ---------------------------------------------------------------------------


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of ``m * c`` (``m`` a 32-bit constant, ``c``
    int64 tensors of 32-bit values), without int64 overflow: ``m`` in
    16-bit halves."""
    p1 = c * (m >> 16)              # < 2^48
    p0 = c * (m & 0xFFFF)           # < 2^48
    mid = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (mid >> 32), mid & M32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counters ``(c0, c1, c2, c3)`` (int64 tensors
    of 32-bit values, broadcast together) under the key ``(k0, k1)``
    (ints or int64 tensors of 32-bit values): its four output words."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words(n: int, key: DropoutKey, site: int, start: int = 0
          ) -> torch.Tensor:
    """The Philox words of elements ``start .. start + n - 1`` of one site,
    element ``i`` taking word ``i % 4`` of counter ``(i // 4, i // 4 >>
    32, epoch, site)``; int64 on the epoch tensor's device."""
    dev = key.epoch.device
    blocks = torch.arange(start // 4, (start + n + 3) // 4,
                          dtype=torch.int64, device=dev)
    epoch = key.epoch & M32
    out = philox4x32(blocks & M32, blocks >> 32, epoch.expand_as(blocks),
                     torch.full_like(blocks, site & M32), key.seed & M32,
                     key.rank)
    first = start % 4
    return torch.stack(out, dim=1).reshape(-1)[first:first + n]


def keep_mask(shape, key: DropoutKey, site: int, rate: float,
              start: int = 0) -> torch.Tensor:
    """The bool keep mask of ``shape`` at ``site``, its elements numbered
    from ``start``: ``u < 1 - rate``."""
    n = int(np.prod(shape, dtype=np.int64))
    u = (words(n, key, site, start) >> 8).to(torch.float32) * 2.0 ** -24
    return (u < keep_probability(rate)).reshape(shape)


def dropout_plain(h: torch.Tensor, rate: float, key: DropoutKey,
                  site: int, start: int = 0) -> torch.Tensor:
    """K8's plain version: ``h / (1 - rate)`` where kept (an elementwise f32
    division, rounded once to ``h``'s dtype), else 0.  ``start`` numbers
    ``h``'s elements from there: ``h`` is then the slab of a larger
    tensor that begins at its element ``start``."""
    keep = keep_mask(h.shape, key, site, rate, start)
    divisor = torch.full(h.shape, keep_probability(rate), dtype=torch.float32,
                         device=h.device)
    scaled = (h.to(torch.float32) / divisor).to(h.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=h.dtype,
                                                 device=h.device))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------


def _launch(h: torch.Tensor, rate: float, key: DropoutKey, site: int,
            name: str = "k8_dropout_fwd") -> torch.Tensor:
    """One K8 launch on ``h`` (contiguous f32 or bf16 on the card), counted
    under ``name``."""
    if h.dtype not in _DTYPES:
        raise ValueError(f"K8 takes f32 or bf16, got {h.dtype}")
    kernels.require_cuda(h, key.seed, key.epoch)
    out = torch.empty_like(h)
    lib = kernels.library("dropout")
    kernels.check(lib, lib.acm_k8_dropout(
        h.data_ptr(), out.data_ptr(), h.numel(), _DTYPES[h.dtype],
        int(h.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0),
        key.seed.data_ptr(), key.rank, key.epoch.data_ptr(), site,
        keep_probability(rate), kernels.stream()), "K8 dropout")
    kernels.count(name)
    return out


class _DropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, rate, key, site):
        ctx.args = (rate, key, site)
        return _launch(h.contiguous(), rate, key, site)

    @staticmethod
    def backward(ctx, g):
        return (_launch(g.contiguous(), *ctx.args, name="k8_dropout_bwd"),
                None, None, None)


def dropout(h: torch.Tensor, rate: float, key: DropoutKey,
            site: int) -> torch.Tensor:
    """Inverted dropout of ``h`` at ``site`` under ``key``: K8 on a CUDA
    tensor (forward and backward), ``dropout_plain`` on a CPU one."""
    if h.device.type == "cpu":
        return dropout_plain(h, rate, key, site)
    return _DropoutFn.apply(h, rate, key, site)
