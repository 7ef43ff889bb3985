"""The counter rule of the configuration's dropout, in plain torch int64
arithmetic: a frozen copy of the rule the program states
(``acmgnn_tpu_torch/ops/dropout.py``), so the reference draws the masks
again from the same keys.

Philox4x32-10 (Salmon et al., SC 2011) of the counter ``(i // 4 mod 2^32,
i // 4 >> 32, epoch, site)`` under the key ``(seed, rank)``; element ``i``
takes word ``i % 4``.  It is kept where ``u < 1 - rate`` (``u`` the top 24
bits of its word times 2^-24) and becomes ``h / (1 - rate)`` in f32.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
ROUNDS = 10


def _mulhilo(m: int, c: torch.Tensor):
    p1 = c * (m >> 16)
    p0 = c * (m & 0xFFFF)
    mid = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (mid >> 32), mid & M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(shape, seed: int, epoch: int, site: int, rate: float,
              rank: int = 0, device=None) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64))
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    out = philox4x32(blocks & M32, blocks >> 32,
                     torch.full_like(blocks, epoch & M32),
                     torch.full_like(blocks, site & M32), seed & M32, rank)
    words = torch.stack(out, dim=1).reshape(-1)[:n]
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    return (u < float(np.float32(1.0 - rate))).reshape(shape)


def dropout(h: torch.Tensor, rate: float, seed: int, epoch: int,
            site: int) -> torch.Tensor:
    """Inverted dropout of ``h`` (f32) at ``site`` of epoch ``epoch``."""
    keep = keep_mask(h.shape, seed, epoch, site, rate, device=h.device)
    scale = torch.tensor(float(np.float32(1.0 - rate)), device=h.device)
    return torch.where(keep, h / scale, torch.zeros((), device=h.device))
