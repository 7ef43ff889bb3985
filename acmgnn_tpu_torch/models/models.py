"""ACM-GNN model container — counterpart of ``acmgnn_tpu/models/models.py``.

Ported so far: the 2-layer ``acmgcn``/``acmgcnp`` stacks,
``dropout(x) -> ACMConv(F->H) -> relu -> dropout -> ACMConv(H->C)``, with
the paired eval forward of the joint training loop and the first-layer
input hoist.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmgnn_tpu_torch.models.layers import ACMConv
from acmgnn_tpu_torch.ops.graph import Operators


def dropout(h: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with an explicit generator (flax ``nn.Dropout``
    semantics: keep with probability ``1 - rate``, scale kept values)."""
    if not training or rate == 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) \
        < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


class ACMGNN(nn.Module):
    """Two ACM layers; parameters initialised from ``seed``."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, *,
                 model_type: str = "acmgcn", dropout: float = 0.5,
                 variant: bool = False, structure_info: bool = False,
                 use_layernorm: bool = False, hoist_first: bool = False,
                 gemm_dtype: Optional[str] = None, seed: int = 0):
        super().__init__()
        self.dropout = dropout
        self.hoist_first = hoist_first
        gen = torch.Generator().manual_seed(seed)
        common = dict(model_type=model_type, variant=variant,
                      structure_info=structure_info,
                      use_layernorm=use_layernorm, gemm_dtype=gemm_dtype,
                      generator=gen)
        self.gcn_0 = ACMConv(nfeat, nhid, input_hoist=hoist_first, **common)
        self.gcn_1 = ACMConv(nhid, nclass, **common)

    def forward(self, x: torch.Tensor, ops: Operators, *,
                training: bool = False, paired_eval: bool = False,
                generator: Optional[torch.Generator] = None):
        """Logits; with ``paired_eval`` also the no-dropout eval logits of
        the same parameters, sharing every gather: ``(train, eval)``."""

        def drop(h):
            return dropout(h, self.dropout, training, generator)

        x_eval = x if paired_eval else None
        x = drop(x)
        # the precomputed aggregate is valid only while dropout is a no-op
        agg0 = ops.x_agg if self.hoist_first else None
        train_agg = agg0 if (self.dropout == 0.0 or not training) else None
        if paired_eval:
            fea1, fea1_eval = self.gcn_0(x, ops, x_eval=x_eval,
                                         x_agg=train_agg, x_eval_agg=agg0)
            fea1 = drop(torch.relu(fea1))
            fea1_eval = torch.relu(fea1_eval)
            return self.gcn_1(fea1, ops, x_eval=fea1_eval)
        fea1 = drop(torch.relu(self.gcn_0(x, ops, x_agg=train_agg)))
        return self.gcn_1(fea1, ops)
