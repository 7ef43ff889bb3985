"""ACM-GNN model container — counterpart of ``acmgnn_tpu/models/models.py``.

Stacks per ``model_type`` (the JAX package's, ``MODEL_TYPES``):

- ``acmgcn``/``acmgcnp``/``acmgcnpp``, and the baselines ``gcn``/``mlp``
  and ``acmgraphsage``: two layers, ``conv(F->H) -> relu -> dropout ->
  conv(H->C)``, the ACM family's input dropout'd first; ``acmgcnpp``
  adds ``dropout(relu(mlpX(x)))`` as a skip into the second layer;
- ``acmsgc``/``sgc``: one layer (F->C) over ``Â^k``;
- ``acmsnowball``/``snowball``: densely concatenated blocks
  (``nlayers``), the input hoist on block 0 only;
- ``graphsage``: two ``SAGEConv`` layers; ``gcnII``: ``fc_in``, ``nlayers``
  ``GCNIIConv`` layers with the initial residual, ``fc_out``.

The paired eval forward of the joint training loop (``paired_eval``:
acmgcn/acmgcnp/acmgcnpp) shares every gather with the train forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from acmgnn_tpu_torch.models.layers import (
    ACM_FAMILY,
    MODEL_TYPES,
    ACMConv,
    Dense,
    GCNIIConv,
    MLPBlock,
    SAGEConv,
)
from acmgnn_tpu_torch.ops.dropout import Dropout, DropoutKey
from acmgnn_tpu_torch.ops.graph import Operators
from acmgnn_tpu_torch.ops.spmm import row_shard

PAIRED_EVAL = ("acmgcn", "acmgcnp", "acmgcnpp")


class ACMGNN(nn.Module):
    """The model of ``model_type``; parameters initialised from ``seed``."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, *,
                 model_type: str = "acmgcn", nlayers: int = 1,
                 dropout: float = 0.5, variant: bool = False,
                 structure_info: bool = False, use_layernorm: bool = False,
                 nnodes: Optional[int] = None, init_layers_X: int = 1,
                 alpha: float = 0.1, lamda: float = 0.5,
                 hoist_first: bool = False,
                 gemm_dtype: Optional[str] = None, seed: int = 0):
        super().__init__()
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type: {model_type!r}")
        self.model_type = model_type
        self.nlayers = nlayers
        self.dropout = dropout
        self.hoist_first = hoist_first
        gen = torch.Generator().manual_seed(seed)
        common = dict(model_type=model_type, variant=variant,
                      structure_info=structure_info,
                      use_layernorm=use_layernorm, nnodes=nnodes,
                      gemm_dtype=gemm_dtype, generator=gen)

        def conv(f_in, f_out, hoist=False):
            return ACMConv(f_in, f_out, input_hoist=hoist, **common)

        if model_type == "acmgcnpp":
            self.mlpX = MLPBlock(nfeat, nhid, nhid, num_layers=init_layers_X,
                                 gemm_dtype=gemm_dtype, generator=gen)
        if model_type in ("acmsnowball", "snowball"):
            for k in range(nlayers):
                setattr(self, f"gcn_{k}", conv(nfeat + k * nhid, nhid,
                                               hoist_first and k == 0))
            setattr(self, f"gcn_{nlayers}",
                    conv(nfeat + nlayers * nhid, nclass))
        elif model_type in ("acmsgc", "sgc"):
            self.gcn_0 = conv(nfeat, nclass,
                              hoist_first and model_type == "sgc")
        elif model_type == "graphsage":
            self.sage_0 = SAGEConv(nfeat, nhid, generator=gen)
            self.sage_1 = SAGEConv(nhid, nclass, generator=gen)
        elif model_type == "gcnII":
            self.fc_in = Dense(nfeat, nhid, generator=gen)
            for l in range(1, max(nlayers, 1) + 1):
                setattr(self, f"gcnII_{l}", GCNIIConv(
                    nhid, nhid, layer_index=l, alpha=alpha, lamda=lamda,
                    generator=gen))
            self.fc_out = Dense(nhid, nclass, generator=gen)
        else:
            self.gcn_0 = conv(nfeat, nhid, hoist_first)
            self.gcn_1 = conv(nhid, nclass)

    def forward(self, x: torch.Tensor, ops: Operators, *,
                training: bool = False, paired_eval: bool = False,
                key: Optional[DropoutKey] = None):
        """Logits; with ``paired_eval`` also the no-dropout eval logits of
        the same parameters, sharing every gather: ``(train, eval)``.  In
        train mode BatchNorm (acmgcnpp's ``mlpX``) updates its running
        statistics, which the paired eval branch then reads; on a sharded
        operator its statistics cover every rank's rows.  Dropout draws
        under ``key`` (``ops/dropout.py``; needed in train mode at a rate
        above 0), its sites numbered in call order from 0 each forward."""
        mt = self.model_type
        if paired_eval and mt not in PAIRED_EVAL:
            raise ValueError(f"paired_eval unsupported for {mt!r}")

        drop = Dropout(self.dropout, training, key)

        x_eval = x if paired_eval else None
        pre_dropped = mt in ACM_FAMILY
        if pre_dropped:
            x = drop(x)
        # ACM-family inputs were dropout'd: the precomputed aggregate is
        # valid only while dropout is a no-op (gcn/sgc/snowball feed raw X)
        agg0 = ops.x_agg if self.hoist_first else None
        train_agg = (agg0 if (not pre_dropped or self.dropout == 0.0
                              or not training) else None)

        if mt in ("acmsnowball", "snowball"):
            blocks = []
            for k in range(self.nlayers):
                inp = torch.cat([x] + blocks, dim=1) if blocks else x
                out = getattr(self, f"gcn_{k}")(
                    inp, ops, x_agg=train_agg if k == 0 else None)
                blocks.append(drop(torch.relu(out)))
            return getattr(self, f"gcn_{self.nlayers}")(
                torch.cat([x] + blocks, dim=1), ops)
        if mt in ("acmsgc", "sgc"):
            return self.gcn_0(x, ops,
                              x_agg=train_agg if mt == "sgc" else None)
        if mt == "graphsage":
            fea1 = drop(torch.relu(self.sage_0(x, ops)))
            return self.sage_1(fea1, ops)
        if mt == "acmgcnpp":
            return self._acmgcnpp(x, x_eval, ops, training, drop, train_agg,
                                  agg0)
        if mt == "gcnII":
            h = torch.relu(self.fc_in(drop(x)))
            h0 = h
            for l in range(1, max(self.nlayers, 1) + 1):
                h = torch.relu(getattr(self, f"gcnII_{l}")(drop(h), h0, ops))
            return self.fc_out(drop(h))
        if paired_eval:
            # the eval branch's layer-1 input is the raw feature matrix:
            # its precomputed aggregate is always valid
            fea1, fea1_eval = self.gcn_0(x, ops, x_eval=x_eval,
                                         x_agg=train_agg, x_eval_agg=agg0)
            fea1 = drop(torch.relu(fea1))
            fea1_eval = torch.relu(fea1_eval)
            return self.gcn_1(fea1, ops, x_eval=fea1_eval)
        fea1 = drop(torch.relu(self.gcn_0(x, ops, x_agg=train_agg)))
        return self.gcn_1(fea1, ops)

    def _acmgcnpp(self, x, x_eval, ops, training, drop, train_agg, agg0):
        """acmgcnpp's two layers with ``dropout(relu(mlpX(x)))`` added to
        layer 2's input (``x`` already dropout'd; ``x_eval``: the paired
        eval branch's raw features, or None).  With one Linear
        (``init_layers_X`` 1) ``mlpX`` reads layer 1's input alone: layer
        1 projects it with its own weights (``ACMConv``'s ``also``), so a
        bf16 operand is rounded once for all of them.  Layer 1 draws no
        dropout, so the sites keep their order: ``mlpX``'s, then layer
        1's output's."""
        lin0 = (self.mlpX.lin_0.kernel,) if self.mlpX.num_layers == 1 \
            else ()
        # xp / xp_eval: lin_0's product as ``mlpX``'s ``x_proj``, or () at
        # two Linears and more
        if x_eval is None:
            fea1, xp = self.gcn_0(x, ops, x_agg=train_agg, also=lin0)
        else:
            fea1, fea1_eval, xp, xp_eval = self.gcn_0(
                x, ops, x_eval=x_eval, x_agg=train_agg, x_eval_agg=agg0,
                also=lin0)
        xx = drop(torch.relu(self.mlpX(
            x, training, drop, row_shard(ops.adj_low), *xp)))
        del xp   # lin_0's product lives no longer than mlpX's own would
        fea1 = drop(torch.relu(fea1)) + xx
        if x_eval is None:
            return self.gcn_1(fea1, ops)
        # feeds metrics only; BatchNorm's statistics as the train branch
        # left them
        xx_eval = torch.relu(self.mlpX(x_eval, False, None, None,
                                       *xp_eval)).detach()
        del xp_eval
        fea1_eval = torch.relu(fea1_eval) + xx_eval
        return self.gcn_1(fea1, ops, x_eval=fea1_eval)
