"""SpMM front end: ``spmm``, ``spmm_high``, ``spmm_transpose``,
``spmm_multi``, ``spmm_dual``.

Counterpart of ``acmgnn_tpu/ops/spmm.py``.  Every product is one call
of K1 on an ``EllOp`` (``ops/ell.py``) or of K5 on a ``CooOp``
(``ops/coo.py``); both kernels share one per-column epilogue.  On a
``DenseOp`` it is one f32 GEMM over all the operands (``torch.mm``:
cuBLAS on the card, as ``jnp.dot`` is XLA's in the JAX package), its
backward ``matᵀ @ g`` over the differentiable prefix.  On a
rank's share of a sharded operator (``parallel/sharded.py``) the product
packs and exchanges the operand rows first, and the operands, residuals
and results are the rank's ``[rows_per_part, d]`` slabs.
``spmm_multi`` fuses any number of operands that share the operator into
one traversal; its epilogue writes the high-pass ``z - Âz`` directly
(subtracting from the f32 ``z``, not its gather-dtype copy), and its
backward transposes only the differentiable prefix of the operands in one
more traversal (the COO transpose triplets, or the ELL transpose half),
adding the high-pass identity path ``g`` in the same epilogue.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from acmgnn_tpu_torch.ops.coo import coo_spmm
from acmgnn_tpu_torch.ops.ell import (
    column_constants,
    k1_operand,
    row_gather_spmm,
)
from acmgnn_tpu_torch.ops.graph import CooOp, DenseOp, EllOp
from acmgnn_tpu_torch.parallel.sharded import (
    ShardedCooOp,
    ShardedEllOp,
    sharded_ell_spmm,
    sharded_ell_spmm_transpose,
    sharded_spmm,
    sharded_spmm_transpose,
)

SparseOp = Union[DenseOp, EllOp, CooOp, ShardedEllOp, ShardedCooOp]


def _dense_epilogue(out, z, alpha, beta):
    """``alpha[j]·z[:, j] + beta[j]·out[:, j]`` per column (alpha 0 and
    beta 1 where None)."""
    dev = out.device
    if beta is not None:
        out = column_constants(beta, dev) * out
    if z is not None and alpha is not None and any(alpha):
        out = column_constants(alpha, dev) * z + out
    return out


def spmm_transpose(op: SparseOp, g: torch.Tensor, sign=None,
                   residual: Optional[torch.Tensor] = None,
                   residual_cols=None) -> torch.Tensor:
    """``Âᵀ (sign ⊙ g)`` [+ ``residual`` on ``residual_cols``].

    On an ``EllOp`` the operand is cast to the gather dtype, then
    pre-scaled in f32 and rounded once more (the JAX package's rounding
    order), into K1's row-padded layout (``k1_operand``); a ``CooOp``
    gathers f32 over its transpose triplets.  A sharded ELL operator
    pre-scales in f32 and rounds once, as the JAX package's sharded path
    does.  ``sign`` (±1 per column) is exact in any float format.
    """
    if isinstance(op, ShardedEllOp):
        return sharded_ell_spmm_transpose(op, g.float(), sign, residual,
                                          residual_cols)
    if isinstance(op, ShardedCooOp):
        return sharded_spmm_transpose(op, g.float(), sign, residual,
                                      residual_cols)
    x = g if sign is None else g * column_constants(sign, g.device)
    if isinstance(op, DenseOp):
        return _dense_epilogue(op.mat.T @ x.float(), residual, residual_cols,
                               None)
    if isinstance(op, CooOp):
        return coo_spmm(op.bwd, x.float(), z=residual, alpha=residual_cols)
    half = op.bwd
    if half.pre_scale is not None:
        x = x.to(op.gather_dtype)
    x = k1_operand(x, op.gather_dtype, half.pre_scale)
    return row_gather_spmm(half, x, z=residual, alpha=residual_cols)


class _FusedGather(torch.autograd.Function):
    """``[Âz_1 | z_2 - Âz_2 | ...]`` in one traversal; gradient only for
    the first ``grad_width`` columns."""

    @staticmethod
    def forward(ctx, op, hp_cols, grad_width, *zs):
        z_cat = zs[0] if len(zs) == 1 else torch.cat(zs, dim=1)
        alpha = tuple(1.0 if hp else 0.0 for hp in hp_cols)
        beta = tuple(-1.0 if hp else 1.0 for hp in hp_cols)
        residual = z_cat.float() if any(alpha) else None
        if isinstance(op, ShardedEllOp):
            out = sharded_ell_spmm(op, z_cat.float(), z=residual, alpha=alpha,
                                   beta=beta)
        elif isinstance(op, ShardedCooOp):
            out = sharded_spmm(op, z_cat.float(), z=residual, alpha=alpha,
                               beta=beta)
        elif isinstance(op, CooOp):
            out = coo_spmm(op.fwd, z_cat.float(), z=residual, alpha=alpha,
                           beta=beta)
        elif isinstance(op, DenseOp):
            az = op.mat @ z_cat.float()
            if z_cat.dtype == torch.bfloat16:
                # jnp.dot(mat, x_bf16, preferred_element_type=bf16)
                az = az.to(torch.bfloat16).float()
            out = _dense_epilogue(az, residual, alpha, beta)
        else:
            # K1 gathers a bf16 operand as it is (its values are exact in
            # f32), so bf16-stored features get no f32 copy (only a
            # row-padded one where K1's layout pads their rows)
            x = k1_operand(z_cat, torch.bfloat16
                           if z_cat.dtype == torch.bfloat16
                           else op.gather_dtype)
            out = row_gather_spmm(op.fwd, x, z=residual, alpha=alpha,
                                  beta=beta)
        ctx.op = op
        ctx.hp_cols = hp_cols
        ctx.grad_width = grad_width
        ctx.dims = [z.shape[1] for z in zs]
        return out

    @staticmethod
    def backward(ctx, g):
        gw = ctx.grad_width
        hp = ctx.hp_cols[:gw]
        g_pre = g[:, :gw].contiguous()
        dz_pre = spmm_transpose(
            ctx.op, g_pre, sign=[-1.0 if h else 1.0 for h in hp],
            residual=g_pre, residual_cols=[1.0 if h else 0.0 for h in hp],
        )
        grads, off = [], 0
        for i, d in enumerate(ctx.dims):
            if off + d <= gw:
                grads.append(dz_pre[:, off:off + d])
            elif ctx.needs_input_grad[3 + i] and ctx.hp_cols[off]:
                # outside the prefix only the identity path of z - Âz
                grads.append(g[:, off:off + d])
            else:
                grads.append(None)
            off += d
        return (None, None, None, *grads)


def spmm_multi(op_low: SparseOp, zs: Sequence[torch.Tensor],
               high_pass_flags: Sequence[bool],
               grad_prefix: Optional[int] = None):
    """One traversal serves every ``z_i``: ``Â z_i``, or ``z_i - Â z_i``
    where ``high_pass_flags[i]``.  With ``grad_prefix``, only the first
    ``grad_prefix`` operands are differentiable (the paired eval branch
    feeds metrics only), so the backward transposes just that prefix."""
    dims = [z.shape[1] for z in zs]
    hp_cols = tuple(h for z, h in zip(zs, high_pass_flags)
                    for _ in range(z.shape[1]))
    n_grad = len(zs) if grad_prefix is None else grad_prefix
    grad_width = sum(dims[:n_grad])
    both = _FusedGather.apply(op_low, hp_cols, grad_width, *zs)
    return list(torch.split(both, dims, dim=1))


def node_rows(op: SparseOp, t: torch.Tensor) -> torch.Tensor:
    """The rows of a replicated ``[N, ...]`` node tensor that ``op``'s
    products take as their operand: all of them, or on a rank's share of
    a sharded operator that rank's zero-padded slab
    (``ShardedOp.node_rows``)."""
    if isinstance(op, (ShardedEllOp, ShardedCooOp)):
        return op.node_rows(t)
    return t


def row_shard(op: SparseOp):
    """``op`` when it is a rank's share of a sharded operator (its node
    rows are the rank's slab), else None."""
    return op if isinstance(op, (ShardedEllOp, ShardedCooOp)) else None


def spmm(op: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``Â @ x`` (f32 result; the operand is gathered in the op's dtype)."""
    return spmm_multi(op, [x], [False])[0]


def spmm_high(op_low: SparseOp, x: torch.Tensor) -> torch.Tensor:
    """``(I - Â) @ x`` computed as ``x - Â x``."""
    return spmm_multi(op_low, [x], [True])[0]


def spmm_dual(op_low: SparseOp, z_low: torch.Tensor, z_high: torch.Tensor):
    """``(Â z_low, z_high - Â z_high)`` in one traversal: ``spmm_multi``
    with flags ``[False, True]``."""
    return tuple(spmm_multi(op_low, [z_low, z_high], [False, True]))
