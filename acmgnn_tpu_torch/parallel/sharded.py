"""Sharded SpMM over ``torch.distributed``: one row partition per rank.

Counterpart of ``acmgnn_tpu/parallel/sharded.py``.  The operator is 1-D
row-partitioned with the JAX package's boundaries and padded node layout
(``parallel/partition.py``): rank p owns node rows
``boundaries[p]:boundaries[p+1]``, stored as a zero-padded
``[rows_per_part, ...]`` slab of every node array, and the model's weights
are replicated.  A ``ShardedEllOp`` or ``ShardedCooOp`` is one rank's
share: its local block of ``Â`` and of ``Âᵀ`` as a rectangular half
(``rows_per_part`` output rows) whose columns index its receive buffer,
and the exchange schedule that fills that buffer.

A product ``Â x`` (or ``Âᵀ g``) on the rank's slab ``x`` is three steps:

1. K6 (``ops/halo.py``) packs the slab: optional per-column sign and
   pre-scale in f32, one rounding into the gather dtype, rows written at
   the receive buffer's row stride (an ELL operator's is K1's padded
   stride, ``k1_operand_ld``: bf16 rows of 7 columns take 16 bytes);
2. the collective fills the receive buffer: an all-gather of every
   rank's packed slab (``P·rows_per_part`` rows), or in halo mode an
   ``all_to_all`` of the deduplicated boundary rows, written in place
   behind the rank's own slab (``rows_per_part + P·halo_pad`` rows; slot q
   holds what rank q sent);
3. K1 (ELL) or K5 (COO) aggregates the local half over the buffer, with
   the single-chip per-column epilogue.

The backward is the same over the transpose half and its schedule: both
matrices are split on the same rows, so ``Âᵀ g`` lands row-partitioned
like ``x``.  ``ops/spmm.py`` dispatches ``spmm``, ``spmm_transpose`` and
``spmm_multi`` (with its prefix-gradient backward) to these functions.

Every row of a local half is summed in the single-chip half's order, so a
sharded run rounds as the single-chip port does: an ELL row lists its
columns in node order (a halo half's columns are receive-buffer slots,
which would put the own rows first), and a COO half keeps the whole
matrix's K5 slice grid (``nnz_offset``).

The ELL halves follow the single-chip port's rules (``ops/ell.py``):
value-free halves with a per-row ``row_scale``, a column-uniform
transpose that pre-scales the operand (here: each rank its own slab,
inside K6), a transpose that shares the forward's structure arrays when
the binary structure is symmetric, and valued halves (symmetric
normalization, weighted graphs) whose values are stored in the gather
dtype, each product rounded to it.  A matrix equal to its transpose
(the symmetric operator, the raw adjacency of the structure channel)
has one half for both directions.  The JAX package's class planes, hub
blocks and their environment knobs are its TPU layout and are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.ops.coo import CooHalf, coo_spmm, make_coo_half
from acmgnn_tpu_torch.ops.ell import (
    EllHalf,
    _build_half,
    _row_uniform_values,
    k1_operand_ld,
    row_gather_spmm,
)
from acmgnn_tpu_torch.ops.graph import (
    Operators,
    row_normalized_adjacency,
    sym_normalized_adjacency,
)
from acmgnn_tpu_torch.ops.halo import halo_pack, padded_rows
from acmgnn_tpu_torch.parallel.multihost import (
    all_gather_rows,
    all_to_all_rows,
    shard_node_array_per_host,
)
from acmgnn_tpu_torch.parallel.partition import (
    build_halo_schedule,
    build_sharded_coo,
)


@dataclasses.dataclass
class _ShardedOp:
    """One rank's share of a row-partitioned operator and its transpose."""

    fwd: Union[EllHalf, CooHalf]    # local A block over the receive buffer
    bwd: Union[EllHalf, CooHalf]    # local Aᵀ block
    rank: int
    world_size: int
    rows_per_part: int
    num_nodes: int
    nnz: int
    boundaries: np.ndarray
    # halo exchange (None: all-gather): this rank's send lists, [P(dest),
    # halo_pad] local rows, and the slab width, for A and for Aᵀ
    send_idx: Optional[torch.Tensor] = None
    send_idx_t: Optional[torch.Tensor] = None
    halo_pad: int = 0
    halo_pad_t: int = 0
    # real (unpadded) rows this rank sends and receives per product
    rows_sent: int = 0
    rows_received: int = 0
    group: object = None            # process group; None: the default one

    def node_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's zero-padded ``[rows_per_part, ...]`` slab of a
        replicated ``[N, ...]`` node tensor (rows ``boundaries[rank]:
        boundaries[rank + 1]``), differentiable: the structure channel's
        embedding, a parameter every rank holds whole."""
        r0, r1 = (int(self.boundaries[self.rank]),
                  int(self.boundaries[self.rank + 1]))
        rows = t[r0:r1]
        pad = self.rows_per_part - (r1 - r0)
        if pad:
            rows = torch.cat([rows, rows.new_zeros((pad,) + t.shape[1:])])
        return rows

    def exchange_rows(self, transpose: bool = False) -> int:
        """Rows of the receive buffer a product gathers from."""
        pad = self.halo_pad_t if transpose else self.halo_pad
        send = self.send_idx_t if transpose else self.send_idx
        if send is None:
            return self.world_size * self.rows_per_part
        return self.rows_per_part + self.world_size * pad

    def _move_halves(self, device):
        fwd = self.fwd.to(device)
        return fwd, (fwd if self.bwd is self.fwd else self.bwd.to(device))

    def to(self, device):
        move = (lambda t: None if t is None else t.to(device))
        fwd, bwd = self._move_halves(device)
        return dataclasses.replace(self, fwd=fwd, bwd=bwd,
                                   send_idx=move(self.send_idx),
                                   send_idx_t=move(self.send_idx_t))


@dataclasses.dataclass
class ShardedEllOp(_ShardedOp):
    """ELL halves (degree-sorted CSR, K1); operand rows are packed in
    ``gather_dtype`` (bf16 on the headline path)."""

    gather_dtype: torch.dtype = torch.float32

    def row_stride(self, d: int) -> int:
        """The receive buffer's row stride: K1's (``k1_operand_ld``), so
        K6 writes and the collectives move whole padded rows."""
        return k1_operand_ld(d, self.gather_dtype)

    def _move_halves(self, device):
        memo: dict = {}     # a shared transpose stays shared
        fwd = self.fwd.to(device, memo)
        return fwd, (fwd if self.bwd is self.fwd
                     else self.bwd.to(device, memo))


@dataclasses.dataclass
class ShardedCooOp(_ShardedOp):
    """COO halves (K5); operand, values and sums are f32, as the JAX
    package's sharded COO path."""

    gather_dtype: ClassVar[torch.dtype] = torch.float32

    def row_stride(self, d: int) -> int:
        """Rows of ``d``: ``coo_spmm`` makes its operand contiguous
        (``ops/coo.py``), so a padded receive buffer would be copied
        once more; giving K5 a row stride is a later item (ROADMAP)."""
        return d


ShardedOp = Union[ShardedEllOp, ShardedCooOp]


def _choose_halo(blocks: dict, exchange: str, n_parts: int) -> dict:
    """The halo schedule when ``exchange`` is "halo", or "auto" and its
    padded per-rank volume is under half the all-gather's; ``{}`` means
    all-gather (the JAX package's rule)."""
    if exchange not in ("allgather", "halo", "auto"):
        raise ValueError(f"unknown exchange mode: {exchange!r}")
    if exchange == "allgather" or n_parts <= 1:
        return {}
    sched = build_halo_schedule(blocks)
    rpp = int(blocks["rows_per_part"])
    halo_vol = n_parts * max(sched["halo_pad"], sched["halo_pad_t"])
    allgather_vol = (n_parts - 1) * rpp
    if exchange == "halo" or halo_vol < 0.5 * allgather_vol:
        return sched
    return {}


def _slab(values: np.ndarray, boundaries, rows_per_part: int, rank: int):
    """This rank's zero-padded f32 slab of a per-node vector."""
    return shard_node_array(np.asarray(values, np.float32), boundaries,
                            rows_per_part, rank)


def _build_blocks(adj_op, world_size, boundaries, exchange):
    """Every rank's block triplets and, for a halo exchange, the schedule
    with ``pair_rows``: [P(owner), P(dest)] distinct rows each owner sends
    each consumer per forward product."""
    blocks = build_sharded_coo(adj_op, world_size, boundaries=boundaries)
    halo = _choose_halo(blocks, exchange, world_size)
    if halo:
        rpp = int(blocks["rows_per_part"])
        pairs = np.zeros((world_size, world_size), np.int64)
        for p, col_h in enumerate(halo["col_h"]):
            slots = np.unique(col_h[col_h >= rpp]) - rpp
            pairs[:, p] = np.bincount(slots // halo["halo_pad"],
                                      minlength=world_size)
        halo["pair_rows"] = pairs
    return blocks, halo


def _common(blocks, halo, rank, world_size):
    """The fields of a rank's op that do not depend on the format."""
    rpp = int(blocks["rows_per_part"])
    common = dict(
        rank=rank, world_size=world_size, rows_per_part=rpp,
        num_nodes=int(blocks["num_nodes"]), nnz=int(blocks["nnz"]),
        boundaries=blocks["boundaries"],
        rows_sent=(world_size - 1) * rpp,
        rows_received=(world_size - 1) * rpp)
    if halo:
        common.update(
            send_idx=torch.from_numpy(halo["send_idx"][rank].copy()),
            send_idx_t=torch.from_numpy(halo["send_idx_t"][rank].copy()),
            halo_pad=int(halo["halo_pad"]),
            halo_pad_t=int(halo["halo_pad_t"]),
            rows_sent=int(halo["pair_rows"][rank].sum()),
            rows_received=int(halo["pair_rows"][:, rank].sum()))
    return common


def _n_cols(halo, key, rows_per_part, world_size):
    if halo:
        return rows_per_part + world_size * int(halo[key])
    return world_size * rows_per_part


def make_sharded_ell_op(adj_op: sp.spmatrix, world_size: int,
                        rank: Optional[int] = None, *, boundaries=None,
                        exchange: str = "allgather",
                        gather_dtype: torch.dtype = torch.float32):
    """Rank ``rank``'s share of a row-partitioned ELL operator, and the
    partition ``boundaries``: ``(op, boundaries)``.  With ``rank=None``
    every rank's share, as a list (one process holding all partitions,
    as a check of the kernels does).

    ``exchange``: "allgather", "halo" (the deduplicated boundary rows), or
    "auto" (halo when its padded volume is under half the all-gather's).
    The half-selection rules are the single-chip ``make_ell_op``'s, on
    the global matrix: a row partition keeps whole rows, so global row
    and column uniformity hold for every block, and a matrix equal to
    its transpose (values included) gives every rank one half for both
    directions (its transpose schedule is the forward's).  Valued halves
    store their values in ``gather_dtype``.
    """
    csr = sp.csr_matrix(adj_op)
    csr.sort_indices()
    csr_t = csr.T.tocsr()
    csr_t.sort_indices()
    scale_fwd = _row_uniform_values(csr)
    scale_bwd = _row_uniform_values(csr_t)
    sym_struct = (np.array_equal(csr.indptr, csr_t.indptr)
                  and np.array_equal(csr.indices, csr_t.indices))
    blocks, halo = _build_blocks(csr, world_size, boundaries, exchange)
    boundaries = blocks["boundaries"]
    rpp = int(blocks["rows_per_part"])
    src = halo if halo else blocks
    ck, ck_t = ("col_h", "col_h_t") if halo else ("col", "col_t")

    def local(rows, cols, vals, n_cols):
        # CSR in the triplets' (row, global column) order, not sorted by
        # receive-buffer slot: K1 then sums every row in the single-chip
        # half's order (a halo remap moves the own columns to the front)
        indptr = np.zeros(rpp + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=rpp), out=indptr[1:])
        return sp.csr_matrix((vals, cols, indptr), shape=(rpp, n_cols))

    def build(p):
        slab = (lambda v: _slab(v, boundaries, rpp, p))
        n_cols = _n_cols(halo, "halo_pad", rpp, world_size)
        fwd = _build_half(
            local(blocks["row_l"][p], src[ck][p], blocks["val"][p], n_cols),
            None if scale_fwd is None else slab(scale_fwd), "post",
            gather_dtype)
        if sym_struct and np.array_equal(csr.data, csr_t.data):
            bwd = fwd                                   # Aᵀ == A
        elif sym_struct and scale_fwd is not None and scale_bwd is None:
            # same structure: share it, pre-scale the operand slab instead
            bwd = EllHalf(indptr=fwd.indptr, indices=fwd.indices,
                          row_ids=fwd.row_ids, num_cols=fwd.num_cols,
                          lane_classes=fwd.lane_classes,
                          pre_scale=slab(scale_fwd))
        else:
            mat_t = local(blocks["row_l_t"][p], src[ck_t][p],
                          blocks["val_t"][p],
                          _n_cols(halo, "halo_pad_t", rpp, world_size))
            if scale_bwd is not None:
                bwd = _build_half(mat_t, slab(scale_bwd), "post")
            elif scale_fwd is not None:
                bwd = _build_half(mat_t, slab(scale_fwd), "pre")
            else:
                bwd = _build_half(mat_t, vals_dtype=gather_dtype)
        return ShardedEllOp(fwd=fwd, bwd=bwd, gather_dtype=gather_dtype,
                            **_common(blocks, halo, p, world_size))

    if rank is None:
        return [build(p) for p in range(world_size)], boundaries
    return build(rank), boundaries


def make_sharded_coo_op(adj_op: sp.spmatrix, world_size: int,
                        rank: Optional[int] = None, *, boundaries=None,
                        exchange: str = "allgather"):
    """Rank ``rank``'s share of a row-partitioned COO operator (its
    block's triplets and its transpose block's, unpadded), and the
    ``boundaries``; ``rank=None``: every rank's, as in
    ``make_sharded_ell_op``."""
    blocks, halo = _build_blocks(adj_op, world_size, boundaries, exchange)
    boundaries = blocks["boundaries"]
    rpp = int(blocks["rows_per_part"])
    src = halo if halo else blocks
    ck, ck_t = ("col_h", "col_h_t") if halo else ("col", "col_t")

    # where each rank's first triplet sits in the whole matrix's triplets:
    # K5's slices then cut every row where the single-chip half's do
    starts = {key: np.cumsum([0] + [r.size for r in blocks[key]])
              for key in ("row_l", "row_l_t")}

    def build(p):
        fwd = make_coo_half(blocks["row_l"][p], src[ck][p], blocks["val"][p],
                            rpp, num_cols=_n_cols(halo, "halo_pad", rpp,
                                                  world_size),
                            nnz_offset=int(starts["row_l"][p]))
        bwd = make_coo_half(blocks["row_l_t"][p], src[ck_t][p],
                            blocks["val_t"][p], rpp,
                            num_cols=_n_cols(halo, "halo_pad_t", rpp,
                                             world_size),
                            nnz_offset=int(starts["row_l_t"][p]))
        return ShardedCooOp(fwd=fwd, bwd=bwd,
                            **_common(blocks, halo, p, world_size))

    if rank is None:
        return [build(p) for p in range(world_size)], boundaries
    return build(rank), boundaries


def make_sharded_operators(adj: sp.spmatrix, world_size: int, rank: int, *,
                           normalization: str = "row",
                           structure_info: bool = False, fmt: str = "ell",
                           exchange: str = "allgather", boundaries=None,
                           spmm_dtype: torch.dtype = torch.float32):
    """Sharded counterpart of ``ops.graph.precompute_operators`` for one
    rank: ``(Operators, boundaries, rows_per_part)``.

    - ``normalization``: "row" (``D^-1 (A + I)``, value-free halves) or
      "sym" (``D^-1/2 (A + I) D^-1/2``: valued ELL halves in the gather
      dtype, f32 COO), as the JAX package's ``make_sharded_operators``;
    - ``structure_info``: also ``adj_unnorm``, the raw adjacency of the
      structure channel, on ``adj_low``'s boundaries and exchange mode so
      every node slab lines up (value-free, its own transpose when the
      graph is undirected);
    - ``fmt``: "ell" (K1) or "coo" (K5, f32; ignores ``spmm_dtype``, as
      the JAX package does).

    Node arrays are placed with ``shard_node_array``."""
    adj = sp.csr_matrix(adj)
    if normalization == "row":
        adj_low = row_normalized_adjacency(adj)
    elif normalization == "sym":
        adj_low = sym_normalized_adjacency(adj)
    else:
        raise ValueError(f"unknown normalization: {normalization!r}")
    if fmt == "ell":
        def make(mat, b):
            return make_sharded_ell_op(mat, world_size, rank, boundaries=b,
                                       exchange=exchange,
                                       gather_dtype=spmm_dtype)
    elif fmt == "coo":
        def make(mat, b):
            return make_sharded_coo_op(mat, world_size, rank, boundaries=b,
                                       exchange=exchange)
    else:
        raise ValueError(f"unknown sharded operator format: {fmt!r}")
    op, boundaries = make(adj_low, boundaries)
    unnorm = make(adj, boundaries)[0] if structure_info else None
    return (Operators(adj_low=op, adj_unnorm=unnorm), boundaries,
            op.rows_per_part)


def shard_node_array(arr: np.ndarray, boundaries, rows_per_part: int,
                     rank: int, device=None) -> torch.Tensor:
    """This rank's zero-padded ``[rows_per_part, ...]`` slab of a node
    array in memory, as a tensor on ``device``
    (``shard_node_array_per_host`` over a slice of it)."""
    arr = np.asarray(arr)
    return shard_node_array_per_host(lambda r0, r1: arr[r0:r1], boundaries,
                                     rows_per_part, rank, arr.dtype,
                                     arr.shape[1:], device)


# ---------------------------------------------------------------------------
# The product: K6 pack, exchange, local K1 / K5
# ---------------------------------------------------------------------------


def receive_buffer(op: ShardedOp, x: torch.Tensor, transpose: bool = False,
                   sign=None) -> torch.Tensor:
    """The rows the local half gathers from: this rank's slab ``x``
    (f32 ``[rows_per_part, d]``) packed by K6 and exchanged, as a
    ``[exchange_rows, d]`` view with the operator's row stride
    (``row_stride``): K1's row-padded operand for an ELL operator."""
    rpp, world = op.rows_per_part, op.world_size
    if x.shape[0] != rpp:
        raise ValueError(f"slab has {x.shape[0]} rows, partition {rpp}")
    half = op.bwd if transpose else op.fwd
    pre_scale = getattr(half, "pre_scale", None)
    send_idx = op.send_idx_t if transpose else op.send_idx
    d, ld = x.shape[1], op.row_stride(x.shape[1])
    # whole padded rows: K6 writes them, the collectives move them
    recv = torch.empty(op.exchange_rows(transpose), ld,
                       dtype=op.gather_dtype, device=x.device)
    if send_idx is not None:
        # own slab at the head, the halo slabs written in place behind it
        send = halo_pack(x, recv[:rpp, :d], pre_scale=pre_scale, sign=sign,
                         send_idx=send_idx, ld=ld)
        all_to_all_rows(recv[rpp:], padded_rows(send), op.group)
    elif world == 1:
        halo_pack(x, recv[:, :d], pre_scale=pre_scale, sign=sign, ld=ld)
    else:
        own = torch.empty(rpp, ld, dtype=op.gather_dtype, device=x.device)
        halo_pack(x, own[:, :d], pre_scale=pre_scale, sign=sign, ld=ld)
        all_gather_rows(recv, own, op.group)
    return recv[:, :d]


def sharded_ell_spmm(op: ShardedEllOp, x: torch.Tensor,
                     z: Optional[torch.Tensor] = None, alpha=None,
                     beta=None) -> torch.Tensor:
    """This rank's rows of ``Â x`` (with K1's per-column epilogue on the
    residual ``z``, ``[rows_per_part, d]``)."""
    return row_gather_spmm(op.fwd, receive_buffer(op, x), z=z, alpha=alpha,
                           beta=beta)


def sharded_ell_spmm_transpose(op: ShardedEllOp, g: torch.Tensor, sign=None,
                               residual: Optional[torch.Tensor] = None,
                               residual_cols=None) -> torch.Tensor:
    """This rank's rows of ``Âᵀ (sign ⊙ g)`` [+ ``residual`` on
    ``residual_cols``]; the pre-scale and sign are applied in K6 with one
    rounding (``_pre_scale_block``'s order)."""
    return row_gather_spmm(op.bwd, receive_buffer(op, g, True, sign),
                           z=residual, alpha=residual_cols)


def sharded_spmm(op: ShardedCooOp, x: torch.Tensor,
                 z: Optional[torch.Tensor] = None, alpha=None,
                 beta=None) -> torch.Tensor:
    """``sharded_ell_spmm`` on a COO operator (K5)."""
    return coo_spmm(op.fwd, receive_buffer(op, x), z=z, alpha=alpha,
                    beta=beta)


def sharded_spmm_transpose(op: ShardedCooOp, g: torch.Tensor, sign=None,
                           residual: Optional[torch.Tensor] = None,
                           residual_cols=None) -> torch.Tensor:
    """``sharded_ell_spmm_transpose`` on a COO operator (K5)."""
    return coo_spmm(op.bwd, receive_buffer(op, g, True, sign), z=residual,
                    alpha=residual_cols)
