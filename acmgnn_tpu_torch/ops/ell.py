"""Row-gather sparse operator for Hopper, and its SpMM kernel (K1).

Counterpart of ``acmgnn_tpu/ops/ell.py``.  The JAX package packs each
matrix into degree buckets of rows-minor, pre-chunked ELL planes because
of the TPU's gather engine.  On Hopper a group of lanes per row walking
plain CSR keeps the index stream coalesced, so a half here is
degree-sorted CSR: ``indptr``/``indices`` over rows in descending-degree
order, ``row_ids`` mapping each sorted row to the output row it writes
(the inverse permutation folded into the store), and ``lane_classes``,
where each group size of K1 (``k1_lanes``, a function of the degree
alone) ends in the sorted order.

The semantics carry over unchanged:

- value-free halves: a row-uniform matrix (``D^-1(A+I)``: every nonzero
  of row r is ``1/deg_r``) keeps only its binary structure and applies
  ``row_scale`` once per row after the sum;
- its transpose is column-uniform and pre-scales the operand instead
  (``Âᵀg = Bᵀ(s⊙g)``), sharing the forward half's structure arrays when
  the binary structure is symmetric;
- matrices that are neither (symmetric normalization, weighted graphs)
  keep per-nonzero values (``vals``), stored in the gather dtype as the
  JAX package stores its value planes: with bf16 gathers each product
  ``v·x`` is rounded to bf16 before the f32 sum (``ell.py:547-553``);
- the operand is cast to the gather dtype (bf16 on the headline path),
  the sum accumulates in f32, zero-degree rows give zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.ops import kernels


# K1 gives a row about K1_LANE_ENTRIES entries per lane in a group of
# 1, 2, 4, 8, 16 or 32 lanes, and rows above K1_HUB_DEGREE a whole block
# (8 entries a lane measured faster than 4 on both graphs of the training
# paths, and as fast as 16: PERF.md's kernel findings).
K1_LANE_ENTRIES = 8
K1_HUB_DEGREE = 256
K1_BLOCK = 256
# lanes per row of each class, in sorted-row (descending degree) order
K1_LANES = (K1_BLOCK, 32, 16, 8, 4, 2, 1)
# K1's forms (csrc/spmm.cu): the narrow form gives a row lanes along its
# entries and walks its indices once per 16 columns; the wide form gives
# it lanes along its columns (16 bytes a lane) and walks its indices once
# for up to 2 KB of the row.  Rows of K1_WIDE_BYTES or more take the wide
# form (the crossover chip_smoke.py measures); every width of the
# headline and genius paths (w4-w12, bf16 and f32) stays narrow.
K1_FORMS = ("narrow", "wide")
K1_WIDE_BYTES = 64
# a hub row's warps in the wide form (entries w, w+8, ... each)
K1_WARPS = K1_BLOCK // 32


def k1_form(d: int, dtype: torch.dtype) -> str:
    """The form K1 runs for a ``d``-column operand of ``dtype``: "wide"
    for rows of ``K1_WIDE_BYTES`` or more, else "narrow"."""
    nbytes = d * torch.finfo(dtype).bits // 8
    return "wide" if nbytes >= K1_WIDE_BYTES else "narrow"


def k1_lanes(deg, entries: int = K1_LANE_ENTRIES):
    """Lanes K1 gives a row of degree ``deg`` (scalar or array): the
    fewest of 1, 2, ..., 32 that hold it at ``entries`` entries a lane,
    or ``K1_BLOCK`` above ``K1_HUB_DEGREE``."""
    deg = np.asarray(deg, np.int64)
    need = np.maximum(-(-deg // entries), 1)
    group = np.minimum(1 << np.ceil(np.log2(need)).astype(np.int64), 32)
    return np.where(deg > K1_HUB_DEGREE, K1_BLOCK, group)


def k1_lane_classes(indptr, entries: int = K1_LANE_ENTRIES) -> tuple:
    """End of each ``K1_LANES`` class in a degree-sorted half's rows
    (``k1_lanes`` at ``entries`` entries a lane)."""
    lanes = k1_lanes(np.diff(np.asarray(indptr, np.int64)), entries)
    if np.any(np.diff(lanes) > 0):
        raise ValueError("K1 needs rows in descending-degree order")
    return tuple(int(np.count_nonzero(lanes >= g)) for g in K1_LANES)


@dataclasses.dataclass
class EllHalf:
    """One matrix (A or Aᵀ) as degree-sorted CSR."""

    indptr: torch.Tensor        # [N + 1] int64, sorted-row order
    indices: torch.Tensor       # [nnz] int32 column ids
    row_ids: torch.Tensor       # [N] int32: sorted row i writes row_ids[i]
    vals: Optional[torch.Tensor] = None       # [nnz] gather dtype; None =
    #                                           value-free
    row_scale: Optional[torch.Tensor] = None  # [N] f32, output-row order
    pre_scale: Optional[torch.Tensor] = None  # [N] f32, operand-row order
    # operand rows (the matrix's column count); None: square, N
    num_cols: Optional[int] = None
    # end of each K1_LANES class in the sorted rows; None: from indptr
    lane_classes: Optional[tuple] = None

    def __post_init__(self):
        if self.num_cols is None:
            self.num_cols = self.num_rows
        if self.lane_classes is None:
            self.lane_classes = k1_lane_classes(self.indptr.cpu().numpy())

    @property
    def num_rows(self) -> int:
        return int(self.row_ids.shape[0])

    def to(self, device, memo: Optional[dict] = None) -> "EllHalf":
        """Copy to ``device``; arrays shared between halves through
        ``memo`` stay shared."""
        memo = {} if memo is None else memo

        def move(t):
            if not isinstance(t, torch.Tensor):
                return t
            if id(t) not in memo:
                memo[id(t)] = t.to(device)
            return memo[id(t)]

        return EllHalf(**{f.name: move(getattr(self, f.name))
                          for f in dataclasses.fields(self)})


@dataclasses.dataclass
class EllOp:
    """Row-gather operator with its precomputed transpose half."""

    fwd: EllHalf
    bwd: EllHalf
    num_nodes: int
    nnz: int
    gather_dtype: torch.dtype = torch.float32

    def to(self, device) -> "EllOp":
        memo: dict = {}
        fwd = self.fwd.to(device, memo)
        bwd = fwd if self.bwd is self.fwd else self.bwd.to(device, memo)
        return dataclasses.replace(self, fwd=fwd, bwd=bwd)


def _row_uniform_values(csr: sp.csr_matrix):
    """Per-row value vector if every nonzero within each row has the same
    value (exact float equality), else None."""
    deg = np.diff(csr.indptr)
    firsts = np.zeros(csr.shape[0], csr.data.dtype)
    nz = deg > 0
    firsts[nz] = csr.data[csr.indptr[:-1][nz]]
    if np.array_equal(csr.data, np.repeat(firsts, deg)):
        return firsts
    return None


def _build_half(csr: sp.csr_matrix, uniform_scale=None,
                scale_mode: str = "post",
                vals_dtype: torch.dtype = torch.float32) -> EllHalf:
    deg = np.diff(csr.indptr)
    order = np.argsort(-deg, kind="stable")
    srt = csr[order]
    half = EllHalf(
        indptr=torch.from_numpy(srt.indptr.astype(np.int64)),
        indices=torch.from_numpy(srt.indices.astype(np.int32)),
        row_ids=torch.from_numpy(order.astype(np.int32)),
        num_cols=csr.shape[1],
    )
    if uniform_scale is None:
        half.vals = torch.from_numpy(srt.data.astype(np.float32)).to(
            vals_dtype)
    elif scale_mode == "post":
        half.row_scale = torch.from_numpy(
            np.asarray(uniform_scale, np.float32))
    else:
        half.pre_scale = torch.from_numpy(
            np.asarray(uniform_scale, np.float32))
    return half


def make_ell_op(mat: sp.spmatrix, *, gather_dtype=torch.float32) -> EllOp:
    """Host build of both halves (same half-selection rules as
    ``acmgnn_tpu.ops.ell.make_ell_op`` without its TPU layout knobs);
    value planes in ``gather_dtype``.  A matrix equal to its transpose,
    values included, has one half for both directions."""
    csr = sp.csr_matrix(mat)
    csr.sort_indices()
    csr_t = csr.T.tocsr()
    csr_t.sort_indices()
    scale_fwd = _row_uniform_values(csr)
    scale_bwd = _row_uniform_values(csr_t)
    fwd = _build_half(csr, scale_fwd, "post", gather_dtype)
    sym_struct = (np.array_equal(csr.indptr, csr_t.indptr)
                  and np.array_equal(csr.indices, csr_t.indices))
    if sym_struct and np.array_equal(csr.data, csr_t.data):
        bwd = fwd                               # Aᵀ == A
    elif sym_struct and scale_fwd is not None and scale_bwd is None:
        # same structure: share it, pre-scale the operand instead
        bwd = EllHalf(
            indptr=fwd.indptr, indices=fwd.indices, row_ids=fwd.row_ids,
            lane_classes=fwd.lane_classes,
            pre_scale=torch.from_numpy(np.asarray(scale_fwd, np.float32)),
        )
    elif scale_bwd is not None:
        bwd = _build_half(csr_t, scale_bwd, "post")
    elif scale_fwd is not None:
        bwd = _build_half(csr_t, scale_fwd, "pre")
    else:
        bwd = _build_half(csr_t, vals_dtype=gather_dtype)
    return EllOp(fwd=fwd, bwd=bwd, num_nodes=csr.shape[0],
                 nnz=int(csr.nnz), gather_dtype=gather_dtype)


# ---------------------------------------------------------------------------
# K1: row-gather SpMM with a per-column epilogue
# ---------------------------------------------------------------------------


def _columns(values, d: int, default: float):
    out = tuple(float(v) for v in values) if values is not None \
        else (default,) * d
    if len(out) != d:
        raise ValueError(f"expected {d} per-column constants, got {len(out)}")
    return out


def k1_operand_ld(d: int, dtype: torch.dtype) -> int:
    """Row stride of K1's gather operand: a row of at most 32 bytes is
    padded to a power of two of bytes (bf16 w7: 14 → 16 bytes, w12: 24 →
    32), so it is one aligned 8- or 16-byte load sequence in one L2
    sector; a row of the wide form to a multiple of 16 bytes (bf16 w4814:
    9,628 → 9,632), so it is a sequence of 16-byte vectors; other rows
    keep ``d``."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = d * elem
    if d == 0:
        return d
    if k1_form(d, dtype) == "wide":
        return -(-nbytes // 16) * 16 // elem
    if nbytes >= 32:
        return d
    return (1 << (nbytes - 1).bit_length()) // elem


def k1_operand(x: torch.Tensor, dtype: torch.dtype,
               pre_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (times ``pre_scale`` per row, in f32, rounded once) in K1's
    gather dtype, as a ``[N, d]`` view with K1's row stride
    (``k1_operand_ld``); the padding columns are never read into a sum.
    A wide-form operand also starts 16-byte aligned."""
    d = x.shape[1]
    ld = k1_operand_ld(d, dtype)
    if pre_scale is not None:
        x = x.float() * pre_scale[:, None]
    if ld == d:
        out = x.to(dtype)
        if k1_form(d, dtype) == "wide" and (
                out.stride(1) != 1 or out.stride(0) != d
                or out.data_ptr() % 16):
            out = out.contiguous()  # a view: the wide form's 16-byte rows
        return out
    out = torch.empty(x.shape[0], ld, dtype=dtype, device=x.device)[:, :d]
    out.copy_(x)
    return out


def _valued_terms(g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``vals·g`` rounded to the values' dtype (the gather dtype), as K1
    and the JAX package round a valued term; exact in f32 for bf16 ×
    bf16, so one rounding."""
    return (g * vals.float()).to(vals.dtype).float()


def row_gather_spmm_plain(half: EllHalf, x: torch.Tensor,
                          z: Optional[torch.Tensor], alpha, beta):
    """Plain PyTorch version of K1 (same arithmetic, another sum order)."""
    n, d = half.num_rows, x.shape[1]
    dev = x.device
    deg = half.indptr[1:] - half.indptr[:-1]
    rows = torch.repeat_interleave(half.row_ids.long(), deg)
    g = x.float()[half.indices.long()]
    if half.vals is not None:
        g = _valued_terms(g, half.vals[:, None])
    acc = torch.zeros(n, d, dtype=torch.float32, device=dev)
    acc.index_add_(0, rows, g)
    if half.row_scale is not None:
        acc = acc * half.row_scale[:, None]
    out = column_constants(beta, dev) * acc
    if z is not None:
        out = column_constants(alpha, dev) * z + out
    return out


def k1_order_replay(half: EllHalf, x: torch.Tensor,
                    z: Optional[torch.Tensor], alpha, beta,
                    form: Optional[str] = None) -> torch.Tensor:
    """K1's arithmetic in its own order, in plain PyTorch, for ``form``
    (default ``k1_form`` of the operand).  Narrow: in a row's group of
    ``k1_lanes(degree)`` lanes, lane l sums the row's entries l, l+g, ...
    in turn, a butterfly over lane offsets g/2, ..., 1 adds each warp's
    partials, a hub row's warp partials are added in warp order.  Wide:
    each column sums a row's entries in order; a hub row's warp w sums
    entries w, w+8, ... and the 8 partials are added in warp order.  Each
    product ``w·x`` is rounded on its own; then the row scale and the
    epilogue, one rounding per operation.  K1 equals this bit for bit."""
    n, d = half.num_rows, x.shape[1]
    dev = x.device
    form = k1_form(d, x.dtype) if form is None else form
    xf = torch.cat([x.float(), torch.zeros(1, d, device=dev)])
    if form == "wide":
        sums = _wide_order_sums(half, xf)
    elif form == "narrow":
        sums = _narrow_order_sums(half, xf)
    else:
        raise ValueError(f"K1 has forms {K1_FORMS}, got {form!r}")
    out = torch.empty(n, d, device=dev)
    out[half.row_ids.long()] = sums
    if half.row_scale is not None:
        out = out * half.row_scale[:, None]
    out = column_constants(beta, dev) * out
    if z is not None:
        out = column_constants(alpha, dev) * z + out
    return out


def _order_terms(half: EllHalf, xf: torch.Tensor, e: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """The terms of entries ``e`` (the appended zero row of ``xf`` where
    not ``valid``), each valued product rounded on its own."""
    e = e.clamp(max=max(half.indices.numel() - 1, 0))
    term = xf[torch.where(valid, half.indices[e].long(), xf.shape[0] - 1)]
    if half.vals is not None:
        term = _valued_terms(term, torch.where(valid, half.vals[e],
                                               0)[..., None])
    return term


def _narrow_order_sums(half: EllHalf, xf: torch.Tensor) -> torch.Tensor:
    """Each sorted row's sum in the narrow form's order."""
    n, d = half.num_rows, xf.shape[1]
    dev = xf.device
    sums = torch.zeros(n, d, device=dev)
    row0 = 0
    for lanes, row1 in zip(K1_LANES, half.lane_classes):
        if row1 == row0:
            continue
        beg = half.indptr[row0:row1, None]
        end = half.indptr[row0 + 1:row1 + 1, None]
        lane = torch.arange(lanes, device=dev)
        acc = torch.zeros(row1 - row0, lanes, d, device=dev)
        for k in range(-(-int((end - beg).max()) // lanes)):
            e = beg + lanes * k + lane[None]
            acc = acc + _order_terms(half, xf, e, e < end)
        warp = min(lanes, 32)
        acc = acc.view(row1 - row0, lanes // warp, warp, d)
        wl = torch.arange(warp, device=dev)
        off = warp // 2
        while off:
            acc = acc + acc[:, :, wl ^ off]
            off //= 2
        s = acc[:, 0, 0]
        for w in range(1, lanes // warp):
            s = s + acc[:, w, 0]
        sums[row0:row1] = s
        row0 = row1
    return sums


def _wide_order_sums(half: EllHalf, xf: torch.Tensor) -> torch.Tensor:
    """Each sorted row's sum in the wide form's order.  Rows are sorted by
    descending degree, so step k of a loop over entries touches only the
    prefix of rows that have an entry k."""
    n, d = half.num_rows, xf.shape[1]
    dev = xf.device
    deg = (half.indptr[1:] - half.indptr[:-1]).cpu()
    sums = torch.zeros(n, d, device=dev)
    hubs = half.lane_classes[0]
    if hubs:    # warp w: entries w, w+8, ...; partials in warp order
        warp = torch.arange(K1_WARPS, device=dev)
        acc = torch.zeros(hubs, K1_WARPS, d, device=dev)
        for k in range(-(-int(deg[0]) // K1_WARPS)):
            m = int(torch.count_nonzero(deg[:hubs] > K1_WARPS * k))
            e = half.indptr[:m, None] + K1_WARPS * k + warp[None]
            valid = e < half.indptr[1:m + 1, None]
            acc[:m] = torch.where(valid[..., None],
                                  acc[:m] + _order_terms(half, xf, e, valid),
                                  acc[:m])
        s = acc[:, 0]
        for w in range(1, K1_WARPS):
            s = s + acc[:, w]
        sums[:hubs] = s
    rest = deg[hubs:]
    for k in range(int(rest[0]) if rest.numel() else 0):
        m = int(torch.count_nonzero(rest > k))   # a prefix: sorted rows
        e = half.indptr[hubs:hubs + m] + k
        sums[hubs:hubs + m] += _order_terms(
            half, xf, e, torch.ones_like(e, dtype=torch.bool))
    return sums


_column_consts: dict = {}


def column_constants(values, device) -> torch.Tensor:
    """A small f32 vector of per-column constants on ``device``, made once
    per distinct value tuple (no host-to-device copy per launch)."""
    key = (tuple(float(v) for v in values), torch.device(device))
    t = _column_consts.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.float32, device=device)
        _column_consts[key] = t
    return t


def _row_gather_spmm_cuda(half: EllHalf, x, z, alpha, beta, form: str):
    """K1 in ``form`` (``row_gather_spmm`` passes ``k1_form``'s; a
    measurement may pass either).  ``alpha`` and ``beta`` are tuples of
    per-column constants."""
    n, d = half.num_rows, x.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K1 takes a bf16 or f32 operand, got {x.dtype}")
    if x.shape[0] != half.num_cols:
        raise ValueError(f"operand has {x.shape[0]} rows, operator "
                         f"{half.num_cols} columns")
    vals_bf16 = half.vals is not None and half.vals.dtype == torch.bfloat16
    if half.vals is not None and (
            half.vals.dtype not in (torch.bfloat16, torch.float32)
            or vals_bf16 and x.dtype != torch.bfloat16):
        raise TypeError(f"K1 takes f32 values, or bf16 values with a bf16 "
                        f"operand; got {half.vals.dtype} values, "
                        f"{x.dtype} operand")
    if form not in K1_FORMS:
        raise ValueError(f"K1 has forms {K1_FORMS}, got {form!r}")
    if form == "wide" and (x.data_ptr() % 16
                           or x.stride(0) * x.element_size() % 16):
        raise ValueError(
            f"K1's wide form reads 16-byte vectors: the operand's base and "
            f"row stride must be 16-byte aligned (k1_operand pads its "
            f"rows), got row stride {x.stride(0)} of {x.dtype} at address "
            f"{x.data_ptr():#x}")
    arrays = [half.indptr, half.indices, half.row_ids]
    arrays += [t for t in (z, half.vals, half.row_scale) if t is not None]
    # the operand may be a row-padded view (k1_operand)
    kernels.require_cuda(*arrays, strided=(x,))
    # K1 reads the operand only through ``indices`` and indexes z and out
    # by output row, so z is [num_rows, d] also for a rectangular half
    if z is not None and (z.dtype != torch.float32 or z.shape != (n, d)):
        raise ValueError(f"epilogue operand z must be f32 [{n}, {d}]")
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    alpha_t = column_constants(alpha, x.device)
    beta_t = column_constants(beta, x.device)
    lib = kernels.library("spmm")
    rc = lib.acm_k1_spmm(
        kernels.ptr(half.indptr), kernels.ptr(half.indices),
        kernels.ptr(half.vals), int(vals_bf16), kernels.ptr(half.row_ids),
        kernels.ptr(x), int(x.dtype == torch.bfloat16), x.stride(0),
        kernels.ptr(z),
        kernels.ptr(alpha_t), kernels.ptr(beta_t),
        kernels.ptr(half.row_scale), kernels.ptr(out), n, d,
        (ctypes.c_int * len(K1_LANES))(*half.lane_classes),
        K1_FORMS.index(form), kernels.stream(),
    )
    kernels.check(lib, rc, f"K1 spmm ({form} form)")
    kernels.count(f"k1_spmm_w{d}" + ("_valued" if half.vals is not None
                                      else ""))
    return out


def row_gather_spmm(half: EllHalf, x: torch.Tensor,
                    z: Optional[torch.Tensor] = None, alpha=None, beta=None):
    """``out[r, j] = alpha[j]·z[r, j] + beta[j]·rs[r]·Σ_{c ∈ row r} x[c, j]``.

    ``x``: [num_cols, d] gather operand (bf16 or f32; a transpose half's
    operand is already pre-scaled), contiguous or a row-padded view
    (``k1_operand``; K1's wide form, ``k1_form``, needs its 16-byte rows
    and raises on others).  ``z``: optional f32 [num_rows, d] residual;
    ``alpha`` (default 0) and ``beta`` (default 1) are per-column
    constants.  Returns f32 [N, d].  A CPU operand runs the plain
    version; a CUDA operand launches K1.
    """
    d = x.shape[1]
    alpha = _columns(alpha, d, 0.0)
    beta = _columns(beta, d, 1.0)
    if z is not None and not any(alpha):
        z = None
    if x.device.type == "cpu":
        return row_gather_spmm_plain(half, x, z, alpha, beta)
    if x.stride(1) != 1 or x.stride(0) < d:
        x = x.contiguous()
    return _row_gather_spmm_cuda(half, x,
                                 None if z is None else z.contiguous(),
                                 alpha, beta, k1_form(d, x.dtype))
