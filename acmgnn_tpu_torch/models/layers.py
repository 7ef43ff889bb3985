"""ACM layers — counterpart of ``acmgnn_tpu/models/layers.py``.

``ACMConv`` for every model type of the zoo:

- the ACM family (``acmgcn``, ``acmgcnp``, ``acmgcnpp``, ``acmsnowball``):
  channels ``H_L = Â (X W_L)``, ``H_H = (I - Â)(X W_H)``, ``H_I = X W_I``
  and, for acmgcnp/pp with ``structure_info``, ``H_S = Â_raw S``; the
  ReLU on every channel (variant 0), or on ``X W_L``/``X W_H`` before the
  propagation and then on ``H_I``/``H_S`` only (variant 1, ACMII);
- ``acmsgc``: the same three channels without any ReLU, the high-pass
  over the 1-hop base when the low-pass is ``Â^k``;
- ``acmgraphsage``: SAGE-style low and high channels and a ReLU'd MLP
  channel;
- the baselines ``mlp``, ``gcn``, ``sgc``, ``snowball``: one projection,
  propagated or not.

The attention is ``att = softmax(sigmoid(scores) @ W_att / T)`` over the
T = 3 or 4 channels, with per-channel scores ``H_i · a_i`` (through a
LayerNorm in its projected form when ``use_layernorm``), and the output
``K · Σ att_i H_i`` with K = 3 at T = 3 and 1 at T = 4.  The channel
ReLU, attention and mix of each branch is one launch of K2 (forward) and
K3 (backward, with the parameter gradients summed over the rows),
``csrc/attention.cu``, at its (T, ReLU mask) instance;
``attention_mix_forward_plain`` and ``attention_mix_backward_plain`` are
their plain PyTorch versions.  The channel projections ``X W`` follow
``gemm_dtype`` (``make_mm``): f32, or bf16 operands with an f32 result
and JAX's backward (``bf16_matmul``); each operand goes through every
weight that reads it in one call (``make_project``), so a bf16 operand
is rounded once a forward and widened once a backward
(``bf16_project``).  The attention's own products stay f32.

Also ``SAGEConv``, ``GCNIIConv`` and ``MLPBlock`` (acmgcnpp's skip MLP,
with ``BatchNorm`` in flax's arithmetic).  Parameter names and
orientations follow the flax modules (``weight_low`` is ``[F_in,
F_out]`` used as ``x @ W``; ``layer_norm_low.scale``; ``lin_0.kernel``;
BatchNorm statistics as the buffers ``bn_0.mean``/``bn_0.var``), so a
flax variable tree copies over flat (``models/convert.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import Optional

import torch
from torch import nn

from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.graph import Operators
from acmgnn_tpu_torch.ops.spmm import (
    node_rows,
    spmm,
    spmm_dual,
    spmm_high,
    spmm_multi,
)
from acmgnn_tpu_torch.parallel.multihost import rank_rows, sum_over_ranks
from acmgnn_tpu_torch.utils import profiling

# Widest layer-1 input the hoist gathers directly (kept from the JAX
# package, where a wider gather fell off the gather engine's full rate).
HOIST_MAX_COLS = 128

LN_EPS = 1e-5
# channel names, in order (flax's ``layer_norm_<name>``/``att_vec_<name>``)
CHANNELS = ("low", "high", "mlp", "struc_low")

ACM_FAMILY = ("acmgcn", "acmgcnp", "acmgcnpp", "acmsgc", "acmsnowball",
              "acmgraphsage")
MODEL_TYPES = ACM_FAMILY + ("gcn", "sgc", "mlp", "graphsage", "snowball",
                            "gcnII")
# layer types whose forward takes a paired eval branch (ACMConv.forward)
PAIRED_TYPES = ("acmgcn", "acmgcnp", "acmgcnpp", "acmsnowball")


def ln_mode() -> str:
    """``ACMGNN_LN_MODE`` (legacy ``ACMGNN_LN_FUSED``: 1 batched, 0
    modules), validated as the JAX package's ``_ln_mode``.  "proj",
    "modules" and "batched" are the same arithmetic up to float
    association (PARITY.md round 5), so all three run K2/K3's projected
    LayerNorm."""
    mode = os.environ.get("ACMGNN_LN_MODE")
    if mode is None:
        legacy = os.environ.get("ACMGNN_LN_FUSED")
        return {"1": "batched", "0": "modules"}.get(legacy, "proj")
    if mode not in ("proj", "modules", "batched"):
        raise ValueError(f"unknown ACMGNN_LN_MODE: {mode!r}")
    return mode


# ---------------------------------------------------------------------------
# K2 / K3: channel ReLU, attention and mix
# ---------------------------------------------------------------------------

# Floats of a row one lane of K2/K3 holds in registers at d > 8 (lanes per
# row = d / ATTN_LANE_FLOATS, rounded up to a power of two, at most 32):
# at d = 64, 4 lanes a row, four float4 loads a channel.  chip_smoke.py
# sweeps 4, 8 and 16 lanes a row at d = 64: 4 lanes took 0.4-2% less of
# K2 + K3's device time per epoch than 8 in each of six readings (three
# runs, both training graphs), 16 the most (K3 +21% on the headline;
# PERF.md's kernel findings).
ATTN_LANE_FLOATS = 16
ATTN_MAX_D = 1024          # 32 lanes x 32 floats: the widest instance
ATTN_THREADS = 256         # threads of a K2/K3 block (csrc/attention.cu)
# (channels, ReLU per channel) instances of attention.cu: variant 0,
# variant 1, acmsgc; the structure channel with variant 0 and variant 1
ATTN_INSTANCES = ((True, True, True), (False, False, True),
                  (False, False, False), (True, True, True, True),
                  (False, False, True, True))


def row_sums(t: int) -> int:
    """Row sums a K3 block keeps per row group: dS (t), dscore (t) and
    g_i dl_j (t²)."""
    return 2 * t + t * t


def relu_flags(relu, t: int) -> tuple:
    """The per-channel ReLU flags (None: every channel)."""
    flags = (True,) * t if relu is None else tuple(bool(r) for r in relu)
    if len(flags) != t:
        raise ValueError(f"{len(flags)} ReLU flags for {t} channels")
    return flags


def _relu_mask(flags) -> int:
    return sum(1 << i for i, r in enumerate(flags) if r)


def _counter(kind: str, flags, d: int) -> str:
    """Launch counter of a K2/K3 instance: ``k2_attn_fwd_d64`` for the
    three ReLU'd channels, ``k2_attn_fwd_t4_d64`` for four, and
    ``..._relu_<channels>`` for another mask (``none``: no ReLU)."""
    t = len(flags)
    name = "k2_attn_fwd" if kind == "fwd" else "k3_attn_bwd"
    if t != 3:
        name += f"_t{t}"
    if not all(flags):
        on = "".join(CHANNELS[i][0] for i, r in enumerate(flags) if r)
        name += f"_relu_{on or 'none'}"
    return f"{name}_d{d}"


def _channels(zs, relu):
    return [torch.relu(z) if r else z
            for z, r in zip(zs, relu_flags(relu, len(zs)))]


def _row_scalars(hs, v, c, W, use_ln: bool):
    """Per-row moments, centred projections, scores, gates and softmax
    weights of the channels ``hs`` (after their ReLU; the kernels'
    arithmetic, in the same order)."""
    d = hs[0].shape[1]
    mus, diffs, rs, pcs, scores = [], [], [], [], []
    for i, h in enumerate(hs):
        mu = h.sum(dim=1) / d
        diff = (h * h).sum(dim=1) / d - mu * mu     # fast variance
        if use_ln:
            r = torch.rsqrt(torch.clamp_min(diff, 0.0) + LN_EPS)
            # = h·v − mu·Σv, summed centred: no cancellation on flat rows
            pc = (h - mu[:, None]) @ v[i]
            score = pc * r + c[i]
        else:
            pc = h @ v[i]
            r = torch.ones_like(pc)
            score = pc
        mus.append(mu), diffs.append(diff), rs.append(r), pcs.append(pc)
        scores.append(score)
    g = torch.sigmoid(torch.stack(scores, dim=1))
    att = torch.softmax((g @ W) / len(hs), dim=1)
    return mus, diffs, rs, pcs, g, att


def attention_mix_forward_plain(zs, v, c, W, use_ln: bool, scale: float,
                                relu=None):
    """Plain PyTorch version of K2: ``scale · Σ att_i h_i`` over the
    channels ``zs``, ``h_i = relu(z_i)`` where ``relu[i]`` (None: all)."""
    hs = _channels(zs, relu)
    *_, att = _row_scalars(hs, v, c, W, use_ln)
    out = att[:, 0:1] * hs[0]
    for i in range(1, len(hs)):
        out = out + att[:, i:i + 1] * hs[i]
    return scale * out


def attention_backward_rows(zs, gout, v, c, W, use_ln: bool, scale: float,
                            relu=None):
    """K3's per-row quantities, in its arithmetic: ``(hs, dhs, dp, dS,
    dscore, g, dl)`` with ``hs`` the channels after their ReLU, ``dhs``
    their gradients, and ``[N, T]`` row terms of the parameter gradients
    (``dS = −dp·mu``: the row's share of the gradient of ``Σ_j v_ij``)."""
    hs = _channels(zs, relu)
    t = len(hs)
    d = hs[0].shape[1]
    S = v.sum(dim=1)
    mus, diffs, rs, pcs, g, att = _row_scalars(hs, v, c, W, use_ln)
    datt = torch.stack([scale * (gout * h).sum(dim=1) for h in hs], dim=1)
    dl = att * (datt - (att * datt).sum(dim=1, keepdim=True))
    dscore = (dl @ W.T) / t * g * (1.0 - g)
    dhs, dps, dSs = [], [], []
    for i, h in enumerate(hs):
        ds = dscore[:, i]
        if use_ln:
            dp = ds * rs[i]
            dS = -dp * mus[i]
            dvar = (-0.5 * (ds * pcs[i])) * (rs[i] * rs[i] * rs[i])
            f = torch.where(diffs[i] > 0, 1.0,
                            torch.where(diffs[i] == 0, 0.5, 0.0))
            dm2 = dvar * f
            # the variance's share centred, as the score is
            add = (-dp * S[i]) / d
            mul = (2.0 * dm2) / d
        else:
            dp, dS = ds, torch.zeros_like(ds)
            add = mul = torch.zeros_like(ds)
        dhs.append(scale * att[:, i:i + 1] * gout + dp[:, None] * v[i]
                   + add[:, None] + mul[:, None] * (h - mus[i][:, None]))
        dps.append(dp), dSs.append(dS)
    return (hs, dhs, torch.stack(dps, 1), torch.stack(dSs, 1), dscore, g,
            dl)


def attention_mix_backward_plain(zs, gout, v, c, W, use_ln: bool,
                                 scale: float, relu=None):
    """Plain PyTorch version of K3: ``(dz_0, ..., dz_{T-1}, dv, dc, dW)``,
    the ReLU's gradient (0 at 0) applied on the channels that have it,
    the parameter gradients summed over the rows (``dc`` is 0 without
    LayerNorm, where ``c`` is unused)."""
    flags = relu_flags(relu, len(zs))
    hs, dhs, dp, dS, dscore, g, dl = attention_backward_rows(
        zs, gout, v, c, W, use_ln, scale, flags)
    dzs = [torch.where(h > 0, dh, 0.0) if r else dh
           for h, dh, r in zip(hs, dhs, flags)]
    dv = torch.stack([h.T @ dp[:, i] for i, h in enumerate(hs)]) \
        + dS.sum(dim=0)[:, None]
    dc = dscore.sum(dim=0) if use_ln else torch.zeros_like(c)
    return (*dzs, dv, dc, (g.T @ dl) / len(hs))


def attention_grad_scales(zs, gout, v, c, W, use_ln: bool, scale: float,
                          relu=None):
    """``Σ_rows |term|`` of each element of ``dv``, ``dc`` and ``dW``: the
    scale of their rounding error, for checking K3 against its plain
    version (chip_smoke.py, the card tests)."""
    hs, _, dp, dS, dscore, g, dl = attention_backward_rows(
        zs, gout, v, c, W, use_ln, scale, relu)
    dv = torch.stack([h.abs().T @ dp[:, i].abs() for i, h in enumerate(hs)]) \
        + dS.abs().sum(dim=0)[:, None]
    return dv, dscore.abs().sum(dim=0), (g.T @ dl.abs()) / len(hs)


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def attention_plan(d: int):
    """``(lanes per row, floats per lane)`` of K2/K3 at width ``d``: one
    lane a row up to d = 8 (2 or 8 floats), else ``ATTN_LANE_FLOATS``
    floats a lane (32 past 512 columns)."""
    if d > ATTN_MAX_D:
        raise ValueError(f"K2/K3 hold a row in registers: d <= "
                         f"{ATTN_MAX_D}, got {d}")
    if d <= 8:
        return 1, 2 if d <= 2 else 8
    lanes = min(32, _next_pow2(-(-d // ATTN_LANE_FLOATS)))
    return lanes, max(2, _next_pow2(-(-d // lanes)))


def _row_major(z):
    """``z`` with unit column stride (a column view of a wider tensor
    stays a view) and its row stride."""
    if z.stride(1) != 1 or z.stride(0) < z.shape[1]:
        z = z.contiguous()
    return z, z.stride(0)


_resident: dict = {}


def attention_config(kind: str, zs, lds, d: int, plan, flags=None):
    """``(vec, lanes, elems, resident blocks)`` of K2 (``kind`` "fwd") or
    K3 ("bwd") at ``plan`` = ``(lanes, elems)`` on the row-major operands
    ``zs`` with row strides ``lds``, for the channels' ReLU ``flags``
    (None: three ReLU'd channels): 16-byte loads (8-byte where a lane
    holds 2 floats) where d, the row strides and the base pointers allow,
    else scalar loads.  The residency is asked of the occupancy API once
    per instance and card (an instance attention.cu does not compile
    fails the query)."""
    flags = relu_flags(flags, 3) if flags is None else tuple(flags)
    t, mask = len(flags), _relu_mask(flags)
    g, e = plan
    vec = 2 if e == 2 else 4
    if d % vec or any(ld % vec or z.data_ptr() % (4 * vec)
                      for z, ld in zip(zs, lds)):
        vec = 1
    key = (kind, t, mask, vec, g, e, zs[0].device)
    n = _resident.get(key)
    if n is None:
        lib = kernels.library("attention")
        active = ctypes.c_int(0)
        if kind == "fwd":
            rc = lib.acm_k2_attn_fwd(
                *[None] * 4, *[0] * 4, t, mask, *[None] * 4, 0, d, 0, 1.0,
                vec, g, e, 0, ctypes.byref(active), None)
        else:
            rc = lib.acm_k3_attn_bwd(
                *[None] * 4, *[0] * 4, t, mask, None, 0, *[None] * 11, 0, d,
                0, 1.0, vec, g, e, 0, ctypes.byref(active), None)
        kernels.check(lib, rc, f"K{2 if kind == 'fwd' else 3} occupancy "
                               f"query")
        n = active.value
        if n <= 0:
            raise RuntimeError(f"K2/K3 {kind} {(t, mask, vec, g, e)}: no "
                               f"block fits")
        _resident[key] = n
    return vec, g, e, n


def attention_grid(n_rows: int, lanes: int, resident: int) -> int:
    """Blocks of a launch: at most the resident ones, none idle."""
    return max(1, min(resident, -(-n_rows // (ATTN_THREADS // lanes))))


def _check_attention_operands(zs, v, c, W, flags):
    t = len(flags)
    if flags not in ATTN_INSTANCES:
        raise ValueError(f"K2/K3 have no instance for {t} channels with "
                         f"the ReLU on {flags}")
    n, d = zs[0].shape
    for z in zs:
        if z.dtype != torch.float32 or tuple(z.shape) != (n, d):
            raise ValueError("attention channels must be f32 and [N, d]")
    want = {"v": (v, (t, d)), "c": (c, (t,)), "W": (W, (t, t))}
    for name, (a, shape) in want.items():
        if a.dtype != torch.float32 or tuple(a.shape) != shape:
            raise ValueError(f"attention {name} must be f32 {shape}")
    kernels.require_cuda(v, c, W, strided=zs)
    return n, d


def _padded(ptrs, fill):
    return [*ptrs, *[fill] * (4 - len(ptrs))]


def attention_mix_forward(zs, v, c, W, use_ln: bool, scale: float,
                          relu=None):
    """K2 on CUDA tensors, the plain version on CPU tensors: ``scale ·
    Σ att_i h_i`` over the 3 or 4 channels ``zs`` (given before their
    ReLU; ``relu`` per channel, None: all).  The channels may be column
    views (unit column stride)."""
    if zs[0].device.type == "cpu":
        return attention_mix_forward_plain(zs, v, c, W, use_ln, scale, relu)
    return _launch_forward(zs, v, c, W, use_ln, scale,
                           attention_plan(zs[0].shape[1]), relu)


def _launch_forward(zs, v, c, W, use_ln: bool, scale: float, plan,
                    relu=None):
    """K2 at ``plan`` = ``(lanes, elems)`` (``attention_plan``'s, or
    another compiled instance: chip_smoke.py's sweep)."""
    flags = relu_flags(relu, len(zs))
    v, c, W = (t.contiguous() for t in (v, c, W))
    n, d = _check_attention_operands(zs, v, c, W, flags)
    zs, lds = zip(*(_row_major(z) for z in zs))
    vec, g, e, resident = attention_config("fwd", zs, lds, d, plan, flags)
    out = torch.empty(n, d, dtype=torch.float32, device=zs[0].device)
    lib = kernels.library("attention")
    rc = lib.acm_k2_attn_fwd(
        *_padded([kernels.ptr(z) for z in zs], None), *_padded(lds, 0),
        len(flags), _relu_mask(flags),
        *(kernels.ptr(t) for t in (v, c, W, out)), n, d, int(use_ln),
        float(scale), vec, g, e, attention_grid(n, g, resident), None,
        kernels.stream())
    kernels.check(lib, rc, "K2 attention forward")
    kernels.count(_counter("fwd", flags, d))
    return out


def attention_mix_backward(zs, gout, v, c, W, use_ln: bool, scale: float,
                           relu=None):
    """K3 on CUDA tensors, the plain version on CPU tensors: ``(dz_0,
    ..., dz_{T-1}, dv, dc, dW)``, the parameter gradients summed over the
    rows in a fixed order (bit-reproducible on one card)."""
    if zs[0].device.type == "cpu":
        return attention_mix_backward_plain(zs, gout, v, c, W, use_ln,
                                            scale, relu)
    return _launch_backward(zs, gout, v, c, W, use_ln, scale,
                            attention_plan(zs[0].shape[1]), relu)[:-1]


def _launch_backward(zs, gout, v, c, W, use_ln: bool, scale: float, plan,
                     relu=None):
    """K3 at ``plan`` = ``(lanes, elems)``: ``(dz_0, ..., dz_{T-1}, dv,
    dc, dW, partials)``, ``partials`` the ``[grid, T d + row_sums(T)]``
    block sums that the finishing kernel added up."""
    flags = relu_flags(relu, len(zs))
    t = len(flags)
    v, c, W = (a.contiguous() for a in (v, c, W))
    n, d = _check_attention_operands((*zs, gout), v, c, W, flags)
    ops, lds = zip(*(_row_major(z) for z in (*zs, gout)))
    vec, g, e, resident = attention_config("bwd", ops, lds, d, plan, flags)
    grid = attention_grid(n, g, resident)
    dev = ops[0].device
    dzs = [torch.empty(n, d, dtype=torch.float32, device=dev)
           for _ in range(t)]
    partials = torch.empty(grid, t * d + row_sums(t), dtype=torch.float32,
                           device=dev)
    dv = torch.empty(t, d, dtype=torch.float32, device=dev)
    dc = torch.empty(t, dtype=torch.float32, device=dev)
    dW = torch.empty(t, t, dtype=torch.float32, device=dev)
    lib = kernels.library("attention")
    rc = lib.acm_k3_attn_bwd(
        *_padded([kernels.ptr(z) for z in ops[:t]], None),
        *_padded(lds[:t], 0), t, _relu_mask(flags), kernels.ptr(ops[t]),
        lds[t], *(kernels.ptr(a) for a in (v, c, W)),
        *_padded([kernels.ptr(dz) for dz in dzs], None),
        *(kernels.ptr(a) for a in (partials, dv, dc, dW)),
        n, d, int(use_ln), float(scale), vec, g, e, grid, None,
        kernels.stream())
    kernels.check(lib, rc, "K3 attention backward")
    kernels.count(_counter("bwd", flags, d))
    return (*dzs, dv, dc, dW, partials)


class _AttentionMix(torch.autograd.Function):
    """Saves only its inputs (the channels before their ReLU); K3
    recomputes the row scalars and returns every gradient, the
    parameters' summed."""

    @staticmethod
    def forward(ctx, v, c, W, use_ln, scale, relu, *zs):
        ctx.save_for_backward(v, c, W, *zs)
        ctx.use_ln, ctx.scale, ctx.relu = use_ln, scale, relu
        return attention_mix_forward(zs, v, c, W, use_ln, scale, relu)

    @staticmethod
    def backward(ctx, gout):
        v, c, W, *zs = ctx.saved_tensors
        *dzs, dv, dc, dW = attention_mix_backward(
            zs, gout, v, c, W, ctx.use_ln, ctx.scale, ctx.relu)
        return (dv, dc, dW, None, None, None, *dzs)


def attention_mix(zs, v, c, W, use_ln: bool, scale: float, relu=None):
    """Differentiable ``scale · Σ att_i h_i`` over the 3 or 4 channels
    ``zs``, given before their ReLU (``relu`` per channel, None: all)."""
    return _AttentionMix.apply(v, c, W, use_ln, scale,
                               relu_flags(relu, len(zs)), *zs)


# ---------------------------------------------------------------------------
# Channel-projection GEMMs (JAX ``_resolve_gemm_dtype`` / ``_make_mm``)
# ---------------------------------------------------------------------------


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices, accumulated and returned in f32.
    On the card one cuBLAS GEMM (``aten::mm.dtype``); the CPU has no such
    kernel, so there the bf16 values are multiplied as f32 (exact
    products, another summation order)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Bf16Project(torch.autograd.Function):
    """JAX's ``dot(a.bf16, w.bf16, preferred_element_type=f32)`` for each
    weight ``w`` of ``ws``: the operands are rounded to bf16, the products
    are not.  ``a`` is rounded once, and that one copy is saved, for every
    weight.  Its backward is what ``jax.grad`` makes of each product: the
    f32 cotangent times the other operand's bf16 values as an f32
    product, rounded to bf16 and cast back to the input's dtype; the
    cotangent itself is not rounded.  The saved copy is widened to f32
    once for every weight's gradient.  ``a``'s gradient is formed at one
    weight only (``bf16_project``)."""

    @staticmethod
    def forward(ctx, a, *ws):
        ab = a.to(torch.bfloat16)
        wbs = [w.to(torch.bfloat16) for w in ws]
        ctx.save_for_backward(ab, *wbs)
        ctx.dtypes = (a.dtype, *(w.dtype for w in ws))
        ctx.set_materialize_grads(False)
        return tuple(_mm_f32_out(ab, wb) for wb in wbs)

    @staticmethod
    def backward(ctx, *gs):
        ab, *wbs = ctx.saved_tensors
        need = ctx.needs_input_grad
        da = None
        if need[0] and gs[0] is not None:
            (g,), (wb,) = gs, wbs
            da = (g @ wb.float().T).to(torch.bfloat16).to(ctx.dtypes[0])
        want = [n and g is not None for n, g in zip(need[1:], gs)]
        af = ab.float() if any(want) else None
        dws = [(af.T @ g).to(torch.bfloat16).to(dt) if w else None
               for w, g, dt in zip(want, gs, ctx.dtypes[1:])]
        return (da, *dws)


def bf16_project(a: torch.Tensor, *ws: torch.Tensor) -> tuple:
    """Differentiable ``a @ w`` for each weight of ``ws``, with bf16
    operands and f32 results: a tuple, one product a weight.  ``a`` is
    rounded to bf16 once for all of them (the counters
    ``proj.roundings`` and ``proj.projections``), unless it needs a
    gradient: then each weight takes its own rounding, so autograd sums
    ``a``'s gradient from one term a weight, as it does for separate
    products."""
    calls = ([(w,) for w in ws] if len(ws) > 1 and a.requires_grad
             and torch.is_grad_enabled() else [ws])
    profiling.count("proj.roundings", len(calls))
    profiling.count("proj.projections", len(ws))
    return tuple(z for c in calls for z in _Bf16Project.apply(a, *c))


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``a @ w`` with bf16 operands and an f32 result."""
    return bf16_project(a, w)[0]


def f32_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in f32; a bf16-stored input (``feature_dtype``) is
    promoted first, as JAX promotes ``bf16 @ f32``."""
    return (a if a.dtype == w.dtype else a.to(w.dtype)) @ w


def make_mm(gemm_dtype: Optional[str]):
    """The channel-projection matmul of a gemm dtype: None / "float32"
    exact f32, "bfloat16" bf16 operands with an f32 accumulator."""
    if gemm_dtype in (None, "float32"):
        return f32_matmul
    if gemm_dtype == "bfloat16":
        return bf16_matmul
    raise ValueError(f"unknown gemm_dtype {gemm_dtype!r}")


def f32_project(a: torch.Tensor, *ws: torch.Tensor) -> tuple:
    """``f32_matmul(a, w)`` for each weight of ``ws``, as a tuple."""
    return tuple(f32_matmul(a, w) for w in ws)


def make_project(gemm_dtype: Optional[str]):
    """``make_mm``'s matmul over the weights that read one operand:
    ``project(a, *ws)`` returns one product a weight."""
    return bf16_project if make_mm(gemm_dtype) is bf16_matmul \
        else f32_project


# ---------------------------------------------------------------------------
# ACMConv and the zoo's other layers
# ---------------------------------------------------------------------------


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


class _LNParams(nn.Module):
    """LayerNorm parameters (flax ``layer_norm_<name>/{scale,bias}``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class SAGEConv(nn.Module):
    """GraphSAGE-style convolution ``x W_self + (Â x) W_agg`` (with
    ``high_pass``, ``(I - Â) x`` over the high-pass base instead)."""

    def __init__(self, in_features: int, out_features: int, *,
                 high_pass: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.high_pass = high_pass
        w = 1.0 / math.sqrt(out_features)
        self.weight_self = _uniform((in_features, out_features), w, generator)
        self.weight_agg = _uniform((in_features, out_features), w, generator)

    def forward(self, x, ops: Operators):
        agg = spmm_high(ops.adj_hp, x) if self.high_pass else spmm(
            ops.adj_low, x)
        return f32_matmul(x, self.weight_self) + agg @ self.weight_agg


class GCNIIConv(nn.Module):
    """GCNII layer ``((1-α) Â h + α h0)((1-β_l) I + β_l W)`` with
    ``β_l = log(λ / l + 1)``."""

    def __init__(self, in_features: int, out_features: int, *,
                 layer_index: int = 1, alpha: float = 0.1,
                 lamda: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer_index, self.alpha, self.lamda = layer_index, alpha, lamda
        self.weight = _uniform((in_features, out_features),
                               1.0 / math.sqrt(out_features), generator)

    def forward(self, h, h0, ops: Operators):
        beta = math.log(self.lamda / self.layer_index + 1.0)
        support = (1.0 - self.alpha) * spmm(ops.adj_low, h) \
            + self.alpha * h0
        return (1.0 - beta) * support + beta * (support @ self.weight)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel ``[F_in, F_out]``;
    flax's default init (kernel ``lecun_normal``: a normal of variance
    1/F_in truncated at two deviations; bias 0) unless ``bound`` is given
    (both ``U(±bound)``, torch ``nn.Linear``'s law)."""

    def __init__(self, in_features: int, out_features: int, *,
                 bound: Optional[float] = None, gemm_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mm = make_mm(gemm_dtype)
        if bound is not None:
            self.kernel = _uniform((in_features, out_features), bound,
                                   generator)
            self.bias = _uniform((out_features,), bound, generator)
            return
        # flax's truncated normal: std corrected for the truncation
        std = math.sqrt(1.0 / in_features) / .87962566103423978
        kernel = torch.empty(in_features, out_features)
        nn.init.trunc_normal_(kernel, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return self.mm(x, self.kernel) + self.bias


_stats_frozen = [False]


@contextlib.contextmanager
def batch_stats_frozen():
    """BatchNorm modules run in train mode without updating their
    running statistics (a recomputed forward under ``remat``: JAX's
    ``jax.checkpoint`` has no side effects to repeat)."""
    before = _stats_frozen[0]
    _stats_frozen[0] = True
    try:
        yield
    finally:
        _stats_frozen[0] = before


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the rows, in
    its arithmetic: train mode normalizes with the batch mean and the
    biased fast variance ``max(mean(x²) − mean², 0)`` and updates the
    running statistics in place, ``0.9·ra + 0.1·batch`` with that same
    biased variance (``nn.BatchNorm1d`` keeps the unbiased one); eval
    mode reads them.  ``y = (x − mean)·(rsqrt(var + eps)·scale) + bias``.
    Parameters ``scale``/``bias``, buffers ``mean``/``var`` (flax's
    ``batch_stats``).

    The batch statistics are formed one way everywhere: Σx and Σx² over
    the real rows, then divided by their count.  On a rank's slab of a
    sharded operator (``shard``: its ``rank``, ``boundaries`` and
    ``group``) the real rows are the rank's own (``rank_rows``; its pad
    rows left out), and the two sums are added over the ranks in one
    collective (``sum_over_ranks``; its backward, one more), then
    divided by the graph's N: every rank normalizes with the statistics
    of the whole graph and updates the same running statistics, so the
    replicas stay equal.  At one rank that is the single card's
    arithmetic bit for bit.  (The JAX package's sharded BatchNorm
    averages over every padded row, whose values after ``lin_0`` and the
    ReLU are ``relu(bias)``, not zero; ROADMAP.md §C.)"""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x, training: bool, shard=None):
        if training:
            rows, n = x, x.shape[0]
            if shard is not None:
                r0, r1 = rank_rows(shard.boundaries, shard.rank)
                n = int(shard.boundaries[-1])
                if r1 - r0 < x.shape[0]:   # a slice is an autograd node
                    rows = x[: r1 - r0]
            sums = torch.stack([rows.sum(dim=0), (rows * rows).sum(dim=0)])
            if shard is not None and (shard.group is not None
                                      or shard.world_size > 1):
                sums = sum_over_ranks(sums, shard.group)
            mu = sums[0] / n
            var = torch.clamp_min(sums[1] / n - mu * mu, 0.0)
            if not _stats_frozen[0]:
                with torch.no_grad():
                    self.mean.copy_(self.momentum * self.mean
                                    + (1.0 - self.momentum) * mu)
                    self.var.copy_(self.momentum * self.var
                                   + (1.0 - self.momentum) * var)
        else:
            mu, var = self.mean, self.var
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


class MLPBlock(nn.Module):
    """acmgcnpp's input-skip MLP: ``lin_0`` alone at ``num_layers == 1``,
    else ``num_layers - 1`` times Linear → ReLU → BatchNorm → dropout,
    then a last Linear.  The Linears take ``gemm_dtype``'s operands and
    torch ``nn.Linear``'s init law (U(±1/sqrt(F_in))).  ``shard``: the
    rank's share of a sharded operator, for BatchNorm's statistics over
    every rank's rows."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, *, num_layers: int = 1,
                 dropout: float = 0.0, gemm_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers, self.dropout = num_layers, dropout
        f_in = in_channels
        for i in range(num_layers):
            f_out = out_channels if i == num_layers - 1 else hidden_channels
            setattr(self, f"lin_{i}", Dense(
                f_in, f_out, bound=1.0 / math.sqrt(f_in),
                gemm_dtype=gemm_dtype, generator=generator))
            if i < num_layers - 1:
                setattr(self, f"bn_{i}", BatchNorm(f_out))
            f_in = f_out

    def forward(self, x, training: bool = False, drop=None, shard=None,
                x_proj=None):
        """``drop``: the forward's ``ops.dropout.Dropout``, whose next
        sites the hidden layers take at this block's rate; None: no
        dropout.  ``x_proj``: ``lin_0``'s product ``x @ lin_0.kernel``,
        made by the caller; used only at ``num_layers == 1``."""
        if self.num_layers == 1 and x_proj is not None:
            return x_proj + self.lin_0.bias
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"lin_{i}")(x))
            x = getattr(self, f"bn_{i}")(x, training, shard)
            if drop is not None:
                x = drop(x, self.dropout)
        return getattr(self, f"lin_{self.num_layers - 1}")(x)


class ACMConv(nn.Module):
    """Adaptive Channel Mixing graph convolution, and the zoo's
    single-projection layers (``model_type`` mlp / gcn / sgc / snowball)."""

    def __init__(self, in_features: int, out_features: int, *,
                 model_type: str = "acmgcn", variant: bool = False,
                 structure_info: bool = False, use_layernorm: bool = False,
                 nnodes: Optional[int] = None, input_hoist: bool = False,
                 gemm_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if model_type not in MODEL_TYPES or model_type in ("graphsage",
                                                           "gcnII"):
            raise ValueError(f"no ACMConv of model type {model_type!r}")
        self.mm = make_mm(gemm_dtype)
        self.project = make_project(gemm_dtype)
        self.model_type = model_type
        self.variant = variant
        self.out_features = out_features
        self.use_layernorm = use_layernorm
        self.input_hoist = input_hoist
        # flax init laws: U(±1/sqrt(F_out)) channel weights and structure
        # embedding, U(±1) score vectors, U(±1/sqrt(T)) mixing matrix, LN
        # scale 1 / bias 0
        w = 1.0 / math.sqrt(out_features)

        def weight(name):
            setattr(self, name, _uniform((in_features, out_features), w,
                                         generator))

        if model_type == "mlp":
            weight("weight_mlp")
            return
        if model_type in ("sgc", "gcn", "snowball"):
            weight("weight_low")
            return
        if model_type == "acmgraphsage":
            self.sage_low = SAGEConv(in_features, out_features,
                                     generator=generator)
            self.sage_high = SAGEConv(in_features, out_features,
                                      high_pass=True, generator=generator)
            weight("weight_mlp")
        else:
            for nm in CHANNELS[:3]:
                weight(f"weight_{nm}")
        self.structure = (structure_info
                          and model_type in ("acmgcnp", "acmgcnpp"))
        t = 4 if self.structure else 3
        self.channels = CHANNELS[:t]
        if self.structure:
            if nnodes is None:
                raise ValueError("structure_info requires nnodes")
            self.struc_low = _uniform((nnodes, out_features), w, generator)
        if use_layernorm:
            for nm in self.channels:
                setattr(self, f"layer_norm_{nm}", _LNParams(out_features))
        for nm in self.channels:
            setattr(self, f"att_vec_{nm}",
                    _uniform((out_features, 1), 1.0, generator))
        self.att_vec = _uniform((t, t), 1.0 / math.sqrt(t), generator)
        # which channels K2 puts the ReLU on: none for acmsgc; variant 1
        # ReLU'd the low and high projections before the propagation
        if model_type == "acmsgc":
            self.relu = (False,) * t
        elif variant and model_type != "acmgraphsage":
            self.relu = (False, False) + (True,) * (t - 2)
        else:
            self.relu = (True,) * t

    def _branch_params(self, detach: bool):
        """Attention operands ``(v, c, W)`` for one branch; the paired
        eval branch detaches them (it feeds metrics only)."""
        get = (lambda p: p.detach()) if detach else (lambda p: p)
        a = torch.stack([get(getattr(self, f"att_vec_{nm}"))[:, 0]
                         for nm in self.channels])
        if self.use_layernorm:
            ln_mode()
            s = torch.stack([get(getattr(self, f"layer_norm_{nm}").scale)
                             for nm in self.channels])
            b = torch.stack([get(getattr(self, f"layer_norm_{nm}").bias)
                             for nm in self.channels])
            v = s * a
            c = (b * a).sum(dim=1)
        else:
            v = a
            c = torch.zeros(len(self.channels), device=a.device)
        return v, c, get(self.att_vec)

    def _mix(self, zs, detach: bool = False):
        return attention_mix(zs, *self._branch_params(detach),
                             self.use_layernorm,
                             1.0 if len(zs) == 4 else 3.0, self.relu)

    def forward(self, x, ops: Operators, x_eval=None, x_agg=None,
                x_eval_agg=None, also=None):
        """One layer; with ``x_eval`` (ACM family but acmsgc and
        acmgraphsage) also the paired eval branch, riding the same fused
        gather, returned as ``(out, out_eval)``.

        ``x_agg``/``x_eval_agg``: precomputed ``Â @ x`` for the input
        hoist, valid only when the input is the array it came from.

        ``also`` (the types of ``x_eval``): weights of another module that
        read this layer's input (acmgcnpp's ``mlpX.lin_0``), projected with
        the layer's own weights that read it, so the input is rounded once
        for all of them.  Their products follow the output, a tuple a
        branch: ``(out, also_out)`` or ``(out, out_eval, also_out,
        also_eval_out)``; the eval branch's come from detached weights."""
        mt = self.model_type
        if (x_eval is not None or also is not None) \
                and mt not in PAIRED_TYPES:
            raise ValueError(f"paired forward unsupported for {mt!r}")
        mm = self.mm
        if mt == "mlp":
            return mm(x, self.weight_mlp)
        if mt in ("sgc", "gcn", "snowball"):
            if self.input_hoist and not self.variant:
                # these layers' inputs are never dropout'd: the aggregate
                # is valid in training too
                y = x_agg
                if y is None and x.shape[-1] <= HOIST_MAX_COLS:
                    y = spmm(ops.adj_low, x.detach())
                if y is not None:
                    return mm(y, self.weight_low)
            return spmm(ops.adj_low, mm(x, self.weight_low))
        if mt == "acmgraphsage":
            return self._mix((self.sage_low(x, ops), self.sage_high(x, ops),
                              mm(x, self.weight_mlp)))
        if mt == "acmsgc":
            # the high-pass stays 1-hop under a k-hop low-pass
            z_low, z_high, z_mlp = self.project(
                x, self.weight_low, self.weight_high, self.weight_mlp)
            if ops.adj_hp_base is None:
                h_low, h_high = spmm_dual(ops.adj_low, z_low, z_high)
            else:
                h_low = spmm(ops.adj_low, z_low)
                h_high = spmm_high(ops.adj_hp, z_high)
            return self._mix((h_low, h_high, z_mlp))
        return self._acm_forward(x, ops, x_eval, x_agg, x_eval_agg,
                                 also)

    def _acm_forward(self, x, ops, x_eval, x_agg, x_eval_agg, also):
        """acmgcn / acmgcnp / acmgcnpp / acmsnowball: every channel
        aggregation of the call shares one fused gather, and each operand
        goes through every weight that reads it in one projection."""
        f_in = x.shape[-1]
        paired = x_eval is not None
        branches = [x, x_eval] if paired else [x]
        pre_aggs = [x_agg, x_eval_agg] if paired else [x_agg]
        wts = (self.weight_low, self.weight_high, self.weight_mlp,
               *(also or ()))
        ws = [wts, tuple(w.detach() for w in wts)]
        hoisted = [self.input_hoist and not self.variant
                   and (pre_aggs[b] is not None or f_in <= HOIST_MAX_COLS)
                   for b in range(len(branches))]
        need = [b for b in range(len(branches))
                if hoisted[b] and pre_aggs[b] is None]
        if need:
            # layer-1 inputs are data: no gradient, no transpose gather
            got = spmm_multi(ops.adj_low,
                             [branches[b].detach() for b in need],
                             [False] * len(need))
            for b, y in zip(need, got):
                pre_aggs[b] = y
        # a branch that projects before the gather projects its mlp
        # channel and ``also`` in the same call; a hoisted one projects
        # when it mixes
        proj = [b for b in range(len(branches)) if not hoisted[b]]
        proj_zs, extra = {}, [()] * len(branches)
        if proj:
            zs = []
            for b in proj:
                wl, wh, wm, *wa = ws[b]
                z_low, z_high, z_mlp, *extra[b] = self.project(
                    branches[b], wl, wh, wm, *wa)
                if self.variant:   # ACMII: propagate post-ReLU projections
                    z_low, z_high = torch.relu(z_low), torch.relu(z_high)
                zs += [z_low, z_high]
                proj_zs[b] = z_mlp
            n_train = sum(1 for b in proj if b == 0)
            grad_prefix = (2 * n_train if paired and n_train < len(proj)
                           else None)
            outs = spmm_multi(ops.adj_low, zs, [False, True] * len(proj),
                              grad_prefix=grad_prefix)
            for i, b in enumerate(proj):
                proj_zs[b] = (outs[2 * i], outs[2 * i + 1], proj_zs[b])
        struc = None
        if self.structure:
            if ops.adj_unnorm is None:
                raise ValueError("structure_info needs the raw adjacency "
                                 "operator (precompute_operators("
                                 "structure_info=True))")
            # depends on parameters only: one gather serves both branches
            # (K2 applies its ReLU); a rank of a sharded run gathers from
            # its slab of the embedding's rows
            struc = spmm(ops.adj_unnorm,
                         node_rows(ops.adj_unnorm, self.struc_low))
        results = []
        for b, xb in enumerate(branches):
            wl, wh, wm, *wa = ws[b]
            if hoisted[b]:
                y = pre_aggs[b]
                if f_in > HOIST_MAX_COLS:
                    z_low, y_high = self.project(y, wl, wh)
                    x_high, z_mlp, *extra[b] = self.project(xb, wh, wm, *wa)
                    z_high = x_high - y_high
                    del x_high, y_high   # as short-lived as before sharing
                else:
                    z_low, z_high = self.mm(y, wl), self.mm(xb - y, wh)
                    z_mlp, *extra[b] = self.project(xb, wm, *wa)
                zs = [z_low, z_high, z_mlp]
            else:
                zs = list(proj_zs.pop(b))
            if struc is not None:
                zs.append(struc)
            if b > 0:
                # the eval branch feeds metrics only: no gradient reaches
                # it (its columns of the fused gather get none either)
                zs = [z.detach() for z in zs]
            results.append(self._mix(zs, detach=b > 0))
        if also is not None:
            return (*results, *map(tuple, extra))
        return tuple(results) if paired else results[0]
