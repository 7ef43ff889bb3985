"""ACM layer — counterpart of ``acmgnn_tpu/models/layers.py``.

``ACMConv`` for ``acmgcn``/``acmgcnp``, variant 0, three channels:

- ``H_L = relu(Â (X W_L))``, ``H_H = relu((I - Â)(X W_H))``,
  ``H_I = relu(X W_I)``;
- ``att = softmax(sigmoid(scores) @ W_att / 3)`` with per-channel scores
  ``H_i · a_i`` — through a LayerNorm (flax fast variance, eps 1e-5) in
  its projected form when ``use_layernorm``;
- output ``3 · Σ att_i H_i``.

The channel ReLU, attention and mix of each branch is one launch of K2
(forward) and K3 (backward, with the parameter gradients summed over the
rows), ``csrc/attention.cu``; ``attention_mix_forward_plain`` and
``attention_mix_backward_plain`` are their plain PyTorch versions.  The
channel projections ``X W`` follow ``gemm_dtype`` (``make_mm``): f32, or
bf16 operands with an f32 result and JAX's backward (``bf16_matmul``);
the attention's own products stay f32.
Parameter names and orientations follow the flax module (``weight_low``
is ``[F_in, F_out]`` used as ``x @ W``; ``layer_norm_low.scale``), so a
flax parameter tree copies over flat (``models/convert.py``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch import nn

from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.graph import Operators
from acmgnn_tpu_torch.ops.spmm import spmm_multi

# Widest layer-1 input the hoist gathers directly (kept from the JAX
# package, where a wider gather fell off the gather engine's full rate).
HOIST_MAX_COLS = 128

LN_EPS = 1e-5
CHANNELS = ("low", "high", "mlp")


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
ROW_SUMS = 15              # K3's row sums a block keeps: dS, dscore, g dl


def _row_scalars(hs, v, c, W, use_ln: bool):
    """Per-row moments, centred projections, scores, gates and softmax
    weights of the ReLU'd channels ``hs`` (the kernels' arithmetic, in the
    same order)."""
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


def attention_mix_forward_plain(z0, z1, z2, v, c, W, use_ln: bool,
                                scale: float):
    """Plain PyTorch version of K2: ``scale · Σ att_i relu(z_i)``."""
    hs = [torch.relu(z) for z in (z0, z1, z2)]
    *_, att = _row_scalars(hs, v, c, W, use_ln)
    return scale * (att[:, 0:1] * hs[0] + att[:, 1:2] * hs[1]
                    + att[:, 2:3] * hs[2])


def attention_backward_rows(z0, z1, z2, gout, v, c, W, use_ln: bool,
                            scale: float):
    """K3's per-row quantities, in its arithmetic: ``(hs, dhs, dp, dS,
    dscore, g, dl)`` with ``hs = relu(z)``, ``dhs`` the gradients of the
    ReLU'd channels, and ``[N, 3]`` row terms of the parameter gradients
    (``dS = −dp·mu`` is the row's share of the gradient of ``Σ_j v_ij``)."""
    hs = [torch.relu(z) for z in (z0, z1, z2)]
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
            add = (-dp * S[i] - 2.0 * mus[i] * dm2) / d
            mul = (2.0 * dm2) / d
        else:
            dp, dS = ds, torch.zeros_like(ds)
            add = mul = torch.zeros_like(ds)
        dhs.append(scale * att[:, i:i + 1] * gout + dp[:, None] * v[i]
                   + add[:, None] + mul[:, None] * h)
        dps.append(dp), dSs.append(dS)
    return (hs, dhs, torch.stack(dps, 1), torch.stack(dSs, 1), dscore, g,
            dl)


def attention_mix_backward_plain(z0, z1, z2, gout, v, c, W, use_ln: bool,
                                 scale: float):
    """Plain PyTorch version of K3: ``(dz0, dz1, dz2, dv, dc, dW)``, the
    ReLU's gradient (0 at 0) applied and the parameter gradients summed
    over the rows (``dc`` is 0 without LayerNorm, where ``c`` is unused)."""
    hs, dhs, dp, dS, dscore, g, dl = attention_backward_rows(
        z0, z1, z2, gout, v, c, W, use_ln, scale)
    dzs = [torch.where(h > 0, dh, 0.0) for h, dh in zip(hs, dhs)]
    dv = torch.stack([h.T @ dp[:, i] for i, h in enumerate(hs)]) \
        + dS.sum(dim=0)[:, None]
    dc = dscore.sum(dim=0) if use_ln else torch.zeros_like(c)
    return (*dzs, dv, dc, (g.T @ dl) / len(hs))


def attention_grad_scales(z0, z1, z2, gout, v, c, W, use_ln: bool,
                          scale: float):
    """``Σ_rows |term|`` of each element of ``dv``, ``dc`` and ``dW``: the
    scale of their rounding error, for checking K3 against its plain
    version (chip_smoke.py, the card tests)."""
    hs, _, dp, dS, dscore, g, dl = attention_backward_rows(
        z0, z1, z2, gout, v, c, W, use_ln, scale)
    dv = torch.stack([h.T @ dp[:, i].abs() for i, h in enumerate(hs)]) \
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


def attention_config(kind: str, zs, lds, d: int, plan):
    """``(vec, lanes, elems, resident blocks)`` of K2 (``kind`` "fwd") or
    K3 ("bwd") at ``plan`` = ``(lanes, elems)`` on the row-major operands
    ``zs`` with row strides ``lds``: 16-byte loads (8-byte where a lane holds 2 floats) where d, the row
    strides and the base pointers allow, else scalar loads.  The residency
    is asked of the occupancy API once per instance and card (an instance
    attention.cu does not compile fails the query)."""
    g, e = plan
    vec = 2 if e == 2 else 4
    if d % vec or any(ld % vec or z.data_ptr() % (4 * vec)
                      for z, ld in zip(zs, lds)):
        vec = 1
    key = (kind, vec, g, e, zs[0].device)
    n = _resident.get(key)
    if n is None:
        lib = kernels.library("attention")
        active = ctypes.c_int(0)
        if kind == "fwd":
            rc = lib.acm_k2_attn_fwd(
                *[None] * 3, *[0] * 3, *[None] * 4, 0, d, 0, 1.0, vec, g, e,
                0, ctypes.byref(active), None)
        else:
            rc = lib.acm_k3_attn_bwd(
                *[None] * 3, *[0] * 3, None, 0, *[None] * 10, 0, d, 0, 1.0,
                vec, g, e, 0, ctypes.byref(active), None)
        kernels.check(lib, rc, f"K{2 if kind == 'fwd' else 3} occupancy "
                               f"query")
        n = active.value
        if n <= 0:
            raise RuntimeError(f"K2/K3 {kind} {(vec, g, e)}: no block fits")
        _resident[key] = n
    return vec, g, e, n


def attention_grid(n_rows: int, lanes: int, resident: int) -> int:
    """Blocks of a launch: at most the resident ones, none idle."""
    return max(1, min(resident, -(-n_rows // (ATTN_THREADS // lanes))))


def _check_attention_operands(zs, v, c, W):
    n, d = zs[0].shape
    for z in zs:
        if z.dtype != torch.float32 or tuple(z.shape) != (n, d):
            raise ValueError("attention channels must be f32 and [N, d]")
    want = {"v": (v, (3, d)), "c": (c, (3,)), "W": (W, (3, 3))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"attention {name} must be f32 {shape}")
    kernels.require_cuda(v, c, W, strided=zs)
    return n, d


def attention_mix_forward(z0, z1, z2, v, c, W, use_ln: bool, scale: float):
    """K2 on CUDA tensors, the plain version on CPU tensors:
    ``scale · Σ att_i relu(z_i)``.  The channels may be column views
    (unit column stride)."""
    if z0.device.type == "cpu":
        return attention_mix_forward_plain(z0, z1, z2, v, c, W, use_ln,
                                           scale)
    return _launch_forward((z0, z1, z2), v, c, W, use_ln, scale,
                           attention_plan(z0.shape[1]))


def _launch_forward(zs, v, c, W, use_ln: bool, scale: float, plan):
    """K2 at ``plan`` = ``(lanes, elems)`` (``attention_plan``'s, or
    another compiled instance: chip_smoke.py's sweep)."""
    v, c, W = (t.contiguous() for t in (v, c, W))
    n, d = _check_attention_operands(zs, v, c, W)
    zs, lds = zip(*(_row_major(z) for z in zs))
    vec, g, e, resident = attention_config("fwd", zs, lds, d, plan)
    out = torch.empty(n, d, dtype=torch.float32, device=zs[0].device)
    lib = kernels.library("attention")
    rc = lib.acm_k2_attn_fwd(
        *(kernels.ptr(z) for z in zs), *lds,
        *(kernels.ptr(t) for t in (v, c, W, out)), n, d, int(use_ln),
        float(scale), vec, g, e, attention_grid(n, g, resident), None,
        kernels.stream())
    kernels.check(lib, rc, "K2 attention forward")
    kernels.count(f"k2_attn_fwd_d{d}")
    return out


def attention_mix_backward(z0, z1, z2, gout, v, c, W, use_ln: bool,
                           scale: float):
    """K3 on CUDA tensors, the plain version on CPU tensors: ``(dz0, dz1,
    dz2, dv, dc, dW)``, the parameter gradients summed over the rows in a
    fixed order (bit-reproducible on one card)."""
    if z0.device.type == "cpu":
        return attention_mix_backward_plain(z0, z1, z2, gout, v, c, W,
                                            use_ln, scale)
    return _launch_backward((z0, z1, z2), gout, v, c, W, use_ln, scale,
                            attention_plan(z0.shape[1]))[:6]


def _launch_backward(zs, gout, v, c, W, use_ln: bool, scale: float, plan):
    """K3 at ``plan`` = ``(lanes, elems)``: ``(dz0, dz1, dz2, dv, dc, dW,
    partials)``, ``partials`` the ``[grid, 3 d + ROW_SUMS]`` block sums
    that the finishing kernel added up."""
    v, c, W = (t.contiguous() for t in (v, c, W))
    n, d = _check_attention_operands((*zs, gout), v, c, W)
    zs, lds = zip(*(_row_major(z) for z in (*zs, gout)))
    vec, g, e, resident = attention_config("bwd", zs, lds, d, plan)
    grid = attention_grid(n, g, resident)
    dev = zs[0].device
    dzs = [torch.empty(n, d, dtype=torch.float32, device=dev)
           for _ in range(3)]
    partials = torch.empty(grid, 3 * d + ROW_SUMS, dtype=torch.float32,
                           device=dev)
    dv = torch.empty(3, d, dtype=torch.float32, device=dev)
    dc = torch.empty(3, dtype=torch.float32, device=dev)
    dW = torch.empty(3, 3, dtype=torch.float32, device=dev)
    lib = kernels.library("attention")
    rc = lib.acm_k3_attn_bwd(
        *(kernels.ptr(z) for z in zs[:3]), *lds[:3], kernels.ptr(zs[3]),
        lds[3], *(kernels.ptr(t) for t in (v, c, W, *dzs, partials, dv, dc,
                                           dW)),
        n, d, int(use_ln), float(scale), vec, g, e, grid, None,
        kernels.stream())
    kernels.check(lib, rc, "K3 attention backward")
    kernels.count(f"k3_attn_bwd_d{d}")
    return (*dzs, dv, dc, dW, partials)


class _AttentionMix(torch.autograd.Function):
    """Saves only its inputs (the channels before the ReLU); K3 recomputes
    the row scalars and returns every gradient, the parameters' summed."""

    @staticmethod
    def forward(ctx, z0, z1, z2, v, c, W, use_ln, scale):
        ctx.save_for_backward(z0, z1, z2, v, c, W)
        ctx.use_ln, ctx.scale = use_ln, scale
        return attention_mix_forward(z0, z1, z2, v, c, W, use_ln, scale)

    @staticmethod
    def backward(ctx, gout):
        z0, z1, z2, v, c, W = ctx.saved_tensors
        return (*attention_mix_backward(z0, z1, z2, gout, v, c, W,
                                        ctx.use_ln, ctx.scale), None, None)


def attention_mix(zs, v, c, W, use_ln: bool, scale: float):
    """Differentiable ``scale · Σ att_i relu(z_i)`` over the three
    channels, given before the ReLU."""
    return _AttentionMix.apply(*zs, v, c, W, use_ln, scale)


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


class _Bf16Matmul(torch.autograd.Function):
    """JAX's ``dot(a.bf16, w.bf16, preferred_element_type=f32)``: the
    operands are rounded to bf16, the product is not.  Its backward is
    what ``jax.grad`` makes of it: the f32 cotangent times the other
    operand's bf16 values as an f32 product, rounded to bf16 and cast
    back to the input's dtype; the cotangent itself is not rounded."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        ctx.dtypes = (a.dtype, w.dtype)
        return _mm_f32_out(ab, wb)

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = (g @ wb.float().T).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = (ab.float().T @ g).to(torch.bfloat16).to(ctx.dtypes[1])
        return da, dw


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``a @ w`` with bf16 operands and an f32 result."""
    return _Bf16Matmul.apply(a, w)


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


# ---------------------------------------------------------------------------
# ACMConv
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


class ACMConv(nn.Module):
    """Adaptive Channel Mixing graph convolution (acmgcn / acmgcnp)."""

    def __init__(self, in_features: int, out_features: int, *,
                 model_type: str = "acmgcn", variant: bool = False,
                 structure_info: bool = False, use_layernorm: bool = False,
                 input_hoist: bool = False, gemm_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if model_type not in ("acmgcn", "acmgcnp"):
            raise NotImplementedError(f"ACMConv {model_type!r} not ported")
        if variant or structure_info:
            raise NotImplementedError("variant 1 and the structure channel "
                                      "are not ported yet")
        self.mm = make_mm(gemm_dtype)
        self.out_features = out_features
        self.use_layernorm = use_layernorm
        self.input_hoist = input_hoist
        # flax init laws: U(±1/sqrt(F_out)) channel weights, U(±1) score
        # vectors, U(±1/sqrt(T)) mixing matrix, LN scale 1 / bias 0
        w = 1.0 / math.sqrt(out_features)
        for nm in CHANNELS:
            setattr(self, f"weight_{nm}",
                    _uniform((in_features, out_features), w, generator))
        for nm in CHANNELS:
            setattr(self, f"att_vec_{nm}",
                    _uniform((out_features, 1), 1.0, generator))
        t = len(CHANNELS)
        self.att_vec = _uniform((t, t), 1.0 / math.sqrt(t), generator)
        if use_layernorm:
            for nm in CHANNELS:
                setattr(self, f"layer_norm_{nm}", _LNParams(out_features))

    def _branch_params(self, detach: bool):
        """Weights and attention operands for one branch; the paired eval
        branch detaches them (it feeds metrics only)."""
        get = (lambda p: p.detach()) if detach else (lambda p: p)
        ws = [get(getattr(self, f"weight_{nm}")) for nm in CHANNELS]
        a = torch.stack([get(getattr(self, f"att_vec_{nm}"))[:, 0]
                         for nm in CHANNELS])
        if self.use_layernorm:
            s = torch.stack([get(getattr(self, f"layer_norm_{nm}").scale)
                             for nm in CHANNELS])
            b = torch.stack([get(getattr(self, f"layer_norm_{nm}").bias)
                             for nm in CHANNELS])
            v = s * a
            c = (b * a).sum(dim=1)
        else:
            v = a
            c = torch.zeros(len(CHANNELS), device=a.device)
        return ws, (v, c, get(self.att_vec))

    def forward(self, x, ops: Operators, x_eval=None, x_agg=None,
                x_eval_agg=None):
        """One ACM layer; with ``x_eval`` also the paired eval branch,
        riding the same fused gather, returned as ``(out, out_eval)``.

        ``x_agg``/``x_eval_agg``: precomputed ``Â @ x`` for the input
        hoist, valid only when the input is the array it came from."""
        f_in = x.shape[-1]
        mm = self.mm
        paired = x_eval is not None
        branches = [x, x_eval] if paired else [x]
        pre_aggs = [x_agg, x_eval_agg] if paired else [x_agg]
        params = [self._branch_params(detach=b > 0)
                  for b in range(len(branches))]
        hoisted = [self.input_hoist
                   and (pre_aggs[b] is not None or f_in <= HOIST_MAX_COLS)
                   for b in range(len(branches))]
        need = [b for b in range(len(branches))
                if hoisted[b] and pre_aggs[b] is None]
        if need:
            # layer-1 inputs are data: no gradient, no transpose gather
            got = spmm_multi(ops.adj_low, [branches[b].detach() for b in need],
                             [False] * len(need))
            for b, y in zip(need, got):
                pre_aggs[b] = y
        proj = [b for b in range(len(branches)) if not hoisted[b]]
        proj_aggs = {}
        if proj:
            zs = []
            for b in proj:
                (w_low, w_high, _), _ = params[b]
                zs += [mm(branches[b], w_low), mm(branches[b], w_high)]
            n_train = sum(1 for b in proj if b == 0)
            grad_prefix = (2 * n_train if paired and n_train < len(proj)
                           else None)
            outs = spmm_multi(ops.adj_low, zs, [False, True] * len(proj),
                              grad_prefix=grad_prefix)
            for i, b in enumerate(proj):
                proj_aggs[b] = (outs[2 * i], outs[2 * i + 1])
        results = []
        for b, xb in enumerate(branches):
            (w_low, w_high, w_mlp), att_ops = params[b]
            if hoisted[b]:
                y = pre_aggs[b]
                if f_in > HOIST_MAX_COLS:
                    z_low = mm(y, w_low)
                    z_high = mm(xb, w_high) - mm(y, w_high)
                else:
                    z_low, z_high = mm(y, w_low), mm(xb - y, w_high)
            else:
                z_low, z_high = proj_aggs[b]
            # K2 applies the channel ReLU itself
            zs = (z_low, z_high, mm(xb, w_mlp))
            results.append(attention_mix(zs, *att_ops, self.use_layernorm,
                                         3.0))
        return tuple(results) if paired else results[0]
