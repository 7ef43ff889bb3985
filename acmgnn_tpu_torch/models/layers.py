"""ACM layer — counterpart of ``acmgnn_tpu/models/layers.py``.

``ACMConv`` for ``acmgcn``/``acmgcnp``, variant 0, three channels:

- ``H_L = relu(Â (X W_L))``, ``H_H = relu((I - Â)(X W_H))``,
  ``H_I = relu(X W_I)``;
- ``att = softmax(sigmoid(scores) @ W_att / 3)`` with per-channel scores
  ``H_i · a_i`` — through a LayerNorm (flax fast variance, eps 1e-5) in
  its projected form when ``use_layernorm``;
- output ``3 · Σ att_i H_i``.

The attention and mix of each branch is one launch of K2 (forward) and K3
(backward), ``csrc/attention.cu``; ``attention_mix_forward_plain`` and
``attention_mix_backward_plain`` are their plain PyTorch versions.  The
channel projections ``X W`` follow ``gemm_dtype`` (``make_mm``): f32, or
bf16 operands with an f32 result and JAX's backward (``bf16_matmul``);
the attention's own products stay f32.
Parameter names and orientations follow the flax module (``weight_low``
is ``[F_in, F_out]`` used as ``x @ W``; ``layer_norm_low.scale``), so a
flax parameter tree copies over flat (``models/convert.py``).
"""

from __future__ import annotations

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
# K2 / K3: channel attention + mix
# ---------------------------------------------------------------------------


def _row_scalars(hs, v, c, W, use_ln: bool):
    """Per-row moments, centred projections, scores, gates and softmax
    weights (the kernels' arithmetic, in the same order)."""
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


def attention_mix_forward_plain(h0, h1, h2, v, c, W, use_ln: bool,
                                scale: float):
    """Plain PyTorch version of K2: ``scale · Σ att_i h_i``."""
    *_, att = _row_scalars((h0, h1, h2), v, c, W, use_ln)
    return scale * (att[:, 0:1] * h0 + att[:, 1:2] * h1 + att[:, 2:3] * h2)


def attention_mix_backward_plain(h0, h1, h2, gout, v, c, W, use_ln: bool,
                                 scale: float):
    """Plain PyTorch version of K3: ``(dh0, dh1, dh2, aux)``; ``aux`` rows
    hold ``[dp(3), dS(3), dscore(3), g(3), dl(3)]`` where ``dS = −dp·mu`` is
    the row's share of the gradient of ``Σ_j v_ij``."""
    hs = (h0, h1, h2)
    t = len(hs)
    d = h0.shape[1]
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
            dmu = -dp * S[i] - 2.0 * mus[i] * dm2
        else:
            dp, dS = ds, torch.zeros_like(ds)
            dm2 = dmu = torch.zeros_like(ds)
        dhs.append(scale * att[:, i:i + 1] * gout + dp[:, None] * v[i]
                   + dmu[:, None] / d + dm2[:, None] * 2.0 * h / d)
        dps.append(dp), dSs.append(dS)
    aux = torch.cat([torch.stack(dps, 1), torch.stack(dSs, 1), dscore, g, dl],
                    dim=1)
    return (*dhs, aux)


def _check_attention_operands(hs, v, c, W):
    n, d = hs[0].shape
    for h in hs:
        if h.dtype != torch.float32 or h.shape != (n, d):
            raise ValueError("attention channels must be f32 and [N, d]")
    want = {"v": (v, (3, d)), "c": (c, (3,)), "W": (W, (3, 3))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"attention {name} must be f32 {shape}")
    kernels.require_cuda(*hs, v, c, W)
    return n, d


def attention_mix_forward(h0, h1, h2, v, c, W, use_ln: bool, scale: float):
    """K2 on CUDA tensors; the plain version on CPU tensors."""
    if h0.device.type == "cpu":
        return attention_mix_forward_plain(h0, h1, h2, v, c, W, use_ln,
                                           scale)
    hs = [h.contiguous() for h in (h0, h1, h2)]
    v, c, W = (t.contiguous() for t in (v, c, W))
    n, d = _check_attention_operands(hs, v, c, W)
    out = torch.empty_like(hs[0])
    lib = kernels.library("attention")
    rc = lib.acm_k2_attn_fwd(
        *(kernels.ptr(t) for t in (*hs, v, c, W, out)), n, d,
        int(use_ln), float(scale), kernels.stream(),
    )
    kernels.check(lib, rc, "K2 attention forward")
    kernels.count(f"k2_attn_fwd_d{d}")
    return out


def attention_mix_backward(h0, h1, h2, gout, v, c, W, use_ln: bool,
                           scale: float):
    """K3 on CUDA tensors; the plain version on CPU tensors."""
    if h0.device.type == "cpu":
        return attention_mix_backward_plain(h0, h1, h2, gout, v, c, W,
                                            use_ln, scale)
    hs = [h.contiguous() for h in (h0, h1, h2)]
    gout = gout.contiguous()
    v, c, W = (t.contiguous() for t in (v, c, W))
    n, d = _check_attention_operands([*hs, gout], v, c, W)
    S = v.sum(dim=1)
    dhs = [torch.empty_like(hs[0]) for _ in range(3)]
    aux = torch.empty(n, 15, dtype=torch.float32, device=gout.device)
    lib = kernels.library("attention")
    rc = lib.acm_k3_attn_bwd(
        *(kernels.ptr(t) for t in (*hs, gout, v, S, c, W, *dhs, aux)), n, d,
        int(use_ln), float(scale), kernels.stream(),
    )
    kernels.check(lib, rc, "K3 attention backward")
    kernels.count(f"k3_attn_bwd_d{d}")
    return (*dhs, aux)


class _AttentionMix(torch.autograd.Function):
    """Saves only its inputs; K3 recomputes the row scalars."""

    @staticmethod
    def forward(ctx, h0, h1, h2, v, c, W, use_ln, scale):
        ctx.save_for_backward(h0, h1, h2, v, c, W)
        ctx.use_ln, ctx.scale = use_ln, scale
        return attention_mix_forward(h0, h1, h2, v, c, W, use_ln, scale)

    @staticmethod
    def backward(ctx, gout):
        h0, h1, h2, v, c, W = ctx.saved_tensors
        dh0, dh1, dh2, aux = attention_mix_backward(
            h0, h1, h2, gout, v, c, W, ctx.use_ln, ctx.scale)
        dp, dS, dscore, g, dl = aux.split(3, dim=1)
        # row reductions for the parameter gradients: [N, d] x [N] products
        dv = torch.stack([h.T @ dp[:, i] for i, h in enumerate((h0, h1, h2))])
        dv = dv + dS.sum(dim=0)[:, None]
        dW = (g.T @ dl) / 3
        return dh0, dh1, dh2, dv, dscore.sum(dim=0), dW, None, None


def attention_mix(hs, v, c, W, use_ln: bool, scale: float):
    """Differentiable ``scale · Σ att_i h_i`` over the three channels."""
    return _AttentionMix.apply(*hs, v, c, W, use_ln, scale)


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
            hs = (torch.relu(z_low), torch.relu(z_high),
                  torch.relu(mm(xb, w_mlp)))
            results.append(attention_mix(hs, *att_ops, self.use_layernorm,
                                         3.0))
        return tuple(results) if paired else results[0]
