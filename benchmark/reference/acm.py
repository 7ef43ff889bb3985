"""ACM-GCN+ and ACM-GCN++ in plain PyTorch, as the configurations state
them, with full-batch training by Adam.

The model (Luan et al., arXiv:2210.07606, and the ACM-PyTorch code it
publishes): two layers ``conv(F->H) -> relu -> dropout -> conv(H->C)``,
the input dropped first; each layer mixes the channels ``H_L = Â X W_L``,
``H_H = (I - Â) X W_H``, ``H_I = X W_I`` and, with the structure channel
(``structure_info``), ``H_S = A S`` over a learned node embedding ``S``,
after a ReLU on each, by ``att = softmax(sigmoid([LN(h_i)·a_i]) W / T)``
and ``out = K Σ att_i h_i`` (K = 3 at T = 3, 1 at T = 4).  ACM-GCN++
(``acmgcnpp``) adds ``dropout(relu(X W_X + b))`` to the first layer's
output.  ``Â = D^-1 (A + I)``; the loss is the mean negative
log-likelihood over the training nodes; Adam with L2 folded into the
gradient (torch's ``weight_decay``).

The precision the configuration states, and the arithmetic that follows
from it, which the reference keeps so that its numbers separate rounding
from a fault:

- ``spmm_dtype`` bfloat16: a sparse product rounds its operand rows to
  bf16 and sums them in f32; the row normalization ``1/deg`` is applied
  in f32 after the sum, and the transposed product ``Âᵀ g = Bᵀ(s ⊙ g)``
  (B = A + I binary, s = 1/deg) rounds ``g`` to bf16 and then ``s ⊙ g``
  to bf16 again (the JAX package's order); the high-pass is ``z − Âz``
  from the f32 ``z``;
- ``gemm_dtype`` float32: the channel projections in f32 (TF32 off);
  bfloat16: bf16 operands and an f32 product, its backward's products
  rounded to bf16 (``jax.grad`` of such a dot);
- ``hoist_first``: the first layer gathers its input and projects it,
  ``Â (X W) = (Â X) W``: ``H_H = (X − ÂX) W_H``, or ``X W_H − (ÂX) W_H``
  for inputs over 128 columns, whose dropped training branch projects
  first and gathers the projections;
- LayerNorm in flax's arithmetic (``max(mean(h²) − mean(h)², 0)``, eps
  1e-5; the gradient halved where the difference is exactly 0).

Departures from the published code: none in the mathematics.  Features
are row-normalized as the published preprocessing does (``features /
rowsum`` in f32 numpy), except for ACM-GCN+/++ with the structure
channel.

The projections may be lowered for the control (``make_mm``'s
``lower``): "tf32" rounds every projection operand to TF32, "float8" to
float8 e4m3 with one scale per operand.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.reference import philox

LN_EPS = 1e-5
HOIST_MAX_COLS = 128
CHANNELS = ("low", "high", "mlp", "struc_low")


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


def _csr(mat: sp.csr_matrix, device) -> torch.Tensor:
    mat = sp.csr_matrix(mat)
    mat.sort_indices()
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(mat.indptr.astype(np.int64)),
            torch.from_numpy(mat.indices.astype(np.int64)),
            torch.from_numpy(mat.data.astype(np.float32)),
            size=mat.shape, check_invariants=True).to(device)


class Graph:
    """The operators worked out again from the raw adjacency ``adj``:
    ``B = A + I`` and its transpose as binary CSR, ``s = 1/deg(B)`` in
    f32 (formed in f64), and the raw ``A`` and its transpose."""

    def __init__(self, adj: sp.spmatrix, device):
        a = sp.csr_matrix(adj, dtype=np.float64)
        a = (a != 0).astype(np.float64)
        b = (a + sp.eye(a.shape[0], format="csr")).tocsr()
        deg = np.asarray(b.sum(axis=1)).ravel()
        with np.errstate(divide="ignore"):
            inv = np.where(deg > 0, 1.0 / deg, 0.0)
        self.n = a.shape[0]
        self.b = _csr(b, device)
        self.bt = _csr(b.T.tocsr(), device)
        self.a = _csr(a, device)
        self.at = _csr(a.T.tocsr(), device)
        self.s = torch.from_numpy(inv.astype(np.float32)).to(device)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _LowPass(torch.autograd.Function):
    """``[Â z | z − Â z]`` by columns (``hp``: a bool per column)."""

    @staticmethod
    def forward(ctx, z, graph, hp):
        ctx.graph, ctx.hp = graph, hp
        agg = (graph.b @ _bf16(z)) * graph.s[:, None]
        return torch.where(hp, z - agg, agg)

    @staticmethod
    def backward(ctx, g):
        graph, hp = ctx.graph, ctx.hp
        sg = torch.where(hp, -g, g)
        pre = _bf16(_bf16(sg) * graph.s[:, None])
        dz = graph.bt @ pre
        return torch.where(hp, dz + g, dz), None, None


def low_pass(graph: Graph, zs, high):
    """``Â z_i``, or ``z_i − Â z_i`` where ``high[i]``, in one product."""
    dims = [z.shape[1] for z in zs]
    hp = torch.cat([torch.full((d,), bool(h), device=zs[0].device)
                    for d, h in zip(dims, high)])
    out = _LowPass.apply(torch.cat(zs, dim=1), graph, hp)
    return list(torch.split(out, dims, dim=1))


class _Raw(torch.autograd.Function):
    """``A S`` over the raw adjacency (bf16 operand, f32 sum)."""

    @staticmethod
    def forward(ctx, s, graph):
        ctx.graph = graph
        return graph.a @ _bf16(s)

    @staticmethod
    def backward(ctx, g):
        return ctx.graph.at @ _bf16(g), None


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits (to nearest, ties even)."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """f32 through float8 e4m3 with one scale (its largest value to 448)."""
    amax = t.abs().max().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


LOWER = {"tf32": _round_tf32, "float8": _round_fp8}


class _Bf16Mm(torch.autograd.Function):
    """bf16 operands, f32 product; the backward's products rounded to
    bf16."""

    @staticmethod
    def forward(ctx, a, w, lower):
        ab, wb = _bf16(a), _bf16(w)
        if lower is not None:
            ab, wb = lower(ab), lower(wb)
        ctx.save_for_backward(ab, wb)
        return ab @ wb

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = _bf16(g @ wb.T)
        if ctx.needs_input_grad[1]:
            dw = _bf16(ab.T @ g)
        return da, dw, None


class _LoweredMm(torch.autograd.Function):
    """f32 product of operands rounded by ``lower`` (the control)."""

    @staticmethod
    def forward(ctx, a, w, lower):
        ctx.save_for_backward(a, w)
        ctx.lower = lower
        return lower(a) @ lower(w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        lo = ctx.lower
        da = lo(g) @ lo(w).T if ctx.needs_input_grad[0] else None
        dw = lo(a).T @ lo(g) if ctx.needs_input_grad[1] else None
        return da, dw, None


def make_mm(gemm_dtype: str, lower: Optional[str] = None) -> Callable:
    """The projection of a configuration's ``gemm_dtype``, lowered to the
    control's precision where ``lower`` names one."""
    fn = LOWER[lower] if lower else None
    if gemm_dtype == "bfloat16":
        return lambda a, w: _Bf16Mm.apply(a, w, fn)
    if gemm_dtype != "float32":
        raise ValueError(f"unknown gemm_dtype {gemm_dtype!r}")
    if fn is None:
        return lambda a, w: a @ w
    return lambda a, w: _LoweredMm.apply(a, w, fn)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def channels(model: dict) -> tuple:
    return CHANNELS[:4] if model["structure_info"] else CHANNELS[:3]


def param_shapes(model: dict, nfeat: int, nclass: int, nnodes: int) -> dict:
    """Every parameter by name (the names the program's models load):
    shape and initial law (``("uniform", bound)``, ``("ones",)`` or
    ``("zeros",)``), the published laws: U(±1/sqrt(F_out)) projections and
    structure embedding, U(±1) score vectors, U(±1/sqrt(T)) mixing matrix,
    LayerNorm 1/0, U(±1/sqrt(F_in)) for ACM-GCN++'s input Linear."""
    h = model["hidden"]
    chans = channels(model)
    t = len(chans)
    out = {}
    if model["model_type"] == "acmgcnpp":
        b = 1.0 / math.sqrt(nfeat)
        out["mlpX.lin_0.kernel"] = ((nfeat, h), ("uniform", b))
        out["mlpX.lin_0.bias"] = ((h,), ("uniform", b))
    for layer, (f_in, f_out) in enumerate(((nfeat, h), (h, nclass))):
        p = f"gcn_{layer}."
        w = 1.0 / math.sqrt(f_out)
        for nm in CHANNELS[:3]:
            out[p + f"weight_{nm}"] = ((f_in, f_out), ("uniform", w))
        if model["structure_info"]:
            out[p + "struc_low"] = ((nnodes, f_out), ("uniform", w))
        if model["use_layernorm"]:
            for nm in chans:
                out[p + f"layer_norm_{nm}.scale"] = ((f_out,), ("ones",))
                out[p + f"layer_norm_{nm}.bias"] = ((f_out,), ("zeros",))
        for nm in chans:
            out[p + f"att_vec_{nm}"] = ((f_out, 1), ("uniform", 1.0))
        out[p + "att_vec"] = ((t, t), ("uniform", 1.0 / math.sqrt(t)))
    return out


def init_params(shapes: dict, gen: torch.Generator, device) -> dict:
    """The initial parameters from one uniform draw on ``device``."""
    total = sum(math.prod(s) for s, law in shapes.values()
                if law[0] == "uniform")
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, (shape, law) in shapes.items():
        if law[0] == "uniform":
            k = math.prod(shape)
            out[name] = (u[off:off + k] * law[1]).reshape(shape)
            off += k
        elif law[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _mix(p: dict, prefix: str, zs, use_ln: bool):
    """ReLU on each channel, the attention over them and the mix."""
    hs = [torch.relu(z) for z in zs]
    names = CHANNELS[:len(hs)]
    scores = []
    for h, nm in zip(hs, names):
        if use_ln:
            mu = h.mean(dim=1, keepdim=True)
            # flax's max(., 0): half the gradient at the tie, as
            # ``jnp.maximum`` gives it (``clamp_min`` gives it whole)
            diff = (h * h).mean(dim=1, keepdim=True) - mu * mu
            var = torch.maximum(diff, torch.zeros_like(diff))
            h = ((h - mu) * torch.rsqrt(var + LN_EPS)
                 * p[prefix + f"layer_norm_{nm}.scale"]
                 + p[prefix + f"layer_norm_{nm}.bias"])
        scores.append(h @ p[prefix + f"att_vec_{nm}"])
    t = len(hs)
    att = torch.softmax((torch.sigmoid(torch.cat(scores, dim=1))
                         @ p[prefix + "att_vec"]) / t, dim=1)
    out = att[:, 0:1] * hs[0]
    for i in range(1, t):
        out = out + att[:, i:i + 1] * hs[i]
    return (3.0 if t == 3 else 1.0) * out


def forward(p: dict, x: torch.Tensor, x_agg: Optional[torch.Tensor],
            graph: Graph, model: dict, mm: Callable, drop=None):
    """Logits.  ``drop(h, site)`` is the training forward's dropout (None:
    the evaluation forward, which reads the hoisted ``x_agg`` = Â x)."""
    site = [0]

    def dropped(h):
        if drop is None:
            return h
        out = drop(h, site[0])
        site[0] += 1
        return out

    pp = model["model_type"] == "acmgcnpp"
    use_ln = model["use_layernorm"]
    x = dropped(x)
    if pp:
        xx = dropped(torch.relu(mm(x, p["mlpX.lin_0.kernel"])
                                + p["mlpX.lin_0.bias"]))
    f = x.shape[1]
    struc = [None, None]
    if model["structure_info"]:
        struc = [_Raw.apply(p[f"gcn_{i}.struc_low"], graph)
                 for i in range(2)]
    # layer 1
    q = "gcn_0."
    wl, wh, wi = (p[q + f"weight_{nm}"] for nm in CHANNELS[:3])
    hoisted = model["hoist_first"] and (drop is None
                                        or f <= HOIST_MAX_COLS)
    if hoisted:
        y = x_agg if drop is None else low_pass(graph, [x], [False])[0]
        if f > HOIST_MAX_COLS:
            zl, zh = mm(y, wl), mm(x, wh) - mm(y, wh)
        else:
            zl, zh = mm(y, wl), mm(x - y, wh)
    else:
        zl, zh = low_pass(graph, [mm(x, wl), mm(x, wh)], [False, True])
    zs = [zl, zh, mm(x, wi)] + ([struc[0]] if struc[0] is not None else [])
    h1 = dropped(torch.relu(_mix(p, q, zs, use_ln)))
    if pp:
        h1 = h1 + xx
    # layer 2
    q = "gcn_1."
    wl, wh, wi = (p[q + f"weight_{nm}"] for nm in CHANNELS[:3])
    zl, zh = low_pass(graph, [mm(h1, wl), mm(h1, wh)], [False, True])
    zs = [zl, zh, mm(h1, wi)] + ([struc[1]] if struc[1] is not None else [])
    return _mix(p, q, zs, use_ln)


def nll(logits: torch.Tensor, labels: torch.Tensor,
        mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=1)
    picked = logp.gather(1, labels[:, None])[:, 0]
    return -(picked * mask).sum() / mask.sum().clamp_min(1)


def preprocess(features: np.ndarray, model: dict) -> np.ndarray:
    """The published preprocessing: rows divided by their sum (f32 numpy;
    a zero row stays zero), except for ACM-GCN+/++ with the structure
    channel."""
    if model["structure_info"] and model["model_type"] in ("acmgcnp",
                                                            "acmgcnpp"):
        return np.ascontiguousarray(features, np.float32)
    rowsum = features.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(rowsum != 0, 1.0 / rowsum, 0.0)
    return (features * inv).astype(np.float32)


BETAS = (0.9, 0.999)
EPS = 1e-8


def adam(p: dict, g: dict, m: dict, v: dict, t: int, lr: float,
         wd: float):
    """Adam (Kingma and Ba, 2015) with L2 folded into the gradient
    (torch's ``weight_decay``): step ``t`` (1, 2, ...) from ``p`` and the
    moments ``m``, ``v`` after step ``t - 1``.  Returns the new
    parameters, moments and the gradient as Adam took it."""
    b1, b2 = BETAS
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out = ({}, {}, {}, {})
    for n in p:
        gd = g[n] + wd * p[n]
        mn = b1 * m[n] + (1.0 - b1) * gd
        vn = b2 * v[n] + (1.0 - b2) * gd * gd
        step = (mn / c1) / (torch.sqrt(vn / c2) + EPS)
        for d, val in zip(out, (p[n] - lr * step, mn, vn, gd)):
            d[n] = val
    return out


class Trainer:
    """The configuration's training step and evaluation on one split's
    inputs (``x`` preprocessed, ``masks`` = train, validation, test)."""

    def __init__(self, x: torch.Tensor, graph: Graph, labels: torch.Tensor,
                 masks, model: dict, seed: int, lower: Optional[str] = None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.x, self.graph, self.labels = x, graph, labels
        self.model, self.seed = model, seed
        self.mm = make_mm(model["gemm_dtype"], lower)
        self.train_mask, self.val_mask = masks[0].float(), masks[1].float()
        with torch.no_grad():
            self.x_agg = (low_pass(graph, [x], [False])[0]
                          if model["hoist_first"] else None)

    def loss_and_grad(self, p: dict, epoch: int):
        """Epoch ``epoch``'s training loss at ``p`` (its dropout masks) and
        its gradient."""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        rate = self.model["dropout"]

        def drop(h, site):
            return philox.dropout(h, rate, self.seed, epoch, site)

        loss = nll(forward(params, self.x, self.x_agg, self.graph,
                           self.model, self.mm, drop), self.labels,
                   self.train_mask)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    @torch.no_grad()
    def val_loss(self, p: dict) -> float:
        return float(nll(forward(p, self.x, self.x_agg, self.graph,
                                 self.model, self.mm), self.labels,
                         self.val_mask))

    def step(self, p, m, v, t: int):
        """Training step ``t`` (epoch ``t - 1``) from ``p`` and the moments:
        ``(loss, new p, new m, new v, gradient as Adam took it)``."""
        loss, g = self.loss_and_grad(p, t - 1)
        new_p, new_m, new_v, gd = adam(p, g, m, v, t, self.model["lr"],
                                       self.model["weight_decay"])
        return loss, new_p, new_m, new_v, gd


def train(trainer: Trainer, p0: dict, steps: int) -> dict:
    """``steps`` training steps from ``p0`` with fresh moments: the
    trajectory (``params[0..steps]``, moments ``m``/``v`` after each step,
    each step's loss, the validation loss after steps 1 .. steps-1), in
    the form ``follow`` judges."""
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    params, ms, vs, losses, val = [p0], [zeros], [zeros], [], []
    for t in range(1, steps + 1):
        loss, p, m, v, _ = trainer.step(params[-1], ms[-1], vs[-1], t)
        params.append(p), ms.append(m), vs.append(v), losses.append(loss)
        if t < steps:
            val.append(trainer.val_loss(p))
    return dict(params=params, m=ms, v=vs, losses=losses, val_losses=val)


def follow(trainer: Trainer, traj: dict) -> dict:
    """The reference step by step from each state of the trajectory
    ``traj`` (the program's, or a control's): at step t, from
    ``params[t-1]`` and the moments after step t-1, its loss, its gradient
    as Adam takes it and its change, beside the trajectory's own; and the
    validation loss at ``params[t]``.  Each entry: ``(traj's, ref's)``."""
    b1 = BETAS[0]
    out = dict(loss=[], val_loss=[], grad=[], change=[])
    steps = len(traj["losses"])
    for t in range(1, steps + 1):
        p0, p1 = traj["params"][t - 1], traj["params"][t]
        m0, m1 = traj["m"][t - 1], traj["m"][t]
        loss, p_ref, _, _, g_ref = trainer.step(p0, m0, traj["v"][t - 1], t)
        g_traj = {n: (m1[n] - b1 * m0[n]) / (1.0 - b1) for n in p0}
        out["loss"].append((traj["losses"][t - 1], loss))
        out["grad"].append((_norms(g_traj), _norms(g_ref)))
        out["change"].append((_norms({n: p1[n] - p0[n] for n in p0}),
                              _norms({n: p_ref[n] - p0[n] for n in p0})))
        if t < steps:
            out["val_loss"].append((traj["val_losses"][t - 1],
                                    trainer.val_loss(p1)))
    return out


def _norms(tensors: dict) -> dict:
    return {k: float(t.detach().double().norm()) for k, t in tensors.items()}
