"""The bf16 channel projections that share one rounding of their operand
(``models/layers.py`` ``bf16_project``) against one rounding a projection.

Every operand that feeds several bf16 projections is rounded to bf16 once
a forward, and its saved copy widened once a backward; the arithmetic is
the same, so every number must equal, bit for bit, what a forward gives in
which each projection rounds its operand itself (``_OneRounding``, the
one-weight Function the port used before).  Held here: acmgcnpp with the
structure channel, the input hoist at F above ``HOIST_MAX_COLS`` (and
below it), dropout and the paired eval branch, ``mlpX`` at one and two
Linears; acmsgc; an operand that carries a gradient; and the counters
``proj.roundings`` / ``proj.projections``.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models import layers
from acmgnn_tpu_torch.models.layers import HOIST_MAX_COLS, bf16_project
from acmgnn_tpu_torch.ops.dropout import Dropout, DropoutKey
from acmgnn_tpu_torch.ops.graph import GraphData
from acmgnn_tpu_torch.ops.spmm import row_shard
from acmgnn_tpu_torch.train import trainer
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.utils import profiling

N, F_WIDE, F_NARROW = 300, 160, 40
PP = dict(model_type="acmgcnpp", hidden=8, dropout=0.5, lr=0.01,
          weight_decay=1e-3, operator_format="ell", gemm_dtype="bfloat16",
          joint=True, hoist_first=True, structure_info=True, seed=3)
CASES = {
    "pp_paired": (dict(PP), F_WIDE, True),
    "pp_train_only": (dict(PP), F_WIDE, False),
    "pp_mlpx2_paired": (dict(PP, init_layers_X=2), F_WIDE, True),
    "pp_narrow_paired": (dict(PP), F_NARROW, True),
    "pp_layernorm_paired": (dict(PP, use_layernorm=True), F_WIDE, True),
    "acmsgc": (dict(PP, model_type="acmsgc", structure_info=False), F_WIDE,
               False),
}


class _OneRounding(torch.autograd.Function):
    """One bf16 projection with its own rounding of its operand, its own
    saved copy and its own widening: the port's projection before
    ``bf16_project``."""

    @staticmethod
    def forward(ctx, a, w):
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(ab, wb)
        ctx.dtypes = (a.dtype, w.dtype)
        return layers._mm_f32_out(ab, wb)

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = (g @ wb.float().T).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = (ab.float().T @ g).to(torch.bfloat16).to(ctx.dtypes[1])
        return da, dw


def _one_rounding_each(model):
    """``model`` with every projection rounding its own operand."""
    for mod in model.modules():
        if hasattr(mod, "mm"):
            mod.mm = _OneRounding.apply
        if hasattr(mod, "project"):
            mod.project = lambda a, *ws: tuple(_OneRounding.apply(a, w)
                                               for w in ws)
    return model


def _reference_forward(model, x, ops, key, paired):
    """The train forward with ``mlpX`` called on its own, before layer 1
    (acmgcnpp's forward before layer 1 took ``mlpX.lin_0``), on a model
    of ``_one_rounding_each``."""
    if model.model_type != "acmgcnpp":
        return trainer.train_forward(model, x, ops, key, paired_eval=paired)
    drop = Dropout(model.dropout, True, key)
    x_eval, x = x, drop(x)
    xx = drop(torch.relu(model.mlpX(x, True, drop, row_shard(ops.adj_low))))
    if not paired:
        fea1 = drop(torch.relu(model.gcn_0(x, ops))) + xx
        return model.gcn_1(fea1, ops)
    xx_eval = torch.relu(model.mlpX(x_eval, False)).detach()
    fea1, fea1_eval = model.gcn_0(x, ops, x_eval=x_eval,
                                  x_eval_agg=ops.x_agg)
    fea1 = drop(torch.relu(fea1)) + xx
    return model.gcn_1(fea1, ops, x_eval=torch.relu(fea1_eval) + xx_eval)


def _setup(cfg_kw, f):
    adj, _, labels = twitch_gamers_scale_graph(0, n=N, pairs=3000)
    feats = np.random.default_rng(5).normal(size=(N, f)).astype(np.float32)
    cfg = TrainConfig(**cfg_kw)
    _, ops, x, _, _, nclass = trainer.prepare_data(
        GraphData(name="proj", adj=adj, features=feats, labels=labels), cfg,
        device="cpu")
    model = trainer.build_model(cfg, x.shape[1], nclass, device="cpu",
                                seed=0, nnodes=x.shape[0])
    key = DropoutKey.new(11, 0, torch.tensor(2, dtype=torch.int64))
    return model, ops, x, key


def _run(model, forward, x, ops, key, paired):
    """Logits (train, and eval when paired), a backward of a seeded
    weighting of the train logits, and every gradient and buffer."""
    out = forward(model, x, ops, key, paired)
    logits = out[0] if paired else out
    g = torch.randn(logits.shape, generator=torch.Generator().manual_seed(1))
    (logits * g).sum().backward()
    got = {"logits": logits.detach()}
    if paired:
        got["eval"] = out[1].detach()
    got.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    got.update({f"buffer {n}": b for n, b in model.named_buffers()})
    return got


@pytest.mark.parametrize("case", CASES)
def test_shared_rounding_is_bit_equal_to_one_rounding_a_projection(case):
    cfg_kw, f, paired = CASES[case]
    model, ops, x, key = _setup(cfg_kw, f)
    assert (f > HOIST_MAX_COLS) == (f == F_WIDE)
    reference = _one_rounding_each(copy.deepcopy(model))
    got = _run(model, lambda m, *a: trainer.train_forward(
        m, *a[:3], paired_eval=a[3]), x, ops, key, paired)
    want = _run(reference, _reference_forward, x, ops, key, paired)
    assert got.keys() == want.keys()
    for name in want:
        assert (got[name] is None) == (want[name] is None), name
        if want[name] is not None:
            assert torch.equal(got[name], want[name]), name
    assert all(want[f"grad {n}"] is not None
               for n, _ in model.named_parameters()
               if n.startswith(("gcn_0.weight", "mlpX.lin_0.kernel")))


@pytest.mark.parametrize("used", ("all", "first"))
@pytest.mark.parametrize("operand_grad", (True, False))
def test_projection_gradients_equal_separate_products(operand_grad, used):
    """With ``operand_grad`` ``a`` needs a gradient (layer 2's input): it
    keeps a rounding a weight, so its gradient sums one term a weight, as
    separate products sum it.  An output that takes no gradient leaves its
    weight's gradient None, as a separate product does."""
    rng = np.random.default_rng(4)
    a0 = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    w0 = [torch.from_numpy(rng.normal(size=(24, 6)).astype(np.float32))
          for _ in range(3)]
    gs = [torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
          for _ in range(3)]
    res = []
    for project in (bf16_project,
                    lambda a, *ws: tuple(_OneRounding.apply(a, w)
                                         for w in ws)):
        a = a0.clone().requires_grad_(operand_grad)
        ws = [w.clone().requires_grad_() for w in w0]
        outs = project(a, *ws)
        n = len(outs) if used == "all" else 1
        torch.autograd.backward(outs[:n], gs[:n])
        res.append([*(o.detach() for o in outs), a.grad,
                    *(w.grad for w in ws)])
    for got, want in zip(*res):
        assert (got is None) == (want is None)
        if want is not None:
            assert torch.equal(got, want)
    assert (res[0][-1] is None) == (used == "first")


def _layer1_and_forward_counts(model, x, ops, key):
    """``proj.*`` counts at layer 2's start and at the forward's end."""
    seen = {}

    def at_layer2(*_):
        seen.setdefault("layer1", dict(profiling.counts))

    hook = model.gcn_1.register_forward_pre_hook(at_layer2)
    profiling.reset_spans()
    profiling.enable_spans()
    try:
        trainer.train_forward(model, x, ops, key, paired_eval=True)
    finally:
        profiling.disable_spans()
        hook.remove()
    seen["forward"] = dict(profiling.counts)
    profiling.reset_spans()
    return {k: (c.get("proj.roundings", 0), c.get("proj.projections", 0))
            for k, c in seen.items()}


@pytest.mark.parametrize("gemm_dtype", ("bfloat16", "float32"))
def test_projection_counters(gemm_dtype):
    """acmgcnpp's paired training forward at F above ``HOIST_MAX_COLS``:
    layer 1 rounds dropout(x) for its three channels and ``mlpX.lin_0``,
    raw x for the eval branch's high and mlp channels and ``lin_0``, and
    ``x_agg`` for the eval branch's low and high: 3 roundings, 9
    projections.  Layer 2 rounds its train input once a weight (it needs
    a gradient) and its eval input once: 4 more, 6 more.  f32 GEMMs count
    nothing; spans off count nothing."""
    model, ops, x, key = _setup(dict(PP, gemm_dtype=gemm_dtype), F_WIDE)
    counts = _layer1_and_forward_counts(model, x, ops, key)
    if gemm_dtype == "float32":
        assert counts == {"layer1": (0, 0), "forward": (0, 0)}
    else:
        assert counts == {"layer1": (3, 9), "forward": (7, 15)}
    trainer.train_forward(model, x, ops, key, paired_eval=True)
    assert not profiling.counts
