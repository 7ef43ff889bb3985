"""The port's ACM layer and model against acmgnn_tpu's flax modules.

The same numpy inputs and the same flax parameters (copied over with
``params_from_flax``) go through both; outputs and ``jax.grad`` gradients
are compared.  Tolerance: ``1e-5·sqrt(reduction length)``, relative and
absolute (tests/test_torch_oracle_parity.py's scale): the longest f32
reduction is over the graph's nodes for parameter gradients, over the
input width or a row's degree otherwise.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from acmgnn_tpu.models.layers import ACMConv as JaxACMConv
from acmgnn_tpu.models.models import ACMGNN as JaxACMGNN
from acmgnn_tpu.ops.graph import precompute_operators as jax_precompute
from acmgnn_tpu.ops.spmm import spmm as jax_spmm
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.models.layers import (
    ATTN_INSTANCES,
    ACMConv,
    attention_mix_backward_plain,
    attention_mix_forward_plain,
)
from acmgnn_tpu_torch.models.models import ACMGNN
from acmgnn_tpu_torch.ops.graph import precompute_operators
from acmgnn_tpu_torch.ops.spmm import spmm


def assert_close(ours, theirs, n_terms, msg=""):
    tol = 1e-5 * max(1.0, float(n_terms) ** 0.5)
    np.testing.assert_allclose(
        ours.detach().cpu().numpy(), np.asarray(theirs, np.float32),
        rtol=tol, atol=tol, err_msg=msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _randomize_layernorms(params, rng):
    """Non-trivial LN scale/bias so the LayerNorm path is really tested."""
    params = jax.tree_util.tree_map(np.asarray, params)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict) and {"scale", "bias"} <= set(val):
                val["scale"] = rng.uniform(0.5, 1.5, val["scale"].shape) \
                    .astype(np.float32)
                val["bias"] = (rng.normal(size=val["bias"].shape) * 0.1) \
                    .astype(np.float32)
            elif isinstance(val, dict):
                walk(val)

    walk(params)
    return params


@pytest.fixture(scope="module")
def both_ops(small_graph):
    adj, feats, _ = small_graph
    x = np.random.default_rng(0).normal(size=(adj.shape[0], 12)) \
        .astype(np.float32)
    jops = jax_precompute(adj, fmt="ell")
    ops = precompute_operators(adj, fmt="ell")
    jops = jops.replace(x_agg=jax_spmm(jops.adj_low, jnp.asarray(x)))
    ops.x_agg = spmm(ops.adj_low, torch.from_numpy(x))
    return jops, ops, x


MODES = ("proj", "proj_paired", "hoist_gather", "hoist_agg", "hoist_paired")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model_type", ("acmgcn", "acmgcnp"))
def test_acmconv_matches_flax(model_type, mode, both_ops):
    jops, ops, x = both_ops
    n, f_in = x.shape
    f_out = 8
    rng = np.random.default_rng(1)
    hoist = mode.startswith("hoist")
    x_eval = None
    if mode == "proj_paired":
        x_eval = rng.normal(size=x.shape).astype(np.float32)
    elif mode == "hoist_paired":
        x_eval = x
    use_agg = mode == "hoist_agg"
    use_ln = model_type == "acmgcnp"
    jconv = JaxACMConv(f_out, model_type=model_type, use_layernorm=use_ln,
                       input_hoist=hoist)

    def jkw():
        kw = {}
        if x_eval is not None:
            kw["x_eval"] = jnp.asarray(x_eval)
            if mode == "hoist_paired":
                kw["x_eval_agg"] = jops.x_agg
        if use_agg:
            kw["x_agg"] = jops.x_agg
        return kw

    params = jconv.init(jax.random.key(0), jnp.asarray(x), jops,
                        **jkw())["params"]
    params = _randomize_layernorms(params, rng)
    conv = ACMConv(f_in, f_out, model_type=model_type, use_layernorm=use_ln,
                   input_hoist=hoist)
    conv.load_state_dict(params_from_flax(params))

    g = rng.normal(size=(n, f_out)).astype(np.float32)

    def jloss(p, xx):
        out = jconv.apply({"params": p}, xx, jops, **jkw())
        train = out[0] if x_eval is not None else out
        return jnp.sum(train * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_(True)
    kw = {}
    if x_eval is not None:
        kw["x_eval"] = torch.from_numpy(x_eval)
        if mode == "hoist_paired":
            kw["x_eval_agg"] = ops.x_agg
    if use_agg:
        kw["x_agg"] = ops.x_agg
    out = conv(tx, ops, **kw)
    train = out[0] if x_eval is not None else out
    (train * torch.from_numpy(g)).sum().backward()

    if x_eval is not None:
        assert_close(out[0], jout[0], f_in, "train out")
        assert_close(out[1], jout[1], f_in, "eval out")
    else:
        assert_close(out, jout, f_in, "out")
    assert_close(tx.grad, jgx, n, "d x")
    grads = dict(conv.named_parameters())
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jgp))
    assert set(jflat) == set(grads)
    for name, jg in jflat.items():
        assert_close(grads[name].grad, jg, n, f"d {name}")


@pytest.mark.parametrize("hoist", (False, True))
@pytest.mark.parametrize("model_type", ("acmgcn", "acmgcnp"))
def test_acmgnn_logits_match_flax(model_type, hoist, both_ops):
    """Eval-mode logits, and the paired (train, eval) logits at dropout 0."""
    jops, ops, x = both_ops
    n, f_in = x.shape
    use_ln = model_type == "acmgcnp"
    rng = np.random.default_rng(2)
    for dropout, paired in ((0.5, False), (0.0, True)):
        jmodel = JaxACMGNN(nhid=16, nclass=4, model_type=model_type,
                           dropout=dropout, use_layernorm=use_ln,
                           hoist_first=hoist)
        params = jmodel.init(jax.random.key(1), jnp.asarray(x), jops)
        params = _randomize_layernorms(params["params"], rng)
        model = ACMGNN(f_in, 16, 4, model_type=model_type, dropout=dropout,
                       use_layernorm=use_ln, hoist_first=hoist)
        model.load_state_dict(params_from_flax(params))
        jout = jmodel.apply({"params": jax.tree_util.tree_map(
            jnp.asarray, params)}, jnp.asarray(x), jops, training=paired,
            paired_eval=paired)
        with torch.no_grad():
            out = model(torch.from_numpy(x), ops, training=paired,
                        paired_eval=paired)
        if paired:
            assert_close(out[0], jout[0], f_in, "paired train logits")
            assert_close(out[1], jout[1], f_in, "paired eval logits")
        else:
            assert_close(out, jout, f_in, "eval logits")


def _attention_inputs(n, d, seed):
    """Channels before the ReLU: negative entries, exact zeros and rows
    with no positive entry (var == 0 after the ReLU)."""
    rng = np.random.default_rng(seed)
    zs = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]
    zs[2][:3] = -np.abs(zs[2][:3])      # all non-positive rows
    zs[1][3:5] = 0.0                    # all-zero rows
    zs[0][::7, 0] = 0.0                 # exact zeros: the ReLU's tie
    v = rng.normal(size=(3, d)).astype(np.float32)
    c = rng.normal(size=3).astype(np.float32)
    W = rng.uniform(-1, 1, size=(3, 3)).astype(np.float32)
    gout = rng.normal(size=(n, d)).astype(np.float32)
    return [torch.from_numpy(t) for t in (*zs, v, c, W, gout)]


@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 7, 64))
def test_attention_backward_plain_matches_autograd(d, use_ln):
    """K3's plain version (the kernel's formulas, the ReLU's gradient and
    the row sums of the parameter gradients included) against autograd of
    K2's plain version on channels before the ReLU."""
    z0, z1, z2, v, c, W, gout = _attention_inputs(300, d, seed=d)
    leaves = [t.clone().requires_grad_(True) for t in (z0, z1, z2, v, c, W)]
    attention_mix_forward_plain(leaves[:3], *leaves[3:], use_ln,
                                3.0).backward(gout)
    dz0, dz1, dz2, dv, dc, dW = attention_mix_backward_plain(
        (z0, z1, z2), gout, v, c, W, use_ln, 3.0)
    n_terms = 300
    for i, dz in enumerate((dz0, dz1, dz2)):
        assert_close(dz, leaves[i].grad.numpy(), d, f"dz{i}")
    assert_close(dv, leaves[3].grad.numpy(), n_terms, "dv")
    if use_ln:
        assert_close(dc, leaves[4].grad.numpy(), n_terms, "dc")
    else:                               # c is not used without LayerNorm
        assert leaves[4].grad is None and not dc.any()
    assert_close(dW, leaves[5].grad.numpy(), n_terms, "dW")


@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("relu", ATTN_INSTANCES)
def test_attention_backward_plain_matches_autograd_at_every_instance(
        relu, use_ln):
    """The same at every (channels, ReLU mask) instance of K2/K3: four
    channels with the scale 1 (the structure channel), the masks of
    variant 1 and of acmsgc (no ReLU), on channels whose negative entries
    then reach the attention."""
    t, d = len(relu), 7
    z0, z1, z2, v, c, W, gout = _attention_inputs(300, d, seed=t)
    zs = [z0, z1, z2, z0.flip(0) - 0.3][:t]
    rng = np.random.default_rng(t)
    v = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=t).astype(np.float32))
    W = torch.from_numpy(rng.uniform(-1, 1, (t, t)).astype(np.float32))
    scale = 1.0 if t == 4 else 3.0
    leaves = [a.clone().requires_grad_(True) for a in (*zs, v, c, W)]
    attention_mix_forward_plain(leaves[:t], *leaves[t:], use_ln, scale,
                                relu).backward(gout)
    *dzs, dv, dc, dW = attention_mix_backward_plain(
        zs, gout, v, c, W, use_ln, scale, relu)
    for i, dz in enumerate(dzs):
        assert_close(dz, leaves[i].grad.numpy(), d, f"dz{i}")
    assert_close(dv, leaves[t].grad.numpy(), 300, "dv")
    if use_ln:
        assert_close(dc, leaves[t + 1].grad.numpy(), 300, "dc")
    else:
        assert leaves[t + 1].grad is None and not dc.any()
    assert_close(dW, leaves[t + 2].grad.numpy(), 300, "dW")


@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 7, 64))
def test_fused_attention_plain_matches_jax(d, use_ln):
    """The fused plain forward and backward against the JAX package:
    ``jax.nn.relu``, then flax's own ``ACMConv._attention`` (its
    parameters passed in: ``ln_mods`` and ``att_params``), then the mix of
    ``ACMConv.__call__``; gradients from ``jax.vjp``.  The same parameter
    tree is copied into the port with ``params_from_flax``; the port's
    ``dv``, ``dc`` and ``dW`` reach it through ``ACMConv._branch_params``.

    Both sides run in f64 (f32-valued inputs and parameters): this holds
    the algorithm, and in f32 the rows that the ReLU leaves near-constant
    are ill-conditioned, where JAX's uncentred score ``h·v − μΣv``
    cancels and the port's centred one does not (ROADMAP §C)."""
    n = 300
    z0, z1, z2, *_, gout = (t.double() for t in _attention_inputs(
        n, d, seed=100 + d))
    rng = np.random.default_rng(d)
    names = ("low", "high", "mlp")
    params = {f"att_vec_{nm}": rng.uniform(-1, 1, (d, 1)) for nm in names}
    params["att_vec"] = rng.uniform(-1, 1, (3, 3)) / np.sqrt(3)
    if use_ln:
        for nm in names:
            params[f"layer_norm_{nm}"] = {"scale": np.ones(d),
                                          "bias": np.zeros(d)}
        params = _randomize_layernorms(params, rng)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    model_type = "acmgcnp" if use_ln else "acmgcn"
    jconv = JaxACMConv(d, model_type=model_type, use_layernorm=use_ln)

    def mix(zs, p):
        hs = [jax.nn.relu(z) for z in zs]
        ln_mods = ([(p[f"layer_norm_{nm}"]["scale"],
                     p[f"layer_norm_{nm}"]["bias"]) for nm in names]
                   if use_ln else None)
        att_params = ([p[f"att_vec_{nm}"] for nm in names], p["att_vec"])
        att = jconv.apply({}, hs, ln_mods, att_params,
                          method=JaxACMConv._attention)
        return 3.0 * (att[:, 0:1] * hs[0] + att[:, 1:2] * hs[1]
                      + att[:, 2:3] * hs[2])

    with jax.enable_x64(True):
        jout, vjp = jax.vjp(
            mix, [jnp.asarray(z.numpy()) for z in (z0, z1, z2)],
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   params))
        jdz, jdp = vjp(jnp.asarray(gout.numpy()))

    conv = ACMConv(1, d, model_type=model_type, use_layernorm=use_ln)
    state = params_from_flax(params)
    conv.load_state_dict(state, strict=False)
    v, c, W = conv._branch_params(detach=False)
    v, c, W = v.double(), c.double(), W.double()
    out = attention_mix_forward_plain((z0, z1, z2), v, c, W, use_ln, 3.0)
    dz0, dz1, dz2, dv, dc, dW = attention_mix_backward_plain(
        (z0, z1, z2), gout, v.detach(), c.detach(), W.detach(), use_ln,
        3.0)
    assert_close(out, jout, d, "out")
    for i, dz in enumerate((dz0, dz1, dz2)):
        assert_close(dz, jdz[i], d, f"dz{i}")
    outs, cots = ([v, c, W], [dv, dc, dW]) if use_ln else ([v, W], [dv, dW])
    grads = torch.autograd.grad(outs, [conv.get_parameter(k) for k in state],
                                cots)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jdp))
    assert set(jflat) == set(state)
    for name, g in zip(state, grads):
        assert_close(g, jflat[name], n, f"d {name}")
