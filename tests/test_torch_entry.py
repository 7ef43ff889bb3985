"""The port's driver entry points (``acmgnn_tpu_torch/entry.py``) against
``__graft_entry__.py``'s, on the CPU.

- ``entry()``: the same graph, drawn by the same generator, and the
  forward of JAX's ``entry()`` variables carried across by
  ``params_from_flax``: with f32 gathers within ``1e-5·sqrt(reduction
  length)``, and as run (bf16 gathers) within the bf16 bound stated at
  ``BF16_TOL``.
- ``dryrun(n)`` at 1, 2 and 4 gloo ranks (spawned processes), dropout 0,
  f32 gathers: the explicit step's loss and updated parameters equal the
  port's single-card step (``dryrun_step`` on the whole graph) within
  1e-5, and a JAX single-device step of the same model, graph and
  parameters (optax Adam 1e-2) within ``1e-5·sqrt(reduction length)``;
  the mini-split's results are finite.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import pytest

import __graft_entry__ as graft
import jax
import jax.numpy as jnp
import optax
import torch

from acmgnn_tpu.models.models import ACMGNN as JaxACMGNN
from acmgnn_tpu.ops.graph import precompute_operators as jax_precompute
from acmgnn_tpu.train.metrics import masked_nll as jax_masked_nll
from acmgnn_tpu_torch import entry as port_entry
from acmgnn_tpu_torch.models.convert import params_from_flax
from acmgnn_tpu_torch.ops.graph import precompute_operators

RANKS = (1, 2, 4)
# bf16 gathers: each gather's operand, an f32 projection, is rounded to
# bf16 first, and two f32 GEMMs an ulp apart can round to neighbouring
# bf16 values, which moves that term by one bf16 ulp (2^-8 of it).  The
# forward as run is held to one bf16 ulp of the logits' scale (it reads
# ~8e-7 of it on this graph, where no rounding flips).
BF16_TOL = 2.0 ** -8


def _close(got, want, n_terms, what):
    """``|got - want| <= 1e-5·sqrt(n_terms)·max(1, |want|)`` elementwise
    (the repo's f32 bound for another summation order)."""
    tol = 1e-5 * max(1.0, n_terms ** 0.5)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def test_generators_equal_graft_entry():
    """``synthetic_graph`` draws JAX's ``_synthetic_graph`` bit for bit."""
    for args in ((4096, 16, 128, 8), (256, 8, 32, 4)):
        ours, theirs = port_entry.synthetic_graph(*args), \
            graft._synthetic_graph(*args)
        assert (ours[0] != theirs[0]).nnz == 0
        assert ours[0].dtype == theirs[0].dtype
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_points_need_the_card_unless_asked():
    """Without a card, asking for the default device raises; the CPU must
    be asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.dryrun(1)


@pytest.fixture(scope="module")
def jax_entry():
    fn, (variables, x, ops) = graft.entry()
    return fn, variables, x, ops


def _port_forward(variables, f32_gathers=False):
    """The port's ``entry()`` forward on the CPU from JAX's variables; with
    ``f32_gathers``, on an f32 operator of the same graph."""
    fn, (model, x, ops) = port_entry.entry("cpu")
    model.load_state_dict(params_from_flax(jax.device_get(variables)))
    if f32_gathers:
        ops = precompute_operators(
            port_entry.synthetic_graph(4096, 16, 128, 8)[0], fmt="ell")
    with torch.no_grad():
        return fn(model, x, ops).numpy()


def test_entry_forward_f32_matches_jax(jax_entry):
    """f32 gathers on both sides: within 1e-5·sqrt(128) (the longest
    reduction: the 128 features of layer 1's projection)."""
    fn, variables, x, _ = jax_entry
    adj = graft._synthetic_graph(4096, 16, 128, 8)[0]
    ops = jax_precompute(adj, fmt="ell", spmm_dtype=jnp.float32)
    want = np.asarray(fn(variables, x, ops))
    got = _port_forward(variables, f32_gathers=True)
    assert got.shape == want.shape == (4096, 8)
    _close(got, want, 128, "entry forward, f32 gathers")


def test_entry_forward_as_run_matches_jax(jax_entry):
    """JAX's ``entry()`` as it runs (bf16 gathers) against the port's
    (bf16 gathers) within ``BF16_TOL`` of the logits' scale."""
    fn, variables, x, ops = jax_entry
    want = np.asarray(fn(variables, x, ops))
    got = _port_forward(variables)
    assert np.all(np.isfinite(got))
    err = float(np.abs(got - want).max())
    assert err <= BF16_TOL * max(1.0, float(np.abs(want).max())), err


def _jax_init(n):
    """JAX's dryrun model for n ranks' graph (its structure embedding has
    the graph's N rows), its single-device operators and inputs, and its
    initial variables."""
    adj, features, labels = graft._synthetic_graph(64 * n, 8, 32, 4)
    ops = jax_precompute(adj, structure_info=True, fmt="ell")
    x, y = jnp.asarray(features), jnp.asarray(labels)
    model = JaxACMGNN(nhid=16, nclass=4, model_type="acmgcnp",
                      structure_info=True, nnodes=64 * n, dropout=0.0)
    return model, ops, x, y, model.init(jax.random.key(0), x, ops)


def _jax_step(model, ops, x, y, variables):
    """``train_step`` of ``__graft_entry__.py:108-123`` on one device:
    (loss, updated parameters as a ``state_dict``)."""
    tx = optax.adam(1e-2)
    mask = jnp.ones(x.shape[0], bool)

    @jax.jit
    def step(p):
        def loss_fn(q):
            logits = model.apply({"params": q}, x, ops, training=True,
                                 rngs={"dropout": jax.random.key(1)})
            return jax_masked_nll(jax.nn.log_softmax(logits, axis=1), y,
                                  mask)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    loss, new = step(variables["params"])
    return float(loss), params_from_flax(jax.device_get(new))


@pytest.fixture(scope="module")
def runs():
    """Per world size n: the initial ``state_dict`` (JAX's variables),
    JAX's single-device step (loss, parameters) and ``dryrun(n)`` on the
    CPU at dropout 0 from those variables.  The dryruns' ranks run while
    JAX computes its steps."""
    inits = {n: _jax_init(n) for n in RANKS}
    start = {n: params_from_flax(jax.device_get(inits[n][-1]))
             for n in RANKS}
    with concurrent.futures.ThreadPoolExecutor(len(RANKS)) as pool:
        futures = {n: pool.submit(port_entry.dryrun, n, "cpu", dropout=0.0,
                                  init_params=start[n]) for n in RANKS}
        steps = {n: _jax_step(*inits[n]) for n in RANKS}
        return {n: (start[n], *steps[n], futures[n].result())
                for n in RANKS}


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_step_equals_single_card(n, runs):
    """The sharded step over n gloo ranks equals ``dryrun_step`` on the
    whole graph on one card within 1e-5 (loss and every parameter)."""
    init, _, _, got = runs[n]
    adj, features, labels = port_entry.dryrun_graph(n)
    ops = precompute_operators(adj, structure_info=True, fmt="ell")
    model = port_entry.dryrun_model(64 * n, 0.0, "cpu", init)
    loss = port_entry.dryrun_step(
        model, ops, torch.from_numpy(features),
        torch.from_numpy(labels.astype(np.int64)),
        torch.ones(64 * n, dtype=torch.bool))
    assert got["world_size"] == n and got["backend"] == "gloo"
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, atol=1e-5)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   p.detach().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_step_equals_jax_single_device(n, runs):
    """The sharded step equals JAX's single-device ``train_step`` within
    1e-5·sqrt(N): the longest reduction is a weight gradient's sum over
    the N rows."""
    _, loss, want, got = runs[n]
    _close(got["loss"], loss, 64 * n, "loss")
    assert set(got["params"]) == set(want)
    for name, p in want.items():
        _close(got["params"][name].numpy(), p.numpy(), 64 * n, name)


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_mini_split_is_finite(n, runs):
    """``run_experiment_sharded`` on the mini-split (acmgcnp, 3 epochs,
    joint, hoist, bf16 gathers, halo) ends with finite results."""
    out = runs[n][3]["mini_split"]
    assert out["devices"] == n and out["epochs_total"] == 3
    assert np.all(np.isfinite(out["per_split"] + [out["test_mean"]])), out
