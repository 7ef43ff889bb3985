"""The port's panel gather (K7's plain version) and its probe against the
TPU probe's Pallas kernels (``tools/pallas_gather_probe.py``).

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own Pallas tests do: the probe module is loaded by path (``tools/`` is not
a package) with its ``pl.pallas_call`` replaced by an interpreting one and
its row count ``M`` cut to ``M_TEST``.  A gather is exact, so the plain
version must equal ``jnp.take_along_axis`` element for element.  The
probe functions return a column sum over the M gathered rows, which the
two frameworks add in other orders: f32 sums agree within
``1e-5·sqrt(M)·max(1, Σ|terms|)`` per column; the TPU probe's bf16
configuration sums its bf16 output into a bf16 result, so there one bf16
rounding of the sum, ``2^-8·|sum|``, is added to that bound.
"""

from __future__ import annotations

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import jax.experimental.pallas as jax_pallas
import torch

from acmgnn_tpu_torch.ops.panel_gather import (
    SMEM_BYTES,
    panel_gather,
    panel_gather_plain,
    panel_plan,
)
from acmgnn_tpu_torch.tools import gather_probe

PROBE = Path(__file__).resolve().parent.parent / "tools" / \
    "pallas_gather_probe.py"
M_TEST = 4096          # a multiple of every probe panel (P = 8, 512, 4096)
D = gather_probe.D


@pytest.fixture(scope="module")
def probe():
    """The TPU probe module, its Pallas calls interpreted on the CPU."""
    spec = importlib.util.spec_from_file_location("pallas_gather_probe",
                                                  PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        **{k: getattr(jax_pallas, k) for k in dir(jax_pallas)
           if not k.startswith("__")})
    mod.pl.pallas_call = functools.partial(jax_pallas.pallas_call,
                                           interpret=True)
    mod.M = M_TEST
    return mod


def _indices(kind: str, m: int, p: int, d: int, rng):
    """Row indices broadcast across the row (the probe's P1 input), indices
    that differ across a row (take_along_axis in general), or one per row
    (P2)."""
    if kind == "row_broadcast":
        return np.ascontiguousarray(np.broadcast_to(
            rng.integers(0, p, size=(m, 1), dtype=np.int32), (m, d)))
    if kind == "per_element":
        return rng.integers(0, p, size=(m, d), dtype=np.int32)
    return rng.integers(0, p, size=(m,), dtype=np.int32)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("row_broadcast", "per_element", "per_row"))
def test_plain_equals_take_along_axis(dtype, kind):
    """``panel_gather_plain`` (and the wrapper on CPU tensors) equal the
    Pallas kernel body's ``jnp.take_along_axis(x, idx, axis=0)`` exactly;
    a per-row index is broadcast across the row first, as in P2."""
    rng = np.random.default_rng(1)
    p, m, d = 37, 300, 12
    x32 = rng.standard_normal((p, d), dtype=np.float32)
    idx = _indices(kind, m, p, d, rng)
    jx = jnp.asarray(x32).astype(dtype)
    jidx = jnp.broadcast_to(jnp.asarray(idx)[:, None], (m, d)) \
        if idx.ndim == 1 else jnp.asarray(idx)
    want = np.asarray(jnp.take_along_axis(jx, jidx, axis=0).astype(
        jnp.float32))
    tx = torch.from_numpy(x32).to(getattr(torch, dtype))
    for fn in (panel_gather_plain, panel_gather):
        got = fn(tx, torch.from_numpy(idx))
        assert got.dtype == tx.dtype and got.shape == (m, d)
        np.testing.assert_array_equal(got.float().numpy(), want)


def _column_sum_close(got, want, terms, extra_rel=0.0):
    """Per column: |got - want| <= 1e-5·sqrt(M)·max(1, Σ|terms|)
    + extra_rel·|want|."""
    absum = np.abs(terms).sum(axis=0)
    tol = 1e-5 * terms.shape[0] ** 0.5 * np.maximum(1.0, absum) \
        + extra_rel * np.abs(want)
    err = np.abs(got - want)
    assert np.all(err <= tol), float((err / tol).max())


@pytest.fixture(scope="module")
def port_configs():
    return gather_probe.configs("cpu", m=M_TEST)


@pytest.mark.parametrize("case", range(1, 7))
def test_probe_matches_pallas_interpret(probe, port_configs, case):
    """Each of the six panel configurations of the port's probe (entries
    1-6 of ``gather_probe.configs``; 0 is the HBM yardstick), K7's plain
    version on the CPU, against the TPU probe's Pallas function on the
    same panel and indices: the same per-call f32 column sum (the TPU
    probe's salt is 0 here; the port has none)."""
    name, fn, x, idx = port_configs[case]
    p = x.shape[0]
    got = fn(x, idx)
    assert got.shape == (1, D) and got.dtype == torch.float32
    is_bf16 = x.dtype == torch.bfloat16
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if is_bf16 else jnp.float32)
    if idx.dim() == 2:
        assert "bcast" not in name
        jfn = probe.make_vmem_gather(p, jx.dtype)
        jidx = jnp.asarray(idx.numpy())
    else:
        assert "bcast" in name
        jfn = probe.make_vmem_gather_bcast(p, jx.dtype)
        jidx = jnp.asarray(idx.numpy()[:, None])
    want = np.asarray(jfn(jx, jidx, jnp.float32(0.0)))
    terms = panel_gather_plain(x, idx).float().numpy()
    _column_sum_close(got.numpy()[0], want[0], terms,
                      extra_rel=2.0 ** -8 if is_bf16 else 0.0)


def test_probe_p1_with_indices_that_differ_across_a_row(probe):
    """P1 is take_along_axis: its Pallas function and the port's agree on
    per-element indices too, not only on the probe's row broadcast."""
    rng = np.random.default_rng(3)
    p = 512
    x = rng.standard_normal((p, D), dtype=np.float32)
    idx = _indices("per_element", M_TEST, p, D, rng)
    want = np.asarray(probe.make_vmem_gather(p, jnp.float32)(
        jnp.asarray(x), jnp.asarray(idx), jnp.float32(0.0)))
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    got = gather_probe.make_panel_gather(M_TEST)(tx, tidx)
    _column_sum_close(got.numpy()[0], want[0],
                      panel_gather_plain(tx, tidx).numpy())


def test_probe_configurations_are_the_tpu_probes(port_configs):
    """The HBM yardstick and the six panel configurations of the TPU
    probe, in its order, with its shapes and dtypes."""
    rows = port_configs
    shapes = [(tuple(x.shape), x.dtype, tuple(i.shape), i.dtype)
              for _, _, x, i in rows]
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    assert shapes == [
        ((gather_probe.HBM_ROWS, D), f32, (M_TEST,), i32),
        ((8, D), f32, (M_TEST, D), i32),
        ((512, D), f32, (M_TEST, D), i32),
        ((4096, D), f32, (M_TEST, D), i32),
        ((512, D), f32, (M_TEST,), i32),
        ((4096, D), f32, (M_TEST,), i32),
        ((4096, D), bf16, (M_TEST,), i32),
    ]
    # the P1 inputs broadcast one row index across the row, as the probe's
    for _, _, x, idx in rows[1:4]:
        assert torch.equal(idx, idx[:, :1].expand_as(idx))


# the probe's six panel configurations: (P, element bytes, per-row
# indices) and K7's plan for each
PROBE_PLANS = [
    ((8, 4, False), "block"),
    ((512, 4, False), "l2"),
    ((4096, 4, False), "l2"),
    ((512, 4, True), "l2"),
    ((4096, 4, True), "l2"),
    ((4096, 2, True), "l2"),
]


def test_plans_cover_the_probe_configurations(port_configs):
    """``PROBE_PLANS`` lists the probe's six panel configurations in
    order."""
    got = [(x.shape[0], x.element_size(), idx.dim() == 1)
           for _, _, x, idx in port_configs[1:]]
    assert got == [cfg for cfg, _ in PROBE_PLANS]


@pytest.mark.parametrize("cfg,want", PROBE_PLANS)
def test_panel_plan_of_the_probe_configurations(cfg, want):
    """K7's host plan: the block form, the whole panel in each block's
    shared memory within ``SMEM_BYTES``, where the panel fits there (P=8);
    else the L2 form, which takes no shared memory."""
    p, elem_bytes, _ = cfg
    assert panel_plan(p, D, elem_bytes) == want
    assert (want == "block") == (p * D * elem_bytes <= SMEM_BYTES)


@pytest.mark.parametrize("d", (128, 12, 7))
@pytest.mark.parametrize("elem_bytes", (4, 2))
def test_panel_plan_size_rule_at_its_edge(d, elem_bytes):
    """The largest panel a block's shared memory holds takes the block
    form; one row more is read through L2."""
    rows = SMEM_BYTES // (d * elem_bytes)
    assert panel_plan(rows, d, elem_bytes) == "block"
    assert panel_plan(rows + 1, d, elem_bytes) == "l2"


def test_a_panel_beyond_any_cluster_is_planned_for_l2():
    """A panel larger than 16 blocks' shared memory (the largest thread-
    block cluster) still has a plan: the L2 form, no refusal; and the
    wrapper on CPU tensors gathers from it as the plain version does."""
    rows = 16 * SMEM_BYTES // (D * 4) + 1
    assert panel_plan(rows, D, 4) == "l2"
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((rows, D), dtype=np.float32))
    for kind in ("per_element", "per_row"):
        idx = torch.from_numpy(_indices(kind, 257, rows, D, rng))
        assert torch.equal(panel_gather(x, idx), panel_gather_plain(x, idx))
