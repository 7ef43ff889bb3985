"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only the port is
installed.  The kernel tests need an NVIDIA card and skip elsewhere; run
them there with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py configures JAX).

Tolerance: ``1e-5·sqrt(reduction length)·max(1, max|plain|)``: kernel
and plain version sum the same f32 (or bf16-rounded) terms in different
orders.  K4 counts integers, so its counts must agree exactly; its AUC
is formed in f64 from them and rounded once to f32, bit-equal to the
plain version for one score column and within 1 f32 ulp for a multilabel
mean.

Without a card, the tests below check what K1, K5 and K4 rely on: K1's
summation order replayed in PyTorch and its lane groups (a function of
the row's degree alone, also on a rank's local half), K5's host
partition of the triplets into slices, the exact counts of K4's plain
version and K4's one-pass tile algebra (``k4_tile_replay``) against them;
the card tests hold the compiled kernels to those.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.data.synthetic_scale import (
    linkx_scale_graph,
    twitch_gamers_scale_graph,
)
from acmgnn_tpu_torch.models import layers
from acmgnn_tpu_torch.models.layers import (
    attention_mix_backward,
    attention_mix_backward_plain,
    attention_mix_forward,
    attention_mix_forward_plain,
    ATTN_MAX_D,
    _launch_backward,
    _launch_forward,
    attention_grad_scales,
    attention_plan,
    bf16_matmul,
    row_sums,
)
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.coo import (
    SLICE_NNZ,
    coo_spmm,
    coo_spmm_plain,
    make_coo_half,
)
from acmgnn_tpu_torch.ops.ell import (
    K1_FORMS,
    K1_LANES,
    K1_WIDE_BYTES,
    _build_half,
    _row_gather_spmm_cuda,
    k1_form,
    k1_lanes,
    k1_operand,
    k1_operand_ld,
    k1_order_replay,
    make_ell_op,
    row_gather_spmm,
    row_gather_spmm_plain,
)
from acmgnn_tpu_torch.ops.graph import (
    GraphData,
    make_coo_op,
    row_normalized_adjacency,
    sym_normalized_adjacency,
)
from acmgnn_tpu_torch.ops.halo import halo_pack, halo_pack_plain, padded_rows
from acmgnn_tpu_torch.ops.panel_gather import (
    SMEM_BYTES,
    _launch,
    panel_gather,
    panel_gather_plain,
    panel_plan,
)
from acmgnn_tpu_torch.ops.spmm import spmm_multi
from acmgnn_tpu_torch.parallel.sharded import make_sharded_ell_op
from acmgnn_tpu_torch.train.metrics import _launch as k4_launch
from acmgnn_tpu_torch.train.metrics import (
    K4_TILE,
    K4_TILES,
    MAX_MASKS,
    auc_rank_pass,
    auc_rank_pass_plain,
    k4_tile_replay,
    pack_labels_and_masks,
    rocauc_from_sorted,
    rocauc_from_sorted_plain,
    sort_scores,
)
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_split_runner,
    prepare_data,
    prepare_sharded_data,
)

REPO = Path(__file__).resolve().parent.parent


def assert_close(got, want, n_terms, msg=""):
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    tol = 1e-5 * max(1.0, n_terms ** 0.5) * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, f"{msg}: max_abs_err {err:.3e} > {tol:.3e}"


def _matrices():
    rng = np.random.default_rng(0)
    n = 700
    dense = (rng.random((n, n)) < 0.02).astype(np.float64)
    np.fill_diagonal(dense, 0.0)
    sym = np.maximum(dense, dense.T)
    sym[7, :] = sym[:, 7] = 0.0           # isolated node
    weighted = sp.csr_matrix(dense)
    weighted.data = rng.uniform(0.1, 2.0, weighted.nnz)
    return {
        "lowpass_sym": row_normalized_adjacency(sp.csr_matrix(sym)),
        "binary_sym": sp.csr_matrix(sym),
        "lowpass_directed": row_normalized_adjacency(sp.csr_matrix(dense)),
        "weighted": weighted,
        "symnorm": sym_normalized_adjacency(sp.csr_matrix(sym)),
    }


def _attention_inputs(n, d, device):
    """Channels before the ReLU: negative entries, exact zeros, rows with
    no positive entry and flat rows (var == 0 after the ReLU)."""
    gen = torch.Generator().manual_seed(d)
    zs = [torch.randn(n, d, generator=gen) for _ in range(3)]
    zs[2][:5] = -zs[2][:5].abs()            # no positive entry: var == 0
    zs[1][5:9, :] = 0.5                     # flat rows: var == 0, r ~ 316
    zs[0][9:12, :] = 0.0                    # exact zeros, the ReLU's tie
    zs[0][::5, 0] = 0.0
    v = torch.randn(3, d, generator=gen)
    c = torch.randn(3, generator=gen)
    W = torch.rand(3, 3, generator=gen) * 2 - 1
    gout = torch.randn(n, d, generator=gen)
    return [t.to(device) for t in (*zs, v, c, W, gout)]


def assert_attention_grads_close(got, want, bargs, msg=""):
    """K3's outputs against the plain version's: ``dz_i`` as
    ``assert_close`` over a row of d; ``dv``, ``dc`` and ``dW``, sums over
    the N rows, per element to ``1e-6·max(1, Σ_rows|term|)`` (rounding
    reads ~1e-8 of Σ_rows|term|; a tolerance growing with sqrt(N) would
    pass a sum that lost a block of rows).  ``bargs``: the backward's
    arguments, channels first."""
    t, d = len(bargs[0]), bargs[0][0].shape[1]
    for i in range(t):
        assert_close(got[i], want[i], d, f"{msg} dz{i}")
    scales = attention_grad_scales(*bargs)
    for name, g, w, s in zip(("dv", "dc", "dW"), got[t:], want[t:], scales):
        err = (g - w).abs()
        tol = 1e-6 * s.clamp_min(1.0)
        assert bool((err <= tol).all()), (
            f"{msg} {name}: max_abs_err {float(err.max()):.3e}, worst "
            f"err/tolerance {float((err / tol).max()):.3e}")


def test_wrappers_refuse_a_device_without_kernel():
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise, never fall back."""
    op = make_ell_op(_matrices()["lowpass_sym"])
    x = torch.empty(op.num_nodes, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        row_gather_spmm(op.fwd, x)
    z0, z1, z2, v, c, W, gout = _attention_inputs(20, 4, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_mix_forward((z0, z1, z2), v, c, W, True, 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        attention_mix_backward((z0, z1, z2), gout, v, c, W, True, 3.0)
    coo = make_coo_op(_matrices()["lowpass_sym"]).to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        coo_spmm(coo.fwd, x)
    s = torch.empty(1, 50, device="meta")
    order = torch.empty(1, 50, dtype=torch.int64, device="meta")
    packed = torch.empty(1, 50, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        auc_rank_pass(s, order, packed, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rocauc_from_sorted(s, order, packed, 2, False)
    with pytest.raises(ValueError, match="CUDA"):
        halo_pack(x, torch.empty_like(x, dtype=torch.bfloat16))
    from acmgnn_tpu_torch.ops.dropout import DropoutKey, dropout
    from acmgnn_tpu_torch.ops.loop import DeviceLoop

    k = torch.zeros((), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dropout(x, 0.5, DropoutKey.new(0, 0, k), 0)
    with pytest.raises(ValueError, match="CUDA"):
        DeviceLoop(None, k, k)


def test_port_imports_no_jax():
    """The package and chip_smoke.py import nothing of JAX, acmgnn_tpu or
    bench.py, nor pandas, scikit-learn or orbax (absent where the card
    is): every module imports with those names blocked."""
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "acmgnn_tpu", "bench", "pandas",
                                  "sklearn", "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import acmgnn_tpu_torch
for m in pkgutil.walk_packages(acmgnn_tpu_torch.__path__, "acmgnn_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
print(" ".join(sorted(sys.modules)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert {"acmgnn_tpu_torch.ops.panel_gather",
            "acmgnn_tpu_torch.tools.gather_probe",
            "acmgnn_tpu_torch.utils.logging",
            "acmgnn_tpu_torch.utils.resilience",
            "acmgnn_tpu_torch.cli",
            "acmgnn_tpu_torch.data.paths",
            "acmgnn_tpu_torch.data.planetoid",
            "acmgnn_tpu_torch.data.geomgcn",
            "acmgnn_tpu_torch.data.linkx",
            "acmgnn_tpu_torch.data.homophily",
            "acmgnn_tpu_torch.data.synthetic",
            "acmgnn_tpu_torch.data.synthetic_scale",
            "acmgnn_tpu_torch.entry",
            "acmgnn_tpu_torch.ops.native",
            "acmgnn_tpu_torch.utils.checkpoint",
            "acmgnn_tpu_torch.utils.profiling",
            "acmgnn_tpu_torch.train.sweep",
            "acmgnn_tpu_torch.train.synthetic_exp"} <= imported


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and outside the repo, the smoke script exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k1_matrix(kind):
    """``_matrices()[kind]``, or "hub": rows of the hub class (degree >
    256), of each lane group and without entries."""
    return _hub_matrix(600) if kind == "hub" else _matrices()[kind]


K1_KINDS = ("lowpass_sym", "binary_sym", "lowpass_directed", "weighted",
            "hub", "symnorm")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", K1_KINDS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width,hp", [(7, None), (8, (0, 0, 1, 1, 0, 0, 1, 1)),
                                      (4, (0, 0, 1, 1)), (12, None),
                                      (20, None), (128, (0,) * 64 + (1,) * 64),
                                      (600, None)])
def test_k1_matches_plain(cuda, kind, dtype, width, hp):
    mat = _k1_matrix(kind)
    op = make_ell_op(mat, gather_dtype=dtype).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(width)
    z = torch.randn(op.num_nodes, width, generator=gen, device=cuda)
    alpha = beta = None
    if hp is not None:
        alpha = [float(h) for h in hp]
        beta = [-1.0 if h else 1.0 for h in hp]
    x = z.to(dtype)
    n_terms = int(np.diff(sp.csr_matrix(mat).indptr).max()) + 1
    for half in (op.fwd, op.bwd):
        got = row_gather_spmm(half, x, z=z, alpha=alpha, beta=beta)
        want = row_gather_spmm_plain(
            half, x, z if hp else None, tuple(alpha or (0.0,) * width),
            tuple(beta or (1.0,) * width))
        torch.cuda.synchronize()
        assert_close(got, want, n_terms, f"{kind} w{width}")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", K1_KINDS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width", (4, 7, 8, 12, 20, 32, 64, 128, 600))
@pytest.mark.parametrize("padded", (False, True))
def test_k1_equals_its_order_replay(cuda, kind, dtype, width, padded):
    """K1 bit for bit against ``k1_order_replay``, on both halves, with a
    high-pass epilogue, on a contiguous operand and on K1's row-padded
    layout (the same values, so the same bits); in the narrow form at the
    narrow widths and in the wide form at the wide ones (``k1_form``;
    "padded" there is a row stride of 16 more bytes than the row's)."""
    op = make_ell_op(_k1_matrix(kind), gather_dtype=dtype).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(width)
    z = torch.randn(op.num_nodes, width, generator=gen, device=cuda)
    if k1_form(width, dtype) == "wide" and padded:
        ld = k1_operand_ld(width, dtype) + 128 // torch.finfo(dtype).bits
        x = torch.full((op.num_nodes, ld), float("nan"), dtype=dtype,
                       device=cuda)[:, :width]
        x.copy_(z)
    else:
        x = k1_operand(z, dtype) if padded else z.to(dtype)
    alpha = tuple(float(j % 2) for j in range(width))
    beta = tuple(-1.0 if j % 2 else 1.0 for j in range(width))
    for half in (op.fwd, op.bwd):
        got = row_gather_spmm(half, x, z=z, alpha=alpha, beta=beta)
        want = k1_order_replay(half, x, z, alpha, beta)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("lowpass_sym", "weighted", "hub",
                                  "symnorm"))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width", (16, 32, 64))
@pytest.mark.parametrize("form", K1_FORMS)
def test_k1_each_form_equals_its_replay_at_the_crossover(cuda, kind, dtype,
                                                         width, form):
    """At the widths where chip_smoke.py times the two forms against each
    other, K1 run in either form equals that form's replay bit for bit."""
    op = make_ell_op(_k1_matrix(kind), gather_dtype=dtype).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(width)
    z = torch.randn(op.num_nodes, width, generator=gen, device=cuda)
    x = k1_operand(z, dtype)
    alpha = tuple(float(j % 2) for j in range(width))
    beta = tuple(-1.0 if j % 2 else 1.0 for j in range(width))
    for half in (op.fwd, op.bwd):
        want = k1_order_replay(half, x, z, alpha, beta, form=form)
        got = _row_gather_spmm_cuda(half, x, z, alpha, beta, form)
        assert torch.equal(got, want)
        if form == k1_form(width, dtype):
            assert torch.equal(row_gather_spmm(half, x, z=z, alpha=alpha,
                                               beta=beta), want)


@pytest.mark.gpu
def test_k1_wide_form_refuses_a_misaligned_operand(cuda):
    """The wide form reads 16-byte vectors: an operand whose rows or base
    are not 16-byte aligned raises, and K1 does not run it in the narrow
    form instead."""
    op = make_ell_op(_k1_matrix("hub"), gather_dtype=torch.bfloat16).to(cuda)
    n = op.num_nodes
    assert k1_form(600, torch.bfloat16) == "wide"
    before = kernels.launches.copy()
    odd_rows = torch.zeros(n, 601, dtype=torch.bfloat16, device=cuda)[:, :600]
    odd_base = torch.zeros(n, 608, dtype=torch.bfloat16, device=cuda)[:, 1:601]
    flat = torch.zeros(n, 4814, dtype=torch.bfloat16, device=cuda)
    for x in (odd_rows, odd_base, flat):
        with pytest.raises(ValueError, match="16-byte"):
            row_gather_spmm(op.fwd, x)
    assert kernels.launches == before
    # the padded operand of the same values runs
    assert torch.equal(row_gather_spmm(op.fwd, k1_operand(flat, torch.bfloat16)),
                       torch.zeros(n, 4814, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 7, 33, 64, 100))
def test_k2_k3_match_plain(cuda, d, use_ln):
    z0, z1, z2, v, c, W, gout = _attention_inputs(3000, d, cuda)
    args = ((z0, z1, z2), v, c, W, use_ln, 3.0)
    assert_close(attention_mix_forward(*args),
                 attention_mix_forward_plain(*args), d, "K2")
    bargs = ((z0, z1, z2), gout, v, c, W, use_ln, 3.0)
    assert_attention_grads_close(attention_mix_backward(*bargs),
                                 attention_mix_backward_plain(*bargs), bargs,
                                 "K3")


@pytest.mark.gpu
@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 7, 64, 100))
def test_k3_is_bit_reproducible(cuda, d, use_ln):
    """Two K3 launches on the same inputs agree bit for bit: the
    parameter gradients are summed in a fixed order, without atomics."""
    z0, z1, z2, v, c, W, gout = _attention_inputs(30000, d, cuda)
    bargs = ((z0, z1, z2), gout, v, c, W, use_ln, 3.0)
    first = attention_mix_backward(*bargs)
    for a, b in zip(first, attention_mix_backward(*bargs)):
        assert torch.equal(a, b)


def _without_block(out, partials, b, use_ln):
    """K3's ``(dv, dc, dW)`` had the finishing kernel left out block
    ``b``'s row of the partials."""
    d = out[0].shape[1]
    p = partials[b]
    return (out[0] - p[:3 * d].view(3, d) - p[3 * d:3 * d + 3][:, None],
            out[1] - p[3 * d + 3:3 * d + 6] * use_ln,
            out[2] - p[3 * d + 6:].view(3, 3) / 3)


@pytest.mark.gpu
@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 64))
def test_k3_row_sum_check_catches_a_lost_block(cuda, d, use_ln):
    """The check of dv, dc and dW fails a sum that lost any one block's
    rows, or a dv of zeros, while it passes K3 itself."""
    z0, z1, z2, v, c, W, gout = _attention_inputs(30000, d, cuda)
    bargs = ((z0, z1, z2), gout, v, c, W, use_ln, 3.0)
    *got, partials = _launch_backward((z0, z1, z2), gout, v, c, W, use_ln,
                                      3.0, attention_plan(d))
    want = attention_mix_backward_plain(*bargs)
    assert partials.shape[1] == 3 * d + row_sums(3) and partials.shape[0] > 1
    assert_attention_grads_close(got, want, bargs, "K3")
    for b in range(partials.shape[0]):
        with pytest.raises(AssertionError, match="dv"):
            lost = _without_block(got[3:], partials, b, use_ln)
            assert_attention_grads_close((*got[:3], *lost), want, bargs)
    with pytest.raises(AssertionError, match="dv"):
        assert_attention_grads_close(
            (*got[:3], torch.zeros_like(got[3]), *got[4:]), want, bargs)


@pytest.mark.gpu
@pytest.mark.parametrize("d", (2, 7, 64))
def test_k2_k3_take_column_views(cuda, d):
    """Channels that are column views of one wider tensor (the layer's
    fused gather output), read at their row stride without a copy."""
    z0, z1, z2, v, c, W, gout = _attention_inputs(3000, d, cuda)
    wide = torch.cat([z0, z1, z2, z0], dim=1)
    views = [wide[:, i * d:(i + 1) * d] for i in range(3)]
    for use_ln in (False, True):
        args = (views, v, c, W, use_ln, 3.0)
        assert_close(attention_mix_forward(*args),
                     attention_mix_forward_plain((z0, z1, z2), v, c, W,
                                                 use_ln, 3.0), d, "K2 views")
        bargs = ((z0, z1, z2), gout, v, c, W, use_ln, 3.0)
        assert_attention_grads_close(
            attention_mix_backward(views, gout, v, c, W, use_ln, 3.0),
            attention_mix_backward_plain(*bargs), bargs, "K3 views")


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", (4, 8, 16))
def test_k2_k3_lanes_per_row(cuda, lanes):
    """Every lanes-per-row instance that chip_smoke.py sweeps at d=64."""
    z0, z1, z2, v, c, W, gout = _attention_inputs(3000, 64, cuda)
    for use_ln in (False, True):
        args = ((z0, z1, z2), v, c, W, use_ln, 3.0)
        plan = (lanes, 64 // lanes)
        assert_close(_launch_forward((z0, z1, z2), v, c, W, use_ln, 3.0,
                                     plan),
                     attention_mix_forward_plain(*args), 64, "K2")
        bargs = ((z0, z1, z2), gout, v, c, W, use_ln, 3.0)
        assert_attention_grads_close(
            _launch_backward((z0, z1, z2), gout, v, c, W, use_ln, 3.0,
                             plan)[:6],
            attention_mix_backward_plain(*bargs), bargs, f"K3 {lanes}")


def _compiled_attention_instances():
    """The (vector width, lanes, floats) instances attention.cu compiles."""
    src = (REPO / "acmgnn_tpu_torch" / "csrc" / "attention.cu").read_text()
    table = src[src.index("#define ACM_K23_INSTANCES"):]
    table = table[:table.index("\n\n")]
    return {tuple(map(int, m)) for m in
            re.findall(r"X\((\d+), (\d+), (\d+)\)", table)}


def test_attention_channel_instances_are_compiled():
    """Every (channels, ReLU mask) instance the layers launch
    (``layers.ATTN_INSTANCES``) is one attention.cu compiles, and K3's
    partials row holds T d columns and 2 T + T² row sums."""
    src = (REPO / "acmgnn_tpu_torch" / "csrc" / "attention.cu").read_text()
    table = src[src.index("#define ACM_K23_CHANNELS"):]
    table = table[:table.index("\n")]
    compiled = {tuple(map(int, m)) for m in
                re.findall(r"X\((\d+), (\d+)\)", table)}
    want = {(len(f), sum(1 << i for i, r in enumerate(f) if r))
            for f in layers.ATTN_INSTANCES}
    assert compiled == want
    assert (row_sums(3), row_sums(4)) == (15, 24)


@pytest.mark.gpu
@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("relu", layers.ATTN_INSTANCES)
@pytest.mark.parametrize("d", (2, 5, 7, 64))
def test_k2_k3_instances_match_plain(cuda, d, relu, use_ln):
    """K2/K3 at every (channels, ReLU mask) instance against their plain
    versions, K3 bit-equal across two launches, and the row-sum check
    failing a lost block of the T d + 2 T + T² partials."""
    t = len(relu)
    z0, z1, z2, _, _, _, gout = _attention_inputs(3000, d, cuda)
    gen = torch.Generator(device=cuda).manual_seed(t * 100 + d)
    zs = [z0, z1, z2, torch.randn(3000, d, generator=gen, device=cuda)][:t]
    v = torch.randn(t, d, generator=gen, device=cuda)
    c = torch.randn(t, generator=gen, device=cuda)
    W = torch.rand(t, t, generator=gen, device=cuda) * 2 - 1
    scale = 1.0 if t == 4 else 3.0
    args = (zs, v, c, W, use_ln, scale, relu)
    assert_close(attention_mix_forward(*args),
                 attention_mix_forward_plain(*args), d, "K2")
    bargs = (zs, gout, v, c, W, use_ln, scale, relu)
    *got, partials = _launch_backward(zs, gout, v, c, W, use_ln, scale,
                                      attention_plan(d), relu)
    want = attention_mix_backward_plain(*bargs)
    assert partials.shape[1] == t * d + row_sums(t)
    assert_attention_grads_close(got, want, bargs, "K3")
    for a, b in zip(attention_mix_backward(*bargs),
                    attention_mix_backward(*bargs)):
        assert torch.equal(a, b)
    p = partials[0]
    lost = (got[t] - p[:t * d].view(t, d) - p[t * d:t * d + t][:, None],
            *got[t + 1:])
    if partials.shape[0] > 1:
        with pytest.raises(AssertionError, match="dv"):
            assert_attention_grads_close((*got[:t], *lost), want, bargs)


def test_attention_plan_has_a_compiled_instance_at_every_width():
    """``attention_plan`` at every width K2/K3 take, and the lanes swept at
    d=64, names an instance attention.cu compiles, with its vector loads
    and with the scalar fallback; a lane group covers the row."""
    compiled = _compiled_attention_instances()
    assert attention_plan(64) == (4, 16) and attention_plan(2) == (1, 2)
    for d in range(1, ATTN_MAX_D + 1):
        g, e = attention_plan(d)
        assert g * e >= d and g in (1, 2, 4, 8, 16, 32), d
        assert (1, g, e) in compiled, d
        vec = 2 if e == 2 else 4
        if d % vec == 0:
            assert (vec, g, e) in compiled, d
    for lanes in (4, 8, 16):
        assert (4, lanes, 64 // lanes) in compiled
    with pytest.raises(ValueError, match="registers"):
        attention_plan(ATTN_MAX_D + 1)


@pytest.mark.gpu
def test_spmm_multi_card_matches_cpu(cuda):
    """Fused forward and prefix gradient through K1 against the CPU."""
    mat = _matrices()["lowpass_sym"]
    rng = np.random.default_rng(1)
    n = mat.shape[0]
    zs = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4)]
    gs = [rng.normal(size=(n, 2)).astype(np.float32) for _ in range(4)]
    res = {}
    for dev in ("cpu", cuda):
        op = make_ell_op(mat, gather_dtype=torch.bfloat16).to(dev)
        tz = [torch.from_numpy(z).to(dev).requires_grad_(i < 2)
              for i, z in enumerate(zs)]
        outs = spmm_multi(op, tz, [False, True, False, True], grad_prefix=2)
        torch.autograd.backward(
            outs, [torch.from_numpy(g).to(dev) for g in gs])
        res[str(dev)] = outs + [tz[0].grad, tz[1].grad]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert_close(a, b, 64, "spmm_multi")


@pytest.mark.gpu
def test_run_joint_card_matches_cpu_and_counts_launches(cuda):
    adj, feats, labels = twitch_gamers_scale_graph(0, n=400, pairs=4000)
    data = GraphData("g", adj, np.abs(feats), labels)
    cfg = TrainConfig(
        model_type="acmgcnp", hidden=16, dropout=0.0, lr=0.01,
        weight_decay=1e-3, epochs=12, early_stopping=0,
        selection="val_metric", operator_format="ell", spmm_dtype="float32",
        joint=True, hoist_first=True)
    perm = np.random.default_rng(0).permutation(400)
    masks_np = np.zeros((3, 400), bool)
    for i, part in enumerate((perm[:200], perm[200:300], perm[300:])):
        masks_np[i, part] = True
    params = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launches()
        _, ops, x, y, _, nclass = prepare_data(data, cfg, device=dev)
        model = build_model(cfg, x.shape[1], nclass, device=dev, seed=2)
        make_split_runner(model, cfg)(
            ops, x, y, tuple(torch.from_numpy(m).to(dev) for m in masks_np))
        params[dev] = {k: p.detach().cpu() for k, p in model.named_parameters()}
        if dev == "cuda":
            it = cfg.epochs + 1
            # dropout 0: both layer-1 branches read x_agg, no input gather
            assert dict(kernels.launches) == {
                "k1_spmm_w7": 1, "k1_spmm_w8": it, "k1_spmm_w4": it,
                "k2_attn_fwd_d16": 2 * it, "k2_attn_fwd_d2": 2 * it,
                "k3_attn_bwd_d16": it, "k3_attn_bwd_d2": it,
                LOOP_COUNTER: it}
    for k, ref in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# the captured loop against the eager one: (graph, configuration).  Dropout
# 0.5 except where a stop must fire (at dropout 0 the CPU shows it firing,
# tests/test_torch_split_loop.py)
CAPTURE_CASES = {
    "joint_ell": ("twitch", dict(model_type="acmgcnp", operator_format="ell",
                                 spmm_dtype="bfloat16")),
    "joint_ell_remat": ("twitch", dict(model_type="acmgcnp", remat=True)),
    "joint_ell_adamw": ("twitch", dict(model_type="acmgcnp",
                                       optimizer="adamw")),
    "joint_coo_rocauc": ("genius", dict(operator_format="coo")),
    "joint_pp_structure": ("twitch", dict(
        model_type="acmgcnpp", structure_info=True, spmm_dtype="bfloat16",
        gemm_dtype="bfloat16")),
    "joint_pp_batchnorm": ("twitch", dict(model_type="acmgcnpp",
                                          init_layers_X=2)),
    "sequential_acmsgc_sym": ("twitch", dict(
        model_type="acmsgc", hops=2, joint=False, normalization="sym",
        spmm_dtype="bfloat16")),
    "sequential_rocauc": ("genius", dict(joint=False)),
    "sequential_rocauc_stop": ("genius", dict(joint=False, dropout=0.0,
                                              epochs=40, early_stopping=5)),
}


def _capture_case(case):
    name, over = CAPTURE_CASES[case]
    if name == "twitch":
        adj, feats, labels = twitch_gamers_scale_graph(0, n=400, pairs=4000)
        base = dict(model_type="acmgcn", selection="val_metric")
    else:
        adj, feats, labels = linkx_scale_graph("genius", n=400, e=1000,
                                               max_deg=60)
        base = dict(model_type="acmgcn", metric="rocauc", loss="bce",
                    selection="val_metric")
    cfg = TrainConfig(**{**dict(
        hidden=16, dropout=0.5, lr=0.01, weight_decay=1e-3, epochs=12,
        early_stopping=0, operator_format="ell", spmm_dtype="float32",
        joint=True, hoist_first=True), **base, **over})
    perm = np.random.default_rng(1).permutation(400)
    masks_np = np.zeros((3, 400), bool)
    for i, part in enumerate((perm[:200], perm[200:300], perm[300:])):
        masks_np[i, part] = True
    return GraphData("g", adj, np.abs(feats), labels), cfg, masks_np


def _run_form(data, cfg, masks_np, graph):
    """One split on the card in the eager (``graph=False``) or captured
    (True) form from the same parameters and seed: (result, state,
    parameters, launch counts)."""
    kernels.reset_launches()
    _, ops, x, y, y1h, nclass = prepare_data(data, cfg, device="cuda")
    model = build_model(cfg, x.shape[1], nclass, device="cuda", seed=2,
                        nnodes=x.shape[0])
    masks = tuple(torch.from_numpy(m).cuda() for m in masks_np)
    res, state = make_split_runner(model, cfg, graph=graph)(
         ops, x, y, masks, seed=5, labels_onehot=y1h, return_state=True)
    torch.cuda.synchronize()
    # parameters and buffers (BatchNorm's running statistics)
    return (res, state, {k: p.detach().clone()
                         for k, p in model.state_dict().items()},
            dict(kernels.launches))


@pytest.mark.gpu
@pytest.mark.parametrize("case", tuple(CAPTURE_CASES))
def test_captured_loop_equals_eager_bit_for_bit(cuda, case):
    """Every body after the first run by one launch of the device loop
    around one CUDA graph (K9 deciding after each body) gives the eager
    loop's run bit for bit: parameters, the train-loss and val-loss
    histories, best metrics and ``epochs_run`` (an early stop at the same
    epoch); dropout draws the eager run's masks (K8 keyed by the loop's
    counter); ``kernels.launches`` counts the same launches, and K9 once
    more than the replayed bodies; the capture asks K2/K3's occupancy of
    no new instance (its buffers are aligned as the eager ones)."""
    data, cfg, masks_np = _capture_case(case)
    eager = _run_form(data, cfg, masks_np, False)
    resident = set(layers._resident)
    captured = _run_form(data, cfg, masks_np, True)
    assert set(layers._resident) == resident
    (re, se, pe, ce), (rc, sc, pc, cc) = eager, captured
    assert se.capture_ms is None and sc.capture_ms is not None
    assert re.epochs_run == rc.epochs_run and se.epoch == sc.epoch
    if cfg.early_stopping:
        assert rc.epochs_run < cfg.epochs, "the stop must fire"
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert torch.equal(getattr(re, f), getattr(rc, f)), f
    assert torch.equal(se.train_losses, sc.train_losses)
    assert torch.equal(se.val_hist, sc.val_hist)
    for k in pe:
        assert torch.equal(pe[k], pc[k]), k
    assert cc.pop(LOOP_COUNTER) == sc.replays + 1
    assert ce == cc


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("joint_ell", "joint_pp_batchnorm",
                                  "joint_coo_rocauc", "sequential_rocauc"))
def test_sharded_nccl_capture_equals_eager(cuda, case):
    """World size 1 over NCCL: the sharded runner captures its body (the
    collectives, K6's packs, BatchNorm's summed statistics and ROC-AUC's
    gathered logits inside the graph) and the captured run equals the
    eager one (``graph=False``) bit for bit: parameters and buffers,
    histories, best metrics, ``epochs_run`` and launch counts."""
    import socket

    import torch.distributed as dist

    from acmgnn_tpu_torch.parallel.multihost import init_distributed

    data, cfg, masks_np = _capture_case(case)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_distributed(backend="nccl", device="cuda", rank=0, world_size=1,
                     init_method=f"tcp://localhost:{port}")
    try:
        prep = prepare_sharded_data(data, cfg, group=dist.group.WORLD)
        runs = []
        for graph in (False, True):
            kernels.reset_launches()
            model = build_model(cfg, prep.x.shape[1], prep.nclass, seed=2,
                                nnodes=data.num_nodes)
            res, state = make_split_runner(
                model, cfg, group=dist.group.WORLD, graph=graph)(
                prep.ops, prep.x, prep.labels,
                tuple(prep.place(m) for m in masks_np), seed=5,
                labels_onehot=prep.labels_onehot, return_state=True)
            torch.cuda.synchronize()
            runs.append((res, state, {k: v.detach().clone() for k, v in
                                      model.state_dict().items()},
                         dict(kernels.launches)))
    finally:
        dist.destroy_process_group()
    (re, se, pe, ce), (rc, sc, pc, cc) = runs
    assert se.capture_ms is None and sc.capture_ms is not None
    assert cc.pop(LOOP_COUNTER) == sc.replays + 1
    assert re.epochs_run == rc.epochs_run and ce == cc
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        assert torch.equal(getattr(re, f), getattr(rc, f)), f
    assert torch.equal(se.train_losses, sc.train_losses)
    assert torch.equal(se.val_hist, sc.val_hist)
    for k in pe:
        assert torch.equal(pe[k], pc[k]), k


@pytest.mark.gpu
def test_captured_loop_counts_launches_per_replay(cuda):
    """The captured joint loop counts one body's launches per body the
    device loop ran and none at the capture: at 12 and at 20 epochs the
    counts are what the run's bodies imply (dropout 0: both layer-1
    branches read x_agg, and K8 runs nowhere), K9 once a body after the
    eager first and once before them."""
    data, cfg, masks_np = _capture_case("joint_ell")
    for epochs in (12, 20):
        run_cfg = dataclasses.replace(cfg, dropout=0.0, epochs=epochs,
                                      spmm_dtype="float32")
        it = epochs + 1
        assert _run_form(data, run_cfg, masks_np, True)[3] == {
            "k1_spmm_w7": 1, "k1_spmm_w8": it, "k1_spmm_w4": it,
            "k2_attn_fwd_d16": 2 * it, "k2_attn_fwd_d2": 2 * it,
            "k3_attn_bwd_d16": it, "k3_attn_bwd_d2": it, LOOP_COUNTER: it}


def _same_tree(a, b) -> bool:
    """Nested dicts, lists and tensors equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return a == b


class _Splits:
    """A logger that keeps each split's result and the per-epoch rows."""

    def __init__(self):
        self.results, self.rows = [], []

    def info(self, msg, *args):
        if "epoch" in msg:
            self.rows.append(args)

    def log_split(self, idx, res):
        self.results.append(res)

    def log_result(self, out):
        pass


LOOP_COUNTER = "k9_loop_cond"


@contextlib.contextmanager
def _loop_launches():
    """How many times a device loop is launched inside the block."""
    from acmgnn_tpu_torch.ops.loop import DeviceLoop

    launch, made = DeviceLoop.launch, [0]

    def counted(self):
        made[0] += 1
        launch(self)

    DeviceLoop.launch = counted
    try:
        yield made
    finally:
        DeviceLoop.launch = launch


@pytest.fixture
def captures(monkeypatch):
    """How many CUDA graphs ``trainer._capture`` records while the test
    runs."""
    from acmgnn_tpu_torch.train import trainer

    made = [0]
    capture = trainer._capture

    def counted(*args, **kwargs):
        made[0] += 1
        return capture(*args, **kwargs)

    monkeypatch.setattr(trainer, "_capture", counted)
    return made


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("joint_ell_remat", "joint_pp_batchnorm",
                                  "sequential_rocauc"))
def test_one_capture_a_run_equals_a_capture_a_split(cuda, case, captures):
    """``run_experiment`` (3 splits) captures once and runs every split in
    one launch of the device loop around that graph, each written in
    place (parameters, moments, loop state, masks, the dropout seed);
    every split's result equals, bit for bit, the same run with a fresh
    model and runner (and capture) a split; each split is one launch."""
    from acmgnn_tpu_torch.train import trainer

    data, cfg, _ = _capture_case(case)
    cfg = dataclasses.replace(cfg, num_splits=3, seed=4)
    runs = []
    for fresh in (False, True):
        def hook(model, ops, x, labels, masks, *, seed, labels_onehot,
                 hparams):
            mdl = build_model(cfg, x.shape[1], int(labels_onehot.shape[1]),
                              seed=seed, nnodes=x.shape[0])
            return make_split_runner(mdl, cfg)(
                ops, x, labels, masks, seed=seed,
                labels_onehot=labels_onehot, hparams=hparams)

        captures[0] = 0
        log = _Splits()
        with _loop_launches() as launched:
            trainer.run_experiment(data, cfg, logger=log,
                                   runner=hook if fresh else None)
        runs.append(log.results)
        assert captures[0] == (3 if fresh else 1)
        assert launched[0] == 3
    for a, b in zip(*runs):
        assert a.epochs_run == b.epochs_run
        for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
def test_a_failed_replay_is_retried_on_a_new_capture(cuda, captures,
                                                     monkeypatch):
    """A transient failure raised by the device loop's launch in split 1:
    the split is retried, the runner discards the loop and the graph it
    was running, runs its first body eagerly and captures anew (2
    captures in the run), and every split's result equals the undisturbed
    run's bit for bit."""
    import time

    from acmgnn_tpu_torch.ops.loop import DeviceLoop
    from acmgnn_tpu_torch.train import trainer

    data, cfg, _ = _capture_case("joint_ell")
    cfg = dataclasses.replace(cfg, num_splits=2)
    clean = _Splits()
    trainer.run_experiment(data, cfg, logger=clean)
    launch = DeviceLoop.launch
    calls = [0]

    def flaky(self):
        calls[0] += 1
        if calls[0] == 2:                    # split 1's launch
            raise RuntimeError("UNAVAILABLE: an injected failure")
        launch(self)

    monkeypatch.setattr(DeviceLoop, "launch", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    captures[0] = 0
    retried = _Splits()
    trainer.run_experiment(data, cfg, logger=retried)
    assert captures[0] == 2
    for a, b in zip(clean.results, retried.results):
        assert a.epochs_run == b.epochs_run
        for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("joint_ell_remat", "sequential_rocauc"))
def test_captured_stepwise_equals_its_eager_form(cuda, case, captures,
                                                 tmp_path):
    """``run_experiment_stepwise`` (2 splits, dropout 0.5) captured (one
    graph: the first epoch eager, the second captured, every later one of
    both splits a replay) against ``graph=False``: every epoch's loss and
    metrics, and each split's final weights, Adam's moments and step and
    best weights, bit for bit."""
    from acmgnn_tpu_torch.train import trainer
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    data, cfg, _ = _capture_case(case)
    cfg = dataclasses.replace(cfg, num_splits=2, epochs=8)
    logs = []
    for graph in (False, True):
        captures[0] = 0
        log = _Splits()
        trainer.run_experiment_stepwise(
            data, cfg, logger=log, display_step=1, graph=graph,
            checkpoint_dir=str(tmp_path / str(graph)),
            checkpoint_every=cfg.epochs)
        logs.append(log.rows)
        assert captures[0] == (1 if graph else 0)
    assert logs[0] == logs[1] and len(logs[0]) == 2 * cfg.epochs
    for idx in range(cfg.num_splits):
        for f in ("last", "best"):
            a, b = (restore_checkpoint(tmp_path / str(g) / f"split{idx}_{f}",
                                       map_location="cpu")
                    for g in (False, True))
            assert _same_tree(a, b), (idx, f)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ("adam", "adamw"))
def test_card_optimizer_matches_optax_in_f64(cuda, optimizer):
    """``make_optimizer`` on the card (capturable; the first step eager,
    the second captured, the rest replays, as the split runner drives it)
    at lr 0.01 and weight decay 1e-3 against optax's update in f64
    (``chip_smoke.optimizer_check``): within its tolerance, and more than
    ten tolerances from the reference without the decay."""
    import chip_smoke

    cfg = chip_smoke.knob_check_config(optimizer=optimizer)
    err, no_decay = chip_smoke.optimizer_check(cfg, "cuda")
    assert err <= 1.0, err
    assert no_decay > 10.0, no_decay


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("rows,width", [(168_114, 64), (168_114, 7),
                                        (40_000, 600), (1001, 3)])
def test_k8_equals_its_plain_version_bit_for_bit(cuda, rows, width, dtype):
    """K8 forward and backward (the mask recomputed from the key) against
    ``dropout_plain`` on the same inputs, bit for bit, at the headline's
    widths (input 7, hidden 64 at N=168,114) and wiki's input width 600:
    the threshold compare is exact in f32 and the division IEEE's on both
    sides.  The key's epoch is read when the kernel runs."""
    from acmgnn_tpu_torch.ops import dropout as dropout_mod

    gen = torch.Generator(device=cuda).manual_seed(rows + width)
    h = torch.randn(rows, width, generator=gen, device=cuda).to(dtype)
    epoch = torch.tensor(11, device=cuda)
    key = dropout_mod.DropoutKey.new(3, 1, epoch)
    hh = h.clone().requires_grad_(dtype == torch.float32)
    out = dropout_mod.dropout(hh, 0.5, key, 2)
    assert torch.equal(out.detach(), dropout_mod.dropout_plain(h, 0.5, key,
                                                               2))
    g = torch.randn(rows, width, generator=gen, device=cuda)
    if hh.requires_grad:
        out.backward(g)
        assert torch.equal(hh.grad, dropout_mod.dropout_plain(g, 0.5, key, 2))
    assert torch.equal(dropout_mod._launch(g, 0.5, key, 2),
                       dropout_mod.dropout_plain(g, 0.5, key, 2))
    epoch.fill_(12)
    again = dropout_mod.dropout(h, 0.5, key, 2)
    assert torch.equal(again, dropout_mod.dropout_plain(h, 0.5, key, 2))
    assert not torch.equal(again, out.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 0.0),
                                                    ("adam", 1e-3),
                                                    ("adamw", 1e-2),
                                                    ("adamw", 0.0)])
def test_card_step_is_torchs_capturable_step(cuda, optimizer, weight_decay):
    """``make_optimizer``'s card form (lr and decay in a device tensor)
    equals torch's capturable multi-tensor Adam/AdamW with Python
    hyperparameters bit for bit over 20 steps."""
    from acmgnn_tpu_torch.train.trainer import make_optimizer

    gen = torch.Generator(device=cuda).manual_seed(3)
    p0 = [torch.randn(64, 7, generator=gen, device=cuda),
          torch.randn(64, generator=gen, device=cuda)]
    grads = [[torch.randn(p.shape, generator=gen, device=cuda) * 1e-3
              for p in p0] for _ in range(20)]
    cfg = TrainConfig(optimizer=optimizer, lr=1e-3,
                      weight_decay=weight_decay)
    cls = torch.optim.Adam if optimizer == "adam" else torch.optim.AdamW
    runs = []
    for make in (lambda ps: make_optimizer(cfg, ps),
                 lambda ps: cls(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay, capturable=True,
                                foreach=True)):
        ps = [torch.nn.Parameter(p.clone()) for p in p0]
        opt = make(ps)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = g.clone()
            opt.step()
        runs.append(ps)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Rectangular halves (a rank's local operator in the sharded SpMM) and K6
# ---------------------------------------------------------------------------


def _rectangular(rows=150, cols=420, seed=3):
    """A ``[rows, cols]`` block: rows without entries, a long row, and
    columns no row references (as a rank's block of the operator over its
    receive buffer)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((rows, cols)) < 0.04) * rng.uniform(0.1, 2.0,
                                                            (rows, cols))
    dense[[4, 9], :] = 0.0
    dense[11, : cols // 2] = rng.uniform(0.1, 2.0, cols // 2)
    dense[:, cols - 40:] = 0.0
    return sp.csr_matrix(dense)


def _rectangular_halves(mat):
    """The block as a valued and as a row-scaled value-free ELL half, and
    as a COO half."""
    rows, cols = mat.shape
    binary = (mat != 0).astype(np.float64)
    deg = np.asarray(binary.sum(axis=1)).ravel()
    scale = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    coo = sp.coo_matrix(mat)
    order = np.lexsort((coo.col, coo.row))
    return {
        "ell_valued": (_build_half(mat), mat),
        "ell_value_free": (_build_half(binary, scale, "post"),
                           sp.diags(scale.astype(np.float32)) @ binary),
        "coo": (make_coo_half(coo.row[order], coo.col[order],
                              coo.data[order], rows, num_cols=cols), mat),
    }


@pytest.mark.parametrize("kind", ("ell_valued", "ell_value_free", "coo"))
def test_rectangular_half_matches_scipy(kind):
    """A ``[rows, cols]`` half gathers a ``[cols, d]`` operand and takes a
    ``[rows, d]`` residual; the plain versions against scipy (f32 sums)."""
    mat = _rectangular()
    half, ref_mat = _rectangular_halves(mat)[kind]
    assert (half.num_rows, half.num_cols) == mat.shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=(mat.shape[1], 6)).astype(np.float32)
    z = rng.normal(size=(mat.shape[0], 6)).astype(np.float32)
    alpha, beta = (1.0, 0.0, 1.0, 0.0, 0.5, 1.0), (-1.0, 1.0, 2.0, 1.0, 1.0, -1.0)
    spmm_fn = coo_spmm if kind == "coo" else row_gather_spmm
    got = spmm_fn(half, torch.from_numpy(x), z=torch.from_numpy(z),
                  alpha=alpha, beta=beta)
    want = np.asarray(alpha) * z + np.asarray(beta) * (ref_mat @ x)
    assert_close(got, torch.from_numpy(want.astype(np.float32)),
                 int(np.diff(mat.indptr).max()) + 1, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("ell_valued", "ell_value_free", "coo"))
@pytest.mark.parametrize("width", (4, 7, 8))
def test_rectangular_half_card_matches_plain(cuda, kind, width):
    """K1 and K5 on a rectangular half: operand rows != output rows."""
    half, _ = _rectangular_halves(_rectangular())[kind]
    half = half.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(width)
    x = torch.randn(half.num_cols, width, generator=gen, device=cuda)
    z = torch.randn(half.num_rows, width, generator=gen, device=cuda)
    alpha = tuple(float(j % 2) for j in range(width))
    beta = tuple(-1.0 if j % 2 else 1.0 for j in range(width))
    if kind == "coo":
        got = coo_spmm(half, x, z=z, alpha=alpha, beta=beta)
        want = coo_spmm_plain(half, x, z, alpha, beta)
    else:
        got = row_gather_spmm(half, x, z=z, alpha=alpha, beta=beta)
        want = row_gather_spmm_plain(half, x, z, alpha, beta)
    torch.cuda.synchronize()
    assert got.shape == (half.num_rows, width)
    assert_close(got, want, 250, kind)


def _halo_inputs(width, with_scale, with_sign, device, rows=1000, n_dest=4,
                 halo_pad=64):
    gen = torch.Generator().manual_seed(width)
    x = torch.randn(rows, width, generator=gen) * 100
    pre = torch.rand(rows, generator=gen) if with_scale else None
    sign = ([(-1.0) ** j for j in range(width)] if with_sign else None)
    send_idx = torch.randint(0, rows, (n_dest, halo_pad), generator=gen,
                             dtype=torch.int32)
    return (x.to(device), None if pre is None else pre.to(device), sign,
            send_idx.to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("padded", (False, True))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width", (4, 7, 8, 12, 64, 300))
@pytest.mark.parametrize("with_scale,with_sign", [(False, False), (True, False),
                                                  (False, True), (True, True)])
def test_k6_matches_plain(cuda, dtype, width, with_scale, with_sign, padded):
    """K6 against its plain version bit for bit: one f32 multiply per
    factor, one rounding into the gather dtype, and the send rows copied
    from the same values; into contiguous rows and into K1's row-padded
    layout (``k1_operand_ld``), whose padding it writes as 0 (the buffers
    start as NaN, and are compared whole)."""
    x, pre, sign, send_idx = _halo_inputs(width, with_scale, with_sign, cuda)
    ld = k1_operand_ld(width, dtype) if padded else width
    bufs = [torch.full((x.shape[0], ld), float("nan"), dtype=dtype,
                       device=cuda) for _ in range(3)]
    own, own_plain, alone = (b[:, :width] for b in bufs)
    send = halo_pack(x, own, pre_scale=pre, sign=sign, send_idx=send_idx,
                     ld=ld)
    send_plain = halo_pack_plain(x, own_plain, pre, sign, send_idx, ld=ld)
    assert halo_pack(x, alone, pre_scale=pre, sign=sign, ld=ld) is None
    torch.cuda.synchronize()
    assert torch.equal(bufs[0], bufs[1]) and torch.equal(bufs[2], bufs[1])
    assert send.shape == (send_idx.numel(), width)
    assert send.stride(0) == ld
    assert torch.equal(padded_rows(send), padded_rows(send_plain))
    assert not bufs[0][:, width:].float().any()
    if padded and ld > width:   # a padded view the caller did not declare
        with pytest.raises(ValueError, match="pass ld"):
            halo_pack(x, own, pre_scale=pre, sign=sign)


# ---------------------------------------------------------------------------
# What K1, K5 and K4 rely on, checked without a card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", K1_KINDS)
@pytest.mark.parametrize("width", (4, 7, 8, 12, 20, 32, 64, 128, 600))
@pytest.mark.parametrize("form", K1_FORMS)
def test_k1_replay_matches_plain(kind, width, form):
    """K1's summation order replayed in either form (narrow: lane groups,
    butterflies, the hub rows' warp partials; wide: each column's entries
    in order, the hub rows' warp partials) sums the same terms as the
    plain version, on both halves, with a per-column epilogue."""
    mat = _k1_matrix(kind)
    op = make_ell_op(mat)
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(op.num_nodes, width))
                         .astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(op.num_nodes, width))
                         .astype(np.float32))
    alpha = tuple(float(j % 2) for j in range(width))
    beta = tuple(-1.0 if j % 2 else 2.0 for j in range(width))
    csr = sp.csr_matrix(mat)
    n_terms = int(max(np.diff(csr.indptr).max(),
                      np.diff(csr.T.tocsr().indptr).max())) + 1
    for half in (op.fwd, op.bwd):
        assert_close(k1_order_replay(half, x, z, alpha, beta, form=form),
                     row_gather_spmm_plain(half, x, z, alpha, beta),
                     n_terms, f"{kind} w{width} {form}")


@pytest.mark.parametrize("kind", ("weighted", "symnorm", "hub"))
def test_k1_wide_replay_sums_each_column_in_entry_order(kind):
    """The wide form's replay, written out for one column: a non-hub
    row's entries added in order from 0, a hub row's warp w adding
    entries w, w+8, ... and the 8 partials added in warp order; equal bit
    for bit (f32 values and operand)."""
    op = make_ell_op(_k1_matrix(kind))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(op.num_nodes, 1))
                         .astype(np.float32))
    for half in (op.fwd, op.bwd):
        got = k1_order_replay(half, x, None, (0.0,), (1.0,), form="wide")
        indptr, idx = half.indptr.numpy(), half.indices.numpy()
        vals = None if half.vals is None else half.vals.numpy()
        want = np.zeros(half.num_rows, np.float32)
        for i in range(half.num_rows):
            e = np.arange(indptr[i], indptr[i + 1])
            t = x.numpy()[idx[e], 0]
            if vals is not None:
                t = (t * vals[e]).astype(np.float32)
            if i < half.lane_classes[0]:
                parts = [np.float32(0)] * 8
                for j, tj in enumerate(t):
                    parts[j % 8] = np.float32(parts[j % 8] + tj)
                s = parts[0]
                for p in parts[1:]:
                    s = np.float32(s + p)
            else:
                s = np.float32(0)
                for tj in t:
                    s = np.float32(s + tj)
            want[half.row_ids[i]] = s
        if half.row_scale is not None:
            want = (want * half.row_scale.numpy()).astype(np.float32)
        np.testing.assert_array_equal(got[:, 0].numpy(), want)
    if kind == "hub":
        assert op.fwd.lane_classes[0] > 0


def test_k1_form_keeps_the_headline_and_genius_widths_narrow():
    """Every width K1 runs on the headline and genius paths (w4, w7, w8,
    w12; bf16 and f32) takes the narrow form, and the wide rows of
    penn94_pp and wiki (bf16 w64, w128, w600, w4814) the wide one, with
    the crossover ``K1_WIDE_BYTES`` between them."""
    for dtype in (torch.bfloat16, torch.float32):
        for width in (4, 7, 8, 12):
            assert k1_form(width, dtype) == "narrow"
    for width in (64, 128, 600, 4814):
        assert k1_form(width, torch.bfloat16) == "wide"
    assert 48 < K1_WIDE_BYTES <= 128


@pytest.mark.parametrize("kind", ("weighted", "symnorm"))
@pytest.mark.parametrize("width", (4, 7, 8, 32, 64, 128, 600))
@pytest.mark.parametrize("form", K1_FORMS)
def test_k1_replay_matches_plain_with_bf16_values(kind, width, form):
    """On valued halves in bf16 (the gather dtype) the replay (either
    form) and the plain version round each term ``v·x`` to bf16 before
    the f32 sum, as K1 does: they agree to the tolerance, and both part
    from the sum of unrounded products by more than their own
    difference."""
    op = make_ell_op(_k1_matrix(kind), gather_dtype=torch.bfloat16)
    assert op.fwd.vals.dtype == torch.bfloat16
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(op.num_nodes, width))
                         .astype(np.float32)).to(torch.bfloat16)
    ones, zeros = (1.0,) * width, (0.0,) * width
    for half in (op.fwd, op.bwd):
        replay = k1_order_replay(half, x, None, zeros, ones, form=form)
        plain = row_gather_spmm_plain(half, x, None, zeros, ones)
        exact = row_gather_spmm_plain(
            dataclasses.replace(half, vals=half.vals.float()), x, None,
            zeros, ones)
        assert_close(replay, plain, 64, f"{kind} w{width}")
        assert float((replay - plain).abs().max()) < \
            float((plain - exact).abs().max())


def _sorted_lanes(half):
    """Lanes of each sorted row, read from the half's class table."""
    cls = np.searchsorted(np.asarray(half.lane_classes),
                          np.arange(half.num_rows), side="right")
    return np.asarray(K1_LANES)[cls]


def _row_lanes(half):
    """Lanes K1 gives each output row of a half."""
    out = np.empty(half.num_rows, np.int64)
    out[half.row_ids.numpy()] = _sorted_lanes(half)
    return out


@pytest.mark.parametrize("kind", K1_KINDS)
def test_k1_lane_classes_cover_the_rows_once(kind):
    """Each half's class table splits its sorted rows into consecutive
    ranges, one per entry of ``K1_LANES``, that cover every row once; each
    row's range is the one ``k1_lanes`` gives its degree; a half sharing
    the forward structure shares its table."""
    op = make_ell_op(_k1_matrix(kind))
    halves = [op.fwd, op.bwd]
    halves += [_build_half(_rectangular(), None, "post")]
    for half in halves:
        ends = np.asarray(half.lane_classes)
        assert len(ends) == len(K1_LANES)
        assert ends[-1] == half.num_rows
        assert np.all(np.diff(np.concatenate([[0], ends])) >= 0)
        sizes = np.diff(np.concatenate([[0], ends]))
        assert sizes.sum() == half.num_rows
        deg = np.diff(half.indptr.numpy())
        np.testing.assert_array_equal(_sorted_lanes(half), k1_lanes(deg))
    if op.bwd is not op.fwd and op.bwd.indptr is op.fwd.indptr:
        assert op.bwd.lane_classes == op.fwd.lane_classes
    if kind == "hub":
        assert all(np.any(_sorted_lanes(op.fwd) == g)
                   for g in (K1_LANES[0], 1))


@pytest.mark.parametrize("exchange", ("allgather", "halo"))
@pytest.mark.parametrize("kind", ("lowpass_sym", "lowpass_directed", "hub"))
def test_k1_lane_groups_follow_the_degree_on_local_halves(kind, exchange):
    """Every row gets the lane group of its degree, in the whole half and
    in each rank's local half (rectangular, over the receive buffer), so
    K1 sums each row of a rank in the single-chip order."""
    mat = row_normalized_adjacency(_k1_matrix(kind))
    whole = make_ell_op(mat)
    ops, bnd = make_sharded_ell_op(mat, 4, None, exchange=exchange)
    for tr in (False, True):
        half = whole.bwd if tr else whole.fwd
        lanes = _row_lanes(half)
        deg = np.zeros(half.num_rows, np.int64)
        deg[half.row_ids.numpy()] = np.diff(half.indptr.numpy())
        np.testing.assert_array_equal(lanes, k1_lanes(deg))
        for p, op in enumerate(ops):
            local = op.bwd if tr else op.fwd
            r0, r1 = int(bnd[p]), int(bnd[p + 1])
            got = _row_lanes(local)
            np.testing.assert_array_equal(got[: r1 - r0], lanes[r0:r1])
            assert np.all(got[r1 - r0:] == 1)   # padding rows, degree 0


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width", (4, 7, 8, 12, 20, 4814))
def test_k1_operand_layout(dtype, width):
    """K1's operand: the values of ``x.to(dtype)`` (pre-scaled in f32 and
    rounded once where a pre-scale is given) at row stride
    ``k1_operand_ld`` (rows of < 32 bytes padded to a power of two of
    bytes, rows of the wide form to a multiple of 16 bytes: bf16 w4814
    takes 9,632 bytes); K1 on the padded view sums what it sums on the
    contiguous operand."""
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(700, width)).astype(np.float32))
    pre = torch.from_numpy(rng.random(700).astype(np.float32))
    for scale, want in ((None, x.to(dtype)),
                        (pre, (x * pre[:, None]).to(dtype))):
        got = k1_operand(x, dtype, scale)
        ld = k1_operand_ld(width, dtype)
        assert got.shape == x.shape and got.dtype == dtype
        assert got.stride() == (ld, 1)
        assert torch.equal(got, want)
        row_bytes = ld * got.element_size()
        if k1_form(width, dtype) == "wide":
            assert row_bytes % 16 == 0
            assert row_bytes - width * got.element_size() < 16
            assert got.data_ptr() % 16 == 0
        else:
            assert row_bytes >= 32 or row_bytes & (row_bytes - 1) == 0
    if width == 4814:
        assert k1_operand_ld(width, torch.bfloat16) * 2 == 9632
    half = make_ell_op(_matrices()["lowpass_sym"]).fwd
    xg = k1_operand(x, dtype)
    assert torch.equal(row_gather_spmm(half, xg),
                       row_gather_spmm(half, xg.contiguous()))


def _hub_matrix(n=120, seed=0):
    """A hub row of degree n-1, rows without triplets, uneven values
    (``n=700``: a hub row of 699 nonzeros spans three or more slices of
    ``SLICE_NNZ``)."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < 0.05) * rng.uniform(0.1, 2.0, (n, n))
    dense[3, :] = rng.uniform(0.1, 2.0, n)
    dense[[7, 8, 50, n - 1], :] = 0.0
    return sp.csr_matrix(dense)


@pytest.mark.parametrize("kind", ("lowpass_sym", "lowpass_directed",
                                  "weighted", "hub", "wide_hub"))
@pytest.mark.parametrize("slice_nnz", (1, 4, 16, SLICE_NNZ))
def test_coo_half_partition_matches_its_definition(kind, slice_nnz):
    """K5's host partition against a row-by-row definition: a row whose
    triplets lie in more than one slice is a spanning row with its first
    and last slice, a row without one is listed as empty, and no slice
    starts or ends more than one spanning row (the carry buffer holds one
    head and one tail partial per slice)."""
    mat = (_hub_matrix() if kind == "hub" else _hub_matrix(700)
           if kind == "wide_hub" else _matrices()[kind])
    half = _coo_half(mat, slice_nnz)
    slices = np.arange(half.nnz) // slice_nnz
    row = half.row.numpy()
    spans, empty = {}, []
    for r in range(half.num_rows):
        own = slices[row == r]
        if own.size == 0:
            empty.append(r)
        elif own.min() != own.max():
            spans[r] = (int(own.min()), int(own.max()))
    assert half.empty_rows.tolist() == empty
    got = dict(zip(half.span_rows.tolist(),
                   zip(half.span_first.tolist(), half.span_last.tolist())))
    assert got == spans
    firsts = [f for f, _ in spans.values()]
    lasts = [last for _, last in spans.values()]
    assert len(set(firsts)) == len(firsts) and len(set(lasts)) == len(lasts)
    if kind == "wide_hub":
        assert np.bincount(row).max() > 2 * SLICE_NNZ
    if kind.endswith("hub") and np.bincount(row).max() > 2 * slice_nnz:
        assert max(last - f for f, last in spans.values()) >= 2


def _row_block(whole, r0: int):
    """Rows ``r0:`` of a COO half as a half of their own that keeps the
    whole half's slice grid, and where its first triplet sits in it."""
    lo = int(np.searchsorted(whole.row.numpy(), r0))
    block = make_coo_half(whole.row.numpy()[lo:] - r0, whole.col.numpy()[lo:],
                          whole.val.numpy()[lo:], whole.num_rows - r0,
                          slice_nnz=whole.slice_nnz, num_cols=whole.num_cols,
                          nnz_offset=lo)
    return block, lo


def _coo_half(mat, slice_nnz=SLICE_NNZ):
    """The forward half of ``make_coo_op(mat)`` cut into slices of
    ``slice_nnz``."""
    half = make_coo_op(mat).fwd
    return make_coo_half(half.row.numpy(), half.col.numpy(),
                         half.val.numpy(), half.num_rows, slice_nnz=slice_nnz)


@pytest.mark.parametrize("slice_nnz", (1, 4, 16, SLICE_NNZ))
@pytest.mark.parametrize("r0", (1, 4, 37, 101))
def test_coo_row_block_keeps_the_whole_slice_grid(r0, slice_nnz):
    """A block of rows built with ``nnz_offset`` cuts its slices where the
    whole half does: the same spanning rows over the same slices (shifted
    by the slices before the block) and the same empty rows."""
    whole = _coo_half(_hub_matrix(), slice_nnz)
    block, lo = _row_block(whole, r0)
    shift = lo // whole.slice_nnz
    keep = whole.span_rows.numpy() >= r0
    assert block.span_rows.numpy().tolist() == (
        whole.span_rows.numpy()[keep] - r0).tolist()
    assert (block.span_first.numpy() + shift).tolist() == \
        whole.span_first.numpy()[keep].tolist()
    assert (block.span_last.numpy() + shift).tolist() == \
        whole.span_last.numpy()[keep].tolist()
    empty = whole.empty_rows.numpy()
    assert block.empty_rows.numpy().tolist() == (empty[empty >= r0]
                                                  - r0).tolist()
    assert block.n_slices == whole.n_slices - shift


def _auc_inputs(kind: str, n: int, seed: int = 0, n_masks: int = 2):
    """``(scores [B, N], labels, masks)``; "saturated" holds one tie group
    of 70% of the nodes (spanning many tiles), "quantised" many groups,
    "equal" one group of every node; "multilabel" three score columns."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    masks = tuple(rng.random(n) < 0.25 for _ in range(n_masks))
    scores = rng.random(n).astype(np.float32)
    if kind == "saturated":
        scores[rng.random(n) < 0.7] = 1.0
    elif kind == "quantised":
        scores = np.round(scores * 20) / 20
    elif kind == "equal":
        scores[:] = 0.5
    elif kind == "multilabel":
        labels = (rng.random((n, 3)) < 0.3).astype(np.int64)
        scores = np.round(rng.normal(size=(3, n)), 1).astype(np.float32)
        return scores, labels, masks
    return scores[None], labels, masks


def _sorted_inputs(kind, n, seed=0, n_masks=2, device="cpu"):
    """``(s_sorted, order, packed)`` of ``_auc_inputs`` on ``device``."""
    scores, labels, masks = _auc_inputs(kind, n, seed, n_masks)
    packed = pack_labels_and_masks(
        torch.from_numpy(labels).to(device),
        tuple(torch.from_numpy(m).to(device) for m in masks))
    order, s_sorted = sort_scores(torch.from_numpy(scores).to(device))
    return s_sorted, order, packed


AUC_KINDS = ("random", "saturated", "quantised", "equal", "multilabel")


@pytest.mark.parametrize("kind", AUC_KINDS)
def test_rank_pass_counts_are_exact(kind):
    """The ``[B, M, 3]`` counts K4 is held to, from its plain version: each
    score column's and mask's positives, negatives and twice the positives'
    average-rank sum, exactly as scipy ranks the masked subset."""
    from scipy.stats import rankdata

    scores, labels, masks = _auc_inputs(kind, 700)
    packed = pack_labels_and_masks(torch.from_numpy(labels),
                                   tuple(torch.from_numpy(m) for m in masks))
    order, s_sorted = sort_scores(torch.from_numpy(scores))
    got = auc_rank_pass_plain(s_sorted, order, packed, 2).numpy()
    lab = labels.reshape(700, -1).T
    for b in range(scores.shape[0]):
        for m, mask in enumerate(masks):
            pos = lab[b][mask] == 1
            rank2 = 2 * rankdata(scores[b][mask], method="average")
            assert got[b, m].tolist() == [int(pos.sum()), int((~pos).sum()),
                                          int(rank2[pos].sum())]


@pytest.mark.parametrize("kind", AUC_KINDS)
@pytest.mark.parametrize("tile", (1, 3, 7, 1024))
@pytest.mark.parametrize("n", (1, 2, 700))
def test_k4_tile_replay_equals_plain(kind, tile, n):
    """K4's one-pass algebra (per-tile statistics, then the finish over
    tiles) gives the plain version's counts exactly, at tiles of 1 node
    (every node its own tile) up to one tile for all, with tie groups
    that span many tiles ("saturated", "equal"), for 1 to 7 masks."""
    for n_masks in (1, 2, 3, MAX_MASKS):
        s_sorted, order, packed = _sorted_inputs(kind, n, seed=n + tile,
                                                 n_masks=n_masks)
        assert torch.equal(
            k4_tile_replay(s_sorted, order, packed, n_masks, tile),
            auc_rank_pass_plain(s_sorted, order, packed, n_masks)), n_masks


def test_k4_tile_sizes_are_compiled():
    """``K4_TILE`` is one of the swept ``K4_TILES``, the tile sizes
    rocauc.cu compiles."""
    src = (REPO / "acmgnn_tpu_torch" / "csrc" / "rocauc.cu").read_text()
    body = src[src.index("bool has_tile"):]
    body = body[:body.index("}")]
    assert sorted(map(int, re.findall(r"tile == (\d+)", body))) == \
        sorted(K4_TILES)
    assert K4_TILE in K4_TILES


# ---------------------------------------------------------------------------
# K5 and K4 on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("lowpass_sym", "binary_sym",
                                  "lowpass_directed", "weighted", "hub"))
@pytest.mark.parametrize("width,hp", [(12, None), (8, (0, 0, 1, 1, 0, 0, 1, 1)),
                                      (4, (0, 0, 1, 1)), (3, None)])
def test_k5_matches_plain(cuda, kind, width, hp):
    """Both halves (forward and transpose triplets), with hub rows that
    span many slices and rows without a triplet; two launches agree bit
    for bit (no atomics)."""
    mat = _hub_matrix(3000) if kind == "hub" else _matrices()[kind]
    op = make_coo_op(mat).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(width)
    z = torch.randn(op.num_nodes, width, generator=gen, device=cuda)
    alpha = beta = None
    if hp is not None:
        alpha = [float(h) for h in hp]
        beta = [-1.0 if h else 1.0 for h in hp]
    csr = sp.csr_matrix(mat)
    n_terms = int(max(np.diff(csr.indptr).max(),
                      np.diff(csr.T.tocsr().indptr).max()))
    for half in (op.fwd, op.bwd):
        got = coo_spmm(half, z, z=z, alpha=alpha, beta=beta)
        again = coo_spmm(half, z, z=z, alpha=alpha, beta=beta)
        want = coo_spmm_plain(half, z, z if hp else None,
                              tuple(alpha or (0.0,) * width),
                              tuple(beta or (1.0,) * width))
        torch.cuda.synchronize()
        assert_close(got, want, n_terms, f"{kind} w{width}")
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("r0", (1, 4, 1777))
@pytest.mark.parametrize("width", (4, 8, 12))
@pytest.mark.parametrize("slice_nnz", (16, 100, SLICE_NNZ))
def test_k5_row_block_sums_as_the_whole(cuda, r0, width, slice_nnz):
    """K5 on a block of rows with its ``nnz_offset`` gives the whole
    half's rows bit for bit (a rank's block of a sharded operator), also
    at slice sizes that are no multiple of a warp."""
    whole = _coo_half(_hub_matrix(3000), slice_nnz)
    block, _ = _row_block(whole, r0)
    x = torch.randn(whole.num_cols, width,
                    generator=torch.Generator(device=cuda).manual_seed(r0),
                    device=cuda)
    got = coo_spmm(block.to(cuda), x)
    want = coo_spmm(whole.to(cuda), x)[r0:]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _assert_aucs(got, want, multilabel):
    """K4's f32 AUCs against the plain version's: NaN in the same places,
    bit-equal for one score column, within 1 f32 ulp for a multilabel
    mean."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    if not multilabel:
        assert torch.equal(got[ok], want[ok])
    ulp = torch.nextafter(want[ok].abs(), torch.tensor(float("inf"))) \
        - want[ok].abs()
    assert bool(((got[ok] - want[ok]).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", AUC_KINDS)
@pytest.mark.parametrize("n", (1, 2, K4_TILE - 1, K4_TILE, K4_TILE + 1,
                               1000, 50_000))
def test_k4_matches_plain(cuda, kind, n):
    """One K4 launch a call: counts equal to the plain version's for 1 to
    7 masks, AUCs as ``_assert_aucs``."""
    multilabel = kind == "multilabel"
    for n_masks in range(1, MAX_MASKS + 1):
        s_sorted, order, packed = _sorted_inputs(kind, n, seed=n,
                                                 n_masks=n_masks,
                                                 device=cuda)
        kernels.reset_launches()
        got = auc_rank_pass(s_sorted, order, packed, n_masks)
        counts, aucs = rocauc_from_sorted(s_sorted, order, packed, n_masks,
                                          multilabel)
        torch.cuda.synchronize()
        assert kernels.launches[f"k4_auc_m{n_masks}"] == 2
        want, want_aucs = rocauc_from_sorted_plain(s_sorted, order, packed,
                                                   n_masks)
        assert torch.equal(got.cpu(), want.cpu()), n_masks
        assert torch.equal(counts.cpu(), want.cpu()), n_masks
        _assert_aucs(aucs, want_aucs, multilabel)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", K4_TILES)
@pytest.mark.parametrize("kind", ("saturated", "multilabel"))
def test_k4_every_tile_size_matches_plain(cuda, tile, kind):
    """Each compiled tile size (the sweep's), on a ragged N."""
    s_sorted, order, packed = _sorted_inputs(kind, 3 * tile + 5, seed=tile,
                                             n_masks=3, device=cuda)
    counts, aucs = k4_launch(s_sorted, order, packed, 3, tile)
    want, want_aucs = rocauc_from_sorted_plain(s_sorted, order, packed, 3)
    torch.cuda.synchronize()
    assert torch.equal(counts.cpu(), want.cpu())
    _assert_aucs(aucs, want_aucs, kind == "multilabel")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("saturated", "multilabel"))
def test_k4_repeats_and_replays_in_a_cuda_graph(cuda, kind):
    """Two launches give the same bits; a CUDA graph of the call, replayed
    twice, gives the eager call's bits each time (the tickets are back at
    zero after every launch)."""
    multilabel = kind == "multilabel"
    s_sorted, order, packed = _sorted_inputs(kind, 50_000, seed=5,
                                             n_masks=3, device=cuda)
    first = rocauc_from_sorted(s_sorted, order, packed, 3, multilabel)
    again = rocauc_from_sorted(s_sorted, order, packed, 3, multilabel)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int8) if a.is_floating_point() else a,
                           b.view(torch.int8) if b.is_floating_point() else b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rocauc_from_sorted(s_sorted, order, packed, 3, multilabel)
    for _ in range(2):
        for t in captured:
            t.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, first):
            assert torch.equal(
                a.view(torch.int8) if a.is_floating_point() else a,
                b.view(torch.int8) if b.is_floating_point() else b)


# ---------------------------------------------------------------------------
# K7: the panel gather (tools/pallas_gather_probe.py's P1 / P2)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("p", (8, 512, 1000, 4096, 16 * SMEM_BYTES // 512 + 1))
@pytest.mark.parametrize("d", (128, 7))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("per_row", (False, True))
@pytest.mark.parametrize("form", (None, "l2"))
def test_k7_matches_plain(cuda, p, d, dtype, per_row, form):
    """K7 equal to its plain version bit for bit (a gather copies bits),
    on a ragged M (no multiple of any warp's row range) and on indices
    that differ across a row for the per-element form; in the host plan's
    form (a panel one block holds: the block form; larger: L2, up to a
    panel no cluster of 16 blocks' shared memory would hold) and in the
    L2 form."""
    gen = torch.Generator(device=cuda).manual_seed(p + d)
    m = 10_007
    x = torch.randn(p, d, generator=gen, device=cuda).to(dtype)
    shape = (m,) if per_row else (m, d)
    idx = torch.randint(0, p, shape, generator=gen, device=cuda,
                        dtype=torch.int32)
    kernels.reset_launches()
    got = panel_gather(x, idx) if form is None else _launch(x, idx, form)
    torch.cuda.synchronize()
    assert kernels.launches["K7"] == 1
    assert got.dtype == dtype and got.shape == (m, d)
    assert torch.equal(got, panel_gather_plain(x, idx))


@pytest.mark.gpu
def test_k7_refuses_what_it_cannot_take(cuda):
    """CPU and CUDA operands are not mixed; indices must be int32; the
    per-element indices' vector loads need them 16-byte aligned, so an
    offset view is refused (a per-row view is taken); the block form is
    refused for a panel a block cannot hold, naming its bytes."""
    idx = torch.zeros(16, dtype=torch.int32, device=cuda)
    x = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="CUDA"):
        panel_gather(x, idx)
    with pytest.raises(ValueError, match="CUDA"):
        panel_gather(x.to(cuda), idx.cpu())
    with pytest.raises(TypeError, match="int32"):
        panel_gather(x.to(cuda), idx.long())
    xc = x.to(cuda)
    flat = torch.zeros(16 * 8 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        panel_gather(xc, flat[1:].view(16, 8))
    got = panel_gather(xc, idx[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, panel_gather_plain(xc, idx[1:]))
    big = torch.zeros(SMEM_BYTES // 32 + 1, 8, device=cuda)
    with pytest.raises(ValueError, match=f"{big.numel() * 4} bytes"):
        _launch(big, idx, "block")
    assert panel_plan(*big.shape, 4) == "l2"


@pytest.mark.gpu
def test_bf16_gemm_card_matches_cpu_formula(cuda):
    """The bf16 GEMM's Function on the card (``torch.mm`` with an f32
    result) against its CPU formula (bf16 values multiplied as f32):
    output and gradients within ``1e-5·sqrt(K)·Σ|terms|`` (the same exact
    products summed in other orders), plus one bf16 step (2^-7 relative)
    on the gradients, whose rounding to bf16 a last-bit difference can
    flip."""
    rng = np.random.default_rng(9)
    a = rng.normal(size=(3000, 96)).astype(np.float32)
    w = rng.normal(size=(96, 64)).astype(np.float32)
    g = rng.normal(size=(3000, 64)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        ta = torch.from_numpy(a).to(dev).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        out = bf16_matmul(ta, tw)
        out.backward(torch.from_numpy(g).to(dev))
        res[str(dev)] = [t.detach().cpu() for t in (out, ta.grad, tw.grad)]
    ab, wb = (torch.from_numpy(t).bfloat16().float().abs() for t in (a, w))
    gabs = torch.from_numpy(g).abs()
    scales = (ab @ wb, gabs @ wb.T, ab.T @ gabs)
    for (got, want), scale, k, rounded in zip(
            zip(res["cuda"], res["cpu"]), scales, (96, 64, 3000),
            (False, True, True)):
        assert got.dtype == torch.float32
        tol = 1e-5 * k ** 0.5 * scale
        if rounded:
            tol = tol + 2.0 ** -7 * want.abs()
            assert torch.equal(got, got.bfloat16().float())
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.gpu
def test_bf16_project_card_equals_separate_products(cuda):
    """``bf16_project`` on the card (one rounding of the operand, one
    widening for every weight's gradient) against one ``bf16_matmul`` a
    weight: products and weight gradients bit for bit, at a width above
    ``HOIST_MAX_COLS`` as penn94's features have."""
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.normal(size=(3000, 160)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(size=(160, 64)).astype(np.float32))
          for _ in range(4)]
    gs = [torch.from_numpy(rng.normal(size=(3000, 64)).astype(np.float32))
          .to(cuda) for _ in ws]
    res = []
    for shared in (True, False):
        ta = a.to(cuda)
        tws = [w.to(cuda).requires_grad_() for w in ws]
        outs = (layers.bf16_project(ta, *tws) if shared
                else [bf16_matmul(ta, w) for w in tws])
        torch.autograd.backward(list(outs), gs)
        res.append([*(o.detach() for o in outs), *(w.grad for w in tws)])
    for got, want in zip(*res):
        assert torch.equal(got, want)
