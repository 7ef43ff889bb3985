"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only the port is
installed.  The kernel tests need an NVIDIA card and skip elsewhere; run
them there with

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py configures JAX).

Tolerance: ``1e-5·sqrt(reduction length)·max(1, max|plain|)``: kernel
and plain version sum the same f32 (or bf16-rounded) terms in different
orders.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from acmgnn_tpu_torch.data.synthetic_scale import twitch_gamers_scale_graph
from acmgnn_tpu_torch.models.layers import (
    attention_mix_backward,
    attention_mix_backward_plain,
    attention_mix_forward,
    attention_mix_forward_plain,
)
from acmgnn_tpu_torch.ops import kernels
from acmgnn_tpu_torch.ops.ell import (
    make_ell_op,
    row_gather_spmm,
    row_gather_spmm_plain,
)
from acmgnn_tpu_torch.ops.graph import GraphData, row_normalized_adjacency
from acmgnn_tpu_torch.ops.spmm import spmm_multi
from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import (
    build_model,
    make_split_runner,
    prepare_data,
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
    }


def _attention_inputs(n, d, device):
    gen = torch.Generator().manual_seed(d)
    hs = [torch.relu(torch.randn(n, d, generator=gen)) for _ in range(3)]
    hs[2][:5] = 0.0                        # var == 0 rows
    hs[1][5:9, :] = 0.5                     # flat rows: var == 0, r ~ 316
    v = torch.randn(3, d, generator=gen)
    c = torch.randn(3, generator=gen)
    W = torch.rand(3, 3, generator=gen) * 2 - 1
    gout = torch.randn(n, d, generator=gen)
    return [t.to(device) for t in (*hs, v, c, W, gout)]


def test_wrappers_refuse_a_device_without_kernel():
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise, never fall back."""
    op = make_ell_op(_matrices()["lowpass_sym"])
    x = torch.empty(op.num_nodes, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        row_gather_spmm(op.fwd, x)
    h0, h1, h2, v, c, W, gout = _attention_inputs(20, 4, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention_mix_forward(h0, h1, h2, v, c, W, True, 3.0)
    with pytest.raises(ValueError, match="CUDA"):
        attention_mix_backward(h0, h1, h2, gout, v, c, W, True, 3.0)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ("lowpass_sym", "binary_sym",
                                  "lowpass_directed", "weighted"))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("width,hp", [(7, None), (8, (0, 0, 1, 1, 0, 0, 1, 1)),
                                      (4, (0, 0, 1, 1)), (20, None)])
def test_k1_matches_plain(cuda, kind, dtype, width, hp):
    mat = _matrices()[kind]
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
@pytest.mark.parametrize("use_ln", (False, True))
@pytest.mark.parametrize("d", (2, 7, 64, 100))
def test_k2_k3_match_plain(cuda, d, use_ln):
    h0, h1, h2, v, c, W, gout = _attention_inputs(3000, d, cuda)
    args = (h0, h1, h2, v, c, W, use_ln, 3.0)
    assert_close(attention_mix_forward(*args),
                 attention_mix_forward_plain(*args), d, "K2")
    bargs = (h0, h1, h2, gout, v, c, W, use_ln, 3.0)
    for i, (a, b) in enumerate(zip(attention_mix_backward(*bargs),
                                   attention_mix_backward_plain(*bargs))):
        assert_close(a, b, d, f"K3 output {i}")


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
                "k3_attn_bwd_d16": it, "k3_attn_bwd_d2": it}
    for k, ref in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][k].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
