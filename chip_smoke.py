#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (acmgnn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. Environment: card name and power limit (nvidia-smi), toolchain, and a
   parallel ``nvcc`` build of every kernel source under
   ``acmgnn_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version at the main path's shapes
   on the twitch-gamers-shaped operator (N=168,114, nnz=13,759,942): K1 at
   widths 7, 8 (high-pass epilogue) and 4 (transpose half), K2/K3 at
   d=64 and d=2; max error against the stated tolerance, kernel ms, plain
   ms, one PyTorch library call's ms where one computes the same product.
3. The main path: ``prepare_data``, ``build_model`` and ``run_joint`` of
   the headline ACM-GCN+ configuration at full width (hidden 64, bf16
   gathers), warm-up then timed epochs; steady ms/epoch, finite losses,
   and every kernel's launch count against the count the path implies;
   then a short torch.profiler window: device time by kernel group and
   the device's busy share.
4. Card against CPU on a small graph (dropout 0, f32 gathers, 20 epochs):
   final parameters and split results agree.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
WARM_EPOCHS, TIMED_EPOCHS, PROFILE_EPOCHS = 2, 10, 4


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, scale_terms: int, what: str):
    """Max |got - want| against 1e-5·sqrt(reduction length)·max(1, |want|)."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * scale_terms ** 0.5 * max(1.0, float(want.abs().max()))
    ok = err <= tol and bool(torch.isfinite(got).all())
    print(f"  {what}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its plain version")
    return err


def phase_environment():
    import torch

    from acmgnn_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {nvcc[-1]}")
    secs = kernels.build()
    print(f"[1] built {', '.join(kernels.SOURCES)} in {secs:.1f} s")
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in kernels.SOURCES:
        kernels.library(name)


def phase_kernels(adj, feats):
    """Each kernel against its plain version at the main path's shapes."""
    import scipy.sparse as sp
    import torch

    from acmgnn_tpu_torch.data.registry import row_normalize_features
    from acmgnn_tpu_torch.models import layers
    from acmgnn_tpu_torch.ops.ell import row_gather_spmm, \
        row_gather_spmm_plain
    from acmgnn_tpu_torch.ops.graph import (
        precompute_operators,
        row_normalized_adjacency,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    op = precompute_operators(adj, spmm_dtype=torch.bfloat16).adj_low.to(dev)
    n, nnz = op.num_nodes, op.nnz
    max_deg = int((op.fwd.indptr[1:] - op.fwd.indptr[:-1]).max())
    print(f"[2] operator N={n} nnz={nnz} max row {max_deg} "
          f"(host build {time.perf_counter() - t0:.1f} s)")
    a_hat = sp.csr_matrix(row_normalized_adjacency(adj), dtype=np.float32)
    a_lib = torch.sparse_csr_tensor(
        torch.from_numpy(a_hat.indptr.astype(np.int64)),
        torch.from_numpy(a_hat.indices.astype(np.int64)),
        torch.from_numpy(a_hat.data), size=a_hat.shape,
        check_invariants=False).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    x7 = torch.from_numpy(row_normalize_features(feats)).to(dev)
    hp8 = (0, 0, 1, 1, 0, 0, 1, 1)   # [zL_tr, zH_tr, zL_ev, zH_ev]
    hp4 = hp8[:4]
    z8 = torch.randn(n, 8, generator=gen, device=dev)
    g4 = torch.randn(n, 4, generator=gen, device=dev)
    sign4 = torch.tensor([-1.0 if h else 1.0 for h in hp4], device=dev)
    x4 = ((g4 * sign4).to(torch.bfloat16).float()
          * op.bwd.pre_scale[:, None]).to(torch.bfloat16)
    cases = [
        # name, half, operand, z, alpha, beta, replaces
        ("k1_spmm_w7", op.fwd, x7.to(torch.bfloat16), None, None, None,
         "acmgnn_tpu/ops/ell.py:693"),
        ("k1_spmm_w8", op.fwd, z8.to(torch.bfloat16), z8,
         [float(h) for h in hp8], [-1.0 if h else 1.0 for h in hp8],
         "acmgnn_tpu/ops/spmm.py:153"),
        ("k1_spmm_w4", op.bwd, x4, g4, [float(h) for h in hp4],
         [1.0] * 4, "acmgnn_tpu/ops/spmm.py:143"),
    ]
    for name, half, x, z, alpha, beta, replaces in cases:
        d = x.shape[1]
        a = tuple(alpha or (0.0,) * d)
        b = tuple(beta or (1.0,) * d)
        got = row_gather_spmm(half, x, z=z, alpha=alpha, beta=beta)
        want = row_gather_spmm_plain(half, x, z, a, b)
        err = max_err(got, want, max_deg, name)
        ms = time_ms(lambda: row_gather_spmm(half, x, z=z, alpha=alpha,
                                             beta=beta), 50)
        plain_ms = time_ms(
            lambda: row_gather_spmm_plain(half, x, z, a, b), 5)
        xf = x.float()
        lib_ms = time_ms(lambda: torch.sparse.mm(a_lib, xf), 20)
        nbytes = (8 * (n + 1) + 4 * nnz + 4 * n + 2 * n * d + 4 * n * d
                  + (4 * n * d if z is not None else 0)
                  + (4 * n if half.row_scale is not None else 0))
        b_ms, b_by = bound(nbytes, nnz * d + 2 * n * d)
        rows.append(dict(name=name, route="cuda",
                         source="acmgnn_tpu_torch/csrc/spmm.cu",
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f}, "
              f"torch.sparse.mm f32 {lib_ms:.4f}, bound {b_ms:.4f} {b_by})")

    for d in (64, 2):
        hs = [torch.relu(torch.randn(n, d, generator=gen, device=dev))
              for _ in range(3)]
        v = torch.randn(3, d, generator=gen, device=dev)
        c = torch.randn(3, generator=gen, device=dev)
        W = torch.rand(3, 3, generator=gen, device=dev) * 2 - 1
        gout = torch.randn(n, d, generator=gen, device=dev)
        args = (*hs, v, c, W, True, 3.0)
        bargs = (*hs, gout, v, c, W, True, 3.0)
        got = layers.attention_mix_forward(*args)
        err = max_err(got, layers.attention_mix_forward_plain(*args), d,
                      f"k2_attn_fwd_d{d}")
        fwd = dict(
            name=f"k2_attn_fwd_d{d}", err=err,
            ms=time_ms(lambda: layers.attention_mix_forward(*args), 50),
            plain_ms=time_ms(
                lambda: layers.attention_mix_forward_plain(*args), 10),
            bound=bound(16 * n * d, 23 * n * d))
        got = layers.attention_mix_backward(*bargs)
        want = layers.attention_mix_backward_plain(*bargs)
        err = max(max_err(g_, w_, d, f"k3_attn_bwd_d{d}[{i}]")
                  for i, (g_, w_) in enumerate(zip(got, want)))
        bwd = dict(
            name=f"k3_attn_bwd_d{d}", err=err,
            ms=time_ms(lambda: layers.attention_mix_backward(*bargs), 50),
            plain_ms=time_ms(
                lambda: layers.attention_mix_backward_plain(*bargs), 10),
            bound=bound(28 * n * d + 60 * n, 50 * n * d))
        for k in (fwd, bwd):
            rows.append(dict(
                name=k["name"], route="cuda",
                source="acmgnn_tpu_torch/csrc/attention.cu",
                replaces="acmgnn_tpu/models/layers.py:191",
                max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"],
                bound_ms=k["bound"][0], bound_by=k["bound"][1],
                library_ms=None))
            print(f"  {k['name']}: {k['ms']:.4f} ms (plain "
                  f"{k['plain_ms']:.3f}, bound {k['bound'][0]:.4f} "
                  f"{k['bound'][1]})")
    return rows


def _masks(n: int):
    perm = np.random.default_rng(0).permutation(n)
    m = np.zeros((3, n), bool)
    m[0, perm[: n // 2]] = True
    m[1, perm[n // 2: 3 * n // 4]] = True
    m[2, perm[3 * n // 4:]] = True
    return m


def headline_config(**over):
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcnp", hidden=64, dropout=0.5, lr=0.01,
        weight_decay=1e-3, epochs=WARM_EPOCHS, early_stopping=0,
        selection="val_metric", operator_format="ell", ell_hub_threshold=0,
        ell_block=1, spmm_dtype="bfloat16", gemm_dtype="float32",
        joint=True, hoist_first=True), **over))


def phase_main_path(adj, feats, labels):
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    cfg = headline_config()
    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    data, ops, x, y, _, nclass = prepare_data(data, cfg)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    model = build_model(cfg, x.shape[1], nclass)
    masks = tuple(torch.from_numpy(m).cuda() for m in _masks(data.num_nodes))
    warm = make_split_runner(model, cfg)
    _, warm_state = warm(ops, x, y, masks, seed=1, return_state=True)
    torch.cuda.synchronize()
    timed = make_split_runner(model, dataclasses.replace(
        cfg, epochs=TIMED_EPOCHS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, state = timed(ops, x, y, masks, seed=2, return_state=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launches)
    iters = warm_state.epoch + state.epoch
    ms_epoch = 1e3 * dt / state.epoch
    losses = torch.cat([warm_state.train_losses, state.train_losses]).cpu()
    print(f"[3] prepare_data {t_prep:.1f} s; {iters} joint iterations; "
          f"steady {ms_epoch:.3f} ms/epoch over {state.epoch} iterations; "
          f"peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"[3] train loss first {float(losses[0]):.5f} last "
          f"{float(losses[-1]):.5f}; best val acc {float(res.val_metric):.4f}"
          f" test acc {float(res.test_metric):.4f}")
    if not torch.isfinite(losses).all():
        fail("non-finite training loss on the main path")
    expected = {
        "k1_spmm_w7": iters + 1,     # + the x_agg precompute
        "k1_spmm_w8": iters, "k1_spmm_w4": iters,
        "k2_attn_fwd_d64": 2 * iters, "k2_attn_fwd_d2": 2 * iters,
        "k3_attn_bwd_d64": iters, "k3_attn_bwd_d2": iters,
    }
    print(f"[3] launches {json.dumps(counts, sort_keys=True)}")
    per_epoch = {k: (counts.get(k, 0) - (1 if k == 'k1_spmm_w7' else 0))
                 / iters for k in expected}
    print(f"[3] launches per epoch {json.dumps(per_epoch, sort_keys=True)}")
    if counts != expected:
        fail(f"launch counts {counts} != expected {expected}")
    phase_profile(make_split_runner(model, dataclasses.replace(
        cfg, epochs=PROFILE_EPOCHS)), ops, x, y, masks)
    return counts, ms_epoch


def _kernel_group(name: str) -> str:
    if "spmm_rows_kernel" in name:
        return "K1 spmm"
    if "attn_fwd_kernel" in name:
        return "K2 attention fwd"
    if "attn_bwd_kernel" in name:
        return "K3 attention bwd"
    if any(k in name.lower() for k in ("gemm", "gemv", "cutlass", "xmma",
                                        "sm90_", "splitk")):
        return "cuBLAS GEMM"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "memcpy/memset"
    return "other (ATen elementwise, reductions, Adam)"


def phase_profile(run, ops, x, y, masks):
    """Device time by kernel group over a few steady joint iterations,
    and the device's busy share of that window (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(ops, x, y, masks, seed=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = PROFILE_EPOCHS + 1
    groups: dict = {}
    launches = 0
    top = []
    for e in prof.key_averages():
        if "cuda" not in str(e.device_type).lower():
            continue
        # ranges such as Optimizer.step#Adam.step span kernels counted
        # on their own already
        if getattr(e, "is_user_annotation", False) or "#" in e.key:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
        launches += e.count
        top.append((us, e.count, e.key))
    busy = sum(groups.values())
    if busy == 0:
        print("[3] profile: no device time recorded (not measured)")
        return
    print(f"[3] profile over {iters} iterations (profiler on): wall "
          f"{1e3 * wall / iters:.3f} ms/epoch, device busy "
          f"{busy / 1e3 / iters:.3f} ms/epoch, busy share "
          f"{busy / 1e6 / wall:.3f}, {launches / iters:.0f} device "
          f"operations/epoch")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3 / iters:.4f} ms/epoch "
              f"({us / busy:.3f} of device time)")
    for us, cnt, key in sorted(top, reverse=True)[:10]:
        print(f"    {us / 1e3 / iters:.4f} ms/epoch x{cnt / iters:.0f} "
              f"{key[:90]}")


def phase_card_vs_cpu():
    """Small graph, dropout 0, f32 gathers: the card's kernels against the
    CPU's plain versions from the same initial parameters.  Features are
    made non-negative: with near-zero row sums the row normalization makes
    the fast LayerNorm variance cancel and summation order alone moves two
    runs apart (tests/test_torch_trainer.py)."""
    import torch

    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    adj, feats, labels = twitch_gamers_scale_graph(0, n=2000, pairs=40_000)
    data = GraphData("small", adj, np.abs(feats), labels)
    cfg = headline_config(hidden=16, dropout=0.0, spmm_dtype="float32",
                          epochs=20)
    out = {}
    for device in ("cuda", "cpu"):
        _, ops, x, y, _, nclass = prepare_data(data, cfg, device=device)
        model = build_model(cfg, x.shape[1], nclass, device=device, seed=3)
        masks = tuple(torch.from_numpy(m).to(device)
                      for m in _masks(data.num_nodes))
        res = make_split_runner(model, cfg)(ops, x, y, masks)
        out[device] = (res, {k: p.detach().cpu()
                             for k, p in model.named_parameters()})
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    worst = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"[4] card vs CPU after {cfg.epochs} epochs: max |Δparam| "
          f"{worst:.3e} (tolerance 1e-4); epochs_run {rg.epochs_run}/"
          f"{rc.epochs_run}")
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        a, b = float(getattr(rg, f)), float(getattr(rc, f))
        print(f"  {f}: card {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= 1e-4 * max(1.0, abs(b)):
            fail(f"card and CPU disagree on {f}")
    if worst > 1e-4 or rg.epochs_run != rc.epochs_run:
        fail("card and CPU parameters disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import acmgnn_tpu_torch  # noqa: F401  (fails outside the repo)
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_environment()
    t0 = time.perf_counter()
    adj, feats, labels = twitch_gamers_scale_graph(0)
    print(f"[2] twitch-shaped graph N={adj.shape[0]} edges={adj.nnz} "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = phase_kernels(adj, feats)
    counts, ms_epoch = phase_main_path(adj, feats, labels)
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
    phase_card_vs_cpu()
    print(f"[done] {time.perf_counter() - t_start:.1f} s; main path "
          f"{ms_epoch:.3f} ms/epoch")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
