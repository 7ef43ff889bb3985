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
   d=64 and d=2; max error against the stated tolerance, kernel ms
   (events around a loop of calls) and device ms (events around a
   CUDA-graph replay of the same calls), plain ms, and one PyTorch
   library call's ms and device ms where one computes the same product;
   K1 also at 4, 8 and 16 entries a lane.  K2/K3 take channels before the
   ReLU (with rows that have no positive entry and exact zeros); K3's
   dz_i are held per element, its summed dv, dc and dW per element to
   ``1e-6·max(1, Σ_rows|term|)``, and that check must fail two planted
   faults (one block's partials left out of the sum, dv = 0); K3 must be
   bit-equal across two launches; at d=64 K2/K3 also run at 4, 8 and 16
   lanes a row.
   Sparse products are held per element to ``1e-5·sqrt(row terms)·max(1,
   Σ|terms|)``; the input gather is checked on the path's features and on
   a randn operand; K1 must also equal its own summation order replayed
   in PyTorch (``ops/ell.py`` ``k1_order_replay``) bit for bit, on the
   front end's row-padded operand and on the same values contiguous
   (both layouts timed).
3. The main path: ``prepare_data``, ``build_model`` and ``run_joint`` of
   the headline ACM-GCN+ configuration at full width (hidden 64, bf16
   gathers), in the runner's default form on the card (the first body
   eagerly, then one captured CUDA graph run by a device loop, one
   launch a call: K9 evaluates the stop rule after each body),
   warm-up then timed epochs; ms/epoch over the run and over the
   looped bodies, the capture's ms, finite losses, and every kernel's
   launch count (launches that ran: a looped body counts its graph's)
   against the count the path implies, K8 (dropout) as
   ``k8_per_body`` implies and K9 once a launch and once a body; then a
   torch.profiler window over the looped bodies: device time by kernel
   group, device operations, the device's busy share and the host's
   waits for it per epoch.
4. Card against CPU on a small graph (dropout 0, f32 gathers, 20 epochs):
   final parameters and split results agree.
5. The genius-shaped ROC-AUC path (bench.py's genius scenario: Chung-Lu
   stand-in N=421,961, nnz(A+I)=2,385,307, F=12, ACM-GCN without
   LayerNorm, BCE loss, ROC-AUC selection):
   a. each kernel against its plain version on the genius operator, as in
      phase 2: K1 at widths 12, 8 and 4; K2/K3 without LayerNorm at d=64
      and d=2; K5 (COO) forward at widths 12 and 8 and transpose at width
      4, then the input gather (w12) at slice sizes 128 to 1024; K4
      (ROC-AUC: one launch forms the counts and the AUCs) with 2 masks,
      also against an exact host reference (scipy rankdata, f64) on
      random scores and on a saturated tie group, then with 7 masks and
      on B=3 multilabel columns, across two launches and under CUDA-graph
      replay, timed at each compiled tile size;
   b. the joint loop on the ELL operator, then on the COO operator, then
      the sequential loop (without and with early stopping), captured as
      in phase 3: ms/epoch, the capture's ms, finite losses, best
      val/test ROC-AUC, launch counts against the counts each path
      implies, and a profiler window; then (d) the cost of the early
      stopping rule in the captured form (K9 reads the flag on the
      device), timed over alternating pairs of full-length sequential
      runs, each a new runner and each on one kept runner (one launch a
      run), and each arm's host waits per epoch;
   c. card against CPU on a small genius stand-in (joint ELL and joint
      COO over 40 epochs, sequential with an early stop that fires).
6. The sharded path (the graph row-partitioned over ranks; K6 packs each
   rank's operand slab before the exchange, K1/K5 aggregate its local
   half):
   a. the headline graph partitioned over 4 ranks in this process, with
      all-gather and with halo exchange: K6 bit-equal to its plain
      version on every rank's slabs, whole padded buffers (padding
      included; widths 7, 8, 4, with and without pre-scale and sign,
      bf16 and f32, at K1's row stride and at rows of d); each rank's
      receive buffer assembled by hand from the four packs in whole
      padded rows (K1's stride for ELL, rows of d for COO), then K1 and
      K5 on every local half per element as in phase 2; rank 0 timed
      against the plain versions and ``torch.sparse.mm``, with the rows
      and bytes it receives per SpMM; then K6 at world size 1 (phase b's
      shapes);
   b. world size 1 over NCCL, every run captured (the first body eager,
      then replays of one CUDA graph holding the NCCL all-reduce):
      ``run_experiment_sharded`` against the single-chip port (f32,
      dropout 0, 10 epochs, parameters within 1e-4), then the headline
      configuration timed with launch counts and a profiler window (K1's,
      K6's and NCCL's ms/epoch and the NCCL operations a replay, beside
      the rows and bytes exchanged), beside phase 3; its captured form
      against its eager form bit for bit over 20 epochs, with the
      runner's all-reduces recorded in the graph (one a joint body); and
      in alternating pairs with the captured single-chip runner (ms/epoch
      over the run and over the replays);
   c. world size 4 on the one card (four processes, gloo on CUDA tensors
      staged through the host, a ``FileStore``) on a 20k-node
      twitch-shaped graph (labels a function of the features, lr 1e-3,
      no weight decay: a configuration that does not amplify rounding):
      every rank's bf16 halo receive buffer against the four ranks' packs
      bit for bit, whole padded rows; all-gather and halo × ELL and COO
      in f32, 20 epochs each, against the single-chip port (parameters
      within 1e-4, equal epochs); each halo run against the all-gather run of its format and
      dtype, bf16 ELL included (within 1e-4); the rows each rank sends and
      receives per SpMM; how far two summation orders of the single-chip
      port part there after 20 epochs; and, for the record, gloo's own
      handling of CUDA tensors without the staging.
7. The last TPU kernels and the single-card entry points:
   a. K7, the panel gather of ``tools/pallas_gather_probe.py`` (P1
      per-element, P2 per-row indices): the port's probe
      (``python -m acmgnn_tpu_torch.tools.gather_probe``) with its
      launches counted, then each of its six configurations: the host
      plan (block or L2 form) and the blocks resident per launch, K7
      bit-equal to the plain version (at P=8 in the L2 form too, the two
      forms timed in turns), K7, plain and library ms, the bytes bound
      and M rows/s, and the HBM ``index_select`` yardstick;
   b. ``run_experiment`` on the headline configuration at full size (2
      splits, joint loop) with launch counts, one capture for the run
      (split 1 replays split 0's graph) and bit for bit against the same
      run with a new runner and capture a split (``epoch_ms_steady``
      beside that run's replays); ``run_experiment_stepwise`` (2 splits x
      20 sequential epochs) captured, one graph a run (the first epoch
      eager, the second captured, the rest replays), launch counts as
      ``sequential_counts``, bit for bit against its ``graph=False`` form
      (every epoch's loss and metrics, final weights, Adam's moments and
      step, best weights), and ``epoch_ms_steady`` of the two forms in 3
      alternating pairs;
   c. each knob in a short ``run_experiment`` at full size, with launch
      counts, one capture a run and equal to a runner a split: remat
      (captured; peak memory beside the plain run; the recomputed
      forward's launches counted), bf16 features with bf16 GEMMs, AdamW,
      the RCM reorder (and the host seconds of the order); then each knob
      card against CPU on phase 4's small graph.
8. The captured split loop (a device loop around one graph) against the
   eager one (``make_split_runner(..., graph=False)``):
   a. 20 epochs of each form from the same parameters and seed on the
      headline (with and without remat) and on genius joint ELL, joint
      COO, sequential, and sequential with early stopping: parameters,
      train-loss and val-loss histories, best metrics and epochs_run bit
      for bit; launch counts equal, and as each path implies; no
      occupancy query in the captured run; the captured body's node
      types (what a conditional body may hold); the capture's ms and
      both forms' peak memory;
   b. on the headline and genius joint ELL, alternating pairs of the two
      forms: ms/epoch over the run and over the replays, medians and
      quartiles, the pairs won; one profile of each form.

9. The operator layer and the model zoo:
   a. the kernel instances of this slice against their plain versions:
      K2/K3 at each (channels, ReLU mask) instance, with and without
      LayerNorm, at the rows and widths of each run that launches it
      (four channels: penn94_pp's 41,554 rows at d=64 and d=2; the masks
      of variant 1 with and without the structure channel and of acmsgc:
      the zoo's 2,000 rows at d=64 and d=2, the chameleon-shaped graph's
      2,277 at d=64 and d=5), their summed gradients with the two
      planted faults;
      K1 with valued halves (bf16 and f32 values) on the headline graph
      in symmetric normalization at widths 7, 8 and 4, bit for bit
      against ``k1_order_replay``; K1 on penn94_pp's structure operator
      at w64 and w2 (its own transpose), and on its row-normalized
      operator at w128 (layer 1's train gather and its transpose) and at
      w4814 (the eval branch's set-up gather of the features, per element
      against the plain version in row chunks), each bit for bit against
      ``k1_order_replay``, and at wiki's w600 bit for bit against it;
      K5 on the symmetric-normalized COO operator; each timed beside its
      plain version, its bound and ``torch.sparse.mm`` where one computes
      the same product.  Every K1 row names its form (``ops/ell.py``
      ``k1_form``: narrow below ``K1_WIDE_BYTES`` a row, else wide); a
      wide row also prints an HBM-only estimate of its gathered bytes
      (entries x row bytes / 3.35 TB/s; not a floor, L2 reuse beats it)
      and the narrow form's device ms on the same operand.  Then the
      crossover of the two forms: both on the headline's
      and penn94_pp's operators at w16, w32 and w64, bf16 and f32, each
      bit for bit against its replay, timed in turns, and the
      ``K1_WIDE_BYTES`` the times support;
   b. penn94_pp at full width (bench.py's row: ACM-GCN++ with the
      structure channel, N=41,554, F=4,814, bf16 gathers and GEMMs, joint
      loop, hoist), 20 captured epochs: ms/epoch over the run and the
      replays, the capture, finite losses, launch counts as ``pp_counts``
      implies, and a profile; then the headline configuration with
      symmetric normalization on the valued ELL operator (bf16 and f32
      values) and on COO, 20 captured epochs each, launch counts as
      ``joint_counts`` implies;
   c. the dense operator on a chameleon-shaped graph (N=2,277, F=2,325,
      C=5; ``fmt="auto"``): ACM-GCN+ with the structure channel and
      variant 1, and acmsgc over Â², 20 captured epochs each, timed,
      with launch counts; each eager against captured bit for bit, and
      card against CPU (1e-4) on each of 20 steps from the card's state;
      acmsgc's whole 20-epoch trajectory too, the structure case's
      printed beside the CPU port's own runs one rounding apart;
   d. every model type of the zoo (and acmgcnpp with a BatchNorm,
      variant 1, the structure channel with variant 1, symmetric
      normalization) on a small twitch-shaped graph: a few epochs eager
      against captured bit for bit (parameters and BatchNorm statistics,
      launch counts equal), then card against CPU (1e-4).

10. The CLI slice: datasets written in their loaders' on-disk layouts
   under a temporary ``ACMGNN_DATA_PATH``, the subcommands of
   ``acmgnn_tpu_torch.cli`` run in this process on the card:
   a. genius at full width from ``genius.mat`` (the Chung-Lu stand-in's
      edge list, N=421,961) and its LINKX split file: the load equal,
      array for array, to the edge list symmetrized in memory with the
      loader's rule (self-loops kept), its host seconds; ``cli train``
      with genius's configuration (``config_from_args`` equal to
      ``genius_config()`` but for the splits and epochs), 2 splits x 20
      epochs, under ``--profile_dir``: launch counts as ``joint_counts``
      implies, the trace naming K1-K4, the per-split test and val
      ROC-AUC and the JSON equal bit for bit to ``run_experiment`` on the
      loaded graph; split 0 captures and split 1 replays its graph;
      ms/epoch over each split's whole run and its replays;
   b. a chameleon-shaped graph in Geom-GCN files: stepwise training with
      checkpoints, captured (one graph a run), the same cut at half the
      epochs and resumed (the snapshots, histories, best weights and
      results equal bit for bit),
      ``predict`` (logits equal to an eval forward of the checkpoint),
      COO training (K5), ``homophily``, a 2 x 2 x 2 ``sweep`` (one
      capture a dropout value; each point equal to its eager form),
      ``gen-graphs``, ``gen-feats``
      from cora-shaped Planetoid files and ``synthetic-train``.

11. The sharded path as the JAX package runs it (``run_experiment_sharded``;
   at world size 1 over NCCL a run makes one capture, which its later
   splits and segments replay, and fails if a split ran eagerly):
   a. wiki at full width (bench.py:942-1045's ``bench_wiki_sharded``:
      ``wiki_scale_graph``, N=1,925,342 Chung-Lu, F=600, C=5; acmgcnp
      hidden 64, dropout 0.5,
      ELL, bf16 gathers, with the hoist) at world size 1 over NCCL
      through per-rank slab loading, 2 splits: the features' loader
      called once with (0, N), its slab the loaded rows, zero padded;
      host seconds of the graph, operator build and loads; split 1
      replays split 0's graph; ``epoch_ms_steady`` beside the replays,
      peak memory, finite losses, launch counts as ``wiki_counts``
      implies, a
      profile of ``WIKI_EPOCHS`` epochs (device time by kernel group);
      K6 and K1 at w600 (the hoist aggregate; K1's plain version in row
      chunks) and at the epoch's widths (w128 and its transpose, w10)
      against their plain versions, bounds and ``torch.sparse.mm``;
   b. genius ROC-AUC (phase 5's configuration, f32 gathers) at world
      size 1 over NCCL: every split's best val and test AUC equal to the
      single-card ``run_experiment``'s bit for bit, K4 once an
      evaluation, the captured loop against its eager form bit for bit
      over 20 epochs (one all-reduce a replay; the logits' gather and K4
      inside the graph), K4 on the gathered scores bit-equal to its plain
      version, timed;
   c. the zoo on 4 gloo ranks on the one card (phase 6c's graph and
      configuration): acmgcnpp with the structure channel, variant 1,
      symmetric normalization on ELL (bf16, f32 values) and COO, gcnII,
      graphsage, BCE + ROC-AUC, acmgcnpp with ``init_layers_X = 2``
      (BatchNorm across the ranks: 11e at 4 ranks), 20 epochs with each
      exchange, against the single card: every step from the single
      card's states (each tensor's gradients over the run within 1e-5 of
      their norm plus 3x the single card's own ELL-COO distance), the
      whole run within 1e-4 where the single card's own ELL and COO
      orders part by under 1e-5, else within 2x that distance (the
      structure channel's, sym's; BatchNorm's is printed, not held, and
      its step bound's witness is the larger of the ELL-COO distance and
      the single card's on its rows reversed: ``STEP_BOUND_ONLY``), and
      each halo run against its all-gather twin;
      K1 on every rank's valued symmetric block bit for bit against
      ``k1_order_replay``; rank 0's blocks timed: K1 valued and on the
      structure operator, K5 symmetric, K6 for the structure operand and
      the valued transpose, K2/K3 at T = 4 and variant 1's mask;
   d. a checkpointed run cut at half the last split's epochs and resumed
      on 2 gloo ranks, joint and sequential: equal bit for bit to the
      uninterrupted run and to the run without checkpoints, snapshots
      included;
   e. acmgcnpp with ``init_layers_X = 2`` (hidden 64, f32 gathers) on the
      headline graph at world size 1 over NCCL, captured: equal bit for
      bit to the captured single card, BatchNorm's statistics included
      (its 4-rank form is an 11c case);
   f. the headline at world size 1 over NCCL with ``checkpoint_every``
      (2 splits x 10 epochs, segments of 4 bodies): one capture for the
      run, every segment of both splits one device-loop launch, equal bit
      for bit to the run without checkpoints and to the segments' eager
      form.

12. The kernels with no TPU counterpart: K8 (counter-based dropout) bit
   for bit against its plain version, forward and backward, f32 and
   bf16, at the headline's widths, and at wiki's full input and hidden
   element counts (one launch each, slabs held to the plain version);
   timed in turns beside the bound, the plain version and ``F.dropout`` /
   ``native_dropout_backward``; K9's device
   loop against its plain condition (limit, stop flag, a limit already
   reached) and its cost an iteration over 10,000 one-kernel bodies
   beside a replay a body with the host reading the condition.

13. The JAX package's single-card scenarios the card had not run, and its
   driver entry points (each path through ``drive_path``: one capture a
   run, a call one device-loop launch; ms/epoch over the run and over the
   looped bodies, set-up and capture, finite losses, peak memory, the
   allocator cache releases before a capture, launch counts as the path
   implies, and busy share and groups from a profile of replays of the
   captured body, not of the device loop; then every K1 width the path
   launches per element against the plain version and bit for bit
   against ``k1_order_replay``, with the hub class's and the deepest
   row's share of the call, and every K2/K3 instance new in size, each
   timed beside its bound and ``torch.sparse.mm``):
   a. wiki on one card (bench.py:773-824: sequential, no hoist, remat,
      bf16 features) on 11a's graph: K1 w128 and w10 and their
      transposes, K2/K3 with LayerNorm at d64/d5 on 1,925,342 rows;
   b. penn94 (acmgcn, joint, hoist, bf16 GEMMs) on 9b's graph: K1 w4814
      (set-up), w128 and its transpose, w8, w4; K2/K3 without LayerNorm;
   c. arxiv_year (F = 128, C = 5): K1 w128 (the input gather and the
      hoist aggregate), w20, w10; K2/K3 without LayerNorm at d64/d5;
   d. the headline on bench.py's powerlaw graph (rows of ~33,000
      entries) and e. on its banded graph (±64 ids): K1 w7, w8, w4 beside
      phase 2's uniform rows;
   f. card against CPU: phase 4's configuration on a small powerlaw graph
      with rows above ``K1_HUB_DEGREE`` (1e-4), and the single-card wiki
      configuration on a small wiki-shaped graph (f32 gathers 1e-4, bf16
      gathers 1e-2);
   g. ``acmgnn_tpu_torch.entry``: ``entry()``'s forward on the card
      against the CPU (2^-8 of the logits' scale) with its launches,
      ``dryrun(1)`` over NCCL (the mini-split captured once), and
      ``dryrun(1)``/``dryrun(4)`` (four gloo ranks on the one card) at
      dropout 0 against the single card's step (1e-5).

The line before the last is the kernel table as JSON (every row with
``ms`` and ``device_ms``, ``library_ms`` and ``library_device_ms``; K1's
rows also with ``form``); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32, outside the tensor cores
# H100 SXM 32-bit integer operations: 64 INT32 lanes an SM x 132 SMs x
# 1.98 GHz boost (the Hopper white paper's SM), one operation a lane
INT32_OPS = 16.7e12
WARM_EPOCHS, TIMED_EPOCHS, PROFILE_EPOCHS = 2, 10, 8
GENIUS_TIMED_EPOCHS, GENIUS_SEQ_EPOCHS, GENIUS_ES = 20, 40, 5


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


def spmm_err(got, want, absref, row_terms, what: str):
    """Max |got - want| of a sparse product against a per-element bound,
    ``1e-5·sqrt(terms of the row)·max(1, absref)``, where ``absref`` is
    the same product over absolute values (``Σ|terms|``, the scale of the
    rounding error): rows of small values get a bound below their values,
    whatever the largest output is."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs()
    tol = 1e-5 * row_terms.float().clamp_min(1).sqrt()[:, None] \
        * absref.clamp_min(1.0)
    ratio = float((err / tol).max())
    ok = ratio <= 1.0 and bool(torch.isfinite(got).all())
    print(f"  {what}: max_abs_err {float(err.max()):.3e}, worst "
          f"err/tolerance {ratio:.3e} (per element 1e-5·sqrt(row terms)·"
          f"max(1, Σ|terms|)) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its plain version")
    return float(err.max())


def device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``, without the host's issue rate
    (``time_ms`` times a Python loop of calls and reads the issue rate
    below ~0.07 ms): ``reps`` calls captured in one CUDA graph, events
    around its replay, the best of three replays.  A call that cannot be
    captured is timed by torch.profiler's device time over ``reps``
    calls instead (late in a long run the profiler has dropped records,
    so the graph comes first); None where that records nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        graph = None
    torch.cuda.synchronize()
    if graph is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
        return best
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(us for us, _ in device_ops(list(prof.events()))[0].values())
    if us <= 0:
        print("  device_ms: the profiler recorded no device time (not "
              "measured)")
        return None
    return us / 1e3 / reps


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


CARD_LINE = "card not read"   # nvidia-smi's name and power limit


def phase_environment():
    import torch

    from acmgnn_tpu_torch.ops import kernels

    global CARD_LINE
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD_LINE = smi.splitlines()[0]
    print(CARD_LINE)
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


def _csr_on_card(mat):
    """f32 ``torch.sparse_csr_tensor`` of ``mat`` on the card (the library
    yardstick, never used by the port)."""
    import scipy.sparse as sp
    import torch

    csr = sp.csr_matrix(mat, dtype=np.float32)
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=csr.shape,
        check_invariants=False).cuda()


def _spmm_cases(n, gen, x_in, hp8=(0, 0, 1, 1, 0, 0, 1, 1)):
    """The three products of a joint epoch: the layer-1 input gather (no
    epilogue), the paired layer-2 gather [zL_tr, zH_tr, zL_ev, zH_ev] with
    the high-pass epilogue, and its prefix transpose with the identity
    path.  Returns (name width, operand, z, alpha, beta, transposed)."""
    import torch

    hp4 = hp8[:4]
    z8 = torch.randn(n, 8, generator=gen, device="cuda")
    g4 = torch.randn(n, 4, generator=gen, device="cuda")
    sign4 = torch.tensor([-1.0 if h else 1.0 for h in hp4], device="cuda")
    return [
        (x_in, None, None, None, False),
        (z8, z8, [float(h) for h in hp8], [-1.0 if h else 1.0 for h in hp8],
         False),
        (g4 * sign4, g4, [float(h) for h in hp4], [1.0] * 4, True),
    ]


def _abs(v):
    """|v| of a tensor or of per-column constants (None stays None)."""
    if v is None:
        return None
    return tuple(abs(c) for c in v) if isinstance(v, tuple) else v.abs()


def _ell_row_terms(half):
    """Terms each output row of an ELL half sums (its degree)."""
    deg = half.indptr[1:] - half.indptr[:-1]
    out = deg.new_empty(deg.shape)
    out[half.row_ids.long()] = deg
    return out


def _coo_row_terms(half):
    import torch

    return torch.bincount(half.row.long(), minlength=half.num_rows)


def _k1_form_note(half, xg):
    """K1's form for the operand ``xg`` (``ops/ell.py`` ``k1_form``) and a
    note for the printed row: for a wide row, an HBM-only estimate of its
    gathered bytes, every entry's row once from HBM, ``entries × row bytes
    / 3.35 TB/s`` (ms).  It is not a floor: hub columns reused from L2
    beat it.  Returns (form, text)."""
    from acmgnn_tpu_torch.ops.ell import k1_form

    d = xg.shape[1]
    form = k1_form(d, xg.dtype)
    if form != "wide":
        return form, f"{form} form"
    est = (1e3 * int(half.indices.numel()) * d * xg.element_size()
           / HBM_BYTES_PER_S)
    return form, (f"wide form, gathered bytes at HBM rate alone "
                  f"{est:.4f} ms ({int(half.indices.numel())} entries x "
                  f"{d * xg.element_size()} B)")


def _k1_narrow_ms(half, xg, z, alpha, beta, reps=20):
    """The narrow form (the design before the wide one) on a wide row's
    operand: device ms, to set beside the wide form's."""
    from acmgnn_tpu_torch.ops.ell import _columns, _row_gather_spmm_cuda

    d = xg.shape[1]
    a, b = _columns(alpha, d, 0.0), _columns(beta, d, 1.0)
    zz = z if any(a) else None
    return _ms(device_ms(
        lambda: _row_gather_spmm_cuda(half, xg, zz, a, b, "narrow"), reps))


K1_REPLACES = ("acmgnn_tpu/ops/ell.py:693", "acmgnn_tpu/ops/spmm.py:153",
               "acmgnn_tpu/ops/spmm.py:143")
K5_REPLACES = ("acmgnn_tpu/ops/spmm.py:45", "acmgnn_tpu/ops/spmm.py:34",
               "acmgnn_tpu/ops/spmm.py:54")


def phase_kernels(adj, feats, tag="[2]", suffix="", use_ln=True,
                  with_coo=False):
    """Each SpMM and attention kernel against its plain version at a
    path's shapes: K1 (and K5 with ``with_coo``) for the three products of
    a joint epoch, then K2/K3."""
    import torch

    from acmgnn_tpu_torch.data.registry import row_normalize_features
    from acmgnn_tpu_torch.ops.coo import coo_spmm, coo_spmm_plain
    from acmgnn_tpu_torch.ops.coo import SLICE_NNZ, make_coo_half
    from acmgnn_tpu_torch.ops.ell import (
        K1_LANE_ENTRIES,
        k1_lane_classes,
        k1_operand,
        k1_order_replay,
        row_gather_spmm,
        row_gather_spmm_plain,
    )
    from acmgnn_tpu_torch.ops.graph import (
        make_coo_op,
        precompute_operators,
        row_normalized_adjacency,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    op = precompute_operators(adj, fmt="ell",
                              spmm_dtype=torch.bfloat16).adj_low.to(dev)
    n, nnz = op.num_nodes, op.nnz
    deg = op.fwd.indptr[1:] - op.fwd.indptr[:-1]
    print(f"{tag} operator N={n} nnz={nnz} max row {int(deg.max())} median "
          f"row {int(deg.median())}; K1 lane classes (rows ending each of "
          f"256, 32, 16, 8, 4, 2, 1 lanes) fwd {op.fwd.lane_classes} bwd "
          f"{op.bwd.lane_classes} (host build "
          f"{time.perf_counter() - t0:.1f} s)")
    a_hat = row_normalized_adjacency(adj)
    a_lib, a_lib_t = _csr_on_card(a_hat), _csr_on_card(a_hat.T)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    x_in = torch.from_numpy(row_normalize_features(feats)).to(dev)
    for (x, z, alpha, beta, tr), replaces in zip(_spmm_cases(n, gen, x_in),
                                                 K1_REPLACES):
        d = x.shape[1]
        name = f"k1_spmm_w{d}"
        half = op.bwd if tr else op.fwd
        a = tuple(alpha or (0.0,) * d)
        b = tuple(beta or (1.0,) * d)
        terms = _ell_row_terms(half) + int(z is not None)
        # the path's operand, and for the input gather (whose row-normalized
        # features reach ~6e4) also a randn one of the same width
        operands = [(x, "")]
        if z is None:
            operands.append((torch.randn(n, d, generator=gen, device=dev),
                             "_randn"))
        checked = {}
        for xo, tag_x in operands:
            # the front end's operand: its rounding order (the transpose
            # rounds, pre-scales in f32, rounds again) and K1's row-padded
            # layout (ops/spmm.py)
            xg = k1_operand(xo if half.pre_scale is None
                            else xo.to(torch.bfloat16), torch.bfloat16,
                            half.pre_scale)
            got = row_gather_spmm(half, xg, z=z, alpha=alpha, beta=beta)
            err = spmm_err(
                got, row_gather_spmm_plain(half, xg, z, a, b),
                row_gather_spmm_plain(half, xg.abs(), _abs(z), _abs(a),
                                      _abs(b)),
                terms, name + tag_x + suffix)
            replay = k1_order_replay(half, xg, z if any(a) else None, a, b)
            if not torch.equal(got, replay):
                fail(f"{name + tag_x + suffix}: K1 differs from its own "
                     f"summation order replayed")
            flat = row_gather_spmm(half, xg.contiguous(), z=z, alpha=alpha,
                                   beta=beta)
            if not torch.equal(got, flat):
                fail(f"{name + tag_x + suffix}: K1 on the row-padded and "
                     f"the contiguous operand differ")
            print(f"  {name + tag_x + suffix}: equal bit for bit to K1's "
                  f"summation order replayed in PyTorch (ops/ell.py "
                  f"k1_order_replay), on row stride {xg.stride(0)} and "
                  f"{d}")
            checked[tag_x] = (xg, err)
        xg, err = checked[""]
        ms = time_ms(lambda: row_gather_spmm(half, xg, z=z, alpha=alpha,
                                             beta=beta), 50)
        dev_ms = device_ms(lambda: row_gather_spmm(half, xg, z=z,
                                                   alpha=alpha, beta=beta))
        if xg.stride(0) != d:   # the layout the path does not use
            xc = xg.contiguous()

            def flat():
                return row_gather_spmm(half, xc, z=z, alpha=alpha, beta=beta)

            print(f"  {name + suffix} operand layout: row stride "
                  f"{xg.stride(0)} (the path's) {ms:.4f} ms, device "
                  f"{_ms(dev_ms)}; contiguous rows of {d}: "
                  f"{time_ms(flat, 50):.4f} ms, device "
                  f"{_ms(device_ms(flat))}")
        # K1's lane rule: the same half with the class table of 4, 8 and
        # 16 entries a lane, each equal to its own order replayed
        indptr = half.indptr.cpu().numpy()
        rule = []
        for entries in (4, 8, 16):
            h = dataclasses.replace(
                half, lane_classes=k1_lane_classes(indptr, entries))

            def run():
                return row_gather_spmm(h, xg, z=z, alpha=alpha, beta=beta)

            if not torch.equal(run(), k1_order_replay(
                    h, xg, z if any(a) else None, a, b)):
                fail(f"{name + suffix} at {entries} entries a lane: K1 "
                     f"differs from its order replayed")
            rule.append(f"{entries}: {_ms(device_ms(run))}")
        print(f"  {name + suffix} device ms by entries a lane (the rule "
              f"uses {K1_LANE_ENTRIES}): " + "; ".join(rule))
        plain_ms = time_ms(
            lambda: row_gather_spmm_plain(half, xg, z, a, b), 5)
        xf = xg.float()
        lib = a_lib_t if tr else a_lib
        lib_ms = time_ms(lambda: torch.sparse.mm(lib, xf), 20)
        lib_dev = device_ms(lambda: torch.sparse.mm(lib, xf))
        nbytes = (8 * (n + 1) + 4 * nnz + 4 * n + 2 * n * d + 4 * n * d
                  + (4 * n * d if z is not None else 0)
                  + (4 * n if half.row_scale is not None else 0))
        b_ms, b_by = bound(nbytes, nnz * d + 2 * n * d)
        form, note = _k1_form_note(half, xg)
        rows.append(dict(name=name + suffix, counter=name, route="cuda",
                         source="acmgnn_tpu_torch/csrc/spmm.cu",
                         replaces=replaces, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms,
                         library_device_ms=lib_dev, form=form))
        print(f"  {name + suffix} ({note}): {ms:.4f} ms, device "
              f"{_ms(dev_ms)} (plain {plain_ms:.3f}, torch.sparse.mm f32 "
              f"{lib_ms:.4f}, device {_ms(lib_dev)}; bound {b_ms:.4f} "
              f"{b_by})")

    if with_coo:
        t0 = time.perf_counter()
        coo = make_coo_op(a_hat).to(dev)
        print(f"{tag} COO operator nnz={coo.nnz}, {coo.fwd.span_rows.numel()}"
              f" rows span slices of {coo.fwd.slice_nnz} (host build "
              f"{time.perf_counter() - t0:.1f} s)")
        for (x, z, alpha, beta, tr), replaces in zip(
                _spmm_cases(n, gen, x_in), K5_REPLACES):
            d = x.shape[1]
            name = f"k5_coo_w{d}"
            half = coo.bwd if tr else coo.fwd
            a = tuple(alpha or (0.0,) * d)
            b = tuple(beta or (1.0,) * d)
            terms = _coo_row_terms(half) + int(z is not None)
            half_abs = dataclasses.replace(half, val=half.val.abs())
            operands = [(x, "")]
            if z is None:
                operands.append((torch.randn(n, d, generator=gen, device=dev),
                                 "_randn"))
            checked = {}
            for xo, tag_x in operands:
                got = coo_spmm(half, xo, z=z, alpha=alpha, beta=beta)
                checked[tag_x] = spmm_err(
                    got, coo_spmm_plain(half, xo, z, a, b),
                    coo_spmm_plain(half_abs, xo.abs(), _abs(z), _abs(a),
                                   _abs(b)),
                    terms, name + tag_x + suffix)
                again = coo_spmm(half, xo, z=z, alpha=alpha, beta=beta)
                if not torch.equal(got, again):
                    fail(f"{name}: two launches differ (K5 must be "
                         f"deterministic)")
            err = checked[""]
            ms = time_ms(lambda: coo_spmm(half, x, z=z, alpha=alpha,
                                          beta=beta), 50)
            dev_ms = device_ms(lambda: coo_spmm(half, x, z=z, alpha=alpha,
                                                beta=beta))
            plain_ms = time_ms(lambda: coo_spmm_plain(half, x, z, a, b), 5)
            lib = a_lib_t if tr else a_lib
            lib_ms = time_ms(lambda: torch.sparse.mm(lib, x), 20)
            lib_dev = device_ms(lambda: torch.sparse.mm(lib, x))
            extra = 4 * (3 * half.span_rows.numel() + half.empty_rows.numel())
            nbytes = (12 * nnz + extra + 4 * n * d + 4 * n * d
                      + (4 * n * d if z is not None else 0))
            b_ms, b_by = bound(nbytes, 2 * nnz * d + 2 * n * d)
            rows.append(dict(name=name + suffix, counter=name, route="cuda",
                             source="acmgnn_tpu_torch/csrc/coo.cu",
                             replaces=replaces, max_abs_err=err, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             library_device_ms=lib_dev))
            print(f"  {name + suffix}: {ms:.4f} ms, device {_ms(dev_ms)} "
                  f"(plain {plain_ms:.3f}, torch.sparse.mm f32 {lib_ms:.4f}, "
                  f"device {_ms(lib_dev)}; bound {b_ms:.4f} {b_by}); "
                  f"bit-identical reruns")
        # K5's slice size: the input gather at other slice sizes, each
        # checked against the plain version and its own rerun
        fwd = coo.fwd.to("cpu")
        d = x_in.shape[1]
        ones, zeros = (1.0,) * d, (0.0,) * d
        sweep = []
        for size in sorted({128, 256, 512, 1024, SLICE_NNZ}):
            h = make_coo_half(fwd.row.numpy(), fwd.col.numpy(),
                              fwd.val.numpy(), n, slice_nnz=size).to(dev)
            got = coo_spmm(h, x_in)
            if not torch.equal(got, coo_spmm(h, x_in)):
                fail(f"K5 slice {size}: two launches differ")
            spmm_err(got, coo_spmm_plain(h, x_in, None, zeros, ones),
                     coo_spmm_plain(dataclasses.replace(h, val=h.val.abs()),
                                    x_in.abs(), None, zeros, ones),
                     _coo_row_terms(h), f"k5_coo_w{d} slice {size}")
            sweep.append(f"{size}: {h.span_rows.numel()} spanning rows, "
                         f"{time_ms(lambda: coo_spmm(h, x_in), 50):.4f} ms, "
                         f"device {_ms(device_ms(lambda: coo_spmm(h, x_in)))}")
        print(f"  k5_coo_w{d}{suffix} by slice size (SLICE_NNZ "
              f"{SLICE_NNZ}): " + "; ".join(sweep))

    rows += attention_rows(n, gen, use_ln=use_ln,
                           suffix=suffix + ("" if use_ln else "_noln"))
    return rows


def _host_auc(scores: np.ndarray, labels: np.ndarray, mask: np.ndarray):
    """Exact f64 Mann-Whitney AUC on the mask's subset (scipy ranks)."""
    from scipy.stats import rankdata

    s, y = scores[mask].astype(np.float64), labels[mask]
    ranks = rankdata(s, method="average")
    n_pos = int((y == 1).sum())
    n_neg = s.size - n_pos
    return (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def phase_rocauc_kernel(labels, masks_np, suffix="@genius"):
    """K4, one launch that forms the counts and the AUCs, against its plain
    version (counts exactly; AUCs bit-equal for one score column, within 1
    f32 ulp for a multilabel mean) and against the exact host reference
    (the AUC from K4's counts in f64 to 1e-9, K4's f32 AUC to half an f32
    ulp + 1e-9), on random scores and on scores holding a saturated tie
    group of >= 50,000 nodes; then 7 masks, and B=3 multilabel columns
    with 2 and 7 masks; every case bit-equal across two launches, and a
    CUDA graph of the path's call replayed twice bit-equal to it.  Timed
    with 2 masks beside the bound, at each compiled tile size, beside
    ``torch.sort`` (the library row) and the ATen tail the fusion removed
    (``auc_from_counts`` on the counts and the f32 cast)."""
    import torch

    from acmgnn_tpu_torch.train.metrics import _launch as k4_launch
    from acmgnn_tpu_torch.train.metrics import (
        K4_TILE,
        K4_TILES,
        MAX_MASKS,
        auc_from_counts,
        pack_labels_and_masks,
        rocauc_from_sorted,
        rocauc_from_sorted_plain,
        sort_scores,
    )

    dev = torch.device("cuda")
    n = labels.shape[0]
    y = torch.from_numpy(labels).to(dev)
    masks = tuple(torch.from_numpy(m).to(dev) for m in masks_np[1:])
    packed = pack_labels_and_masks(y, masks)
    rng = np.random.default_rng(7)
    random_scores = rng.random(n).astype(np.float32)
    saturated = random_scores.copy()
    saturated[rng.random(n) < 0.3] = 1.0

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def check(what, s_sorted, order, pk, n_masks, multilabel):
        counts, aucs = rocauc_from_sorted(s_sorted, order, pk, n_masks,
                                          multilabel)
        want, want_aucs = rocauc_from_sorted_plain(s_sorted, order, pk,
                                                   n_masks)
        torch.cuda.synchronize()
        if not torch.equal(counts, want):
            fail(f"K4 ({what}) counts disagree with its plain version: "
                 f"{counts.tolist()} != {want.tolist()}")
        nan = torch.isnan(want_aucs)
        ok = want_aucs.abs()
        ulp = torch.nextafter(ok, torch.full_like(ok, float("inf"))) - ok
        diff = torch.where(nan, 0.0, (aucs - want_aucs).abs())
        if not torch.equal(torch.isnan(aucs), nan) or (
                bool((diff > ulp).any()) if multilabel
                else bool((diff > 0).any())):
            fail(f"K4 ({what}) AUCs {aucs.tolist()} disagree with its "
                 f"plain version's {want_aucs.tolist()}")
        again = rocauc_from_sorted(s_sorted, order, pk, n_masks, multilabel)
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(again, (counts, aucs))):
            fail(f"K4 ({what}): two launches differ")
        print(f"  k4 {what}: counts equal the plain version's, AUCs "
              f"{'within 1 f32 ulp of' if multilabel else 'bit-equal to'} "
              f"its (max |diff| {float(diff.max()):.3e}); two launches "
              f"bit-equal")
        return counts, aucs

    err = 0.0
    for what, sc in (("random", random_scores), ("saturated", saturated)):
        scores = torch.from_numpy(sc).to(dev)[None]
        order, s_sorted = sort_scores(scores)
        counts, aucs = check(f"m2{suffix} {what}", s_sorted, order, packed, 2,
                             False)
        from_counts = auc_from_counts(counts)[0].tolist()
        ref = [_host_auc(sc, labels, m) for m in masks_np[1:]]
        diff = max(abs(a - b) for a, b in zip(from_counts, ref))
        half_ulp = max(abs(float(a) - b) - 0.5 * float(
            np.spacing(np.float32(b))) for a, b in zip(aucs.tolist(), ref))
        group = int((sc == 1.0).sum())
        print(f"  k4_auc_m2{suffix} {what} scores (largest tie group "
              f"{group}): AUC from the counts {from_counts} vs host f64 "
              f"{ref}, |diff| {diff:.2e} (tolerance 1e-9); f32 AUC "
              f"{aucs.tolist()}, |diff| - half an f32 ulp {half_ulp:.2e} "
              f"(tolerance 1e-9)")
        if diff > 1e-9 or half_ulp > 1e-9:
            fail(f"K4 ({what}) disagrees with the host reference")
        err = max(err, diff)
    # the path's call (saturated scores) in a CUDA graph, replayed twice
    eager = rocauc_from_sorted(s_sorted, order, packed, 2, False)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rocauc_from_sorted(s_sorted, order, packed, 2, False)
    for _ in range(2):
        for t in captured:
            t.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(captured, eager)):
            fail("K4 under CUDA-graph replay differs from the eager call")
    print(f"  k4_auc_m2{suffix}: a CUDA graph of the call replayed twice, "
          f"bit-equal to the eager call")
    # 7 masks; B=3 multilabel columns with 2 and 7 masks
    extra = tuple(torch.from_numpy(rng.random(n) < 0.3).to(dev)
                  for _ in range(MAX_MASKS))
    scores = torch.from_numpy(random_scores).to(dev)[None]
    order_r, sorted_r = sort_scores(scores)
    check(f"m{MAX_MASKS}{suffix} random", sorted_r, order_r,
          pack_labels_and_masks(y, extra), MAX_MASKS, False)
    y3 = torch.from_numpy((rng.random((n, 3)) < 0.3).astype(np.int64)).to(
        dev)
    scores3 = torch.from_numpy(np.round(rng.normal(size=(3, n)), 2).astype(
        np.float32)).to(dev)
    order3, sorted3 = sort_scores(scores3)
    for mk in (masks, extra):
        check(f"m{len(mk)}{suffix} multilabel B=3", sorted3, order3,
              pack_labels_and_masks(y3, mk), len(mk), True)

    def call():
        return rocauc_from_sorted(s_sorted, order, packed, 2, False)

    ms = time_ms(call, 50)
    dev_ms = device_ms(call)
    plain_ms = time_ms(
        lambda: rocauc_from_sorted_plain(s_sorted, order, packed, 2), 5)
    lib_ms = time_ms(lambda: torch.sort(scores, dim=-1), 50)
    lib_dev = device_ms(lambda: torch.sort(scores, dim=-1))
    counts = call()[0]
    tail_dev = device_ms(lambda: auc_from_counts(counts)[0].float())
    sweep = []
    for tile in K4_TILES:

        def at_tile():
            return k4_launch(s_sorted, order, packed, 2, tile)

        if not torch.equal(at_tile()[0], counts):
            fail(f"K4 at tile {tile} disagrees with its plain version")
        sweep.append(f"{tile}: {time_ms(at_tile, 50):.4f} ms, device "
                     f"{_ms(device_ms(at_tile))}")
    b_ms, b_by = bound(n * (4 + 8 + 1) + 2 * (3 * 8 + 4), 0)
    print(f"  k4_auc_m2{suffix} by tile size (K4_TILE {K4_TILE}): "
          + "; ".join(sweep))
    print(f"  k4_auc_m2{suffix}: {ms:.4f} ms, device {_ms(dev_ms)} (plain "
          f"{plain_ms:.3f}, torch.sort of the scores {lib_ms:.4f}, device "
          f"{_ms(lib_dev)}; the ATen tail K4 now forms, auc_from_counts "
          f"and the f32 cast, device {_ms(tail_dev)}; bound {b_ms:.4f} "
          f"{b_by})")
    return [dict(name="k4_auc_m2" + suffix, counter="k4_auc_m2",
                 route="cuda", source="acmgnn_tpu_torch/csrc/rocauc.cu",
                 replaces="acmgnn_tpu/train/metrics.py:68", max_abs_err=err,
                 ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms,
                 library_device_ms=lib_dev)]


ROW_SUM_TOL = 1e-6     # dv, dc, dW: per element, times max(1, Σ_rows|term|)


def _sum_ratios(got, want, absref):
    """``(|got - want|, that over ROW_SUM_TOL·max(1, absref), max(1,
    absref))`` per element, flattened; ``absref`` is the sum of the
    terms' absolute values (the scale of the rounding error)."""
    err = (got - want).abs()
    ref = absref.clamp_min(1.0).expand_as(err).flatten()
    err = err.flatten()
    return err, err / (ROW_SUM_TOL * ref), ref


def sum_err(got, want, absref, what: str):
    """Max |got - want| of a sum over the rows against
    ``ROW_SUM_TOL·max(1, Σ_rows|term|)`` per element: rounding reads ~1e-8
    of Σ_rows|term|, while a sum that lost a block of b rows is off by
    ~sqrt(b/N) of |Σ term| ~ Σ|term|/sqrt(N), so the tolerance does not
    grow with N."""
    import torch

    torch.cuda.synchronize()
    err, ratio, _ = _sum_ratios(got, want, absref)
    worst = float(ratio.max())
    ok = worst <= 1.0 and bool(torch.isfinite(got).all())
    print(f"  {what}: max_abs_err {float(err.max()):.3e}, worst "
          f"err/tolerance {worst:.3e} (per element {ROW_SUM_TOL:g}·max(1, "
          f"Σ_rows|term|)) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees with its plain version")
    return float(err.max())


def _planted_faults(got, want, scales, partials, n, use_ln, what):
    """The row-sum check must fail K3's (dv, dc, dW) with one block's row
    of the partials left out of the finishing sum (every block tried; the
    least visible one printed) and with dv = 0.  Prints each fault's worst
    err/tolerance, and what the looser 1e-5·sqrt(N) form would have
    read."""
    import torch

    t, d = got[0].shape
    p = partials
    lost = (p[:, :t * d].view(-1, t, d) + p[:, t * d:t * d + t, None],
            p[:, t * d + t:t * d + 2 * t] * use_ln,
            p[:, t * d + 2 * t:].view(-1, t, t) / t)
    new = torch.zeros(p.shape[0], device=p.device)
    old = torch.zeros_like(new)
    for g_, w_, s_, l_ in zip(got, want, scales, lost):
        err, ratio, ref = _sum_ratios(g_[None] - l_, w_[None], s_[None])
        new = torch.maximum(new, ratio.view(p.shape[0], -1).max(1).values)
        loose = err / (1e-5 * n ** 0.5 * ref)
        old = torch.maximum(old, loose.view(p.shape[0], -1).max(1).values)
    b = int(new.argmin())
    zero_err, zero_new, zero_ref = _sum_ratios(torch.zeros_like(got[0]),
                                               want[0], scales[0])
    zero_old = float((zero_err / (1e-5 * n ** 0.5 * zero_ref)).max())
    print(f"  {what} planted faults: block {b} of {p.shape[0]} left out "
          f"(the least visible) worst err/tolerance {float(new[b]):.3e} "
          f"(1e-5·sqrt(N) form {float(old[b]):.3e}); dv = 0 "
          f"{float(zero_new.max()):.3e} (1e-5·sqrt(N) form "
          f"{zero_old:.3e})")
    if float(new[b]) <= 1.0 or float(zero_new.max()) <= 1.0:
        fail(f"{what}: the row-sum check passes a planted fault")


ATTN_SWEEP_LANES = (4, 8, 16)    # lanes a row of K2/K3 swept at d=64


def _attention_case(n, d, gen, dev, t=3):
    """``t`` channels before their ReLU (randn, with rows that have no
    positive entry, all-zero rows and scattered exact zeros), parameters
    and an output gradient."""
    import torch

    zs = [torch.randn(n, d, generator=gen, device=dev) for _ in range(t)]
    zs[2][:1000] = -zs[2][:1000].abs()
    zs[1][1000:2000] = 0.0
    zs[0][::7, 0] = 0.0
    v = torch.randn(t, d, generator=gen, device=dev)
    c = torch.randn(t, generator=gen, device=dev)
    W = torch.rand(t, t, generator=gen, device=dev) * 2 - 1
    gout = torch.randn(n, d, generator=gen, device=dev)
    return zs, v, c, W, gout


def _check_attention(layers, args, bargs, tag, plan, faults=False):
    """K2 and K3 at ``plan`` (lanes a row, floats a lane) against their
    plain versions, ``args`` = ``(channels, v, c, W, use_ln, scale[,
    relu])``: the output and dz_i per element, dv, dc and dW as sums over
    the rows (with ``faults``, the check's planted faults too).  Returns
    the largest error of each kernel."""
    zs, rest = args[0], args[1:]
    relu = layers.relu_flags(args[6] if len(args) > 6 else None, len(zs))
    n, d = zs[0].shape
    t = len(zs)
    fwd_name = layers._counter("fwd", relu, d)
    bwd_name = layers._counter("bwd", relu, d)
    got = layers._launch_forward(zs, *rest[:5], plan, relu)
    e_fwd = max_err(got, layers.attention_mix_forward_plain(*args), d,
                    f"{fwd_name}{tag}")
    *got, partials = layers._launch_backward(zs, *bargs[1:7], plan, relu)
    want = layers.attention_mix_backward_plain(*bargs)
    errs = [max_err(got[i], want[i], d, f"{bwd_name}{tag} dz{i}")
            for i in range(t)]
    scales = layers.attention_grad_scales(*bargs)
    errs += [sum_err(g_, w_, s_, f"{bwd_name}{tag} {name}")
             for name, g_, w_, s_ in zip(("dv", "dc", "dW"), got[t:],
                                         want[t:], scales)]
    if faults:
        _planted_faults(got[t:], want[t:], scales, partials, n, args[4],
                        f"{bwd_name}{tag}")
    return e_fwd, max(errs)


def attention_rows(n: int, gen, use_ln: bool, suffix: str = ""):
    """K2/K3 against their plain versions at d=64 and d=2 on n rows of
    channels before the ReLU; K3 twice on the same inputs (bit-equal);
    at d=64 also 4, 8 and 16 lanes a row, each checked and timed."""
    import torch

    from acmgnn_tpu_torch.models import layers

    dev = torch.device("cuda")
    rows = []
    for d in (64, 2):
        zs, v, c, W, gout = _attention_case(n, d, gen, dev)
        args = (zs, v, c, W, use_ln, 3.0)
        bargs = (zs, gout, v, c, W, use_ln, 3.0)
        e_fwd, e_bwd = _check_attention(layers, args, bargs, suffix,
                                        layers.attention_plan(d), True)
        first = layers.attention_mix_backward(*bargs)
        again = layers.attention_mix_backward(*bargs)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"k3_attn_bwd_d{d}{suffix}: two launches differ")
        vec, g, e, resident = layers.attention_config(
            "bwd", zs, [d] * 3, d, layers.attention_plan(d))
        grid = layers.attention_grid(n, g, resident)
        print(f"  k3_attn_bwd_d{d}{suffix}: bit-equal across two launches; "
              f"{g} lanes a row x {e} floats, {vec}-float loads, grid "
              f"{grid} of {resident} resident blocks")
        if d == 64:
            sweep = []
            for lanes in ATTN_SWEEP_LANES:
                plan = (lanes, 64 // lanes)
                _check_attention(layers, args, bargs,
                                 f"{suffix} {lanes} lanes", plan)
                t_fwd = device_ms(lambda: layers._launch_forward(
                    zs, *args[1:], plan))
                t_bwd = device_ms(lambda: layers._launch_backward(
                    zs, *bargs[1:], plan))
                sweep.append(f"{lanes}: K2 {_ms(t_fwd)}, K3 {_ms(t_bwd)}")
            print(f"  k2/k3 d64{suffix} device ms by lanes a row (the "
                  f"plan uses {layers.attention_plan(64)[0]}): "
                  + "; ".join(sweep))
        # v, c and W in (K3: and dv, dc and dW out); K3 writes its
        # partials and the finishing kernel reads them
        params = 4 * (3 * d + 12)
        k3_bytes = (28 * n * d + 2 * 4 * grid * (3 * d + layers.row_sums(3))
                    + 2 * params)
        fwd = dict(
            counter=f"k2_attn_fwd_d{d}", err=e_fwd,
            ms=time_ms(lambda: layers.attention_mix_forward(*args), 50),
            device_ms=device_ms(lambda: layers.attention_mix_forward(*args)),
            plain_ms=time_ms(
                lambda: layers.attention_mix_forward_plain(*args), 10),
            bound=bound(16 * n * d + params, 23 * n * d))
        bwd = dict(
            counter=f"k3_attn_bwd_d{d}", err=e_bwd,
            ms=time_ms(lambda: layers.attention_mix_backward(*bargs), 50),
            device_ms=device_ms(
                lambda: layers.attention_mix_backward(*bargs)),
            plain_ms=time_ms(
                lambda: layers.attention_mix_backward_plain(*bargs), 10),
            bound=bound(k3_bytes, 50 * n * d))
        for k in (fwd, bwd):
            rows.append(dict(
                name=k["counter"] + suffix, counter=k["counter"],
                route="cuda", source="acmgnn_tpu_torch/csrc/attention.cu",
                replaces="acmgnn_tpu/models/layers.py:191",
                max_abs_err=k["err"], ms=k["ms"], device_ms=k["device_ms"],
                plain_ms=k["plain_ms"], bound_ms=k["bound"][0],
                bound_by=k["bound"][1], library_ms=None,
                library_device_ms=None))
            print(f"  {rows[-1]['name']}: {k['ms']:.4f} ms, device "
                  f"{_ms(k['device_ms'])} (plain {k['plain_ms']:.3f}, bound "
                  f"{k['bound'][0]:.4f} {k['bound'][1]})")
    return rows


def _masks(n: int, seed: int = 0):
    perm = np.random.default_rng(seed).permutation(n)
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


def genius_config(**over):
    """bench.py's genius scenario (``bench.py:621-662``)."""
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcn", hidden=64, dropout=0.5, lr=0.01,
        weight_decay=1e-3, epochs=WARM_EPOCHS, early_stopping=0,
        selection="val_metric", metric="rocauc", loss="bce",
        operator_format="ell", spmm_dtype="bfloat16", gemm_dtype="float32",
        joint=True, hoist_first=True), **over))


def joint_counts(bodies, gather, input_width, k4=False, nclass=2,
                 hidden=64):
    """Launches a joint run of ``bodies`` iterations implies: layer 1's
    train branch gathers its input (F = ``input_width`` <= HOIST_MAX_COLS;
    the eval branch reads x_agg, +1 at set-up) or, above HOIST_MAX_COLS,
    projects first and gathers [z_low | z_high] (2·hidden wide) and its
    transpose (x_agg's F-wide gather once at set-up); layer 2's paired
    gather (4·C wide) and its prefix transpose (2·C); K2 per branch and
    layer, K3 for the train branch, K4 once per iteration."""
    from acmgnn_tpu_torch.models.layers import HOIST_MAX_COLS

    b, c = bodies, nclass
    if input_width <= HOIST_MAX_COLS:
        out = {f"{gather}_w{input_width}": b + 1}
    else:
        out = {f"{gather}_w{input_width}": 1, f"{gather}_w{2 * hidden}": 2 * b}
    out.update({f"{gather}_w{4 * c}": b, f"{gather}_w{2 * c}": b,
                "k2_attn_fwd_d64": 2 * b, f"k2_attn_fwd_d{c}": 2 * b,
                "k3_attn_bwd_d64": b, f"k3_attn_bwd_d{c}": b})
    if k4:
        out["k4_auc_m2"] = b
    return out


def sequential_counts(bodies, gather, input_width, k4=True, nclass=2,
                      hidden=64, remat=False):
    """Launches a sequential run implies: per epoch the train forward's
    layer-1 and layer-2 gathers, the layer-2 transpose, the eval forward's
    layer-2 gather, K2 per forward and layer, K3 once per layer, K4 once
    (ROC-AUC runs).  Layer 1 with the hoist (``input_width``, F): the
    train forward gathers its input and the eval forward reads x_agg
    (+1 at set-up); without it (``input_width`` None), each forward
    gathers [z_low | z_high] (2·hidden wide) and the backward transposes
    it.  ``remat`` (without the hoist): the backward re-runs every K1 and
    K2 launch of the train forward once, layer 2's K2 included (it saves
    its inputs; the joint loop's last launch, the eval branch's K2, saves
    nothing: ``remat_counts``); tests/test_torch_scenarios.py pins it."""
    b, c = bodies, nclass
    again = b if remat else 0
    if input_width is None:
        out = {f"{gather}_w{2 * hidden}": 3 * b + again}
    elif remat:
        raise ValueError("no count rule for remat with the hoist")
    else:
        out = {f"{gather}_w{input_width}": b + 1}
    out.update({f"{gather}_w{2 * c}": 3 * b + again,
                "k2_attn_fwd_d64": 2 * b + again,
                f"k2_attn_fwd_d{c}": 2 * b + again,
                "k3_attn_bwd_d64": b, f"k3_attn_bwd_d{c}": b})
    if k4:
        out["k4_auc_m2"] = b
    return out


def remat_counts(bodies, setup=1):
    """``joint_counts`` of the headline with ``remat``: the backward
    re-runs the train forward once, up to its last launch whose inputs
    autograd saved (torch's non-reentrant checkpoint stops there), so
    every K1 and K2 launch of the forward runs twice but the last, the
    paired eval branch's layer-2 K2, which feeds metrics only and saves
    nothing; the transpose, K3 and ``setup`` set-up gathers run once
    (tests/test_torch_experiment.py pins this rule on the CPU).  The
    sequential loop's remat form is ``sequential_counts(remat=True)``."""
    out = joint_counts(bodies, "k1_spmm", 7)
    for name in ("k1_spmm_w8", "k2_attn_fwd_d64"):
        out[name] *= 2
    out["k2_attn_fwd_d2"] = 3 * bodies
    out["k1_spmm_w7"] = 2 * bodies + setup
    return out


def drive_path(tag, data, cfg, masks_np, timed_epochs, expected,
               profile=True, group=None, profile_ops=None, replays=False,
               keep=None):
    """One path through the user's entry points: ``prepare_data`` (with
    ``group``, a process group: ``prepare_sharded_data`` and this rank's
    slabs), ``build_model``, a warm-up run (``cfg.epochs``), then a timed
    run of ``timed_epochs``, in the form ``make_split_runner`` takes by
    default (the first body eagerly, then replays of one captured CUDA
    graph; a sharded run on NCCL too); ms per loop body over the whole
    run and, when captured, over the replays (the run less its set-up:
    the eager first body and the capture), the capture's ms, finite
    losses, the best split result, every launch count against
    ``expected(bodies)``, and a profiler window (``replays``: of a run
    that replays the captured body once a body, not of a device loop);
    the allocator cache releases before its captures
    (``trainer._room_for_capture``).  ``keep``, a dict, receives the
    prepared ``ops`` and ``x``.  Returns (counts, ms per body over the
    whole timed run, timed result, the profile's ms per body by kernel
    group, ms per body over the replays or None)."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
        prepare_sharded_data,
    )

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if group is None:
        data, ops, x, y, y1h, nclass = prepare_data(data, cfg)
        masks = tuple(torch.from_numpy(m).cuda() for m in masks_np)
    else:
        prep = prepare_sharded_data(data, cfg, group=group)
        ops, x, y, y1h, nclass = (prep.ops, prep.x, prep.labels,
                                  prep.labels_onehot, prep.nclass)
        masks = tuple(prep.place(m) for m in masks_np)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    if keep is not None:
        keep.update(ops=ops, x=x)
    model = build_model(cfg, x.shape[1], nclass, nnodes=x.shape[0])
    releases = [0]

    def counted(empty_cache):
        def wrapper():
            releases[0] += 1
            return empty_cache()
        return wrapper

    warm = make_split_runner(model, cfg, group=group)
    with _wrapped(torch.cuda, "empty_cache", counted):
        _, warm_state = warm(ops, x, y, masks, seed=1, return_state=True,
                             labels_onehot=y1h)
    warm.release()    # its graph: the timed run captures its own
    torch.cuda.synchronize()
    timed = make_split_runner(model, dataclasses.replace(
        cfg, epochs=timed_epochs), group=group)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _loop_launches() as launched, \
            _wrapped(torch.cuda, "empty_cache", counted):
        res, state = timed(ops, x, y, masks, seed=2, return_state=True,
                           labels_onehot=y1h)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launches)
    launched[0] += int(warm_state.capture_ms is not None)
    bodies = warm_state.epoch + state.epoch
    ms_run = 1e3 * dt / state.epoch
    if not state.replays:
        ms_epoch, form = None, "eager"
    else:
        ms_epoch = (1e3 * dt - state.setup_ms) / state.replays
        form = (f"captured: capture {_ms(state.capture_ms)} ms, set-up "
                f"{state.setup_ms:.1f} ms, replays {ms_epoch:.3f} ms/epoch")
    losses = torch.cat([warm_state.train_losses, state.train_losses]).cpu()
    loop = "joint iterations" if cfg.joint else "sequential epochs"
    print(f"{tag} prepare {t_prep:.1f} s; {bodies} {loop}; timed run "
          f"{ms_run:.3f} ms/epoch over {state.epoch} ({form}); epochs_run "
          f"{res.epochs_run} of {timed_epochs} (early_stopping "
          f"{cfg.early_stopping}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; allocator "
          f"cache released before a capture {releases[0]} times (warm-up "
          f"and timed run)")
    print(f"{tag} train loss first {float(losses[0]):.5f} last "
          f"{float(losses[-1]):.5f}; best val {cfg.metric} "
          f"{float(res.val_metric):.4f} test {cfg.metric} "
          f"{float(res.test_metric):.4f}")
    if not torch.isfinite(losses).all():
        fail(f"{tag} non-finite training loss")
    want = expected(bodies)
    print(f"{tag} launches {json.dumps(counts, sort_keys=True)}")
    if without_loop_kernels(counts) != want:
        fail(f"{tag} launch counts {counts} != expected {want}")
    if state.replays and launched[0] != 2:
        fail(f"{tag} {launched[0]} device-loop launches for the warm-up "
             f"and the timed run, not one each")
    check_loop_kernels(tag, counts, cfg, bodies, launched[0],
                       warm_state.replays + state.replays)
    groups = {}
    if profile:
        def run_of(epochs):
            c = dataclasses.replace(cfg, epochs=epochs)
            return _bodies(c, make_split_runner(model, c, group=group)(
                ops, x, y, masks, seed=3, labels_onehot=y1h))

        groups = phase_profile(tag, run_of, ops_out=profile_ops,
                               replays=replays)
    return counts, ms_run, res, groups, ms_epoch


def phase_main_path(adj, feats, labels):
    from acmgnn_tpu_torch.ops.graph import GraphData

    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    counts, ms_run, _, _, ms_replay = drive_path(
        "[3]", data, headline_config(), _masks(adj.shape[0]), TIMED_EPOCHS,
        lambda it: joint_counts(it, "k1_spmm", 7))
    return counts, (ms_run, ms_replay)


def phase_genius_paths(adj, feats, labels, masks_np):
    """The genius ROC-AUC configuration through the joint loop on ELL and
    on COO, then the sequential loop without and with early stopping."""
    from acmgnn_tpu_torch.ops.graph import GraphData

    data = GraphData("genius-scale", adj, feats, labels)
    out = {}
    out["ell"] = drive_path(
        "[5b ell]", data, genius_config(), masks_np, GENIUS_TIMED_EPOCHS,
        lambda it: joint_counts(it, "k1_spmm", 12, k4=True))
    out["coo"] = drive_path(
        "[5b coo]", data, genius_config(operator_format="coo"), masks_np,
        GENIUS_TIMED_EPOCHS,
        lambda it: joint_counts(it, "k5_coo", 12, k4=True))
    out["seq"] = drive_path(
        "[5b seq]", data, genius_config(joint=False), masks_np,
        GENIUS_SEQ_EPOCHS, lambda b: sequential_counts(b, "k1_spmm", 12))
    out["seq_es"] = drive_path(
        "[5b seq+es]", data, genius_config(joint=False,
                                           early_stopping=GENIUS_ES),
        masks_np, GENIUS_SEQ_EPOCHS,
        lambda b: sequential_counts(b, "k1_spmm", 12), profile=False)
    out["stop_flag_ms"] = phase_stop_flag_cost(data, masks_np)
    return out


KEPT_PAIRS = 6                   # 5d's pairs on kept runners (steady)


def phase_stop_flag_cost(data, masks_np, pairs: int = 10):
    """What the sequential loop pays for its early-stopping rule in the
    captured form (since PR 15 a device loop whose K9 reads the flag; PR
    14's host read it once an epoch): runs of ``GENIUS_SEQ_EPOCHS`` epochs
    without early stopping and with it (window ``GENIUS_ES``), in
    alternating pairs, each a new runner (its eager first body and
    capture inside the timed run, as before PR 15); then the same pairs
    on one kept runner per arm, each call one device-loop launch and one
    read of ``k`` (the steady cost, without a capture's host noise); then
    one profile of each arm (the host's waits for the device per epoch).
    Both arms get an empty val mask, so the val loss is 0 every epoch: the
    rule is evaluated after every epoch and never fires."""
    import torch

    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    cfg = genius_config(joint=False, epochs=GENIUS_SEQ_EPOCHS)
    _, ops, x, y, y1h, nclass = prepare_data(data, cfg)
    model = build_model(cfg, x.shape[1], nclass)
    m = masks_np.copy()
    m[1] = False
    masks = tuple(torch.from_numpy(t).cuda() for t in m)
    make_split_runner(model, dataclasses.replace(cfg, epochs=WARM_EPOCHS))(
        ops, x, y, masks, labels_onehot=y1h)
    ms = {0: [], GENIUS_ES: []}
    for i in range(pairs):
        for es in ((0, GENIUS_ES) if i % 2 == 0 else (GENIUS_ES, 0)):
            run = make_split_runner(model, dataclasses.replace(
                cfg, early_stopping=es))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(ops, x, y, masks, seed=i, labels_onehot=y1h)
            torch.cuda.synchronize()
            if res.epochs_run != GENIUS_SEQ_EPOCHS:
                fail(f"[5d] early_stopping={es} stopped at {res.epochs_run}")
            ms[es].append(1e3 * (time.perf_counter() - t0) / GENIUS_SEQ_EPOCHS)
    diffs = sorted(b - a for a, b in zip(ms[0], ms[GENIUS_ES]))
    median = float(np.median(diffs))
    # the host's contention only ever adds time, so each arm's fastest run
    # is its least disturbed one
    low = min(ms[GENIUS_ES]) - min(ms[0])
    kept = {es: make_split_runner(model, dataclasses.replace(
        cfg, early_stopping=es)) for es in (0, GENIUS_ES)}
    for run in kept.values():          # the eager first body, the capture
        run(ops, x, y, masks, labels_onehot=y1h)
    steady = {0: [], GENIUS_ES: []}
    for i in range(KEPT_PAIRS):
        for es in ((0, GENIUS_ES) if i % 2 == 0 else (GENIUS_ES, 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = kept[es](ops, x, y, masks, seed=i, labels_onehot=y1h)
            torch.cuda.synchronize()
            if res.epochs_run != GENIUS_SEQ_EPOCHS:
                fail(f"[5d] early_stopping={es} stopped at {res.epochs_run}")
            steady[es].append(1e3 * (time.perf_counter() - t0)
                              / GENIUS_SEQ_EPOCHS)
    s_diffs = sorted(b - a for a, b in zip(steady[0], steady[GENIUS_ES]))
    s_median = float(np.median(s_diffs))
    print(f"[5d] steady (one kept runner per arm, one device-loop launch a "
          f"run): ms/epoch without {[round(v, 4) for v in steady[0]]}, with "
          f"{[round(v, 4) for v in steady[GENIUS_ES]]}; paired differences "
          f"{[round(v, 4) for v in s_diffs]}, median {s_median:.4f} "
          f"ms/epoch ({CARD_LINE}); prediction (PERF.md, PR 15) within "
          f"+-0.03: {'held' if abs(s_median) <= 0.03 else 'missed'}")
    print(f"[5d] stop rule, sequential loop (captured: a device loop whose "
          f"K9 reads the flag; the host reads k once a run), "
          f"{GENIUS_SEQ_EPOCHS} epochs per run, {pairs} alternating pairs: "
          f"ms/epoch without {[round(v, 3) for v in ms[0]]}, with "
          f"early_stopping={GENIUS_ES} {[round(v, 3) for v in ms[GENIUS_ES]]}"
          f"; paired differences {[round(v, 3) for v in diffs]}, median "
          f"{median:.3f}; fastest with minus fastest without {low:.3f} "
          f"ms/epoch ({CARD_LINE}); prediction (PERF.md, PR 15) within "
          f"+-0.03: {'held' if abs(median) <= 0.03 else 'missed'}")
    for es in (0, GENIUS_ES):
        def run_of(epochs, es=es):
            c = dataclasses.replace(cfg, epochs=epochs, early_stopping=es)
            return _bodies(c, make_split_runner(model, c)(
                ops, x, y, masks, labels_onehot=y1h))

        phase_profile(f"[5d early_stopping={es}]", run_of,
                      epochs=PROFILE_EPOCHS + GENIUS_ES)
    return median


K8_REPLACES = ("none (flax nn.Dropout under fold_in(run_key, epoch), "
               "acmgnn_tpu/train/trainer.py:235; XLA's, not a Pallas kernel)")
K9_REPLACES = ("none (the lax.while_loop condition, "
               "acmgnn_tpu/train/trainer.py:296; XLA's, not a Pallas kernel)")
K8_SHAPE = (168_114, 64)         # the headline's hidden width (layer 1's
#                                  output, the site with a backward)
K9_BODIES = 10_000


def _k8_bound(elems, read, write):
    """K8's least time: ``read`` and ``write`` bytes an element, or its
    Philox work (10 rounds of 4 multiplies and 4 other 32-bit operations
    for four elements, and the threshold: ~12 an element) at the card's
    32-bit integer rate, whichever is larger."""
    t_bytes = 1e3 * elems * (read + write) / HBM_BYTES_PER_S
    t_ops = 1e3 * elems * 12 / INT32_OPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _k8_wiki_slabs(D, key, gen):
    """K8 at wiki's full input: one launch over ``[WIKI n, WIKI f]`` f32
    (1.16e9 elements, 4.6 GB), and its hidden ``[WIKI n, 64]``, each held
    bit for bit to ``dropout_plain`` on slabs of 2^20 elements: the first,
    seven spread through the tensor, and the last, which starts off a
    multiple of 4 (the plain version over the whole would need ~25 GB of
    int64 temporaries).  The counter's high word stays 0 at this count
    (it counts Philox calls, 4 elements each, from 2^32: 2^34 elements,
    twice the card's memory in f32).  Returns the elements checked."""
    import torch

    checked = 0
    for width in (WIKI["f"], K8_SHAPE[1]):
        h = torch.randn(WIKI["n"], width, generator=gen, device="cuda")
        out = D._launch(h, 0.5, key, 3).reshape(-1)
        flat = h.reshape(-1)
        n = flat.numel()
        slab = min(1 << 20, n // 9)
        starts = [0] + [(n // 8) * j + 4 * j + 1 for j in range(1, 8)] + [
            n - slab]
        for s0 in starts:
            if not torch.equal(out[s0:s0 + slab], D.dropout_plain(
                    flat[s0:s0 + slab], 0.5, key, 3, start=s0)):
                fail(f"[12] K8 at [{WIKI['n']}, {width}] f32 differs from "
                     f"its plain version in elements {s0}..{s0 + slab}")
            checked += slab
        del h, out, flat
    torch.cuda.empty_cache()
    return checked


def phase_loop_kernels(counts):
    """[12] K8 (dropout) and K9 (the device loop's condition), the two
    kernels of this slice with no TPU counterpart.  K8 bit for bit
    against its plain version, forward and backward, f32 and bf16, at the
    headline's widths (input 7, hidden 64, N=168,114) and after its epoch
    tensor changed, and at wiki's full element counts (``_k8_wiki_slabs``);
    timed in turns at the hidden width beside the bound, the plain version
    and ``F.dropout`` / ``native_dropout_backward``.  K9: a device loop of
    a one-kernel body stops where its plain condition stops it (the
    limit, a stop flag the body sets, a limit already reached); its cost
    per iteration over ``K9_BODIES`` bodies in one launch beside the same
    body replayed once a body with the host reading the condition (the
    eager loop's form).  Returns the kernel rows (launches from phase
    3's main path)."""
    import torch
    import torch.nn.functional as F

    from acmgnn_tpu_torch.ops import dropout as D
    from acmgnn_tpu_torch.ops.loop import DeviceLoop, loop_condition
    from acmgnn_tpu_torch.train import trainer

    gen = torch.Generator(device="cuda").manual_seed(12)
    epoch = torch.tensor(7, device="cuda")
    key = D.DropoutKey.new(3, 0, epoch)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for width in (7, K8_SHAPE[1]):
            h = torch.randn(K8_SHAPE[0], width, generator=gen,
                            device="cuda").to(dtype)
            g = torch.randn(K8_SHAPE[0], width, generator=gen, device="cuda")
            for e in (7, 8):
                epoch.fill_(e)
                out = D._launch(h, 0.5, key, 1)
                back = D._launch(g, 0.5, key, 1, name="k8_dropout_bwd")
                if not (torch.equal(out, D.dropout_plain(h, 0.5, key, 1))
                        and torch.equal(back, D.dropout_plain(
                            g, 0.5, key, 1))):
                    fail(f"[12] K8 {dtype} w{width} epoch {e} differs from "
                         f"its plain version")
                checked += 1
    epoch.fill_(7)
    wiki_checked = _k8_wiki_slabs(D, key, gen)
    n = K8_SHAPE[0] * K8_SHAPE[1]
    h = torch.randn(*K8_SHAPE, generator=gen, device="cuda")
    g = torch.randn(*K8_SHAPE, generator=gen, device="cuda")
    forms = {
        "fwd": lambda: D._launch(h, 0.5, key, 1),
        "bwd": lambda: D._launch(g, 0.5, key, 1, name="k8_dropout_bwd"),
    }
    t = {k: [] for k in forms}
    for i in range(4):
        for k in (forms if i % 2 == 0 else reversed(list(forms))):
            t[k].append(time_ms(forms[k], 50))
    ms = {k: float(np.median(v)) for k, v in t.items()}
    dev = {k: device_ms(f) for k, f in forms.items()}
    plain_ms = time_ms(lambda: D.dropout_plain(h, 0.5, key, 1), 5)
    lib_f = lambda: F.dropout(h, 0.5, True)          # noqa: E731
    _, lib_mask = torch.ops.aten.native_dropout(h, 0.5, True)
    lib_b = lambda: torch.ops.aten.native_dropout_backward(  # noqa: E731
        g, lib_mask, 2.0)
    lib = {"fwd": (time_ms(lib_f, 50), device_ms(lib_f)),
           "bwd": (time_ms(lib_b, 50), device_ms(lib_b))}
    print(f"[12] K8 bit-equal to its plain version in {checked} cases "
          f"(fwd and bwd; f32, bf16; w7, w64 at N={K8_SHAPE[0]}; two "
          f"epochs) and on {wiki_checked} elements of one launch each at "
          f"[{WIKI['n']}, {WIKI['f']}] and [{WIKI['n']}, {K8_SHAPE[1]}] "
          f"f32 (18 slabs); at {list(K8_SHAPE)} f32, medians of 4 turns: "
          f"fwd {ms['fwd']:.4f} ms (device {_ms(dev['fwd'])}), bwd "
          f"{ms['bwd']:.4f} ({_ms(dev['bwd'])}); plain {plain_ms:.3f}; "
          f"F.dropout {lib['fwd'][0]:.4f} (device {_ms(lib['fwd'][1])}), "
          f"native_dropout_backward {lib['bwd'][0]:.4f} "
          f"({_ms(lib['bwd'][1])}) ({CARD_LINE})")
    rows = []
    for side in ("fwd", "bwd"):
        b_ms, b_by = _k8_bound(n, 4, 4)
        rows.append(dict(
            name=f"k8_dropout_{side}_d{K8_SHAPE[1]}",
            counter=f"k8_dropout_{side}", route="cuda",
            source="acmgnn_tpu_torch/csrc/dropout.cu", replaces=K8_REPLACES,
            max_abs_err=0.0, ms=ms[side], device_ms=dev[side],
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib[side][0], library_device_ms=lib[side][1],
            path="headline (twitch-gamers, joint, ELL): launches phase 3, "
                 "timed phase 12",
            launches=counts.get(f"k8_dropout_{side}", 0)))

    # K9: a body of one kernel that sets the stop flag at k == stop_at
    k = torch.zeros((), dtype=torch.int64, device="cuda")
    limit = torch.zeros((), dtype=torch.int64, device="cuda")
    stop = torch.zeros((), dtype=torch.bool, device="cuda")
    stop_at = torch.tensor(37, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        def body():
            k.add_(1)
            torch.ge(k, stop_at, out=stop)

        body()
        graph = trainer._capture(body, keep_graph=True)
        loop = DeviceLoop(graph.graph, k, limit, stop)

        def run(start, lim, at):
            k.fill_(start)
            stop.zero_()
            limit.fill_(lim)
            stop_at.fill_(at)
            loop.launch()
            return int(k)

        def plain(start, lim, at):
            kk = start
            while bool(loop_condition(torch.tensor(kk), torch.tensor(lim),
                                      torch.tensor(kk >= at and kk != start))):
                kk += 1
            return kk

        cases = [(0, 50, 37), (0, 20, 37), (5, 5, 37), (0, 1, 37)]
        got = [run(*c) for c in cases]
        want = [plain(*c) for c in cases]
        if got != want:
            fail(f"[12] K9's loop stopped at {got}, its plain condition at "
                 f"{want}")
        stop_at.fill_(2 ** 62)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        k.zero_()
        limit.fill_(K9_BODIES)
        t0.record()
        loop.launch()
        t1.record()
        t1.synchronize()
        loop_ms = t0.elapsed_time(t1) / K9_BODIES
        k.zero_()
        limit.fill_(200)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        while bool(loop_condition(k, limit, stop)):
            graph.replay()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - h0) / 200
        loop.destroy()
        graph.graph.reset()
    torch.cuda.current_stream().wait_stream(side)
    b_ms = 1e3 * (8 + 8 + 1) / HBM_BYTES_PER_S
    print(f"[12] K9: the device loop stops where its plain condition does "
          f"({list(zip(cases, got))}: (k, limit, stop at) -> k); "
          f"{loop_ms:.5f} ms an iteration over {K9_BODIES} bodies of one "
          f"kernel in one launch (K9, the conditional node and the body), "
          f"against {host_ms:.4f} ms a body replayed with the host reading "
          f"the condition after each ({CARD_LINE})")
    rows.append(dict(
        name="k9_loop_cond", counter=LOOP_COUNTER, route="cuda",
        source="acmgnn_tpu_torch/csrc/loop.cu", replaces=K9_REPLACES,
        max_abs_err=0.0, ms=loop_ms, device_ms=loop_ms, plain_ms=host_ms,
        bound_ms=b_ms, bound_by="bytes", library_ms=None,
        library_device_ms=None,
        path="headline (twitch-gamers, joint, ELL): launches phase 3, "
             "timed phase 12",
        launches=counts.get(LOOP_COUNTER, 0)))
    return rows


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "spmm_rows_kernel" in name or "spmm_wide_kernel" in name:
        return "K1 spmm"
    if "attn_fwd_kernel" in name:
        return "K2 attention fwd"
    if "attn_bwd" in name:           # attn_bwd_kernel and its finish
        return "K3 attention bwd"
    if "rocauc_pass_kernel" in name:
        return "K4 auc"
    if "coo_slices_kernel" in name or "coo_spans_kernel" in name:
        return "K5 coo"
    if "halo_pack_kernel" in name:
        return "K6 halo pack"
    if "dropout_kernel" in name:
        return "K8 dropout"
    if "loop_cond_kernel" in name:
        return "K9 loop condition"
    if "nccl" in low:
        return "NCCL collectives"
    if "sort" in low:
        return "torch.sort"
    if any(k in low for k in ("cusparse", "csrmm", "spmm", "csr2")):
        return "torch.sparse (cuSPARSE)"
    if "index" in low or "scatter" in low:
        return "indexing (index_add/gather/scatter)"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                              "splitk")):
        return "cuBLAS GEMM"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    return "other (ATen elementwise, reductions, Adam)"


ANNOTATION = re.compile(r"[\w.]+#[\w.]+")


LOOP_MARK = "acm.device_loop"


def replay_window(events, bodies=None):
    """Where the steady bodies of a profiled split run begin on the host's
    clock, and how many there are, from a torch.profiler window's
    ``events``: in a device loop (``LOOP_MARK`` ranges around its
    launches), at the first launch, with the run's ``bodies`` less the
    eager first; replayed a body at a time, at the end of the capture
    (``cudaGraphInstantiate``), one body per ``cudaGraphLaunch`` after
    it; eager, ``(-inf, None)``: the whole run."""
    loops = [e.time_range.start for e in events if e.name == LOOP_MARK]
    if loops and bodies is not None:
        return min(loops), bodies - 1
    ends = [e.time_range.end for e in events
            if e.name.startswith("cudaGraphInstantiate")]
    if not ends:
        return -math.inf, None
    start = max(ends)
    return start, sum(1 for e in events if e.name == "cudaGraphLaunch"
                      and e.time_range.start >= start)


def device_ops(events, start=-math.inf):
    """``({name: (device µs, count)}, end)``: the operations that ran on
    the card from host-clock time ``start`` on in a torch.profiler
    window's ``events`` (each counted once), and the last one's end."""
    tally: dict = {}
    end = start
    for e in events:
        if ("cuda" not in str(e.device_type).lower() or _is_annotation(e)
                or e.time_range.end <= 0 or e.time_range.start < start):
            continue
        us, cnt = tally.get(e.name, (0.0, 0))
        tally[e.name] = (us + e.time_range.end - e.time_range.start, cnt + 1)
        end = max(end, e.time_range.end)
    return tally, end


def _is_annotation(e) -> bool:
    # ranges such as Optimizer.step#Adam.step span kernels counted on
    # their own already (a kernel's name may hold "#" too: ATen's lambda
    # kernels, "...{lambda(float)#1}...")
    return bool(getattr(e, "is_user_annotation", False)
                or ANNOTATION.fullmatch(e.key))


def _bodies(cfg, res) -> int:
    """The loop bodies of a run that did not stop early, from its
    result: the joint loop runs one more than its epochs.  (A profiled
    run asks for no ``return_state``: its copies would fall inside the
    window.)"""
    from acmgnn_tpu_torch.train.trainer import JOINT_CAPABLE

    return res.epochs_run + int(bool(cfg.joint)
                                and cfg.model_type in JOINT_CAPABLE)


LOOP_COUNTER = "k9_loop_cond"


def without_loop_kernels(counts):
    """``counts`` without K8's and K9's counters: the launch counts that
    the path's ``expected`` functions hold (K1-K7); K8 and K9 are held on
    their own (``check_loop_kernels``, phase 12)."""
    return {k: v for k, v in counts.items()
            if not k.startswith(("k8_", "k9_"))}


def k8_per_body(cfg):
    """K8's (forward, backward) launches per loop body for the ACM
    models the paths run: the input and layer 1's output are dropped in
    the train branch (acmgcnpp also its skip branch), and the input's
    backward is never launched (the features take no gradient); remat's
    recompute draws every forward site again; None where the rule is not
    written down (other model types)."""
    if cfg.dropout == 0.0:
        return 0, 0
    sites = {"acmgcn": 2, "acmgcnp": 2, "acmgcnpp": 3}.get(cfg.model_type)
    if sites is None:
        return None
    return sites * (2 if cfg.remat else 1), sites - 1


def check_loop_kernels(tag, counts, cfg, bodies, loop_launches, replays):
    """K8 as ``k8_per_body`` implies for ``bodies`` bodies (at least one
    launch where the rule is not written down), and K9 once per device
    loop launch plus once per body it ran (``replays``)."""
    per = k8_per_body(cfg)
    got = (counts.get("k8_dropout_fwd", 0), counts.get("k8_dropout_bwd", 0))
    if per is None:
        ok = got[0] > 0
    else:
        ok = got == (per[0] * bodies, per[1] * bodies)
    k9 = counts.get(LOOP_COUNTER, 0)
    print(f"{tag} K8 launches (fwd, bwd) {got}"
          + ("" if per is None else f", {per} a body expected")
          + f"; K9 {k9} ({loop_launches} device-loop launches, {replays} "
          f"bodies in them)")
    if not ok:
        fail(f"{tag} K8 launches {got} for {bodies} bodies, expected "
             f"{per} a body")
    if k9 != loop_launches + replays:
        fail(f"{tag} K9 ran {k9} times, not {loop_launches} + {replays}")


@contextlib.contextmanager
def _loop_launches():
    """Counts ``DeviceLoop.launch`` calls in the block (one a runner call
    on the card).  Yields a one-element list."""
    from acmgnn_tpu_torch.ops.loop import DeviceLoop

    made = [0]

    def make(launch):
        def wrapper(self):
            made[0] += 1
            return launch(self)
        return wrapper

    with _wrapped(DeviceLoop, "launch", make):
        yield made


def body_node_types(runner):
    """The node types of ``runner``'s captured body (``ops.loop.node_types``)
    as ``{type: count}``, None before a capture."""
    import collections

    from acmgnn_tpu_torch.ops.loop import node_types

    kept = runner.kept()
    if kept is None or kept.loop.graph is None:
        return None
    return dict(collections.Counter(
        t for t in node_types(kept.loop.graph.graph) if t not in "[]"))


def phase_profile(tag, run_of, epochs=PROFILE_EPOCHS, ops_out=None,
                  replays=False):
    """Device time by kernel group, device operations, the device's busy
    share and the host's waits for the device, per steady loop body:
    ``run_of(epochs)`` runs one split (and returns its bodies) under
    torch.profiler.  Captured, the window runs from the end of the
    capture (``cudaGraphInstantiate``; the card waits for the eager first
    body before it) to the last device operation's end, and holds the
    replays (one ``cudaGraphLaunch`` each) with what the host does
    between them; eager, it is the whole run.  Returns the
    groups' ms per loop body ({} where nothing was recorded); ``ops_out``,
    a dict, receives each group's device operations per body and, under
    "wall"/"busy", the window's ms per body.  ``replays``: the run replays
    its captured body once a body (``Replay.run`` without its device
    loop), so the window holds replays: inside a device loop the profiler
    has misfiled wiki's groups (ROADMAP.md A5)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmgnn_tpu_torch.train import trainer

    def settled(capture):
        # the eager first body's device work ends before the capture, so
        # none of it falls in the window (wiki's body outlasts the
        # capture's host time)
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            return capture(*a, **k)
        return wrapper

    from acmgnn_tpu_torch.ops.loop import DeviceLoop

    def marked(launch):
        # the loop's launch on the profiler's clock: the window starts
        # there (the capture's graph is not instantiated on its own)
        def wrapper(self):
            torch.cuda.synchronize()
            with torch.profiler.record_function(LOOP_MARK):
                return launch(self)
        return wrapper

    def replayed(run):
        def wrapper(self, *a, device_loop=None, **k):
            return run(self, *a, **k)
        return wrapper

    torch.cuda.synchronize()
    with _wrapped(trainer, "_capture", settled), \
            _wrapped(DeviceLoop, "launch", marked), \
            (_wrapped(trainer.Replay, "run", replayed) if replays
             else contextlib.nullcontext()), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bodies = run_of(epochs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = list(prof.events())
    start, replays = replay_window(events, bodies)
    dev, end = device_ops(events, start)
    form = "eager: the whole run"
    if replays is not None:
        bodies, wall_us = replays, (end - start if dev else 0.0)
        form = ("captured: the device loop's bodies, from its launch"
                if any(e.name == LOOP_MARK for e in events) else
                "captured: the replays, from the end of the capture")
    host = [e for e in events if "cuda" not in str(e.device_type).lower()
            and e.time_range.start >= start]
    n_ops = sum(cnt for _, cnt in dev.values())
    groups: dict = {}
    counts: dict = {}
    for key, (us, cnt) in dev.items():
        g = _kernel_group(key)
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + cnt
    busy = sum(groups.values())
    if ops_out is not None and bodies > 0:
        ops_out.update({g: c / bodies for g, c in counts.items()})
        ops_out.update(wall=wall_us / 1e3 / bodies,
                       busy=busy / 1e3 / bodies)
    if bodies <= 0 or busy <= 0 or wall_us <= 0:
        print(f"{tag} profile: no device time recorded in the steady "
              f"bodies (not measured)")
        return {}
    print(f"{tag} profile of {bodies} loop bodies ({form}; profiler on): "
          f"wall {wall_us / 1e3 / bodies:.3f} ms/epoch, device busy "
          f"{busy / 1e3 / bodies:.3f} ms/epoch, busy share "
          f"{busy / wall_us:.3f}, {n_ops / bodies:.1f} device "
          f"operations/epoch")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3 / bodies:.4f} ms/epoch "
              f"({us / busy:.3f} of device time)")
    for key, (us, cnt) in sorted(dev.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {us / 1e3 / bodies:.4f} ms/epoch x{cnt / bodies:.1f} "
              f"{key[:90]}")
    # the host side: where its time goes, and every call that makes it
    # wait for the device (a wait stops the host from running ahead)
    by_name: dict = {}
    for e in host:
        us, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.self_cpu_time_total, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"{tag} host self time by operation (profiler on), top 8: "
          + "; ".join(f"{key[:40]} {us / 1e3 / bodies:.3f} ms "
                      f"x{cnt / bodies:.1f}" for key, (us, cnt) in top))
    # replayed a body at a time: the waits between the first replay's
    # launch and the last one's, per interval (the run's closing waits
    # fall after it); a device loop is one launch, whose run ends in the
    # host's one read of k: its waits are counted over its bodies
    launches = sorted(e.time_range.start for e in events
                      if e.name == "cudaGraphLaunch"
                      and e.time_range.start >= start)
    inside, per = host, bodies
    if len(launches) > 1:
        inside = [e for e in host
                  if launches[0] <= e.time_range.start < launches[-1]]
        per = len(launches) - 1
    waits: dict = {}
    for e in inside:
        if "ynchronize" in e.name:
            us, cnt = waits.get(e.name, (0.0, 0))
            waits[e.name] = (us + e.self_cpu_time_total, cnt + 1)
    print(f"{tag} host waits for the device per epoch"
          f"{' (between replays)' if len(launches) > 1 else ''}: "
          + ("; ".join(f"{key} x{cnt / per:.2f} {us / 1e3 / per:.3f} ms"
                       for key, (us, cnt) in waits.items()) or "none"))
    return {g: us / 1e3 / bodies for g, us in groups.items()}


def trained(data, cfg, masks_np, device, seed=3):
    """One split of ``cfg`` on ``device`` from ``build_model(seed)`` in the
    card's optimizer arithmetic (``capturable``, see ``make_optimizer``):
    the result and the final parameters on the host."""
    import torch

    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    _, ops, x, y, y1h, nclass = prepare_data(data, cfg, device=device)
    model = build_model(cfg, x.shape[1], nclass, device=device, seed=seed,
                        nnodes=x.shape[0])
    masks = tuple(torch.from_numpy(m).to(device) for m in masks_np)
    res = make_split_runner(model, cfg, capturable=True)(
        ops, x, y, masks, labels_onehot=y1h)
    return res, {k: p.detach().cpu() for k, p in model.named_parameters()}


def max_param_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def card_vs_cpu(tag, data, cfg, masks_np, tol=1e-4, seed=3):
    """One configuration trained on the card (kernels) and on the CPU
    (plain versions) by ``trained`` from the same initial parameters
    (``seed``): final parameters within ``tol``, split results within
    ``tol`` relative, equal epochs_run."""
    out = {device: trained(data, cfg, masks_np, device, seed)
           for device in ("cuda", "cpu")}
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    worst = max_param_diff(pg, pc)
    print(f"{tag} card vs CPU, {cfg.epochs} epochs (early_stopping "
          f"{cfg.early_stopping}): max |Δparam| {worst:.3e} (tolerance "
          f"{tol:g}); epochs_run {rg.epochs_run}/{rc.epochs_run}")
    for f in ("test_metric", "val_metric", "val_loss", "train_loss"):
        a, b = float(getattr(rg, f)), float(getattr(rc, f))
        print(f"  {f}: card {a:.6f} cpu {b:.6f}")
        if not abs(a - b) <= tol * max(1.0, abs(b)):
            fail(f"{tag} card and CPU disagree on {f}")
    if worst > tol or rg.epochs_run != rc.epochs_run:
        fail(f"{tag} card and CPU parameters disagree")
    return rg


def phase_card_vs_cpu():
    """Small graph, dropout 0, f32 gathers: the card's kernels against the
    CPU's plain versions.  Features are made non-negative (here and in
    phase 5c): with near-zero row sums the row normalization makes the
    fast LayerNorm variance cancel and summation order alone moves two
    runs apart (tests/test_torch_trainer.py)."""
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    adj, feats, labels = twitch_gamers_scale_graph(0, n=2000, pairs=40_000)
    card_vs_cpu("[4]", GraphData("small", adj, np.abs(feats), labels),
                knob_check_config(), _masks(2000))


def phase_genius_card_vs_cpu():
    """The genius configuration on a small stand-in (dropout 0, f32): the
    joint loop on ELL and on COO over 40 epochs, and the sequential loop
    with an early stop (window 5) that fires before its 60 epochs.  Card
    and CPU sum in other orders; phase 5a shows K1 equal to its own order
    replayed, so what is left between them is rounding, which this
    configuration does not amplify
    (tests/test_torch_rocauc_trainer.py)."""
    from acmgnn_tpu_torch.data.synthetic_scale import linkx_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    adj, feats, labels = linkx_scale_graph("genius", n=2000, e=5000,
                                           max_deg=150)
    data = GraphData("small-genius", adj, np.abs(feats), labels)
    small = dict(hidden=16, dropout=0.0, spmm_dtype="float32", epochs=40)
    masks = _masks(2000, seed=1)
    card_vs_cpu("[5c ell]", data, genius_config(**small), masks)
    card_vs_cpu("[5c coo]", data, genius_config(operator_format="coo",
                                                **small), masks)
    res = card_vs_cpu("[5c seq+es]", data, genius_config(
        joint=False, **dict(small, epochs=60, early_stopping=5)), masks)
    if res.epochs_run >= 60:
        fail("[5c seq+es] the early stop did not fire")


# ---------------------------------------------------------------------------
# Phase 6: the sharded path (B6: K6, the exchange, K1/K5 on local halves)
# ---------------------------------------------------------------------------

SHARDED_P = 4                    # ranks of phases 6a and 6c
# phase 6c's runs: (exchange, format, gather dtype); the f32 runs are held
# to the single-chip port, each halo run to its all-gather twin
SHARDED_RUNS = (("allgather", "ell", "float32"), ("halo", "ell", "float32"),
                ("allgather", "coo", "float32"), ("halo", "coo", "float32"),
                ("allgather", "ell", "bfloat16"), ("halo", "ell", "bfloat16"))
# phase 6c's twitch-shaped graph: ~20k nodes at the full graph's density,
# non-negative features, labels a function of the features.  The parity
# check trains it at lr 1e-3 without weight decay: with the stand-in's
# random labels at the headline's lr 0.01 and weight decay 1e-3, Adam
# steps of ±lr on weights near zero turn rounding into ~1e-2 parameter
# differences within 20 epochs, whatever the path.  Phase 6c prints how
# far two summation orders of the single-chip port part on the
# configuration it checks; tests/test_torch_sharded.py pins that below
# 1e-5 on the CPU.
SMALL_TWITCH = dict(n=20_000, pairs=808_700)
SHARDED_CHECK_EPOCHS = 20
SHARDED_CAPTURE_EPOCHS = 20      # 6b, 11b: the captured sharded loop's
#                                  run against its eager form
RANK_DEADLINE_S = 420
K6_REPLACES = "acmgnn_tpu/parallel/sharded.py:493"
K1_LOCAL_REPLACES = "acmgnn_tpu/parallel/sharded.py:450"
K5_LOCAL_REPLACES = "acmgnn_tpu/parallel/sharded.py:614"


def sharded_counts(bodies):
    """Launches a sharded joint run of the headline implies: K6 packs the
    operand of every product before K1 (the hoist's input gather at
    set-up included), K2/K3 as on one card."""
    out = joint_counts(bodies, "k1_spmm", 7)
    out.update({f"k6_pack_w{d}": out[f"k1_spmm_w{d}"] for d in (7, 8, 4)})
    return out


def _slab_of(t, boundaries, rpp, p):
    """Rank p's zero-padded ``[rpp, d]`` slab of a ``[N, d]`` tensor."""
    import torch

    r0, r1 = int(boundaries[p]), int(boundaries[p + 1])
    out = torch.zeros(rpp, t.shape[1], dtype=t.dtype, device=t.device)
    out[: r1 - r0] = t[r0:r1]
    return out


def _k6_bound(rows, d, ld, n_send, gsz, pre):
    """K6's bytes: the slab (and pre-scale) and send lists read once, own
    and send rows written once at the row stride ``ld`` (the padding is
    written too); one multiply per element."""
    nbytes = 4 * rows * d + (4 * rows if pre else 0) + 4 * n_send \
        + gsz * (rows + n_send) * ld
    return bound(nbytes, 2 * rows * d)


def _local_csr(half):
    """f32 ``torch.sparse_csr_tensor`` of a rank's half over its receive
    buffer, rows in the half's stored order (the library yardstick)."""
    import torch

    if hasattr(half, "indptr"):
        crow, col = half.indptr, half.indices.long()
        vals = (half.vals if half.vals is not None
                else torch.ones(col.numel(), device=col.device))
    else:
        counts = torch.bincount(half.row.long(), minlength=half.num_rows)
        crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        col, vals = half.col.long(), half.val
    return torch.sparse_csr_tensor(crow, col, vals,
                                   size=(half.num_rows, half.num_cols),
                                   check_invariants=False)


def _check_k6(xs, out_dtype, ld, pre, sign, send_idx, what):
    """K6 against ``halo_pack_plain`` into rows of stride ``ld``, bit for
    bit on the whole padded buffers (they start as NaN, so padding K6
    leaves unwritten fails); returns (own, send, max |K6 - plain|), own
    and send as ``[rows, d]`` views of their padded rows."""
    import torch

    from acmgnn_tpu_torch.ops.halo import (
        halo_pack,
        halo_pack_plain,
        padded_rows,
    )

    rows, d = xs.shape
    bufs = [torch.full((rows, ld), float("nan"), dtype=out_dtype,
                       device=xs.device) for _ in range(2)]
    own, own_p = bufs[0][:, :d], bufs[1][:, :d]
    send = halo_pack(xs, own, pre_scale=pre, sign=sign, send_idx=send_idx,
                     ld=ld)
    send_p = halo_pack_plain(xs, own_p, pre, sign, send_idx, ld=ld)
    torch.cuda.synchronize()
    pairs = [tuple(bufs)]
    if send is not None:
        pairs.append((padded_rows(send), padded_rows(send_p)))
    if not all(torch.equal(a, b) for a, b in pairs):
        fail(f"{what}: K6 differs from its plain version (padding "
             f"included)")
    err = max(float((a.float() - b.float()).abs().max()) if a.numel()
              else 0.0 for a, b in pairs)
    return own, send, err


def phase_sharded_kernels(adj, feats):
    """[6a] The headline graph partitioned over 4 ranks in this one
    process, with all-gather and with halo exchange forced: K6 on every
    rank's slabs bit-equal to its plain version (and at widths 7, 8, 4
    with and without pre-scale and sign), each rank's receive buffer
    assembled by hand from the four packs, then K1 and K5 on every rank's
    local half against their plain versions per element (K1 also against
    its summation order replayed); rank 0 timed.  Then K6 at world size 1
    (phase 6b's shapes), checked and timed the same way."""
    import torch

    from acmgnn_tpu_torch.data.registry import row_normalize_features
    from acmgnn_tpu_torch.ops.coo import coo_spmm, coo_spmm_plain
    from acmgnn_tpu_torch.ops.ell import (
        k1_form,
        k1_order_replay,
        row_gather_spmm,
        row_gather_spmm_plain,
    )
    from acmgnn_tpu_torch.ops.graph import row_normalized_adjacency
    from acmgnn_tpu_torch.ops.halo import padded_rows
    from acmgnn_tpu_torch.parallel.sharded import (
        make_sharded_coo_op,
        make_sharded_ell_op,
    )

    dev = torch.device("cuda")
    a_hat = row_normalized_adjacency(adj)
    n = adj.shape[0]
    gen = torch.Generator(device=dev).manual_seed(6)
    x_in = torch.from_numpy(row_normalize_features(feats)).to(dev)
    cases = _spmm_cases(n, gen, x_in)
    sign4 = [-1.0 if h else 1.0 for h in (0, 0, 1, 1)]
    rows = []
    for exchange in ("allgather", "halo"):
        t0 = time.perf_counter()
        ell, bnd = make_sharded_ell_op(a_hat, SHARDED_P, None,
                                       exchange=exchange,
                                       gather_dtype=torch.bfloat16)
        coo, _ = make_sharded_coo_op(a_hat, SHARDED_P, None,
                                     exchange=exchange, boundaries=bnd)
        ell = [op.to(dev) for op in ell]
        coo = [op.to(dev) for op in coo]
        rpp = ell[0].rows_per_part
        print(f"[6a] P={SHARDED_P} {exchange}: rows_per_part {rpp}, receive "
              f"buffer {ell[0].exchange_rows()} rows, halo_pad "
              f"{ell[0].halo_pad}; rows sent/received per product by rank "
              f"{[(op.rows_sent, op.rows_received) for op in ell]} (host "
              f"build of both formats {time.perf_counter() - t0:.1f} s)")
        tag = f"@P{SHARDED_P}-{exchange}"
        for ops, fmt in ((ell, "ell"), (coo, "coo")):
            for (x, z, alpha, beta, tr), case_sign in zip(
                    cases, (None, None, sign4)):
                # _spmm_cases' transpose operand carries the sign already;
                # here K6 applies it to the raw cotangent
                if tr:
                    x = z
                d = x.shape[1]
                a = tuple(alpha or (0.0,) * d)
                b = tuple(beta or (1.0,) * d)
                packs, k6_err = [], 0.0
                ld = ops[0].row_stride(d)
                for p, op in enumerate(ops):
                    half = op.bwd if tr else op.fwd
                    own, send, err = _check_k6(
                        _slab_of(x, bnd, rpp, p), op.gather_dtype, ld,
                        getattr(half, "pre_scale", None), case_sign,
                        op.send_idx_t if tr else op.send_idx,
                        f"k6_pack_w{d}{tag} rank {p}")
                    packs.append((padded_rows(own),
                                  None if send is None
                                  else padded_rows(send)))
                    k6_err = max(k6_err, err)
                worst = 0.0
                for p, op in enumerate(ops):
                    half = op.bwd if tr else op.fwd
                    send_idx = op.send_idx_t if tr else op.send_idx
                    # the receive buffer as the exchange fills it: whole
                    # padded rows, a [:, :d] view for the local half
                    if send_idx is None:
                        recv = torch.cat([own for own, _ in packs])[:, :d]
                    else:    # slot q holds what rank q sent to rank p
                        pad = op.halo_pad_t if tr else op.halo_pad
                        recv = torch.cat([packs[p][0]] + [
                            packs[q][1].view(SHARDED_P, pad, ld)[p]
                            for q in range(SHARDED_P)])[:, :d]
                    zs = None if z is None else _slab_of(z, bnd, rpp, p)
                    if fmt == "ell":
                        got = row_gather_spmm(half, recv, z=zs, alpha=alpha,
                                              beta=beta)
                        want = row_gather_spmm_plain(half, recv, zs, a, b)
                        absref = row_gather_spmm_plain(
                            half, recv.abs(), _abs(zs), _abs(a), _abs(b))
                        terms = _ell_row_terms(half)
                    else:
                        got = coo_spmm(half, recv, z=zs, alpha=alpha,
                                       beta=beta)
                        want = coo_spmm_plain(half, recv, zs, a, b)
                        absref = coo_spmm_plain(
                            dataclasses.replace(half, val=half.val.abs()),
                            recv.abs(), _abs(zs), _abs(a), _abs(b))
                        terms = _coo_row_terms(half)
                    name = f"{'k1_spmm' if fmt == 'ell' else 'k5_coo'}_w{d}"
                    worst = max(worst, spmm_err(
                        got, want, absref, terms + int(z is not None),
                        f"{name}{tag} rank {p}"))
                    if fmt == "ell" and not torch.equal(got, k1_order_replay(
                            half, recv, zs if any(a) else None, a, b)):
                        fail(f"{name}{tag} rank {p}: K1 differs from its "
                             f"own summation order replayed")
                    if p == 0:
                        rank0 = (half, recv, zs, terms)
                half, recv, zs, terms = rank0
                kern = row_gather_spmm if fmt == "ell" else coo_spmm
                plain = (row_gather_spmm_plain if fmt == "ell"
                         else coo_spmm_plain)
                ms = time_ms(lambda: kern(half, recv, z=zs, alpha=alpha,
                                          beta=beta), 50)
                dev_ms = device_ms(lambda: kern(half, recv, z=zs,
                                                alpha=alpha, beta=beta))
                plain_ms = time_ms(lambda: plain(half, recv, zs, a, b), 5)
                lib = _local_csr(half)
                recv_f = recv.float()
                lib_ms = time_ms(lambda: torch.sparse.mm(lib, recv_f), 20)
                lib_dev = device_ms(lambda: torch.sparse.mm(lib, recv_f))
                nnz, ncols = int(terms.sum()), half.num_cols
                gsz = recv.element_size()
                if fmt == "ell":
                    nbytes = (8 * (rpp + 1) + 4 * nnz + 4 * rpp
                              + gsz * ncols * d + 4 * rpp * d
                              + (4 * rpp * d if z is not None else 0)
                              + (4 * rpp if half.row_scale is not None
                                 else 0))
                    b_ms, b_by = bound(nbytes, nnz * d + 2 * rpp * d)
                else:
                    extra = 4 * (3 * half.span_rows.numel()
                                 + half.empty_rows.numel())
                    nbytes = (12 * nnz + extra + 4 * ncols * d
                              + 4 * rpp * d
                              + (4 * rpp * d if z is not None else 0))
                    b_ms, b_by = bound(nbytes, 2 * nnz * d + 2 * rpp * d)
                rows.append(dict(
                    name=name + tag, counter=name, route="cuda",
                    source=("acmgnn_tpu_torch/csrc/spmm.cu" if fmt == "ell"
                            else "acmgnn_tpu_torch/csrc/coo.cu"),
                    replaces=(K1_LOCAL_REPLACES if fmt == "ell"
                              else K5_LOCAL_REPLACES),
                    max_abs_err=worst, ms=ms, device_ms=dev_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms, library_device_ms=lib_dev,
                    run=(exchange, fmt),
                    **({"form": k1_form(d, recv.dtype)} if fmt == "ell"
                       else {})))
                got_rows = ops[0].rows_received
                print(f"  {name}{tag} (rank 0, {rpp} x {ncols} local half, "
                      f"row stride {ld}): {ms:.4f} ms, device {_ms(dev_ms)} "
                      f"(plain {plain_ms:.3f}, torch.sparse.mm f32 "
                      f"{lib_ms:.4f}, device {_ms(lib_dev)}; bound "
                      f"{b_ms:.4f} {b_by}); rank 0 receives {got_rows} "
                      f"rows, {got_rows * ld * gsz} bytes per SpMM "
                      f"({got_rows * d * gsz} at rows of {d})")
                if fmt == "ell":
                    rows.append(_k6_row(ops[0], x, bnd, rpp, tr, case_sign,
                                        tag, (exchange, fmt), k6_err))
    ell1, bnd1 = make_sharded_ell_op(a_hat, 1, 0, gather_dtype=torch.bfloat16)
    ell1 = ell1.to(dev)
    for (x, z, _, _, tr), case_sign in zip(cases, (None, None, sign4)):
        rows.append(_k6_row(ell1, z if tr else x, bnd1, n, tr, case_sign,
                            "@P1", None, 0.0))
    return rows


def _k6_row(op, x, bnd, rpp, tr, path_sign, tag, run, err, dev_reps=20):
    """K6 on rank 0's slab of ``x``: every combination of pre-scale, sign
    and dtype bit-equal to the plain version on the whole buffers, at
    K1's row stride (the ELL receive buffer's) and at rows of d (the COO
    one's), then the path's own combination timed.  ``err``: the largest
    |K6 - plain| read on the other ranks' slabs."""
    import torch

    from acmgnn_tpu_torch.ops.ell import k1_operand_ld
    from acmgnn_tpu_torch.ops.halo import halo_pack, halo_pack_plain

    xs = _slab_of(x, bnd, rpp, 0)
    d = xs.shape[1]
    send_idx = op.send_idx_t if tr else op.send_idx
    slab_scale = op.bwd.pre_scale if op.bwd.pre_scale is not None \
        else op.fwd.row_scale
    sign = [(-1.0) ** j for j in range(d)]
    for dtype in (torch.bfloat16, torch.float32):
        for ld in sorted({d, k1_operand_ld(d, dtype)}):
            for pre in (None, slab_scale):
                for sg in (None, sign):
                    err = max(err, _check_k6(
                        xs, dtype, ld, pre, sg, send_idx,
                        f"k6_pack_w{d}{tag} combinations")[2])
    pre = op.bwd.pre_scale if tr else None
    ld = op.row_stride(d)
    own = torch.empty(rpp, ld, dtype=op.gather_dtype,
                      device=xs.device)[:, :d]

    def pack():
        return halo_pack(xs, own, pre_scale=pre, sign=path_sign,
                         send_idx=send_idx, ld=ld)

    ms = time_ms(pack, 50)
    dev_ms = device_ms(pack, dev_reps)
    plain_ms = time_ms(lambda: halo_pack_plain(xs, own, pre, path_sign,
                                               send_idx, ld=ld), 5)
    lib_ms = lib_dev = None
    if pre is None and path_sign is None and send_idx is None:
        lib_ms = time_ms(lambda: xs.to(op.gather_dtype), 50)
        lib_dev = device_ms(lambda: xs.to(op.gather_dtype), dev_reps)
    n_send = 0 if send_idx is None else send_idx.numel()
    b_ms, b_by = _k6_bound(rpp, d, ld, n_send, own.element_size(),
                           pre is not None)
    lib = ("none" if lib_ms is None
           else f"x.to(bf16) {lib_ms:.4f}, device {_ms(lib_dev)}")
    print(f"  k6_pack_w{d}{tag} (rank 0: {rpp} rows, {n_send} send rows, "
          f"row stride {ld}): {ms:.4f} ms, device {_ms(dev_ms)} (plain "
          f"{plain_ms:.3f}, library {lib}; bound {b_ms:.4f} {b_by}); "
          f"bit-equal to its plain version on the whole buffers (padding "
          f"included) with and without pre-scale and sign, bf16 and f32, "
          f"at K1's row stride and at rows of {d}")
    return dict(name=f"k6_pack_w{d}{tag}", counter=f"k6_pack_w{d}",
                route="cuda", source="acmgnn_tpu_torch/csrc/halo.cu",
                replaces=K6_REPLACES, max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev,
                run=run)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def single_chip_reference(data, cfg):
    """The single-chip port on the card under ``run_experiment_sharded``'s
    protocol for one split: its masks and initial parameters.  Returns
    (split result, parameters on the host)."""
    import torch

    from acmgnn_tpu_torch.data.splits import random_disassortative_splits
    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    _, ops, x, y, y1h, nclass = prepare_data(data, cfg)
    masks = random_disassortative_splits(
        np.asarray(data.labels), nclass, rng=np.random.default_rng(cfg.seed))
    model = build_model(cfg, x.shape[1], nclass, seed=cfg.seed,
                        nnodes=x.shape[0])
    res = make_split_runner(model, cfg)(
        ops, x, y, tuple(torch.from_numpy(m).cuda() for m in masks),
        seed=cfg.seed, labels_onehot=y1h)
    return res, {k: p.detach().cpu() for k, p in model.named_parameters()}


def compare_to_single(tag, result, params, ref):
    """A sharded run's result dict and parameters against
    ``single_chip_reference``: parameters within 1e-4, equal epochs, test
    metric within 1e-4."""
    res, want = ref
    worst = max(float((params[k] - want[k]).abs().max()) for k in want)
    print(f"{tag} against the single-chip port: max |Δparam| {worst:.3e} "
          f"(tolerance 1e-4); epochs {result['epochs_total']}/"
          f"{res.epochs_run}; test {result['test_mean']:.6f}/"
          f"{float(res.test_metric):.6f}")
    if (worst > 1e-4 or result["epochs_total"] != res.epochs_run
            or abs(result["test_mean"] - float(res.test_metric)) > 1e-4):
        fail(f"{tag} disagrees with the single-chip port")


def phase_sharded_main_path(adj, feats, labels, ms_single):
    """[6b] World size 1 over NCCL: ``run_experiment_sharded`` against the
    single-chip port (f32 gathers, dropout 0, 10 epochs), then the
    headline configuration (bf16, dropout 0.5) captured, timed with
    launch counts and a profiler window (the NCCL operations a replay
    runs among them), beside phase 3's single-chip number; its captured
    form against its eager form bit for bit over
    ``SHARDED_CAPTURE_EPOCHS`` (``sharded_capture_equality``: one
    all-reduce a joint body); then the captured sharded and single-chip
    runners in alternating pairs.  Returns (launch counts, ms/epoch)."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.trainer import (
        prepare_sharded_data,
        run_experiment_sharded,
    )

    init_distributed_nccl()
    try:
        data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
        cfg = headline_config(dropout=0.0, spmm_dtype="float32", epochs=10,
                              num_splits=1, seed=0)
        t0 = time.perf_counter()
        with _captured_runs("[6b]"):
            result, model = run_experiment_sharded(data, cfg,
                                                   return_model=True)
        torch.cuda.synchronize()
        print(f"[6b] run_experiment_sharded, world size 1 (nccl, "
              f"captured), f32, {cfg.epochs} epochs: "
              f"{time.perf_counter() - t0:.1f} s")
        compare_to_single("[6b]", result, {
            k: p.detach().cpu() for k, p in model.named_parameters()},
            single_chip_reference(data, cfg))
        ops: dict = {}
        counts, ms_epoch, _, groups, ms_replay = drive_path(
            "[6b]", data, headline_config(), _masks(adj.shape[0]),
            TIMED_EPOCHS, sharded_counts, group=dist.group.WORLD,
            profile_ops=ops)
        nccl = ops.get("NCCL collectives", 0.0)
        print(f"[6b] K1 {_ms(groups.get('K1 spmm'))} ms/epoch (profile "
              f"above), K6 {_ms(groups.get('K6 halo pack'))}, NCCL "
              f"{_ms(groups.get('NCCL collectives'))} in {nccl:.2f} device "
              f"operations a replay (a one-rank sum in place may launch "
              f"none); the receive buffer's rows are K1's padded stride "
              f"(bf16 w7 16 bytes); exchanged per SpMM at world size 1: 0 "
              f"rows, 0 bytes (P=4: phase 6a)")
        prep = prepare_sharded_data(data, headline_config(),
                                    group=dist.group.WORLD)
        sharded_capture_equality("[6b]", prep, headline_config(
            epochs=SHARDED_CAPTURE_EPOCHS), _masks(adj.shape[0]),
            dist.group.WORLD, collectives=1)
        pairs = phase_sharded_overhead(data, prep)
    finally:
        dist.destroy_process_group()
    print(f"[6b] headline, world size 1 (nccl), captured: {ms_epoch:.3f} "
          f"ms/epoch over the run, {ms_replay:.3f} over the replays, beside "
          f"the single-chip path's {ms_single:.3f} (phase 3, this call); "
          f"alternating pairs, medians: single-chip {pairs['single'][0]:.3f}"
          f" / sharded {pairs['sharded'][0]:.3f} ms/epoch over the run, "
          f"{pairs['single'][1]:.3f} / {pairs['sharded'][1]:.3f} over the "
          f"replays (sharded / single "
          f"{pairs['sharded'][1] / pairs['single'][1]:.3f}; predicted "
          f"within 1.15)")
    return counts, ms_epoch


@contextlib.contextmanager
def _captured_runs(tag, captures=1):
    """The block's runner calls (``trainer.Replay.run``) must replay a
    CUDA graph, and the block must record ``captures`` graphs
    (``trainer._capture``: one a run, whatever its splits and segments):
    fails at the end of the block otherwise.  Yields the calls' (bodies,
    replays, capture ms or None)."""
    from acmgnn_tpu_torch.train import trainer

    calls, made = [], [0]

    def run_of(run):
        def wrapper(self, *a, **k):
            out = run(self, *a, **k)
            calls.append(out[:3])
            return out
        return wrapper

    def capture_of(capture):
        def wrapper(*a, **k):
            made[0] += 1
            return capture(*a, **k)
        return wrapper

    with _wrapped(trainer.Replay, "run", run_of), \
            _wrapped(trainer, "_capture", capture_of):
        yield calls
    eager = [c for c in calls if c[0] > 1 and not c[1]]
    if not calls or eager or made[0] != captures:
        fail(f"{tag} {made[0]} captures (want {captures}); the runner's "
             f"calls (bodies, replays, capture ms): {calls}")


@contextlib.contextmanager
def _collectives_captured():
    """Counts the split runner's all-reduces (``trainer.all_reduce_sum``:
    BatchNorm's go through ``sum_over_ranks`` and are not counted) made
    while a CUDA graph captures: those each replay runs.  Yields a
    one-element list."""
    import torch

    from acmgnn_tpu_torch.train import trainer

    seen = [0]

    def make(reduce):
        def wrapper(t, group=None):
            if torch.cuda.is_current_stream_capturing():
                seen[0] += 1
            return reduce(t, group)
        return wrapper

    with _wrapped(trainer, "all_reduce_sum", make):
        yield seen


def _sharded_split(prep, cfg, masks_np, group, graph=True):
    """One split of ``cfg`` through the sharded runner on ``prep``
    (``prepare_sharded_data``'s; ``group`` None: the single card's
    ``prepare_data`` output) from ``build_model(seed=2)``: ``_split``'s
    result, end state, parameters and buffers, launch counts, and the
    runner's all-reduces recorded in a capture."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train.trainer import build_model, make_split_runner

    if group is None:
        _, ops, x, y, y1h, nclass = prep
        args = (ops, x, y, tuple(torch.from_numpy(m).cuda()
                                 for m in masks_np))
        nnodes = x.shape[0]
    else:
        args = (prep.ops, prep.x, prep.labels,
                tuple(prep.place(m) for m in masks_np))
        x, nclass, y1h = prep.x, prep.nclass, prep.labels_onehot
        nnodes = prep.data.num_nodes
    kernels.reset_launches()
    model = build_model(cfg, x.shape[1], nclass, seed=2, nnodes=nnodes)
    runner = make_split_runner(model, cfg, group=group, graph=graph)
    with _collectives_captured() as seen, _loop_launches() as launched:
        res, state = runner(*args, seed=5, labels_onehot=y1h,
                            return_state=True)
    torch.cuda.synchronize()
    return dict(res=res, state=state,
                counts=_loop_counted(dict(kernels.launches), state,
                                     launched[0]),
                collectives=seen[0], nodes=body_node_types(runner),
                params={k: v.detach().clone()
                        for k, v in model.state_dict().items()})


def sharded_capture_equality(tag, prep, cfg, masks_np, group, collectives):
    """One split of ``cfg`` through the sharded runner in its eager form
    (``graph=False``) and captured, from the same parameters and seed:
    ``_bit_equal`` (parameters and buffers, histories, best metrics,
    ``epochs_run``), launch counts equal, ``capture_ms`` None only for the
    eager form, and ``collectives`` all-reduces of the runner's recorded
    in the graph (one a joint body, two a sequential one)."""
    eager, captured = (_sharded_split(prep, cfg, masks_np, group, graph)
                       for graph in (False, True))
    n = _bit_equal(tag, eager, captured)
    capture_ms = captured["state"].capture_ms
    print(f"{tag} sharded runner, world size {prep.world_size} (nccl), "
          f"{cfg.epochs} epochs, eager against captured (capture "
          f"{_ms(capture_ms)} ms): {n} tensors bit for bit; epochs_run "
          f"{captured['res'].epochs_run}; launches equal "
          f"{eager['counts'] == captured['counts']}; the runner's "
          f"all-reduces recorded in the graph: {captured['collectives']} a "
          f"replay (expected {collectives}); the captured body's node "
          f"types {captured['nodes']} (a device loop's body takes kernel, "
          f"memset, memcpy, empty, child-graph and conditional nodes)")
    if (eager["state"].capture_ms is not None or capture_ms is None
            or eager["counts"] != captured["counts"]):
        fail(f"{tag} the eager and captured forms differ in form or "
             f"launches")
    if captured["collectives"] != collectives:
        fail(f"{tag} {captured['collectives']} all-reduces a replay, not "
             f"{collectives}")


def sharded_vs_single_bits(tag, data, cfg, masks_np, group):
    """One split of ``cfg`` (f32 gathers) through the captured sharded
    runner at world size 1 and through the captured single-card runner,
    from the same parameters and seed: ``_bit_equal`` (parameters and
    buffers, BatchNorm's running statistics among them, histories, best
    metrics)."""
    from acmgnn_tpu_torch.train.trainer import (
        prepare_data,
        prepare_sharded_data,
    )

    sharded = _sharded_split(prepare_sharded_data(data, cfg, group=group),
                             cfg, masks_np, group)
    single = _sharded_split(prepare_data(data, cfg), cfg, masks_np, None)
    if sharded["state"].capture_ms is None or single[
            "state"].capture_ms is None:
        fail(f"{tag} a run was not captured")
    n = _bit_equal(tag, single, sharded)
    print(f"{tag} captured sharded (world size 1, nccl) against the captured "
          f"single card, {cfg.epochs} epochs, f32 gathers: {n} tensors bit "
          f"for bit; test {float(sharded['res'].test_metric):.6f}")


def phase_sharded_overhead(data, prep, pairs: int = 5):
    """The headline configuration on one card through the single-chip
    runner and through the sharded one (world size 1, ``prep``), both
    captured, ``TIMED_EPOCHS`` epochs a run, in alternating pairs:
    ``{arm: (median ms/epoch over the whole run, over its replays)}``.
    Both share the host, so pairs cancel its drift; the replays read what
    the sharded body adds on the card (K6 packs, one all-reduce).  Each
    arm keeps one runner, which captures in the warm-up pair and replays
    from its first body in every later call."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    cfg = headline_config(epochs=TIMED_EPOCHS)
    masks_np = _masks(data.num_nodes)
    _, ops, x, y, _, nclass = prepare_data(data, cfg)
    arms = {
        "single": (make_split_runner(build_model(cfg, x.shape[1], nclass),
                                     cfg),
                   (ops, x, y, tuple(torch.from_numpy(m).cuda()
                                     for m in masks_np))),
        "sharded": (make_split_runner(
            build_model(cfg, x.shape[1], nclass), cfg,
            group=dist.group.WORLD),
            (prep.ops, prep.x, prep.labels,
             tuple(prep.place(m) for m in masks_np))),
    }
    ms = {k: ([], []) for k in arms}
    for i in range(pairs + 1):
        for arm in (("single", "sharded") if i % 2 else ("sharded",
                                                          "single")):
            run, args = arms[arm]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = run(*args, seed=i, return_state=True)
            torch.cuda.synchronize()
            dt = 1e3 * (time.perf_counter() - t0)
            if not st.replays:
                fail(f"[6b] the {arm} arm ran eagerly")
            if i > 0:            # the first pair warms both arms up
                ms[arm][0].append(dt / st.epoch)
                ms[arm][1].append((dt - st.setup_ms) / st.replays)
    print("[6b] alternating pairs, captured forms, ms/epoch over the run "
          "(over the replays): " + "; ".join(
              f"{arm} " + ", ".join(f"{a:.3f} ({b:.3f})"
                                    for a, b in zip(*ms[arm]))
              for arm in arms))
    return {arm: (float(np.median(ms[arm][0])), float(np.median(ms[arm][1])))
            for arm in arms}


def _small_twitch():
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    adj, feats, _ = twitch_gamers_scale_graph(0, **SMALL_TWITCH)
    feats = np.abs(feats)
    labels = (feats[:, 0] > np.median(feats[:, 0])).astype(np.int32)
    return GraphData("twitch-shaped-20k", adj, feats, labels)


def sharded_check_config(fmt, dtype="float32"):
    """Phase 6c's configuration: the headline model at dropout 0, lr 1e-3,
    no weight decay (see ``SMALL_TWITCH``)."""
    return headline_config(dropout=0.0, lr=1e-3, weight_decay=0.0,
                           spmm_dtype=dtype, epochs=SHARDED_CHECK_EPOCHS,
                           num_splits=1, operator_format=fmt, seed=0)


def _gloo_unstaged(rank, world):
    """gloo's own handling of CUDA tensors, without the port's staging:
    each collective of the path at f32 and bf16, written into a view of a
    larger buffer, on values exact in bf16; {collective dtype: ok}."""
    import torch
    import torch.distributed as dist

    rows, d = 64, 8
    base = torch.arange(rows * d, device="cuda").reshape(rows, d) % 8

    def val(src, dst, dtype):
        return (32 * src + 8 * dst + base).to(dtype)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        buf = torch.full(((world + 1) * rows, d), -1.0, dtype=dtype,
                         device="cuda")
        dist.all_to_all_single(buf[rows:], torch.cat(
            [val(rank, q, dtype) for q in range(world)]))
        want = torch.cat([buf.new_full((rows, d), -1.0)]
                         + [val(q, rank, dtype) for q in range(world)])
        out[f"all_to_all_single {name}"] = torch.equal(buf.cpu(), want.cpu())
        buf.fill_(-1.0)
        dist.all_gather_into_tensor(buf[rows:], val(rank, rank, dtype))
        want = torch.cat([buf.new_full((rows, d), -1.0)]
                         + [val(q, q, dtype) for q in range(world)])
        out[f"all_gather_into_tensor {name}"] = torch.equal(buf.cpu(),
                                                            want.cpu())
        t = val(rank, 0, dtype)
        dist.all_reduce(t)
        want = sum(val(q, 0, torch.float32) for q in range(world)).to(dtype)
        out[f"all_reduce {name}"] = torch.equal(t.cpu(), want.cpu())
    return out


def _halo_exchange_rows(data, rank, world):
    """This rank's bf16 halo receive buffers, filled by the path's staged
    ``all_to_all``, against the same rows assembled from every rank's K6
    pack in this process, whole padded rows (K1's row stride, padding
    included): the rows that differ, forward and transpose."""
    import torch

    from acmgnn_tpu_torch.ops.graph import row_normalized_adjacency
    from acmgnn_tpu_torch.ops.halo import halo_pack, padded_rows
    from acmgnn_tpu_torch.parallel.sharded import (
        make_sharded_ell_op,
        receive_buffer,
    )

    ops, b = make_sharded_ell_op(row_normalized_adjacency(data.adj), world,
                                 None, exchange="halo",
                                 gather_dtype=torch.bfloat16)
    ops = [op.to("cuda") for op in ops]
    rpp = ops[0].rows_per_part
    gen = torch.Generator().manual_seed(6)     # the same x on every rank
    bad = []
    for tr, sign in ((False, None), (True, [1.0, 1.0, -1.0, -1.0, 1.0, 1.0,
                                            -1.0])):
        x = torch.randn(data.num_nodes, 7 if tr else 8, generator=gen).cuda()
        got = padded_rows(receive_buffer(ops[rank], _slab_of(x, b, rpp, rank),
                                         tr, sign))
        ld = ops[rank].row_stride(x.shape[1])
        packs = []
        for q, op in enumerate(ops):
            own = torch.empty(rpp, ld, dtype=torch.bfloat16, device="cuda")
            send = halo_pack(_slab_of(x, b, rpp, q), own[:, :x.shape[1]],
                             pre_scale=(op.bwd if tr else op.fwd).pre_scale,
                             sign=sign,
                             send_idx=op.send_idx_t if tr else op.send_idx,
                             ld=ld)
            packs.append((own, padded_rows(send)))
        pad = ops[0].halo_pad_t if tr else ops[0].halo_pad
        want = torch.cat([packs[rank][0]] + [
            packs[q][1].view(world, pad, ld)[rank] for q in range(world)])
        bad.append(int((got != want).any(dim=1).sum())
                   + int(got[:, x.shape[1]:].float().any(dim=1).sum()))
    return bad


def _sharded_rank(rank, world, store_path, out_dir):
    """One rank of phase 6c (a process of its own on the one card): the
    exchange checks, then every run of ``SHARDED_RUNS`` through
    ``run_experiment_sharded``, its parameters and launch counts written
    for the parent."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.parallel.multihost import init_distributed
    from acmgnn_tpu_torch.train.trainer import run_experiment_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda", rank=rank,
                     world_size=world,
                     store=dist.FileStore(store_path, world))
    data = _small_twitch()
    torch.save(dict(unstaged=_gloo_unstaged(rank, world),
                    exchange=_halo_exchange_rows(data, rank, world)),
               f"{out_dir}/checks-rank{rank}.pt")
    for exchange, fmt, dtype in SHARDED_RUNS:
        kernels.reset_launches()
        result, model = run_experiment_sharded(
            data, sharded_check_config(fmt, dtype), exchange=exchange,
            return_model=True)
        torch.save(dict(result=result, launches=dict(kernels.launches),
                        params={k: p.detach().cpu()
                                for k, p in model.named_parameters()}),
                   f"{out_dir}/{exchange}-{fmt}-{dtype}-rank{rank}.pt")
    dist.destroy_process_group()


def phase_sharded_gloo():
    """[6c] World size 4 on the one card: four processes joined by gloo on
    CUDA tensors over a ``FileStore``.  The bf16 halo exchange checked
    row for row; each run of ``SHARDED_RUNS`` trained for
    ``SHARDED_CHECK_EPOCHS`` epochs of ``sharded_check_config``, the f32
    ones against the single-chip port on the card, each halo run against
    its all-gather twin.  Returns each run's rank-0 launch counts."""
    import shutil

    import torch

    from acmgnn_tpu_torch.ops.graph import row_normalized_adjacency
    from acmgnn_tpu_torch.parallel.sharded import make_sharded_ell_op

    data = _small_twitch()
    counts = {}
    tmp, secs = _spawn_ranks(_sharded_rank, SHARDED_P, "[6c]")
    try:
        print(f"[6c] {SHARDED_P} ranks (gloo on CUDA tensors staged through "
              f"the host, one card), graph N={data.num_nodes} "
              f"nnz={data.adj.nnz}, {len(SHARDED_RUNS)} runs of "
              f"{SHARDED_CHECK_EPOCHS} epochs: {secs:.1f} s with start-up")
        checks = [torch.load(f"{tmp}/checks-rank{r}.pt")
                  for r in range(SHARDED_P)]
        bad = [c["exchange"] for c in checks]
        print(f"[6c] bf16 halo receive buffers (forward w8, transpose w7 at "
              f"K1's row stride 8), whole padded rows against the four "
              f"ranks' K6 packs: rows differing by rank {bad}")
        if any(any(b) for b in bad):
            fail("[6c] the halo exchange delivered wrong rows")
        print(f"[6c] gloo's own handling of CUDA tensors, not staged (the "
              f"port stages every gloo collective on the card): rank 0 "
              + ", ".join(f"{k} {'ok' if v else 'WRONG'}"
                          for k, v in checks[0]["unstaged"].items()))
        a_hat = row_normalized_adjacency(data.adj)
        params = {}
        for exchange, fmt, dtype in SHARDED_RUNS:
            tag = f"[6c {exchange} {fmt} {dtype}]"
            ranks = [torch.load(f"{tmp}/{exchange}-{fmt}-{dtype}-rank{r}.pt")
                     for r in range(SHARDED_P)]
            r0 = ranks[0]
            for r in ranks[1:]:
                if any(not torch.equal(r["params"][k], r0["params"][k])
                       for k in r0["params"]):
                    fail(f"{tag} the replicas' parameters differ")
            if r0["result"]["devices"] != SHARDED_P:
                fail(f"{tag} ran on {r0['result']['devices']} ranks")
            if dtype == "float32":
                compare_to_single(tag, r0["result"], r0["params"],
                                  single_chip_reference(
                                      data, sharded_check_config(fmt)))
            ops, _ = make_sharded_ell_op(a_hat, SHARDED_P, None,
                                         exchange=exchange)
            print(f"{tag} rows sent/received per SpMM by rank "
                  f"{[(op.rows_sent, op.rows_received) for op in ops]}; "
                  f"{r0['result']['epoch_ms_avg']:.3f} ms/epoch with set-up "
                  f"(gloo on one card copies every collective through the "
                  f"host: not the path's speed); rank 0 launches "
                  f"{json.dumps(r0['launches'], sort_keys=True)}")
            counts[(exchange, fmt, dtype)] = r0["launches"]
            params[(exchange, fmt, dtype)] = r0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for exchange, fmt, dtype in SHARDED_RUNS:
        if exchange == "halo":
            _halo_against_allgather(f"[6c halo {fmt} {dtype}]",
                                    params[("halo", fmt, dtype)],
                                    params[("allgather", fmt, dtype)])
    phase_check_conditioning(data)
    return counts


def _halo_against_allgather(tag, halo, ag):
    """The halo run against the all-gather run of the same format and
    dtype: the same rows in the same order, so within 1e-4 (in fact
    equal)."""
    worst = max(float((halo["params"][k] - ag["params"][k]).abs().max())
                for k in ag["params"])
    print(f"{tag} against the all-gather run: max |Δparam| {worst:.3e} "
          f"(tolerance 1e-4); epochs {halo['result']['epochs_total']}/"
          f"{ag['result']['epochs_total']}; test "
          f"{halo['result']['test_mean']:.6f}/{ag['result']['test_mean']:.6f}")
    if (worst > 1e-4 or halo["result"]["epochs_total"]
            != ag["result"]["epochs_total"]
            or abs(halo["result"]["test_mean"]
                   - ag["result"]["test_mean"]) > 1e-4):
        fail(f"{tag} disagrees with the all-gather run")


def phase_check_conditioning(data):
    """How far two summation orders of the single-chip port (ELL, COO)
    part on phase 6c's configuration: what the parity check would see of
    a sharded path that summed in another order."""
    (_, pe), (_, pc) = (single_chip_reference(data, sharded_check_config(fmt))
                        for fmt in ("ell", "coo"))
    worst = max(float((pe[k] - pc[k]).abs().max()) for k in pe)
    print(f"[6c] single-chip ELL against single-chip COO (summation order "
          f"only) after {SHARDED_CHECK_EPOCHS} epochs: max |Δparam| "
          f"{worst:.3e}")


# ---------------------------------------------------------------------------
# Phase 7: K7 (the probe's panel gather) and the single-card entry points
# ---------------------------------------------------------------------------

PROBE_REPLACES = {"p1": "tools/pallas_gather_probe.py:62",
                  "p2": "tools/pallas_gather_probe.py:91"}
EXPERIMENT_EPOCHS, STEPWISE_EPOCHS, KNOB_EPOCHS = 20, 20, 10


def phase_probe():
    """[7a] The probe's entry point (``gather_probe.main``) on the card,
    its K7 launches counted; then each of its six panel configurations:
    the host plan (block or L2 form) and the blocks resident per launch;
    K7 in the plan's form, and at the panel a block holds (P=8) in the
    L2 form too, each equal to its plain version bit for bit; where both
    forms run, their device ms in turns (plan, L2, L2, plan); K7, plain
    and library (``take_along_dim`` for P1, ``index_select`` for P2) ms
    and device ms, each device time one reading of the same
    ``device_ms``; the bytes bound and M rows/s; and the HBM yardstick's
    ms beside its bound."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.ops.panel_gather import (
        _launch,
        panel_gather,
        panel_gather_plain,
        panel_plan,
        resident,
    )
    from acmgnn_tpu_torch.tools import gather_probe as probe

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    probe.main("cuda")
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    per_config = probe.WARMUP + probe.ITERS
    print(f"[7a] gather_probe.main: {time.perf_counter() - t0:.1f} s; "
          f"launches {json.dumps(counts)}")
    if counts != {"K7": 6 * per_config}:
        fail(f"[7a] K7 launches {counts} != 6 configurations x {per_config}")
    configs = probe.configs("cuda")
    m, d = probe.M, probe.D
    rows = []
    for name, _, x, idx in configs[1:]:
        p, s = x.shape[0], x.element_size()
        per_row = idx.dim() == 1
        forms = ["block", "l2"] if panel_plan(p, d, s) == "block" else ["l2"]
        want = panel_gather_plain(x, idx)
        for form in forms:
            got = _launch(x, idx, form)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"[7a] {name}: K7 ({form} form) differs from its "
                     f"plain version")
            del got
        del want
        form_ms = {}
        if len(forms) > 1:
            for form in forms + forms[::-1]:
                form_ms.setdefault(form, []).append(device_ms(
                    lambda form=form: _launch(x, idx, form), 5))
        ms = time_ms(lambda: panel_gather(x, idx), 20)
        dev_ms = device_ms(lambda: panel_gather(x, idx), 5)
        plain_ms = time_ms(lambda: panel_gather_plain(x, idx), 5)
        if per_row:
            def lib():
                return torch.index_select(x, 0, idx)
        else:
            idx64 = idx.long()

            def lib():
                return torch.take_along_dim(x, idx64, 0)
        lib_ms = time_ms(lib, 20)
        lib_dev = device_ms(lib, 5)
        del lib
        idx64 = None    # the per-element form's int64 indices: 1 GiB
        nbytes = 4 * idx.numel() + m * d * s + p * d * s
        b_ms, b_by = bound(nbytes, 0)
        form = "p2" if per_row else "p1"
        dtype = "bf16" if s == 2 else "f32"
        row_name = f"k7_panel_gather_{form}_{dtype}_P{p}"
        held = ", ".join(f"{f} {resident(f, x, per_row)}" for f in forms)
        print(f"  {row_name}: panel {p * d * s} bytes, plan: {forms[0]} "
              f"form; blocks resident at once: {held}")
        turns = "; device ms in turns: " + ", ".join(
            f"{f} {' / '.join(f'{v:.4f}' for v in vs)}"
            for f, vs in form_ms.items()) if form_ms else ""
        print(f"  {row_name}: bit-equal to its plain version in "
              f"{' and '.join(forms)} form{turns}; {ms:.4f} ms "
              f"({m / ms * 1e3 / 1e6:.1f} M rows/s; plain {plain_ms:.3f}, "
              f"{'index_select' if per_row else 'take_along_dim'} "
              f"{lib_ms:.4f}, device {_ms(lib_dev)}; K7 device "
              f"{_ms(dev_ms)}; bound {b_ms:.4f} {b_by})")
        rows.append(dict(
            name=row_name, counter="K7", route="cuda",
            source="acmgnn_tpu_torch/csrc/panel_gather.cu",
            replaces=PROBE_REPLACES[form], launches=per_config,
            max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_device_ms=lib_dev,
            path=f"probe, not on a training path (python -m "
                 f"acmgnn_tpu_torch.tools.gather_probe): {per_config} "
                 f"launches per configuration, 1 per probe call; "
                 f"{forms[0]} form"))
    _, _, xb, idxb = configs[0]
    ms = time_ms(lambda: torch.index_select(xb, 0, idxb), 20)
    b_ms, _ = bound(4 * m + 2 * m * d * 4, 0)
    print(f"  yardstick torch.index_select from [{xb.shape[0]}, {d}] f32 in "
          f"device memory: {ms:.4f} ms ({m / ms * 1e3 / 1e6:.1f} M rows/s; "
          f"bound {b_ms:.4f} bytes, rows read once each)")
    return rows


class _SplitLog:
    """A logger that keeps each split's result and the per-epoch rows
    logged at ``display_step=1``."""

    def __init__(self):
        self.splits, self.rows = [], []

    def info(self, msg, *args):
        if "epoch" in msg:
            self.rows.append(args)

    def log_split(self, idx, res):
        self.splits.append(res)

    def log_result(self, out):
        pass


def _same_results(tag, a, b):
    """Fail unless two runs' split results agree bit for bit."""
    import torch

    fields = ("test_metric", "val_metric", "val_loss", "train_loss")
    if len(a) != len(b) or any(
            x.epochs_run != y.epochs_run
            or not all(torch.equal(getattr(x, f), getattr(y, f))
                       for f in fields) for x, y in zip(a, b)):
        fail(f"{tag} the split results differ: {a} != {b}")


def _experiment(tag, data, cfg, expected, prepared=None):
    """``run_experiment`` on the card with the launch counts reset before
    and read after (``expected(bodies)``, ``bodies`` the loop bodies of
    all splits), peak memory from a reset, one capture for the run (its
    later splits replay the first's graph); then the same run through a
    ``runner=`` hook that makes a new split runner a split (a capture a
    split, the port's form before PR 14): every split's result equal bit
    for bit, and that run's ms/epoch over split 1's replays printed beside
    the reused run's ``epoch_ms_steady``.  Returns (result, counts, peak
    MiB, split 1's replays ms/epoch)."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train import run_experiment
    from acmgnn_tpu_torch.train.trainer import make_split_runner

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    log = _SplitLog()
    t0 = time.perf_counter()
    with _captured_runs(tag):
        out = run_experiment(data, cfg, prepared=prepared, logger=log)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    bodies = out["epochs_total"] + (cfg.num_splits if cfg.joint else 0)
    print(f"{tag} run_experiment {cfg.num_splits} splits x {cfg.epochs} "
          f"epochs, one capture: {time.perf_counter() - t0:.1f} s; peak "
          f"{peak:.0f} MiB; {json.dumps(out)}")
    want = expected(bodies)
    print(f"{tag} launches {json.dumps(counts, sort_keys=True)}")
    if without_loop_kernels(counts) != want:
        fail(f"{tag} launch counts {counts} != expected {want}")
    if not np.isfinite(out["test_mean"]) or out["epoch_ms_steady"] is None:
        fail(f"{tag} no finite result")

    timings, fresh = [], _SplitLog()

    def per_split(model, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res, st = make_split_runner(model, cfg)(*args, return_state=True,
                                                **kwargs)
        torch.cuda.synchronize()
        timings.append((1e3 * (time.perf_counter() - t) - st.setup_ms)
                       / st.replays)
        return res

    with _captured_runs(f"{tag} a runner a split", cfg.num_splits):
        ref = run_experiment(data, cfg, prepared=prepared, runner=per_split,
                             logger=fresh)
    _same_results(tag, log.splits, fresh.splits)
    if ref["per_split"] != out["per_split"]:
        fail(f"{tag} per_split {out['per_split']} != {ref['per_split']}")
    print(f"{tag} = the same run with a new runner (and capture) a split, "
          f"bit for bit ({cfg.num_splits} split results); epoch_ms_steady "
          f"{out['epoch_ms_steady']:.3f} (one capture) beside that run's "
          f"{ref['epoch_ms_steady']:.3f} (a capture a split) and its split "
          f"1 replays {timings[-1]:.3f} ms/epoch ({CARD_LINE})")
    return out, counts, peak, timings[-1]


STEPWISE_PAIRS = 3


def _stepwise_run(data, cfg, graph, ckpt=None):
    """``run_experiment_stepwise`` on the card, its launches counted from
    a reset and its per-epoch rows logged: (result, rows, counts)."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train.trainer import run_experiment_stepwise

    torch.cuda.synchronize()
    kernels.reset_launches()
    log = _SplitLog()
    out = run_experiment_stepwise(
        data, cfg, logger=log, display_step=1, graph=graph,
        checkpoint_dir=None if ckpt is None else str(ckpt),
        checkpoint_every=cfg.epochs if ckpt is not None else 0)
    torch.cuda.synchronize()
    return out, log.rows, dict(kernels.launches)


def phase_stepwise(data, cfg):
    """[7b] ``run_experiment_stepwise`` on the headline at full width,
    sequential, ``cfg.num_splits`` splits: one capture for the run (the
    first epoch eager, the second captured, every later epoch of every
    split a replay), launch counts as ``sequential_counts`` implies; bit
    for bit against its ``graph=False`` form (every epoch's loss and
    metrics, each split's final weights, Adam's moments and step, best
    weights); then ``epoch_ms_steady`` of the two forms in
    ``STEPWISE_PAIRS`` alternating pairs.  Returns the captured run's
    result."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with _captured_runs("[7b stepwise]") as calls:
            out, rows, counts = _stepwise_run(data, cfg, True, tmp / "c")
        eager, eager_rows, eager_counts = _stepwise_run(data, cfg, False,
                                                        tmp / "e")
        epochs = cfg.num_splits * cfg.epochs
        want = sequential_counts(epochs, "k1_spmm", 7, k4=False)
        print(f"[7b] run_experiment_stepwise {cfg.num_splits} splits x "
              f"{cfg.epochs} epochs, captured: {json.dumps(out)}; "
              f"{sum(c[1] for c in calls)} replays, captures "
              f"{[round(c[2], 1) for c in calls if c[2] is not None]} ms; "
              f"launches {json.dumps(counts, sort_keys=True)}")
        if (without_loop_kernels(counts) != want or counts != eager_counts
                or LOOP_COUNTER in counts):
            fail(f"[7b] stepwise launch counts {counts} (eager "
                 f"{eager_counts}) != expected {want}")
        if rows != eager_rows or len(rows) != epochs:
            fail(f"[7b] stepwise captured rows {rows} != eager {eager_rows}")
        for idx in range(cfg.num_splits):
            for f in ("last", "best"):
                if not _tree_equal(*(_restore(tmp / d / f"split{idx}_{f}")
                                     for d in ("c", "e"))):
                    fail(f"[7b] stepwise split{idx}_{f}: the captured run's "
                         f"snapshot differs from the eager one's")
    print(f"[7b] stepwise captured = graph=False, bit for bit: {epochs} "
          f"epochs' loss and metrics, each split's final weights, Adam's "
          f"moments and step, best weights")
    steady = {False: [], True: []}
    for i in range(STEPWISE_PAIRS):
        for graph in ((False, True) if i % 2 == 0 else (True, False)):
            steady[graph].append(
                _stepwise_run(data, cfg, graph)[0]["epoch_ms_steady"])
    e, c = (float(np.median(steady[g])) for g in (False, True))
    print(f"[7b] stepwise epoch_ms_steady in {STEPWISE_PAIRS} alternating "
          f"pairs: eager {[round(v, 3) for v in steady[False]]}, captured "
          f"{[round(v, 3) for v in steady[True]]}; medians {e:.3f} / "
          f"{c:.3f} ({CARD_LINE}); prediction (PERF.md, PR 14) captured "
          f"2.8-4.0: {'held' if 2.8 <= c <= 4.0 else 'missed'}")
    out["pairs"] = {"eager": steady[False], "captured": steady[True]}
    return out


def _restore(path):
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    return restore_checkpoint(path, map_location="cpu")


def phase_entry_points(adj, feats, labels):
    """[7b] ``run_experiment`` on the headline configuration at full size
    (2 splits, joint loop; ``_experiment``) and ``run_experiment_stepwise``
    (2 splits, sequential epochs; ``phase_stepwise``) with launch counts;
    [7c] each knob of this slice in one short ``run_experiment`` at full
    size, each one capture a run and equal to a runner a split: remat
    (peak memory beside the plain run), bf16 features + bf16 GEMMs, AdamW,
    RCM reorder (with the host seconds of the order itself)."""
    from acmgnn_tpu_torch.ops.graph import GraphData, locality_order
    from acmgnn_tpu_torch.train.trainer import prepare_data

    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    cfg = headline_config(epochs=EXPERIMENT_EPOCHS, num_splits=2)
    out = {}
    out["experiment"] = _experiment(
        "[7b]", data, cfg, lambda b: joint_counts(b, "k1_spmm", 7))
    out["stepwise"] = phase_stepwise(data, dataclasses.replace(
        cfg, epochs=STEPWISE_EPOCHS, joint=False))

    knob = dataclasses.replace(cfg, epochs=KNOB_EPOCHS)
    prepared = prepare_data(data, knob)
    plain = lambda b: joint_counts(b, "k1_spmm", 7)    # noqa: E731
    reused = lambda b: {**plain(b), "k1_spmm_w7": b}   # noqa: E731
    out["plain"] = _experiment("[7c plain]", data, knob, reused, prepared)
    out["remat"] = _experiment(
        "[7c remat]", data, dataclasses.replace(knob, remat=True),
        lambda b: remat_counts(b, setup=0), prepared)
    print("[7c] remat runs in the captured form: its recompute draws the "
          "forward's masks from the same keys (seed, epoch, site), nothing "
          "restored (phase 8a holds the captured form to the eager one bit "
          "for bit)")
    print(f"[7c] peak memory: plain {out['plain'][2]:.0f} MiB, remat "
          f"{out['remat'][2]:.0f} MiB; ms/epoch steady: plain "
          f"{out['plain'][0]['epoch_ms_steady']:.3f}, remat "
          f"{out['remat'][0]['epoch_ms_steady']:.3f}")
    out["adamw"] = _experiment(
        "[7c adamw]", data, dataclasses.replace(knob, optimizer="adamw"),
        reused, prepared)
    out["bf16"] = _experiment(
        "[7c bf16 features + GEMMs]", data,
        dataclasses.replace(knob, feature_dtype="bfloat16",
                            gemm_dtype="bfloat16"), plain)
    t0 = time.perf_counter()
    perm = locality_order(adj, "rcm")
    rcm_s = time.perf_counter() - t0
    print(f"[7c] RCM order of N={adj.shape[0]} nnz={adj.nnz}: {rcm_s:.2f} s "
          f"on the host (scipy); bandwidth before "
          f"{_bandwidth(adj)}, after {_bandwidth(adj[perm][:, perm])}")
    out["rcm"] = _experiment(
        "[7c reorder rcm]", data, dataclasses.replace(knob, reorder="rcm"),
        plain)
    out["rcm_s"] = rcm_s
    for tag, key, lo, hi in (("7b", "experiment", 2.4, 3.2),
                             ("7c plain", "plain", 2.4, 3.5)):
        v = out[key][0]["epoch_ms_steady"]
        print(f"[{tag}] prediction (PERF.md, PR 14): epoch_ms_steady "
              f"{lo}-{hi}: {v:.3f}, {'held' if lo <= v <= hi else 'missed'} "
              f"(split 1's replays with a capture a split: "
              f"{out[key][3]:.3f})")
    return out


def _bandwidth(adj) -> int:
    """The largest |row - column| of a nonzero."""
    import scipy.sparse as sp

    coo = sp.coo_matrix(adj)
    return int(np.abs(coo.row.astype(np.int64) - coo.col).max())


def bf16_check_config():
    """Phase 7c's card-against-CPU check of bf16 features with bf16 GEMMs:
    phase 6c's configuration (``sharded_check_config``) with both knobs.
    A bf16 rounding that a last-bit f32 difference flips moves a value by
    2^-8 relative, and on phase 4's configuration (lr 0.01, weight decay,
    random labels) 20 epochs amplify that to 3.3e-2 card against CPU (H100
    80GB HBM3, 700 W); here two summation orders of the CPU port part by
    3.6e-4 (tests/test_torch_experiment.py pins it below 1e-3)."""
    return dataclasses.replace(sharded_check_config("ell"),
                               feature_dtype="bfloat16",
                               gemm_dtype="bfloat16")


def knob_check_config(**over):
    """Phase 4's configuration (the card-against-CPU checks of 4 and 7c)
    with ``over``."""
    return headline_config(**dict(dict(hidden=16, dropout=0.0,
                                       spmm_dtype="float32", epochs=20),
                                  **over))


def adamw_check_config():
    """Phase 7c's AdamW trajectory check: phase 4's configuration at lr
    1e-3.  A 20-epoch comparison of two runs that differ in rounding only
    holds until a ReLU input lands within that rounding of zero: at lr
    0.01 one does at epoch 8 (an output-layer input at 1.0e-7), and the
    card parts from the CPU by 1.092e-2 (H100 80GB HBM3, 700 W); the CPU
    port's own two summation orders (ELL and COO, 8 threads) part there
    by the same 1.092e-2 (tests/test_torch_experiment.py).  At lr 1e-3
    the card's rounding crosses no ReLU input.  The optimizer's own
    arithmetic at lr 0.01, decay included, is held by
    ``phase_optimizer_check``."""
    return knob_check_config(optimizer="adamw", lr=1e-3)


OPT_STEPS = 20


def optimizer_case(cfg, seed=0):
    """Phase 4's model's initial parameters (f32) and ``OPT_STEPS`` seeded
    gradients for each, of magnitudes from 1e-7 to 1e-2 (a training
    run's range), as NumPy arrays ``[steps, *shape]``."""
    from acmgnn_tpu_torch.train.trainer import build_model

    model = build_model(cfg, 7, 2, device="cpu", seed=3)
    rng = np.random.default_rng(seed)
    params, grads = [], []
    for p in model.parameters():
        p = p.detach().numpy().astype(np.float32)
        shape = (OPT_STEPS, *p.shape)
        grads.append((rng.standard_normal(shape)
                      * 10.0 ** rng.uniform(-7, -2, shape)).astype(np.float32))
        params.append(p)
    return params, grads


def optimizer_reference(cfg, params, grads, weight_decay=None):
    """optax's update in f64 NumPy, written from its definition: "adam" is
    ``add_decayed_weights -> scale_by_adam -> scale(-lr)`` (the decay in
    the gradient, before the moments), "adamw" is ``optax.adamw`` (the
    decay beside the Adam step, ``p -= lr·(step + wd·p)``)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    wd = cfg.weight_decay if weight_decay is None else weight_decay
    out = []
    for p, g in zip(params, grads):
        p = p.astype(np.float64)
        m, v = np.zeros_like(p), np.zeros_like(p)
        for t, gt in enumerate(g.astype(np.float64), 1):
            if cfg.optimizer == "adam":
                gt = gt + wd * p
            m = b1 * m + (1 - b1) * gt
            v = b2 * v + (1 - b2) * gt * gt
            step = m / (1 - b1 ** t) / (np.sqrt(v / (1 - b2 ** t)) + eps)
            if cfg.optimizer == "adamw":
                step = step + wd * p
            p = p - cfg.lr * step
        out.append(p)
    return out


def optimizer_steps(cfg, params, grads, device, capturable=None):
    """``make_optimizer(cfg)`` over the given gradients, driven by the
    split runner's loop (``trainer.Replay``): on the card the first step
    eagerly, the second captured as a CUDA graph, the rest replays of it.
    The final parameters as NumPy arrays."""
    import torch

    from acmgnn_tpu_torch.train import trainer

    device = torch.device(device)
    ps = [torch.nn.Parameter(torch.tensor(p, device=device)) for p in params]
    gs = [torch.tensor(g, device=device) for g in grads]
    for p in ps:
        p.grad = torch.zeros_like(p)
    opt = trainer.make_optimizer(cfg, ps, capturable=capturable)
    k = torch.zeros(1, dtype=torch.long, device=device)

    def body():
        for p, g in zip(ps, gs):
            p.grad.copy_(g.index_select(0, k)[0])
        opt.step()
        k.add_(1)

    trainer.Replay(device if device.type == "cuda" else None).run(
        body, OPT_STEPS)
    return [p.detach().cpu().numpy() for p in ps]


# per element, times max(1, |p|): 2 f32 roundings (2^-24 each) of p in
# each of 20 steps is 2.4e-6 at most; the CPU's form reads 1.5e-6
OPT_TOL = 4e-6


def optimizer_check(cfg, device, capturable=None):
    """``optimizer_steps`` against ``optimizer_reference``: the worst
    error over ``OPT_TOL·max(1, |p|)``, and the same measure of the
    reference with the decay left out (a fault the check must see)."""
    params, grads = optimizer_case(cfg)
    got = optimizer_steps(cfg, params, grads, device, capturable)

    def worst(ref):
        return max(float(np.max(np.abs(a - r) / np.maximum(1.0, np.abs(r))))
                   for a, r in zip(got, ref)) / OPT_TOL

    return (worst(optimizer_reference(cfg, params, grads)),
            worst(optimizer_reference(cfg, params, grads, weight_decay=0.0)))


def phase_optimizer_check():
    """[7c] The card's optimizer (``make_optimizer``: capturable, the step
    captured and replayed as in the split runner) at phase 4's lr 0.01 and
    weight decay, Adam and AdamW, on ``OPT_STEPS`` seeded gradients at
    phase 4's parameter shapes, against optax's update in f64: within
    ``OPT_TOL·max(1, |p|)``; the same reference without the decay must
    lie more than ten tolerances away."""
    for opt in ("adam", "adamw"):
        cfg = knob_check_config(optimizer=opt)
        err, no_decay = optimizer_check(cfg, "cuda")
        print(f"[7c {opt} step] card optimizer, lr {cfg.lr:g}, weight decay "
              f"{cfg.weight_decay:g}, {OPT_STEPS} steps (eager, captured, "
              f"replays) against optax in f64: {err:.3f} of the tolerance "
              f"{OPT_TOL:g}·max(1, |p|); without the decay {no_decay:.1f}")
        if not err <= 1.0:
            fail(f"[7c {opt} step] the card's optimizer disagrees with optax")
        if not no_decay > 10.0:
            fail(f"[7c {opt} step] the check cannot see the decay")


def phase_knobs_card_vs_cpu():
    """[7c] Each knob of this slice, card against CPU from the same
    initial parameters at dropout 0 (the CPU and the card draw different
    dropout streams): remat and the RCM reorder on phase 4's small graph
    and configuration, AdamW there at lr 1e-3 (``adamw_check_config``),
    within 1e-4 (f32: summation order only); bf16 features with bf16
    GEMMs on phase 6c's graph and configuration within 1e-2
    (``bf16_check_config``).  AdamW at lr 0.01 is printed beside the
    CPU's ELL and COO orders, not held."""
    import torch

    from acmgnn_tpu_torch.data.splits import random_disassortative_splits
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    adj, feats, labels = twitch_gamers_scale_graph(0, n=2000, pairs=40_000)
    data = GraphData("small", adj, np.abs(feats), labels)
    for tag, cfg in (("remat", knob_check_config(remat=True)),
                     ("adamw", adamw_check_config()),
                     ("reorder rcm", knob_check_config(reorder="rcm"))):
        card_vs_cpu(f"[7c {tag}]", data, cfg, _masks(2000))
    # at lr 0.01 a ReLU input lies within rounding of zero at epoch 8
    # (adamw_check_config): where the card's run lands beside the CPU's
    # two summation orders, read and not held
    cfg = knob_check_config(optimizer="adamw")
    card = trained(data, cfg, _masks(2000), "cuda")[1]
    apart = {fmt: max_param_diff(card, trained(
        data, dataclasses.replace(cfg, operator_format=fmt), _masks(2000),
        "cpu")[1]) for fmt in ("ell", "coo")}
    print(f"[7c adamw lr {cfg.lr:g}] card vs CPU after {cfg.epochs} epochs "
          f"(read, not held), max |Δparam|: ELL order {apart['ell']:.3e}, "
          f"COO order {apart['coo']:.3e} ({torch.get_num_threads()} CPU "
          f"threads)")
    cfg = bf16_check_config()
    data = _small_twitch()
    masks = np.stack(random_disassortative_splits(
        data.labels, 2, rng=np.random.default_rng(cfg.seed)))
    card_vs_cpu("[7c bf16 features + GEMMs]", data, cfg, masks, tol=1e-2,
                seed=cfg.seed)


# ---------------------------------------------------------------------------
# Phase 8: the captured split loop against the eager one
# ---------------------------------------------------------------------------

CAPTURE_EPOCHS, CAPTURE_PAIRS = 20, 10


def _split(prepared, cfg, masks, graph, seed=7):
    """One split of ``cfg`` on ``prepare_data``'s output from
    ``build_model(seed)``, eager (``graph=False``) or captured (True):
    result, end state, final parameters, launch counts, the run's peak
    MiB above what was allocated before it (the prepared graphs, the
    model), and wall seconds."""
    import torch

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train.trainer import build_model, make_split_runner

    _, ops, x, y, y1h, nclass = prepared
    model = build_model(cfg, x.shape[1], nclass, seed=seed,
                        nnodes=x.shape[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    runner = make_split_runner(model, cfg, graph=graph)
    with _loop_launches() as launched:
        res, state = runner(ops, x, y, masks, seed=seed, labels_onehot=y1h,
                            return_state=True)
    torch.cuda.synchronize()
    return dict(res=res, state=state, wall=time.perf_counter() - t0,
                counts=_loop_counted(dict(kernels.launches), state,
                                     launched[0]),
                peak=(torch.cuda.max_memory_allocated() - base) / 2**20,
                params={k: p.detach().clone()
                        for k, p in model.state_dict().items()},
                nodes=body_node_types(runner))


def _loop_counted(counts, state, launched):
    """``counts`` without K9's counter, which must read one launch per
    device loop launched plus one per body it ran (none eager); a loop
    launched at all must be the call's one launch."""
    k9 = counts.pop(LOOP_COUNTER, 0)
    if launched > 1 or k9 != launched + (state.replays if launched else 0):
        fail(f"K9 ran {k9} times in {launched} device-loop launches of "
             f"{state.replays} bodies")
    return counts


def _bit_equal(tag, eager, captured):
    """Fail unless the two runs agree bit for bit."""
    import torch

    pairs = [(f, getattr(eager["res"], f), getattr(captured["res"], f))
             for f in ("test_metric", "val_metric", "val_loss", "train_loss")]
    pairs += [(f, getattr(eager["state"], f), getattr(captured["state"], f))
              for f in ("train_losses", "val_hist")]
    pairs += [(k, v, captured["params"][k]) for k, v in eager["params"].items()]
    unequal = [f for f, a, b in pairs
               if a.shape != b.shape or not torch.equal(a, b)]
    if unequal or eager["res"].epochs_run != captured["res"].epochs_run:
        fail(f"{tag} the two runs differ: {unequal}, epochs_run "
             f"{eager['res'].epochs_run}/{captured['res'].epochs_run}")
    return len(pairs)


def phase_capture_equality(cases):
    """[8a] Each case eager, then captured, ``CAPTURE_EPOCHS`` epochs from
    the same parameters and seed: bit-equal parameters, train-loss and
    val-loss histories, best metrics and ``epochs_run``; equal launch
    counts, each what ``expected(bodies)`` implies (the set-up gather ran
    in ``prepare_data``, before the count); no K2/K3 occupancy query made
    by the captured run (its buffers take the eager launches' vector
    width); the capture's ms and both forms' peak memory."""
    from acmgnn_tpu_torch.models import layers

    out = {}
    for tag, prepared, cfg, masks, expected in cases:
        eager = _split(prepared, cfg, masks, False)
        resident = set(layers._resident)
        captured = _split(prepared, cfg, masks, True)
        if set(layers._resident) != resident:
            fail(f"[8a {tag}] the capture asked the occupancy of "
                 f"{set(layers._resident) - resident}")
        n = _bit_equal(f"[8a {tag}]", eager, captured)
        bodies = captured["state"].epoch
        want = expected(bodies)
        if eager["counts"] != captured["counts"] or \
                without_loop_kernels(captured["counts"]) != want:
            fail(f"[8a {tag}] launch counts eager {eager['counts']}, "
                 f"captured {captured['counts']}, expected {want}")
        print(f"[8a {tag}] eager and captured, {cfg.epochs} epochs "
              f"(early_stopping {cfg.early_stopping}): bit-equal ({n} "
              f"tensors: best metrics, train-loss and val-loss histories, "
              f"parameters), epochs_run {captured['res'].epochs_run}, "
              f"{bodies} bodies; launch counts equal and as expected "
              f"{json.dumps(want, sort_keys=True)} (K8 "
              f"{captured['counts'].get('k8_dropout_fwd', 0)} fwd, "
              f"{captured['counts'].get('k8_dropout_bwd', 0)} bwd); body "
              f"node types {captured['nodes']}; capture "
              f"{captured['state'].capture_ms:.1f} ms; the run's peak memory "
              f"above its inputs: eager {eager['peak']:.0f} MiB, captured "
              f"{captured['peak']:.0f} MiB")
        out[tag] = dict(capture_ms=captured["state"].capture_ms,
                        peak_eager=eager["peak"],
                        peak_captured=captured["peak"])
    return out


def _quartiles(v):
    q1, q2, q3 = np.percentile(v, [25, 50, 75])
    return float(q1), float(q2), float(q3)


def phase_capture_pairs(tag, prepared, cfg, masks, pairs=CAPTURE_PAIRS):
    """[8b] Eager against captured in alternating pairs (eager first in
    even pairs), ``cfg.epochs`` epochs a run after one warm-up run of
    each: ms/epoch over the whole run (what a run costs, the captured
    form's set-up included) and, captured, over the replays; medians,
    quartiles, the pairs the captured form won; then one profile of each
    form.  Returns (median eager, median captured run, median replays)
    ms/epoch."""
    from acmgnn_tpu_torch.train.trainer import build_model, make_split_runner

    for graph in (False, True):
        _split(prepared, cfg, masks, graph)
    ms = {False: [], True: []}
    replay, capture = [], []
    for i in range(pairs):
        for graph in ((False, True) if i % 2 == 0 else (True, False)):
            r = _split(prepared, cfg, masks, graph, seed=i)
            bodies = r["state"].epoch
            ms[graph].append(1e3 * r["wall"] / bodies)
            if graph:
                replay.append((1e3 * r["wall"] - r["state"].setup_ms)
                              / r["state"].replays)
                capture.append(r["state"].capture_ms)
    wins = sum(c < e for e, c in zip(ms[False], ms[True]))
    print(f"[8b {tag}] {pairs} alternating pairs, {cfg.epochs} epochs a "
          f"run, ms/epoch: eager {[round(v, 3) for v in ms[False]]}; "
          f"captured {[round(v, 3) for v in ms[True]]}; captured replays "
          f"{[round(v, 3) for v in replay]}; capture ms "
          f"{[round(v, 1) for v in capture]}")
    e, c, r = (_quartiles(ms[False]), _quartiles(ms[True]),
               _quartiles(replay))
    print(f"[8b {tag}] medians (quartiles): eager {e[1]:.3f} ({e[0]:.3f}-"
          f"{e[2]:.3f}), captured run {c[1]:.3f} ({c[0]:.3f}-{c[2]:.3f}), "
          f"captured replays {r[1]:.3f} ({r[0]:.3f}-{r[2]:.3f}) ms/epoch; "
          f"the captured run faster in {wins} of {pairs} pairs; capture "
          f"median {float(np.median(capture)):.1f} ms")
    _, ops, x, y, y1h, nclass = prepared
    model = build_model(cfg, x.shape[1], nclass, seed=7)
    for graph, form in ((False, "eager"), (True, "captured")):
        def run_of(epochs, graph=graph):
            c = dataclasses.replace(cfg, epochs=epochs)
            return _bodies(c, make_split_runner(model, c, graph=graph)(
                ops, x, y, masks, labels_onehot=y1h))

        phase_profile(f"[8b {tag} {form}]", run_of)
    return e[1], c[1], r[1]


def phase_capture(adj, feats, labels, g_adj, g_feats, g_labels, g_masks):
    """[8] The captured loop against the eager one: bit for bit (8a) on
    the headline (with and without remat, and with AdamW) and on genius's
    four routes,
    then timed in alternating pairs and profiled (8b) on the headline and
    genius joint ELL."""
    import torch

    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.trainer import prepare_data

    def on_card(masks_np):
        return tuple(torch.from_numpy(m).cuda() for m in masks_np)

    h_cfg = headline_config(epochs=CAPTURE_EPOCHS)
    h = prepare_data(GraphData("twitch-gamers-scale-uniform", adj, feats,
                               labels), h_cfg)
    h_masks = on_card(_masks(adj.shape[0]))
    g_data = GraphData("genius-scale", g_adj, g_feats, g_labels)
    g_cfg = genius_config(epochs=CAPTURE_EPOCHS)
    g = prepare_data(g_data, g_cfg)
    gc_cfg = genius_config(operator_format="coo", epochs=CAPTURE_EPOCHS)
    gc = prepare_data(g_data, gc_cfg)
    gm = on_card(g_masks)

    def joint(gather, width, k4=False):
        return lambda b: {**joint_counts(b, gather, width, k4=k4),
                          f"{gather}_w{width}": b}

    def sequential(b):
        return {**sequential_counts(b, "k1_spmm", 12), "k1_spmm_w12": b}

    seq = dataclasses.replace(g_cfg, joint=False)
    out = phase_capture_equality([
        ("headline", h, h_cfg, h_masks, joint("k1_spmm", 7)),
        ("headline remat", h, dataclasses.replace(h_cfg, remat=True),
         h_masks, lambda b: remat_counts(b, setup=0)),
        ("headline adamw", h, dataclasses.replace(h_cfg, optimizer="adamw"),
         h_masks, joint("k1_spmm", 7)),
        ("genius joint ell", g, g_cfg, gm, joint("k1_spmm", 12, k4=True)),
        ("genius joint coo", gc, gc_cfg, gm, joint("k5_coo", 12, k4=True)),
        ("genius sequential", g, seq, gm, sequential),
        ("genius sequential+es", g, dataclasses.replace(
            seq, early_stopping=GENIUS_ES), gm, sequential),
    ])
    out["pairs"] = {
        "headline": phase_capture_pairs("headline", h, h_cfg, h_masks),
        "genius joint ell": phase_capture_pairs("genius joint ell", g,
                                                g_cfg, gm),
    }
    return out

# ---------------------------------------------------------------------------
# Phase 9: the operator layer and the model zoo
# ---------------------------------------------------------------------------

PP_EPOCHS, SYM_EPOCHS, DENSE_EPOCHS, ZOO_EPOCHS = 20, 20, 20, 8
# 9c holds a card's trajectory to the CPU's only where the CPU port's own
# runs with the features moved by one ulp, WITNESS_DRAWS draws
# (``cpu_witness``), stay within WITNESS_SHARE of the tolerance
WITNESS_SHARE, WITNESS_DRAWS = 0.1, 4
# 9d holds the card to the CPU over ZOO_CPU_EPOCHS at lr 1e-3, weight
# decay 5e-4, dropout 0: there the CPU port's own ELL and COO orders part
# by at most 1.7e-5 on every case (this configuration measured on a CPU);
# without decay a BatchNorm channel the ReLU leaves dead turns rounding
# into Adam's ±lr steps (acmgcnpp with init_layers_X 2: 6.2e-3 after 8
# epochs), with decay 1e-3 a gcnII weight whose gradient cancels its
# decay does (4.6e-4), and at 8 epochs acmgcnp reads 6.2e-5
ZOO_CPU_EPOCHS = 5
# the structure operator's K1 widths on penn94_pp: hidden 64, 2 classes
PP_STRUCT_WIDTHS = (64, 2)
PP_FEATURES = 4814        # penn94's feature width (LINKX_SCALE)
# a chameleon-shaped graph (the small heterophily benchmark of the paper's
# ACM-Pytorch pipeline: 2,277 nodes, 36,101 edges, 2,325 bag-of-words
# features, 5 classes): Chung-Lu pairs with a top degree of 700, binary
# features at 2% density; 'auto' builds the dense operator
CHAMELEON = dict(n=2277, e=36_101, f=2325, c=5, max_deg=700)
ZOO_N = 2000             # 9d's graph
# the K2/K3 instances (ReLU per channel; T is its length) checked in 9a,
# each at the rows and widths of the run whose launches its rows report:
# (mask, phase, case, rows (None: penn94_pp's), widths)
INSTANCE_RUNS = (
    ((True,) * 4, "9b", "penn94_pp", None, (64, 2)),
    ((False, False, True, True), "9d", "acmgcnp structure variant 1", ZOO_N,
     (64, 2)),
    ((False, False, True, True), "9c", "acmgcnp structure variant 1",
     CHAMELEON["n"], (64, CHAMELEON["c"])),
    ((False, False, True), "9d", "acmgcn variant 1", ZOO_N, (64, 2)),
    ((False, False, False), "9d", "acmsgc", ZOO_N, (2,)),
    ((False, False, False), "9c", "acmsgc hops 2", CHAMELEON["n"],
     (CHAMELEON["c"],)),
)
INSTANCE_SITE = {"9b": "penn94", "9c": "chameleon", "9d": "zoo"}


def valued(counts):
    """``counts`` with every K1 counter of a valued operator's name."""
    return {(f"{k}_valued" if k.startswith("k1_spmm") else k): v
            for k, v in counts.items()}


def pp_counts(bodies, setup=1):
    """Launches a joint penn94_pp run of ``bodies`` iterations implies
    (acmgcnpp, hoist, structure channel, F = 4814 > HOIST_MAX_COLS):
    layer 1's train branch projects and gathers 2·64 = 128 wide and
    transposes as wide (its eval branch reads x_agg: one w4814 set-up
    gather), the structure gather of each layer (w64, w2) and its
    transpose, layer 2's paired gather (w8) and its prefix transpose
    (w4); K2 at T = 4 per branch and layer, K3 per layer."""
    b = bodies
    return {"k1_spmm_w4814": setup, "k1_spmm_w128": 2 * b,
            "k1_spmm_w64": 2 * b, "k1_spmm_w2": 2 * b, "k1_spmm_w8": b,
            "k1_spmm_w4": b, "k2_attn_fwd_t4_d64": 2 * b,
            "k2_attn_fwd_t4_d2": 2 * b, "k3_attn_bwd_t4_d64": b,
            "k3_attn_bwd_t4_d2": b}


def penn94_pp_config(**over):
    """bench.py's penn94_pp scenario (``bench.py:562-564``, ``:599-660``):
    ACM-GCN++ with the structure channel, hidden 64, dropout 0.5, Adam lr
    0.01 wd 1e-3, projected LayerNorm, joint loop, hoist, bf16 gathers
    and GEMMs, ELL."""
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcnpp", structure_info=True, hidden=64, dropout=0.5,
        lr=0.01, weight_decay=1e-3, epochs=WARM_EPOCHS, early_stopping=0,
        selection="val_metric", operator_format="ell",
        spmm_dtype="bfloat16", gemm_dtype="bfloat16", joint=True,
        hoist_first=True), **over))


def _k1_rows(op_half, xs, tag, counter_of, lib, replaces):
    """K1 on ``op_half`` for each ``(operand, z, alpha, beta, name)``:
    per element against the plain version, bit for bit against
    ``k1_order_replay``, timed beside the plain version and
    ``torch.sparse.mm`` on ``lib``; one kernel-table row each."""
    import torch

    from acmgnn_tpu_torch.ops.ell import (
        k1_order_replay,
        row_gather_spmm,
        row_gather_spmm_plain,
    )

    rows = []
    n, nnz = op_half.num_rows, int(op_half.indices.numel())
    for xg, z, alpha, beta, name in xs:
        d = xg.shape[1]
        a = tuple(alpha or (0.0,) * d)
        b = tuple(beta or (1.0,) * d)
        half_abs = (op_half if op_half.vals is None else
                    dataclasses.replace(op_half, vals=op_half.vals.abs()))
        got = row_gather_spmm(op_half, xg, z=z, alpha=alpha, beta=beta)
        err = spmm_err(got, row_gather_spmm_plain(op_half, xg, z, a, b),
                       row_gather_spmm_plain(half_abs, xg.abs(), _abs(z),
                                             _abs(a), _abs(b)),
                       _ell_row_terms(op_half) + int(z is not None),
                       name + tag)
        if not torch.equal(got, k1_order_replay(
                op_half, xg, z if any(a) else None, a, b)):
            fail(f"{name + tag}: K1 differs from its summation order "
                 f"replayed")
        vals = "none" if op_half.vals is None else op_half.vals.dtype
        print(f"  {name + tag}: equal bit for bit to k1_order_replay "
              f"(values {vals}, operand {xg.dtype}, row stride "
              f"{xg.stride(0)})")

        def run():
            return row_gather_spmm(op_half, xg, z=z, alpha=alpha, beta=beta)

        form, note = _k1_form_note(op_half, xg)
        if form == "wide":
            print(f"  {name + tag} the narrow form on the same operand: "
                  f"device {_k1_narrow_ms(op_half, xg, z, alpha, beta)}")
        ms, dev_ms = time_ms(run, 50), device_ms(run)
        plain_ms = time_ms(lambda: row_gather_spmm_plain(op_half, xg, z, a,
                                                         b), 5)
        xf = xg.float()
        lib_ms = time_ms(lambda: torch.sparse.mm(lib, xf), 20)
        lib_dev = device_ms(lambda: torch.sparse.mm(lib, xf))
        vbytes = 0 if op_half.vals is None else \
            nnz * op_half.vals.element_size()
        nbytes = (8 * (n + 1) + 4 * nnz + vbytes + 4 * n
                  + xg.element_size() * xg.shape[0] * d + 4 * n * d
                  + (4 * n * d if z is not None else 0)
                  + (4 * n if op_half.row_scale is not None else 0))
        b_ms, b_by = bound(nbytes, (2 if op_half.vals is not None else 1)
                           * nnz * d + 2 * n * d)
        rows.append(dict(name=name + tag, counter=counter_of(d), route="cuda",
                         source="acmgnn_tpu_torch/csrc/spmm.cu",
                         replaces=replaces, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms,
                         library_device_ms=lib_dev, form=form))
        print(f"  {name + tag} ({note}): {ms:.4f} ms, device {_ms(dev_ms)} "
              f"(plain {plain_ms:.3f}, torch.sparse.mm f32 {lib_ms:.4f}, "
              f"device {_ms(lib_dev)}; bound {b_ms:.4f} {b_by}; {CARD_LINE})")
    return rows


def _attention_instance_rows(n, gen, relu, use_ln, widths, tag):
    """K2/K3 at one (T, ReLU mask) instance on ``n`` rows, against the
    plain versions (planted faults included), bit-reproducible, timed."""
    import torch

    from acmgnn_tpu_torch.models import layers

    dev = torch.device("cuda")
    t = len(relu)
    scale = 1.0 if t == 4 else 3.0
    rows = []
    for d in widths:
        zs, v, c, W, gout = _attention_case(n, d, gen, dev, t)
        args = (zs, v, c, W, use_ln, scale, relu)
        bargs = (zs, gout, v, c, W, use_ln, scale, relu)
        e_fwd, e_bwd = _check_attention(layers, args, bargs, tag,
                                        layers.attention_plan(d), True)
        first = layers.attention_mix_backward(*bargs)
        if not all(torch.equal(a, b) for a, b in zip(
                first, layers.attention_mix_backward(*bargs))):
            fail(f"{layers._counter('bwd', relu, d)}{tag}: two launches "
                 f"differ")
        vec, g, e, resident = layers.attention_config(
            "bwd", zs, [d] * t, d, layers.attention_plan(d), relu)
        grid = layers.attention_grid(n, g, resident)
        params = 4 * (t * d + 2 * t + t * t)
        k3_bytes = (4 * n * d * (2 * t + 1)
                    + 2 * 4 * grid * (t * d + layers.row_sums(t))
                    + 2 * params)
        for kind, fn, plain, err, nbytes, flops in (
                ("fwd", layers.attention_mix_forward,
                 layers.attention_mix_forward_plain, e_fwd,
                 4 * n * d * (t + 1) + params, (6 * t + 2) * n * d),
                ("bwd", layers.attention_mix_backward,
                 layers.attention_mix_backward_plain, e_bwd, k3_bytes,
                 (14 * t + 2) * n * d)):
            a_ = args if kind == "fwd" else bargs
            counter = layers._counter(kind, relu, d)
            ms = time_ms(lambda: fn(*a_), 50)
            dev_ms = device_ms(lambda: fn(*a_))
            plain_ms = time_ms(lambda: plain(*a_), 10)
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(
                name=counter + tag, counter=counter, route="cuda",
                source="acmgnn_tpu_torch/csrc/attention.cu",
                replaces="acmgnn_tpu/models/layers.py:191",
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library_device_ms=None))
            print(f"  {counter + tag}: {ms:.4f} ms, device {_ms(dev_ms)} "
                  f"(plain {plain_ms:.3f}, bound {b_ms:.4f} {b_by}); "
                  f"{g} lanes a row x {e} floats, grid {grid}")
    return rows


def phase_instances(adj, feats, p_adj):
    """[9a] The kernel instances of this slice against their plain
    versions: K2/K3 at each (T, ReLU mask) instance, with and without
    LayerNorm, at the rows and widths of each run that launches it
    (``INSTANCE_RUNS``); K1 with valued halves (bf16 and
    f32 values) on the headline graph in symmetric normalization at the
    joint epoch's widths 7, 8 (high-pass epilogue) and 4 (transpose), bit
    for bit against ``k1_order_replay``; K1 on penn94_pp's structure
    operator (value-free, its own transpose) at w64 and w2, and on its
    row-normalized operator at w128 (layer 1's train gather with the
    high-pass epilogue, and its transpose); K5 on the
    symmetric-normalized COO operator at w7, w8 and w4."""
    import scipy.sparse as sp
    import torch

    from acmgnn_tpu_torch.data.registry import row_normalize_features
    from acmgnn_tpu_torch.ops.coo import coo_spmm, coo_spmm_plain
    from acmgnn_tpu_torch.ops.ell import (
        k1_operand,
        k1_order_replay,
        row_gather_spmm,
    )
    from acmgnn_tpu_torch.ops.graph import (
        make_coo_op,
        precompute_operators,
        row_normalized_adjacency,
        sym_normalized_adjacency,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    n_pp = p_adj.shape[0]
    for relu, phase, case, n_rows, widths in INSTANCE_RUNS:
        for use_ln in (True, False):
            for row in _attention_instance_rows(
                    n_rows or n_pp, gen, relu, use_ln, widths,
                    f"{'' if use_ln else '_noln'}@{INSTANCE_SITE[phase]}"):
                rows.append(dict(row, run=(phase, case)))
    # K1 valued halves: the headline graph, symmetric normalization
    a_sym = sym_normalized_adjacency(adj)
    lib = _csr_on_card(a_sym)
    n = adj.shape[0]
    x_in = torch.from_numpy(row_normalize_features(feats)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        t0 = time.perf_counter()
        op = precompute_operators(adj, normalization="sym", fmt="ell",
                                  spmm_dtype=dtype).adj_low.to(dev)
        if op.bwd is not op.fwd or op.fwd.vals.dtype != dtype:
            fail(f"[9a] the symmetric operator should share one valued "
                 f"half in {dtype}")
        print(f"[9a] symmetric-normalized ELL operator, {dtype} values, one "
              f"half for both directions (host build "
              f"{time.perf_counter() - t0:.1f} s)")
        cases = []
        for (x, z, alpha, beta, tr), nm in zip(
                _spmm_cases(n, gen, x_in), ("w7", "w8", "w4")):
            cases.append((k1_operand(x, dtype), z, alpha, beta,
                          f"k1_spmm_{nm}_valued"))
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        rows += _k1_rows(op.fwd, cases, f"_{dt}@twitch-sym",
                         lambda d: f"k1_spmm_w{d}_valued",
                         lib, "acmgnn_tpu/ops/ell.py:525")
    # K1 on the structure operator of penn94_pp (the raw adjacency)
    s_op = precompute_operators(p_adj, structure_info=True, fmt="ell",
                                spmm_dtype=torch.bfloat16).adj_unnorm.to(dev)
    if s_op.bwd is not s_op.fwd or s_op.fwd.vals is not None:
        fail("[9a] the structure operator should be one value-free half, "
             "its own transpose")
    print("[9a] penn94_pp's structure operator: one value-free half for "
          "both directions (its transpose is the same launch)")
    s_lib = _csr_on_card(sp.csr_matrix(p_adj, dtype=np.float32))
    cases = [(k1_operand(torch.randn(n_pp, d, generator=gen, device=dev),
                         torch.bfloat16), None, None, None,
              f"k1_spmm_w{d}") for d in PP_STRUCT_WIDTHS]
    rows += _k1_rows(s_op.fwd, cases, "@penn94-structure",
                     lambda d: f"k1_spmm_w{d}", s_lib,
                     "acmgnn_tpu/ops/ell.py:693")
    # K1 at w128 on penn94_pp's row-normalized operator: layer 1's train
    # gather (the low and the high projection, 64 wide each, the high one
    # through the epilogue) and its transpose (the operand pre-scaled)
    t0 = time.perf_counter()
    low = precompute_operators(p_adj, fmt="ell",
                               spmm_dtype=torch.bfloat16).adj_low.to(dev)
    a_pp = row_normalized_adjacency(p_adj)
    print(f"[9a] penn94_pp's row-normalized operator (host build "
          f"{time.perf_counter() - t0:.1f} s)")
    hp = [float(h) for h in (0,) * 64 + (1,) * 64]
    z = torch.randn(n_pp, 128, generator=gen, device=dev)
    rows += _k1_rows(low.fwd, [(k1_operand(z, torch.bfloat16), z, hp,
                                [1.0 - 2.0 * h for h in hp], "k1_spmm_w128")],
                     "@penn94", lambda d: "k1_spmm_w128", _csr_on_card(a_pp),
                     "acmgnn_tpu/ops/spmm.py:153")
    g = torch.randn(n_pp, 128, generator=gen, device=dev)
    sign = torch.tensor([1.0 - 2.0 * h for h in hp], device=dev)
    xg = k1_operand((g * sign).to(torch.bfloat16), torch.bfloat16,
                    low.bwd.pre_scale)
    rows += _k1_rows(low.bwd, [(xg, g, hp, [1.0] * 128,
                                "k1_spmm_w128_transpose")],
                     "@penn94", lambda d: "k1_spmm_w128",
                     _csr_on_card(a_pp.T), "acmgnn_tpu/ops/spmm.py:143")
    del z, g, xg
    # the eval branch's set-up gather of the features (x_agg, w4814): per
    # element against the plain version in row chunks, bit for bit
    # against the replay; and wiki's w600 width bit for bit on this graph
    # (41,554 rows), where the replay fits
    a_lib = _csr_on_card(a_pp)
    x = k1_operand(torch.randn(n_pp, PP_FEATURES, generator=gen, device=dev),
                   torch.bfloat16)
    rows.append(_k1_wide_row(low.fwd, x, f"k1_spmm_w{PP_FEATURES}",
                             "@penn94", a_lib, "acmgnn_tpu/ops/ell.py:693",
                             replay=True))
    del x
    x = k1_operand(torch.randn(n_pp, 600, generator=gen, device=dev),
                   torch.bfloat16)
    if not torch.equal(row_gather_spmm(low.fwd, x),
                       k1_order_replay(low.fwd, x, None, (0.0,) * 600,
                                       (1.0,) * 600)):
        fail("k1_spmm_w600@penn94: K1 differs from its summation order "
             "replayed")
    print(f"  k1_spmm_w600@penn94 ({_k1_form_note(low.fwd, x)[1]}): equal "
          f"bit for bit to k1_order_replay (row stride {x.stride(0)}; "
          f"wiki's hoist width on penn94_pp's graph)")
    del x, a_lib
    torch.cuda.empty_cache()
    # K5 on the symmetric-normalized COO operator
    coo = make_coo_op(a_sym).to(dev)
    for (x, z, alpha, beta, tr), nm in zip(_spmm_cases(n, gen, x_in),
                                           ("w7", "w8", "w4")):
        d = x.shape[1]
        half = coo.bwd if tr else coo.fwd
        a = tuple(alpha or (0.0,) * d)
        b = tuple(beta or (1.0,) * d)
        got = coo_spmm(half, x, z=z, alpha=alpha, beta=beta)
        err = spmm_err(got, coo_spmm_plain(half, x, z, a, b),
                       coo_spmm_plain(dataclasses.replace(
                           half, val=half.val.abs()), x.abs(), _abs(z),
                           _abs(a), _abs(b)),
                       _coo_row_terms(half) + int(z is not None),
                       f"k5_coo_{nm}@twitch-sym")
        if not torch.equal(got, coo_spmm(half, x, z=z, alpha=alpha,
                                         beta=beta)):
            fail(f"k5_coo_{nm}@twitch-sym: two launches differ")

        def run():
            return coo_spmm(half, x, z=z, alpha=alpha, beta=beta)

        ms, dev_ms = time_ms(run, 50), device_ms(run)
        plain_ms = time_ms(lambda: coo_spmm_plain(half, x, z, a, b), 5)
        lib_ms = time_ms(lambda: torch.sparse.mm(lib, x), 20)
        lib_dev = device_ms(lambda: torch.sparse.mm(lib, x))
        nnz = coo.nnz
        extra = 4 * (3 * half.span_rows.numel() + half.empty_rows.numel())
        b_ms, b_by = bound(12 * nnz + extra + 8 * n * d
                           + (4 * n * d if z is not None else 0),
                           2 * nnz * d + 2 * n * d)
        rows.append(dict(name=f"k5_coo_{nm}@twitch-sym",
                         counter=f"k5_coo_{nm}", route="cuda",
                         source="acmgnn_tpu_torch/csrc/coo.cu",
                         replaces=K5_REPLACES[int(z is not None) + int(tr)],
                         max_abs_err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms, library_device_ms=lib_dev))
        print(f"  k5_coo_{nm}@twitch-sym: {ms:.4f} ms, device {_ms(dev_ms)} "
              f"(plain {plain_ms:.3f}, torch.sparse.mm f32 {lib_ms:.4f}, "
              f"device {_ms(lib_dev)}; bound {b_ms:.4f} {b_by}); "
              f"bit-identical reruns")
    return rows


K1_CROSSOVER_WIDTHS = (16, 32, 64)


def phase_k1_crossover(adj, p_adj):
    """[9a] Where K1's wide form starts to win: both forms on the
    headline's and penn94_pp's row-normalized operators at
    ``K1_CROSSOVER_WIDTHS``, bf16 and f32 operands, each bit for bit
    against its own order replayed, timed in turns (narrow, wide, wide,
    narrow; device ms); prints the ``K1_WIDE_BYTES`` the times support
    beside the one ``ops/ell.py`` uses."""
    import torch

    from acmgnn_tpu_torch.ops.ell import (
        K1_FORMS,
        K1_WIDE_BYTES,
        _row_gather_spmm_cuda,
        k1_operand,
        k1_order_replay,
    )
    from acmgnn_tpu_torch.ops.graph import precompute_operators

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    wins = []      # (row bytes, graph, dtype, narrow ms, wide ms)
    for graph, a in (("twitch", adj), ("penn94", p_adj)):
        half = precompute_operators(a, fmt="ell",
                                    spmm_dtype=torch.bfloat16).adj_low.fwd
        half = half.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            for d in K1_CROSSOVER_WIDTHS:
                x = k1_operand(torch.randn(half.num_cols, d, generator=gen,
                                           device=dev), dtype)
                ones, zeros = (1.0,) * d, (0.0,) * d
                def run(form):
                    return _row_gather_spmm_cuda(half, x, None, zeros, ones,
                                                 form)

                for form in K1_FORMS:
                    if not torch.equal(run(form), k1_order_replay(
                            half, x, None, zeros, ones, form=form)):
                        fail(f"[9a] K1's {form} form at w{d} {dtype} on "
                             f"{graph} differs from its order replayed")
                ms = {f: [] for f in K1_FORMS}
                for form in ("narrow", "wide", "wide", "narrow"):
                    ms[form].append(device_ms(lambda: run(form)))
                nar, wid = (float(np.mean(ms[f])) for f in K1_FORMS)
                nbytes = d * x.element_size()
                wins.append((nbytes, graph, dtype, nar, wid))
                print(f"  k1 crossover {graph} w{d} {dtype} ({nbytes} B "
                      f"rows): narrow {nar:.4f}, wide {wid:.4f} device ms "
                      f"({'wide' if wid < nar else 'narrow'} faster; both "
                      f"bit for bit against their replays)")
                del x
    sizes = sorted({w[0] for w in wins})
    misses = {c: sum((b >= c) != (wid < nar) for b, _, _, nar, wid in wins)
              for c in sizes + [2 * sizes[-1]]}
    best = min(misses.values())
    supported = [c for c, m in misses.items() if m == best]
    print(f"[9a] K1 crossover: the times support K1_WIDE_BYTES in "
          f"{supported} ({best} of {len(wins)} points disagree; a value "
          f"above {sizes[-1]} means the narrow form everywhere measured); "
          f"ops/ell.py uses {K1_WIDE_BYTES}: "
          f"{'supported' if K1_WIDE_BYTES in supported else 'NOT supported'}"
          f" ({CARD_LINE})")


def phase_penn94_pp(p_adj, p_feats, p_labels):
    """[9b] The slice at full width: penn94_pp (ACM-GCN++ with the
    structure channel, Table 16's row) trained ``PP_EPOCHS`` captured
    epochs, with the launch counts ``pp_counts`` implies and a profile."""
    from acmgnn_tpu_torch.ops.graph import GraphData

    data = GraphData("penn94_pp-scale", p_adj, p_feats, p_labels)
    return drive_path("[9b penn94_pp]", data, penn94_pp_config(),
                      _masks(p_adj.shape[0]), PP_EPOCHS, pp_counts)


def phase_symmetric_paths(adj, feats, labels):
    """[9b sym] The headline configuration with symmetric normalization:
    the valued ELL operator with bf16 and with f32 values, and the COO
    operator, ``SYM_EPOCHS`` captured epochs each, launch counts as
    ``joint_counts`` implies on the valued counters."""
    from acmgnn_tpu_torch.ops.graph import GraphData

    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    masks = _masks(adj.shape[0])
    out = {}
    for fmt, dtype in (("ell", "bfloat16"), ("ell", "float32"),
                       ("coo", "float32")):
        cfg = headline_config(normalization="sym", operator_format=fmt,
                              spmm_dtype=dtype)
        gather = "k5_coo" if fmt == "coo" else "k1_spmm"
        rename = valued if fmt == "ell" else (lambda c: c)
        out[(fmt, dtype)] = drive_path(
            f"[9b sym {fmt} {dtype}]", data, cfg, masks, SYM_EPOCHS,
            lambda it, g=gather, r=rename: r(joint_counts(it, g, 7)),
            profile=False)
    return out


def _chameleon_graph():
    """A chameleon-shaped graph with labels taken from the features (a
    configuration that does not amplify rounding, as phase 6c's)."""
    from acmgnn_tpu_torch.data.synthetic_scale import (
        build_sym_adjacency,
        chung_lu_edges,
    )
    from acmgnn_tpu_torch.ops.graph import GraphData

    spec = CHAMELEON
    src, dst = chung_lu_edges(spec["n"], spec["e"], spec["max_deg"], seed=3)
    adj = build_sym_adjacency(src, dst, spec["n"], drop_self_loops=True)
    rng = np.random.default_rng(3)
    feats = (rng.random((spec["n"], spec["f"])) < 0.02).astype(np.float32)
    proj = rng.normal(size=(spec["f"], spec["c"]))
    labels = np.argmax(feats @ proj, axis=1).astype(np.int32)
    return GraphData("chameleon-shaped", adj, feats, labels)


def ulp_nudged(data, draw=0):
    """``data`` with each non-zero feature moved one ulp up or down (the
    direction drawn from ``draw``): inputs one rounding apart."""
    rng = np.random.default_rng(draw)
    feats = np.array(data.features, dtype=np.float32)
    nz = feats != 0
    to = np.where(rng.random(int(nz.sum())) < 0.5, -np.inf, np.inf)
    feats[nz] = np.nextafter(feats[nz], to.astype(np.float32))
    return dataclasses.replace(data, features=feats)


def cpu_witness(data, cfg, masks_np, seed=3, draws=WITNESS_DRAWS,
                threads=False):
    """How far the CPU port parts from itself over ``cfg``, with no card
    involved: the largest |Δparam| between its run on ``data`` and its runs
    on ``ulp_nudged(data, draw)`` for each draw (and, with ``threads``,
    its run on one thread against torch's default), all from
    ``build_model(seed)``; the parts, by name."""
    import torch

    ref = trained(data, cfg, masks_np, "cpu", seed)[1]
    out = {f"features one ulp apart (draw {k})": max_param_diff(ref, trained(
        ulp_nudged(data, k), cfg, masks_np, "cpu", seed)[1])
        for k in range(draws)}
    if threads:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = trained(data, cfg, masks_np, "cpu", seed)[1]
        finally:
            torch.set_num_threads(n)
        out[f"1 thread against {n}"] = max_param_diff(ref, one)
    return out


def stepwise_card_vs_cpu(tag, data, cfg, masks_np, tol=1e-4, seed=3):
    """``cfg.epochs`` optimizer steps of the train loss (the whole train
    mask; the joint loop's paired forward where ``cfg`` runs it) on the
    card, each taken again on the CPU from the card's state before it
    (parameters and the optimizer's moments copied over), both in the
    card's optimizer arithmetic: every step's parameters within ``tol``.
    Each step starts both sides from one state, so a trajectory that turns
    rounding into Adam steps (``_read_ill_conditioned``) cannot part
    them."""
    import torch

    from acmgnn_tpu_torch.train.metrics import masked_nll
    from acmgnn_tpu_torch.train.trainer import (
        JOINT_CAPABLE,
        build_model,
        make_optimizer,
        prepare_data,
    )

    paired = bool(cfg.joint) and cfg.model_type in JOINT_CAPABLE
    sides = []
    for device in ("cuda", "cpu"):
        _, ops, x, y, _, nclass = prepare_data(data, cfg, device=device)
        model = build_model(cfg, x.shape[1], nclass, device=device,
                            seed=seed, nnodes=x.shape[0])
        sides.append((model, make_optimizer(cfg, model.parameters(),
                                            capturable=True), ops, x, y,
                       torch.from_numpy(masks_np[0]).to(device)))

    def step(model, opt, ops, x, y, mask):
        opt.zero_grad(set_to_none=True)
        out = model(x, ops, training=True, paired_eval=paired)
        logits = out[0] if paired else out
        masked_nll(torch.log_softmax(logits, dim=1), y, mask).backward()
        opt.step()

    card, cpu = sides
    worst = []
    for _ in range(cfg.epochs):
        cpu[0].load_state_dict({k: v.cpu() for k, v in
                                card[0].state_dict().items()})
        cpu[1].load_state_dict(card[1].state_dict())   # copied to the host
        step(*card)
        step(*cpu)
        worst.append(max_param_diff(
            {k: p.detach().cpu() for k, p in card[0].named_parameters()},
            {k: p.detach() for k, p in cpu[0].named_parameters()}))
    print(f"{tag} card vs CPU step by step, each from the card's state, "
          f"{cfg.epochs} steps (lr {cfg.lr:g}, decay {cfg.weight_decay:g}): "
          f"max |Δparam| per step {' '.join(f'{w:.1e}' for w in worst)} "
          f"(tolerance {tol:g})")
    if max(worst) > tol:
        fail(f"{tag} a step on the card and on the CPU disagree")


def _capture_and_cpu(tag, data, cfg, masks_np, cpu_cfg=None):
    """``cfg`` eager then captured on the card, bit for bit (8a's check:
    parameters and BatchNorm statistics, histories, best metrics, launch
    counts equal); then, given ``cpu_cfg``, card against the CPU's plain
    versions in the card's optimizer arithmetic (1e-4).  Returns the
    captured run's launch counts."""
    import torch

    from acmgnn_tpu_torch.models import layers
    from acmgnn_tpu_torch.train.trainer import prepare_data

    prepared = prepare_data(data, cfg)
    masks = tuple(torch.from_numpy(m).cuda() for m in masks_np)
    eager = _split(prepared, cfg, masks, False)
    resident = set(layers._resident)
    captured = _split(prepared, cfg, masks, True)
    if set(layers._resident) != resident:
        fail(f"{tag} the capture asked the occupancy of "
             f"{set(layers._resident) - resident}")
    n = _bit_equal(tag, eager, captured)
    if eager["counts"] != captured["counts"]:
        fail(f"{tag} launch counts eager {eager['counts']}, captured "
             f"{captured['counts']}")
    print(f"{tag} eager and captured, {cfg.epochs} epochs: bit-equal ({n} "
          f"tensors), epochs_run {captured['res'].epochs_run}; capture "
          f"{captured['state'].capture_ms:.1f} ms; launches "
          f"{json.dumps(captured['counts'], sort_keys=True)}")
    if cpu_cfg is not None:
        card_vs_cpu(tag, data, cpu_cfg, masks_np)
    return captured["counts"]


def phase_dense_paths():
    """[9c] The dense operator (``fmt="auto"`` at or below 4096 nodes) on
    a chameleon-shaped graph: ACM-GCN+ with the structure channel and
    variant 1 (joint), and acmsgc over Â² (sequential), ``DENSE_EPOCHS``
    captured epochs each at full width, timed; each also eager against
    captured bit for bit over as many epochs, and card against CPU with
    dropout 0: every one of as many steps from the card's state, and the
    whole trajectory where the CPU port's own runs with the features one
    ulp apart stay within ``WITNESS_SHARE`` of the tolerance (else it is
    printed beside them, not held)."""
    data = _chameleon_graph()
    n = data.num_nodes
    masks = _masks(n, seed=2)
    print(f"[9c] chameleon-shaped graph N={n} nnz={data.adj.nnz} "
          f"F={data.features.shape[1]} C={data.num_classes}")
    base = dict(hidden=64, dropout=0.5, lr=0.01, weight_decay=5e-4,
                epochs=DENSE_EPOCHS, early_stopping=0,
                selection="val_metric", operator_format="auto")
    # the card against the CPU, dropout 0, lr 1e-3, decay 5e-4: each of
    # DENSE_EPOCHS steps from the card's state (``stepwise_card_vs_cpu``);
    # the whole run's trajectory where the CPU port agrees with itself
    # (acmsgc). On the structure channel's case the CPU port alone parts by
    # 7e-5 to 3.9e-3 over 20 epochs on seven seeds of eight (ROADMAP §C,
    # acmgnn_tpu_torch/tools/cpu_witness.py): that trajectory is read
    trajectory_held = {"acmgcnp structure variant 1": False,
                       "acmsgc hops 2": True}
    c = data.num_classes

    def structure_v1(b):    # joint: K2 per branch and layer, K3 per layer
        return {"k2_attn_fwd_t4_relu_ms_d64": 2 * b,
                f"k2_attn_fwd_t4_relu_ms_d{c}": 2 * b,
                "k3_attn_bwd_t4_relu_ms_d64": b,
                f"k3_attn_bwd_t4_relu_ms_d{c}": b}

    def acmsgc(b):          # sequential, one layer: train and eval forward
        return {f"k2_attn_fwd_relu_none_d{c}": 2 * b,
                f"k3_attn_bwd_relu_none_d{c}": b}

    out = {}
    for tag, over, expected in (
            ("acmgcnp structure variant 1", dict(
                model_type="acmgcnp", structure_info=True, variant=True,
                joint=True), structure_v1),
            ("acmsgc hops 2", dict(model_type="acmsgc", hops=2,
                                   joint=False), acmsgc)):
        from acmgnn_tpu_torch.train.config import TrainConfig

        cfg = TrainConfig(**dict(base, **over))
        counts, ms_run, res, _, ms_replay = drive_path(
            f"[9c {tag}]", data, dataclasses.replace(cfg, epochs=WARM_EPOCHS),
            masks, DENSE_EPOCHS, expected, profile=tag.startswith("acmgcnp"))
        cpu = dataclasses.replace(cfg, dropout=0.0, lr=1e-3)
        stepwise_card_vs_cpu(f"[9c {tag}]", data, cpu, masks)
        if not trajectory_held[tag]:
            _capture_and_cpu(f"[9c {tag}]", data, cfg, masks)
            _read_ill_conditioned(f"[9c {tag}]", data, cpu, masks)
        else:
            witness = max(cpu_witness(data, cpu, masks).values())
            print(f"[9c {tag}] the CPU port against itself with its "
                  f"features one ulp apart ({WITNESS_DRAWS} draws), "
                  f"{cpu.epochs} epochs: max |Δparam| {witness:.3e} (at "
                  f"most {WITNESS_SHARE:g} of the tolerance)")
            if not witness <= WITNESS_SHARE * 1e-4:
                fail(f"[9c {tag}] the card-against-CPU configuration "
                     f"amplifies rounding")
            _capture_and_cpu(f"[9c {tag}]", data, cfg, masks, cpu)
        out[tag] = (counts, ms_run, ms_replay)
    return out


def _read_ill_conditioned(tag, data, cfg, masks_np):
    """Print, without holding it, the card against the CPU in ``cfg``
    beside the CPU port against itself (features one ulp apart, one
    thread against torch's default) in the same configuration."""
    card = trained(data, cfg, masks_np, "cuda")[1]
    cpu = trained(data, cfg, masks_np, "cpu")[1]
    witness = cpu_witness(data, cfg, masks_np, threads=True)
    print(f"{tag} read, not held: lr {cfg.lr:g}, decay {cfg.weight_decay:g}, "
          f"{cfg.epochs} epochs, max |Δparam| card against CPU "
          f"{max_param_diff(card, cpu):.3e}; the CPU against itself, "
          + ", ".join(f"{k} {v:.3e}" for k, v in witness.items()))


ZOO_CASES = {
    "acmgcn": {}, "acmgcnp": {}, "acmgcnpp": {}, "acmsgc": {},
    "acmsnowball": dict(nlayers=2), "acmgraphsage": {}, "gcn": {},
    "sgc": dict(hops=2, hoist_first=False), "mlp": {}, "graphsage": {},
    "snowball": dict(nlayers=2), "gcnII": dict(nlayers=2),
    "acmgcnpp batchnorm": dict(model_type="acmgcnpp", init_layers_X=2),
    "acmgcn variant 1": dict(model_type="acmgcn", variant=True),
    "acmgcnp structure variant 1": dict(model_type="acmgcnp",
                                        structure_info=True, variant=True),
    "acmgcn sym": dict(model_type="acmgcn", normalization="sym"),
}


def phase_zoo():
    """[9d] Every model type (and the BatchNorm, variant 1 and symmetric
    cases) on a small twitch-shaped graph with the ELL operator:
    ``ZOO_EPOCHS`` epochs eager against captured bit for bit (dropout
    0.5; joint where the model is joint-capable), then card against CPU
    (1e-4) in ``ZOO_CPU_EPOCHS``'s configuration.  Returns each case's
    launch counts."""
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.config import TrainConfig

    adj, feats, _ = twitch_gamers_scale_graph(0, n=ZOO_N, pairs=20 * ZOO_N)
    feats = np.abs(feats)
    labels = (feats[:, 0] > np.median(feats[:, 0])).astype(np.int32)
    data = GraphData("small", adj, feats, labels)
    masks = _masks(ZOO_N)
    out = {}
    for tag, over in ZOO_CASES.items():
        over = dict(over)
        model_type = over.pop("model_type", tag)
        cfg = TrainConfig(**dict(dict(
            model_type=model_type, hidden=64, dropout=0.5, lr=0.01,
            weight_decay=1e-3, epochs=ZOO_EPOCHS, early_stopping=0,
            selection="val_metric", operator_format="ell",
            spmm_dtype="float32", joint=True, hoist_first=True), **over))
        out[tag] = _capture_and_cpu(
            f"[9d {tag}]", data, cfg, masks,
            dataclasses.replace(cfg, dropout=0.0, lr=1e-3, weight_decay=5e-4,
                                epochs=ZOO_CPU_EPOCHS))
    return out


# ---------------------------------------------------------------------------
# Phase 10: the CLI slice (the user's entry point, from files)
# ---------------------------------------------------------------------------

CLI_EPOCHS, CLI_SPLITS = 20, 2          # 10a: genius through the CLI
CLI_SMALL_EPOCHS = 20                   # 10b: the chameleon-shaped files
TRACE_KERNELS = {"K1": "spmm_rows_kernel", "K2": "attn_fwd_kernel",
                 "K3": "attn_bwd_kernel", "K4": "rocauc_pass_kernel"}


class _Recording:
    """Wrap ``owner.name`` (a module function or a class method) for the
    ``with`` block; ``seen`` receives every call's return value (or
    ``record(*args)`` of each call's arguments)."""

    def __init__(self, owner, name, record=None):
        self.owner, self.name, self.record = owner, name, record
        self.fn, self.seen = getattr(owner, name), []

    def __enter__(self):
        fn, seen, record = self.fn, self.seen, self.record

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out if record is None else record(*args))
            return out

        setattr(self.owner, self.name, wrapped)
        return self.seen

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def _cli(argv):
    """``acmgnn_tpu_torch.cli.main(argv)`` in this process, its standard
    output captured: (the last line's JSON or None, the output)."""
    import contextlib
    import io

    from acmgnn_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    try:
        return json.loads(out.strip().splitlines()[-1]), out
    except (json.JSONDecodeError, IndexError):
        return None, out


def _cli_config(argv):
    """The ``TrainConfig`` that ``cli train argv`` runs with."""
    from acmgnn_tpu_torch import cli

    got, cmd = [], cli.cmd_train
    cli.cmd_train = got.append
    try:
        cli.main(["train"] + argv)
    finally:
        cli.cmd_train = cmd
    return cli.config_from_args(got[0])


def _split_log(idx, res):
    return idx, float(res.test_metric), float(res.val_metric)


def _write_genius_files(root, n, src, dst, feats, labels):
    """genius's on-disk layout: ``large_scale_data/genius.mat`` and the
    LINKX split file (2 splits of 50/25/25, ``rand_train_test_idx``)."""
    import scipy.io

    from acmgnn_tpu_torch.data.splits import rand_train_test_idx

    (root / "large_scale_data").mkdir(parents=True)
    scipy.io.savemat(root / "large_scale_data" / "genius.mat", {
        "edge_index": np.vstack([src, dst]), "node_feat": feats,
        "label": labels})
    splits = [dict(zip(("train", "valid", "test"), rand_train_test_idx(
        labels, rng=np.random.default_rng(i)))) for i in range(CLI_SPLITS)]
    (root / "ACM-Geometric" / "splits").mkdir(parents=True)
    np.save(root / "ACM-Geometric" / "splits" / "genius-splits.npy",
            np.array(splits, dtype=object), allow_pickle=True)
    return splits


def phase_cli_genius(root, ms_5b):
    """[10a] genius from files at full width through ``cli train``."""
    import torch

    from acmgnn_tpu_torch.data.registry import load_dataset
    from acmgnn_tpu_torch.data.synthetic_scale import (
        LINKX_SCALE,
        chung_lu_edges,
    )
    from acmgnn_tpu_torch.ops import kernels, native
    from acmgnn_tpu_torch.train import trainer
    from acmgnn_tpu_torch.utils.logging import ExperimentLogger

    spec = LINKX_SCALE["genius"]
    n = spec["n"]
    t0 = time.perf_counter()
    src, dst = chung_lu_edges(n, spec["e"], spec["max_deg"], seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, spec["f"])).astype(np.float32)
    labels = rng.integers(0, spec["c"], size=n).astype(np.int32)
    splits = _write_genius_files(root, n, src, dst, feats, labels)
    print(f"[10a] wrote genius.mat (N={n}, {src.shape[0]} directed edges, "
          f"F={spec['f']}) and genius-splits.npy under the data root "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    data = load_dataset("genius")
    t_load = time.perf_counter() - t0
    want = native.build_sym_adjacency_scipy(src, dst, n)
    for part in ("indptr", "indices", "data"):
        if not np.array_equal(getattr(data.adj, part), getattr(want, part)):
            fail(f"[10a] genius.mat's CSR {part} differs from the edge "
                 f"list symmetrized in memory (self-loops kept)")
    if not (np.array_equal(data.features, feats)
            and np.array_equal(data.labels, labels)
            and len(data.splits) == CLI_SPLITS
            and all(np.array_equal(a[k], b[k]) for a, b in zip(
                data.splits, splits) for k in ("train", "valid", "test"))):
        fail("[10a] genius.mat's features, labels or splits differ")
    if not data.adj.diagonal().any():
        fail("[10a] genius.mat's graph has no self-loop to keep")
    print(f"[10a] load_dataset('genius'): {t_load:.2f} s on the host "
          f"(compiled graph prep: {native.native_available()}); CSR "
          f"nnz={data.adj.nnz} (self-loops kept), features, labels and "
          f"{CLI_SPLITS} splits equal to the arrays written")

    argv = ["--dataset", "genius", "--fixed_splits", "1", "--num_splits",
            str(CLI_SPLITS), "--model", "acmgcn", "--hidden", "64",
            "--dropout", "0.5", "--lr", "0.01", "--weight_decay", "1e-3",
            "--epochs", str(CLI_EPOCHS), "--early_stopping", "0",
            "--operator_format", "ell", "--spmm_dtype", "bfloat16",
            "--joint", "1", "--hoist_first", "1",
            "--log_dir", str(root / "logs")]
    cfg = _cli_config(argv)
    want_cfg = genius_config(epochs=CLI_EPOCHS, num_splits=CLI_SPLITS,
                             fixed_splits=True)
    if cfg != want_cfg:
        fail(f"[10a] the CLI's config {dataclasses.asdict(cfg)} != "
             f"genius_config() {dataclasses.asdict(want_cfg)}")
    prof = root / "profile"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _Recording(trainer, "run_experiment") as outs, \
            _Recording(ExperimentLogger, "log_split",
                       record=lambda self, i, r: _split_log(i, r)) as logs:
        line, _ = _cli(["train"] + argv + ["--profile_dir", str(prof)])
    t_cli = time.perf_counter() - t0
    counts = dict(kernels.launches)
    # the loader keeps genius's self-loops, so Â = D^-1 (A + I) has rows
    # that are not uniform: its ELL halves carry values (K1's valued form)
    bodies = CLI_SPLITS * (CLI_EPOCHS + 1)
    want = valued(joint_counts(bodies, "k1_spmm", 12, k4=True))
    counts = without_loop_kernels(counts)
    print(f"[10a] cli train: {t_cli:.1f} s (prepare, {CLI_SPLITS} splits, "
          f"profiler trace written); launches "
          f"{json.dumps(counts, sort_keys=True)}")
    if counts != want:
        fail(f"[10a] cli train launch counts {counts} != expected {want}")
    trace = (prof / "trace.json").read_text()
    missing = [k for k, v in TRACE_KERNELS.items() if v not in trace]
    if missing:
        fail(f"[10a] the --profile_dir trace names no {missing} kernel")
    print(f"[10a] --profile_dir trace.json ({len(trace) / 2**20:.1f} MiB) "
          f"names " + ", ".join(f"{k} ({v})" for k, v in
                                TRACE_KERNELS.items()))

    timings = []

    def timed(make):   # the run's runner, each call timed
        def made(*a, **k):
            runner = make(*a, **k)

            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res, state = runner(*args, return_state=True, **kwargs)
                torch.cuda.synchronize()
                timings.append((1e3 * (time.perf_counter() - t), state))
                return res
            return run
        return made

    with _Recording(ExperimentLogger, "log_split",
                    record=lambda self, i, r: _split_log(i, r)) as ref_logs, \
            _wrapped(trainer, "make_split_runner", timed):
        ref = trainer.run_experiment(
            data, cfg, logger=ExperimentLogger("ref", log_dir=str(root / "logs"),
                                               to_file=False))
    cli_out = outs[0]
    if (cli_out["per_split"] != ref["per_split"] or logs != ref_logs
            or line["test_mean"] != ref["test_mean"]
            or line["test_std"] != ref["test_std"]
            or line["epochs_total"] != ref["epochs_total"]):
        fail(f"[10a] cli train {cli_out['per_split']} {logs} {line} != "
             f"run_experiment {ref['per_split']} {ref_logs} {ref}")
    valid_mean = float(np.mean([v for _, _, v in logs]))
    print(f"[10a] cli train = run_experiment on the loaded graph, bit for "
          f"bit: per-split test ROC-AUC {cli_out['per_split']}, val "
          f"{[v for _, _, v in logs]} (valid_mean {valid_mean!r}), "
          f"test_mean {line['test_mean']!r}, {line['epochs_total']} epochs")
    captured = [st.capture_ms for _, st in timings]
    if captured[0] is None or any(c is not None for c in captured[1:]):
        fail(f"[10a] capture ms by split {captured}: split 0 must capture "
             f"and every later split replay its graph")
    whole = [ms / st.epoch for ms, st in timings]
    replays = [(ms - st.setup_ms) / st.replays for ms, st in timings]
    print(f"[10a] run_experiment ms/epoch by split, whole run "
          f"{', '.join(f'{v:.3f}' for v in whole)}; over the replays "
          f"{', '.join(f'{v:.3f}' for v in replays)} (set-up "
          f"{', '.join(f'{st.setup_ms:.1f}' for _, st in timings)} ms; "
          f"capture ms {[_ms(c) for c in captured]}: split 1 replays split "
          f"0's graph); the CLI's own (profiled) epoch_ms_avg "
          f"{line['epoch_ms_avg']:.3f}, epoch_ms_steady "
          f"{line['epoch_ms_steady']:.3f} ({CARD_LINE})")
    ratio1 = whole[-1] / replays[-1]
    print(f"[10a] prediction (PERF.md, PR 14): split 1's whole run within "
          f"10% of its replays: {ratio1:.3f}x, "
          f"{'held' if ratio1 <= 1.1 else 'missed'}")
    ratio = replays[-1] / ms_5b
    print(f"[10a] prediction: replays within +-10% of 5b's genius joint "
          f"ELL replays ({ms_5b:.3f}): {replays[-1]:.3f} = {ratio:.3f}x, "
          f"{'held' if abs(ratio - 1) <= 0.1 else 'missed'}; host load "
          f"<= 5 s: {t_load:.2f} s, "
          f"{'held' if t_load <= 5 else 'missed'}")
    return dict(load_s=t_load, whole=whole, replays=replays, counts=counts)


def _write_geomgcn_files(root, data, name, n_splits=2):
    """Geom-GCN's layout of ``data``: ``new_data/<name>/out1_*`` (binary
    features as text, the edge list) and the fixed split files
    ``ACM-Pytorch/splits/<name>_split_0.6_0.2_<i>.npz`` (48/32/20)."""
    d = root / "new_data" / name
    d.mkdir(parents=True)
    coo = data.adj.tocoo()
    with open(d / "out1_graph_edges.txt", "w") as fh:
        fh.write("node_id\tnode_id\n")
        fh.writelines(f"{u}\t{v}\n" for u, v in zip(coo.row, coo.col))
    feats = data.features.astype(np.int64)
    with open(d / "out1_node_feature_label.txt", "w") as fh:
        fh.write("node_id\tfeature\tlabel\n")
        fh.writelines(f"{i}\t{','.join(map(str, feats[i]))}\t"
                      f"{data.labels[i]}\n" for i in range(data.num_nodes))
    s = root / "ACM-Pytorch" / "splits"
    s.mkdir(parents=True, exist_ok=True)
    n = data.num_nodes
    for i in range(n_splits):
        perm = np.random.default_rng(i).permutation(n)
        cut = (int(0.48 * n), int(0.8 * n))
        np.savez(s / f"{name}_split_0.6_0.2_{i}.npz",
                 **{k: np.isin(np.arange(n), perm[a:b]) for k, (a, b) in
                    zip(("train_mask", "val_mask", "test_mask"),
                        ((0, cut[0]), cut, (cut[1], n)))})


def _write_planetoid_files(root, name, n=2708, f=1433, c=7, seed=0):
    """Planetoid's ``data/ind.<name>.*`` pickles of a random graph of the
    given shape (cora's: 2,708 nodes, 1,433 binary features, 7 classes;
    140 labelled rows, 1,000 test rows)."""
    import pickle

    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n_test = 1000
    n_allx = n - n_test
    onehot = np.eye(c)[rng.integers(0, c, n)]
    x_all = sp.csr_matrix((rng.random((n, f)) < 0.013).astype(np.float32))
    parts = {"x": x_all[:140], "y": onehot[:140], "allx": x_all[:n_allx],
             "ally": onehot[:n_allx], "tx": x_all[n_allx:],
             "ty": onehot[n_allx:],
             "graph": {i: [int(v) for v in rng.integers(0, n, 2)]
                       for i in range(n)}}
    (root / "data").mkdir(exist_ok=True)
    for part, obj in parts.items():
        with open(root / "data" / f"ind.{name}.{part}", "wb") as fh:
            pickle.dump(obj, fh)
    (root / "data" / f"ind.{name}.test.index").write_text("\n".join(
        str(i) for i in rng.permutation(np.arange(n_allx, n))) + "\n")


def _snapshots_equal(a, b, what):
    """Two ``save_checkpoint`` files hold equal payloads, bit for bit."""
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    sa = restore_checkpoint(a)
    if not _tree_equal(sa, restore_checkpoint(b)):
        fail(f"[10b] {what}: the snapshots differ")
    return sa


def _tree_equal(a, b) -> bool:
    """Nested dicts, lists and tensors equal, tensors bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    return a == b


def phase_cli_small(root):
    """[10b] A small dataset end to end through every subcommand."""
    import torch

    from acmgnn_tpu_torch.data import homophily as H
    from acmgnn_tpu_torch.data.registry import load_dataset
    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    name = "chameleon"
    graph = _chameleon_graph()
    _write_geomgcn_files(root, graph, name)
    data = load_dataset(name)
    if ((data.adj != graph.adj).nnz or not np.array_equal(
            data.features, graph.features)
            or not np.array_equal(data.labels, graph.labels)):
        fail("[10b] the Geom-GCN files do not load back as written")
    print(f"[10b] {name}: Geom-GCN files of the chameleon-shaped graph "
          f"(N={data.num_nodes}, F={data.features.shape[1]}, "
          f"C={data.num_classes}) load back equal")
    logs = ["--log_dir", str(root / "logs")]
    base = ["--dataset", name, "--fixed_splits", "1", "--num_splits", "2"]
    ckpt = ["--operator_format", "ell", "--stepwise", "--checkpoint_every",
            "5"]
    whole, cut = root / "whole", root / "cut"
    with _captured_runs("[10b] stepwise", captures=3) as calls:
        t0 = time.perf_counter()
        out, _ = _cli(["train"] + base + ckpt + logs + [
            "--checkpoint_dir", str(whole), "--epochs",
            str(CLI_SMALL_EPOCHS)])
        t_whole = time.perf_counter() - t0
        _cli(["train"] + base + ckpt + logs + [
            "--checkpoint_dir", str(cut), "--epochs",
            str(CLI_SMALL_EPOCHS // 2)])
        resumed, _ = _cli(["train"] + base + ckpt + logs + [
            "--checkpoint_dir", str(cut), "--epochs", str(CLI_SMALL_EPOCHS),
            "--resume"])
    for idx in range(2):
        snap = _snapshots_equal(whole / f"split{idx}_last",
                                cut / f"split{idx}_last",
                                f"split {idx} resumed at epoch "
                                f"{CLI_SMALL_EPOCHS // 2}")
        _snapshots_equal(whole / f"split{idx}_best", cut / f"split{idx}_best",
                         f"split {idx}'s best weights")
        if snap["step"] != CLI_SMALL_EPOCHS or not np.array_equal(
                np.load(whole / f"split{idx}_history.npy"),
                np.load(cut / f"split{idx}_history.npy")):
            fail(f"[10b] split {idx}: the resumed history differs")
    keys = ("test_mean", "test_std", "valid_mean", "valid_std",
            "epochs_total")
    if any(out[k] != resumed[k] for k in keys):
        fail(f"[10b] resumed result {resumed} != uninterrupted {out}")
    print(f"[10b] stepwise ELL, {CLI_SMALL_EPOCHS} epochs x 2 splits, "
          f"captured (one graph a run; {sum(c[1] for c in calls)} replays "
          f"in the three runs) ({t_whole:.1f} s, epoch_ms_steady "
          f"{out['epoch_ms_steady']:.3f}): cut at "
          f"{CLI_SMALL_EPOCHS // 2} and resumed = uninterrupted, bit for "
          f"bit (weights, Adam's moments and step, history, best weights; "
          f"test_mean {out['test_mean']!r})")

    pred = root / "pred.npz"
    summary, _ = _cli(["predict"] + base + logs + [
        "--checkpoint", str(whole / "split0_best"), "--output", str(pred)])
    cfg = _cli_config(base)
    _, ops, x, _, _, nclass = trainer.prepare_data(name, cfg)
    model = trainer.build_model(cfg, x.shape[1], nclass, nnodes=x.shape[0])
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    model.load_state_dict(restore_checkpoint(whole / "split0_best")[
        "variables"])
    with torch.no_grad():
        want = model(x, ops, training=False).cpu()
    if not torch.equal(torch.from_numpy(np.load(pred)["logits"]), want):
        fail("[10b] predict's logits differ from an eval forward of the "
             "checkpoint's weights")
    print(f"[10b] predict: logits = an eval forward of split0_best, bit for "
          f"bit ({summary['nodes']} nodes, label agreement "
          f"{summary['label_agreement']})")

    kernels.reset_launches()
    coo, _ = _cli(["train"] + base + logs + [
        "--operator_format", "coo", "--epochs", "5", "--num_splits", "1"])
    k5 = {k: v for k, v in kernels.launches.items() if k.startswith("k5")}
    if not k5 or not math.isfinite(coo["test_mean"]):
        fail(f"[10b] train --operator_format coo: K5 {k5}, {coo}")
    print(f"[10b] train --operator_format coo, 5 epochs: K5 launches {k5}, "
          f"test_mean {coo['test_mean']:.4f}")

    hom, _ = _cli(["homophily", "--dataset", name])
    want_h = {"edge_homophily": H.edge_homophily(data.adj, data.labels),
              "node_homophily": H.node_homophily(data.adj, data.labels),
              "class_homophily": H.class_homophily(data.adj, data.labels),
              "aggregation_homophily": H.aggregation_homophily(
                  data.features, data.adj, data.labels)}
    if any(hom[k] != v for k, v in want_h.items()):
        fail(f"[10b] homophily {hom} != {want_h}")
    print(f"[10b] homophily = the metrics on the loaded arrays: {hom}")

    grid = {"lr": [0.01, 0.05], "weight_decay": [0.0, 5e-4],
            "dropout": [0.0, 0.5]}
    with _Recording(trainer, "run_experiment") as points, \
            _captured_runs("[10b] sweep", captures=2) as calls:
        best, _ = _cli(["sweep"] + base + logs + [
            "--epochs", "10", "--grid", json.dumps(grid)])
    if len(points) != 8:
        fail(f"[10b] sweep ran {len(points)} grid points, not 8")

    def eager(model, *args, **kwargs):
        return trainer.make_split_runner(model, cfg_p, graph=False)(
            *args, **kwargs)

    # the last (lr, wd) point of each dropout value: its runner's
    # hyperparameters rewritten three times since its capture
    for p in (points[3], points[7]):
        cfg_p = trainer.TrainConfig(**p["config"])
        ref = trainer.run_experiment(name, cfg_p, runner=eager)
        if (ref["per_split"] != p["per_split"]
                or ref["epochs_total"] != p["epochs_total"]):
            fail(f"[10b] sweep point {p['config']['lr']}, "
                 f"{p['config']['weight_decay']}, "
                 f"{p['config']['dropout']}: {p['per_split']} != its eager "
                 f"form (graph=False) {ref['per_split']}")
    if best["test_mean"] != max(p["test_mean"] for p in points):
        fail(f"[10b] sweep best {best['test_mean']} is not the highest")
    print(f"[10b] sweep 2 x 2 x 2 (lr x wd x dropout), {len(calls)} runner "
          f"calls, 2 captures (one a dropout value; (lr, wd) written into "
          f"the optimizer's tensors): the last (lr, wd) point of each "
          f"dropout value = its eager form (graph=False) bit for bit; best "
          f"test_mean "
          f"{best['test_mean']:.4f} at lr {best['config']['lr']}, wd "
          f"{best['config']['weight_decay']}, dropout "
          f"{best['config']['dropout']}")

    _write_planetoid_files(root, "cora")
    syn = root / "synthetic"
    _cli(["gen-graphs", "--base_dir", str(syn), "--edge_homos", "0.5",
          "--num_graph", "1"])
    _cli(["gen-feats", "--base_dataset", "cora", "--out_dir",
          str(syn / "features"), "--num_realizations", "1"])
    with np.load(syn / "features" / "features_0.npz") as f:
        feats = f["features"]
    if feats.shape != (2000, 1433) or not np.isfinite(feats).all():
        fail(f"[10b] gen-feats wrote {feats.shape}")
    st, _ = _cli(["synthetic-train", "--base_dir", str(syn), "--edge_homo",
                  "0.5", "--num_graph", "1", "--features_dir",
                  str(syn / "features"), "--epochs", "20", "--num_splits",
                  "1"] + logs)
    if not math.isfinite(st["test_mean"]):
        fail(f"[10b] synthetic-train: {st}")
    print(f"[10b] gen-graphs, gen-feats (from cora-shaped Planetoid files) "
          f"and synthetic-train (1 graph at edge homophily 0.5): "
          f"test_mean {st['test_mean']:.4f}; phase 10b "
          f"{time.perf_counter() - t_phase:.1f} s")


def phase_cli(ms_5b):
    """[10] The CLI slice: datasets written in their loaders' layouts
    under a temporary data root (``ACMGNN_DATA_PATH``), then the
    subcommands run in this process on the card."""
    import os
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    old = os.environ.get("ACMGNN_DATA_PATH")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ACMGNN_DATA_PATH"] = tmp
        try:
            out = phase_cli_genius(Path(tmp), ms_5b)
            phase_cli_small(Path(tmp))
        finally:
            if old is None:
                os.environ.pop("ACMGNN_DATA_PATH", None)
            else:
                os.environ["ACMGNN_DATA_PATH"] = old
    out["seconds"] = time.perf_counter() - t0
    print(f"[10] the CLI slice: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the sharded path as the JAX package runs it — wiki at full
# width through per-rank slab loading, ROC-AUC across ranks, the zoo on
# sharded operators, cut and resume
# ---------------------------------------------------------------------------

CARD = "cuda"                    # the device phase 11 makes its tensors on
# bench.py:965-982's wiki scenario (``bench_wiki_sharded``)
WIKI = dict(n=1_925_342, e=6_500_000, f=600, c=5, max_deg=30_000)
WIKI_EPOCHS = 4                  # per split, 2 splits
# phase 11c's cases: config over ``sharded_check_config``'s
ZOO11_CASES = {
    "acmgcnpp+structure": dict(model_type="acmgcnpp", structure_info=True),
    "acmgcnp variant 1": dict(variant=True),
    "sym ell bf16": dict(normalization="sym", spmm_dtype="bfloat16"),
    "sym ell f32": dict(normalization="sym"),
    "sym coo": dict(normalization="sym", operator_format="coo"),
    "gcnII": dict(model_type="gcnII"),
    "graphsage": dict(model_type="graphsage"),
    "bce rocauc": dict(loss="bce", metric="rocauc"),
    # 11e at 4 ranks: BatchNorm's statistics summed over the ranks
    "acmgcnpp init_layers_X 2": dict(model_type="acmgcnpp", init_layers_X=2),
}
# cases held by the per-step gradient bound alone, their whole run printed:
# lin_0's bias (Linear -> ReLU -> BatchNorm) has, for a unit that every row
# passes, a gradient of zero in exact arithmetic, which Adam turns into
# steps of up to ~3·lr driven by rounding, so no two summation orders
# (the single card's ELL and COO included) keep its trajectory
# (tests/test_torch_sharded.py BN_CFG).  Their step bound's witness is
# the larger of the ELL-COO distance and the single card's on its rows
# reversed: ELL and COO leave BatchNorm's sums (over the raw features)
# in one order, and the fast variance E[x²] − E[x]² of a unit whose
# values sit near their mean carries the order's rounding into every
# later gradient (a CPU rehearsal at N=20,000, 4 ranks: 3.0x the ELL-COO
# bound on lin_0's bias; 0.30x with the reversed rows)
STEP_BOUND_ONLY = ("acmgcnpp init_layers_X 2",)
# 11c holds every case step by step (each step's gradient from the single
# card's state, per tensor within GRAD_REL of its norm plus GRAD_ORDERS
# times the single card's own ELL-COO distance), and its whole 20-epoch
# run within 1e-4 of the single card where the single card's own ELL and
# COO orders part by less than WELL_CONDITIONED: where they part by more
# (the structure channel: ~1e-2, Adam's steps of ±lr on gradients at
# rounding distance from zero), no other summation order can be held to
# 1e-4, and the run is held to TRAJECTORY_ORDERS times that distance
WELL_CONDITIONED = 1e-5
GRAD_REL, GRAD_ORDERS = 1e-5, 3.0
TRAJECTORY_ORDERS = 2.0
RESUME_EVERY, RESUME_EPOCHS = 3, 12


def wiki_config(**over):
    """bench.py:978-982's ``TrainConfig`` (acmgcnp, hidden 64, dropout 0.5,
    ELL, bf16 gathers, the sequential loop) with the first-layer hoist on:
    its ``Â X`` at w600 is the aggregate the wide-feature path stores in
    bf16 (4·N·F > 2^30), made once at set-up through the sharded
    operator."""
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcnp", hidden=64, dropout=0.5, epochs=WIKI_EPOCHS,
        early_stopping=0, selection="val_metric", operator_format="ell",
        spmm_dtype="bfloat16", hoist_first=True, num_splits=2, seed=0),
        **over))


def wiki_counts(bodies):
    """Launches the sharded wiki run implies (F = 600 > HOIST_MAX_COLS,
    sequential loop): at set-up K6 + K1 at w600 (the hoist aggregate);
    per epoch layer 1's train gather of [z_low | z_high] at w128 and its
    transpose, layer 2's gather at w10 in the train and the eval forward
    and its transpose (the eval forward's layer 1 reads the aggregate),
    each product packed by K6 first; K2 per forward and layer, K3 per
    layer."""
    b = bodies
    out = {"k1_spmm_w600": 1, "k1_spmm_w128": 2 * b, "k1_spmm_w10": 3 * b,
           "k2_attn_fwd_d64": 2 * b, "k2_attn_fwd_d5": 2 * b,
           "k3_attn_bwd_d64": b, "k3_attn_bwd_d5": b}
    out.update({f"k6_pack_w{d}": out[f"k1_spmm_w{d}"]
                for d in (600, 128, 10)})
    return out


@contextlib.contextmanager
def _wrapped(module, name, make):
    """``module.name`` replaced by ``make(original)`` for the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _k1_plain_chunked(half, x, max_bytes=2**32):
    """K1's plain version (``row_gather_spmm_plain``, value-free or
    valued, no epilogue) over chunks of sorted rows, each gathering at
    most ``max_bytes`` of f32 terms: at w600 on the wiki graph the whole
    gather would be 36 GB."""
    import torch

    from acmgnn_tpu_torch.ops.ell import _valued_terms

    n, d = half.num_rows, x.shape[1]
    indptr = half.indptr.cpu()
    acc = torch.zeros(n, d, device=x.device)
    per = max(1, max_bytes // (4 * d))
    row0 = 0
    while row0 < n:
        lo = int(indptr[row0])
        row1 = int(torch.searchsorted(indptr, lo + per, right=True)) - 1
        row1 = min(max(row1, row0 + 1), n)
        hi = int(indptr[row1])
        deg = half.indptr[row0 + 1:row1 + 1] - half.indptr[row0:row1]
        rows = torch.repeat_interleave(half.row_ids[row0:row1].long(), deg)
        g = x.float()[half.indices[lo:hi].long()]
        if half.vals is not None:
            g = _valued_terms(g, half.vals[lo:hi, None])
        acc.index_add_(0, rows, g)
        row0 = row1
    if half.row_scale is not None:
        acc = acc * half.row_scale[:, None]
    return acc


def _k1_wide_row(half, xg, name, tag, lib, replaces=None, replay=False):
    """K1 at a width whose gather the plain version cannot hold whole:
    per element against ``_k1_plain_chunked``, with ``replay`` also bit
    for bit against ``k1_order_replay``, timed beside it (one call) and
    ``torch.sparse.mm``."""
    import torch

    from acmgnn_tpu_torch.ops.ell import k1_order_replay, row_gather_spmm

    n, nnz, d = half.num_rows, int(half.indices.numel()), xg.shape[1]
    got = row_gather_spmm(half, xg)
    err = spmm_err(got, _k1_plain_chunked(half, xg),
                   _k1_plain_chunked(half, xg.abs()), _ell_row_terms(half),
                   name + tag)
    form, note = _k1_form_note(half, xg)
    if replay:
        if not torch.equal(got, k1_order_replay(half, xg, None, (0.0,) * d,
                                                (1.0,) * d)):
            fail(f"{name + tag}: K1 differs from its summation order "
                 f"replayed")
        print(f"  {name + tag}: equal bit for bit to k1_order_replay "
              f"({form} form, row stride {xg.stride(0)})")
    if form == "wide":
        print(f"  {name + tag} the narrow form on the same operand: device "
              f"{_k1_narrow_ms(half, xg, None, None, None, 3)}")
    del got

    def run():
        return row_gather_spmm(half, xg)

    ms, dev_ms = time_ms(run, 5), device_ms(run, reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _k1_plain_chunked(half, xg)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    xf = xg.float()
    lib_ms = time_ms(lambda: torch.sparse.mm(lib, xf), 3)
    lib_dev = device_ms(lambda: torch.sparse.mm(lib, xf), reps=3)
    del xf
    nbytes = (8 * (n + 1) + 4 * nnz + 4 * n
              + xg.element_size() * half.num_cols * d + 4 * n * d
              + (4 * n if half.row_scale is not None else 0))
    b_ms, b_by = bound(nbytes, nnz * d + 2 * n * d)
    print(f"  {name + tag} ({note}): {ms:.4f} ms, device {_ms(dev_ms)} "
          f"(plain, in row chunks of <= 4 GiB of terms, {plain_ms:.3f}; "
          f"torch.sparse.mm f32 {lib_ms:.4f}, device {_ms(lib_dev)}; bound "
          f"{b_ms:.4f} {b_by}; {CARD_LINE})")
    return dict(name=name + tag, counter=f"k1_spmm_w{d}", route="cuda",
                source="acmgnn_tpu_torch/csrc/spmm.cu",
                replaces=replaces or K1_LOCAL_REPLACES, max_abs_err=err,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev,
                form=form)


def phase_wiki_sharded(data):
    """[11a] wiki at full width (``data``, ``wiki_graph``'s) on the sharded path, world size 1 over
    NCCL: ``run_experiment_sharded(..., per_host_loading=True)`` (2 splits
    x ``WIKI_EPOCHS``), each split captured, the features' loader called
    once with (0, N) and its slab the loaded rows, zero padded; host
    seconds of the graph, the operator build and the load; ms/epoch,
    peak memory, finite losses, launch counts as ``wiki_counts`` implies,
    a profile of ``WIKI_EPOCHS`` epochs (profiler on, the replays); then K6 and
    K1 at w600 and at the epoch's widths (w128 and its transpose, w10)
    against their plain versions, bounds and ``torch.sparse.mm``.
    Returns (kernel rows, launch counts)."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.ops.ell import k1_operand
    from acmgnn_tpu_torch.parallel import sharded
    from acmgnn_tpu_torch.train import trainer

    print(f"[11a] memory reckoned beforehand: features {4 * WIKI['n'] * 600 / 1e9:.2f} "
          f"GB f32 (host and card), the hoist aggregate "
          f"{2 * WIKI['n'] * 600 / 1e9:.2f} GB bf16, its receive buffer as "
          f"much, activations [N, 64] f32 {4 * WIKI['n'] * 64 / 1e9:.2f} GB "
          f"each")
    cfg = wiki_config()
    seen = {"prep": [], "ops_s": [], "loads": [], "splits": []}

    def timed_ops(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            seen["ops_s"].append(time.perf_counter() - t0)
            return out
        return wrapper

    def recorded_load(fn):
        def wrapper(loader, boundaries, rpp, rank, dtype, trailing=(),
                    device=None):
            calls, views = [], []

            def load(r0, r1):
                calls.append((r0, r1))
                views.append(loader(r0, r1))
                return views[-1]

            t0 = time.perf_counter()
            slab = fn(load, boundaries, rpp, rank, dtype, trailing, device)
            dt = time.perf_counter() - t0
            same = None
            if tuple(trailing) == (WIKI["f"],):
                # the whole array (world size 1): its rows, then zeros
                rows = views[0].shape[0]
                same = (torch.equal(slab[:rows], torch.from_numpy(views[0]))
                        and not slab[rows:].any())
            seen["loads"].append((tuple(trailing), calls, dt, same))
            return slab
        return wrapper

    def kept_prep(fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            seen["prep"].append(out)
            return out
        return wrapper

    class SplitLog:
        def info(self, *a):
            pass

        def log_split(self, idx, res):
            seen["splits"].append(res)

        def log_result(self, out):
            pass

    init_distributed_nccl()
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _wrapped(trainer, "make_sharded_operators", timed_ops), \
                _wrapped(sharded, "shard_node_array_per_host",
                         recorded_load), \
                _wrapped(trainer, "prepare_sharded_data", kept_prep), \
                _captured_runs("[11a]") as calls:
            out = trainer.run_experiment_sharded(
                data, cfg, per_host_loading=True, logger=SplitLog())
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prep = seen["prep"][0]
        model = trainer.build_model(cfg, prep.x.shape[1], prep.nclass,
                                    seed=cfg.seed, nnodes=data.num_nodes)
        masks = tuple(prep.place(m) for m in _masks(data.num_nodes))

        def run_of(epochs):
            c = dataclasses.replace(cfg, epochs=epochs)
            return _bodies(c, trainer.make_split_runner(
                model, c, group=dist.group.WORLD)(
                prep.ops, prep.x, prep.labels, masks, seed=3,
                labels_onehot=prep.labels_onehot))

        ops: dict = {}
        phase_profile("[11a]", run_of, epochs=WIKI_EPOCHS, ops_out=ops)
        del model
    finally:
        dist.destroy_process_group()
    feat_loads = [ld for ld in seen["loads"] if ld[0] == (WIKI["f"],)]
    print(f"[11a] run_experiment_sharded, world size 1 (nccl), per-rank "
          f"slab loading, {cfg.num_splits} splits x {cfg.epochs} epochs: "
          f"{t_run:.1f} s in all; operator build {sum(seen['ops_s']):.1f} s "
          f"(host); slab loads {sum(ld[2] for ld in seen['loads']):.2f} s "
          f"(host, {len(seen['loads'])} arrays: features, labels, one-hot "
          f"labels, 3 masks a split, the operators' per-node vectors); "
          f"features loader calls "
          f"{[ld[1] for ld in feat_loads]}")
    if (len(feat_loads) != 1 or feat_loads[0][1] != [(0, data.num_nodes)]
            or not feat_loads[0][3]):
        fail("[11a] the features' loader was not called once with (0, N), "
             "or its slab is not the loaded rows")
    losses = [(float(r.train_loss), float(r.val_loss)) for r in
              seen["splits"]]
    print(f"[11a] epoch_ms_steady {out['epoch_ms_steady']:.3f} ms/epoch "
          f"(split 1, replaying split 0's capture: (bodies, replays, "
          f"capture ms) by split {[(b, r, _ms(c)) for b, r, c in calls]}), "
          f"epoch_ms_avg "
          f"{out['epoch_ms_avg']:.3f}; the profiled replays "
          f"{_ms(ops.get('wall'))} ms/epoch, device busy "
          f"{_ms(ops.get('busy'))}; peak memory {peak:.2f} GiB; (train, "
          f"val) loss by split {losses}; test accuracy "
          f"{out['test_mean']:.4f} ({CARD_LINE})")
    if not np.all(np.isfinite(losses)) or not np.isfinite(out["test_mean"]):
        fail("[11a] non-finite loss")
    if ops.get("wall"):
        ratio = out["epoch_ms_steady"] / ops["wall"]
        print(f"[11a] prediction (PERF.md, PR 14): epoch_ms_steady within 3% "
              f"of the replays: {ratio:.4f}x, "
              f"{'held' if abs(ratio - 1) <= 0.03 else 'missed'}; peak "
              f"within 1% of 22.65 GiB: {peak:.3f}, "
              f"{'held' if abs(peak / 22.65 - 1) <= 0.01 else 'missed'}")
    want = wiki_counts(out["epochs_total"])
    counts = without_loop_kernels(counts)
    print(f"[11a] launches {json.dumps(counts, sort_keys=True)}")
    if counts != want:
        fail(f"[11a] launch counts {counts} != expected {want}")

    # the kernels at the path's shapes
    op, x = prep.ops.adj_low, prep.x
    rpp, bnd = prep.rows_per_part, prep.boundaries
    prep.ops.x_agg = None
    seen.clear()
    del prep
    torch.cuda.empty_cache()
    gen = torch.Generator(device=CARD).manual_seed(11)
    rows = []
    row = _k6_row(op, x, bnd, rpp, False, None, "@wiki", None, 0.0,
                  dev_reps=3)
    row.pop("run")
    rows.append(row)
    lib = _local_csr(op.fwd)
    rows.append(_k1_wide_row(op.fwd, k1_operand(x, torch.bfloat16),
                             "k1_spmm_w600", "@wiki", lib))
    del x
    torch.cuda.empty_cache()
    hp = [float(h) for h in (0,) * 64 + (1,) * 64]
    sign = [1.0 - 2.0 * h for h in hp]
    z = torch.randn(rpp, 128, generator=gen, device=CARD)
    row = _k6_row(op, z, bnd, rpp, True, sign, "_transpose@wiki", None, 0.0)
    row.pop("run")
    rows.append(row)
    rows += _k1_rows(op.fwd, [(k1_operand(z, torch.bfloat16), z, hp, sign,
                               "k1_spmm_w128")], "@wiki",
                     lambda d: f"k1_spmm_w{d}", lib, K1_LOCAL_REPLACES)
    signed = (z * torch.tensor(sign, device=CARD)).to(torch.bfloat16)
    rows += _k1_rows(op.bwd, [(k1_operand(signed, torch.bfloat16,
                                          op.bwd.pre_scale), z, hp,
                               [1.0] * 128, "k1_spmm_w128_transpose")],
                     "@wiki", lambda d: f"k1_spmm_w{d}", lib,
                     K1_LOCAL_REPLACES)
    hp10 = [0.0] * 5 + [1.0] * 5
    z10 = torch.randn(rpp, 10, generator=gen, device=CARD)
    row = _k6_row(op, z10, bnd, rpp, False, None, "@wiki", None, 0.0)
    row.pop("run")
    rows.append(row)
    rows += _k1_rows(op.fwd, [(k1_operand(z10, torch.bfloat16), z10, hp10,
                               [1.0 - 2.0 * h for h in hp10],
                               "k1_spmm_w10")], "@wiki",
                     lambda d: f"k1_spmm_w{d}", lib, K1_LOCAL_REPLACES)
    for r in rows:
        r.update(path=f"11a: wiki, world size 1 (nccl), {cfg.num_splits} "
                      f"splits x {cfg.epochs} epochs",
                 launches=counts.get(r["counter"], 0))
    return rows, counts


def init_distributed_nccl():
    from acmgnn_tpu_torch.parallel.multihost import init_distributed

    init_distributed(backend="nccl", device="cuda",
                     init_method=f"tcp://localhost:{_free_port()}", rank=0,
                     world_size=1)


def phase_genius_sharded_rocauc(g_adj, g_feats, g_labels):
    """[11b] genius (phase 5's configuration at full width, f32 gathers)
    through ``run_experiment_sharded`` at world size 1 over NCCL, each
    split captured, ROC-AUC over the gathered logits (inside the graph):
    each split's best val and test AUC equal to the single-card
    ``run_experiment``'s bit for bit, K4 launched once per evaluation;
    the captured sharded loop against its eager form bit for bit
    (``sharded_capture_equality``); then K4 on the gathered scores of the
    trained model
    against its plain version (counts and AUCs bit for bit), timed.
    Returns the kernel row."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.parallel.multihost import gather_rows
    from acmgnn_tpu_torch.train import metrics, trainer

    data = GraphData("genius-scale", g_adj, g_feats, g_labels)
    # f32 gathers: with bf16 ones the two paths round the ELL transpose's
    # operand apart, as the JAX package's do (the single card casts, then
    # pre-scales and rounds again; the sharded path pre-scales in f32 and
    # rounds once), so only the f32 form can be equal bit for bit
    cfg = genius_config(epochs=GENIUS_TIMED_EPOCHS, num_splits=2, seed=0,
                        spmm_dtype="float32")
    splits = {"sharded": [], "single": []}

    def log(key):
        class Log:
            def info(self, *a):
                pass

            def log_split(self, idx, res):
                splits[key].append((float(res.val_metric),
                                    float(res.test_metric),
                                    int(res.epochs_run)))

            def log_result(self, out):
                pass
        return Log()

    preps = []

    def kept(fn):
        def wrapper(*a, **k):
            preps.append(fn(*a, **k))
            return preps[-1]
        return wrapper

    init_distributed_nccl()
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _wrapped(trainer, "prepare_sharded_data", kept), \
                _captured_runs("[11b]"):
            out, model = trainer.run_experiment_sharded(
                data, cfg, logger=log("sharded"), return_model=True)
        torch.cuda.synchronize()
        t_sharded = time.perf_counter() - t0
        k4 = dict(kernels.launches).get("k4_auc_m2", 0)
        sharded_capture_equality(
            "[11b]", preps[0], dataclasses.replace(
                cfg, epochs=SHARDED_CAPTURE_EPOCHS), _masks(
                data.num_nodes, seed=1), dist.group.WORLD, collectives=1)
        prep = preps[0]
        with torch.no_grad():
            logits = gather_rows(model(prep.x, prep.ops, training=False),
                                 dist.group.WORLD)
        scores = torch.softmax(logits, dim=-1)[:, 1][None].contiguous()
        packed = metrics.pack_labels_and_masks(
            prep.labels, tuple(prep.place(m) for m in _masks(
                data.num_nodes, seed=1)[1:]))
        packed = gather_rows(packed.T, dist.group.WORLD).T.contiguous()
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    single = trainer.run_experiment(data, cfg, logger=log("single"))
    t_single = time.perf_counter() - t0
    bodies = sum(e + 1 for _, _, e in splits["sharded"])
    print(f"[11b] genius ROC-AUC, {cfg.num_splits} splits x {cfg.epochs} "
          f"joint epochs: sharded world size 1 (nccl, captured) "
          f"{t_sharded:.1f} "
          f"s, single card (captured) {t_single:.1f} s; (val, test, epochs) "
          f"by split: sharded {splits['sharded']}, single {splits['single']};"
          f" K4 launches on the sharded path {k4} (one per evaluation: "
          f"{bodies})")
    if splits["sharded"] != splits["single"] or out["per_split"] != \
            single["per_split"]:
        fail("[11b] the sharded AUCs differ from the single card's")
    if k4 != bodies:
        fail(f"[11b] K4 launched {k4} times, not once per evaluation")
    order, s_sorted = metrics.sort_scores(scores)
    counts, auc = metrics._launch(s_sorted, order, packed, 2)
    p_counts, p_auc = metrics.rocauc_from_sorted_plain(s_sorted, order,
                                                       packed, 2)
    torch.cuda.synchronize()
    if not (torch.equal(counts, p_counts) and torch.equal(auc, p_auc)):
        fail("[11b] K4 on the gathered scores differs from its plain "
             "version")
    n = scores.shape[1]

    def run():
        return metrics._launch(s_sorted, order, packed, 2)

    ms, dev_ms = time_ms(run, 50), device_ms(run)
    plain_ms = time_ms(lambda: metrics.rocauc_from_sorted_plain(
        s_sorted, order, packed, 2), 5)
    lib_ms = time_ms(lambda: torch.sort(scores, dim=-1), 50)
    lib_dev = device_ms(lambda: torch.sort(scores, dim=-1))
    b_ms, b_by = bound(13 * n, 6 * n)
    print(f"  k4_auc_m2@genius-sharded (gathered scores, {n} nodes): counts "
          f"and AUCs {auc.tolist()} bit-equal to the plain version; "
          f"{ms:.4f} ms, device {_ms(dev_ms)} (plain {plain_ms:.3f}, "
          f"torch.sort {lib_ms:.4f}, device {_ms(lib_dev)}; bound "
          f"{b_ms:.4f} {b_by})")
    return dict(name="k4_auc_m2@genius-sharded", counter="k4_auc_m2",
                route="cuda", source="acmgnn_tpu_torch/csrc/rocauc.cu",
                replaces="acmgnn_tpu/train/metrics.py:68", max_abs_err=0.0,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev,
                launches=k4, path=f"11b: genius ROC-AUC, sharded world size "
                                  f"1 (nccl), {cfg.num_splits} splits x "
                                  f"{cfg.epochs} joint epochs")


def zoo11_config(case):
    """Phase 11c's configuration of ``case``: ``sharded_check_config``
    (the headline model, dropout 0, lr 1e-3, no weight decay) with the
    case's changes."""
    over = dict(ZOO11_CASES[case])
    fmt = over.pop("operator_format", "ell")
    return dataclasses.replace(sharded_check_config(fmt), **over)


def _zoo_rank(rank, world, store_path, out_dir):
    """One rank of phase 11c: every case of ``ZOO11_CASES`` with each
    exchange through ``run_experiment_sharded``; its result, parameters
    and launch counts written for the parent."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.parallel.multihost import init_distributed
    from acmgnn_tpu_torch.train.trainer import run_experiment_sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda", rank=rank,
                     world_size=world,
                     store=dist.FileStore(store_path, world))
    data = _small_twitch()
    for i, case in enumerate(ZOO11_CASES):
        for exchange in ("allgather", "halo"):
            kernels.reset_launches()
            result, model = run_experiment_sharded(
                data, zoo11_config(case), exchange=exchange,
                return_model=True)
            torch.save(dict(result=result, launches=dict(kernels.launches),
                            params={k: p.detach().cpu()
                                    for k, p in model.named_parameters()}),
                       f"{out_dir}/zoo{i}-{exchange}-rank{rank}.pt")
        torch.save(_stepwise_gaps(data, zoo11_config(case),
                                  row_witness=case in STEP_BOUND_ONLY),
                   f"{out_dir}/zoo{i}-steps-rank{rank}.pt")
    dist.destroy_process_group()


def _stepwise_gaps(data, cfg, row_witness=False):
    """The sharded runner against the single card step by step (in a
    rank of a group): the single card's trajectory in one-body segments
    (``make_split_runner``'s ``init_state`` / ``epoch_limit``); from each
    of its states, one body on the sharded path (the largest |Δparameter|
    after it), and one body with Adam's first moments zeroed on the
    sharded path, on the single card and on the single card's ELL and COO
    operators at f32 gathers: each then leaves ``exp_avg = (1 - beta1) ·
    gradient``.  Per step, per parameter tensor, the L2 norms of the
    sharded gradient's distance from the single card's, of the single
    card's gradient, and of the distance between the single card's own
    ELL and COO gradients (split 0's masks and parameters, as
    ``run_experiment_sharded``).  With ``row_witness`` (a model without
    per-node parameters) that last distance is the larger of it and the
    distance to the single card's gradient on the graph with its node
    rows in reverse order: every reduction over rows (BatchNorm's
    statistics, the weight gradients) in another order, as the ranks
    split them."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.data.splits import random_disassortative_splits
    from acmgnn_tpu_torch.ops.graph import permute_graph
    from acmgnn_tpu_torch.train import trainer

    masks_np = random_disassortative_splits(
        np.asarray(data.labels), data.num_classes,
        rng=np.random.default_rng(cfg.seed))

    def single_runner(c, perm=None):
        d, m_np = data, masks_np
        if perm is not None:
            d = dataclasses.replace(
                data, adj=permute_graph(data.adj, perm),
                features=np.asarray(data.features)[perm],
                labels=np.asarray(data.labels)[perm])
            m_np = tuple(m[perm] for m in masks_np)
        _, ops, x, y, y1h, nclass = trainer.prepare_data(d, c)
        run = trainer.make_split_runner(trainer.build_model(
            c, x.shape[1], nclass, seed=c.seed, nnodes=data.num_nodes), c)
        masks = tuple(torch.from_numpy(m).to(x.device) for m in m_np)
        return lambda init, k: run(ops, x, y, masks, seed=c.seed,
                                   labels_onehot=y1h, init_state=init,
                                   epoch_limit=k, return_state=True)[1].runner

    single = single_runner(cfg)
    orders = [single_runner(dataclasses.replace(
        cfg, spmm_dtype="float32", operator_format=fmt))
        for fmt in ("ell", "coo")]
    rows = None
    if row_witness:
        if cfg.structure_info:
            raise ValueError("the row witness needs a model without "
                             "per-node parameters")
        rows = single_runner(cfg, np.arange(data.num_nodes)[::-1].copy())
    prep = trainer.prepare_sharded_data(data, cfg, group=dist.group.WORLD)
    model = trainer.build_model(cfg, prep.x.shape[1], prep.nclass,
                                seed=cfg.seed, nnodes=data.num_nodes)
    run_sharded = trainer.make_split_runner(model, cfg,
                                            group=dist.group.WORLD)
    smasks = tuple(prep.place(m) for m in masks_np)

    def sharded(init, k):
        return run_sharded(prep.ops, prep.x, prep.labels, smasks,
                           seed=cfg.seed, labels_onehot=prep.labels_onehot,
                           init_state=init, epoch_limit=k,
                           return_state=True)[1].runner

    def zeroed(state):
        opt = {**state.opt_state, "state": {
            i: {**st, "exp_avg": torch.zeros_like(st["exp_avg"])}
            for i, st in state.opt_state["state"].items()}}
        return dataclasses.replace(state, opt_state=opt)

    def grads(state):
        return [st["exp_avg"].double() / 0.1
                for st in state.opt_state["state"].values()]

    budget = cfg.epochs + int(bool(cfg.joint)
                              and cfg.model_type in trainer.JOINT_CAPABLE)
    state, gaps = single(None, 0), []
    for k in range(1, budget + 1):
        nxt = single(state, k)
        got = sharded(state, k)
        step = max(float((got.variables[n] - nxt.variables[n]).abs().max())
                   for n in got.variables)
        g_sh, g_ref, g_ell, g_coo = (grads(run(zeroed(state), k)) for run in
                                     (sharded, single, *orders))
        g_rows = g_ref if rows is None else grads(rows(zeroed(state), k))
        gaps.append((step, [
            (float((a - b).norm()), float(b.norm()),
             max(float((e - c).norm()), float((r - b).norm())))
            for a, b, e, c, r in zip(g_sh, g_ref, g_ell, g_coo, g_rows)]))
        state = nxt
    return gaps


def _spawn_ranks(fn, world, tag):
    """``fn(rank, world, store, out_dir)`` in ``world`` spawned processes
    on the one card; returns (``out_dir``, for the caller to read and
    remove, and the seconds the ranks took with start-up)."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    ctx = mp.start_processes(fn, args=(world, f"{tmp}/store", tmp),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > RANK_DEADLINE_S:
                fail(f"{tag} the ranks did not finish in {RANK_DEADLINE_S} "
                     f"s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    return tmp, time.perf_counter() - t0


def phase_zoo_sharded():
    """[11c] The zoo on the sharded path: 4 ranks (gloo on CUDA tensors,
    one card) on phase 6c's 20k-node graph, each case of ``ZOO11_CASES``
    for ``SHARDED_CHECK_EPOCHS`` epochs with all-gather and with halo exchange:
    against the single-card port (``_check_zoo_case``) and each halo run
    against its all-gather twin; then the kernels of these runs on rank 0's blocks: K1 on the
    symmetric operator's valued halves (bf16, f32 values) bit for bit
    against ``k1_order_replay`` on every rank's block, K1 on the
    structure operator's block (w64, w2), K5 on the symmetric COO block,
    K6 packing the structure operand (halo) and the valued transpose's
    (sign, no pre-scale), K2/K3 at T = 4 and at variant 1's mask.
    Returns (kernel rows, rank 0's launch counts by case)."""
    import shutil

    import scipy.sparse as sp
    import torch

    from acmgnn_tpu_torch.ops.coo import coo_spmm, coo_spmm_plain
    from acmgnn_tpu_torch.ops.ell import (
        k1_operand,
        k1_order_replay,
        row_gather_spmm,
    )
    from acmgnn_tpu_torch.ops.graph import sym_normalized_adjacency
    from acmgnn_tpu_torch.parallel.sharded import (
        make_sharded_coo_op,
        make_sharded_ell_op,
    )

    data = _small_twitch()
    tmp, secs = _spawn_ranks(_zoo_rank, SHARDED_P, "[11c]")
    counts = {}
    try:
        print(f"[11c] {SHARDED_P} ranks (gloo, one card), graph "
              f"N={data.num_nodes}, {len(ZOO11_CASES)} cases x 2 exchanges "
              f"of {SHARDED_CHECK_EPOCHS} epochs: {secs:.1f} s with start-up")
        for i, case in enumerate(ZOO11_CASES):
            runs = {}
            for exchange in ("allgather", "halo"):
                tag = f"[11c {case}, {exchange}]"
                ranks = [torch.load(f"{tmp}/zoo{i}-{exchange}-rank{r}.pt")
                         for r in range(SHARDED_P)]
                r0 = ranks[0]
                for r in ranks[1:]:
                    if any(not torch.equal(r["params"][k], r0["params"][k])
                           for k in r0["params"]):
                        fail(f"{tag} the replicas' parameters differ")
                if r0["result"]["devices"] != SHARDED_P:
                    fail(f"{tag} ran on {r0['result']['devices']} ranks")
                runs[exchange] = r0
            _check_zoo_case(f"[11c {case}]", data, zoo11_config(case),
                            runs["allgather"],
                            torch.load(f"{tmp}/zoo{i}-steps-rank0.pt"),
                            trajectory=case not in STEP_BOUND_ONLY)
            _halo_against_allgather(f"[11c {case}, halo]", runs["halo"],
                                    runs["allgather"])
            counts[case] = runs["allgather"]["launches"]
            print(f"[11c {case}] rank 0 launches "
                  f"{json.dumps(counts[case], sort_keys=True)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    dev = torch.device(CARD)
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    a_sym = sym_normalized_adjacency(data.adj)
    for dtype, case in ((torch.bfloat16, "sym ell bf16"),
                        (torch.float32, "sym ell f32")):
        ops, b = make_sharded_ell_op(a_sym, SHARDED_P, None,
                                     exchange="halo", gather_dtype=dtype)
        for p, op in enumerate(ops):
            if op.bwd is not op.fwd or op.fwd.vals.dtype != dtype:
                fail(f"[11c] rank {p}'s symmetric block should be one "
                     f"valued half in {dtype}")
            half = op.fwd.to(dev)
            for d in (7, 4):
                xg = k1_operand(torch.randn(half.num_cols, d, generator=gen,
                                            device=dev), dtype)
                if not torch.equal(row_gather_spmm(half, xg),
                                   k1_order_replay(half, xg, None,
                                                   (0.0,) * d, (1.0,) * d)):
                    fail(f"[11c] K1 on rank {p}'s valued {dtype} block "
                         f"differs from k1_order_replay at w{d}")
        print(f"[11c] K1 on every rank's valued symmetric block ({dtype} "
              f"values, halo layout), w7 and w4: bit for bit against "
              f"k1_order_replay")
        op0 = ops[0].to(dev)
        half = op0.fwd
        lib = _local_csr(dataclasses.replace(half, vals=half.vals.float()))
        dt = "bf16" if dtype == torch.bfloat16 else "f32"
        cases = [(k1_operand(torch.randn(half.num_cols, d, generator=gen,
                                         device=dev), dtype), None, None,
                  None, f"k1_spmm_w{d}_valued") for d in (7, 4)]
        for r in _k1_rows(half, cases, f"_{dt}@sharded-sym-rank0",
                          lambda d: f"k1_spmm_w{d}_valued", lib,
                          K1_LOCAL_REPLACES):
            r.update(case=case)
            rows.append(r)
        if dtype == torch.float32:
            x4 = torch.randn(data.num_nodes, 4, generator=gen, device=dev)
            r = _k6_row(op0, x4, b, op0.rows_per_part, True,
                        [1.0, 1.0, -1.0, -1.0], "_valued_transpose@sharded",
                        None, 0.0)
            r.pop("run")
            r.update(case=case)
            rows.append(r)
    # K5 on rank 0's symmetric COO block
    coos, b = make_sharded_coo_op(a_sym, SHARDED_P, None, exchange="halo")
    half = coos[0].fwd.to(dev)
    x = torch.randn(half.num_cols, 7, generator=gen, device=dev)
    got = coo_spmm(half, x)
    err = spmm_err(got, coo_spmm_plain(half, x, None, (0.0,) * 7,
                                       (1.0,) * 7),
                   coo_spmm_plain(dataclasses.replace(half,
                                                      val=half.val.abs()),
                                  x.abs(), None, (0.0,) * 7, (1.0,) * 7),
                   _coo_row_terms(half), "k5_coo_w7@sharded-sym-rank0")
    lib = _local_csr(half)
    ms, dev_ms = time_ms(lambda: coo_spmm(half, x), 50), device_ms(
        lambda: coo_spmm(half, x))
    plain_ms = time_ms(lambda: coo_spmm_plain(half, x, None, (0.0,) * 7,
                                              (1.0,) * 7), 5)
    lib_ms = time_ms(lambda: torch.sparse.mm(lib, x), 20)
    lib_dev = device_ms(lambda: torch.sparse.mm(lib, x))
    rpp = coos[0].rows_per_part
    b_ms, b_by = bound(12 * half.nnz + 4 * half.num_cols * 7 + 4 * rpp * 7,
                       2 * half.nnz * 7)
    print(f"  k5_coo_w7@sharded-sym-rank0: {ms:.4f} ms, device "
          f"{_ms(dev_ms)} (plain {plain_ms:.3f}, torch.sparse.mm f32 "
          f"{lib_ms:.4f}, device {_ms(lib_dev)}; bound {b_ms:.4f} {b_by})")
    rows.append(dict(name="k5_coo_w7@sharded-sym-rank0", counter="k5_coo_w7",
                     route="cuda", source="acmgnn_tpu_torch/csrc/coo.cu",
                     replaces=K5_LOCAL_REPLACES, max_abs_err=err, ms=ms,
                     device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms,
                     library_device_ms=lib_dev, case="sym coo"))
    # the structure operator (the raw adjacency) on rank 0's block
    s_ops, b = make_sharded_ell_op(sp.csr_matrix(data.adj), SHARDED_P, None,
                                   exchange="halo")
    s_op = s_ops[0].to(dev)
    if s_op.bwd is not s_op.fwd or s_op.fwd.vals is not None:
        fail("[11c] the structure block should be one value-free half")
    lib = _local_csr(s_op.fwd)
    cases = [(k1_operand(torch.randn(s_op.fwd.num_cols, d, generator=gen,
                                     device=dev), torch.float32), None, None,
              None, f"k1_spmm_w{d}") for d in (64, 2)]
    for r in _k1_rows(s_op.fwd, cases, "@sharded-structure-rank0",
                      lambda d: f"k1_spmm_w{d}", lib, K1_LOCAL_REPLACES):
        r.update(case="acmgcnpp+structure")
        rows.append(r)
    emb = torch.randn(data.num_nodes, 64, generator=gen, device=dev)
    r = _k6_row(s_op, emb, b, s_op.rows_per_part, False, None,
                "_structure@sharded", None, 0.0)
    r.pop("run")
    r.update(case="acmgcnpp+structure")
    rows.append(r)
    # K2/K3 at the sharded zoo's instances, rank 0's rows
    n0 = s_op.rows_per_part
    for relu, case in (((True,) * 4, "acmgcnpp+structure"),
                       ((False, False, True), "acmgcnp variant 1")):
        for r in _attention_instance_rows(n0, gen, relu, True, (64, 2),
                                          "@sharded-rank0"):
            r.update(case=case)
            rows.append(r)
    for r in rows:
        case = r.pop("case")
        r.update(path=f"11c: {case}, {SHARDED_P} gloo ranks on one card, "
                      f"{SHARDED_CHECK_EPOCHS} epochs, all-gather, rank 0 (timed on "
                      f"rank 0's block)",
                 launches=counts[case].get(r["counter"], 0))
    return rows, counts


def _check_zoo_case(tag, data, cfg, run, gaps, trajectory=True):
    """A zoo case of 11c against the single card.  Each step on the
    sharded path, from the single card's state, computes the single
    card's gradient: per parameter tensor, its gradients stacked over the
    run's steps, ``‖Δg‖ ≤ GRAD_REL · ‖g‖ + GRAD_ORDERS · ‖g_ELL −
    g_COO‖``, the last the single card's own distance between its ELL
    and COO orders at f32 gathers from the same states (the steps'
    parameters are printed: Adam moves a parameter ±lr wherever its
    gradient is at rounding distance from zero).  The whole
    run within 1e-4 of the single card, with equal epochs and test
    metric, where the single card's own ELL and COO orders (at f32
    gathers) part by less than ``WELL_CONDITIONED`` after the run; where
    they part by more, within ``TRAJECTORY_ORDERS`` times that distance.
    Without ``trajectory`` (``STEP_BOUND_ONLY``) the whole run is printed,
    not held."""
    ref = single_chip_reference(data, cfg)
    # the two orders at f32 gathers (COO has no other gather dtype)
    pair = [single_chip_reference(data, dataclasses.replace(
        cfg, spmm_dtype="float32", operator_format=fmt))[1]
        for fmt in ("ell", "coo")]
    orders = max(float((pair[0][k] - pair[1][k]).abs().max())
                 for k in ref[1])
    # each tensor's norms over the run's steps (its gradients stacked)
    gap, norm, witness = (np.sqrt(np.sum(np.square(
        [[t[j] for t in tensors] for _, tensors in gaps]), axis=0))
        for j in range(3))
    bound = GRAD_REL * norm + GRAD_ORDERS * witness
    ratios = np.where(gap > 0, gap / np.maximum(bound, 1e-300), 0.0)
    ratio = float(np.max(ratios))
    worst = list(ref[1])[int(np.argmax(ratios))]
    witness_is = ("‖g_ELL − g_COO‖" if trajectory else
                  "the larger of ‖g_ELL − g_COO‖ and the reversed rows'")
    print(f"{tag} step by step from the single card's states, "
          f"{len(gaps)} steps: per tensor over the steps ‖Δgradient‖ up to "
          f"{ratio:.3f} of its bound ({GRAD_REL:g}·‖g‖ + {GRAD_ORDERS:g}·"
          f"{witness_is}; {worst}), ‖Δgradient‖ / ‖g‖ up to "
          f"{float(np.max(gap / np.maximum(norm, 1e-300))):.3e}; |Δparam| "
          f"after each step up to {max(p for p, _ in gaps):.1e} (not held); "
          f"the single card's own ELL and COO orders part by {orders:.3e} "
          f"after {cfg.epochs} epochs")
    if ratio > 1.0:
        fail(f"{tag} a sharded step's gradient disagrees with the single "
             f"card's")
    if not trajectory:
        worst = max(float((run["params"][k] - ref[1][k]).abs().max())
                    for k in ref[1])
        print(f"{tag} held step by step only: the whole run {worst:.3e} "
              f"from the single card (its own orders {orders:.3e}; not "
              f"held); epochs {run['result']['epochs_total']}/"
              f"{ref[0].epochs_run}")
        return
    if orders < WELL_CONDITIONED:
        compare_to_single(tag, run["result"], run["params"], ref)
        return
    worst = max(float((run["params"][k] - ref[1][k]).abs().max())
                for k in ref[1])
    print(f"{tag} ill-conditioned ({orders:.3e} between the single card's "
          f"own orders): the whole run {worst:.3e} from the single card, "
          f"held to {TRAJECTORY_ORDERS:g}x that; epochs "
          f"{run['result']['epochs_total']}/{ref[0].epochs_run}; test "
          f"{run['result']['test_mean']:.6f}/{float(ref[0].test_metric):.6f}")
    if worst > TRAJECTORY_ORDERS * orders:
        fail(f"{tag} the sharded run parts from the single card by more "
             f"than {TRAJECTORY_ORDERS:g}x the single card's own orders")


def resume11_config(joint):
    """Phase 11d's runs: the headline model at dropout 0.5 (each
    segment's masks follow from the snapshot's loop counter), 2 splits x
    ``RESUME_EPOCHS``; the
    sequential case with the structure channel."""
    over = dict(dropout=0.5, lr=1e-3, weight_decay=0.0, num_splits=2,
                epochs=RESUME_EPOCHS, spmm_dtype="bfloat16", seed=0)
    if not joint:
        over.update(joint=False, model_type="acmgcnpp", structure_info=True)
    return headline_config(**over)


def _resume_rank(rank, world, store_path, out_dir):
    """One rank of phase 11d: for the joint and the sequential loop, the
    run without checkpoints, the checkpointed run, and the checkpointed
    run cut right after the last split's snapshot at half its epochs
    (every rank raises at its next segment's runner call) and resumed;
    results, parameters and each snapshot's tensors written for the
    parent."""
    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.parallel.multihost import init_distributed
    from acmgnn_tpu_torch.train import trainer
    from acmgnn_tpu_torch.utils.checkpoint import restore_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend="gloo", device="cuda", rank=rank,
                     world_size=world,
                     store=dist.FileStore(store_path, world))
    data = _small_twitch()

    class Cut(Exception):
        pass

    make = trainer.make_split_runner
    for joint in (True, False):
        cfg = resume11_config(joint)
        base = f"{out_dir}/ckpt-{int(joint)}"

        def run(ckpt, resume, cfg=cfg):
            res, model = trainer.run_experiment_sharded(
                data, cfg, checkpoint_dir=ckpt,
                checkpoint_every=RESUME_EVERY if ckpt else 0, resume=resume,
                return_model=True)
            return dict(per_split=res["per_split"],
                        epochs_total=res["epochs_total"],
                        params={k: v.cpu()
                                for k, v in model.state_dict().items()})

        def cutting(model, c, **kw):
            runner = make(model, c, **kw)

            def call(*a, **k):
                st = k.get("init_state")
                if (k.get("seed") == c.seed + c.num_splits - 1
                        and st is not None and st.bodies >= c.epochs // 2):
                    raise Cut(st.bodies)
                return runner(*a, **k)
            return call

        out = {"plain": run(None, False), "whole": run(f"{base}/whole",
                                                       False)}
        trainer.make_split_runner = cutting
        try:
            run(f"{base}/cut", False)
            raise RuntimeError("the run was not cut")
        except Cut:
            pass
        finally:
            trainer.make_split_runner = make
        dist.barrier()
        out["resumed"] = run(f"{base}/cut", True)
        dist.barrier()
        for name in ("whole", "cut"):
            d = f"{base}/{name}"
            out[f"snap_{name}"] = {
                f: restore_checkpoint(f"{d}/{f}", map_location="cpu")
                for f in sorted(os.listdir(d)) if f.endswith("_state")}
        torch.save(out, f"{out_dir}/resume-{int(joint)}-rank{rank}.pt")
    dist.destroy_process_group()


def phase_resume_sharded():
    """[11d] Cut and resume at world size 2 (gloo on the one card): each
    rank's resumed run equals the uninterrupted checkpointed run and the
    run without checkpoints bit for bit (per-split test metrics, epochs,
    the last split's parameters and buffers), and the resumed run's last
    snapshots equal the uninterrupted run's (parameters, Adam's moments
    and step, the loop state with its loss and val histories); for the
    joint and the sequential loop."""
    import shutil

    import torch

    tmp, secs = _spawn_ranks(_resume_rank, 2, "[11d]")
    try:
        for joint in (True, False):
            tag = f"[11d {'joint' if joint else 'sequential'}]"
            for r in range(2):
                out = torch.load(f"{tmp}/resume-{int(joint)}-rank{r}.pt")
                for name in ("whole", "resumed"):
                    if not _tree_equal(out[name], out["plain"]):
                        fail(f"{tag} rank {r}: the {name} run differs from "
                             f"the run without checkpoints")
                if not _tree_equal(out["snap_cut"], out["snap_whole"]):
                    fail(f"{tag} rank {r}: the resumed run's snapshots "
                         f"differ from the uninterrupted run's")
            print(f"{tag} cut after the last split's snapshot at epoch >= "
                  f"{RESUME_EPOCHS // 2} and resumed: equal bit for bit to "
                  f"the uninterrupted run and to the run without "
                  f"checkpoints on both ranks (per-split {out['plain']['per_split']}, "
                  f"{out['plain']['epochs_total']} epochs; snapshots "
                  f"{sorted(out['snap_cut'])})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[11d] 2 ranks: {secs:.1f} s with start-up")


def phase_batchnorm_sharded(adj, feats, labels):
    """[11e] acmgcnpp with ``init_layers_X = 2`` (its skip MLP's
    BatchNorm; hidden 64, the headline's other settings, f32 gathers) on
    the headline graph at world size 1 over NCCL, captured: equal bit for
    bit to the captured single card (``sharded_vs_single_bits``).  Its
    4-rank form runs as an 11c case, held by 11c's per-step gradient
    bound."""
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops.graph import GraphData

    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    cfg = headline_config(model_type="acmgcnpp", init_layers_X=2,
                          spmm_dtype="float32",
                          epochs=SHARDED_CAPTURE_EPOCHS)
    init_distributed_nccl()
    try:
        sharded_vs_single_bits("[11e]", data, cfg, _masks(adj.shape[0]),
                               dist.group.WORLD)
    finally:
        dist.destroy_process_group()


SEGMENT_EVERY = 4                # 11f: bodies a checkpoint segment


def phase_segments_nccl(adj, feats, labels):
    """[11f] ``run_experiment_sharded`` with ``checkpoint_every`` at world
    size 1 over NCCL on the headline graph (2 splits x 10 epochs, dropout
    0.5): every split's segments replay the run's one capture, and the
    run equals, bit for bit, the same run without checkpoints (one capture
    too): per-split test metrics, epochs, the last split's parameters and
    buffers."""
    import tempfile

    import torch
    import torch.distributed as dist

    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train import trainer

    data = GraphData("twitch-gamers-scale-uniform", adj, feats, labels)
    cfg = headline_config(epochs=10, num_splits=2, seed=0)
    runs = {}
    init_distributed_nccl()
    try:
        for name, kw in (("plain", {}), ("segments", dict(
                checkpoint_every=SEGMENT_EVERY))):
            with tempfile.TemporaryDirectory() as tmp:
                if kw:
                    kw["checkpoint_dir"] = tmp
                t0 = time.perf_counter()
                with _captured_runs(f"[11f {name}]") as calls:
                    out, model = trainer.run_experiment_sharded(
                        data, cfg, return_model=True, **kw)
                torch.cuda.synchronize()
                runs[name] = (out, {k: v.detach().clone() for k, v in
                                    model.state_dict().items()},
                              calls, time.perf_counter() - t0)
        # the segments' eager form: the same host loop without a capture
        with tempfile.TemporaryDirectory() as tmp, \
                _wrapped(trainer, "capture_device",
                         lambda f: lambda *a, **k: None):
            out, model = trainer.run_experiment_sharded(
                data, cfg, return_model=True, checkpoint_dir=tmp,
                checkpoint_every=SEGMENT_EVERY)
        runs["eager"] = (out, {k: v.detach().clone() for k, v in
                               model.state_dict().items()})
    finally:
        dist.destroy_process_group()
    e_out, e_params = runs["eager"]
    if (e_out["per_split"] != runs["segments"][0]["per_split"]
            or not _tree_equal(e_params, runs["segments"][1])):
        fail(f"[11f] the looped segments {runs['segments'][0]} differ from "
             f"their eager form {e_out}")
    (p_out, p_params, _, p_s), (s_out, s_params, calls, s_s) = (
        runs["plain"], runs["segments"])
    if (p_out["per_split"] != s_out["per_split"]
            or p_out["epochs_total"] != s_out["epochs_total"]
            or not _tree_equal(p_params, s_params)):
        fail(f"[11f] the checkpointed run {s_out} differs from the run "
             f"without checkpoints {p_out}")
    print(f"[11f] run_experiment_sharded, world size 1 (nccl), "
          f"{cfg.num_splits} splits x {cfg.epochs} epochs in segments of "
          f"{SEGMENT_EVERY} bodies: one capture, {len(calls)} runner calls "
          f"(bodies, replays, capture ms) {[(b, r, _ms(c)) for b, r, c in calls]}"
          f"; equal bit for bit to the run without checkpoints (one capture "
          f"too): per_split {s_out['per_split']}, {len(s_params)} tensors; "
          f"{s_s:.1f} s against {p_s:.1f} s, epoch_ms_steady "
          f"{s_out['epoch_ms_steady']:.3f} against "
          f"{p_out['epoch_ms_steady']:.3f} ({CARD_LINE}); the segments "
          f"equal their eager form (graph=False) bit for bit")


def phase_sharded_zoo(wiki, g_adj, g_feats, g_labels, adj, feats, labels):
    """Phase 11 (``wiki``: ``wiki_graph``'s); returns (kernel rows,
    seconds)."""
    import torch

    t0 = time.perf_counter()
    rows, _ = phase_wiki_sharded(wiki)
    torch.cuda.empty_cache()
    rows.append(phase_genius_sharded_rocauc(g_adj, g_feats, g_labels))
    torch.cuda.empty_cache()
    phase_batchnorm_sharded(adj, feats, labels)
    torch.cuda.empty_cache()
    phase_segments_nccl(adj, feats, labels)
    torch.cuda.empty_cache()
    z_rows, _ = phase_zoo_sharded()
    rows += z_rows
    phase_resume_sharded()
    for row in rows:
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    secs = time.perf_counter() - t0
    print(f"[11] phase 11: {secs:.1f} s")
    return rows, secs


# ---------------------------------------------------------------------------
# Phase 13: the JAX package's single-card scenarios the card had not run,
# and its driver entry points
# ---------------------------------------------------------------------------

SCENARIO_EPOCHS = TIMED_EPOCHS   # 13a-e's timed runs (bench.py times 30)
# 13f: a few thousand nodes with rows above K1_HUB_DEGREE (top row 700,
# 8 hub rows); a wiki-shaped graph with a hub class (top row ~500)
SMALL_POWERLAW = dict(n=3000, pairs=30_000)
SMALL_WIKI = dict(n=3000, e=15_000, f=600, c=5, max_deg=600)
# 13g: entry()'s forward on the card against the CPU's, bf16 gathers: a
# gathered f32 projection an ulp apart can round to the neighbouring bf16
# value (tests/test_torch_entry.py BF16_TOL); dryrun at dropout 0 against
# the single card's step (f32 gathers, another summation order)
ENTRY_TOL = 2.0 ** -8
DRYRUN_TOL = 1e-5


def wiki_single_config(**over):
    """bench.py:773-824's ``bench_epoch_wiki``: acmgcnp, hidden 64,
    dropout 0.5, lr 0.01, weight decay 1e-3, ELL, bf16 gathers, f32 GEMMs,
    and the JAX package's single-chip memory ladder: the sequential loop,
    no hoist, remat, bf16 feature storage."""
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcnp", hidden=64, dropout=0.5, lr=0.01,
        weight_decay=1e-3, epochs=WARM_EPOCHS, early_stopping=0,
        selection="val_metric", operator_format="ell",
        spmm_dtype="bfloat16", gemm_dtype="float32", joint=False,
        hoist_first=False, remat=True, feature_dtype="bfloat16"), **over))


def linkx_config(name, **over):
    """bench.py:633-657's configuration of a LINKX-scale row
    (``bench.py:551-556``): acmgcn, hidden 64, dropout 0.5, lr 0.01,
    weight decay 1e-3, ELL, bf16 gathers, the joint loop, the hoist;
    penn94's GEMMs in bf16 (its row's ``gemm``), arxiv_year's in f32."""
    from acmgnn_tpu_torch.train.config import TrainConfig

    return TrainConfig(**dict(dict(
        model_type="acmgcn", hidden=64, dropout=0.5, lr=0.01,
        weight_decay=1e-3, epochs=WARM_EPOCHS, early_stopping=0,
        selection="val_metric", operator_format="ell",
        spmm_dtype="bfloat16",
        gemm_dtype="bfloat16" if name == "penn94" else "float32",
        joint=True, hoist_first=True), **over))


def _hp(c):
    """The [low | high] epilogue of a C-wide channel pair: the high half
    is z - Â z."""
    return [0.0] * c + [1.0] * c, [1.0] * c + [-1.0] * c


def _k1_cases(op, n, gen, widths):
    """K1's products on ``op`` for ``_k1_rows``, by kind: ("input", x)
    the gather of x, no epilogue; ("fwd", c) a [low | high] gather 2c wide;
    ("paired", c) the joint loop's [train | eval] pair of them, 4c wide;
    ("transpose", c) the prefix transpose of a 2c-wide pair (the signed
    operand pre-scaled, the identity path).  Returns a (half, case) pair
    for each, a case being ``_k1_rows``'s (operand, z, alpha, beta,
    name)."""
    import torch

    from acmgnn_tpu_torch.ops.ell import k1_operand

    out = []
    for kind, arg in widths:
        if kind == "input":
            out.append((op.fwd, (k1_operand(arg, torch.bfloat16), None, None,
                                 None, f"k1_spmm_w{arg.shape[1]}")))
            continue
        alpha, beta = _hp(arg)
        if kind == "paired":
            alpha, beta = alpha * 2, beta * 2
        d = len(alpha)
        z = torch.randn(n, d, generator=gen, device="cuda")
        if kind == "transpose":
            signed = (z * torch.tensor(beta, device="cuda")).to(
                torch.bfloat16)
            out.append((op.bwd, (k1_operand(signed, torch.bfloat16,
                                            op.bwd.pre_scale), z, alpha,
                                 [1.0] * d, f"k1_spmm_w{d}_transpose")))
        else:
            out.append((op.fwd, (k1_operand(z, torch.bfloat16), z, alpha,
                                 beta, f"k1_spmm_w{d}")))
    return out


def _k1_hub_share(half, xg, z, alpha, beta, name):
    """What a K1 call's hub class (its first lane class: rows above
    ``K1_HUB_DEGREE``, a block or 8 warps a row) costs alone, and its
    deepest row alone, each run as a half of its own (those rows'
    entries, writing rows 0..h-1), against the whole call: device ms and
    shares, printed."""
    import torch

    from acmgnn_tpu_torch.ops.ell import EllHalf, row_gather_spmm

    h = half.lane_classes[0]
    whole = device_ms(lambda: row_gather_spmm(half, xg, z=z, alpha=alpha,
                                              beta=beta), reps=5)
    if not h:
        print(f"  {name}: no hub rows (K1's hub class is empty); whole call "
              f"device {_ms(whole)}")
        return

    def alone(rows):
        end = int(half.indptr[rows])
        ids = half.row_ids[:rows].long()
        sub = EllHalf(
            indptr=half.indptr[:rows + 1], indices=half.indices[:end],
            row_ids=torch.arange(rows, dtype=torch.int32,
                                 device=half.indptr.device),
            vals=None if half.vals is None else half.vals[:end],
            row_scale=(None if half.row_scale is None
                       else half.row_scale[ids]),
            pre_scale=half.pre_scale, num_cols=half.num_cols)
        zz = None if z is None else z[ids]
        return device_ms(lambda: row_gather_spmm(sub, xg, z=zz, alpha=alpha,
                                                 beta=beta), reps=5)

    hub, top = alone(h), alone(1)
    nnz = int(half.indices.numel())
    hub_nnz = int(half.indptr[h])
    top_nnz = int(half.indptr[1])
    print(f"  {name}: hub class {h} rows, {hub_nnz} of {nnz} entries "
          f"({hub_nnz / nnz:.3f}), alone device {_ms(hub)} = "
          f"{(hub or 0) / (whole or 1):.3f} of the whole call's "
          f"{_ms(whole)}; its deepest row ({top_nnz} entries) alone "
          f"{_ms(top)} = {(top or 0) / (whole or 1):.3f} of the call "
          f"({CARD_LINE})")


def _path_kernel_rows(tag, suffix, op, lib, lib_t, cases, counts, path):
    """``_k1_rows`` for each of ``_k1_cases``'s products (K1 per element
    against the plain version, bit for bit against ``k1_order_replay``,
    timed beside its bound and ``torch.sparse.mm``), the hub class's
    share of each call, launches from the path's ``counts``."""
    rows = []
    for half, case in cases:
        xg, z, alpha, beta, name = case
        rows += _k1_rows(half, [case], suffix, lambda d: f"k1_spmm_w{d}",
                         lib_t if half is op.bwd else lib,
                         K1_REPLACES[2 if half is op.bwd
                                     else 0 if z is None else 1])
        _k1_hub_share(half, xg, z, alpha, beta, name + suffix)
    for r in rows:
        r.update(path=path, launches=counts.get(r["counter"], 0))
    print(f"{tag} K1 rows on the path's operator: "
          + "; ".join(f"{r['name']} device {_ms(r['device_ms'])}, launches "
                      f"{r['launches']}" for r in rows))
    return rows


def _operator_note(tag, op):
    from acmgnn_tpu_torch.ops.ell import K1_HUB_DEGREE

    deg = (op.fwd.indptr[1:] - op.fwd.indptr[:-1]).cpu()
    print(f"{tag} operator N={op.num_nodes} nnz={op.nnz}: max row "
          f"{int(deg.max())}, median {int(deg.median())}, "
          f"{int((deg > K1_HUB_DEGREE).sum())} rows above K1_HUB_DEGREE "
          f"{K1_HUB_DEGREE} holding "
          f"{float(deg[deg > K1_HUB_DEGREE].sum()) / float(deg.sum()):.3f} "
          f"of the entries; K1 lane classes fwd {op.fwd.lane_classes}")


def _libs(adj):
    """``torch.sparse.mm``'s operands (f32 CSR on the card): Â and Âᵀ."""
    from acmgnn_tpu_torch.ops.graph import row_normalized_adjacency

    a_hat = row_normalized_adjacency(adj)
    return _csr_on_card(a_hat), _csr_on_card(a_hat.T)


def _scenario(tag, data, cfg, masks_np, expected, path):
    """One scenario through ``drive_path`` (replays profiled); returns
    (counts, ms over the run, ms over the looped bodies, the prepared ops
    and x, the profile's {"wall", "busy", ...})."""
    keep, prof = {}, {}
    counts, ms_run, _, _, ms_loop = drive_path(
        tag, data, cfg, masks_np, SCENARIO_EPOCHS, expected,
        profile_ops=prof, replays=True, keep=keep)
    print(f"{tag} {path}: {ms_run:.3f} ms/epoch over the run, "
          f"{_ms(ms_loop)} over the looped bodies; replays profiled "
          f"{_ms(prof.get('wall'))} ms/epoch, device busy "
          f"{_ms(prof.get('busy'))} ({CARD_LINE})")
    return counts, ms_run, ms_loop, keep, prof


def phase_wiki_single(wiki):
    """[13a] wiki on one card as the JAX package runs it
    (``wiki_single_config``: sequential, no hoist, remat, bf16 features)
    on 11a's graph: the path's run, then K1 at its widths (w128 and its
    transpose, w10 and its transpose) and K2/K3 with LayerNorm at d64 and
    d5 on its 1,925,342 rows."""
    import torch

    cfg = wiki_single_config()
    path = ("13a: wiki on one card (sequential, remat, bf16 features), "
            f"{SCENARIO_EPOCHS} timed epochs")
    print(f"[13a] memory reckoned beforehand: features "
          f"{2 * wiki.num_nodes * 600 / 1e9:.2f} GB bf16 on the card, their "
          f"f32 copy for the projection {4 * wiki.num_nodes * 600 / 1e9:.2f}"
          f" GB while it runs; the sharded hoisted form (11a) peaked at "
          f"16.76 GiB (PERF.md)")
    counts, ms_run, ms_loop, keep, prof = _scenario(
        "[13a]", wiki, cfg, _masks(wiki.num_nodes), lambda b:
        sequential_counts(b, "k1_spmm", None, k4=False, nclass=5,
                          remat=True), path)
    op, n = keep["ops"].adj_low, wiki.num_nodes
    del keep
    torch.cuda.empty_cache()
    _operator_note("[13a]", op)
    lib, lib_t = _libs(wiki.adj)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = _path_kernel_rows(
        "[13a]", "@wiki1", op, lib, lib_t,
        _k1_cases(op, n, gen, [("fwd", 64), ("transpose", 64), ("fwd", 5),
                               ("transpose", 5)]), counts, path)
    del lib, lib_t, op
    torch.cuda.empty_cache()
    a_rows = _attention_instance_rows(n, gen, (True,) * 3, True, (64, 5),
                                      "@wiki1")
    for r in a_rows:
        r.update(path=path, launches=counts.get(r["counter"], 0))
    return rows + a_rows, (ms_run, ms_loop, prof)


def phase_linkx_scenario(name, adj, feats, labels):
    """[13b] penn94 / [13c] arxiv_year (``linkx_config``): the path's run
    on bench.py's stand-in, then K1 at every width it launches and K2/K3
    without LayerNorm at d64 and d=C on its rows."""
    import torch

    from acmgnn_tpu_torch.ops.ell import k1_operand
    from acmgnn_tpu_torch.ops.graph import GraphData

    tag = "[13b]" if name == "penn94" else "[13c]"
    cfg = linkx_config(name)
    f, c = feats.shape[1], int(labels.max()) + 1
    data = GraphData(f"{name}-scale", adj, feats, labels)
    path = (f"{tag[1:-1]}: {name} (acmgcn, joint, hoist, bf16 gathers, "
            f"{cfg.gemm_dtype} GEMMs), {SCENARIO_EPOCHS} timed epochs")
    counts, ms_run, ms_loop, keep, prof = _scenario(
        tag, data, cfg, _masks(adj.shape[0], seed=1),
        lambda b: joint_counts(b, "k1_spmm", f, nclass=c), path)
    op, x, n = keep["ops"].adj_low, keep["x"], adj.shape[0]
    del keep
    _operator_note(tag, op)
    lib, lib_t = _libs(adj)
    gen = torch.Generator(device="cuda").manual_seed(13)
    suffix = f"@{name}"
    rows = []
    if f > 128:
        # the eval branch's set-up gather of the features (x_agg): the
        # plain version in row chunks, as 9a
        row = _k1_wide_row(op.fwd, k1_operand(x, torch.bfloat16),
                           f"k1_spmm_w{f}", suffix, lib, replay=True)
        row.update(path=path, launches=counts.get(row["counter"], 0))
        rows.append(row)
        widths = [("fwd", 64), ("transpose", 64)]
    else:
        widths = [("input", x)]
    rows += _path_kernel_rows(tag, suffix, op, lib, lib_t,
                              _k1_cases(op, n, gen, widths
                                        + [("paired", c), ("transpose", c)]),
                              counts, path)
    del lib, lib_t, op, x
    torch.cuda.empty_cache()
    a_rows = _attention_instance_rows(n, gen, (True,) * 3, False, (64, c),
                                      suffix)
    for r in a_rows:
        r.update(path=path, launches=counts.get(r["counter"], 0))
    return rows + a_rows, (ms_run, ms_loop, prof)


def phase_twitch_scenario(graph, headline_rows):
    """[13d] powerlaw / [13e] banded: the headline configuration on
    bench.py's twitch-shaped graph (``twitch_gamers_scale_graph(graph=)``),
    then K1 at w7, w8 and w4 on its operator beside the uniform
    headline's phase-2 rows (K2/K3 are phase 2's: the same rows and
    widths)."""
    import torch

    from acmgnn_tpu_torch.data.registry import row_normalize_features
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    tag = "[13d]" if graph == "powerlaw" else "[13e]"
    t0 = time.perf_counter()
    adj, feats, labels = twitch_gamers_scale_graph(0, graph=graph)
    print(f"{tag} {graph} twitch-shaped graph N={adj.shape[0]} "
          f"edges={adj.nnz} ({time.perf_counter() - t0:.1f} s on the host)")
    data = GraphData(f"twitch-gamers-scale-{graph}", adj, feats, labels)
    path = (f"{tag[1:-1]}: the headline on the {graph} graph, "
            f"{SCENARIO_EPOCHS} timed epochs")
    counts, ms_run, ms_loop, keep, prof = _scenario(
        tag, data, headline_config(), _masks(adj.shape[0]),
        lambda b: joint_counts(b, "k1_spmm", 7), path)
    op, n = keep["ops"].adj_low, adj.shape[0]
    del keep
    _operator_note(tag, op)
    lib, lib_t = _libs(adj)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x_in = torch.from_numpy(row_normalize_features(feats)).cuda()
    rows = _path_kernel_rows(
        tag, f"@{graph}", op, lib, lib_t,
        _k1_cases(op, n, gen, [("input", x_in), ("paired", 2),
                               ("transpose", 2)]), counts, path)
    uniform = {r["name"]: r["device_ms"] for r in headline_rows}
    print(f"{tag} K1 on the {graph} graph against the uniform headline "
          f"(phase 2, same widths, device ms): " + "; ".join(
              f"{r['name']} {_ms(r['device_ms'])} / "
              f"{_ms(uniform.get(r['counter']))} = "
              f"{(r['device_ms'] or 0) / (uniform.get(r['counter']) or 1):.3f}"
              for r in rows) + f" ({CARD_LINE})")
    return rows, (ms_run, ms_loop, prof)


def phase_scenarios_card_vs_cpu():
    """[13f] Card against CPU, dropout 0: phase 4's configuration on a
    small powerlaw graph with rows above ``K1_HUB_DEGREE`` (f32 gathers,
    20 epochs, 1e-4); the single-card wiki configuration on a small
    wiki-shaped graph (sequential, remat, bf16 features; hidden 16, lr
    1e-3 without decay on labels from the features, as 6c), with f32
    gathers within 1e-4 and with its bf16 gathers within 1e-2 (a bf16
    rounding that a last-bit f32 difference flips moves a value by 2^-8:
    7c's bf16 bound)."""
    from acmgnn_tpu_torch.data.synthetic_scale import (
        twitch_gamers_scale_graph,
        wiki_scale_graph,
    )
    from acmgnn_tpu_torch.ops.ell import K1_HUB_DEGREE
    from acmgnn_tpu_torch.ops.graph import GraphData

    for name, (adj, feats, labels) in (
            ("powerlaw", twitch_gamers_scale_graph(0, graph="powerlaw",
                                                   **SMALL_POWERLAW)),
            ("wiki", wiki_scale_graph(**SMALL_WIKI, device=CARD))):
        deg = np.diff(adj.indptr)
        print(f"[13f {name}] N={adj.shape[0]} nnz(A)={adj.nnz}: max row "
              f"{int(deg.max())}, {int((deg > K1_HUB_DEGREE).sum())} rows "
              f"above K1_HUB_DEGREE")
        if not (deg > K1_HUB_DEGREE).any():
            fail(f"[13f {name}] no row above K1_HUB_DEGREE")
        feats = np.abs(feats)
        n = adj.shape[0]
        if name == "powerlaw":
            card_vs_cpu("[13f powerlaw]", GraphData(name, adj, feats, labels),
                        knob_check_config(), _masks(n))
            continue
        labels = np.searchsorted(np.quantile(feats[:, 0], [0.2, 0.4, 0.6,
                                                           0.8]),
                                 feats[:, 0]).astype(np.int32)
        data = GraphData(name, adj, feats, labels)
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
            card_vs_cpu(f"[13f wiki, {dtype} gathers]", data,
                        wiki_single_config(hidden=16, dropout=0.0, lr=1e-3,
                                           weight_decay=0.0, epochs=20,
                                           spmm_dtype=dtype), _masks(n),
                        tol=tol)


def _dryrun_reference(n):
    """The dryrun's step on one card (``dryrun_step`` on the whole graph,
    dropout 0): (loss, state_dict on the host)."""
    import torch

    from acmgnn_tpu_torch import entry as port_entry
    from acmgnn_tpu_torch.ops.graph import precompute_operators

    adj, feats, labels = port_entry.dryrun_graph(n)
    ops = precompute_operators(adj, structure_info=True, fmt="ell").to(CARD)
    model = port_entry.dryrun_model(adj.shape[0], 0.0, CARD)
    loss = port_entry.dryrun_step(
        model, ops, torch.from_numpy(feats).to(CARD),
        torch.from_numpy(labels.astype(np.int64)).to(CARD),
        torch.ones(adj.shape[0], dtype=torch.bool, device=CARD))
    return loss, {k: v.detach().cpu() for k, v in model.state_dict().items()}


def phase_entry_driver():
    """[13g] The port's driver entry points (``acmgnn_tpu_torch/entry.py``):
    ``entry()``'s forward on the card (its default) against the CPU's
    within ``ENTRY_TOL`` of the logits' scale, with K1 and K2 launched;
    ``dryrun(1)`` over NCCL in this process (its mini-split captured
    once) at its dropout 0.1, then ``dryrun(1)`` and ``dryrun(4)`` (four
    gloo ranks on the one card) at dropout 0, each step's loss finite and
    its loss and parameters within ``DRYRUN_TOL`` of the single card's
    step; the mini-splits' results finite."""
    import torch

    from acmgnn_tpu_torch import entry as port_entry
    from acmgnn_tpu_torch.ops import kernels

    kernels.reset_launches()
    fn, args = port_entry.entry()
    if args[1].device.type != "cuda":
        fail("[13g] entry() did not place its tensors on the card")
    with torch.no_grad():
        got = fn(*args).cpu()
    counts = without_loop_kernels(dict(kernels.launches))
    fn, args = port_entry.entry("cpu")
    with torch.no_grad():
        want = fn(*args)
    err = float((got - want).abs().max())
    tol = ENTRY_TOL * max(1.0, float(want.abs().max()))
    print(f"[13g] entry() forward {tuple(got.shape)} on the card against "
          f"the CPU: max_abs_err {err:.3e} (tolerance {tol:.3e}); launches "
          f"{json.dumps(counts, sort_keys=True)}")
    # the graph keeps its self-pairs, so A + I is not row-uniform: valued
    # halves (JAX's entry builds the same operator)
    want_counts = {"k1_spmm_w128_valued": 1, "k1_spmm_w16_valued": 1,
                   "k2_attn_fwd_d64": 1, "k2_attn_fwd_d8": 1}
    if not (err <= tol and torch.isfinite(got).all()):
        fail("[13g] entry() on the card disagrees with the CPU")
    if counts != want_counts:
        fail(f"[13g] entry() launches {counts} != expected {want_counts}")
    t0 = time.perf_counter()
    with _captured_runs("[13g dryrun(1)]") as calls:
        out = port_entry.dryrun(1)
    print(f"[13g] dryrun(1) over {out['backend']}: loss {out['loss']:.6f}, "
          f"mini-split test {out['mini_split']['test_mean']:.4f}, runner "
          f"calls (bodies, replays, capture ms) {calls} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not math.isfinite(out["loss"]):
        fail("[13g] dryrun(1): non-finite loss")
    for n in (1, 4):
        t0 = time.perf_counter()
        out = port_entry.dryrun(n, dropout=0.0)
        secs = time.perf_counter() - t0
        loss, params = _dryrun_reference(n)
        worst = max(float((out["params"][k] - v).abs().max())
                    for k, v in params.items())
        d_loss = abs(out["loss"] - loss)
        print(f"[13g] dryrun({n}) over {out['backend']} at dropout 0 "
              f"({secs:.1f} s with start-up): loss {out['loss']:.6f}, the "
              f"single card {loss:.6f}; max |Δparam| {worst:.3e}, |Δloss| "
              f"{d_loss:.3e} (tolerance {DRYRUN_TOL:g}); mini-split test "
              f"{out['mini_split']['test_mean']:.4f}")
        if not (math.isfinite(out["loss"]) and worst <= DRYRUN_TOL
                and d_loss <= DRYRUN_TOL * max(1.0, abs(loss))):
            fail(f"[13g] dryrun({n}) disagrees with the single card")


def phase_scenarios(wiki, p_adj, p_feats, p_labels, headline_rows):
    """Phase 13; returns (kernel rows, {path: (ms over the run, over the
    looped bodies, profile)}, seconds)."""
    import torch

    from acmgnn_tpu_torch.data.synthetic_scale import linkx_scale_graph

    t0 = time.perf_counter()
    rows, ms = [], {}

    def lap(tag):
        torch.cuda.empty_cache()
        print(f"[t] {tag} done at {time.perf_counter() - t0:.1f} s of "
              f"phase 13")

    got, ms["wiki1"] = phase_wiki_single(wiki)
    rows += got
    lap("13a")
    got, ms["penn94"] = phase_linkx_scenario("penn94", p_adj, p_feats,
                                             p_labels)
    rows += got
    lap("13b")
    t1 = time.perf_counter()
    a_adj, a_feats, a_labels = linkx_scale_graph("arxiv_year")
    print(f"[13c] arxiv_year-shaped graph N={a_adj.shape[0]} edges="
          f"{a_adj.nnz} F={a_feats.shape[1]} ({time.perf_counter() - t1:.1f}"
          f" s)")
    got, ms["arxiv_year"] = phase_linkx_scenario("arxiv_year", a_adj,
                                                 a_feats, a_labels)
    rows += got
    lap("13c")
    for graph in ("powerlaw", "banded"):
        got, ms[graph] = phase_twitch_scenario(graph, headline_rows)
        rows += got
        lap("13d" if graph == "powerlaw" else "13e")
    phase_scenarios_card_vs_cpu()
    lap("13f")
    phase_entry_driver()
    for row in rows:
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    secs = time.perf_counter() - t0
    print(f"[13] phase 13: {secs:.1f} s")
    return rows, ms, secs


def _instance_launches(row, pp, sym, dense, zoo):
    """The launches of a 9a row's instance, and the run they come from:
    the symmetric headline runs (9b sym) for the valued K1 and K5,
    penn94_pp (9b) for the structure operator's K1, and for K2/K3 the run
    named in ``INSTANCE_RUNS`` (penn94_pp, 9c's dense runs or 9d's
    zoo)."""
    name, counter = row["name"], row["counter"]
    if name.endswith("@twitch-sym"):
        key = ("coo", "float32") if counter.startswith("k5") else (
            "ell", "bfloat16" if "_bf16@" in name else "float32")
        return (sym[key][0].get(counter, 0),
                f"timed 9a; launches 9b: the headline, symmetric "
                f"normalization, {key[0]} {key[1]}, {SYM_EPOCHS} epochs")
    phase, case = row.get("run", ("9b", "penn94_pp"))
    if phase == "9b":
        return (pp[0].get(counter, 0),
                f"timed 9a and launches 9b: penn94_pp's rows, {PP_EPOCHS} "
                f"epochs")
    n = CHAMELEON["n"] if phase == "9c" else ZOO_N
    counts, epochs = ((dense[case][0], DENSE_EPOCHS) if phase == "9c" else
                      (zoo[case], ZOO_EPOCHS))
    return (counts.get(counter, 0),
            f"timed 9a and launches {phase}: {case}, {n} rows, {epochs} "
            f"epochs")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import acmgnn_tpu_torch  # noqa: F401  (fails outside the repo)
    from acmgnn_tpu_torch.data.synthetic_scale import (
        linkx_scale_graph,
        twitch_gamers_scale_graph,
        wiki_scale_graph,
    )
    from acmgnn_tpu_torch.ops.graph import GraphData

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def lap(phases):
        print(f"[t] phases {phases} done at "
              f"{time.perf_counter() - t_start:.1f} s")

    phase_environment()
    t0 = time.perf_counter()
    adj, feats, labels = twitch_gamers_scale_graph(0)
    print(f"[2] twitch-shaped graph N={adj.shape[0]} edges={adj.nnz} "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = phase_kernels(adj, feats)
    counts, (ms_epoch, ms_replay) = phase_main_path(adj, feats, labels)
    for row in rows:
        row.update(path="headline (twitch-gamers, joint, ELL)",
                   launches=counts.get(row["counter"], 0))
    l_rows = phase_loop_kernels(counts)
    for row in l_rows:
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    phase_card_vs_cpu()
    lap("1-4, 12")

    t0 = time.perf_counter()
    g_adj, g_feats, g_labels = linkx_scale_graph("genius")
    g_masks = _masks(g_adj.shape[0], seed=1)
    print(f"[5a] genius-shaped graph N={g_adj.shape[0]} edges={g_adj.nnz} "
          f"({time.perf_counter() - t0:.1f} s)")
    g_rows = phase_kernels(g_adj, g_feats, tag="[5a]", suffix="@genius",
                           use_ln=False, with_coo=True)
    g_rows += phase_rocauc_kernel(g_labels, g_masks)
    paths = phase_genius_paths(g_adj, g_feats, g_labels, g_masks)
    phase_genius_card_vs_cpu()
    for row in g_rows:
        key = "coo" if row["counter"].startswith("k5") else "ell"
        row.update(path=f"genius ({key}, joint)",
                   launches=paths[key][0].get(row["counter"], 0))
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    lap(5)

    s_rows = phase_sharded_kernels(adj, feats)
    s1_counts, s_ms = phase_sharded_main_path(adj, feats, labels, ms_epoch)
    s_counts = phase_sharded_gloo()
    for row in s_rows:
        run = row.pop("run")
        if run is None:             # K6 at world size 1: phase 6b's shapes
            row.update(path="sharded headline, world size 1 (nccl): "
                            "launches phase 6b, timed phase 6a",
                       launches=s1_counts.get(row["counter"], 0))
        else:
            dtype = "float32" if run[1] == "coo" else "bfloat16"
            row.update(path=f"timed phase 6a: headline graph, {SHARDED_P} "
                            f"ranks in one process, rank 0; launches phase "
                            f"6c {run[0]} {run[1]} {dtype}: 20k-node graph, "
                            f"{SHARDED_P} gloo ranks, {SHARDED_CHECK_EPOCHS} "
                            f"epochs, rank 0",
                       launches=s_counts[run + (dtype,)].get(
                           row["counter"], 0))
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    lap(6)

    p_rows = phase_probe()
    entry = phase_entry_points(adj, feats, labels)
    phase_knobs_card_vs_cpu()
    phase_optimizer_check()
    capture = phase_capture(adj, feats, labels, g_adj, g_feats, g_labels,
                            g_masks)
    lap("7-8")

    t0 = time.perf_counter()
    p_adj, p_feats, p_labels = linkx_scale_graph("penn94_pp")
    print(f"[9a] penn94_pp-shaped graph N={p_adj.shape[0]} edges="
          f"{p_adj.nnz} F={p_feats.shape[1]} "
          f"({time.perf_counter() - t0:.1f} s)")
    i_rows = phase_instances(adj, feats, p_adj)
    phase_k1_crossover(adj, p_adj)
    pp = phase_penn94_pp(p_adj, p_feats, p_labels)
    sym = phase_symmetric_paths(adj, feats, labels)
    dense = phase_dense_paths()
    zoo = phase_zoo()
    for row in i_rows:
        row["launches"], row["path"] = _instance_launches(row, pp, sym,
                                                          dense, zoo)
        if row["launches"] == 0:
            fail(f"{row['name']} was not launched on its path")
    lap(9)
    cli_out = phase_cli(paths["ell"][4])
    lap(10)
    t0 = time.perf_counter()
    wiki = GraphData("wiki-scale", *wiki_scale_graph(**WIKI, device=CARD))
    print(f"[11a] wiki-shaped graph N={wiki.num_nodes} nnz(A)="
          f"{wiki.adj.nnz} F={WIKI['f']}: {time.perf_counter() - t0:.1f} s "
          f"on the host (the features drawn on the card)")
    w_rows, w_secs = phase_sharded_zoo(wiki, g_adj, g_feats, g_labels, adj,
                                       feats, labels)
    lap(11)
    sc_rows, sc_ms, sc_secs = phase_scenarios(wiki, p_adj, p_feats,
                                              p_labels, rows)
    del wiki, p_feats
    lap(13)
    steady = {k: entry[k][0]["epoch_ms_steady"]
              for k in ("experiment", "plain", "remat", "adamw", "bf16",
                        "rcm")}
    print(f"[done] {CARD_LINE}: {time.perf_counter() - t_start:.1f} s; "
          f"ms/epoch over a "
          f"whole timed run, set-up included (over its replays): main path "
          f"{ms_epoch:.3f} ({ms_replay:.3f}) of {TIMED_EPOCHS} epochs; "
          f"genius joint ell {paths['ell'][1]:.3f} ({paths['ell'][4]:.3f}), "
          f"coo {paths['coo'][1]:.3f} ({paths['coo'][4]:.3f}) of "
          f"{GENIUS_TIMED_EPOCHS}, sequential {paths['seq'][1]:.3f} "
          f"({paths['seq'][4]:.3f}) of {GENIUS_SEQ_EPOCHS}; the stop-flag read "
          f"{paths['stop_flag_ms']:+.3f} ms/epoch; sharded headline, world "
          f"size 1 {s_ms:.3f} ms/epoch; run_experiment steady ms/epoch "
          + ", ".join(f"{k} {v:.3f}" for k, v in steady.items())
          + f"; stepwise captured {entry['stepwise']['epoch_ms_steady']:.3f}"
          f" (pairs, eager / captured medians "
          f"{float(np.median(entry['stepwise']['pairs']['eager'])):.3f} / "
          f"{float(np.median(entry['stepwise']['pairs']['captured'])):.3f})"
          f"; eager "
          f"/ captured run / captured replays ms/epoch (8b medians): "
          + ", ".join(f"{k} {e:.3f} / {c:.3f} / {r:.3f}"
                      for k, (e, c, r) in capture["pairs"].items())
          + f"; penn94_pp {pp[1]:.3f} ({pp[4]:.3f}) of {PP_EPOCHS}; "
          + "symmetric headline " + ", ".join(
              f"{f} {d} {v[1]:.3f} ({v[4]:.3f})" for (f, d), v in
              sym.items())
          + "; dense " + ", ".join(f"{k} {v[1]:.3f} ({v[2]:.3f})"
                                   for k, v in dense.items())
          + f"; cli train genius {cli_out['whole'][-1]:.3f} "
          f"({cli_out['replays'][-1]:.3f}), load {cli_out['load_s']:.2f} s, "
          f"phase 10 {cli_out['seconds']:.1f} s; phase 11 {w_secs:.1f} s; "
          + "phase 13 ms/epoch over the run (over the looped bodies; "
          "profiled replays, device busy) " + ", ".join(
              f"{k} {r:.3f} ({_ms(b)}; {_ms(p.get('wall'))}, "
              f"{_ms(p.get('busy'))})" for k, (r, b, p) in sc_ms.items())
          + f", phase 13 {sc_secs:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "path")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + (("form",) if "form" in r else ())}
        for r in rows + l_rows + g_rows + s_rows + p_rows + i_rows
        + w_rows + sc_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
