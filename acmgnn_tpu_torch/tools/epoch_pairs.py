"""Steady ms/epoch of two trees of the port, in alternating pairs on one card.

    python -m acmgnn_tpu_torch.tools.epoch_pairs --parent DIR
        [--pairs 6] [--epochs 20] [--configs headline genius]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``).  For each configuration, one worker
process per tree builds that tree's kernels, the graph and the model, and
warms up; then each time it is asked it runs ``--epochs`` epochs of the
joint training loop and reports the steady ms/epoch (host clock around the
run, ending in ``torch.cuda.synchronize()``).  The two workers take turns,
parent, this tree, this tree, parent, ..., so that both see the same
host; both hold their data on the card, one runs at a time.  Then each
worker runs ``chip_smoke.PROFILE_EPOCHS`` epochs under torch.profiler and
reports its device operations by name; the names whose count per loop
body differs between the trees are printed.  Prints every run, the
paired differences (this tree minus the parent), their median and range,
and one JSON line.

The configurations, graphs and masks are this tree's ``chip_smoke.py``'s
(``headline_config``, ``genius_config``, ``_masks``), built in each worker
from its own tree's ``TrainConfig``: the headline (ACM-GCN+ with LayerNorm
on the twitch-gamers-shaped graph, joint loop, ELL, bf16 gathers) and
genius (ACM-GCN without LayerNorm, BCE and ROC-AUC, on the genius-shaped
stand-in, joint ELL).  The worker uses only entry points both trees have
(``prepare_data``, ``build_model``, ``make_split_runner``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]


def _smoke():
    """This tree's ``chip_smoke.py``, loaded by path (its functions import
    ``acmgnn_tpu_torch`` when called, from whichever tree is first on
    ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def worker(root: str, name: str, epochs: int) -> None:
    """Serve ``run`` and ``profile`` requests on stdin for the tree at
    ``root``."""
    sys.path.insert(0, root)
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from acmgnn_tpu_torch.data.synthetic_scale import (
        linkx_scale_graph,
        twitch_gamers_scale_graph,
    )
    from acmgnn_tpu_torch.ops import kernels
    from acmgnn_tpu_torch.ops.graph import GraphData
    from acmgnn_tpu_torch.train.trainer import (
        build_model,
        make_split_runner,
        prepare_data,
    )

    import acmgnn_tpu_torch

    if Path(acmgnn_tpu_torch.__file__).resolve().parents[1] != \
            Path(root).resolve():
        raise SystemExit(f"worker imported {acmgnn_tpu_torch.__file__}, "
                         f"not the tree at {root}")
    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    if name == "headline":
        adj, feats, labels = twitch_gamers_scale_graph(0)
        masks_np = smoke._masks(adj.shape[0])
        cfg = smoke.headline_config()
    else:
        adj, feats, labels = linkx_scale_graph("genius")
        masks_np = smoke._masks(adj.shape[0], seed=1)
        cfg = smoke.genius_config()
    _, ops, x, y, y1h, nclass = prepare_data(
        GraphData(name, adj, feats, labels), cfg)
    masks = tuple(torch.from_numpy(m).cuda() for m in masks_np)
    model = build_model(cfg, x.shape[1], nclass)
    make_split_runner(model, dataclasses.replace(cfg, epochs=2))(
        ops, x, y, masks, seed=1, labels_onehot=y1h)
    torch.cuda.synchronize()
    runner = make_split_runner(model, dataclasses.replace(cfg, epochs=epochs))
    print("ready", flush=True)
    seed = 2
    for line in sys.stdin:
        if line.strip() == "profile":
            prof_cfg = dataclasses.replace(cfg, epochs=smoke.PROFILE_EPOCHS)
            bodies = smoke.PROFILE_EPOCHS + (1 if cfg.joint else 0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                make_split_runner(model, prof_cfg)(
                    ops, x, y, masks, seed=seed, labels_onehot=y1h)
                torch.cuda.synchronize()
            events = list(prof.events())
            start, replays = smoke.replay_window(events)
            per = replays or bodies
            per_body = {key: (count / per, us / 1e3 / per) for key, (us, count)
                        in smoke.device_ops(events, start)[0].items()}
            print("ops " + json.dumps(per_body), flush=True)
            continue
        if line.strip() != "run":
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = runner(ops, x, y, masks, seed=seed, return_state=True,
                          labels_onehot=y1h)
        torch.cuda.synchronize()
        seed += 1
        print(f"ms {1e3 * (time.perf_counter() - t0) / state.epoch:.6f}",
              flush=True)


def _start(root: Path, name: str, epochs: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(HERE), "--worker", str(root), name, str(epochs)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def _expect(proc: subprocess.Popen, word: str, who: str) -> str:
    line = proc.stdout.readline()
    if not line.startswith(word):
        raise SystemExit(f"epoch_pairs: {who} worker said {line!r} "
                         f"(exit {proc.poll()})")
    return line


def pairs(parent: Path, name: str, n_pairs: int, epochs: int) -> dict:
    procs = {"parent": _start(parent, name, epochs),
             "change": _start(REPO, name, epochs)}
    try:
        for who, proc in procs.items():
            _expect(proc, "ready", who)
        ms = {"parent": [], "change": []}
        for i in range(n_pairs):
            for who in (("parent", "change") if i % 2 == 0
                        else ("change", "parent")):
                procs[who].stdin.write("run\n")
                procs[who].stdin.flush()
                ms[who].append(float(_expect(procs[who], "ms",
                                             who).split()[1]))
        ops = {}
        for who, proc in procs.items():
            proc.stdin.write("profile\n")
            proc.stdin.flush()
            ops[who] = json.loads(_expect(proc, "ops", who)[4:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.stdin.close()
                proc.wait(timeout=120)
    diffs = [c - p for p, c in zip(ms["parent"], ms["change"])]
    out = {"config": name, "epochs_per_run": epochs, "pairs": n_pairs,
           "parent_ms": ms["parent"], "change_ms": ms["change"],
           "diffs_ms": diffs, "median_diff_ms": statistics.median(diffs),
           "min_diff_ms": min(diffs), "max_diff_ms": max(diffs),
           "ops_per_body": {who: sum(n for n, _ in v.values())
                            for who, v in ops.items()},
           "device_ms_per_body": {who: sum(ms for _, ms in v.values())
                                  for who, v in ops.items()},
           "ops_differing": {
               key: [ops[who].get(key, (0, 0))[0] for who in ("parent",
                                                             "change")]
               for key in sorted(set(ops["parent"]) | set(ops["change"]))
               if ops["parent"].get(key, (0, 0))[0]
               != ops["change"].get(key, (0, 0))[0]}}
    print(f"[{name}] ms/epoch over {epochs} epochs a run, {n_pairs} "
          f"alternating pairs: parent {ms['parent']}; this tree "
          f"{ms['change']}; this tree minus parent {diffs}: median "
          f"{out['median_diff_ms']:+.4f}, range {min(diffs):+.4f} to "
          f"{max(diffs):+.4f}", flush=True)
    print(f"[{name}] per loop body (torch.profiler): device operations "
          f"parent {out['ops_per_body']['parent']:.2f}, this tree "
          f"{out['ops_per_body']['change']:.2f}; device busy ms parent "
          f"{out['device_ms_per_body']['parent']:.4f}, this tree "
          f"{out['device_ms_per_body']['change']:.4f}; the names whose "
          f"count differs (parent, this tree):", flush=True)
    for key, (a, b) in out["ops_differing"].items():
        print(f"  {a:6.2f} {b:6.2f}  {key[:150]}", flush=True)
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--configs", nargs="+", default=["headline", "genius"],
                    choices=["headline", "genius"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("epoch_pairs: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    results = [pairs(args.parent.resolve(), name, args.pairs, args.epochs)
               for name in args.configs]
    print(json.dumps({"epoch_pairs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
