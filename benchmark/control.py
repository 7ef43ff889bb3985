"""The readings that the limits of ``correct`` are set from (``PERF.md``),
for one cell, in one process; the benchmark's own runs do not run this::

    python3 -m benchmark.control --workload <name> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--device cuda]

- For each of ``--seeds``: the program's set-up and warm-up split, as a
  run makes them, against the reference (the lower readings).
- For each of ``--control-seeds``: the control, the reference computed
  in the precision below the configuration's (``CONTROL``: TF32 for f32
  projections, float8 for bf16 ones), put in the program's place; and
  the fault "half of the batch left out, the mean taken over the rest",
  the reference trained on half its training nodes, put in the program's
  place; and the fault "an answer altered where it is produced", the
  reference's validation loss taken at the parameters before each step.
  (The fault "a step that returns its state unchanged" reads
  ``change_gap`` = 1 by the measure and needs no run.)
- For each of ``--order-seeds``: two sound f32 orders of the reference
  against each other: the reference trains three steps, and the
  reference with every projection summed in two halves of its inner
  dimension follows that trajectory as it follows the program's; the
  compared numbers by the worst and by the median leaf (how far rounding
  alone moves each number, ``PERF.md``).

Each reading is one JSON line on standard output; the last line gives,
for each number, the largest program reading and the smallest reading of
the control and of the fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, harness, inputs, manifest

CONTROL = {"float32": "tf32", "bfloat16": "float8"}


def half_batch(masks):
    """The training mask with every second training node left out."""
    train = masks[0]
    idx = torch.nonzero(train).flatten()
    half = torch.zeros_like(train)
    half[idx[::2]] = True
    return (half, *masks[1:])


def trainer(cell, seed: int, device, adj, lower=None, fault=None,
            on=None):
    """The reference's trainer of the run seeded ``seed`` (inputs made on
    ``device``, computed on ``on``), lowered to ``lower`` or with
    ``fault``."""
    inp = inputs.Inputs(cell.config, cell.traffic, seed, device, adj,
                        cell.reference)
    masks = inp.masks(0)
    if fault == "half_batch":
        masks = half_batch(masks)
    return harness.reference_trainer(cell, inp, adj, lower, on, masks), inp


def split_mm(a, w):
    """An f32 projection summed in two halves of its inner dimension."""
    k = a.shape[1] // 2
    return a[:, :k] @ w[:k] + a[:, k:] @ w[k:]


def second_order(cell, seed: int, device, adj) -> dict:
    """The compared numbers, by the worst and by the median leaf, of the
    reference followed by itself with its projections summed in another
    order (f32 configurations)."""
    if cell.config["model"]["gemm_dtype"] != "float32":
        raise ValueError("a second order is summed for f32 projections")
    ref, inp = trainer(cell, seed, device, adj)
    traj = cell.reference.train(ref, inp.params(0), check.STEPS)
    ref.mm = split_mm
    followed = cell.reference.follow(ref, traj)
    return {leaf: check.gaps(followed, leaf) for leaf in check.LEAF}


def in_the_programs_place(cell, seed: int, device, adj, on=None, **kw):
    """The compared numbers of a trajectory other than the program's
    (the control, a fault, or the reference on ``on``), followed by the
    reference as the program's is."""
    stale = kw.get("fault") == "stale_eval"
    if stale:
        kw = {k: v for k, v in kw.items() if k != "fault"}
    other, inp = trainer(cell, seed, device, adj, on=on, **kw)
    p0 = {k: v.to(other.x.device) for k, v in inp.params(0).items()}
    traj = cell.reference.train(other, p0, check.STEPS)
    if stale:    # each evaluation reads the parameters before its step
        traj["val_losses"] = [other.val_loss(p)
                              for p in traj["params"][:check.STEPS - 1]]
    if on is not None:      # back to where the reference runs
        traj = {k: ([{n: t.to(device) for n, t in d.items()} for d in v]
                    if k in ("params", "m", "v") else v)
                for k, v in traj.items()}
    ref, _ = trainer(cell, seed, device, adj)
    followed = cell.reference.follow(ref, traj)
    return (check.gaps(followed, cell.workload.get("leaf", "worst")),
            followed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="",
                   help="seeds whose reference is also computed on the "
                        "CPU: how far two sound orders of the same "
                        "arithmetic part")
    p.add_argument("--order-seeds", default="",
                   help="seeds on which the reference is followed by "
                        "itself summed in another order")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = manifest.Cell(args.workload, manifest.manifest())
    dev = torch.device(args.device)
    adj = inputs.graph(cell.config, cell.traffic, dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lower = CONTROL[cell.config["model"]["gemm_dtype"]]
    worst = {k: 0.0 for k in check.NUMBERS}
    least = {side: {k: float("inf") for k in check.NUMBERS}
             for side in ("control", "half_batch", "stale_eval")}
    for s in seeds:
        t = time.perf_counter()
        run = harness.Run(cell, s, dev, t)
        run.setup(adj)
        run.free_program()
        numbers = run.compare()
        for k in check.NUMBERS:
            worst[k] = max(worst[k], numbers[k])
        print(json.dumps({"side": "program", "seed": s, **numbers,
                          "seconds": time.perf_counter() - t,
                          "followed": run.followed,
                          "worst_leaves": check.worst_leaves(run.followed)}),
              flush=True)
        del run
    for s in controls:
        for side, kw in (("control", dict(lower=lower)),
                         ("half_batch", dict(fault="half_batch")),
                         ("stale_eval", dict(fault="stale_eval"))):
            numbers, followed = in_the_programs_place(cell, s, dev, adj,
                                                      **kw)
            for k in check.NUMBERS:
                least[side][k] = min(least[side][k], numbers[k])
            print(json.dumps({"side": side, "seed": s, **numbers,
                              "followed": followed,
                              "worst_leaves": check.worst_leaves(followed)}),
                  flush=True)
    for s in [int(s) for s in args.witness_seeds.split(",") if s]:
        numbers, followed = in_the_programs_place(cell, s, dev, adj,
                                                  on=torch.device("cpu"))
        print(json.dumps({"side": "reference_on_cpu", "seed": s, **numbers,
                          "followed": followed,
                          "worst_leaves": check.worst_leaves(followed)}),
              flush=True)
    for s in [int(s) for s in args.order_seeds.split(",") if s]:
        print(json.dumps({"side": "second_order", "seed": s,
                          **second_order(cell, s, dev, adj)}), flush=True)
    print(json.dumps({"workload": cell.name, "program_max": worst,
                      "control_min": least["control"],
                      "half_batch_min": least["half_batch"],
                      "stale_eval_min": least["stale_eval"],
                      "control": lower}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
