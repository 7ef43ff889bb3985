"""How far the CPU port parts from itself when its arithmetic moves by one
rounding, in ``chip_smoke.py``'s dense configurations (phase 9c).

    python -m acmgnn_tpu_torch.tools.cpu_witness [--case structure]
        [--seeds 3 4 5 6] [--epochs 20] [--lr 1e-3] [--weight-decay 5e-4]
        [--graph chameleon|zoo] [--draws 4] [--trace]

For each seed of the initial parameters, one split is trained on the CPU
(dropout 0, no card involved) from ``build_model(seed)``: as
``chip_smoke.trained`` trains it, and again on one thread instead of
torch's default, with the ELL operator in place of the dense one, and
with every non-zero feature moved one ulp up or down, the directions
drawn ``--draws`` times (``chip_smoke.cpu_witness``).  Prints, for each
of those runs, the largest |Δparam| against the first, and the largest
of all.  With ``--trace``, for the first
seed and ulp draw 0, after each epoch: the largest |Δparam|, where it is
(parameter, row, column) and how many parameters part by more than 1e-5.  A configuration whose runs part by more than the
card-against-CPU tolerance amplifies rounding: there the card cannot be
held to the CPU over that many epochs.

The cases are 9c's ``structure`` (acmgcnp, structure channel, variant 1,
joint), ``acmsgc`` (hops 2, sequential) and ``acmgcn`` (joint); the graphs
are 9c's chameleon-shaped graph and 9d's twitch-shaped ``zoo`` graph.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
CASES = {
    "structure": dict(model_type="acmgcnp", structure_info=True,
                      variant=True, joint=True),
    "acmsgc": dict(model_type="acmsgc", hops=2, joint=False),
    "acmgcn": dict(model_type="acmgcn", joint=True),
}


def _smoke():
    """This tree's ``chip_smoke.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _graph(smoke, name):
    from acmgnn_tpu_torch.data.synthetic_scale import \
        twitch_gamers_scale_graph
    from acmgnn_tpu_torch.ops.graph import GraphData

    if name == "chameleon":
        return smoke._chameleon_graph(), 2
    adj, feats, _ = twitch_gamers_scale_graph(0, n=smoke.ZOO_N,
                                              pairs=20 * smoke.ZOO_N)
    feats = np.abs(feats)
    labels = (feats[:, 0] > np.median(feats[:, 0])).astype(np.int32)
    return GraphData("small", adj, feats, labels), 0


def _trace(smoke, data, cfg, masks, seed):
    nudged = smoke.ulp_nudged(data, 0)
    for epochs in range(1, cfg.epochs + 1):
        run = dataclasses.replace(cfg, epochs=epochs)
        a = smoke.trained(data, run, masks, "cpu", seed)[1]
        b = smoke.trained(nudged, run, masks, "cpu", seed)[1]
        diff = {k: (a[k] - b[k]).abs() for k in a}
        k = max(diff, key=lambda k: float(diff[k].max()))
        where = np.unravel_index(int(diff[k].argmax()), tuple(diff[k].shape))
        parted = sum(int((d > 1e-5).sum()) for d in diff.values())
        print(f"seed {seed} ulp draw 0, epoch {epochs}: "
              f"{float(diff[k].max()):.3e} at {k}{list(map(int, where))}; "
              f"{parted} parameters part by more than 1e-5", flush=True)


def main(argv=None) -> None:
    import torch

    from acmgnn_tpu_torch.train.config import TrainConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", choices=sorted(CASES), default="structure")
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--graph", choices=("chameleon", "zoo"),
                    default="chameleon")
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    smoke = _smoke()
    data, mask_seed = _graph(smoke, args.graph)
    masks = smoke._masks(data.num_nodes, seed=mask_seed)
    cfg = TrainConfig(
        hidden=64, dropout=0.0, lr=args.lr, weight_decay=args.weight_decay,
        epochs=args.epochs, early_stopping=0, selection="val_metric",
        operator_format="auto", **CASES[args.case])
    threads = torch.get_num_threads()
    print(f"{args.case} on the {args.graph} graph (N={data.num_nodes}), lr "
          f"{args.lr:g}, decay {args.weight_decay:g}, {args.epochs} epochs, "
          f"torch {threads} threads")
    if args.trace:
        _trace(smoke, data, cfg, masks, args.seeds[0])
    for seed in args.seeds:
        gaps = {"ELL": smoke.max_param_diff(
            smoke.trained(data, cfg, masks, "cpu", seed)[1],
            smoke.trained(data, dataclasses.replace(
                cfg, operator_format="ell"), masks, "cpu", seed)[1])}
        gaps.update(smoke.cpu_witness(data, cfg, masks, seed,
                                      draws=args.draws, threads=True))
        print(f"seed {seed}: " + "; ".join(
            f"{name} {gap:.3e}" for name, gap in gaps.items())
            + f"; largest {max(gaps.values()):.3e}", flush=True)


if __name__ == "__main__":
    main()
