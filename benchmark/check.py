"""The comparison that decides ``correct``.

Set-up drives the program's split runner from the seed through its first
three steps, through the same call the window uses (split 0 in three
segments of one step each), and keeps its trajectory: the parameters and
Adam's moments after each step, each step's training loss and the
validation loss after steps 1 and 2 (``program_trajectory``).  Once the
window has closed and the program's state is freed, the cell's plain
reference follows that trajectory step by step (its ``follow``,
``manifest.REFERENCE``): from the program's state before step t it
computes step t's loss, gradient and change, and the validation loss at
the program's state after it.  It
starts from the same inputs as the program (the benchmark's), so step 1
is checked from the start; it does not run three steps on its own,
because a second sound order of the same arithmetic parts from it by up
to 1e-2 after the first Adam step (``PERF.md``).  Compared (``gaps``),
each the largest over the steps:

- ``loss_gap``: a step's training loss, relative;
- ``val_loss_gap``: an evaluated epoch's validation loss, relative;
- ``grad_gap``: the gradient as Adam takes it (the program's worked out
  from its first moments before and after the step), by the worst leaf
  (or, where the cell's workload file says ``"leaf": "median"``, the
  median leaf): the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the step's change of the parameters, by the same leaf
  statistic, measured alike; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (they move by round-off
  alone).

Each has a limit of its own, set from the readings in ``PERF.md`` and
kept in the cell's workload file.
"""

from __future__ import annotations

import statistics

import torch

STEPS = 3              # steps the reference follows
NULL_GRADIENT = 1e-3   # of the median leaf's gradient norm
NUMBERS = ("loss_gap", "val_loss_gap", "grad_gap", "change_gap")


def program_trajectory(init: dict, states, names) -> dict:
    """The program's trajectory from ``init`` and the ``SplitState`` of
    each one-step segment (its ``runner`` holds the parameters and the
    optimizer's state after that step; ``names`` are the parameters in
    the optimizer's order).  A moment the optimizer does not hold (it
    took no step) reads NaN."""
    zeros = {n: torch.zeros_like(init[n]) for n in names}
    params, ms, vs = [init], [zeros], [zeros]
    for st in states:
        opt = st.runner.opt_state["state"]
        params.append({n: st.runner.variables[n] for n in names})
        for key, out in (("exp_avg", ms), ("exp_avg_sq", vs)):
            out.append({n: (opt[i][key] if key in opt.get(i, {})
                            else torch.full_like(init[n], float("nan")))
                        for i, n in enumerate(names)})
    last = states[-1]
    return dict(params=params, m=ms, v=vs,
                losses=[float(v) for v in last.train_losses[:STEPS].cpu()],
                val_losses=[float(v)
                            for v in last.val_hist[:STEPS - 1].cpu()])


def _worst(values) -> float:
    """The largest of ``values``, NaN if any is (``max`` may skip one)."""
    values = list(values)
    return (float("nan") if any(v != v for v in values)
            else max(values, default=0.0))


def _relative(pairs) -> float:
    return _worst(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)


def leaf_gaps(got: dict, ref: dict, leaves) -> dict:
    floor = statistics.median(ref[n] for n in leaves)
    return {n: abs(got[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in leaves}


def _median(values) -> float:
    values = list(values)
    return (float("nan") if any(v != v for v in values)
            else statistics.median(values))


LEAF = {"worst": _worst, "median": _median}


def gaps(followed: dict, leaf: str = "worst") -> dict:
    """The compared numbers of a reference's ``follow`` output; ``leaf``
    says which leaf's gap ``grad_gap`` and ``change_gap`` take at a step:
    the worst, or the median leaf's (a cell whose worst leaf is
    ill-conditioned, ``PERF.md``)."""
    over = LEAF[leaf]
    grad, change = [], []
    for (g_got, g_ref), (c_got, c_ref) in zip(followed["grad"],
                                              followed["change"]):
        leaves = sorted(g_ref)
        grad.append(over(leaf_gaps(g_got, g_ref, leaves).values()))
        g_med = statistics.median(g_ref[n] for n in leaves)
        moved = [n for n in leaves if g_ref[n] >= NULL_GRADIENT * g_med]
        change.append(over(leaf_gaps(c_got, c_ref, moved).values()))
    return dict(loss_gap=_relative(followed["loss"]),
                val_loss_gap=_relative(followed["val_loss"]),
                grad_gap=_worst(grad), change_gap=_worst(change))


def worst_leaves(followed: dict) -> dict:
    """Which leaf sets ``grad_gap`` and ``change_gap`` at each step."""
    out = {}
    for key in ("grad", "change"):
        names = []
        for got, ref in followed[key]:
            gap = leaf_gaps(got, ref, sorted(ref))
            names.append(max(gap, key=lambda n: gap[n] if gap[n] == gap[n]
                             else float("inf")))
        out[key] = names
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN fails)."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in NUMBERS)
