"""The comparison with the plain reference that decides ``correct``.

Training (the first ``checked_steps`` steps of the timed step object):
  * ``loss_gap``: the largest |program loss - reference loss| / |reference
    loss| over the steps;
  * ``update_gap``: over the trainable leaves, the worst |norm of the
    program's first update - the reference's| (the update as the recipe's
    optimizer gets it, read from the program's optimizer state after step
    1 by the optimizer module, ``benchmark/reference/optimizers/``), over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger;
  * ``change_gap``: the same for each leaf's change over the steps;
  * ``stats_gap``: the same for each BN running statistic's change (the
    train-mode forwards and the target-stats forward move them);
  * ``update_median_gap``, ``change_median_gap``: the median leaf's gap,
    steady from seed to seed where the worst leaf's is the bf16 rounding
    of a few leaves (a trainable BN affine: its gradients are sums that
    cancel), which ``PERF.md`` shows.
A cell compares the numbers its traffic file's ``limits`` name.
Leaves whose reference first gradient is under a thousandth of the median
leaf's (nought to rounding, e.g. a bias under a normalization) move under
weight decay and round-off alone: they are left out of ``update_gap`` and
``change_gap`` by that rule, never by name.  A leaf the program leaves
without an update counts as 0 and reads 1.

Evaluation: ``logit_gap``, over the sampled images and every pixel, how
far the reference's merged logit of the program's predicted class lies
below the reference's best, over the image's largest |logit|; and
``confusion_diff``, the summed |difference| between the program's
confusion counts and the reference's counts of the program's predictions
(exact: limit 0).
"""

from __future__ import annotations

import math
import statistics

GRAD_FLOOR = 1e-3  # of the median leaf's first gradient


def _leaf_gaps(prog: dict, ref: dict, keys) -> list[float]:
    keys = list(keys)
    if not keys:
        return [math.nan]
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def moving_leaves(ref: dict) -> list[str]:
    med = statistics.median(ref["first_grad"].values())
    return [k for k, g in ref["first_grad"].items() if g >= GRAD_FLOOR * med]


def train_readings(prog: dict, ref: dict) -> dict[str, float]:
    keep = moving_leaves(ref)
    update = _leaf_gaps(prog["first_update"], ref["first_update"], keep)
    change = _leaf_gaps(prog["change"], ref["change"], keep)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "update_gap": max(update),
        "change_gap": max(change),
        "update_median_gap": statistics.median(update),
        "change_median_gap": statistics.median(change),
        "stats_gap": max(_leaf_gaps(prog["stats_change"], ref["stats_change"],
                                    ref["stats_change"])),
    }


def worst_leaves(prog: dict, ref: dict, field: str, k: int = 3) -> list:
    """The ``k`` leaves with the widest gap of ``field``: [name, gap, program, reference]."""
    keys = moving_leaves(ref) if field != "stats_change" else list(ref[field])
    med = statistics.median(ref[field][n] for n in keys)
    rows = [[n, abs(prog[field].get(n, 0.0) - ref[field][n]) / max(ref[field][n], med, 1e-30),
             prog[field].get(n, 0.0), ref[field][n]] for n in keys]
    return sorted(rows, key=lambda r: -r[1])[:k]


def judge(readings: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """(every number the cell compares finite and within its limit,
    {name: {value, limit}}); the cell's traffic file names the numbers it
    compares in ``limits``, a reading it does not name is not compared."""
    lines, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
        lines[name] = {"value": value, "limit": limit}
    return ok, lines
