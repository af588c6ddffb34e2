"""The comparison that decides ``correct`` for a training cell.

Three numbers, each against the cell's limit (``limits`` in the cell
file), the program's readings against the reference's:

- ``loss_gap``: the largest |loss_program - loss_reference| over the
  first ``loss_steps`` compared steps (the cell's ``loss_steps``; where a
  later step's loss swings by the round-off of the update before it, the
  first step's alone);
- ``grad_gap``: the first step's gradient as the optimizer got it (the
  program's first moment after one step, over 1 - b1), by the worst leaf:
  | |g_p| - |g_r| | over the larger of |g_r| and the median leaf's |g_r|;
- ``update_gap``: each leaf's change after the compared steps, by the
  worst leaf in the same measure.  Leaves whose reference gradient is
  under a thousandth of the median leaf's move under Adam by round-off
  alone and are left out.

A reading that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

LEAF_FLOOR = 1e-3  # of the median leaf's reference gradient


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: List[str]) -> float:
    med = statistics.median(ref[p] for p in keep)
    gaps = [abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in keep]
    return max(gaps)


def readings(prog: Dict, ref: Dict, loss_steps: int = 0) -> Dict[str, float]:
    n = min(len(prog["losses"]), len(ref["losses"]))
    if loss_steps:
        n = min(n, loss_steps)
    loss_gap = max(abs(prog["losses"][k] - ref["losses"][k]) for k in range(n))
    paths = sorted(ref["grad_norms"])
    med = statistics.median(ref["raw_grad_norms"][p] for p in paths)
    moved = [p for p in paths if ref["raw_grad_norms"][p] >= LEAF_FLOOR * med]
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"],
                                   paths),
            "update_gap": worst_leaf(prog["change_norms"],
                                     ref["change_norms"], moved)}


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> Dict[str, List]:
    """The ``n`` leaves with the largest gradient and change gaps, each
    as [path, program norm, reference norm]."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        p, r = prog[key], ref[key]
        order = sorted(r, key=lambda k: -abs(p[k] - r[k]) / max(r[k], 1e-30))
        out[key] = [[k, p[k], r[k]] for k in order[:n]]
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
