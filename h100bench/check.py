"""The numbers that decide ``correct``, and how they are read.

Readings of a training run over its first three steps (the program's, or a
control's), against the reference's over the same steps from the same
weights and batches:

* ``loss_gap``: the largest relative gap of a step's loss (the mean over
  workers of the mean over the R forward slices).
* ``grad_gap``: the first gradient each worker's optimizer receives (its
  momentum after step D, the FIFO's depth), per leaf and worker: the gap
  between the two norms, over the larger of the reference's norm of that
  leaf and of its median leaf; the worst leaf. ``grad_gap_median``: the
  median leaf's (each leaf's worst worker).
* ``update_gap``, ``update_gap_median``: the same of each leaf's change
  over the three steps, leaving out leaves whose first gradient in the
  reference is under a thousandth of the median leaf's (they move by
  round-off alone).
* ``clock_mismatch``: version clocks and push-sum weights that differ
  from the reference's at all (a count).

Each has a limit in ``h100bench/limits/<cell>.json``; ``null`` there means
the cell does not compare that number (``PERF.md`` says why). A reading
that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "update_gap",
           "update_gap_median", "clock_mismatch")
QUIET = 1e-3  # a leaf whose first gradient is under this share of the median


def leaf_gaps(got: Dict[str, List[float]], want: Dict[str, List[float]],
              keep=None) -> Dict[str, float]:
    """{leaf: its worst worker's gap of norms, over the larger of the
    reference's norm and the median leaf's}."""
    floor = statistics.median(v for vs in want.values() for v in vs)
    out = {}
    for path, ws in want.items():
        if keep is not None and path not in keep:
            continue
        worst = 0.0
        for g, w in zip(got[path], ws):
            den = max(w, floor)
            gap = abs(g - w) / den if den > 0 else 0.0
            worst = max(worst, gap if math.isfinite(g) else math.inf)
        out[path] = worst
    return out


def moved(want: dict) -> set:
    """Leaves whose first gradient in the reference is not nought to
    rounding."""
    grads = want["grad_norms"]
    floor = statistics.median(v for vs in grads.values() for v in vs)
    return {p for p, vs in grads.items() if max(vs) >= QUIET * floor}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The compared numbers of ``got`` against the reference ``want``
    (readings as :func:`h100bench.reference.pdasgd.run` returns them)."""
    loss_gap = max(abs(g - w) / abs(w) if math.isfinite(g) else math.inf
                   for g, w in zip(got["loss"], want["loss"]))
    grad = leaf_gaps(got["grad_norms"], want["grad_norms"])
    upd = leaf_gaps(got["update_norms"], want["update_norms"], moved(want))
    clocks = (int((got["versions"] != want["versions"]).sum())
              + int((got["w"] != want["w"]).sum()))
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "update_gap": max(upd.values()),
            "update_gap_median": statistics.median(upd.values()),
            "clock_mismatch": float(clocks)}


def judge(numbers: Dict[str, float],
          limits: Dict[str, Optional[float]]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS if limits[k] is not None)
