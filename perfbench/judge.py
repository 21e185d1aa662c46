"""The comparison that decides ``correct``.

Readings (of the program, of the reference, of the control) are each a
dict of ``losses`` (one a step), ``grad1`` (the norm of each leaf of the
first gradient as the optimizer takes it) and ``change`` (the norm of
each leaf's change over the first steps). Three numbers are compared,
each against its cell's limit (``limits`` in the workload file):

- ``loss``: the largest gap between a step's loss and the reference's;
- ``grad1``: over the leaves, the largest gap between the program's norm
  and the reference's, over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change``: the same for the change, over the leaves whose first
  gradient in the reference is at least a thousandth of the median
  leaf's (a leaf with no gradient moves by rounding alone).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

MOVED = 1e-3          # of the median leaf's first gradient


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> Tuple[float, str]:
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        p = prog.get(k, math.nan)
        gap = abs(p - ref[k]) / max(ref[k], med, 1e-300)
        if not gap <= worst:            # NaN counts as the worst
            worst, at = (gap if gap == gap else math.inf), k
    return worst, at


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Every leaf's gap, as :func:`worst_leaf` measures it (for the look
    at which leaves set a number)."""
    out = {}
    for name in ("grad1", "change"):
        med = statistics.median(ref[name].values())
        out[name] = {k: abs(prog[name].get(k, math.nan) - r)
                     / max(r, med, 1e-300) for k, r in ref[name].items()}
    return out


def numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """The three compared numbers, each with the leaf or step it came
    from."""
    gaps = [abs(a - b) if a == a else math.inf
            for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps.append(math.inf)
    med = statistics.median(ref["grad1"].values())
    moved = {k for k, g in ref["grad1"].items() if g >= MOVED * med}
    g1, g1_at = worst_leaf(prog["grad1"], ref["grad1"])
    ch, ch_at = worst_leaf(prog["change"], ref["change"], moved)
    worst = max(gaps)
    return {"loss": {"value": worst, "at": f"step {gaps.index(worst)}"},
            "grad1": {"value": g1, "at": g1_at},
            "change": {"value": ch, "at": ch_at}}


def verdict(prog: Dict, ref: Dict, limits: Dict[str, Optional[float]],
            checks: Dict[str, Dict]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, compared): every number beside its limit, the entry's
    exact checks after them. A number whose limit is null is not compared
    (no reading of the control or of a fault separates it from sound
    runs; PERF.md gives its readings)."""
    compared = {}
    for name, n in numbers(prog, ref).items():
        if limits[name] is None:
            continue
        compared[name] = {"value": n["value"], "limit": limits[name],
                          "rule": "<=", "at": n["at"]}
    compared.update(checks)
    ok = all((c["value"] <= c["limit"]) if c["rule"] == "<="
             else (c["value"] >= c["limit"]) for c in compared.values())
    return ok, compared
