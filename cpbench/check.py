"""The numbers that decide ``correct`` for a training cell, and the
judgment against the cell's limits (``limits/<cell>.json``).

Both sides start from the same weights and train the same first steps
on the same rows.  Compared are:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer got it
  (after clipping), by its worst leaf: the gap between the two sides'
  norms of a leaf, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``change_gap``: the parameters' change over the compared steps, by
  its worst leaf in the same measure, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (a leaf below
  that moves under AdamW by round-off alone).
"""

from __future__ import annotations

import statistics

__all__ = ["NUMBERS", "loss_gap", "leaf_gap", "leaf_gaps", "readings", "judge"]

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
#: leaves whose reference gradient norm is below this share of the
#: median leaf's are left out of the change
MOVED_SHARE = 1e-3


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: gap} of two ``{leaf: norm}``: the gap of the norms over
    the reference's norm of the leaf or of the median leaf."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med, 1e-30)
            for k, r in ref.items() if keep is None or k in keep}


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(worst gap, its leaf) of two ``{leaf: norm}``."""
    gaps = leaf_gaps(prog, ref, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run; ``prog`` and ``ref`` each hold
    ``losses`` (per step), ``grad_norms`` and ``change_norms`` ({leaf:
    norm})."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= MOVED_SHARE * med}
    grad, grad_at = leaf_gap(prog["grad_norms"], g)
    change, change_at = leaf_gap(prog["change_norms"], ref["change_norms"],
                                 moved)
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "losses": prog["losses"], "ref_losses": ref["losses"],
            "grad_gap": grad, "grad_leaf": grad_at,
            "change_gap": change, "change_leaf": change_at,
            "left_out": sorted(set(g) - moved),
            "grad_gaps": leaf_gaps(prog["grad_norms"], g),
            "change_gaps": leaf_gaps(prog["change_norms"],
                                     ref["change_norms"], moved)}


def judge(read: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{number: {"value", "limit"}}``): correct where every
    number is finite and at most its limit."""
    checks = {k: {"value": read[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
