"""The comparison that decides ``correct``.

Set-up drives the program through the first round of its epoch order (one
batch of every gap of the mix, through the window's own ``train_epoch``)
and reads, from the program: each step's loss (the logged loss plus the
acceleration regularizer), each leaf's first gradient as Adam got it
(``exp_avg / (1 - beta1)`` after step 1) and each leaf's change after
``CHANGE_AFTER`` steps, before step 4 moves it (later steps part the two
trajectories by chaos alone: a float32 MiDaS seed read a change gap of 0.03
after five steps with its first gradient within 1.4e-4). The reference
follows the same steps on the same pairs from the same weights. Three
numbers, each against its limit in ``limits/<workload>.json``:

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the steps;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  two first gradients, over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the same for the parameters' change after
  ``CHANGE_AFTER`` steps, over the leaves the reference moves: a leaf whose reference gradient is
  under a thousandth of the median leaf's moves under Adam by round-off
  alone and is left out.

A step that leaves the state unchanged reads ``change_gap`` 1.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
CHANGE_AFTER = 3
STILL = 1e-3  # a leaf's gradient under this share of the median's: unmoved


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys,
           floor: float):
    worst, leaf = 0.0, None
    for k in keys:
        gap = abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{'losses': [...], 'first': {leaf: norm},
    'change': {leaf: norm}}``. Returns the three numbers and the worst
    leaves."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program steps against "
                         f"{len(ref['losses'])} reference steps")
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(a) for a in prog["losses"]):
        loss_gap = math.inf
    med_g = statistics.median(ref["first"].values())
    grad_gap, grad_leaf = _worst(prog["first"], ref["first"], ref["first"],
                                 med_g)
    moved = [k for k, g in ref["first"].items() if g >= STILL * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change_gap, change_leaf = _worst(prog["change"], ref["change"], moved,
                                     med_c)
    extra = sorted(set(prog["first"]) ^ set(ref["first"]))
    if extra:  # a leaf on one side only
        grad_gap = change_gap = math.inf
        grad_leaf = change_leaf = extra[0]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf, "still_leaves":
            len(ref["first"]) - len(moved)}


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in NUMBERS)


def report(nums: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """The compared numbers with their limits, one line each."""
    return [f"check {k} {nums[k]!r} limit {limits[k]!r}" for k in NUMBERS]
