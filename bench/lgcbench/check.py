"""How ``correct`` is decided.  The reference follows the first
``COMPARED_STEPS`` steps of the step object that the window then drives,
on the same weights and batches; three numbers are compared:

* ``loss``: the largest relative gap of a step's node-mean loss;
  ``loss0``: the first step's alone (no update has acted on it yet);
* ``grad``: the first step's gradient as AdamW took it (its first moment
  over 1 - b1), per leaf: the worst gap between the program's norm and
  the reference's, over the reference's norm of that leaf or of the
  median leaf, whichever is larger; ``grad_median``: the median leaf's
  such gap;
* ``change``: the worst leaf's such gap of each leaf's change over the
  compared steps.

A leaf whose reference gradient is under a thousandth of the median
leaf's is left out of ``grad`` and ``change``: it moves by round-off
alone.  Each number has a limit of its own, in
``checks/limits/<workload>.json``; a number whose limit is null is
reported and not compared (``PERF.md`` gives why for each)."""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

COMPARED_STEPS = 3
NUMBERS = ("loss", "loss0", "grad", "grad_median", "change")
NEGLIGIBLE = 1e-3


def counted(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return sorted(p for p, g in ref_grad.items() if g >= NEGLIGIBLE * med)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> List[Tuple[float, str]]:
    """[(gap, leaf)] sorted: |prog - ref| over the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref[p] for p in leaves)
    out = []
    for p in leaves:
        denom = max(ref[p], med)
        gap = abs(prog[p] - ref[p]) / denom if denom > 0 else \
            (0.0 if prog[p] == ref[p] else float("inf"))
        out.append((gap, p))
    return sorted(out)


def readings(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """prog, ref: {"losses": [..], "grad": {leaf: norm}, "change": {leaf:
    norm}} -> {number: {"value", "at"}}."""
    gaps = [abs(a - b) / abs(b)
            for a, b in zip(prog["losses"], ref["losses"])]
    loss = max((g, i) for i, g in enumerate(gaps))
    leaves = counted(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = leaf_gaps(prog["change"], ref["change"], leaves)
    med = grad[len(grad) // 2]
    return {"loss": {"value": loss[0], "at": f"step {loss[1]}"},
            "loss0": {"value": gaps[0], "at": "step 0"},
            "grad": {"value": grad[-1][0], "at": grad[-1][1]},
            "grad_median": {"value": med[0], "at": med[1]},
            "change": {"value": change[-1][0], "at": change[-1][1]}}


def verdict(got: Dict[str, Dict], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict]]:
    """(every number within its limit, {number: {"value", "limit"}})."""
    compared = {k: {"value": got[k]["value"], "limit": limits[k]}
                for k in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in compared.values()
             if c["limit"] is not None)
    return ok, compared
