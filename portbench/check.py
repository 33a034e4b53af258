"""The numbers that decide ``correct`` for a training cell.

The program's first steps, on the object the window then drives, against
the plain reference's same steps from the same weights, rows and dropout
seed (reference/clair2.py):

- ``loss_gap``: the largest, over the checked steps, of
  |program loss - reference loss| / |reference loss|;
- ``grad_gap``: step 1's clipped gradient as Adam received it (the
  program's worked out from Adam's first moment after one step), by the
  worst leaf: |program norm - reference norm| over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the parameters' change over the checked steps, each
  leaf's gap taken alike, over the leaves whose step-1 gradient in the
  reference is at least a thousandth of the median leaf's (a leaf with
  none moves under Adam by round-off alone): the median leaf's gap;
- ``change_worst``: the same gaps' worst leaf, so that a fault in a few
  leaves' updates shows. It swings from seed to seed with Adam's
  amplification of the round-off in its smallest elements' later steps,
  and sound runs read as high as the control: its limit is held against
  the planted faults (PERF.md §2).

A configuration's file gives the limit of each number it holds
(``limits``); the harness compares those alone and logs the rest.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from portbench.reference.clair2 import l2_norms

# a leaf whose reference gradient is under this share of the median
# leaf's is left out of the change
MOVED_SHARE = 1e-3


def _gaps(program: Dict[str, float], reference: Dict[str, float],
          leaves: List[str]) -> Dict[str, float]:
    """Each leaf's |program - reference| over the larger of the
    reference's value for that leaf and for the median leaf."""
    median = statistics.median(reference[k] for k in leaves)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30)
            for k in leaves}


def compare(program: Dict, reference: Dict, start: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """{name: {"value": v, "leaf": where it was read}} of both sides'
    {"losses", "grad", "params"} (reference/clair2.py:train's keys) from
    the parameters ``start``."""
    loss_gaps = [abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(program["losses"], reference["losses"])]
    step = max(range(len(loss_gaps)), key=loss_gaps.__getitem__)
    ref_grad = l2_norms(reference["grad"])
    grad = _gaps(l2_norms(program["grad"]), ref_grad, sorted(ref_grad))
    grad_leaf = max(grad, key=grad.get)
    median_grad = statistics.median(ref_grad.values())
    moved = sorted(k for k, v in ref_grad.items() if v >= MOVED_SHARE * median_grad)
    change = {side: l2_norms({k: tree["params"][k].float() - start[k].float() for k in moved})
              for side, tree in (("program", program), ("reference", reference))}
    change = _gaps(change["program"], change["reference"], moved)
    worst = max(change, key=change.get)
    return {
        "loss_gap": {"value": max(loss_gaps), "leaf": f"step {step + 1}"},
        "grad_gap": {"value": grad[grad_leaf], "leaf": grad_leaf},
        "change_gap": {"value": statistics.median(change.values()), "leaf": "median leaf"},
        "change_worst": {"value": change[worst], "leaf": worst},
    }
