"""The port's QUAL calibration sweep (tools/torch_qual_sweep.py) against the
JAX tool's (tools/qual_sweep.py): the sweep's arithmetic on the exact case
of tests/test_qual_calibration.py, and a held-out ONT flowcell called by
both packages on the CPU: the same planted truth and the same
(position, is_tp) calls, QUAL within 1 below 3000 (float32 does not
resolve QUAL above it). On the card: the production checkpoint's false
positives concentrate below the sweep's cutoff, as
tests/test_qual_calibration.py requires of the JAX package."""

import tempfile

import numpy as np
import pytest
import torch

from tools import qual_sweep as jax_tool
from tools import torch_qual_sweep as port_tool

# tests/test_qual_calibration.py's exact-math case
TRUTH = {100, 200, 300, 400}
CALLS = [
    (100, 900.0, True), (200, 800.0, True), (300, 700.0, True),
    (400, 50.0, True),
    (500, 40.0, False), (600, 30.0, False),
    (700, 850.0, False),
]


def test_sweep_math_exact_matches_jax():
    rows = port_tool.sweep(TRUTH, CALLS)
    assert rows == jax_tool.sweep(TRUTH, CALLS)
    assert rows[0] == {"qual": 0.0, "tp": 4, "fp": 3,
                       "precision": round(4 / 7, 4), "recall": 1.0,
                       "f1": round(2 * (4 / 7) / (4 / 7 + 1), 4)}
    best = port_tool.operating_point(rows)
    assert best == jax_tool.operating_point(jax_tool.sweep(TRUTH, CALLS))
    assert best["qual"] == 50.0 and best["tp"] == 4 and best["fp"] == 1
    assert best["precision"] == 0.8 and best["recall"] == 1.0
    cutoffs = [0.0, 45.0, 900.0]
    assert port_tool.sweep(TRUTH, CALLS, cutoffs) == jax_tool.sweep(TRUTH, CALLS, cutoffs)


def test_call_heldout_matches_jax_on_the_cpu(tmp_path, monkeypatch):
    truth, calls = port_tool.call_heldout("ont", genome_kb=10, device="cpu")
    # the JAX tool leaves its working directory behind: keep it in tmp_path
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want_truth, want_calls = jax_tool.call_heldout("ont", genome_kb=10)
    assert truth == want_truth and len(truth) > 10
    assert [(p, tp) for p, _, tp in calls] == [(p, tp) for p, _, tp in want_calls]
    assert any(not tp for _, _, tp in calls), "no false positive to calibrate on"
    for (p, q, _), (_, q_jax, _) in zip(calls, want_calls):
        if max(q, q_jax) < port_tool.QUAL_RESOLVED:
            assert abs(q - q_jax) <= 1.0, (p, q, q_jax)
    assert port_tool.operating_point(port_tool.sweep(truth, calls)) == \
        jax_tool.operating_point(jax_tool.sweep(want_truth, want_calls))


def test_differences_names_every_kind_of_disagreement():
    rows = [(1, "A", "C", "0/1", 100.0), (2, "G", "T", "1/1", 5000.0), (3, "A", "T", "0/1", 50.0),
            (4, "C", "G", "0/1", 10.0)]
    other = [(1, "A", "C", "0/1", 100.9), (2, "G", "T", "1/1", 5100.0), (3, "A", "T", "1/1", 50.0),
             (4, "C", "G", "0/1", 12.0), (5, "T", "A", "0/1", 30.0)]
    assert port_tool.differences(rows, other) == [
        "3: ('A', 'T', '0/1') against ('A', 'T', '1/1')", "4: QUAL 10.0 against 12.0",
        "5: called by the other run only"]


@pytest.mark.cuda
def test_production_false_positives_concentrate_below_cutoff_on_the_card():
    """tests/test_qual_calibration.py's production check, the calls made on
    the card: the best-F1 cutoff buys precision without giving up recall,
    and the false positives sit below it far more often than the true
    positives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    truth, calls = port_tool.call_heldout("ont", genome_kb=60, device="cuda")
    assert len(truth) > 100
    rows = port_tool.sweep(truth, calls)
    unfiltered = rows[0]
    assert unfiltered["recall"] == 1.0
    assert unfiltered["fp"] > 0, "held-out flowcell produced no FPs to calibrate on"
    best = port_tool.operating_point(rows)
    assert best["qual"] > 0
    assert best["f1"] > unfiltered["f1"]
    assert best["precision"] > unfiltered["precision"]
    assert best["recall"] >= 0.98
    fp_quals = np.array([q for _, q, is_tp in calls if not is_tp])
    tp_quals = np.array([q for _, q, is_tp in calls if is_tp])
    fp_below = (fp_quals < best["qual"]).mean()
    tp_below = (tp_quals < best["qual"]).mean()
    assert fp_below >= 3 * max(tp_below, 1e-9), (
        f"QUAL does not separate: {fp_below:.2f} of FPs vs "
        f"{tp_below:.2f} of TPs below cutoff {best['qual']}"
    )
