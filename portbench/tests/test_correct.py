"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a chip skipped, the rest of a run driven on the
CPU at a small size): a step that leaves the state unchanged, half of
each batch left out with the mean taken over the rest, and a gradient
altered where row 2 produces it. The exchange between chips has no fault
here: every cell runs on one chip. And the control, the reference in the
precision below the configuration's put in the program's place, reads
above a limit."""

import json

import pytest
import torch

from conftest import REPO, run_copy
from portbench import harness
from portbench.calibrate import CONTROLS
from portbench.kinds import train

CELLS = {"train-f32": "clair2-f32", "train-bf16": "clair2-bf16"}


@pytest.mark.parametrize("fault", ["none", "unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_correct_only_when_sound(tiny, cell, fault):
    result = run_copy(tiny, cell, 2**31 + 1000 + len(fault), fault)
    assert result["correct"] is (fault == "none"), result["compared"]
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_a_limit(cell):
    config = json.loads((REPO / "portbench" / "configs" / f"{CELLS[cell]}.json").read_text())
    mix = harness.load_traffic("train-b10k")
    config["bin_rows"], mix["batch"] = 3 * 400, 400
    run = train.Cell(config, mix, 2**31 + 5, torch.device("cpu"))
    run.setup()
    run.release()
    limits = config["limits"]
    sound = run.check()
    control = run.check(precision=CONTROLS[config["training"]["compute_dtype"]])
    assert all(sound[k]["value"] <= limits[k] for k in limits), sound
    assert any(control[k]["value"] > limits[k] for k in limits), control
