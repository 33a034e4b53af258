"""Clair3_F's cell (kind ``train_fa``): the work counts at the published
widths, the rows the generator makes, and a run of the cell cut to narrow
widths on the CPU through the harness, whose check holds the program to
the reference."""

import json
import shutil

import torch

from conftest import REPO, run_copy
from portbench import fa_rows, harness, work_fa
from portbench.kinds.train_fa import stats_gap

CONFIG = json.loads((REPO / "portbench/configs/clair3-fa-f32.json").read_text())
MIX = json.loads((REPO / "portbench/traffic/train-fa-b2k.json").read_text())


def test_work_counts():
    flops = work_fa.forward_flops_per_row(CONFIG["model"])
    convs = [v for k, v in flops.items() if k.startswith(("conv", "block"))]
    assert round(sum(convs) / 1e6, 1) == 449.4
    assert round(sum(flops.values()) / 1e6, 1) == 451.5
    assert round(work_fa.model_flops(CONFIG["model"], 2000, 0) / 1e12, 3) == 2.709


def test_rows_are_seeded_int16_in_clair3s_scale():
    def rows(seed):
        return fa_rows.make_rows(300, MIX["reads"], 89, 33,
                                 torch.Generator().manual_seed(seed), torch.device("cpu"))

    x, y = rows(5)
    assert x.shape == (300, 89, 33, 8) and x.dtype == torch.int16 and y.shape == (300, 90)
    assert x.abs().max() <= 100 and (y.sum(1) == 4).all()
    depth = (x[..., 0] != 0).all(dim=2).sum(1)
    assert depth.min() >= 35 and depth.max() <= 65
    assert torch.equal(rows(5)[0], x) and not torch.equal(rows(6)[0], x)


def test_narrow_cell_runs_correct(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    config = dict(CONFIG, bin_rows=600)
    config["model"] = dict(CONFIG["model"], input_shape=[17, 9, 8], stage_channels=[8, 16, 32],
                           l4_num_units=32, l5_num_units=16)
    (tmp_path / "portbench/configs/clair3-fa-f32.json").write_text(json.dumps(config))
    (tmp_path / "portbench/traffic/train-fa-b2k.json").write_text(json.dumps(dict(MIX, batch=100)))
    result = run_copy(tmp_path, "train-fa-f32", 2**31 + 91, seconds=2.0)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 3
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_stats_gap_reads_the_running_statistics_faults():
    """Statistics left at their start read 1 in the buffer that moved most;
    a momentum of 0.9 in place of 0.99 about 8 (over three steps the change
    is (1 - 0.9^3) / (1 - 0.99^3) = 9.1 times the reference's); the
    reference against itself 0."""
    g = torch.Generator().manual_seed(1)
    start = {"a.mean": torch.zeros(8), "a.var": torch.ones(8),
             "b.mean": torch.zeros(4), "b.var": torch.ones(4)}
    batch = {k: torch.rand(v.shape, generator=g) + 0.5 for k, v in start.items()}

    def run(momentum, steps=3):
        stats = dict(start)
        for _ in range(steps):
            stats = {k: momentum * v + (1 - momentum) * batch[k] for k, v in stats.items()}
        return stats

    reference = run(0.99)
    assert stats_gap(reference, reference, start)["value"] == 0
    assert stats_gap(start, reference, start)["value"] == 1
    assert 8 < stats_gap(run(0.9), reference, start)["value"] < 9
