"""A cell is added with new files only: the first Open question's
``epoch-bf16`` (a real epoch, a tenth of the rows held out for the eval
step) added to a throwaway copy as one traffic file and BENCHMARK.json
entries (the cell, the configuration whose file portbench/ keeps, and its
name in the per-layer metrics' lists of cells), then run at a small size
on the CPU."""

import hashlib
import json
import shutil

from conftest import REPO, run_copy, tiny_copy, with_bf16
from portbench import harness

EPOCH_MIX = "train-b10k-val10"
EPOCH_CELL = {"name": "epoch-bf16", "config": "clair2-bf16", "traffic": EPOCH_MIX, "chips": 1,
              "why": "a real epoch: train steps at batch 10,000, then the eval step at 512 on "
                     "the held-out tenth"}


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def add_epoch_cell(root):
    mix = json.loads((root / "portbench" / "traffic" / "train-b10k.json").read_text())
    mix.update(val_share=0.1, about="a real epoch: a tenth of the rows held out")
    (root / "portbench" / "traffic" / f"{EPOCH_MIX}.json").write_text(json.dumps(mix))
    spec = with_bf16(json.loads((root / "BENCHMARK.json").read_text()))
    spec["workloads"].append(EPOCH_CELL)
    for metric in spec["per_layer"]:
        metric["workloads"].append(EPOCH_CELL["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_epoch_cell_takes_new_files_only(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)
    add_epoch_cell(tmp_path)
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {f"portbench/traffic/{EPOCH_MIX}.json"}
    spec = harness.load_spec(tmp_path)
    assert len(harness.per_layer(spec, "epoch-bf16")) == 8


def test_epoch_cell_runs(tmp_path):
    root = tiny_copy(tmp_path, rows=1000, batch=200)
    add_epoch_cell(root)
    result, log = run_copy(root, "epoch-bf16", 2**31 + 77, with_log=True, seconds=8.0)
    assert result["correct"] and result["failed"] == 0
    # 900 training rows: 4 steps of 200 and one of 100, then 100 held out
    # in one eval step of 100; the window runs whole epochs and more
    assert "'eval': 0}" not in log and result["attempted"] >= 7
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}
