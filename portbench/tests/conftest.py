"""Helpers of the benchmark's CPU tests (run them with
``python -m pytest portbench/tests -q`` from the repository's root)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# a cell cut to a size the CPU runs in seconds: every width as published
TINY_ROWS, TINY_BATCH = 1200, 200


# the bf16 cell, whose configuration file is kept for it (PERF.md §7): the
# copies carry it, so that the CPU tests cover both configurations
BF16_CONFIG = {"name": "clair2-bf16", "source": "https://github.com/HKU-BAL/Clair",
               "file": "portbench/configs/clair2-bf16.json", "reduced": ["bin_rows"],
               "why": "the port's default training precision"}
BF16_CELL = {"name": "train-bf16", "config": "clair2-bf16", "traffic": "train-b10k", "chips": 1,
             "why": "the port's default training path"}


def with_bf16(spec: dict) -> dict:
    """``spec`` with the bf16 cell and its configuration added as entries."""
    if not any(w["name"] == BF16_CELL["name"] for w in spec["workloads"]):
        spec["configs"].append(dict(BF16_CONFIG))
        spec["workloads"].append(dict(BF16_CELL))
        for metric in spec["per_layer"]:
            metric["workloads"].append(BF16_CELL["name"])
    return spec


def tiny_copy(root: Path, rows: int = TINY_ROWS, batch: int = TINY_BATCH) -> Path:
    """A throwaway copy of the benchmark (BENCHMARK.json, with the bf16
    cell added, and portbench/) under ``root``, every configuration cut to
    ``rows`` rows and every traffic mix to batches of ``batch``."""
    spec = with_bf16(json.loads((REPO / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (root / "portbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["bin_rows"] = rows
        path.write_text(json.dumps(config))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["batch"] = batch
        mix["val_batch"] = min(mix["val_batch"], batch // 2)
        path.write_text(json.dumps(mix))
    return root


# runs one cell of the copy in the working directory on the CPU for
# argv[4] seconds, with the fault named by argv[3] planted in the program
# underneath, and prints the result's object
RUNNER = r'''
import json, sys, time
import torch
torch.set_num_threads(2)
from portbench import harness
cell, seed, fault, seconds = sys.argv[1], int(sys.argv[2]), sys.argv[3], float(sys.argv[4])
if fault == "unchanged":
    from clair_tpu_torch.parallel import sharding
    sharding.ClippedOptimizer.step = lambda self, tensor_parallel=None: torch.zeros(())
elif fault == "half_batch":
    from clair_tpu_torch.parallel import sharding
    original = sharding._loss
    def half(model, logits, y, l2_lambda, sample_weights):
        weights = torch.zeros(y.shape[0], device=y.device)
        weights[: y.shape[0] // 2] = 2.0
        return original(model, logits, y, l2_lambda, weights)
    sharding._loss = half
elif fault == "altered":
    from clair_tpu_torch.ops import bilstm_stream as stream
    original = stream.bilstm_stream_backward
    def doubled(x, *args, **kwargs):
        dx, dw, du, db = original(x, *args, **kwargs)
        if x.shape[-1] == 256:
            dw = dw.clone()
            dw[0] *= 2
        return dx, dw, du, db
    stream.bilstm_stream_backward = doubled
spec = harness.load_spec()
result, lines = harness.run(spec, cell, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter(), log=lambda line: print(line, file=sys.stderr))
print("\n".join(lines), file=sys.stderr)
print(json.dumps(result))
'''


def run_copy(root: Path, cell: str, seed: int, fault: str = "none", with_log: bool = False,
             seconds: float = 1.0):
    """The result of one run of ``cell`` in the copy at ``root`` on the
    CPU, measuring for ``seconds`` (and its standard error, ``with_log``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", RUNNER, cell, str(seed), fault, str(seconds)], cwd=root,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    return (result, proc.stderr) if with_log else result


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("tiny"))
