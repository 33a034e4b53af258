"""The readings a cell's limits are set from (not run by the benchmark).

    python3 portbench/calibrate.py --workload train-f32 --seeds 11,12,13 \
        --control-seeds 11,12,13 --out calibration.jsonl

For each seed, in one process: the cell's set-up as a run makes it (rows,
bin, weights, the program's checked steps through the feed), then

- ``program``: the numbers compared, the program against the reference;
- with ``--control-seeds``: ``control``, the reference computed in the
  precision below the configuration's (float32: TF32 products; bfloat16:
  float8 e4m3 products, scaled per tensor) put in the program's place, and
  the faults a training cell can have, planted in the reference put in the
  program's place: ``half_batch`` (half of each batch left out, the mean
  taken over the rest) and ``altered`` (one leaf's gradient, lstm2's
  forward W, doubled where it is produced), and ``unchanged`` (no update:
  every gradient zero, which Adam turns into no step), whose norms read 1
  by the measure of portbench/check.py and whose losses are read here.

Each reading is one JSON line in ``--out``, and printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTROLS = {"bfloat16": "fp8", "float32": "tf32"}
ALTERED_LEAF = "lstm2.fw.w"


def half_batch(step, grads):
    """Row weights 2 on a batch's first half and 0 on the rest."""
    if grads is not None:
        return grads
    return half_batch.weights


def altered(step, grads):
    if grads is None:
        return None
    return {k: 2 * g if k == ALTERED_LEAF else g for k, g in grads.items()}


def unchanged(step, grads):
    if grads is None:
        return None
    return {k: g * 0.0 for k, g in grads.items()}


def seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, required=True)
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    device = torch.device("cuda")
    spec = harness.load_spec()
    entry = harness.workload(spec, args.workload)
    config = harness.load_config(spec, entry["config"])
    mix = harness.load_traffic(entry["traffic"])
    kind = harness.load_kind(mix)
    control = CONTROLS[config["training"]["compute_dtype"]]
    with open(args.out, "a") as out:
        for seed in sorted(set(args.seeds) | set(args.control_seeds)):
            started = time.perf_counter()
            cell = kind.Cell(config, mix, seed, device)
            cell.setup()
            setup_s = time.perf_counter() - started
            cell.release()
            runs = {"program": {}} if seed in args.seeds else {}
            if seed in args.control_seeds:
                batch = cell.batch
                half_batch.weights = torch.cat([torch.full((batch // 2,), 2.0),
                                                torch.zeros(batch - batch // 2)]).to(device)
                runs.update({"control": {"precision": control},
                             "half_batch": {"fault": half_batch},
                             "altered": {"fault": altered},
                             "unchanged": {"fault": unchanged}})
            for name, kwargs in runs.items():
                numbers = cell.check(**kwargs)
                line = {"workload": args.workload, "seed": seed, "reading": name,
                        "setup_s": setup_s, "losses": cell.checked["losses"],
                        **{k: v["value"] for k, v in numbers.items()},
                        "worst": {k: v["leaf"] for k, v in numbers.items()}}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
                out.flush()
            del cell
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
