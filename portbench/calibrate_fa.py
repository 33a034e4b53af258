"""The readings train-fa-f32's limits are set from (not run by the benchmark).

    python3 portbench/calibrate_fa.py --workload train-fa-f32 --seeds 1-20 \
        --control-seeds 1-4 --out calibration.jsonl

portbench/calibrate.py's readings for Clair3_F, with its seeds' syntax and
its planted faults (half of each batch left out, the state unchanged), and
its altered gradient on ``ALTERED_LEAF``, the kernel of the middle stage's
BasicBlock's second convolution, doubled. For each seed, in one process: the
cell's set-up as a run makes it, but for a bin of the checked steps' rows
alone (``CHECKED_STEPS`` batches: portbench/fa_rows.py makes rows in chunks
of a fixed size, so these are a run's first rows, which its checked steps
take), then

- ``program``: the numbers compared, the program against the reference;
- with ``--control-seeds``: ``control``, the reference computed with
  cuBLAS's and cuDNN's TF32 products put in the program's place; the
  three faults planted in the reference put in its place; and two faults
  of batch norm's running statistics: ``stats_unchanged`` (the program's
  steps with the statistics left at their start) and ``stats_momentum``
  (the reference's steps with a momentum of 0.9 in place of 0.99);
- with ``--float64-seeds``: the three steps computed in float64, against
  which ``program_vs_f64`` reads the program and ``reference_vs_f64`` the
  float32 reference, each number, with the three leaves of the largest
  gradient gaps of each (``top_grad``).

Each reading is one JSON line in ``--out``, and printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import calibrate  # noqa: E402

ALTERED_LEAF = "block2.conv2.w"
# the running statistics' momentum of the stats_momentum fault
FAULT_MOMENTUM = 0.9


def altered(step, grads):
    if grads is None:
        return None
    return {k: 2 * g if k == ALTERED_LEAF else g for k, g in grads.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=calibrate.seeds, required=True)
    parser.add_argument("--control-seeds", type=calibrate.seeds, default=[])
    parser.add_argument("--float64-seeds", type=calibrate.seeds, default=[])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    import torch

    from portbench import check, harness
    from portbench.kinds.train import CHECKED_STEPS
    from portbench.kinds.train_fa import compare
    from portbench.reference.clair2 import l2_norms

    def top_grad(program, reference):
        ref = l2_norms(reference["grad"])
        gaps = check._gaps(l2_norms(program["grad"]), ref, sorted(ref))
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    device = torch.device("cuda")
    spec = harness.load_spec()
    entry = harness.workload(spec, args.workload)
    config = harness.load_config(spec, entry["config"])
    mix = harness.load_traffic(entry["traffic"])
    config["bin_rows"] = CHECKED_STEPS * int(mix["batch"])
    kind = harness.load_kind(mix)
    with open(args.out, "a") as out:
        for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.float64_seeds)):
            started = time.perf_counter()
            cell = kind.Cell(config, mix, seed, device)
            cell.setup()
            setup_s = time.perf_counter() - started
            cell.release()
            runs = {"program": {}} if seed in args.seeds else {}
            if seed in args.control_seeds:
                batch = cell.batch
                calibrate.half_batch.weights = torch.cat(
                    [torch.full((batch // 2,), 2.0), torch.zeros(batch - batch // 2)]).to(device)
                runs.update({"control": {"precision": "tf32"},
                             "half_batch": {"fault": calibrate.half_batch},
                             "altered": {"fault": altered},
                             "unchanged": {"fault": calibrate.unchanged}})
            readings = [(name, cell.check(**kwargs), None) for name, kwargs in runs.items()]
            if seed in args.control_seeds:
                program = dict(cell.checked, stats=cell.start_stats())
                readings.append(("stats_unchanged", compare(
                    program, cell.reference(), cell.reference("float64", steps=1), cell.start,
                    cell.start_stats()), None))
                momentum = dict(cell.model_spec, bn_momentum=FAULT_MOMENTUM)
                readings.append(("stats_momentum", cell.check(model=momentum), None))
            if seed in args.float64_seeds:
                exact = cell.reference("float64")
                for name, program in (("program_vs_f64", cell.checked),
                                      ("reference_vs_f64", cell.reference())):
                    readings.append((name, compare(program, exact, exact, cell.start,
                                                   cell.start_stats()),
                                     top_grad(program, exact)))
            for name, numbers, top in readings:
                line = {"workload": args.workload, "seed": seed, "reading": name,
                        "setup_s": setup_s, "losses": cell.checked["losses"],
                        **{k: v["value"] for k, v in numbers.items()},
                        "worst": {k: v["leaf"] for k, v in numbers.items()},
                        **({"top_grad": top} if top else {})}
                print(json.dumps(line), flush=True)
                out.write(json.dumps(line) + "\n")
                out.flush()
            del cell
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
