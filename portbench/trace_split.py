# Frozen copy of tools/torch_trace_split.py at commit
# 2d943a28633bbdf54bf4ad8c2fca49aa40a5ff2a, kept here so that an edit of
# tools/ does not move the benchmark's yardstick. Unchanged below this header.
"""The train step's device time split from a torch.profiler trace, as
``python -m clair_tpu_torch train --profile_dir DIR`` writes it
(``DIR/*.pt.trace.json``): the port's BiLSTM kernels by row, and the rest
of the step by where its kernels were launched.

    python3 tools/torch_trace_split.py DIR/host_pid.pt.trace.json

Each CUDA kernel of the trace is tied to the CPU op that launched it (the
runtime launch event with the same ``correlation`` id, and the ranges that
enclose that launch on its thread). A kernel counts toward the train step
when a ``train_step.*`` range (parallel/sharding.py: make_train_step) or
an autograd ``evaluate_function`` encloses its launch; the validation
steps and the feed's copies do not count. Its part:

- row 1 and row 2 by kernel name (KERNEL_ROWS), wherever launched;
- else "backward" when launched by autograd, "optimizer" (the clip and
  Adam) under ``train_step.optimizer``, "loss" under ``train_step.loss``,
  "forward" under ``train_step.forward``.

A kernel belongs to the step whose ``train_step.forward`` range began
last before its launch. Prints each step's milliseconds by part (the
kernels' summed durations), their mean over the steps and each kernel
name's mean; the last line is the same as JSON. An epoch's last step may
be a short batch: read the steps one by one. Needs no card: it reads a
file. A trace taken on the CPU has no kernels.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from typing import Dict

# the port's kernels on the streaming training path, by a substring of their
# names: row 1 the streaming forward (bf16: its kernel; float32: the x.W
# product and the sweep on its layout), row 2 the streaming backward's four
# (its sweeps: bf16 bilstm_bwd_sweep_mma and _fma, float32 lstm_bwd_sweep;
# its products: bf16 wgmma_product, float32 mma_product; float32's split of
# operands into bf16 pieces counts here for both rows)
KERNEL_ROWS = (("row 1", ("bilstm_stream_fwd_kernel", "StreamXWProblem", "StreamForward")),
               ("row 2", ("lstm_bwd_sweep", "wgmma_product", "mma_product", "split_pieces")))
PARTS = ("row 1", "row 2", "forward", "loss", "backward", "optimizer")
_CPU_CATS = ("cpu_op", "user_annotation", "python_function")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def split_train_steps(trace_path: str) -> Dict:
    """{"steps": n, "per_step": [{part: ms} of each step], "ms_per_step":
    {part: mean ms}, "kernels_ms_per_step": {kernel name: mean ms},
    "total_ms_per_step": mean ms} of the trace's train steps."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    ranges = defaultdict(list)       # (pid, tid) -> [(start, end, name)]
    launches = {}                    # correlation -> (pid, tid, ts)
    kernels = []
    for e in events:
        cat = e.get("cat", "")
        if cat in _CPU_CATS:
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["pid"], e["tid"], e["ts"])
        elif cat == "kernel":
            kernels.append(e)
    starts = {k: sorted(v) for k, v in ranges.items()}
    keys = {k: [r[0] for r in v] for k, v in starts.items()}

    def enclosing(pid, tid, ts):
        spans = starts.get((pid, tid), [])
        # a range that starts after ts cannot hold it
        return [name for start, end, name in spans[:bisect.bisect_right(keys[(pid, tid)], ts)]
                if end >= ts] if spans else []

    step_starts = sorted(r[0] for v in ranges.values() for r in v
                         if r[2] == "train_step.forward")
    steps = len(step_starts)
    per_step = [dict.fromkeys(PARTS, 0.0) for _ in step_starts]
    by_name = defaultdict(float)
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        names = enclosing(*launch)
        in_autograd = any(n.startswith("autograd::engine::evaluate_function") for n in names)
        steps_of = {n for n in names if n.startswith("train_step.")}
        if not (in_autograd or steps_of):
            continue
        part = next((row for row, marks in KERNEL_ROWS if any(m in k["name"] for m in marks)),
                    None)
        if part is None:
            part = "backward" if in_autograd else next(
                (p for p in ("optimizer", "loss", "forward") if f"train_step.{p}" in steps_of),
                "forward")
        step = bisect.bisect_right(step_starts, launch[2]) - 1
        per_step[max(step, 0)][part] += k["dur"] / 1e3
        by_name[k["name"]] += k["dur"] / 1e3
    per = max(steps, 1)
    mean = {p: sum(s[p] for s in per_step) / per for p in PARTS}
    return {"steps": steps, "per_step": per_step, "ms_per_step": mean,
            "kernels_ms_per_step": {n: v / per for n, v in
                                    sorted(by_name.items(), key=lambda kv: -kv[1])},
            "total_ms_per_step": sum(mean.values())}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__.split("\n\n")[1])
    split = split_train_steps(argv[0])
    print(f"{split['steps']} train steps, {split['total_ms_per_step']:.4f} ms of kernels a step")
    for i, step in enumerate(split["per_step"]):
        print(f"  step {i + 1}: {sum(step.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in step.items()))
    for part, ms in split["ms_per_step"].items():
        print(f"  mean {part}: {ms:.4f} ms")
    for name, ms in split["kernels_ms_per_step"].items():
        print(f"    {ms:.4f} ms  {name[:120]}")
    print(json.dumps(split))


if __name__ == "__main__":
    main()
