"""The program's own spans and counters (clair_tpu_torch/utils/trace.py) as
the per-layer readers take them: the records made while no profiler was
recording, so outside the traced window's profiled stretches. A program
without the recorder has none, and its readers find nothing.

Run as a script on a machine with the cards the cell asks for (it exits
non-zero and prints nothing without them), it runs one traced cell in this
process and prints, as
its last line, one JSON object beside the cell's result: how much of the
interval between consecutive train steps the dispatching thread's
top-level spans cover, the records a train step makes, the ring's drops,
and the calls into the CUDA runtime that wait for the device in the
"host" stretch's trace, by the spans around them:

    python3 portbench/spans.py --workload train-f32 --seed 7 --seconds 51
"""

from __future__ import annotations

import bisect
import json
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

# the spans of a train step's host dispatch, less the loss's wait
DISPATCH = ("dispatch.to_device", "train_step.forward", "train_step.loss",
            "train_step.backward", "train_step.optimizer", "values.copy")
# the dispatching thread's top-level spans: where its time goes
TOP_LEVEL = ("feed.wait", "dispatch.to_device", "train_step.forward", "train_step.loss",
             "train_step.backward", "train_step.optimizer", "values.copy", "values.wait")
STEP_PARTS = ("train_step.forward", "train_step.loss", "train_step.backward",
              "train_step.optimizer")


def unprofiled() -> List:
    """The recorder's records made with no profiler recording; [] where the
    program has no recorder."""
    try:
        from clair_tpu_torch.utils import trace
    except ImportError:
        return []
    return [r for r in trace.records() if not r.profiled]


def ms(record) -> float:
    return (record.end_ns - record.start_ns) / 1e6


def median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def train_steps(records: Sequence) -> List[Dict[str, float]]:
    """{span name: ms} of each train step, by the batch's sequence number:
    the steps whose four ``train_step.*`` spans are all among ``records``,
    with the loss's wait (``loss.sync`` inside ``train_step.loss``) as
    ``loss.sync``."""
    by_batch: Dict[int, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for r in records:
        if r.name in DISPATCH or (r.name == "loss.sync" and r.parent == "train_step.loss"):
            by_batch[r.batch][r.name] += ms(r)
    return [dict(parts) for _, parts in sorted(by_batch.items())
            if all(p in parts for p in STEP_PARTS)]


def reads_behind(records: Sequence) -> List:
    """The ``values.wait`` records of reads made one step behind the
    dispatch: after the dispatch of the next batch (``dispatch.to_device``
    of the batch's sequence number plus one) had begun. That leaves out
    set-up's checked and warm-up steps, each read right after its own
    dispatch, and the window's last read, which follows no dispatch."""
    begun: Dict[int, int] = {}
    for r in records:
        if r.name == "dispatch.to_device":
            begun[r.batch] = min(begun.get(r.batch, r.start_ns), r.start_ns)
    return [r for r in records if r.name == "values.wait"
            and begun.get(r.batch + 1, r.start_ns + 1) <= r.start_ns]


def coverage(records: Sequence) -> Optional[Dict[str, float]]:
    """How much of each interval between the starts of consecutive train
    steps' ``feed.wait`` (batches n and n + 1 both train steps) the
    dispatching thread's top-level spans (``TOP_LEVEL``, no span around
    them) cover: the medians of the interval, of the time covered and of
    their ratio, over the intervals. None without two such steps."""
    steps = {r.batch for r in records if r.name == "train_step.forward"}
    waits = {r.batch: r for r in records if r.name == "feed.wait" and r.batch in steps}
    if not waits:
        return None
    thread = next(iter(waits.values())).thread
    spans = sorted((r.start_ns, r.end_ns) for r in records
                   if r.name in TOP_LEVEL and r.parent is None and r.thread == thread)
    starts = [s for s, _ in spans]
    intervals, covered, shares = [], [], []
    for n, wait in waits.items():
        after = waits.get(n + 1)
        if after is None:
            continue
        a, b = wait.start_ns, after.start_ns
        inside, reach = 0, a
        for s, e in spans[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if s >= b:
                break
            s, e = max(s, reach), min(e, b)
            if e > s:
                inside += e - s
                reach = e
        intervals.append((b - a) / 1e6)
        covered.append(inside / 1e6)
        shares.append(inside / (b - a))
    if not intervals:
        return None
    return {"intervals": len(intervals), "interval_ms": statistics.median(intervals),
            "covered_ms": statistics.median(covered),
            "covered_share": statistics.median(shares)}


def waits_by_span(trace_path: str) -> List[List]:
    """The calls into the CUDA runtime that wait for the device
    (portbench/devtrace.py's WAITS) in a profiler's trace, by the
    ``user_annotation`` ranges around them on their thread, outermost
    first: [[call, ranges, count, ms], ...], most time first."""
    from portbench import devtrace

    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    ranges = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            ranges[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    found: Dict[tuple, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "cuda_runtime" and e["name"] in devtrace.WAITS:
            around = sorted((a, n) for a, b, n in ranges.get(e.get("tid"), ())
                            if a <= e["ts"] <= b)
            key = (e["name"], " / ".join(n for _, n in around))
            found[key][0] += 1
            found[key][1] += e.get("dur", 0) / 1e3
    return [[call, where, n, total] for (call, where), (n, total) in
            sorted(found.items(), key=lambda kv: -kv[1][1])]


def main(argv=None) -> int:
    import argparse
    import os
    import sys
    import time

    started = time.perf_counter()
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    import torch

    from clair_tpu_torch.utils import trace
    from portbench import devtrace, harness

    spec = harness.load_spec()
    chips = harness.workload(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    waits: List = []
    read_host = devtrace.read_host

    def reading_waits(path):
        waits.extend(waits_by_span(path))
        return read_host(path)

    devtrace.read_host = reading_waits
    result, _ = harness.run(spec, args.workload, args.seed, args.seconds, True,
                            device, started, log=lambda line: print(line, file=sys.stderr))
    records = unprofiled()
    steps = train_steps(records)
    window = [r for r in records if r.batch >= 0]
    print(json.dumps({"result": result, "coverage": coverage(records),
                      "train_steps": len(steps),
                      "records_a_batch": len(window) / max(len({r.batch for r in window}), 1),
                      "records": len(trace.records()), "dropped": trace.dropped(),
                      "waits_by_span": waits}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
