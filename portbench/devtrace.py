"""The device's busy and idle time, and the host's, in torch.profiler
traces of stretches of the window (kinds/train.py:_Stretch).

A trace of the device's activity alone (``read_device``), over steps that
begin and end with the device idle (the harness synchronises):

- busy: the union of every kernel, copy and fill on the device;
- the window: from the first of them to the end of the last;
- the device operations that took most time, summed by name.

A trace of the host and the device (``read_host``), over a range named
``STRETCH`` that opens before the stretch's first step and closes once the
device has finished its last:

- the longest idle gaps (no kernel, copy or fill running), each named by
  what the host thread that opened the range was doing at the gap's
  middle: the outermost ``portbench.*`` range there and the innermost
  operation. The host's profiling slows a host-paced step, so the gaps
  are longer than in an unprofiled step;
- the host's milliseconds by range, operation and CUDA runtime call on
  that thread (inclusive: a range counts the operations inside it);
- the host's own milliseconds in each ``DISPATCH`` range: its length less
  the CUDA runtime calls inside it that wait for the device (``WAITS``),
  such as the synchronisation of a copy from pageable memory.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

STRETCH = "portbench.profiled"
DISPATCH = "portbench.dispatch"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy", "cudaMemcpyAsync")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _events(path: str) -> List[Dict]:
    with open(path) as fh:
        return [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]


def read_device(path: str) -> Dict:
    """{"busy_s", "window_s", "device_ops"} of a trace of the device's
    activity over a stretch that began and ended with the device idle: the
    window runs from its first operation's start to its last one's end;
    {} where it has none."""
    spans, by_name = [], defaultdict(float)
    for e in _events(path):
        if e.get("cat") in DEVICE_CATS and e.get("dur", 0) > 0:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            by_name[e["name"]] += e["dur"] / 1e6
    if not spans:
        return {}
    busy = _merge(spans)
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (busy[-1][1] - busy[0][0]) / 1e6,
        "device_ops": [[name[:200], seconds] for name, seconds in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def read_host(path: str) -> Dict:
    """{"idle_gaps", "host_ms"} of a trace of the host and the device over
    the range ``STRETCH``; {} where it has no such range or no device
    operation."""
    events = _events(path)
    stretch = next((e for e in events if e.get("name") == STRETCH
                    and e.get("cat") == "user_annotation"), None)
    if stretch is None:
        return {}
    w0, w1 = stretch["ts"], stretch["ts"] + stretch["dur"]
    spans = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in events
             if e.get("cat") in DEVICE_CATS]
    busy = _merge([(a, b) for a, b in spans if b > a])
    if not busy:
        return {}
    gaps = [(a, b) for a, b in zip([w0] + [e for _, e in busy], [s for s, _ in busy] + [w1])
            if b > a]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("pid") == stretch.get("pid")
                  and e.get("tid") == stretch.get("tid") and e["name"] != STRETCH)
    starts = [h[0] for h in host]

    def doing(ts: float) -> str:
        around = [(a, b, n) for a, b, n in host[:bisect.bisect_right(starts, ts)] if b >= ts]
        if not around:
            return "host outside any range"
        outer = next((n for _, _, n in around if n.startswith("portbench.")), around[0][2])
        inner = min(around, key=lambda r: r[1] - r[0])[2]
        return outer if inner == outer else f"{outer} / {inner}"

    host_ms = defaultdict(float)
    for a, b, name in host:
        if a >= w0 and b <= w1:
            host_ms[name] += (b - a) / 1e3
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and w0 <= e["ts"] <= w1
               and e.get("tid") == stretch.get("tid")]
    for e in runtime:
        host_ms[e["name"]] += e.get("dur", 0) / 1e3
    dispatch = []
    for a, b, name in host:
        if name == DISPATCH:
            waited = sum(e.get("dur", 0) for e in runtime
                         if e["name"] in WAITS and a <= e["ts"] <= b)
            dispatch.append((b - a, waited))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    found = {
        "idle_gaps": [[doing((a + b) / 2), (b - a) / 1e6] for a, b in longest],
        "host_ms": [[name, ms] for name, ms in
                    sorted(host_ms.items(), key=lambda kv: -kv[1])[:2 * TOP]],
    }
    if dispatch:
        found["dispatch_ms"] = sum(d - w for d, w in dispatch) / len(dispatch) / 1e3
        found["dispatch_wait_ms"] = sum(w for _, w in dispatch) / len(dispatch) / 1e3
    return found
