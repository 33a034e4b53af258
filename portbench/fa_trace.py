"""Clair3_F's train step split from the "host" stretch's torch.profiler
trace (kinds/train.py:_Stretch), by the program's own ranges
(models/clair3_fa.py, parallel/sharding.py, pipeline/train.py):

- ``trunk_fwd_ms``: the device time of the kernels launched inside an
  ``fa.trunk`` range that a ``train_step.forward`` range encloses;
- ``backward_ms``: of every kernel launched inside ``train_step.backward``
  or by autograd's engine (an ``autograd::engine::evaluate_function``
  range, on autograd's own thread);
- ``h2d_x_ms``: of the host-to-device copies launched inside
  ``dispatch.to_device`` whose size is one that the program's counter
  ``dispatch.x_bytes`` recorded (x's; y's copy is another size);

each summed over the stretch and divided by its train steps (its
``train_step.forward`` ranges). A kernel or copy is tied to the ranges
around its launch by the runtime call with the same ``correlation`` id.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, Set

_CPU_CATS = ("cpu_op", "user_annotation", "python_function")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
AUTOGRAD = "autograd::engine::evaluate_function"


def x_bytes() -> Set[int]:
    """The sizes the program's ``dispatch.x_bytes`` counter recorded; empty
    where the program has no such counter."""
    try:
        from clair_tpu_torch.utils import trace
    except ImportError:
        return set()
    return {int(r.value) for r in trace.records() if r.name == "dispatch.x_bytes"}


def read_host(path: str, sizes: Iterable[int]) -> Dict[str, float]:
    """{"steps", "trunk_fwd_ms", "backward_ms", and where ``sizes`` names
    one, "h2d_x_ms"} of the trace at ``path``; {} without a train step."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    ranges = defaultdict(list)
    launches = {}
    device = []
    for e in events:
        cat = e.get("cat", "")
        if cat in _CPU_CATS:
            ranges[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        elif cat in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["pid"], e["tid"], e["ts"])
        elif cat in ("kernel", "gpu_memcpy"):
            device.append(e)
    spans = {k: sorted(v) for k, v in ranges.items()}
    starts = {k: [s for s, _, _ in v] for k, v in spans.items()}

    def enclosing(pid, tid, ts):
        held = spans.get((pid, tid), [])
        return {n for s, end, n in held[:bisect.bisect_right(starts[(pid, tid)], ts)]
                if end >= ts} if held else set()

    steps = sum(n == "train_step.forward" for v in spans.values() for _, _, n in v)
    if not steps:
        return {}
    sizes = set(sizes)
    trunk = backward = h2d = 0.0
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        names = enclosing(*launch)
        ms = e.get("dur", 0) / 1e3
        if e["cat"] == "gpu_memcpy":
            if ("HtoD" in e["name"] and "dispatch.to_device" in names
                    and e["args"].get("bytes") in sizes):
                h2d += ms
        elif "fa.trunk" in names and "train_step.forward" in names:
            trunk += ms
        elif "train_step.backward" in names or any(n.startswith(AUTOGRAD) for n in names):
            backward += ms
    found = {"steps": steps, "trunk_fwd_ms": trunk / steps, "backward_ms": backward / steps}
    if sizes:
        found["h2d_x_ms"] = h2d / steps
    return found
