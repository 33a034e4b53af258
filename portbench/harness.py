"""The benchmark of clair_tpu_torch, driven by data.

Everything is found by the names in the repository's ``BENCHMARK.json``:

- a configuration, by its ``file`` (``portbench/configs/<name>.json``);
- a traffic mix, ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the general generator that reads it, ``portbench/kinds/<kind>.py``
  (a module with a ``Cell`` class: ``setup``, ``window``, ``release``,
  ``check``);
- a per-layer metric, ``portbench/metrics/<name>.py``, a reader that
  declares its ``LAYER``, ``UNIT``, ``SOURCE``, ``BETTER`` and ``MOVES`` and
  returns the metric from a run's readings, or None where it finds nothing.

A cell, configuration, mix or metric is added with new files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
# compared by the whole top-level name (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "clair_tpu")
_METRIC_KEYS = {"LAYER": "layer", "UNIT": "unit", "SOURCE": "source", "BETTER": "better",
                "MOVES": "moves"}


class BenchError(RuntimeError):
    """A benchmark that cannot run as its files describe it."""


def load_spec(root: Path = REPO) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise BenchError(f"BENCHMARK.json has no {what} named {name!r}")
    return found[0]


def workload(spec: Dict, name: str) -> Dict:
    return _named(spec["workloads"], name, "workload")


def load_config(spec: Dict, name: str) -> Dict:
    entry = _named(spec["configs"], name, "configuration")
    with open(REPO / entry["file"]) as fh:
        config = json.load(fh)
    if config.get("name") != name:
        raise BenchError(f"{entry['file']} names {config.get('name')!r}, not {name!r}")
    return config


def load_traffic(name: str) -> Dict:
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def load_kind(mix: Dict) -> ModuleType:
    return importlib.import_module(f"portbench.kinds.{mix['kind']}")


def load_metric(entry: Dict, bench: Path = BENCH) -> ModuleType:
    """The reader of a per-layer metric, checked against its entry."""
    path = bench / "metrics" / f"{entry['name']}.py"
    module_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + entry["name"].replace(".", "_").replace("-", "_"), path)
    if module_spec is None or not path.is_file():
        raise BenchError(f"no reader {path} for the metric {entry['name']!r}")
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    for attr, key in _METRIC_KEYS.items():
        if getattr(module, attr, None) != entry[key]:
            raise BenchError(f"{path.name} declares {attr} {getattr(module, attr, None)!r}; "
                             f"BENCHMARK.json says {entry[key]!r}")
    return module


def end_to_end(spec: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics the cell reports: those that list it among
    their ``workloads``, and those with no such list, which every cell
    reports."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(spec: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics that list the cell among their ``workloads``."""
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def host_probe(loops: int = 2_000_000) -> float:
    """Seconds this host takes for a fixed loop of the interpreter's: read
    after the window, beside the run's numbers, to tell a slow host from a
    slow program."""
    start = time.perf_counter()
    total = 0
    for i in range(loops):
        total += i & 7
    return time.perf_counter() - start


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run(spec: Dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
        started: float, log=print) -> Tuple[Dict, List[str]]:
    """One run of a cell: (the result's object, the lines compared). The
    result names the device; a run off a CUDA device says so."""
    import torch

    cell_entry = workload(spec, cell_name)
    config = load_config(spec, cell_entry["config"])
    mix = load_traffic(cell_entry["traffic"])
    readers = [(m, load_metric(m)) for m in per_layer(spec, cell_name)]
    cell = load_kind(mix).Cell(config, mix, seed, device)
    cell.setup()
    setup_s = time.perf_counter() - started
    values, readings, counts = cell.window(seconds, trace)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    probe = host_probe()
    # the numbers the configuration holds to a limit (PERF.md §2)
    limits = config["limits"]
    numbers = cell.check()
    if set(limits) - set(numbers):
        raise BenchError(f"{cell_entry['config']} limits {sorted(set(limits) - set(numbers))}, "
                         f"which the check does not read")
    compared = {k: v for k, v in numbers.items() if k in limits}
    for name in sorted(set(numbers) - set(limits)):
        log(f"recorded, not compared: {name} {numbers[name]['value']!r} "
            f"(worst: {numbers[name]['leaf']})")
    lines = []
    for name, got in compared.items():
        got["limit"] = limits[name]
        lines.append(f"compared {name} {got['value']!r} limit {limits[name]!r} "
                     f"(worst: {got['leaf']})")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())

    values["setup_s"] = setup_s
    metrics = {}
    if trace:
        for entry, reader in readers:
            value = reader.read(readings)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        for entry in end_to_end(spec, cell_name):
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell_entry["chips"], "memory_peak_bytes": peak,
                   "power_limit": power_limit() if cuda else None}
    result = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics, "device": device_info}
    found = readings.trace
    if trace and "busy_s" in found:
        device_info["busy_s"] = found["busy_s"]
        device_info["window_s"] = found["window_s"]
    if trace and found:
        result["breakdown"] = {"device_ops": found.get("device_ops", []),
                               "idle_gaps": found.get("idle_gaps", [])}
    if trace and readings.split is not None:
        result["parts_ms_per_step"] = readings.split["ms_per_step"]
    if trace and "host_ms" in found:
        result["host_ms"] = found["host_ms"]
    if len(readings.step_intervals_ms) >= 4:
        q = statistics.quantiles(readings.step_intervals_ms, n=20)
        log(f"step intervals ms: {len(readings.step_intervals_ms)}, median {q[9]!r}, "
            f"p75 {q[14]!r}, p95 {q[18]!r}, max {max(readings.step_intervals_ms)!r}")
    log(f"cell {cell_name} seed {seed}: {counts['attempted']} steps, rows {counts['rows']} in "
        f"{counts['seconds']!r} s; set-up {setup_s!r} s {getattr(cell, 'setup_parts', {})}; "
        f"host probe {probe!r} s; checked losses {cell.checked['losses']}; window losses first "
        f"{cell.window_losses[:1]} last {cell.window_losses[-1:]}; {counts['failed']} failed, "
        f"the first at window step {counts['first_failed']}")
    result["compared"] = {k: {"value": c["value"], "limit": c["limit"]}
                          for k, c in compared.items()}
    return result, lines
