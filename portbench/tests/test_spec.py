"""BENCHMARK.json in the format the benchmark is held to, and the harness finding each
configuration, traffic mix, kind and metric by its name."""

import json
import re

import pytest

from conftest import REPO
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for entry in SPEC["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in entry["reduced"])
    for entry in SPEC["workloads"]:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] == 1 and NAME.match(entry["traffic"])
    for entry in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for entry in SPEC["end_to_end"]:
        assert 0.01 <= entry["bound"] <= 0.25 and entry["source"] == "host_clock"
    texts = [e["why"] for e in SPEC["configs"] + SPEC["workloads"]]
    texts += [e["layer"] for e in SPEC["per_layer"]] + [e["source"] for e in SPEC["configs"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    entry = harness.workload(SPEC, cell)
    config = harness.load_config(SPEC, entry["config"])
    assert config["reduced"] == harness._named(SPEC["configs"], entry["config"],
                                               "configuration")["reduced"]
    assert ({"loss_gap", "grad_gap", "change_gap"} <= set(config["limits"])
            <= {"loss_gap", "grad_gap", "change_gap", "change_worst"})
    mix = harness.load_traffic(entry["traffic"])
    assert hasattr(harness.load_kind(mix), "Cell")
    reported = {m["name"] for m in harness.end_to_end(SPEC, cell)}
    assert {"setup_s", "train_samples_per_s"} <= reported
    layer_metrics = harness.per_layer(SPEC, cell)
    assert len(layer_metrics) == 8 and all(m["moves"] in reported for m in layer_metrics)


@pytest.mark.parametrize("entry", SPEC["per_layer"], ids=lambda e: e["name"])
def test_metric_reader_declares_its_entry(entry):
    reader = harness.load_metric(entry)
    assert callable(reader.read)


def test_metric_reader_that_disagrees_is_refused(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x.train.py").write_text(
        'LAYER = "device"\nUNIT = "ms"\nSOURCE = "device_trace"\nBETTER = "lower"\n'
        'MOVES = "train_samples_per_s"\ndef read(r):\n    return None\n')
    entry = {"name": "x.train", "unit": "%", "layer": "device", "source": "device_trace",
             "better": "lower", "moves": "train_samples_per_s"}
    with pytest.raises(harness.BenchError, match="UNIT"):
        harness.load_metric(entry, bench=tmp_path)


def test_layers_named_alike():
    by_layer = {}
    for entry in SPEC["per_layer"]:
        by_layer.setdefault(entry["layer"], []).append(entry["name"])
    assert sorted(by_layer["device (the card, from the profiler's trace)"]) == [
        "idle_share.train", "mfu.train"]
    assert len(by_layer) == 6


def test_config_files_state_their_cut():
    for entry in SPEC["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        assert config["source"] == entry["source"]
        assert all(k in config for k in entry["reduced"])
        assert config["model"]["lstm1_num_units"] == config["model"]["lstm2_num_units"] == 128
