"""The port's recorder of spans and counters (clair_tpu_torch/utils/trace.py)
on the CPU: nesting, the batch's sequence number, the ring's bound and its
drops, the profiler's trace; the training path's spans (the feed, the
dispatch, the step, the values, the optimizer's build); the benchmark's
readers of them (portbench/metrics/, portbench/spans.py) and the split of
a profiled step (portbench/trace_split.py)."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clair_tpu_torch.data.bins import BinDataset, EpochBatches, _pack
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
from clair_tpu_torch.pipeline.train import _host_line, _StepValues, _to_device
from clair_tpu_torch import utils
from clair_tpu_torch.utils import trace
from portbench import harness, spans, trace_split

NEW_METRICS = ("feed_starved_share.train", "epoch_restart_ms.train", "dispatch_host_ms.train",
               "step_sync_wait_ms.train", "host_ahead_share.train", "optimizer_build_s.train")
STEP_PARTS = ("train_step.forward", "train_step.loss", "train_step.backward",
              "train_step.optimizer")
ROWS, BLOCK, BATCH = 120, 20, 40
# narrow, and 11 positions, so that a step takes milliseconds on the CPU
CONFIG = ModelConfig(input_shape=(11, 8, 4), lstm1_num_units=16, lstm2_num_units=16,
                     l4_num_units=32, l5_num_units=16, compute_dtype="float32")


@pytest.fixture(autouse=True)
def empty_ring():
    trace.reset()
    yield
    trace.reset()


def _dataset(rows=ROWS, block=BLOCK, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(-20, 50, (rows,) + CONFIG.input_shape).astype(np.float32)
    y = np.zeros((rows, 90), np.float32)
    for off, width in ((0, 21), (21, 3), (24, 33), (57, 33)):
        y[np.arange(rows), off + rs.randint(0, width, rows)] = 1.0
    offs = range(0, rows, block)
    return BinDataset(rows, [_pack(x[o:o + block]) for o in offs],
                      [_pack(y[o:o + block]) for o in offs],
                      [_pack(np.arange(o, o + block)) for o in offs], block)


def _epochs(dataset, n_epochs, workers=2, n_train=ROWS):
    """Every batch of ``n_epochs`` epochs, as train_model's loop takes them."""
    order = np.arange(dataset.n_blocks)
    out = []
    for _ in range(n_epochs):
        out += list(EpochBatches(dataset, order, n_train, BATCH, BATCH // 2,
                                 decompress_workers=workers, cast_to_float32=False))
    return out


def _model():
    torch.manual_seed(0)
    model = ClairNet(CONFIG, torch.device("cpu"))
    optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
    return model, optimizer, make_train_step(model, optimizer)


def _train_loop(epochs=2):
    """The benchmark's loop (portbench/kinds/train.py) on the CPU: the feed,
    the batch to the device, the step, the previous step's values read."""
    model, _, step = _model()
    generator = torch.Generator().manual_seed(1)
    order = np.arange(_dataset().n_blocks)
    pending = None
    dataset = _dataset()
    for _ in range(epochs):
        for x, y, _ in EpochBatches(dataset, order, ROWS, BATCH, BATCH,
                                    decompress_workers=2, cast_to_float32=False):
            xd, yd = _to_device(x, torch.device("cpu")), _to_device(y, torch.device("cpu"))
            values = _StepValues(*step(xd, yd, generator, 0.005), True)
            if pending is not None:
                pending.read()
            pending = values
    pending.read()
    return trace.records()


@pytest.fixture(scope="module")
def loop_records():
    trace.reset()
    return _train_loop()


def test_spans_nest_and_carry_the_batch():
    trace.set_batch(7)
    with trace.span("outer"):
        with trace.span("inner", value=3):
            trace.count("counter", 11)
        with trace.span("other", batch=4) as renamed:
            renamed.name, renamed.value = "renamed", "v"
    assert trace.batch() == 7
    got = {r.name: r for r in trace.records()}
    assert list(got) == ["counter", "inner", "renamed", "outer"]
    assert got["inner"].parent == got["renamed"].parent == "outer"
    assert got["counter"].parent == "inner" and got["outer"].parent is None
    assert (got["inner"].batch, got["renamed"].batch, got["outer"].batch) == (7, 4, 7)
    assert (got["inner"].value, got["counter"].value, got["renamed"].value) == (3, 11, "v")
    assert got["counter"].start_ns == got["counter"].end_ns
    assert got["outer"].start_ns <= got["inner"].start_ns <= got["inner"].end_ns \
        <= got["outer"].end_ns
    assert not any(r.profiled for r in got.values())
    assert {r.thread for r in got.values()} == {threading.get_ident()}
    assert trace.records(since_ns=got["renamed"].start_ns) == [got["renamed"]]


def test_threads_keep_their_own_nesting_and_batch():
    def other():
        trace.set_batch(100)
        with trace.span("worker"):
            pass

    with trace.span("main"):
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=30)
    assert not thread.is_alive()
    got = {r.name: r for r in trace.records()}
    assert got["worker"].parent is None and got["worker"].batch == 100
    assert got["main"].batch == -1 and got["worker"].thread != got["main"].thread


def test_ring_keeps_its_newest_records_and_counts_the_rest():
    for i in range(trace.RING + 10):
        trace.count("n", i)
    kept = trace.records()
    assert len(kept) == trace.RING and trace.dropped() == 10
    assert [r.value for r in kept[:2]] == [10, 11] and kept[-1].value == trace.RING + 9
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_profiled_span_is_a_user_annotation_in_the_trace(tmp_path):
    profiler = profile(activities=[ProfilerActivity.CPU])
    profiler.start()
    with trace.span("probe.outer"):
        with trace.span("probe.inner"):
            torch.ones(3).sum()
    profiler.stop()
    with trace.span("probe.after"):
        pass
    path = tmp_path / "trace.json"
    profiler.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"probe.outer", "probe.inner"} <= annotations and "probe.after" not in annotations
    assert {r.name: r.profiled for r in trace.records()} == {
        "probe.inner": True, "probe.outer": True, "probe.after": False}


def test_no_profiler_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or pytest.fail(name))
    _, _, step = _model()
    x, y, _ = _epochs(_dataset(), 1)[0]
    step(torch.from_numpy(x), torch.from_numpy(y), torch.Generator().manual_seed(1), 0.005)
    assert opened == []
    assert [r.name for r in trace.records() if r.parent is None][-4:] == list(STEP_PARTS)


@pytest.mark.parametrize("workers", [0, 2])
def test_feed_spans_each_batch(workers):
    batches = _epochs(_dataset(), 2, workers, n_train=100)
    records = trace.records()
    consumer = threading.get_ident()
    waits = [r for r in records if r.name == "feed.wait"]
    # 100 train rows in batches of 40 (40, 40, 20), 20 held out in one
    assert len(batches) == len(waits) == 8
    assert [r.value for r in waits] == [0, 1, 2, 3] * 2
    assert [r.batch for r in waits] == list(range(8)) and trace.batch() == 7
    assert all(r.thread == consumer and r.parent is None for r in waits)
    depths = [r for r in records if r.name == "feed.depth"]
    assert [r.batch for r in depths] == list(range(8))
    assert all(isinstance(r.value, int) and 0 <= r.value <= 8 for r in depths)
    assert len([r for r in records if r.name == "feed.end"]) == 2
    producer = [r for r in records if r.name in ("feed.assemble", "feed.block_wait",
                                                 "feed.put_wait")]
    assert producer and all(r.thread != consumer for r in producer)
    assert sorted({r.batch for r in producer if r.name == "feed.assemble"}) == list(range(8))
    assert bool([r for r in producer if r.name == "feed.block_wait"]) == (workers > 0)


def test_feed_put_wait_while_the_queue_is_full():
    dataset = _dataset(rows=400)
    feed = iter(EpochBatches(dataset, np.arange(dataset.n_blocks), 400, 20, 20,
                             decompress_workers=0, prefetch=1))
    next(feed)
    threading.Event().wait(0.5)  # the producer fills the queue of one and waits
    rest = list(feed)
    assert len(rest) == 19
    waited = [r for r in trace.records() if r.name == "feed.put_wait"]
    assert waited and all(r.end_ns > r.start_ns for r in waited)


def test_train_step_spans_and_the_split_of_a_profiled_step(tmp_path):
    model, _, step = _model()
    generator = torch.Generator().manual_seed(1)
    batches = _epochs(_dataset(), 1)
    for n, (x, y, _) in enumerate(batches[:2]):
        trace.set_batch(n)
        step(torch.from_numpy(x), torch.from_numpy(y), generator, 0.005)
    records = trace.records()
    for batch in (0, 1):
        top = [r.name for r in records if r.batch == batch and r.parent is None
               and r.name.startswith("train_step.")]
        assert top == list(STEP_PARTS)
    syncs = [r for r in records if r.name == "loss.sync"]
    assert [(r.parent, r.batch) for r in syncs] == [("train_step.loss", 0),
                                                    ("train_step.loss", 1)]
    profiler = profile(activities=[ProfilerActivity.CPU])
    profiler.start()
    trace.set_batch(2)
    for x, y, _ in batches[2:]:
        step(torch.from_numpy(x), torch.from_numpy(y), generator, 0.005)
    profiler.stop()
    path = str(tmp_path / "trace.json")
    profiler.export_chrome_trace(path)
    split = trace_split.split_train_steps(path)
    assert split["steps"] == len(batches[2:]) == 1 and split["total_ms_per_step"] == 0.0
    names = {e["name"] for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(STEP_PARTS) | {"loss.sync"} <= names
    profiled = [r for r in trace.records() if r.profiled]
    assert {r.name for r in profiled} >= set(STEP_PARTS) and {r.batch for r in profiled} == {2}


def test_loop_records_each_layer(loop_records):
    """Two epochs of three train steps: every layer's spans, the optimizer
    built once, values copied and read once a step."""
    names = [r.name for r in loop_records]
    assert names.count("optimizer.build") == 1
    assert names.count("feed.wait") == names.count("values.copy") == \
        names.count("values.wait") == names.count("train_step.forward") == 6
    assert names.count("dispatch.to_device") == 12 and "dispatch.pin_copy" not in names
    assert [r.batch for r in loop_records if r.name == "values.wait"] == list(range(6))
    assert spans.train_steps(loop_records) and len(spans.train_steps(loop_records)) == 6


def test_host_line_of_an_epoch(loop_records):
    line = _host_line(loop_records)
    assert line.startswith("feed wait ") and " ms a batch, " in line
    assert "% starved; block wait " in line and " ms a train step less the loss's sync " in line
    # the last read follows no dispatch: not one step behind
    assert line.endswith("host ahead in 0 of 5 reads")


def test_host_line_says_what_the_ring_let_go(loop_records):
    line = _host_line(loop_records, lost=7)
    assert line.endswith("host ahead in 0 of 5 reads; the ring let go 7 records: "
                         "the line covers the epoch's last 6 batches")


def _record(name, start, end, batch, parent=None, value=None, thread=1):
    return trace.Record(name, thread, int(start * 1e6), int(end * 1e6), parent, batch, False,
                        value)


def test_coverage_of_the_interval_between_steps():
    """Three train steps 10 ms apart; the top-level spans cover 9 ms of the
    first interval and 8.5 of the second; a nested span does not count
    twice, another thread's not at all."""
    records = []
    for n, gap in ((0, 1.0), (1, 1.5), (2, 0.0)):
        t = 10.0 * n
        records += [_record("feed.wait", t, t + 1, n, value=n),
                    _record("dispatch.to_device", t + 1, t + 2, n),
                    _record("dispatch.pin_copy", t + 1, t + 1.5, n, "dispatch.to_device"),
                    _record("train_step.forward", t + 2, t + 4, n),
                    _record("train_step.loss", t + 4, t + 6, n),
                    _record("loss.sync", t + 4, t + 5.5, n, "train_step.loss"),
                    _record("train_step.backward", t + 6, t + 7, n),
                    _record("train_step.optimizer", t + 7, t + 8, n),
                    _record("values.copy", t + 8, t + 8.5, n),
                    _record("values.wait", t + 8.5, t + 10 - gap, n - 1),
                    _record("feed.assemble", t, t + 10, n, thread=2)]
    found = spans.coverage(records)
    assert found["intervals"] == 2 and found["interval_ms"] == pytest.approx(10.0)
    assert found["covered_ms"] == pytest.approx(8.75)
    assert found["covered_share"] == pytest.approx(0.875)
    steps = spans.train_steps(records)
    assert [s["loss.sync"] for s in steps] == pytest.approx([1.5] * 3)
    assert sum(steps[0][k] for k in spans.DISPATCH) - steps[0]["loss.sync"] == \
        pytest.approx(6.0)
    assert spans.coverage(records[:11]) is None


def test_reads_behind_leave_out_reads_right_after_their_own_dispatch():
    """Set-up's pattern (batches 0-1: dispatch, then read its values), the
    window's (batches 2-4: the read of n after n + 1's dispatch began) and
    its last read (batch 4, after no dispatch)."""
    records, t = [], 0.0
    for n in (0, 1):
        records += [_record("dispatch.to_device", t, t + 1, n),
                    _record("values.wait", t + 1, t + 3, n)]
        t += 3
    for n in (2, 3, 4):
        records.append(_record("dispatch.to_device", t, t + 1, n))
        if n > 2:
            records.append(_record("values.wait", t + 1, t + 1.05, n - 1))
        t += 2
    records.append(_record("values.wait", t, t + 3, 4))
    assert [r.batch for r in spans.reads_behind(records)] == [2, 3]
    assert spans.reads_behind(records[:4]) == []


def test_spans_script_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seed = 2**31 + 5
    assert spans.main(["--workload", "train-f32", "--seed", str(seed), "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA device(s)" in err


@pytest.fixture(scope="module")
def readers():
    spec = harness.load_spec()
    return {m["name"]: harness.load_metric(m) for m in spec["per_layer"]
            if m["name"] in NEW_METRICS}


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_reads_a_cpu_loop(name, readers, loop_records, monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: list(loop_records))
    value = readers[name].read(None)
    assert isinstance(value, float) and value >= 0.0
    if readers[name].UNIT == "%":
        assert value <= 100.0
    if name == "host_ahead_share.train":  # a read on the CPU never waits
        assert value == 0.0


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_finds_nothing(name, readers, monkeypatch):
    assert readers[name].read(None) is None
    # a program without the recorder, as a parent commit may be
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "clair_tpu_torch.utils.trace", None)
    assert spans.unprofiled() == [] and readers[name].read(None) is None


def test_readers_leave_out_profiled_records(readers, loop_records, monkeypatch):
    profiled = [r._replace(profiled=True) for r in loop_records]
    monkeypatch.setattr(trace, "records", lambda: profiled)
    assert all(reader.read(None) is None for reader in readers.values())


def test_feed_holds_two_batches_ready_by_default():
    """The producer runs ahead of the consumer by the queue's two batches
    (and the one it waits to put), not by the whole epoch."""
    dataset = _dataset(rows=400)
    feed = iter(EpochBatches(dataset, np.arange(dataset.n_blocks), 400, 20, 20,
                             decompress_workers=0))
    next(feed)
    threading.Event().wait(0.5)  # the producer fills the queue and waits
    assembled = [r for r in trace.records() if r.name == "feed.assemble"]
    assert len(assembled) == 1 + 2 + 1
    assert len(list(feed)) == 19
