"""The trace readers on a small hand-made profiler trace: busy and idle
time, and the host's own dispatch time less its waits for the device."""

import json

import pytest

from portbench import devtrace


def x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_dispatch_less_its_waits(tmp_path):
    events = [
        x(devtrace.STRETCH, "user_annotation", 0, 1000),
        # two dispatches: 300 us with a 200 us wait, 100 us with none
        x(devtrace.DISPATCH, "user_annotation", 0, 300),
        x("cudaLaunchKernel", "cuda_runtime", 10, 5),
        x("cudaStreamSynchronize", "cuda_runtime", 50, 200),
        x(devtrace.DISPATCH, "user_annotation", 500, 100),
        x("cudaLaunchKernel", "cuda_runtime", 510, 5),
        # another thread's wait is not the dispatching thread's
        x("cudaStreamSynchronize", "cuda_runtime", 520, 50, tid=2),
        x("kernel_a", "kernel", 20, 400, tid=7),
        x("kernel_b", "kernel", 520, 300, tid=7),
    ]
    found = devtrace.read_host(write(tmp_path, events))
    assert found["dispatch_ms"] == pytest.approx((100 + 100) / 2 / 1e3)
    assert found["dispatch_wait_ms"] == pytest.approx(200 / 2 / 1e3)
    # idle: 0-20, 420-520 and 820-1000 inside the stretch
    assert sorted(g for _, g in found["idle_gaps"]) == pytest.approx([20e-6, 100e-6, 180e-6])


def test_device_busy_and_window(tmp_path):
    events = [x("k1", "kernel", 100, 50), x("k2", "kernel", 120, 80), x("c", "gpu_memcpy", 300, 100),
              x("op", "cpu_op", 0, 1000)]
    found = devtrace.read_device(write(tmp_path, events))
    assert found["busy_s"] == pytest.approx(200e-6)
    assert found["window_s"] == pytest.approx(300e-6)
    assert [n for n, _ in found["device_ops"]] == ["c", "k2", "k1"]


def test_nothing_to_read(tmp_path):
    assert devtrace.read_device(write(tmp_path, [x("op", "cpu_op", 0, 10)])) == {}
    assert devtrace.read_host(write(tmp_path, [x("op", "cpu_op", 0, 10)])) == {}
