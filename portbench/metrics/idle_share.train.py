"""Share of the "device" stretch of the traced window (kinds/train.py:
_Stretch, the device's activity alone) in which no kernel, copy or fill ran
on the device (portbench/devtrace.py:read_device)."""

LAYER = "device (the card, from the profiler's trace)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    trace = readings.trace
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
