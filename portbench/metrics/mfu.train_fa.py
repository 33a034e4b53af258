"""The whole step's share of the card's peak for Clair3_F: the model FLOPs
of the rows the "device" stretch of the traced window completed (3
forwards a training row, 1.355 GFLOP at the published widths, 1 a
validation row, no recompute; portbench/work_fa.py) over that stretch's
seconds (portbench/devtrace.py:read_device), against the dense bf16 tensor
peak."""

from portbench.work import PEAK_BF16_FLOPS
from portbench.work_fa import model_flops

LAYER = "device (the card, from the profiler's trace)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(readings):
    trace, rows = readings.trace, readings.profiled_rows
    if not trace.get("window_s") or not rows.get("train", 0) + rows.get("eval", 0):
        return None
    flops = model_flops(readings.model, rows.get("train", 0), rows.get("eval", 0))
    return 100.0 * flops / trace["window_s"] / PEAK_BF16_FLOPS
