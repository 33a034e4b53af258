"""The 95th percentile of the intervals between consecutive steps'
completions on the device: a CUDA event recorded after each step of the
traced window outside its profiled stretches, read once it has closed,
over every pair of consecutive such steps. None off a
CUDA device, and under 20 intervals, where the percentile is a maximum."""

import statistics

LAYER = "step (parallel/sharding.py train step: forward, loss, backward, clip, Adam)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    intervals = readings.step_intervals_ms
    if len(intervals) < 20:
        return None
    return statistics.quantiles(intervals, n=100)[94]
