"""Host milliseconds a step waits on the feed: the harness's span around
``next()`` of data/bins.py:EpochBatches, the mean over every step of the
traced window outside its profiled stretches (train and validation steps
alike)."""

import statistics

LAYER = "feed (data/bins.py EpochBatches)"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    spans = readings.spans.get("feed")
    return statistics.fmean(spans) * 1e3 if spans else None
