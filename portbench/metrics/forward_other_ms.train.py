"""Device milliseconds a train step of the kernels launched under its
``train_step.forward`` range other than row 1 (the BiLSTM forward): the
model's casts, L3, the dense layers, SELU and dropout. From the "host"
stretch of the traced window (kinds/train.py:_Stretch), split by
portbench/trace_split.py."""

LAYER = "model (models/clair.py ClairNet)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    split = readings.split
    if not split or not split["steps"] or not split["total_ms_per_step"]:
        return None
    return split["ms_per_step"]["forward"]
