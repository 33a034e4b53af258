"""Host milliseconds to copy a batch into pinned memory and enqueue its step
(pipeline/train.py:_to_device and the step of
parallel/sharding.py:make_train_step), less the time the host spends
waiting for the device inside them: the mean, over the steps of the traced
window's "host" stretch (kinds/train.py:_Stretch), of each
``portbench.dispatch`` range less its synchronising CUDA runtime calls
(portbench/devtrace.py:read_host). Under the host's profiling, so it reads
above an unprofiled step's. Above the step's device time, the host does
not keep ahead of the card."""

LAYER = "step dispatch (parallel/sharding.py make_train_step, pipeline/train.py _to_device)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    return readings.trace.get("dispatch_ms")
