"""Device milliseconds a train step spends copying x to the card: the
host-to-device copies launched inside the program's ``dispatch.to_device``
spans (pipeline/train.py:_to_device) whose size the program's counter
``dispatch.x_bytes`` recorded, summed over the "host" stretch and divided
by its train steps (portbench/fa_trace.py). The copy is enqueued on the
compute stream, so the card runs no kernel while it lasts. None where the
program has no such counter."""

LAYER = "step dispatch (parallel/sharding.py make_train_step, pipeline/train.py _to_device)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    return readings.trace.get("fa", {}).get("h2d_x_ms")
