"""Host milliseconds a train step waits inside its loss for the device to
finish the forward: the median over the train steps outside the traced
window's profiled stretches of the program's ``loss.sync`` span
(models/losses.py:total_loss, the task weights' copy from pageable memory,
which waits for the work queued before it). While it lasts the host
enqueues nothing, so the backward starts only after the forward is done."""

from portbench import spans

LAYER = "step (parallel/sharding.py train step: forward, loss, backward, clip, Adam)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    return spans.median([step["loss.sync"] for step in spans.train_steps(spans.unprofiled())
                         if "loss.sync" in step])
