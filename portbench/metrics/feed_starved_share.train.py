"""Share of the batches whose consumer found the feed's queue empty: the
program's counter ``feed.depth`` (the queue's depth before each batch's
``feed.wait``, data/bins.py:EpochBatches), over every batch recorded
outside the traced window's profiled stretches."""

from portbench import spans

LAYER = "feed (data/bins.py EpochBatches)"
UNIT = "%"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    depths = [r.value for r in spans.unprofiled() if r.name == "feed.depth"]
    if not depths:
        return None
    return 100.0 * sum(d == 0 for d in depths) / len(depths)
