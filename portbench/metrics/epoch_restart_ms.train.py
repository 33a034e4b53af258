"""Host milliseconds the consumer waits for each epoch's first batch: the
median of the program's ``feed.wait`` spans whose value, the batch's index
in its epoch, is 0 (data/bins.py:EpochBatches: the producer thread and
the decompress pool start, and the first batch's blocks decompress),
outside the traced window's profiled stretches."""

from portbench import spans

LAYER = "feed (data/bins.py EpochBatches)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    return spans.median([spans.ms(r) for r in spans.unprofiled()
                         if r.name == "feed.wait" and r.value == 0])
