"""Share of the reads of a step's values that waited over 0.1 ms for the
device: the program's ``values.wait`` spans (pipeline/train.py:
_StepValues.read) of the reads made one step behind the dispatch, after
the next batch's dispatch had begun (portbench/spans.py:reads_behind; not
set-up's steps, nor the window's last read), outside the traced window's
profiled stretches. Such a read waits only where the host has run ahead of
the card; near 0, the host paces the step."""

from portbench import spans

LAYER = "step dispatch (parallel/sharding.py make_train_step, pipeline/train.py _to_device)"
UNIT = "%"
SOURCE = "program_span"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(readings):
    waits = [spans.ms(r) for r in spans.reads_behind(spans.unprofiled())]
    if not waits:
        return None
    return 100.0 * sum(w > 0.1 for w in waits) / len(waits)
