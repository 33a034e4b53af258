"""Host milliseconds a train step's dispatch takes, unprofiled: the median
over the train steps outside the traced window's profiled stretches of the
program's spans ``dispatch.to_device`` (pipeline/train.py:_to_device, x
and y), the four ``train_step.*`` (parallel/sharding.py:make_train_step)
and ``values.copy`` (pipeline/train.py:_StepValues), less ``loss.sync``,
the loss's wait for the forward inside ``train_step.loss``. Where it
exceeds the step's device time, the host paces the card."""

from portbench import spans

LAYER = "step dispatch (parallel/sharding.py make_train_step, pipeline/train.py _to_device)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "train_samples_per_s"


def read(readings):
    return spans.median([sum(step.get(name, 0.0) for name in spans.DISPATCH)
                         - step.get("loss.sync", 0.0)
                         for step in spans.train_steps(spans.unprofiled())])
