"""Host seconds of set-up spent building the optimizer: the program's
``optimizer.build`` span (parallel/sharding.py:make_optimizer), the first
made; the first Adam of a process imports torch._dynamo."""

from portbench import spans

LAYER = "step (parallel/sharding.py train step: forward, loss, backward, clip, Adam)"
UNIT = "s"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "setup_s"


def read(readings):
    built = [r for r in spans.unprofiled() if r.name == "optimizer.build"]
    return spans.ms(built[0]) / 1e3 if built else None
