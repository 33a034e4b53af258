"""Clair3_F's backward's share of its roofline: the least time the card
could take for the whole model's backward at the cell's batch
(portbench/work_fa.py: every convolution's data and weight gradients but
the first's data gradient, the dense layers', and the bytes of batch norm's,
ReLU's, the residual sums' and the pyramid's gradients; against the bf16
tensor peak and the HBM rate) over the device milliseconds a step of every
kernel launched under ``train_step.backward`` or by autograd's engine, in
the "host" stretch (portbench/fa_trace.py)."""

from portbench.work_fa import backward_work, roofline_ms

LAYER = "step (parallel/sharding.py train step: forward, loss, backward, clip, Adam)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(readings):
    measured = readings.trace.get("fa", {}).get("backward_ms", 0.0)
    if measured <= 0:
        return None
    return 100.0 * roofline_ms(backward_work(readings.model, readings.batch)) / measured
