"""Row 2's share of its roofline a train step: the least time its work
could take on the card (portbench/work.py: both layers' backward at the
cell's batch, dx for the second, the larger of its operations over the
bf16 tensor peak and its bytes over the HBM rate) over the device
milliseconds a step of the kernels the frozen splitter puts in row 2, in
the "host" stretch."""

from portbench.work import roofline_ms, train_backward_work

LAYER = "kernels (ops/bilstm_stream.py, csrc/bilstm_stream_fwd.cu and bilstm_stream_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(readings):
    split = readings.split
    measured = split["ms_per_step"]["row 2"] if split and split["steps"] else 0.0
    if measured <= 0:
        return None
    least = roofline_ms(train_backward_work(readings.model, readings.batch, readings.dtype))
    return 100.0 * least / measured
