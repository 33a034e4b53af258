"""Clair3_F's convolutional trunk's share of its roofline in the forward: the
least time the card could take for the trunk's forward at the cell's batch
(portbench/work_fa.py: each convolution's operations and bytes, batch
norm's, ReLU's and the residual adds' bytes; the larger of the operations
over the bf16 tensor peak and the bytes over the HBM rate) over the device
milliseconds a step of the kernels launched inside the program's ``fa.trunk``
range under ``train_step.forward``, in the "host" stretch
(portbench/fa_trace.py)."""

from portbench.work_fa import roofline_ms, trunk_forward_work

LAYER = "model (models/clair3_fa.py Clair3FANet)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "train_samples_per_s"


def read(readings):
    measured = readings.trace.get("fa", {}).get("trunk_fwd_ms", 0.0)
    if measured <= 0:
        return None
    return 100.0 * roofline_ms(trunk_forward_work(readings.model, readings.batch)) / measured
