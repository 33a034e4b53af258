"""The training loop's dispatch waits for the card nowhere but in the read
of the previous step's values: warm train steps, from the batch's copy to
the device (pipeline/train.py:_to_device) through the loss, backward,
clip and Adam (parallel/sharding.py:make_train_step) to the values' copy
(_StepValues), run under torch.cuda.set_sync_debug_mode("error"), which
raises at any call that synchronises the host with the device. The
values are read one step behind, as train_model reads them, outside that
mode. Card only (marker ``cuda``)."""

import numpy as np
import pytest
import torch

from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.parallel.sharding import make_optimizer, make_train_step
from clair_tpu_torch.params import ModelConfig
from clair_tpu_torch.pipeline.train import _StepValues, _to_device

BATCH = 256
WARM, CHECKED = 3, 4


def _feed(rs, n, input_shape):
    """int16 rows and one-hot labels, as EpochBatches gives them."""
    x = rs.randint(-20, 50, (n,) + tuple(input_shape)).astype(np.int16)
    y = np.zeros((n, 90), np.int16)
    for off, width in ((0, 21), (21, 3), (24, 33), (57, 33)):
        y[np.arange(n), off + rs.randint(0, width, n)] = 1
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_warm_train_steps_never_wait_for_the_card(compute_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    device = torch.device("cuda", torch.cuda.current_device())
    torch.manual_seed(0)
    model = ClairNet(ModelConfig(compute_dtype=compute_dtype), device)
    optimizer = make_optimizer(dict(model.named_parameters()), "Adam", 1e-3)
    step = make_train_step(model, optimizer)
    generator = torch.Generator(device).manual_seed(1)
    rs = np.random.RandomState(2)
    batches = [_feed(rs, BATCH, model.config.input_shape) for _ in range(WARM + CHECKED)]

    def dispatch(x, y):
        loss, components = step(_to_device(x, device), _to_device(y, device), generator, 0.005)
        return _StepValues(loss, components, True)

    losses, pending = [], None
    for n, (x, y) in enumerate(batches):
        checked = n >= WARM
        torch.cuda.set_sync_debug_mode("error" if checked else "default")
        try:
            values = dispatch(x, y)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if pending is not None:
            losses.append(pending.read()["loss"])
        pending = values
    losses.append(pending.read()["loss"])
    assert len(losses) == WARM + CHECKED and np.isfinite(losses).all()
