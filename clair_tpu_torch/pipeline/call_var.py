"""The calling Predictor on a torch device (port of the single-device
``Predictor`` of clair_tpu/pipeline/call_var.py).

It has the JAX Predictor's duck-typed surface -- ``batch_size``,
``eager_host_copy``, ``predict_async(x) -> (handle, n)``, ``gather`` and
``gather_group`` -- so the host runners of the JAX package
(``call_bam.call_window``, ``call_bam_parallel.call_bam_windows_threaded``,
``call_var.call_variants``) take it unchanged.

Link semantics are the JAX Predictor's: a batch is padded to
``batch_size``; raw uint8 counts ship as they are and are channel-normalized
on the device (``_device_input``); normalized float windows (over-byte
depth) ship as int16 (``clair_tpu.pipeline.call_var._pack_uplink``). Both
may arrive in one run.

On a CUDA device a batch goes host -> device from pinned memory without
blocking, runs the forward, and, with ``eager_host_copy``, starts its
(B, 90) result's copy into pinned host memory at once; ``gather`` waits on
the batch's event. With ``eager_host_copy`` off the copy happens in
``gather``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from clair_tpu.params import PREDICT_BATCH_SIZE, ModelConfig
from clair_tpu.pipeline.call_var import _pack_uplink
from clair_tpu.task.labels import split_label_vector
from clair_tpu_torch.models.clair import ClairNet


def _device_input(x: torch.Tensor) -> torch.Tensor:
    """float32 model input from a link batch. Raw uint8 counts get the
    channel normalization (ch1..3 -= ch0) here; int16 batches arrive
    normalized. Counts are small integers, so this equals host
    normalization exactly."""
    xf = x.float()
    if x.dtype == torch.uint8:
        xf = torch.cat([xf[..., :1], xf[..., 1:] - xf[..., :1]], dim=-1)
    return xf


@dataclass
class Predictor:
    """Fixed-shape forward over padded batches on one torch device."""

    params: dict
    config: ModelConfig
    batch_size: int = PREDICT_BATCH_SIZE
    # start each batch's device->host copy at dispatch; the threaded WGS
    # runner turns it off and fetches in its consumer thread instead
    eager_host_copy: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self._device = torch.device(self.device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError(
                "Predictor(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is false"
            )
        self.model = ClairNet.from_jax(self.params, self.config, self._device)

    def predict_async(self, x: np.ndarray):
        """Dispatch one (possibly short) batch; returns (handle, n)."""
        n = x.shape[0]
        link = torch.from_numpy(_pack_uplink(x, self.batch_size))
        if self._cuda:
            link = link.pin_memory()
        with torch.inference_mode():
            x_dev = link.to(self._device, non_blocking=True)
            out = torch.cat(self.model(_device_input(x_dev)), dim=-1)
        if self._cuda and self.eager_host_copy:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return (host, done), n
        return (out, None), n

    def gather(self, handle, n: int):
        """The batch's (n, 90) output split into the four head arrays."""
        out, done = handle
        if done is not None:
            done.synchronize()
        return split_label_vector(out[:n].cpu().numpy())

    def gather_group(self, handles: Sequence, ns: Sequence[int]) -> List[Tuple]:
        """Per-batch head arrays of several batches, in order."""
        return [self.gather(h, n) for h, n in zip(handles, ns)]

