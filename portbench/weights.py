"""The model's starting weights, made from a seed on the device.

The same initialisers as the JAX package and the port (glorot-uniform for
the LSTMs' W and U, a unit normal truncated to (-2, 2) and scaled to
sqrt(1 / fan_in) / 0.8796 for L3 and the dense layers, zero biases), drawn
here, by the benchmark, and handed alike to the program and to the plain
reference: one ``torch.rand`` call on the device for every weight at once,
then each leaf's transform of its slice. Weights are float32 masters, as
the port keeps them whatever it computes in.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# stddev of a unit normal truncated to (-2, 2)
_TRUNCATED_STDDEV = 0.87962566103423978


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """The last two axes are (in, out), the others receptive field."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def make_weights(shapes: Dict[str, Tuple[int, ...]], generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{leaf name: float32 tensor on ``device``} for ``shapes`` (leaf names
    as the port's state_dict keys: ``lstm1.fw.w``, ``l3.b``, ...)."""
    weights = {k: s for k, s in shapes.items() if not k.endswith(".b")}
    total = sum(math.prod(s) for s in weights.values())
    uniform = torch.rand(total, generator=generator, device=device)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    out, at = {}, 0
    for name, shape in shapes.items():
        if name not in weights:
            out[name] = torch.zeros(shape, device=device)
            continue
        size = math.prod(shape)
        u = uniform[at:at + size].view(shape)
        at += size
        fan_in, fan_out = _fans(shape)
        if name.startswith("lstm"):
            out[name] = (u * 2.0 - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
        else:
            z = (math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))).clamp_(-2.0, 2.0)
            out[name] = z * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STDDEV)
    return out
