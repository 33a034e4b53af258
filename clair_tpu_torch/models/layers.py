"""Self-normalizing-network primitives (port of clair_tpu/models/layers.py).

SELU's constants are those of Klambauer et al. 2017 and of the JAX package,
so trained checkpoints behave identically. Dropout and alpha-dropout serve
training only and come with the training port.
"""

from __future__ import annotations

import torch

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x >= 0.0, x, SELU_ALPHA * torch.expm1(x))
