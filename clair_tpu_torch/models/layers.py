"""Self-normalizing-network primitives (port of clair_tpu/models/layers.py).

SELU's and alpha-dropout's constants are those of Klambauer et al. 2017 and
of the JAX package, so trained checkpoints behave identically. Every random
draw comes from a ``torch.Generator`` the caller passes; it cannot give the
bits of JAX's generators, so the two packages agree in distribution, not in
samples.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
# the value a dropped SELU unit saturates to: -scale * alpha
ALPHA_DROPOUT_VALUE = -1.7580993408473766
# stddev of a unit normal truncated to (-2, 2): the truncated draw is divided
# by it so the kept samples have the variance asked for (as JAX's
# variance_scaling does)
_TRUNCATED_STDDEV = 0.87962566103423978


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x >= 0.0, x, SELU_ALPHA * torch.expm1(x))


def _keep_mask(generator: torch.Generator, x: torch.Tensor, keep_prob: float) -> torch.Tensor:
    return torch.rand(x.shape, generator=generator, device=x.device) < keep_prob


def alpha_dropout(
    generator: torch.Generator,
    x: torch.Tensor,
    rate: float,
    fixed_point_mean: float = 0.0,
    fixed_point_var: float = 1.0,
) -> torch.Tensor:
    """Dropout for SELU networks: dropped units are set to alpha' and the
    output is affinely rescaled to keep the fixed point's mean and
    variance."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    alpha_p = ALPHA_DROPOUT_VALUE
    ret = torch.where(_keep_mask(generator, x, keep_prob), x, alpha_p)
    a = (fixed_point_var / (keep_prob * ((1 - keep_prob) * (alpha_p - fixed_point_mean) ** 2
                                         + fixed_point_var))) ** 0.5
    b = fixed_point_mean - a * (keep_prob * fixed_point_mean + (1 - keep_prob) * alpha_p)
    return a * ret + b


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout (between the LSTM layers)."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    return torch.where(_keep_mask(generator, x, keep_prob), x / keep_prob, 0.0)


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """JAX's fan rule: the last two axes are (in, out) and every other axis
    is receptive field, so an (F, T, U) weight has fan_in = T * F."""
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def he_fan_in(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """variance_scaling(1.0, "fan_in", "truncated_normal"): a unit normal
    truncated to (-2, 2), scaled to stddev sqrt(1 / fan_in) / 0.8796."""
    fan_in, _ = _fans(shape)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    # inverse-CDF sampling of the truncated normal, as jax.random does
    uniform = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + uniform * (hi - lo))
    z = z.clamp(-2.0, 2.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNCATED_STDDEV)).to(torch.float32)


def glorot_uniform(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """variance_scaling(1.0, "fan_avg", "uniform"): U(-l, l) with
    l = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    uniform = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (uniform * 2.0 - 1.0) * limit
