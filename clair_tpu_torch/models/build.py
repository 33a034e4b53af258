"""The network a model config names: Clair v2's ClairNet for a
``params.ModelConfig``, Clair3's full-alignment Clair3FANet for a
``FullAlignmentConfig``. The training loop and the evaluation build
through here and do not branch on the model."""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Union

import torch
from torch import nn

from clair_tpu_torch.models import clair, clair3_fa
from clair_tpu_torch.params import ModelConfig

if TYPE_CHECKING:
    from clair_tpu_torch.parallel.tensor_parallel import TensorParallel

Config = Union[ModelConfig, clair3_fa.FullAlignmentConfig]


def init_params(generator: torch.Generator, config: Config) -> Dict:
    """A fresh parameter tree in the JAX layout (with Clair3_F's running
    statistics)."""
    if isinstance(config, clair3_fa.FullAlignmentConfig):
        return clair3_fa.init_params(generator, config)
    return clair.init_params(generator, config)


def build_model(params: Dict, config: Config, device=None,
                tensor_parallel: Optional["TensorParallel"] = None,
                scan: bool = False) -> nn.Module:
    """The model holding ``params``; ``tensor_parallel`` and ``scan`` are
    ClairNet's (Clair3_F trains on one device and has no BiLSTM)."""
    if isinstance(config, clair3_fa.FullAlignmentConfig):
        return clair3_fa.Clair3FANet.from_jax(params, config, device)
    return clair.ClairNet.from_jax(params, config, device, tensor_parallel, scan)
