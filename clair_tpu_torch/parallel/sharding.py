"""Optimizer and the train and eval steps, on one device (port of the
single-device part of clair_tpu/parallel/sharding.py).

The JAX step is a pure function of (params, opt_state); here the model owns
its parameters and the optimizer its state, and a step updates both in
place. A mesh (data or model parallelism) is not ported yet: passing one
raises.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from clair_tpu_torch.params import GRADIENT_CLIP_NORM, MOMENTUM
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.models.losses import total_loss

_MESH_TODO = ("a mesh (multi-GPU data or model parallelism) is not ported yet "
              "(ROADMAP Queue 1, 'Multi-GPU')")


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every gradient becomes (g / norm) * max_norm. No 1e-6 in
    the divisor (torch.nn.utils.clip_grad_norm_ adds one), and no host
    sync. Returns the norm."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class ClippedOptimizer:
    """Clip by global norm (GRADIENT_CLIP_NORM), then Adam (optax defaults:
    b1 0.9, b2 0.999, eps 1e-8) or SGD with momentum. The learning rate
    lives in ``inner.param_groups`` and may change between steps."""

    def __init__(self, named_params: Dict[str, torch.Tensor], optimizer_name: str,
                 learning_rate: float, momentum: float):
        # the JAX tree's leaf order (sorted paths), for the norm's sum
        self.params = [named_params[k] for k in sorted(named_params)]
        if optimizer_name == "Adam":
            self.inner = torch.optim.Adam(self.params, lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif optimizer_name == "SGDM":
            self.inner = torch.optim.SGD(self.params, lr=learning_rate, momentum=momentum)
        else:
            raise ValueError(f"unknown optimizer {optimizer_name}")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_by_global_norm_(grads, GRADIENT_CLIP_NORM)
        self.inner.step()


def make_optimizer(named_params: Dict[str, torch.Tensor], optimizer_name: str = "Adam",
                   learning_rate: float = 1e-3, momentum: float = MOMENTUM) -> ClippedOptimizer:
    """Gradient clip (global norm 5) + Adam or SGD-M over the named
    parameters, with a mutable learning rate."""
    return ClippedOptimizer(named_params, optimizer_name, learning_rate, momentum)


def set_learning_rate(optimizer: ClippedOptimizer, learning_rate: float) -> None:
    for group in optimizer.inner.param_groups:
        group["lr"] = learning_rate


def loss_fn(model: ClairNet, x, y, generator: Optional[torch.Generator], l2_lambda,
            deterministic: bool = False, sample_weights=None):
    """(loss, components) of one batch; L2 over the float32 masters."""
    config = model.config
    logits = model.forward_logits(x, deterministic=deterministic, generator=generator)
    return total_loss(
        logits, y, dict(model.named_parameters()),
        loss_function=config.loss_function,
        l2_lambda=l2_lambda,
        task_weights=config.task_loss_weights,
        sample_weights=sample_weights,
    )


def _detached(loss, components) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return loss.detach(), {k: v.detach() for k, v in components.items()}


def make_train_step(model: ClairNet, optimizer: ClippedOptimizer, mesh=None):
    """step(x, y, generator, l2_lambda, sample_weights=None) -> (loss,
    components): the training forward (dropout from ``generator``), the
    backward, clip and update. Returns the pre-update loss as device
    tensors; nothing waits for the device."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)

    def step(x, y, generator, l2_lambda, sample_weights=None):
        optimizer.zero_grad()
        loss, components = loss_fn(model, x, y, generator, l2_lambda, False, sample_weights)
        loss.backward()
        optimizer.step()
        return _detached(loss, components)

    return step


def make_eval_step(model: ClairNet, mesh=None):
    """step(x, y, l2_lambda, sample_weights=None) -> (loss, components),
    the deterministic forward without a gradient."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)

    def step(x, y, l2_lambda, sample_weights=None):
        with torch.no_grad():
            return _detached(*loss_fn(model, x, y, None, l2_lambda, True, sample_weights))

    return step
