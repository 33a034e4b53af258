"""Optimizer and the train and eval steps (port of
clair_tpu/parallel/sharding.py).

The JAX step is a pure function of (params, opt_state); here the model owns
its parameters and the optimizer its state, and a step updates both in
place. Given a mesh (parallel/mesh.py: a DeviceMesh over the ranks of
torch.distributed, one device each) each rank computes its data row's
stripe of the global batch, DistributedDataParallel sums the gradients
over its 'data' group during ``backward()``, and the step returns the
global batch's loss. Where the mesh's 'model' axis is wider than 1, each
model column is a DDP group of its own over its shard of the dense trunk
(parallel/tensor_parallel.py), and:

- the L2 term is the unsharded model's: its sharded part is summed over
  the model group (gradient passed through), and the lead of each data
  group alone adds it, so its gradient is added once per column;
- the clip's global norm adds the model-group sum of the sharded
  gradients' squares to the replicated gradients' squares: the unsharded
  norm, the same on every rank;
- the reported loss sums the task terms over 'data' only (every rank of a
  model group computed them whole) with the L2 term counted once.

Adam works element by element, so each rank updates its shard alone.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from clair_tpu_torch.params import GRADIENT_CLIP_NORM, MOMENTUM
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.models.losses import COMPONENTS, l2_regularization, total_loss
from clair_tpu_torch.parallel.tensor_parallel import TensorParallel, shard_dim
from clair_tpu_torch.utils import trace


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                         sharded: Iterable[torch.Tensor] = (),
                         tensor_parallel: Optional[TensorParallel] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every gradient becomes (g / norm) * max_norm. No 1e-6 in
    the divisor (torch.nn.utils.clip_grad_norm_ adds one), and no host
    sync. ``sharded``: the gradients of this rank's shards, whose squares
    are summed over ``tensor_parallel``'s group, so that the norm is the
    unsharded model's. Returns the norm."""
    grads, sharded = list(grads), list(sharded)
    squares = sum(torch.sum(g * g) for g in grads)
    if sharded:
        squares = squares + tensor_parallel.reduce_from_model(
            sum(torch.sum(g * g) for g in sharded))
    norm = torch.sqrt(squares)
    keep = norm < max_norm
    for g in grads + sharded:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


class ClippedOptimizer:
    """Clip by global norm (GRADIENT_CLIP_NORM), then Adam (optax defaults:
    b1 0.9, b2 0.999, eps 1e-8) or SGD with momentum. The learning rate
    lives in ``inner.param_groups`` and may change between steps."""

    def __init__(self, named_params: Dict[str, torch.Tensor], optimizer_name: str,
                 learning_rate: float, momentum: float):
        # the JAX tree's leaf order (sorted paths), for the norm's sum
        self.names = sorted(named_params)
        self.params = [named_params[k] for k in self.names]
        if optimizer_name == "Adam":
            self.inner = torch.optim.Adam(self.params, lr=learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        elif optimizer_name == "SGDM":
            self.inner = torch.optim.SGD(self.params, lr=learning_rate, momentum=momentum)
        else:
            raise ValueError(f"unknown optimizer {optimizer_name}")

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, tensor_parallel: Optional[TensorParallel] = None) -> torch.Tensor:
        """Clip and update; returns the global norm before the clip. With
        ``tensor_parallel`` (the model's, where it holds a shard) the norm
        is the unsharded model's."""
        grads = [(p.grad, tensor_parallel is not None and shard_dim(k) is not None)
                 for k, p in zip(self.names, self.params) if p.grad is not None]
        norm = clip_by_global_norm_([g for g, s in grads if not s], GRADIENT_CLIP_NORM,
                                    [g for g, s in grads if s], tensor_parallel)
        self.inner.step()
        return norm


def make_optimizer(named_params: Dict[str, torch.Tensor], optimizer_name: str = "Adam",
                   learning_rate: float = 1e-3, momentum: float = MOMENTUM) -> ClippedOptimizer:
    """Gradient clip (global norm 5) + Adam or SGD-M over the named
    parameters, with a mutable learning rate. The span ``optimizer.build``
    times it: the first Adam of a process imports torch._dynamo."""
    with trace.span("optimizer.build"):
        return ClippedOptimizer(named_params, optimizer_name, learning_rate, momentum)


def set_learning_rate(optimizer: ClippedOptimizer, learning_rate: float) -> None:
    for group in optimizer.inner.param_groups:
        group["lr"] = learning_rate


def loss_fn(model: ClairNet, x, y, generator: Optional[torch.Generator], l2_lambda,
            deterministic: bool = False, sample_weights=None):
    """(loss, components) of one batch; L2 over the float32 masters."""
    logits = model.forward_logits(x, deterministic=deterministic, generator=generator)
    return _loss(model, logits, y, l2_lambda, sample_weights)


def _loss(model: ClairNet, logits, y, l2_lambda, sample_weights):
    config = model.config
    params = dict(model.named_parameters())
    tp = model.tensor_parallel
    l2_raw = None
    if tp is not None:
        # the unsharded model's L2: the shards' part summed over the model
        # group, the replicated part counted once
        sharded = {k: v for k, v in params.items() if shard_dim(k) is not None}
        replicated = {k: v for k, v in params.items() if k not in sharded}
        l2_raw = l2_regularization(replicated) + tp.reduce_from_model(
            l2_regularization(sharded))
    return total_loss(
        logits, y, params,
        loss_function=config.loss_function,
        l2_lambda=l2_lambda,
        task_weights=config.task_loss_weights,
        sample_weights=sample_weights,
        l2_raw=l2_raw,
    )


def _detached(loss, components) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return loss.detach(), {k: v.detach() for k, v in components.items()}


class _TrainingForward(nn.Module):
    """The training forward as a module's ``forward``, for
    DistributedDataParallel, which readies its gradient reduction in the
    forward it wraps. It holds the model's parameters under the prefix
    ``model.`` (and DDP adds ``module.``): the optimizer, the L2 term and the
    checkpoints take their names from the unwrapped ClairNet."""

    def __init__(self, model: ClairNet):
        super().__init__()
        self.model = model

    def forward(self, x, generator):
        return self.model.forward_logits(x, deterministic=False, generator=generator)


def _sum_hook(group, bucket):
    """A DDP communication hook that SUMS the ranks' gradients (DDP's
    default averages them): the loss is a sum over the batch, so the
    global gradient is the sum of the stripes' gradients."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


class _DataParallel:
    """What a step needs of a mesh: this rank's 'data' group and whether
    this rank leads it. The lead rank alone adds L2 (its gradient would
    otherwise be summed once per rank)."""

    def __init__(self, mesh):
        self.group = mesh.get_group("data")
        self.lead = mesh.get_local_rank("data") == 0

    def l2_lambda(self, l2_lambda):
        return l2_lambda if self.lead else 0.0

    def summed(self, loss, components):
        """The global batch's loss and components: the sums over the data
        group of each rank's (L2 comes from the lead rank alone, and
        l2_without_lambda, the same on every rank, is not summed). The
        ranks of a model group computed the same task terms, so the sum
        runs over 'data' only."""
        values = torch.stack([loss.detach(), *(components[k].detach() for k in COMPONENTS)])
        dist.all_reduce(values, group=self.group)
        out = {k: v.detach() for k, v in components.items()}
        out.update(zip(COMPONENTS, values[1:]))
        return values[0], out


def make_train_step(model: ClairNet, optimizer: ClippedOptimizer, mesh=None):
    """step(x, y, generator, l2_lambda, sample_weights=None) -> (loss,
    components): the training forward (dropout from ``generator``), the
    backward, clip and update. Returns the pre-update loss as device
    tensors; nothing waits for the device (the loss's task weights are
    held there, models/losses.py), so the host may enqueue the next step
    while the card runs this one.

    With a mesh, x and y are this rank's stripe of the global batch and the
    returned loss is the global batch's. The gradients are summed over the
    data group inside ``backward()``, so the clip sees the global norm, and
    every rank of a model column applies the same update."""
    if mesh is None:
        forward, l2_of, reported = _TrainingForward(model), lambda l2: l2, _detached
    else:
        parallel = _DataParallel(mesh)
        # DDP broadcasts the lead rank's parameters to the others here
        forward = DistributedDataParallel(_TrainingForward(model), process_group=parallel.group)
        forward.register_comm_hook(parallel.group, _sum_hook)
        l2_of, reported = parallel.l2_lambda, parallel.summed

    # the spans name the step's parts, in a profiler's trace too, where
    # tools/torch_trace_split.py splits the step by these names
    def step(x, y, generator, l2_lambda, sample_weights=None):
        with trace.span("train_step.forward"):
            optimizer.zero_grad()
            logits = forward(x, generator)
        with trace.span("train_step.loss"):
            loss, components = _loss(model, logits, y, l2_of(l2_lambda), sample_weights)
        with trace.span("train_step.backward"):
            loss.backward()
        with trace.span("train_step.optimizer"):
            optimizer.step(model.tensor_parallel)
        return reported(loss, components)

    return step


def make_eval_step(model: ClairNet, mesh=None):
    """step(x, y, l2_lambda, sample_weights=None) -> (loss, components),
    the deterministic forward without a gradient; with a mesh, of the
    global batch, x and y being this rank's stripe."""
    parallel = _DataParallel(mesh) if mesh is not None else None

    def step(x, y, l2_lambda, sample_weights=None):
        with torch.no_grad():
            if parallel is None:
                return _detached(*loss_fn(model, x, y, None, l2_lambda, True, sample_weights))
            return parallel.summed(*loss_fn(model, x, y, None, parallel.l2_lambda(l2_lambda),
                                            True, sample_weights))

    return step
