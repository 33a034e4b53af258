"""Loss functions (port of clair_tpu/models/losses.py): focal loss (the
default), per-class-weighted cross entropy, L2 regularization, and the
five-term weighted total.

Every per-task loss is a SUM over the batch, not a mean: the learning-rate
constants are calibrated to it. Logits and labels are upcast to float32
first (bf16 logits, int16 labels from the feed).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from clair_tpu_torch.task.labels import GENOTYPE_SPAN, GT21_SPAN, LENGTH1_SPAN, LENGTH2_SPAN
from clair_tpu_torch.utils import trace

COMPONENTS = ("gt21", "genotype", "indel_length_1", "indel_length_2")


def focal_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    gamma: float = 2.0,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-class focal loss, summed over batch and classes: positive
    entries weigh log(p) by (y - p)^gamma, negative ones log(1 - p) by
    p^gamma."""
    p = torch.softmax(logits, dim=-1)
    is_pos = labels > 0
    pos_sub = torch.where(is_pos, labels - p, 0.0)
    neg_sub = torch.where(is_pos, 0.0, p)
    per_entry = -(
        (pos_sub ** gamma) * torch.log(p.clamp(1e-8, 1.0))
        + (neg_sub ** gamma) * torch.log((1.0 - p).clamp(1e-8, 1.0))
    )
    if sample_weights is not None:
        per_entry = per_entry * sample_weights[:, None]
    return per_entry.sum()


def weighted_cross_entropy(
    probs: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    epsilon: float = 1e-10,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-class-weighted cross entropy over softmaxed probabilities,
    summed over the batch."""
    per_example = -(labels * torch.log(probs + epsilon) * class_weights).sum(dim=-1)
    if sample_weights is not None:
        per_example = per_example * sample_weights
    return per_example.sum()


def l2_regularization(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sum(||w||^2 / 2) over the kernels: every parameter but the biases
    (state_dict keys ending in ``.b``) and batch norm's scale and shift
    (``.bn.s``, ``.bn.b``), as Keras' ``kernel_regularizer`` covers them."""
    return sum(0.5 * torch.sum(torch.square(v)) for k, v in params.items()
               if k.rsplit(".", 1)[-1] != "b" and ".bn." not in f".{k}")


@functools.lru_cache(maxsize=16)
def _task_weights(task_weights: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The task weights as a float32 tensor on ``device``, made once per
    (values, device): a copy from pageable memory to a CUDA device waits for
    the work queued before it, so a step that made it anew would wait for
    its forward."""
    return torch.tensor(task_weights, dtype=torch.float32, device=device)


def total_loss(
    logits: Sequence[torch.Tensor],
    y: torch.Tensor,
    params: Mapping[str, torch.Tensor],
    *,
    loss_function: str = "FocalLoss",
    l2_lambda: float = 0.005,
    task_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
    class_weights: Optional[Sequence[torch.Tensor]] = None,
    sample_weights: Optional[torch.Tensor] = None,
    l2_raw: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the four task losses and L2. Returns (scalar, dict
    of the unweighted components, with the JAX package's keys). ``l2_raw``
    is the L2 term without lambda where the caller computes it (a model
    split over a model axis sums its shards' part over the axis); by
    default ``l2_regularization(params)``."""
    spans = (GT21_SPAN, GENOTYPE_SPAN, LENGTH1_SPAN, LENGTH2_SPAN)
    logits = [lg.float() for lg in logits]
    y = y.float()  # int16 labels from the feed, cast on the device
    labels = [y[..., s[0]:s[1]] for s in spans]

    if loss_function == "CrossEntropy":
        if class_weights is None:
            class_weights = [torch.ones(lb.shape[-1], device=y.device) for lb in labels]
        task_losses = [
            weighted_cross_entropy(torch.softmax(lg, dim=-1), lb, cw,
                                   sample_weights=sample_weights)
            for lg, lb, cw in zip(logits, labels, class_weights)
        ]
    else:
        task_losses = [focal_loss(lg, lb, sample_weights=sample_weights)
                       for lg, lb in zip(logits, labels)]

    if l2_raw is None:
        l2_raw = l2_regularization(params)
    l2 = l2_raw * l2_lambda
    # held on the device (_task_weights): only a process's first loss on a
    # device copies them and waits for the forward (the span times that wait)
    with trace.span("loss.sync"):
        weights = _task_weights(tuple(float(w) for w in task_weights), y.device)
    loss = torch.sum(weights * torch.stack([*task_losses, l2]))
    components = dict(zip(COMPONENTS, task_losses))
    components["l2_without_lambda"] = l2_raw
    components["l2"] = l2
    return loss, components
