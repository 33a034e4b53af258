"""Learning-rate range finder (port of clair_tpu/pipeline/lr_finder.py).

One-epoch LR sweep from min_lr to max_lr with per-batch multi-head accuracy
tracking; the suggested range comes from the extrema of the accuracy-curve
derivative (ref /root/reference/clair/learning_rate_finder.py:76-84,
:225-258).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from clair_tpu_torch.data.bins import BinDataset, EpochBatches
from clair_tpu_torch.models.clair import ClairNet, init_params
from clair_tpu_torch.params import (
    LR_FINDER_MAX_LR,
    LR_FINDER_MIN_LR,
    TRAIN_BATCH_SIZE,
    TRAINING_DATASET_PERCENTAGE,
    ModelConfig,
)
from clair_tpu_torch.parallel.sharding import (
    make_optimizer,
    make_train_step,
    set_learning_rate,
)
from clair_tpu_torch.pipeline.schedules import CyclicalLR
from clair_tpu_torch.task.labels import split_label_vector


@dataclass
class LrFinderResult:
    learning_rates: List[float]
    accuracies: List[float]
    losses: List[float]
    suggested_min_lr: float = 0.0
    suggested_max_lr: float = 0.0


def _batch_accuracy(model: ClairNet, x: torch.Tensor, y: np.ndarray) -> float:
    """Mean over the 4 heads of per-batch argmax accuracy, with the
    indel-length pair order-normalized (ref learning_rate_finder.py:21-73)."""
    with torch.inference_mode():
        gt21_p, geno_p, vl1_p, vl2_p = (a.cpu().numpy() for a in model(x))
    y_gt21, y_geno, y_vl1, y_vl2 = split_label_vector(y)
    acc_gt21 = float((gt21_p.argmax(-1) == y_gt21.argmax(-1)).mean())
    acc_geno = float((geno_p.argmax(-1) == y_geno.argmax(-1)).mean())
    t1, t2 = y_vl1.argmax(-1), y_vl2.argmax(-1)
    p1, p2 = vl1_p.argmax(-1), vl2_p.argmax(-1)
    acc_l1 = float((np.minimum(p1, p2) == np.minimum(t1, t2)).mean())
    acc_l2 = float((np.maximum(p1, p2) == np.maximum(t1, t2)).mean())
    return (acc_gt21 + acc_geno + acc_l1 + acc_l2) / 4.0


def find_learning_rate(
    dataset: BinDataset,
    model_config: ModelConfig = ModelConfig(),
    min_lr: float = LR_FINDER_MIN_LR,
    max_lr: float = LR_FINDER_MAX_LR,
    train_batch_size: int = TRAIN_BATCH_SIZE,
    output_path: Optional[str] = None,
    seed: int = 0,
    device: str = "cuda",
) -> LrFinderResult:
    """One epoch of train steps at a learning rate rising linearly from
    min_lr to max_lr (a half 'tri' cycle), no L2, recording each step's LR,
    its pre-update loss and the updated model's accuracy on the batch.

    ``model_config`` is used as given: the default ModelConfig() computes
    in float32 with no kernel flag, which on a CUDA device runs the
    streaming pair, rows 1 and 2 (ops/bilstm_stream.py), in float32
    (models/clair.py: select_bilstm); on the CPU their plain versions.
    Initial parameters and dropout come from ``seed`` as in train_model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("find_learning_rate on 'cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is false")
    params = init_params(torch.Generator().manual_seed(seed + 1), model_config)
    model = ClairNet.from_jax(params, model_config, device)
    optimizer = make_optimizer(dict(model.named_parameters()), model_config.optimizer_name,
                               min_lr)
    train_step = make_train_step(model, optimizer)
    generator = torch.Generator(device=device).manual_seed(seed)

    n_train = dataset.train_size_hint or int(
        dataset.dataset_size * TRAINING_DATASET_PERCENTAGE
    )
    iterations = max(int(np.ceil(n_train / train_batch_size)), 1)
    # a half 'tri' cycle sweeps min_lr -> max_lr linearly over the epoch
    clr = CyclicalLR(step_size=iterations, max_lr=max_lr, mode="tri", min_lr=min_lr)

    lrs, accs, losses = [], [], []
    batches = EpochBatches(
        dataset, np.arange(dataset.n_blocks), n_train, train_batch_size
    )
    for x, y, is_training in batches:
        if not is_training:
            break
        lr = clr()
        set_learning_rate(optimizer, lr)
        xd, yd = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        loss, _ = train_step(xd, yd, generator, 0.0)
        lrs.append(lr)
        losses.append(loss.item())
        accs.append(_batch_accuracy(model, xd, y))

    result = LrFinderResult(learning_rates=lrs, accuracies=accs, losses=losses)
    if len(accs) >= 2:
        derivative = np.diff(accs)
        result.suggested_min_lr = lrs[int(np.argmax(derivative))]
        result.suggested_max_lr = lrs[int(np.argmin(derivative))]

    if output_path is not None:
        with open(output_path, "w") as fh:
            fh.write("lr,accuracy,loss\n")
            for lr, acc, loss in zip(lrs, accs, losses):
                fh.write(f"{lr},{acc},{loss}\n")
            fh.write(f"# suggested min_lr {result.suggested_min_lr}\n")
            fh.write(f"# suggested max_lr {result.suggested_max_lr}\n")
    return result
