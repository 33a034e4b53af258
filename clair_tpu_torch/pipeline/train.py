"""Training loop on one torch device (port of clair_tpu/pipeline/train.py).

The same semantics as the JAX loop:
- a 90/10 train/validation split by index (or explicit train/val bins);
- a per-epoch shuffle of the train blocks only, from
  ``np.random.RandomState(seed)``, so both packages see the same batches in
  the same order;
- the adaptive (x0.1 on validation-loss heuristics, up to 3 switches), the
  cyclical and the fixed learning-rate schedules, and the L2-lambda decay;
- a checkpoint every epoch as prefix-%06d, resume epoch parsed from the
  path, the best-validation epoch restored at the end, then the evaluator.

The feed ships int16-packed blocks as stored (``cast_to_float32=False``):
on a CUDA device each batch goes host -> device from pinned memory without
blocking, and the model and losses cast on the device. A step's loss is
read only after the next step has been dispatched: its values start their
copy to pinned host memory at once and an event marks when they are there,
which is the JAX loop's overlap done with device tensors.

On a CUDA device both BiLSTM layers run the kernel pair the model config
selects (models/clair.py:select_bilstm; the streaming pair unless a flag
says otherwise), forward and backward; a CPU device runs their plain
versions. ``use_stream_bilstm`` acts as in the JAX loop: True sets
``use_pallas_stream_bilstm``, None and False leave the model's flags alone.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from clair_tpu_torch.params import (
    CLR_MAX_LR,
    CLR_STEPSIZE_CONSTANT,
    INITIAL_LEARNING_RATE,
    L2_REGULARIZATION_LAMBDA,
    L2_REGULARIZATION_LAMBDA_DECAY,
    LEARNING_RATE_DECAY,
    MAX_EPOCH,
    MAX_LEARNING_RATE_SWITCH,
    PREDICT_BATCH_SIZE,
    TRAIN_BATCH_SIZE,
    TRAINING_DATASET_PERCENTAGE,
    ModelConfig,
)
from clair_tpu_torch.pipeline.schedules import AdaptiveDecay, CyclicalLR
from clair_tpu_torch.data.bins import BinDataset, EpochBatches
from clair_tpu_torch.models.checkpoint import (
    checkpoint_path,
    epoch_from_path,
    load_checkpoint,
    save_checkpoint,
)
from clair_tpu_torch.models.clair import ClairNet, init_params, params_from_jax, params_to_jax
from clair_tpu_torch.models.losses import COMPONENTS
from clair_tpu_torch.parallel.sharding import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)

logger = logging.getLogger(__name__)

# the values a step reports, in order: the loss, then its components
_REPORTED = ("loss", *COMPONENTS, "l2_without_lambda")


@dataclass
class TrainingConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    learning_rate: float = INITIAL_LEARNING_RATE
    l2_lambda: float = L2_REGULARIZATION_LAMBDA
    l2_lambda_decay: float = L2_REGULARIZATION_LAMBDA_DECAY
    lr_decay: float = LEARNING_RATE_DECAY
    output_prefix: Optional[str] = None
    init_checkpoint: Optional[str] = None
    train_batch_size: int = TRAIN_BATCH_SIZE
    val_batch_size: int = PREDICT_BATCH_SIZE
    # "adaptive", a cyclical mode "tri" / "tri2" / "exp", or "fixed"
    schedule: str = "adaptive"
    clr_max_lr: float = CLR_MAX_LR
    max_epochs: int = MAX_EPOCH
    # optional cap for the adaptive schedule, which otherwise trains until
    # its third learning-rate switch
    hard_max_epochs: Optional[int] = None
    checkpoint_every: int = 1
    # not ported: multi-GPU training (ROADMAP Queue 1, 'Multi-GPU')
    mesh: Optional[object] = None
    seed: int = 0
    evaluate_at_end: bool = True
    # the JAX package's training default (float32 masters, float32 loss and
    # cell state); "float32" computes in float32 throughout
    train_compute_dtype: str = "bfloat16"
    # block-decompression threads for the feed (None: one per spare core,
    # capped at 4; 0: inline)
    decompress_workers: Optional[int] = None
    restore_best: bool = True
    # the JAX flag that picks the streaming Pallas BiLSTM: True selects it,
    # None and False leave the model's kernel flags alone. False with no
    # kernel flag set means the JAX package's lax.scan, which in the port is
    # the plain version, kept off the card: refused on a CUDA device
    use_stream_bilstm: Optional[bool] = None
    device: str = "cuda"


@dataclass
class TrainResult:
    params: dict
    training_losses: list
    validation_losses: list
    best_epoch: int


class _StepValues:
    """A step's loss and components on their way to the host: on a CUDA
    device the copy into pinned memory starts at once, and ``read`` waits
    only for it, not for steps dispatched after."""

    def __init__(self, loss: torch.Tensor, components: dict, is_training: bool):
        self.is_training = is_training
        values = torch.stack([loss, *(components[k] for k in _REPORTED[1:])]).float()
        self._done = None
        if values.is_cuda:
            self._host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            self._host.copy_(values, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host = values

    def read(self) -> dict:
        if self._done is not None:
            self._done.synchronize()
        return dict(zip(_REPORTED, self._host.tolist()))


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A feed batch on the device; from pinned memory without blocking on a
    CUDA device (the pinned buffer is held until the copy is done)."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(array))
    dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
    host = torch.empty(array.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = array
    return host.to(device, non_blocking=True)


def _check_supported(config: TrainingConfig, device: torch.device) -> None:
    if config.mesh is not None:
        raise NotImplementedError(
            "mesh: multi-GPU training is not ported yet (ROADMAP Queue 1, 'Multi-GPU')")
    model = config.model
    if (device.type == "cuda" and config.use_stream_bilstm is False
            and not (model.use_pallas_bilstm or model.use_pallas_stream_bilstm
                     or model.use_pallas_train_bilstm)):
        raise NotImplementedError(
            "use_stream_bilstm=False with no BiLSTM kernel flag selects the JAX "
            "package's lax.scan, which in the port is the plain PyTorch version: it "
            "serves CPU tensors and is kept off the card (ROADMAP, the kernel rule); "
            "set a ModelConfig kernel flag, or leave use_stream_bilstm unset")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on 'cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is false")


def train_model(dataset: BinDataset, config: TrainingConfig) -> TrainResult:
    device = torch.device(config.device)
    _check_supported(config, device)
    model_config = dataclasses.replace(config.model, compute_dtype=config.train_compute_dtype)
    if config.use_stream_bilstm:
        model_config = dataclasses.replace(model_config, use_pallas_stream_bilstm=True)
    generator = torch.Generator(device=device).manual_seed(config.seed)

    if config.init_checkpoint is not None:
        params, _ = load_checkpoint(config.init_checkpoint)
        start_epoch = epoch_from_path(config.init_checkpoint) + 1
    else:
        params = init_params(torch.Generator().manual_seed(config.seed + 1), model_config)
        start_epoch = 1
    model = ClairNet.from_jax(params, model_config, device)

    optimizer = make_optimizer(dict(model.named_parameters()), model_config.optimizer_name,
                               config.learning_rate)
    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)

    n_train = dataset.train_size_hint or int(dataset.dataset_size * TRAINING_DATASET_PERCENTAGE)
    n_val = dataset.dataset_size - n_train
    n_train_blocks = int(n_train / dataset.block_size)
    block_order = np.arange(dataset.n_blocks)
    # a generator of its own: the block shuffle is reproducible from the seed
    shuffle_rs = np.random.RandomState(config.seed)

    learning_rate = config.learning_rate
    l2_lambda = config.l2_lambda
    decay = AdaptiveDecay(max_switches=MAX_LEARNING_RATE_SWITCH)
    clr = None
    if config.schedule not in ("adaptive", "fixed"):
        iterations_per_epoch = max(int(np.ceil(n_train / config.train_batch_size)), 1)
        clr = CyclicalLR(step_size=CLR_STEPSIZE_CONSTANT * iterations_per_epoch,
                         max_lr=config.clr_max_lr, mode=config.schedule)

    training_losses: List = []
    validation_losses: List = []
    training_start = time.time()
    logger.info("[INFO] Start training... LR %.2e, L2 lambda %.2e", learning_rate, l2_lambda)

    epoch = start_epoch
    while True:
        epoch_start = time.time()
        sums = {"train": 0.0, "val": 0.0, **{k: 0.0 for k in _REPORTED[1:]}}

        def account(pending: _StepValues) -> None:
            values = pending.read()
            if pending.is_training:
                sums["train"] += values["loss"]
            else:
                sums["val"] += values["loss"]
                for k in _REPORTED[1:]:
                    sums[k] += values[k]

        pending = None
        batches = EpochBatches(
            dataset, block_order, n_train, config.train_batch_size, config.val_batch_size,
            decompress_workers=config.decompress_workers, cast_to_float32=False,
        )
        for x, y, is_training in batches:
            x, y = _to_device(x, device), _to_device(y, device)
            if is_training:
                if clr is not None:
                    learning_rate = clr()
                    set_learning_rate(optimizer, learning_rate)
                loss, components = train_step(x, y, generator, l2_lambda)
            else:
                loss, components = eval_step(x, y, l2_lambda)
            # read the PREVIOUS step's values: the device runs ahead
            if pending is not None:
                account(pending)
            pending = _StepValues(loss, components, is_training)
        if pending is not None:
            account(pending)
        train_loss_sum, val_loss_sum = sums["train"], sums["val"]

        logger.info("%d Training loss: %s", epoch, train_loss_sum / max(n_train, 1))
        logger.info(
            "%d Validation loss (Total/Base/Genotype/Indel_1_2): %s\t%s\t%s\t%s\t%s",
            epoch, val_loss_sum / max(n_val, 1),
            *(sums[k] / max(n_val, 1) for k in COMPONENTS),
        )
        logger.info("[INFO] Epoch time elapsed: %.2f s", time.time() - epoch_start)
        training_losses.append((train_loss_sum, epoch))
        validation_losses.append((val_loss_sum, epoch))

        is_last = config.schedule != "adaptive" and epoch >= config.max_epochs
        if config.output_prefix is not None and (
            epoch % config.checkpoint_every == 0 or is_last
        ):
            save_checkpoint(
                checkpoint_path(config.output_prefix, epoch), params_to_jax(model.state_dict()),
                extra={"epoch": epoch, "learning_rate": learning_rate},
            )

        if config.schedule == "fixed" or clr is not None:
            if epoch >= config.max_epochs:
                break
        else:
            should_stop, did_decay = decay.observe(val_loss_sum, epoch)
            if should_stop:
                break
            if config.hard_max_epochs is not None and epoch >= config.hard_max_epochs:
                break
            if did_decay:
                learning_rate *= config.lr_decay
                l2_lambda *= config.l2_lambda_decay
                set_learning_rate(optimizer, learning_rate)
                logger.info("[INFO] New learning rate: %.2e", learning_rate)

        epoch += 1
        # shuffle the train blocks only
        block_order = _shuffle_first_n(block_order, n_train_blocks, shuffle_rs)

    logger.info("[INFO] Training time elapsed: %.2f s", time.time() - training_start)

    saved = {
        e for _, e in validation_losses
        if config.output_prefix is not None
        and os.path.exists(checkpoint_path(config.output_prefix, e))
    }
    restorable = [v for v in validation_losses if v[1] in saved] or validation_losses
    best_epoch = sorted(restorable)[0][1]
    logger.info("[INFO] Best validation loss at epoch: %d", best_epoch)
    params = params_to_jax(model.state_dict())
    if not config.restore_best:
        best_epoch = epoch  # keep the final-epoch parameters
    elif config.output_prefix is not None and best_epoch in saved:
        params, _ = load_checkpoint(checkpoint_path(config.output_prefix, best_epoch))
    if config.evaluate_at_end:
        from clair_tpu_torch.pipeline.evaluate import evaluate_model

        evaluate_model(params, model_config, dataset, device=config.device)

    return TrainResult(
        params=params,
        training_losses=training_losses,
        validation_losses=validation_losses,
        best_epoch=best_epoch,
    )


def _shuffle_first_n(array: np.ndarray, n: int, rs: np.random.RandomState) -> np.ndarray:
    array = array.copy()
    if len(array) <= n:
        rs.shuffle(array)
        return array
    head = array[:n]
    rs.shuffle(head)
    array[:n] = head
    return array
