"""Training loop on one torch device, or data-parallel over several (port of
clair_tpu/pipeline/train.py).

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
``use_pallas_stream_bilstm``; None and False leave the model's flags alone,
and False with no flag set runs every forward of the run (the train and
validation steps, the evaluation at the end) on the JAX package's lax.scan
BiLSTM (models/bilstm.py:bilstm_scan), on either device. The auto rule
(None) stays on the streaming pair whatever the dtype.

Clair3's full-alignment network (models/clair3_fa.py) trains through the
same loop, steps and feed when ``TrainingConfig.model`` is a
``FullAlignmentConfig``: on one device, in the config's float32, the
process's TF32 switches off for the whole run (``float32_products``: the
backward's convolutions are launched from autograd's own thread, after any
scope around the forward alone), its checkpoints carrying batch norm's
running statistics. A mesh or the BiLSTM flags raise ValueError with it.

With ``TrainingConfig.mesh`` (parallel/mesh.py) this process is one rank
of a parallel run on ``TrainingConfig.device``: it reads the same epoch
stream as every other rank, pads each global batch to a multiple of the
data axis with sample weight 0 and steps on its data row's stripe
(parallel/distributed.py). Where the mesh has a model axis, the rank holds
its shard of the dense trunk (parallel/tensor_parallel.py), and the full
parameters are gathered over the model group wherever they are used: the
best-epoch snapshot, the checkpoints, the result. The steps return the
global batch's losses, so every rank takes the same schedule decisions.
Process 0 alone writes checkpoints and runs the evaluation at the end; with
more than one rank, resume goes through ``broadcast_checkpoint`` and the
best epoch is restored from a snapshot kept in memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

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
from clair_tpu_torch.models.build import build_model, init_params
from clair_tpu_torch.models.clair import params_to_jax
from clair_tpu_torch.models.clair3_fa import FullAlignmentConfig, float32_products
from clair_tpu_torch.models.losses import COMPONENTS
from clair_tpu_torch.parallel.distributed import (
    broadcast_checkpoint,
    check_multihost_mesh,
    local_stripe,
    process_info,
)
from clair_tpu_torch.parallel.tensor_parallel import TensorParallel, gather_params, shard_params
from clair_tpu_torch.parallel.sharding import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)
from clair_tpu_torch.utils import trace

logger = logging.getLogger(__name__)

# the values a step reports, in order: the loss, then its components
_REPORTED = ("loss", *COMPONENTS, "l2_without_lambda")


@dataclass
class TrainingConfig:
    # ClairNet's ModelConfig, or Clair3_F's FullAlignmentConfig
    model: Union[ModelConfig, FullAlignmentConfig] = field(default_factory=ModelConfig)
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
    # a DeviceMesh over the ranks of torch.distributed (parallel/mesh.py):
    # data- (and model-) parallel training, this process being one rank on
    # ``device``
    mesh: Optional[object] = None
    seed: int = 0
    evaluate_at_end: bool = True
    # the JAX package's training default (float32 masters, float32 loss and
    # cell state); "float32" computes in float32 throughout. ClairNet's: a
    # FullAlignmentConfig computes in its own compute_dtype (float32)
    train_compute_dtype: str = "bfloat16"
    # block-decompression threads for the feed (None: one per spare core,
    # capped at 4; 0: inline)
    decompress_workers: Optional[int] = None
    restore_best: bool = True
    # the JAX flag that picks the streaming Pallas BiLSTM: True selects it,
    # None and False leave the model's kernel flags alone. False with no
    # kernel flag set runs the JAX package's lax.scan BiLSTM, the float32
    # exact-parity escape hatch of the JAX loop (models/bilstm.py:bilstm_scan)
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
    only for it, not for steps dispatched after. Spans: ``values.copy``
    (the copy's enqueue) and ``values.wait`` (``read``'s wait for the
    device, which the host meets only where it ran ahead of the card),
    both of the step's batch."""

    def __init__(self, loss: torch.Tensor, components: dict, is_training: bool):
        self.is_training = is_training
        self._batch = trace.batch()
        with trace.span("values.copy"):
            values = torch.stack([loss, *(components[k] for k in _REPORTED[1:])]).float()
            self._done = None
            if values.is_cuda:
                self._host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
                self._host.copy_(values, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record(torch.cuda.current_stream(values.device))
            else:
                self._host = values

    def read(self) -> dict:
        with trace.span("values.wait", batch=self._batch):
            if self._done is not None:
                self._done.synchronize()
        return dict(zip(_REPORTED, self._host.tolist()))


def _to_device(array: np.ndarray, device: torch.device,
               counter: Optional[str] = None) -> torch.Tensor:
    """A feed batch on the device; from pinned memory without blocking on a
    CUDA device (the pinned buffer is held until the copy is done). Spans:
    ``dispatch.to_device``, and ``dispatch.pin_copy`` around the pinned
    buffer's allocation and fill; ``counter``, where given, names a counter
    of the bytes sent (the loop counts x's as ``dispatch.x_bytes``)."""
    with trace.span("dispatch.to_device"):
        if counter is not None:
            trace.count(counter, array.nbytes)
        if device.type != "cuda":
            return torch.from_numpy(np.array(array))
        dtype = torch.from_numpy(np.empty(0, array.dtype)).dtype
        with trace.span("dispatch.pin_copy"):
            host = torch.empty(array.shape, dtype=dtype, pin_memory=True)
            host.numpy()[...] = array
        return host.to(device, non_blocking=True)


# a train step's host dispatch: the spans on the dispatching thread around
# the batch's copy, the step's enqueue and its values' copy
_DISPATCH_SPANS = ("dispatch.to_device", "train_step.forward", "train_step.loss",
                   "train_step.backward", "train_step.optimizer", "values.copy")


def _host_line(records: Sequence[trace.Record], lost: int = 0) -> str:
    """An epoch's host side from its spans (utils/trace.py): the feed's
    wait a batch and the share of batches that found its queue empty, the
    producer's wait on the decompress pool a batch, the host's dispatch a
    train step less the loss's wait for the forward, that wait, and how
    many reads of a step's values made one step behind (after the next
    batch's dispatch began) waited over 0.1 ms for the card (the host had
    run ahead of it). ``lost``: the records the ring let go during the
    epoch, so that the line covers only its last batches."""
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)

    def ms(name, keep=lambda r: True):
        return sum((r.end_ns - r.start_ns) / 1e6 for r in by_name.get(name, ()) if keep(r))

    batches = max(len(by_name.get("feed.wait", ())), 1)
    starved = sum(r.value == 0 for r in by_name.get("feed.depth", ()))
    train = {r.batch for r in by_name.get("train_step.forward", ())}
    steps = max(len(train), 1)
    dispatch = sum(ms(name, lambda r: r.batch in train) for name in _DISPATCH_SPANS)
    sync = ms("loss.sync", lambda r: r.parent == "train_step.loss")
    begun = {r.batch for r in by_name.get("dispatch.to_device", ())}
    reads = [r for r in by_name.get("values.wait", ()) if r.batch + 1 in begun]
    ahead = sum(r.end_ns - r.start_ns > 100_000 for r in reads)
    line = (f"feed wait {ms('feed.wait') / batches:.2f} ms a batch, "
            f"{100.0 * starved / batches:.1f}% starved; "
            f"block wait {ms('feed.block_wait') / batches:.2f} ms a batch; "
            f"dispatch {(dispatch - sync) / steps:.2f} ms a train step less the loss's sync "
            f"{sync / steps:.2f} ms; host ahead in {ahead} of {len(reads)} reads")
    if lost:
        line += (f"; the ring let go {lost} records: the line covers the epoch's last "
                 f"{len(by_name.get('feed.wait', ()))} batches")
    return line


def _check_supported(config: TrainingConfig, device: torch.device) -> None:
    if config.mesh is not None and not isinstance(config.mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel/mesh.py: make_mesh), not "
                        f"{type(config.mesh).__name__}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on 'cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is false")


def _check_full_alignment(dataset: BinDataset, config: TrainingConfig) -> None:
    """What Clair3_F's training refuses: a mesh, the BiLSTM flags, and a bin
    whose rows are not the model's input_shape."""
    if config.mesh is not None:
        raise ValueError("Clair3_F (clair3_fa) trains on one device: no mesh, no "
                         "--num_devices, --coordinator_address or --model_parallel")
    if config.use_stream_bilstm is not None:
        raise ValueError("use_stream_bilstm (--no_stream_bilstm) picks a BiLSTM layer, and "
                         "Clair3_F (clair3_fa) has none")
    if dataset.n_blocks:
        rows = tuple(dataset.x_block(0, cast=False).shape[1:])
        if rows != tuple(config.model.input_shape):
            raise ValueError(f"the bin's rows are {rows}; Clair3_F (clair3_fa) takes "
                             f"{tuple(config.model.input_shape)}")


def train_model(dataset: BinDataset, config: TrainingConfig) -> TrainResult:
    """Train ClairNet, or Clair3_F where ``config.model`` is a
    FullAlignmentConfig (inside ``float32_products``, so that no
    convolution or product of the run, backward included, takes TF32)."""
    if isinstance(config.model, FullAlignmentConfig):
        _check_full_alignment(dataset, config)
        with float32_products():
            return _train(dataset, config, config.model)
    return _train(dataset, config,
                  dataclasses.replace(config.model, compute_dtype=config.train_compute_dtype))


def _train(dataset: BinDataset, config: TrainingConfig,
           model_config: Union[ModelConfig, FullAlignmentConfig]) -> TrainResult:
    device = torch.device(config.device)
    _check_supported(config, device)
    if config.use_stream_bilstm:
        model_config = dataclasses.replace(model_config, use_pallas_stream_bilstm=True)
    scan = config.use_stream_bilstm is False
    rank, world = 0, 1
    data_index = 0
    shard = tp = None
    if config.mesh is not None:
        rank, world = process_info()
        check_multihost_mesh(config.mesh, world)
        data_index = config.mesh.get_local_rank("data")
        data_size = config.mesh.get_group("data").size()
        tp = TensorParallel.of(config.mesh)

        def shard(x, y):
            # every rank holds the same GLOBAL batch (the same epoch stream)
            # and steps on its data row's stripe: the global batch is the
            # single-process run's
            n = len(x)
            padded = -(-n // data_size) * data_size
            w = np.zeros(padded, dtype=np.float32)
            w[:n] = 1.0
            if padded != n:
                x = np.concatenate([x, np.zeros((padded - n,) + x.shape[1:], x.dtype)])
                y = np.concatenate([y, np.zeros((padded - n,) + y.shape[1:], y.dtype)])
            rows = local_stripe(padded, data_index, data_size)
            return x[rows], y[rows], w[rows]
    # dropout masks differ by data row, so that the stripes share none, and
    # are the same along a model row, whose ranks compute its replicated
    # layers together
    generator = torch.Generator(device=device).manual_seed(config.seed + data_index)

    if config.init_checkpoint is not None and world > 1:
        # checkpoints are written by process 0 only: it loads and broadcasts
        # the parameters and the epoch counter
        params, epoch0 = broadcast_checkpoint(config.init_checkpoint)
        start_epoch = epoch0 + 1
    elif config.init_checkpoint is not None:
        params, _ = load_checkpoint(config.init_checkpoint)
        start_epoch = epoch_from_path(config.init_checkpoint) + 1
    else:
        params = init_params(torch.Generator().manual_seed(config.seed + 1), model_config)
        start_epoch = 1
    if tp is not None:
        params = shard_params(params, tp.index, tp.size)
    model = build_model(params, model_config, device, tp, scan)

    def full_params():
        # a collective over the model group where the model is a shard
        if tp is not None:
            return gather_params(model, config.mesh)
        return params_to_jax(model.state_dict())

    optimizer = make_optimizer(dict(model.named_parameters()), model_config.optimizer_name,
                               config.learning_rate)
    train_step = make_train_step(model, optimizer, config.mesh)
    eval_step = make_eval_step(model, config.mesh)

    n_train = dataset.train_size_hint or int(dataset.dataset_size * TRAINING_DATASET_PERCENTAGE)
    n_val = dataset.dataset_size - n_train
    n_train_blocks = int(n_train / dataset.block_size)
    block_order = np.arange(dataset.n_blocks)
    # a generator of its own: the block shuffle is reproducible from the seed
    shuffle_rs = np.random.RandomState(config.seed)
    best_snapshot = None  # (val_loss, epoch, params) with more than one rank

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
        epoch_start_ns, epoch_dropped = time.perf_counter_ns(), trace.dropped()
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
            weights = None
            if shard is not None:
                x, y, weights = shard(x, y)
                weights = _to_device(weights, device)
            x, y = _to_device(x, device, "dispatch.x_bytes"), _to_device(y, device)
            if is_training:
                if clr is not None:
                    learning_rate = clr()
                    set_learning_rate(optimizer, learning_rate)
                loss, components = train_step(x, y, generator, l2_lambda, weights)
            else:
                loss, components = eval_step(x, y, l2_lambda, weights)
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
        logger.info("[INFO] Epoch host: %s", _host_line(trace.records(since_ns=epoch_start_ns),
                                                        trace.dropped() - epoch_dropped))
        training_losses.append((train_loss_sum, epoch))
        validation_losses.append((val_loss_sum, epoch))

        is_last = config.schedule != "adaptive" and epoch >= config.max_epochs
        if world > 1 and config.restore_best and (
            best_snapshot is None or val_loss_sum < best_snapshot[0]
        ):
            best_snapshot = (val_loss_sum, epoch, full_params())
        # process 0's model row gathers the parameters; process 0 writes them
        if config.output_prefix is not None and data_index == 0 and (
            epoch % config.checkpoint_every == 0 or is_last
        ):
            saved_params = full_params()
            if rank == 0:
                save_checkpoint(checkpoint_path(config.output_prefix, epoch), saved_params,
                                extra={"epoch": epoch, "learning_rate": learning_rate})

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

    params = full_params()
    if world > 1:
        # no shared filesystem: the best epoch comes from the snapshot, and
        # every rank ends with the same parameters
        best_epoch = sorted(validation_losses)[0][1]
        logger.info("[INFO] Best validation loss at epoch: %d", best_epoch)
        if best_snapshot is not None:
            _, best_epoch, params = best_snapshot
        else:
            best_epoch = epoch
    else:
        saved = {
            e for _, e in validation_losses
            if config.output_prefix is not None
            and os.path.exists(checkpoint_path(config.output_prefix, e))
        }
        restorable = [v for v in validation_losses if v[1] in saved] or validation_losses
        best_epoch = sorted(restorable)[0][1]
        logger.info("[INFO] Best validation loss at epoch: %d", best_epoch)
        if not config.restore_best:
            best_epoch = epoch  # keep the final-epoch parameters
        elif config.output_prefix is not None and best_epoch in saved:
            params, _ = load_checkpoint(checkpoint_path(config.output_prefix, best_epoch))
    if config.evaluate_at_end and rank == 0:
        from clair_tpu_torch.pipeline.evaluate import evaluate_model

        evaluate_model(params, model_config, dataset, device=config.device, scan=scan)

    return TrainResult(
        params=params,
        training_losses=training_losses,
        validation_losses=validation_losses,
        best_epoch=best_epoch,
    )


def train_on_devices(load_dataset: Callable[[], BinDataset], config: TrainingConfig, n: int,
                     *, profile_dir: Optional[str] = None, backend: Optional[str] = None,
                     devices: Optional[Sequence[str]] = None,
                     timeout_s: Optional[float] = None,
                     model_parallel: int = 1) -> Tuple[TrainResult, dict]:
    """train_model over n devices of this host, one rank process each
    (spawned), meeting at a free localhost port: rank r on cuda:r, or on
    ``devices[r]``, or on the CPU when config.device is the CPU, on a mesh
    of (n // model_parallel, model_parallel). Every rank loads its dataset
    with ``load_dataset`` (a picklable callable). Returns rank 0's
    TrainResult and the ranks' kernel launches, summed. Fewer visible GPUs
    than n raise; a model_parallel that does not divide n raises in the
    ranks (make_mesh).
    ``backend`` (default NCCL on CUDA, gloo on the CPU) and ``timeout_s``
    (the ranks' wall-clock limit and their collectives' timeout) serve
    tests and the smoke test."""
    from clair_tpu_torch.ops import add_launches
    from clair_tpu_torch.parallel.distributed import free_port, spawn
    from clair_tpu_torch.parallel.mesh import visible_devices

    devices = devices or visible_devices(n, _device_type(config.device))
    address = f"localhost:{free_port()}"
    results = spawn(train_rank, n, (n, address, load_dataset, config, profile_dir, backend,
                                    devices, timeout_s, model_parallel), timeout_s=timeout_s)
    launches: dict = {}
    for _, rank_launches in results:
        add_launches(launches, rank_launches)
    return results[0][0], launches


def train_rank(rank: int, world: int, address: str, load_dataset: Callable[[], BinDataset],
               config: TrainingConfig, profile_dir: Optional[str] = None,
               backend: Optional[str] = None, devices: Optional[Sequence[str]] = None,
               timeout_s: Optional[float] = None,
               model_parallel: int = 1) -> Tuple[TrainResult, dict]:
    """One rank of a parallel run: join the group at ``address``
    (parallel/distributed.py: init_distributed), build the mesh over every
    rank (``model_parallel`` wide on its model axis), train on this rank's
    device, leave the group. Returns (TrainResult, this process's kernel
    launches during the run)."""
    import torch.distributed as dist

    from clair_tpu_torch.ops import launch_counts, launches_since
    from clair_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S, init_distributed
    from clair_tpu_torch.parallel.mesh import make_mesh

    device_type = _device_type(config.device)
    if device_type == "cpu":
        # the ranks share this host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    device = init_distributed(address, world, rank, device_type, backend=backend,
                              device=devices[rank] if devices else None,
                              timeout_s=timeout_s or DEFAULT_TIMEOUT_S)
    try:
        mesh = make_mesh(world, model_parallel, device_type=device_type)
        config = dataclasses.replace(config, mesh=mesh, device=str(device))
        dataset = load_dataset()
        before = launch_counts()
        with profiled(profile_dir, config.device, f"rank{rank}"):
            result = train_model(dataset, config)
        return result, launches_since(before)
    finally:
        dist.destroy_process_group()


def _device_type(device: str) -> str:
    return torch.device(device).type


@contextlib.contextmanager
def profiled(profile_dir: Optional[str], device: str, worker_name: Optional[str] = None):
    """A torch.profiler trace of what runs inside (CPU ops, and CUDA kernels
    on a CUDA device), written into ``profile_dir`` as a
    ``*.pt.trace.json`` by tensorboard_trace_handler when it ends; nothing
    when profile_dir is None (train --profile_dir)."""
    if profile_dir is None:
        yield
        return
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if _device_type(device) == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    with tp.profile(activities=activities,
                    on_trace_ready=tp.tensorboard_trace_handler(profile_dir, worker_name)):
        yield


def _shuffle_first_n(array: np.ndarray, n: int, rs: np.random.RandomState) -> np.ndarray:
    array = array.copy()
    if len(array) <= n:
        rs.shuffle(array)
        return array
    head = array[:n]
    rs.shuffle(head)
    array[:n] = head
    return array
