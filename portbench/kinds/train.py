"""Training traffic: the port's training loop over a bin made from the seed.

A traffic file of this kind gives ``batch``, ``val_batch``, ``val_share``
and ``pileup`` (the profile of portbench/pileup.py); the configuration
gives the model, the training recipe and ``bin_rows``.

Set-up makes ``bin_rows`` rows on the device, packs them into the port's
500-row blocks with the port's own writer (data/bins.py:_pack, on a pool
of threads), makes the weights (portbench/weights.py), builds one model,
its optimizer and its train step, and drives that object through its
first ``CHECKED_STEPS`` steps, which the reference follows after the
window. The window goes on with the same object, the same feed and the
same dropout generator, in the order pipeline/train.py:train_model runs
its loop: the feed (``EpochBatches``, the train blocks reshuffled each
epoch from the seed), ``_to_device``, the train step (or the eval step on
validation batches), the previous step's values read one step behind
(``_StepValues``). The learning rate stays the recipe's: the schedule acts
between epochs on the validation loss, and changes only that scalar.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from clair_tpu_torch.data.bins import BinDataset, EpochBatches, _pack
from clair_tpu_torch.models.clair import ClairNet
from clair_tpu_torch.params import BIN_BLOCK_SIZE, ModelConfig
from clair_tpu_torch.parallel.sharding import make_eval_step, make_optimizer, make_train_step
from clair_tpu_torch.pipeline.train import _shuffle_first_n, _StepValues, _to_device

from portbench import check, devtrace, trace_split
from portbench.pileup import make_rows
from portbench.reference import clair2
from portbench.weights import make_weights

CHECKED_STEPS = 3
# the traced run profiles these stretches of steps, one after the other,
# after the window's first PROFILE_AFTER (see _Stretch)
PROFILE_AFTER = 16
STRETCHES = (("device", 16), ("host", 16))
_MODEL_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def seeds(seed: int) -> Dict[str, int]:
    """Independent streams of one seed: rows, weights, dropout, shuffle."""
    state = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint64)
    names = ("rows", "weights", "dropout", "shuffle")
    out = {k: int(v) for k, v in zip(names, state)}
    out["shuffle"] &= 0xFFFFFFFF  # numpy's RandomState takes 32 bits
    return out


def pack_bin(x: np.ndarray, y: np.ndarray, block: int = BIN_BLOCK_SIZE) -> BinDataset:
    """The rows as a bin: float32 blocks through the port's writer, which
    stores them as int16 (they round-trip), as a lab's bins are."""
    def one(start: int):
        rows = slice(start, start + block)
        return (_pack(x[rows].astype(np.float32)), _pack(y[rows].astype(np.float32)),
                _pack(np.arange(start, min(start + block, len(x)))))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(one, range(0, len(x), block)))
    return BinDataset(len(x), [p[0] for p in parts], [p[1] for p in parts],
                      [p[2] for p in parts], block)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (portbench/metrics/)."""
    model: Dict
    dtype: str
    batch: int
    spans: Dict[str, List[float]]
    step_intervals_ms: List[float]
    split: Optional[Dict] = None          # trace_split.split_train_steps
    trace: Dict = dataclasses.field(default_factory=dict)  # devtrace's readings
    profiled_rows: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Stretch:
    """Steps ``first`` to ``last`` - 1 of a traced window under
    torch.profiler. "device": the device's activity alone, which costs the
    host little (busy and idle time, the device operations, ``mfu``);
    "host": the host's operations and ranges too (the split of the step by
    part, the host's time, idle gaps by what the host was doing), which
    slow a host-paced step."""

    def __init__(self, name: str, first: int, last: int, cell: "Cell", folder: str):
        self.name, self.first, self.last, self.cell = name, first, last, cell
        self.rows = {"train": 0, "eval": 0}
        self.profiler = self.range = None
        self.path = os.path.join(folder, f"{name}.pt.trace.json")

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] if self.name == "host" else []
        if self.cell.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        if not activities:  # off a CUDA device there is no device activity
            return
        self.cell._sync()
        self.profiler = profile(activities=activities)
        self.profiler.start()
        if self.name == "host":
            self.range = record_function(devtrace.STRETCH)
            self.range.__enter__()

    def mark(self, name: str):
        return torch.profiler.record_function(name) if self.name == "host" else nullcontext()

    def stop(self) -> None:
        if self.profiler is None:
            return
        self.cell._sync()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.profiler.stop()
        # written at once: a later profiling session clears this one's events
        self.profiler.export_chrome_trace(self.path)

    def read(self, readings: "Readings") -> None:
        if self.profiler is None:
            return
        if self.name == "host":
            readings.split = trace_split.split_train_steps(self.path)
            readings.trace.update(devtrace.read_host(self.path))
        else:
            readings.trace.update(devtrace.read_device(self.path))
            readings.profiled_rows = dict(self.rows)


class Cell:
    def __init__(self, config: Dict, mix: Dict, seed: int, device: torch.device):
        self.mix, self.device = mix, device
        self.model_spec = config["model"]
        self.training = config["training"]
        self.streams = seeds(seed)
        self._reference = None
        self.batch, self.val_batch = int(mix["batch"]), int(mix["val_batch"])
        self.rows = int(config["bin_rows"])
        self.n_train = int(round(self.rows * (1.0 - float(mix["val_share"]))))
        if self.n_train < CHECKED_STEPS * self.batch:
            raise ValueError(f"{self.n_train} training rows hold fewer than {CHECKED_STEPS} "
                             f"batches of {self.batch}")

    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        dev = self.device
        clock = time.perf_counter
        marks = [clock()]
        x, y = make_rows(self.rows, self.mix["pileup"],
                         torch.Generator(dev).manual_seed(self.streams["rows"]), dev)
        x, y = x.cpu().numpy(), y.cpu().numpy()
        marks.append(clock())
        checked = CHECKED_STEPS * self.batch
        # epoch 1 runs the blocks in order: the checked steps take the
        # first rows, which the reference gets from here, not from the feed
        self.checked_rows = (x[:checked].copy(), y[:checked].copy())
        self.dataset = pack_bin(x, y)
        del x, y
        marks.append(clock())

        shapes = clair2.param_shapes(self.model_spec)
        self.start = make_weights(shapes, torch.Generator(dev).manual_seed(self.streams["weights"]),
                                  dev)
        self._sync()
        marks.append(clock())
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in self.model_spec.items() if k in _MODEL_FIELDS}
        model_config = ModelConfig(**fields, compute_dtype=self.training["compute_dtype"])
        self.model = ClairNet(model_config, dev)
        self.model.load_state_dict(self.start)
        self._sync()
        marks.append(clock())
        self.optimizer = make_optimizer(dict(self.model.named_parameters()),
                                        self.training["optimizer"],
                                        self.training["learning_rate"])
        self.train_step = make_train_step(self.model, self.optimizer)
        self.eval_step = make_eval_step(self.model)
        self.generator = torch.Generator(dev).manual_seed(self.streams["dropout"])
        self.feed = self._batches()
        marks.append(clock())

        losses, first_grad = [], None
        for step in range(CHECKED_STEPS):
            x_b, y_b, is_training = next(self.feed)
            if not is_training or len(x_b) != self.batch:
                raise RuntimeError("the feed's first batches are not full training batches")
            losses.append(self._dispatch(x_b, y_b, True).read()["loss"])
            if step == 0:
                first_grad = self._adam_gradient()
        self.checked = {"losses": losses, "grad": first_grad,
                        "params": {k: v.detach().clone()
                                   for k, v in self.model.named_parameters()}}
        if float(self.mix["val_share"]) > 0:
            self._warm_eval()
        self._sync()
        marks.append(clock())
        self.setup_parts = dict(zip(("rows", "pack", "weights", "model", "optimizer",
                                     "checked_steps"),
                                    (b - a for a, b in zip(marks, marks[1:]))))

    def _adam_gradient(self) -> Dict[str, torch.Tensor]:
        """The gradient Adam received at its first step: its first moment
        over (1 - b1). A leaf Adam holds no state for received none."""
        beta1 = self.optimizer.inner.param_groups[0]["betas"][0]
        out = {}
        for name, p in zip(self.optimizer.names, self.optimizer.params):
            state = self.optimizer.inner.state.get(p, {})
            out[name] = (state["exp_avg"] / (1.0 - beta1) if "exp_avg" in state
                         else torch.zeros_like(p)).detach().clone()
        return out

    def _warm_eval(self) -> None:
        """The eval step at the validation batch and the epoch's short last
        validation batch: the shapes the window will see."""
        n_val = self.rows - self.n_train
        sizes = {min(self.val_batch, n_val), n_val % self.val_batch} - {0}
        x, y = self.checked_rows
        for n in sorted(sizes):
            self._dispatch(x[:n], y[:n], False).read()

    def _batches(self) -> Iterator:
        """Epoch after epoch: train_model's feed and block shuffle."""
        ds = self.dataset
        order = np.arange(ds.n_blocks)
        n_train_blocks = int(self.n_train / ds.block_size)
        shuffle = np.random.RandomState(self.streams["shuffle"])
        while True:
            epoch = iter(EpochBatches(ds, order, self.n_train, self.batch, self.val_batch,
                                      decompress_workers=None, cast_to_float32=False))
            try:
                yield from epoch
            finally:
                epoch.close()
            order = _shuffle_first_n(order, n_train_blocks, shuffle)

    def _dispatch(self, x: np.ndarray, y: np.ndarray, is_training: bool) -> _StepValues:
        xd, yd = _to_device(x, self.device), _to_device(y, self.device)
        if is_training:
            loss, components = self.train_step(xd, yd, self.generator,
                                               self.training["l2_lambda"])
        else:
            loss, components = self.eval_step(xd, yd, self.training["l2_lambda"])
        return _StepValues(loss, components, is_training)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the window --------------------------------------------------------
    def window(self, seconds: float, trace: bool):
        """Measure for ``seconds``; returns ({end-to-end metric: value},
        Readings, {"attempted", "failed", "rows", "seconds"}). A traced run
        profiles the stretches of ``STRETCHES`` and takes its spans and
        step events on the other steps."""
        cuda = self.device.type == "cuda"
        spans: Dict[str, List[float]] = {"feed": []}
        events, losses = [], []
        rows = {"train": 0, "eval": 0}
        folder = tempfile.TemporaryDirectory()  # the stretches' traces, read after the window
        plan, start = [], PROFILE_AFTER
        for name, count in STRETCHES if trace else ():
            plan.append(_Stretch(name, start, start + count, self, folder.name))
            start += count
        done, active = [], None
        pending = None
        steps = 0
        clock = time.perf_counter
        self._sync()
        t0 = clock()
        while clock() - t0 < seconds:
            if active is None and plan and plan[0].first == steps:
                active = plan.pop(0)
                active.start()
            mark = active.mark if active is not None else lambda name: nullcontext()
            a = clock()
            with mark("portbench.feed"):
                x, y, is_training = next(self.feed)
            b = clock()
            with mark(devtrace.DISPATCH):
                values = self._dispatch(x, y, is_training)
            kind = "train" if is_training else "eval"
            rows[kind] += len(x)
            if active is not None:
                active.rows[kind] += len(x)
            elif trace:
                spans["feed"].append(b - a)
                if cuda:
                    event = torch.cuda.Event(enable_timing=True)
                    event.record()
                    events.append((steps, event))
            if pending is not None:
                losses.append(pending.read()["loss"])
            pending = values
            steps += 1
            if active is not None and steps == active.last:
                active.stop()
                done.append(active)
                active = None
        if pending is not None:
            losses.append(pending.read()["loss"])
        self._sync()
        elapsed = clock() - t0
        if active is not None:  # the window closed inside a stretch
            active.stop()
            done.append(active)

        intervals = [e1.elapsed_time(e2) for (i1, e1), (i2, e2) in zip(events, events[1:])
                     if i2 == i1 + 1]
        readings = Readings(self.model_spec, self.training["compute_dtype"], self.batch,
                            spans, intervals)
        with folder:
            for stretch in done:
                stretch.read(readings)
        self.window_losses = losses
        failed = [i for i, v in enumerate(losses) if not np.isfinite(v)]
        counts = {"attempted": steps, "failed": len(failed),
                  "first_failed": failed[0] if failed else None,
                  "rows": rows, "seconds": elapsed}
        return {"train_samples_per_s": (rows["train"] + rows["eval"]) / elapsed}, readings, counts

    # ---- after the window ---------------------------------------------------
    def release(self) -> None:
        """Free the program's state: the feed's threads end, the model,
        optimizer and steps go."""
        self.feed.close()
        for name in ("feed", "model", "optimizer", "train_step", "eval_step", "dataset"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision: str = "float32", fault=None) -> Dict[str, Dict]:
        """The numbers compared: the checked steps against the reference
        (portbench/check.py). ``precision`` and ``fault`` put the control or
        a planted fault in the reference's place on the program's side
        (portbench/calibrate.py); by default the program's own steps."""
        dev = self.device
        x, y = self.checked_rows
        batches = [(torch.from_numpy(x[i:i + self.batch]).to(dev).float(),
                    torch.from_numpy(y[i:i + self.batch]).to(dev).float())
                   for i in range(0, len(x), self.batch)]
        generator = torch.Generator(dev).manual_seed(self.streams["dropout"])
        masks = [clair2.draw_masks(self.model_spec, self.batch, generator, dev)
                 for _ in batches]
        if self._reference is None:
            self._reference = clair2.train(self.start, batches, masks, self.model_spec,
                                           self.training)
        program = self.checked
        if precision != "float32" or fault is not None:
            program = clair2.train(self.start, batches, masks, self.model_spec, self.training,
                                   precision=precision, fault=fault)
        return check.compare(program, self._reference, self.start)

