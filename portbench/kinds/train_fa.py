"""Training traffic for Clair3's full-alignment network (Clair3_F): the
port's training loop over a bin of full-alignment rows made from the seed.

A traffic file of this kind gives ``batch``, ``val_batch``, ``val_share``
and ``reads`` (the profile of portbench/fa_rows.py); the configuration
gives the model (the fields of the port's
models/clair3_fa.py:FullAlignmentConfig), the recipe and ``bin_rows``.

It is kinds/train.py's cell with Clair3_F in ClairNet's place, and takes
from there everything that is not the model's: the seeds' streams, the
bin's packing (data/bins.py:_pack), the feed (``EpochBatches`` of int16
blocks), the window in train_model's order and its profiled stretches, the
readings. Here: the rows (portbench/fa_rows.py), the weights
(portbench/weights.py's fan-in rule for the conv and dense kernels, HWIO,
so the receptive field counts; batch norm's scale 1 and shift 0), the
model, x's bytes counted as train_model counts them (``dispatch.x_bytes``),
the "host" stretch's split of the step by Clair3_F's ranges
(portbench/fa_trace.py), and the reference (portbench/reference/
clair3_fa.py), which follows the checked steps after the window on whole
batches, batch norm's statistics being the whole batch's.

The numbers compared (``compare``) are portbench/check.py's, but that
step 1's gradient (``grad_gap``) is held to the reference's computed in
float64: in float32 the first stage's gradients, reduced through batch
norm over 1.5M positions a channel, carry round-off of 1e-4 to 6e-3 of
their norm in the reference as in the program (PERF.md §2), and a gap
between two such gradients reads both. The three steps' losses and
changes are held to the float32 reference's, whose float32 course the
program shares. And ``stats_gap``: Clair3_F's step also changes state
that is no parameter, batch norm's running statistics, which evaluation
and every checkpoint use.

The process's cuDNN and cuBLAS TF32 switches are off from set-up until
release (the model's ``float32_products``): the float32 step must not run
in TF32, and autograd launches the backward's convolutions from its own
thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Dict
from unittest import mock

import numpy as np
import torch

from clair_tpu_torch.models.clair3_fa import Clair3FANet, FullAlignmentConfig, float32_products
from clair_tpu_torch.parallel.sharding import make_eval_step, make_optimizer, make_train_step
from clair_tpu_torch.pipeline.train import _StepValues, _to_device

from portbench import check, fa_trace
from portbench.fa_rows import make_rows
from portbench.kinds import train
from portbench.kinds.train import CHECKED_STEPS, pack_bin
from portbench.reference import clair3_fa
from portbench.weights import make_weights

_MODEL_FIELDS = {f.name for f in dataclasses.fields(FullAlignmentConfig)}
X_BYTES = "dispatch.x_bytes"


def stats_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              start: Dict[str, torch.Tensor]) -> Dict:
    """Batch norm's running statistics after the checked steps, by the worst
    buffer: the norm of the gap between the two sides' changes from
    ``start``, over the larger of the reference's change of that buffer and
    of the median buffer. Statistics left unchanged read 1 in the buffer
    that moved most; a momentum of 0.9 in place of 0.99 about 8 over three
    steps (the change (1 - 0.9^3) / (1 - 0.99^3) = 9.1 times the reference's)."""
    change = {k: (program[k].double() - start[k].double(),
                  reference[k].double() - start[k].double()) for k in reference}
    moved = {k: float(r.norm()) for k, (_, r) in change.items()}
    median = statistics.median(moved.values())
    gaps = {k: float((p - r).norm()) / max(moved[k], median, 1e-30)
            for k, (p, r) in change.items()}
    worst = max(gaps, key=gaps.get)
    return {"value": gaps[worst], "leaf": worst}


def compare(program: Dict, reference: Dict, exact: Dict, start: Dict[str, torch.Tensor],
            start_stats: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """portbench/check.py's numbers and ``stats_gap`` of the program's
    {"losses", "grad", "params", "stats"} against the reference's, but
    ``grad_gap`` against ``exact``'s, the reference's step 1 in float64."""
    numbers = check.compare(program, reference, start)
    numbers["grad_gap"] = check.compare(program, exact, start)["grad_gap"]
    numbers["stats_gap"] = stats_gap(program["stats"], reference["stats"], start_stats)
    return numbers


class _Stretch(train._Stretch):
    """kinds/train.py's stretch; the "host" one also splits the step by
    Clair3_F's ranges into ``readings.trace["fa"]``."""

    def read(self, readings: train.Readings) -> None:
        super().read(readings)
        if self.profiler is not None and self.name == "host":
            readings.trace["fa"] = fa_trace.read_host(self.path, fa_trace.x_bytes())


class Cell(train.Cell):
    def __init__(self, *args) -> None:
        super().__init__(*args)
        self._kept = {}  # the reference's steps the check holds the program to

    def setup(self) -> None:
        dev = self.device
        self._precision = contextlib.ExitStack()
        self._precision.enter_context(float32_products())
        clock = time.perf_counter
        marks = [clock()]
        rows, positions = (int(k) for k in self.model_spec["input_shape"][:2])
        x, y = make_rows(self.rows, self.mix["reads"], rows, positions,
                         torch.Generator(dev).manual_seed(self.streams["rows"]), dev)
        x, y = x.numpy(), y.numpy()
        marks.append(clock())
        checked = CHECKED_STEPS * self.batch
        self.checked_rows = (x[:checked].copy(), y[:checked].copy())
        self.dataset = pack_bin(x, y)
        del x, y
        marks.append(clock())

        shapes = clair3_fa.param_shapes(self.model_spec)
        drawn = make_weights({k: s for k, s in shapes.items() if not k.endswith(".bn.s")},
                             torch.Generator(dev).manual_seed(self.streams["weights"]), dev)
        self.start = {k: drawn[k] if k in drawn else torch.ones(s, device=dev)
                      for k, s in shapes.items()}
        self._sync()
        marks.append(clock())
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in self.model_spec.items() if k in _MODEL_FIELDS}
        config = FullAlignmentConfig(**fields, compute_dtype=self.training["compute_dtype"])
        self.model = Clair3FANet(config, dev)
        self.model.load_state_dict({**self.model.state_dict(), **self.start})
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
                                   for k, v in self.model.named_parameters()},
                        "stats": {k: v.clone() for k, v in self.model.named_buffers()}}
        if float(self.mix["val_share"]) > 0:
            self._warm_eval()
        self._sync()
        marks.append(clock())
        self.setup_parts = dict(zip(("rows", "pack", "weights", "model", "optimizer",
                                     "checked_steps"),
                                    (b - a for a, b in zip(marks, marks[1:]))))

    def _dispatch(self, x: np.ndarray, y: np.ndarray, is_training: bool) -> _StepValues:
        xd, yd = _to_device(x, self.device, X_BYTES), _to_device(y, self.device)
        if is_training:
            loss, components = self.train_step(xd, yd, self.generator,
                                               self.training["l2_lambda"])
        else:
            loss, components = self.eval_step(xd, yd, self.training["l2_lambda"])
        return _StepValues(loss, components, is_training)

    def window(self, seconds: float, trace: bool):
        """kinds/train.py's window, its stretches this module's."""
        with mock.patch.object(train, "_Stretch", _Stretch):
            return super().window(seconds, trace)

    def release(self) -> None:
        super().release()
        self._precision.close()

    def inputs(self):
        """The checked steps' batches on the device and their dropout masks,
        drawn as the program drew them."""
        dev = self.device
        x, y = self.checked_rows
        batches = [(torch.from_numpy(x[i:i + self.batch]).to(dev).float(),
                    torch.from_numpy(y[i:i + self.batch]).to(dev).float())
                   for i in range(0, len(x), self.batch)]
        generator = torch.Generator(dev).manual_seed(self.streams["dropout"])
        masks = [clair3_fa.draw_masks(self.model_spec, self.batch, generator, dev)
                 for _ in batches]
        return batches, masks

    def reference(self, precision: str = "float32", fault=None, model=None,
                  steps: int = CHECKED_STEPS) -> Dict:
        """The reference's first ``steps`` checked steps (the plain float32
        ones and step 1 in float64 kept); with ``precision``, a ``fault`` or
        a ``model`` (a model spec) a control or a planted fault
        (portbench/calibrate_fa.py)."""
        key = (precision, steps)
        kept = fault is None and model is None and key in (("float32", CHECKED_STEPS),
                                                           ("float64", 1))
        if kept and key in self._kept:
            return self._kept[key]
        batches, masks = self.inputs()
        out = clair3_fa.train(self.start, batches[:steps], masks[:steps],
                              model or self.model_spec, self.training, precision=precision,
                              fault=fault)
        if kept:
            self._kept[key] = out
        return out

    def start_stats(self) -> Dict[str, torch.Tensor]:
        return clair3_fa.initial_stats(self.model_spec, self.device)

    def check(self, precision: str = "float32", fault=None, model=None) -> Dict[str, Dict]:
        """The numbers compared: the checked steps against the reference
        (``compare``). ``precision`` and ``fault`` put the reference in that
        precision or with that fault in the program's place, as in
        kinds/train.py, and so does ``model``, a model spec (a planted
        fault)."""
        program = self.checked
        if precision != "float32" or fault is not None or model is not None:
            program = self.reference(precision, fault, model)
        return compare(program, self.reference(), self.reference("float64", steps=1),
                       self.start, self.start_stats())
