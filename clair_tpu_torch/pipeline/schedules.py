"""Learning-rate schedules: cyclical LR and the adaptive-decay heuristics.

Semantics match the reference trainers so published training recipes carry
over (clr: clair/model.py:1086-1103; decay triggers: clair/train.py:18-62).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from clair_tpu_torch.params import CLR_GAMMA, CLR_MIN_LR


@dataclass
class CyclicalLR:
    """Triangular cyclical learning rate with tri / tri2 / exp decay modes.

    Stateful like the reference's ``clr()``: each call advances one training
    iteration; after a full cycle, max_lr decays by mode and the step
    counter resets.
    """

    step_size: int
    max_lr: float
    mode: str = "tri"
    min_lr: float = CLR_MIN_LR
    gamma: float = CLR_GAMMA
    global_step: int = 0

    def __call__(self) -> float:
        self.global_step += 1
        cycle = 1 + self.global_step / (2 * self.step_size)
        if cycle > 2:
            self.global_step = 0
            if self.mode == "exp":
                self.max_lr = self.max_lr * self.gamma
            elif self.mode == "tri2":
                self.max_lr = self.max_lr / 2
        x = self.global_step / self.step_size
        if x <= 1:
            return self.min_lr + (self.max_lr - self.min_lr) * max(0.0, x)
        return self.min_lr + (self.max_lr - self.min_lr) * max(0.0, 2 - x)


@dataclass
class AdaptiveDecay:
    """Validation-loss-driven LR decay state machine (ref train.py:214-235).

    ``observe(val_loss)`` returns (should_stop, did_decay).
    """

    max_switches: int = 3
    min_epochs_for_oscillation: int = 6
    min_epochs_for_increase: int = 8
    validation_losses: List[Tuple[float, int]] = field(default_factory=list)
    epochs_at_current_lr: int = 0
    switches_left: int = field(default=-1)

    def __post_init__(self):
        if self.switches_left < 0:
            self.switches_left = self.max_switches

    def observe(self, val_loss: float, epoch: int) -> Tuple[bool, bool]:
        self.validation_losses.append((val_loss, epoch))
        self.epochs_at_current_lr += 1

        need_update = (
            self.epochs_at_current_lr >= self.min_epochs_for_oscillation
            and not self._last_five_approach_minimum()
            and self._loss_oscillates()
        ) or (
            self.epochs_at_current_lr >= self.min_epochs_for_increase
            and self._loss_keeps_increasing()
        )
        if not need_update:
            return False, False

        self.switches_left -= 1
        if self.switches_left == 0:
            return True, False
        self.epochs_at_current_lr = 0
        return False, True

    def best_epoch(self) -> int:
        return min(self.validation_losses)[1]

    def _losses(self) -> np.ndarray:
        return np.asarray([v for v, _ in self.validation_losses])

    def _last_five_approach_minimum(self) -> bool:
        losses = self._losses()
        if len(losses) <= 5:
            return True
        return losses[-5:].min() == losses.min()

    def _loss_oscillates(self) -> bool:
        losses = self._losses()
        if len(losses) <= 6:
            return False
        a = losses[-6:]
        diffs = np.sign(np.diff(a))
        return bool(np.all(diffs == np.array([-1, 1, -1, 1, -1]))) or bool(
            np.all(diffs == np.array([1, -1, 1, -1, 1]))
        )

    def _loss_keeps_increasing(self) -> bool:
        losses = self._losses()
        if len(losses) <= 6:
            return False
        return bool((losses[-5:] > losses.min()).all())
