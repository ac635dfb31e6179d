"""Learning-rate schedules.

Counterpart of ``multimodal_deepfake_detection_tpu/train/schedules.py``:

* ``PlateauScheduler``: host-side ReduceLROnPlateau with torch semantics
  (mode=min, relative threshold 1e-4, cooldown 0), paired with
  ``optim.set_learning_rate`` between epochs.
* ``onecycle_schedule``: the values of ``optax.cosine_onecycle_schedule``
  (not torch's ``OneCycleLR``, whose phase boundaries differ), with the
  JAX package's guard against a phase of zero steps.
"""
from __future__ import annotations

import math
from typing import Callable


class PlateauScheduler:
    def __init__(
        self,
        init_lr: float,
        *,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.lr = float(init_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


def onecycle_schedule(
    max_lr: float,
    total_steps: int,
    *,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """step -> LR: cosine from ``max_lr / div_factor`` up to ``max_lr`` over
    the first ``int(pct_start * total)`` steps, then down to ``max_lr /
    (div_factor * final_div_factor)`` at ``total`` and flat after.

    optax's piecewise cosine NaNs when a phase rounds to zero steps (tiny
    runs), so warmup and cooldown are clamped to span at least one step."""
    total_steps = max(int(total_steps), 4)
    pct_start = min(max(pct_start, 1.0 / total_steps), 1.0 - 1.0 / total_steps)
    b1 = int(pct_start * total_steps)
    init = max_lr / div_factor
    bounds = (0, b1, total_steps)
    peak = init * div_factor
    values = (init, peak, peak * (1.0 / (div_factor * final_div_factor)))

    def schedule(step: int) -> float:
        if step >= bounds[2]:
            return float(values[2])
        k = 0 if step < bounds[1] else 1
        pct = (step - bounds[k]) / (bounds[k + 1] - bounds[k])
        start, end = values[k], values[k + 1]
        return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))

    return schedule
