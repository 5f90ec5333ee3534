"""Per-epoch learning-rate schedulers (torch ``lr_scheduler`` semantics).

The torch package's own copy of ``transformer_clip_eeg_tpu/train/
schedulers.py`` (standard library only): no/plateau/step/cosine/
cosine_warmup, the reference's choices, with the two cosine paths working
(``CosineAnnealingLR(T_max=10)`` and ``CosineAnnealingWarmRestarts(T_0=10,
T_mult=2)``).  ``step(val_metric) -> lr`` is called once per epoch and the
trainer hands the result to the optimizer (``train/state.set_learning_rate``).
"""

from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.epoch = -1

    def step(self, val_metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self._compute(val_metric)
        return self.lr

    def _compute(self, val_metric: Optional[float]) -> float:
        return self.base_lr


class NoScheduler(LRScheduler):
    pass


class StepLR(LRScheduler):
    """torch ``StepLR(step_size, gamma=0.1)`` — the working reference default
    (ref train_clip_final.py:417)."""

    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute(self, val_metric):
        return self.base_lr * self.gamma ** ((self.epoch + 1) // self.step_size)


class ReduceLROnPlateau(LRScheduler):
    """torch ``ReduceLROnPlateau(mode='min', factor=0.1, patience=5)``
    (ref train_clip_final.py:415)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 5):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.best = math.inf
        self.bad_epochs = 0

    def _compute(self, val_metric):
        if val_metric is None:
            return self.lr
        if val_metric < self.best:
            self.best = val_metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return self.lr * self.factor
        return self.lr


class CosineAnnealingLR(LRScheduler):
    """torch ``CosineAnnealingLR(T_max=10, eta_min=0)``."""

    def __init__(self, base_lr: float, t_max: int = 10, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def _compute(self, val_metric):
        e = self.epoch + 1
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * e / self.t_max)
        ) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    """torch ``CosineAnnealingWarmRestarts(T_0=10, T_mult=2, eta_min=0)``."""

    def __init__(
        self,
        base_lr: float,
        t_0: int = 10,
        t_mult: int = 2,
        eta_min: float = 0.0,
    ):
        super().__init__(base_lr)
        self.t_0 = t_0
        self.t_mult = t_mult
        self.eta_min = eta_min

    def _compute(self, val_metric):
        e = self.epoch + 1
        t_i, t_cur = self.t_0, e
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.t_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2


def make_scheduler(
    name: str, base_lr: float, step_size_scheduler: int = 10
) -> LRScheduler:
    """Ref train_clip_final.py:414-425 dispatch."""
    if name == "no":
        return NoScheduler(base_lr)
    if name == "plateau":
        return ReduceLROnPlateau(base_lr)
    if name == "step":
        return StepLR(base_lr, step_size_scheduler)
    if name == "cosine":
        return CosineAnnealingLR(base_lr)
    if name == "cosine_warmup":
        return CosineAnnealingWarmRestarts(base_lr)
    raise ValueError(f"unknown lr_scheduler {name!r}")
