"""Epoch-level learning-rate schedules (the port's own copy of
vipformer_tpu/train/schedules.py).

Replicates the reference's four scheduler choices (`pretrain.py:128-152`):
* `cos` — torch CosineAnnealingLR(T_max=epochs),
* `step` — torch StepLR(step_size, gamma),
* `coswarm` — katsura-jp `CosineAnnealingWarmupRestarts` semantics
  (first_cycle_steps=step_size, warmup_steps=warm_epochs, max_lr, min_lr,
  gamma; cycle_mult fixed at 1 as the reference leaves it default),
* `plateau` — torch ReduceLROnPlateau(mode='min', factor, patience).

All but plateau are pure functions epoch -> lr; the trainer sets the value
on the optimizer before each epoch's steps. Plateau is a small host-side
state machine fed the epoch metric.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from vipformer_tpu_torch.config import Config


def cosine_lr(epoch: int, base_lr: float, epochs: int, min_lr: float = 0.0) -> float:
    return min_lr + (base_lr - min_lr) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def step_lr(epoch: int, base_lr: float, step_size: int, gamma: float) -> float:
    return base_lr * (gamma ** (epoch // step_size))


def cosine_warmup_restarts_lr(
    epoch: int,
    first_cycle_steps: int,
    max_lr: float,
    min_lr: float,
    warmup_steps: int,
    gamma: float,
) -> float:
    cycle = epoch // first_cycle_steps
    t = epoch % first_cycle_steps
    cur_max = max_lr * (gamma**cycle)
    if t < warmup_steps:
        return (cur_max - min_lr) * t / warmup_steps + min_lr
    frac = (t - warmup_steps) / (first_cycle_steps - warmup_steps)
    return min_lr + (cur_max - min_lr) * (1 + math.cos(math.pi * frac)) / 2


@dataclass
class PlateauState:
    """torch ReduceLROnPlateau(mode='min') state machine, exact semantics:
    rel-threshold improvement test (default 1e-4), cooldown epochs during
    which bad-epoch counting is suspended, a floor `min_lr`, and the `eps`
    rule that skips updates smaller than eps. Defaults match torch's (the
    reference passes only factor/patience, `pretrain.py:146-152`).
    """

    lr: float
    factor: float
    patience: int
    threshold: float = 1e-4
    cooldown: int = 0
    min_lr: float = 0.0
    eps: float = 1e-8
    best: float = math.inf
    bad_epochs: int = 0
    cooldown_counter: int = 0

    def update(self, metric: float) -> float:
        """Feed the epoch metric (lower is better); returns the lr to use."""
        # rel-mode improvement: metric < best * (1 - threshold)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.bad_epochs = 0
        return self.lr


class Schedule:
    """Uniform epoch->lr interface over the four scheduler kinds."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.kind = cfg.scheduler
        self._plateau = PlateauState(cfg.lr, cfg.factor, cfg.patience)

    def lr(self, epoch: int, metric: float | None = None) -> float:
        c = self.cfg
        if self.kind == "cos":
            return cosine_lr(epoch, c.lr, c.epochs)
        if self.kind == "step":
            return step_lr(epoch, c.lr, c.step_size, c.gamma)
        if self.kind == "coswarm":
            return cosine_warmup_restarts_lr(
                epoch, c.step_size, c.max_lr, c.min_lr, c.warm_epochs, c.gamma
            )
        if self.kind == "plateau":
            if metric is None:
                return self._plateau.lr
            return self._plateau.update(metric)
        raise ValueError(self.kind)
