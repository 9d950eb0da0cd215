"""Host-side learning-rate schedulers (epoch granularity).

Port of ``deepfm_tpu/training/schedulers.py``: the same plateau and
warmup-cosine arithmetic on Python floats. The learning rate is optimizer
state (``OptState.lr``, a 0-dim f32 tensor the step reads), so ``set_lr``
writes it between epochs without touching the step.
"""

from __future__ import annotations

import math

import torch

from deepfm_tpu_torch.training.optim import OptState

__all__ = ["PlateauScheduler", "CosineScheduler", "SCHEDULERS",
           "build_scheduler", "set_lr"]

SCHEDULERS = ("reduce_on_plateau", "none", "warmup_cosine")


class PlateauScheduler:
    """Host-side reduce-on-plateau (mode max, factor 0.5, patience 2),
    matching torch ReduceLROnPlateau semantics incl. the 1e-4 relative
    threshold."""

    def __init__(
        self,
        lr: float,
        factor: float = 0.5,
        patience: int = 2,
        threshold: float = 1e-4,
        enabled: bool = True,
    ) -> None:
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.enabled = enabled
        self.best = -float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if not self.enabled:
            return self.lr
        if metric > self.best * (1 + self.threshold) or self.best == -float(
            "inf"
        ):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]


class CosineScheduler:
    """Host-side warmup + cosine decay at EPOCH granularity.

    LR for epoch ``e`` (1-based): linear ramp ``base * e / warmup`` over
    the first ``warmup_epochs`` epochs, then cosine decay from ``base``
    to ``min_frac * base`` at the final epoch. The host writes each
    epoch's LR into the optimizer state (``set_lr``), which the dense
    chain and the table kernels read alike.
    """

    def __init__(
        self,
        lr: float,
        total_epochs: int,
        warmup_epochs: int = 0,
        min_frac: float = 0.01,
    ) -> None:
        self.base = lr
        self.total = max(total_epochs, 1)
        self.warmup = max(min(warmup_epochs, self.total - 1), 0)
        self.min_lr = min_frac * lr
        self.epoch = 1
        self.lr = self._lr_for(1)

    def _lr_for(self, e: int) -> float:
        if self.warmup and e <= self.warmup:
            return self.base * e / self.warmup
        t = (e - self.warmup - 1) / max(self.total - self.warmup - 1, 1)
        return self.min_lr + 0.5 * (self.base - self.min_lr) * (
            1.0 + math.cos(math.pi * min(max(t, 0.0), 1.0))
        )

    def step(self, metric: float) -> float:
        """Advance to the next epoch's LR (the metric is ignored)."""
        self.epoch += 1
        self.lr = self._lr_for(min(self.epoch, self.total))
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "epoch": self.epoch}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.epoch = d["epoch"]


def build_scheduler(training) -> PlateauScheduler | CosineScheduler:
    """The scheduler of a ``TrainingConfig`` (``Trainer.__init__`` of the
    JAX package); raises ValueError on an unknown name."""
    if training.scheduler not in SCHEDULERS:
        raise ValueError(f"Unknown scheduler: {training.scheduler}")
    if training.scheduler == "warmup_cosine":
        return CosineScheduler(lr=training.lr,
                               total_epochs=training.num_epochs,
                               warmup_epochs=training.warmup_epochs)
    return PlateauScheduler(lr=training.lr,
                            enabled=training.scheduler == "reduce_on_plateau")


def set_lr(opt_state: OptState, lr: float) -> None:
    """Write the learning rate the next step reads, rounded to f32 as the
    JAX package's ``jnp.asarray(lr, float32)``."""
    opt_state.lr = torch.full((), lr, dtype=torch.float32,
                              device=opt_state.lr.device)
