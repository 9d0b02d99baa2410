"""Training checkpoints and host-side learning-rate scheduling (port of
reslic_tcm_tpu/utils/checkpoint.py).

A checkpoint is the reference's dict (reference train.py:307-322) written
with ``torch.save``: the model's state dict, both optimisers, the
scheduler, the epoch and the validation loss, plus the global step (which
seeds the next step's noise). Derived CDF tables are not saved: the
codec's ``update()`` rebuilds them from the parameters.
"""

from __future__ import annotations

import os

import torch


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau's rule as the JAX package
    has it (mode 'min', relative threshold, reference train.py:176): the
    learning rate is a number returned by ``step``, which the trainer sets
    on its optimiser."""

    def __init__(self, init_lr: float, mode: str = "min", factor: float = 0.5,
                 patience: int = 4, threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = float(init_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, a: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return a < self.best * (1 - self.threshold)
        return a > self.best * (1 + self.threshold)

    def step(self, metric: float) -> float:
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, d: dict):
        self.__dict__.update(d)


def save_checkpoint(path: str, state, scheduler: ReduceLROnPlateau, epoch: int,
                    val_loss: float) -> None:
    """Write ``state`` (a ``training.step.TrainState``), the scheduler, the
    epoch and the validation loss to ``path``; the file appears whole or
    not at all."""
    payload = {
        "epoch": int(epoch),
        "state_dict": state.module.state_dict(),
        "loss": float(val_loss),
        "optimizer": state.optimizer.state_dict(),
        "aux_optimizer": (None if state.aux_optimizer is None
                          else state.aux_optimizer.state_dict()),
        "lr_scheduler": scheduler.state_dict(),
        "step": int(state.step),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The dict ``save_checkpoint`` wrote."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore(state, payload: dict, scheduler: ReduceLROnPlateau | None = None) -> int:
    """Load a checkpoint's model, optimisers, step and (when given) scheduler
    into ``state``; returns the next epoch."""
    state.module.load_state_dict(payload["state_dict"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.aux_optimizer is not None:
        state.aux_optimizer.load_state_dict(payload["aux_optimizer"])
    state.step = int(payload["step"])
    if scheduler is not None:
        scheduler.load_state_dict(payload["lr_scheduler"])
    return int(payload["epoch"]) + 1
