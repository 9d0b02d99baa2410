"""beta-temperature annealing schedules for STanH training (a copy of
reslic_tcm_tpu/entropy/annealings.py, which imports no JAX).

Host-side state machines (like LR schedules): stepped between train steps,
the current beta is passed to the step as a float. Semantics follow
reference annealings/functions.py:7-346 — types {linear, linear_stoc, gap,
gap_stoc, loss, AugmentBetaOnPlateau, constant, triangle, random}. The
random draws come from ``random.Random(0)`` unless a stream is given, as
in the JAX package.
"""

from __future__ import annotations

import random as _random


class StanhAnnealing:
    """General scheduler (reference StanhAnnealings, functions.py:7-141)."""

    TYPES = ("linear", "linear_stoc", "gap", "gap_stoc", "constant", "loss",
             "AugmentBetaOnPlateau", "triangle")

    def __init__(self, beta=1.0, factor=50.0, type="gap", iteration=1500,
                 decreasing=False, dec_epoch=-1, decreasing_factor=0.0,
                 threshold=0.02, mode="min", threshold_mode="abs", patience=10,
                 max_beta=1000.0, rng=None):
        assert type in self.TYPES, type
        self.type = type
        self.beta = float(beta)
        self.factor = float(factor)
        self.iteration = iteration
        self.decreasing = decreasing
        self.dec_epoch = dec_epoch
        self.decreasing_factor = decreasing_factor
        self.threshold = threshold
        self.mode = mode
        self.threshold_mode = threshold_mode
        self.patience = patience
        self.max_beta = float(max_beta)
        self.beta_max = float(beta)
        self.loss_hist: list[float] = []
        self.num_bad_epochs = 0
        self.best = 1e2
        self.beta_list = [self.beta]
        self.gap = 0.0
        self._rng = rng if rng is not None else _random.Random(0)

    def _is_better(self, a, best):
        if self.mode == "min" and self.threshold_mode == "abs":
            return a < best - self.threshold
        if self.mode == "min":
            return a < best * (1.0 - self.threshold)
        if self.threshold_mode == "abs":
            return a > best - self.threshold
        return a > best * (1.0 - self.threshold)

    def step(self, gap=0.0, epoch=0, loss=None, plateau=False):
        gap = float(gap)
        if self.type == "linear":
            if self.beta < 50000:
                if not self.decreasing or self.dec_epoch > epoch:
                    self.beta += self.factor / self.iteration
                else:
                    self.beta -= self.decreasing_factor / self.iteration
            else:
                self.beta = self.beta / 2
        elif self.type == "linear_stoc":
            self.beta_max += self.factor / self.iteration
            self.beta = self._rng.uniform(1.0, max(1.0, self.beta_max))
        elif self.type == "gap":
            self.gap = gap
            self.beta = self.beta + self.factor * gap
        elif self.type == "gap_stoc":
            self.gap = gap
            self.beta_max = self.beta_max + self.factor * gap
            hi = min(self.beta_max, self.max_beta)
            self.beta = self._rng.uniform(1.0, max(1.0, hi))
        elif self.type == "loss":
            if loss is not None:
                self.loss_hist.append(float(loss))
                if len(self.loss_hist) >= 2:
                    d = abs(self.loss_hist[-1] - self.loss_hist[-2])
                    if d <= self.threshold and d > 0:
                        self.beta = self.beta + self.factor * (1 / d)
                    self.loss_hist = self.loss_hist[-2:]
        elif self.type == "AugmentBetaOnPlateau" and plateau:
            current = float(loss)
            if self._is_better(current, self.best):
                self.best = current
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience and self.beta_list[-1] < self.max_beta:
                self.beta *= self.factor
                self.num_bad_epochs = 0
                self.beta_list.append(self.beta)
        # constant: no-op
        return self.beta


class RandomAnnealing:
    """Uniform beta each step (reference RandomAnnealings, functions.py:144-171)."""

    def __init__(self, beta=1.0, left_beta=1.0, right_beta=1000.0, gap=False,
                 factor=0.05, type="random", rng=None):
        self.type = type
        self.beta = float(beta)
        self.left_beta = left_beta
        self.right_beta = right_beta
        self.use_gap = gap
        self.factor = factor
        self.triggered = False
        self.beta_fix = float(beta)
        self._rng = rng if rng is not None else _random.Random(0)

    def step(self, gap=None, **_):
        if gap is not None and self.use_gap:
            if self.beta >= 100:
                self.triggered = True
                self.beta_fix = self.beta
            if self.triggered:
                self.beta = self._rng.uniform(self.beta_fix / 10, self.beta_fix)
            else:
                self.beta = self.beta + self.factor * float(gap)
        else:
            self.beta = self._rng.uniform(self.left_beta, self.right_beta)
        return self.beta


class TriangleAnnealing:
    """Grow-then-sample schedule (reference Annealing_triangle,
    functions.py:174-194)."""

    def __init__(self, beta=1.0, factor=0.5, rng=None):
        self.type = "triangle"
        self.increase = True
        self.factor = factor
        self.dec_factor = factor * 0.9
        self.beta = float(beta)
        self.beta_max = float(beta)
        self._rng = rng if rng is not None else _random.Random(0)

    def step(self, gap=0.0, **_):
        if self.increase:
            self.beta_max += self.factor * float(gap)
        else:
            self.beta_max -= self.dec_factor * float(gap)
        self.beta = self._rng.uniform(1.0, max(1.0, self.beta_max))
        return self.beta


def configure_annealings(config: dict | None):
    """Factory matching reference utils/helper.py:118-133."""
    if config is None or "none" in config.get("annealing", "none"):
        return None
    kind = config["annealing"]
    if "random" in kind:
        return RandomAnnealing(beta=config["beta"], type=kind, gap=False)
    if "triangle" in kind:
        return TriangleAnnealing(beta=config["beta"], factor=config["gap_factor"])
    return StanhAnnealing(
        beta=config["beta"], factor=config["gap_factor"], type=kind
    )
