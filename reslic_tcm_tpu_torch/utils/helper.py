"""Helpers (port of reslic_tcm_tpu/utils/helper.py; only what eval uses)."""

from __future__ import annotations


class AverageMeter:
    """Running average (reference helper.py:88-101)."""

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
