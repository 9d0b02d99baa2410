"""Helpers (port of reslic_tcm_tpu/utils/helper.py: what eval and the
trainer use)."""

from __future__ import annotations

from datetime import datetime
from os.path import join


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


def create_savepath(args, epoch, base_path):
    """Checkpoint paths for an epoch (reference helper.py:55-73): the epoch
    file, its "best" twin and the run's very-best file."""
    date_time = datetime.now().strftime("%m%d")
    c = join(date_time, "_lambda_", str(args.lambda_list[0]), "_epoch_", str(epoch)).replace("/", "_")
    c_best = join(c, "best").replace("/", "_")
    c = join(c, ".ckpt").replace("/", "_")
    c_best = join(c_best, ".ckpt").replace("/", "_")
    return join(base_path, c), join(base_path, c_best), join(base_path, "_very_best.ckpt")


def sec_to_hours(seconds: float) -> str:
    a = int(seconds // 3600)
    b = int((seconds % 3600) // 60)
    c = int((seconds % 3600) % 60)
    msg = f"{a} hours {b} mins {c} seconds"
    print(msg)
    return msg
