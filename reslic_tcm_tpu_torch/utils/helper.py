"""Helpers (port of reslic_tcm_tpu/utils/helper.py: what eval and the
trainer use)."""

from __future__ import annotations

from datetime import datetime
from os.path import join

from ..data.datasets import read_image  # noqa: F401  (re-export, helper.py:70-74)
from ..entropy.annealings import configure_annealings  # noqa: F401  (re-export, helper.py:118)


def configure_latent_space_policy(args, multi: bool = False) -> list[dict]:
    """Per-lambda STanH configuration dicts (reference helper.py:16-46):
    one dict from the first entry of each ``--gauss_*`` list (frozen
    quantizer), or with ``multi`` one per lambda with its trainable flag."""

    def pick(v, i):
        return v[i] if isinstance(v, list) else v

    if not multi:
        return [{
            "beta": pick(args.gauss_beta, 0),
            "num_sigmoids": pick(args.gauss_num_sigmoids, 0),
            "annealing": pick(args.gauss_annealing, 0),
            "symmetry": args.symmetry,
            "gap_factor": pick(args.gauss_gp, 0),
            "extrema": pick(args.gauss_extrema, 0),
            "trainable": False,
            "removing_mean": args.removing_mean,
        }]
    return [{
        "beta": args.gauss_beta[i],
        "num_sigmoids": args.gauss_num_sigmoids[i],
        "annealing": args.gauss_annealing[i],
        "symmetry": args.symmetry,
        "gap_factor": args.gauss_gp[i],
        "extrema": args.gauss_extrema[i],
        "trainable": args.gauss_trainable[i] == "yes",
        "removing_mean": args.removing_mean,
    } for i in range(len(args.lambda_list))]


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
