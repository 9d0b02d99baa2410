"""Training CLI (port of reslic_tcm_tpu/cli/train.py).

The JAX trainer's flags (``utils/parser.py``) and recipe: epochs over an
ImageFolder of random crops, a random rate level per batch (Python's
``random`` seeded by ``--seed``) passed to the step as ``lv``, the main and
aux Adam with global-norm clipping (``training/step.py``), validation per
lambda at its level with each image padded to a multiple of 128,
``ReduceLROnPlateau`` on the mean validation loss, best and very-best
checkpoints and the two newest epoch files. The STanH codecs take beta
from one annealing schedule per run (``get_model``'s), stepped with each
batch's ``gap``, epoch and loss; ``--freeze`` trains only their
staircases and synthesis transforms. The gain codecs train level p's
gains with lambda p; ``scale_gain_sc`` is refused (its forward needs a
quality map, which no train step feeds).
``--tester`` validates and stops; ``--checkpoint`` takes a ``.npz``
snapshot of JAX parameters (a warm start, every parameter required), a
PyTorch ``.pth``/``.pth.tar``/``.pt`` state dict (a non-strict warm start,
as the JAX trainer's: ``utils/torch_convert.py::warm_start_codec``, e.g. a
CompressAI-zoo bmshj2018 checkpoint into ``-m scale_stanh``) or the port's
own checkpoint, whose optimisers, scheduler, step and epoch
``--continue_train`` resumes.
Runs on the CUDA device unless ``--platform cpu``. ``--bf16`` trains with
the JAX trainer's bf16 matmul precision (``training/step.py``; parameters
and optimiser states fp32, validation fp32). wandb is not ported.

``--coordinator host:port --num_processes n --process_id i`` makes the run
one rank of n (NCCL on the card, gloo with ``--platform cpu``; rank 0
listens at the coordinator): ``--batch-size`` is then global, each rank
loads its rows (its own shuffle, seeded with ``--seed`` + rank) and takes
the data-parallel step (``training/step.py::shard_train_step``), every rank
keeps the same rate level, validation loss and learning rate, and only
rank 0 saves.

    python -m reslic_tcm_tpu_torch.cli.train -m tcm --N 64 -d <root with
        train/data and test/data> --lambda_list 0.013 --save_path runs/
"""

from __future__ import annotations

import functools
import os
import random
import sys
import time

import numpy as np
import torch

from .eval import _device  # the card (TF32 off, cuDNN deterministic) or the CPU
from .eval import load_checkpoint as load_snapshot


def warm_start(codec, path: str) -> None:
    """``--checkpoint``'s weights-only warm starts: a PyTorch state-dict file
    non-strictly (the JAX trainer's ``warm_start_codec``), a ``.npz``
    snapshot strictly (every parameter in it)."""
    if path.endswith((".pth", ".pth.tar", ".pt")):
        from ..utils.torch_convert import warm_start_codec

        warm_start_codec(codec, path)
    else:
        load_snapshot(codec, path)


def to_device(batch: np.ndarray, device) -> torch.Tensor:
    """An NHWC numpy batch -> an NCHW float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2))).to(device)


def main(argv=None):
    from ..utils.parser import parse_args

    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.model == "scale_gain_sc":
        raise ValueError("-m scale_gain_sc needs a quality map input, which the train step "
                         "does not feed (nor does the JAX trainer's)")
    device = _device(args)
    if args.coordinator:
        from ..parallel.multihost import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes, args.process_id, device)
    try:
        return _train(args, device)
    finally:
        if args.coordinator:
            torch.distributed.destroy_process_group()


def _train(args, device) -> int:
    from ..data.datasets import ImageFolder, KodakDataset, Loader
    from ..models import get_model
    from ..parallel.mesh import make_mesh, shard_params
    from ..parallel.multihost import is_coordinator, local_batch_size, rank_and_size
    from ..training.optimizer import set_learning_rate
    from ..training.step import create_train_state, shard_train_step, step_noise, train_step
    from ..utils.checkpoint import ReduceLROnPlateau, load_checkpoint, restore
    from ..utils.helper import AverageMeter, sec_to_hours

    for arg in vars(args):
        print(arg, ":", getattr(args, arg))
    seed = int(args.seed)
    random.seed(seed)
    np.random.seed(seed)

    patch = tuple(args.patch_size)
    train_ds = ImageFolder(args.dataset, num_images=args.num_images, split="train",
                           patch_size=patch, train=True)
    valid_ds = ImageFolder(args.dataset, num_images=args.num_images_val, split="test",
                           patch_size=patch, train=False)
    mesh = make_mesh() if args.coordinator else None
    train_loader = Loader(train_ds, local_batch_size(args.batch_size, mesh),
                          seed=seed + rank_and_size(mesh)[0])
    valid_loader = Loader(valid_ds, args.test_batch_size, seed=0, shuffle=False,
                          drop_last=False)
    kodak = KodakDataset(args.kodak) if os.path.isdir(args.kodak) else None

    codec, _, ann_g, _, _ = get_model(args, device=device)
    module = codec.module
    restored = None
    if args.checkpoint != "none":
        print("Loading", args.checkpoint)
        if args.checkpoint.endswith((".npz", ".pth", ".pth.tar", ".pt")):
            warm_start(codec, args.checkpoint)  # weights only
        else:
            restored = load_checkpoint(args.checkpoint)
            module.load_state_dict(restored["state_dict"])

    # --bf16: the JAX trainer's make_train_step(matmul_precision="bfloat16")
    # for every model; validation stays fp32
    precision = "bfloat16" if args.bf16 else None
    step_fn = functools.partial(train_step, matmul_precision=precision)
    if mesh is not None:
        shard_params(mesh, module)
        step_fn = shard_train_step(mesh, precision)
    is_stanh = is_stanh_name(args.model)
    _warn_frozen_uniform_levels(args)
    if args.freeze and is_stanh:
        from ..training.optimizer import freeze_all_but_stanh

        freeze_all_but_stanh(module)
        print("freeze: training only stanh (+ g_s) parameters")
    state = create_train_state(module, args.learning_rate, float(args.aux_learning_rate),
                               args.clip_max_norm)
    scheduler = ReduceLROnPlateau(args.learning_rate, "min", factor=0.5, patience=4)
    first_epoch = 0
    if restored is not None and args.continue_train:
        first_epoch = restore(state, restored, scheduler)
        print(f"resuming from epoch {first_epoch}, step {state.step}, lr={scheduler.lr}")

    lambda_list = list(args.lambda_list)
    if args.tester:
        _validate(module, valid_loader, lambda_list, args.type, device)
        return 0

    best_loss = float("inf")
    for epoch in range(first_epoch, args.epochs):
        start = time.time()
        print(f"Learning rate: {scheduler.lr}")
        meters = {k: AverageMeter() for k in ("loss", "bpp_loss", "mse_loss")}
        for i, batch in enumerate(train_loader):
            p = random.randint(0, len(lambda_list) - 1)
            beta = float(ann_g.beta) if (is_stanh and ann_g is not None) else None
            metrics = step_fn(state, to_device(batch, device), lambda_list[p],
                                 step_noise(seed, state.step, device), args.type, lv=p,
                                 beta=beta)
            if is_stanh and ann_g is not None:
                ann_g.step(gap=float(metrics["gap"]), epoch=epoch, loss=float(metrics["loss"]))
            for k in meters:
                if k in metrics:
                    meters[k].update(float(metrics[k]))
            if i % 1000 == 0:
                print(f"Train epoch {epoch}: [{i * len(batch)}/{len(train_ds)}]"
                      f"\tLoss: {float(metrics['loss']):.3f} |"
                      f"\tBpp loss: {float(metrics['bpp_loss']):.2f} |"
                      f"\tAux loss: {float(metrics['aux_loss']):.2f} |")

        if is_stanh and ann_g is not None:
            print(f"stanh beta after epoch {epoch}: {float(ann_g.beta):.4f}")
        val_loss = _validate(module, valid_loader, lambda_list, args.type, device, epoch)
        if kodak is not None:
            _validate(module, kodak, lambda_list, args.type, device, epoch, tag="test")
        set_learning_rate(state.optimizer, scheduler.step(val_loss))
        is_best = val_loss < best_loss
        best_loss = min(val_loss, best_loss)
        if args.save and is_coordinator():
            _save(args, state, scheduler, epoch, val_loss, is_best)
        sec_to_hours(time.time() - start)
        print("END OF EPOCH ", epoch)
    return 0


def is_stanh_name(model_name: str) -> bool:
    return "stanh" in model_name


def _warn_frozen_uniform_levels(args) -> None:
    """The JAX trainer's warning: with several lambdas and every quantizer
    frozen at one shared init, all rate levels compute the same function
    (per-level staircase inits are exempt)."""
    n_lam = len(args.lambda_list)
    uniform_init = (len(set(args.gauss_num_sigmoids[:n_lam])) <= 1
                    and len(set(args.gauss_extrema[:n_lam])) <= 1)
    if (is_stanh_name(args.model) and n_lam > 1 and uniform_init
            and all(t != "yes" for t in args.gauss_trainable)):
        print("WARNING: multi-lambda stanh training with all quantizers frozen "
              "(--gauss_trainable no ...): every level starts from the same frozen STanH, "
              "so the trained model will code identically at every level. Pass "
              "--gauss_trainable " + " ".join(["yes"] * n_lam) + " for a variable-rate model.")


def _save(args, state, scheduler, epoch: int, val_loss: float, is_best: bool) -> None:
    """The epoch's checkpoint (best and very-best when it is the best so
    far), keeping the very-best file and the two newest epoch files."""
    import re

    from ..utils.checkpoint import save_checkpoint
    from ..utils.helper import create_savepath

    check = "pret" if args.checkpoint != "none" else "zero"
    name_folder = (check + args.model + "_" + str(args.N) + "_" + str(args.symmetry) + "_"
                   + str(args.gauss_gp) + "_" + str(args.lambda_list))
    folder = os.path.join(args.save_path, re.sub(r"[\[\]\s,']+", "_", name_folder))
    os.makedirs(folder, exist_ok=True)
    filename, filename_best, very_best = create_savepath(args, epoch, folder)
    if is_best:
        save_checkpoint(filename_best, state, scheduler, epoch, val_loss)
        save_checkpoint(very_best, state, scheduler, epoch, val_loss)
    else:
        save_checkpoint(filename, state, scheduler, epoch, val_loss)
    epochs_on_disk = sorted(
        (e for e in os.listdir(folder) if e.endswith(".ckpt") and e != os.path.basename(very_best)),
        key=lambda e: os.path.getmtime(os.path.join(folder, e)), reverse=True)
    for entry in epochs_on_disk[2:]:
        os.remove(os.path.join(folder, entry))


def _validate(module, loader, lambda_list, loss_type, device, epoch=0, tag="valid") -> float:
    """Mean over the lambdas of the average eval loss, lambda j at rate
    level j; each batch is padded to a multiple of 128, the model's
    windowing contract."""
    from ..ops.math import compute_padding, pad_nhwc
    from ..training.step import eval_step
    from ..utils.helper import AverageMeter

    total = 0.0
    for j, lmbda in enumerate(lambda_list):
        loss_m, bpp_m, psnr_m = AverageMeter(), AverageMeter(), AverageMeter()
        for batch in loader:
            x = torch.from_numpy(np.ascontiguousarray(batch))
            h, w = x.shape[1], x.shape[2]
            if h % 128 or w % 128:
                x = pad_nhwc(x, compute_padding(h, w, 128)[0])
            out = eval_step(module, x.permute(0, 3, 1, 2).contiguous().to(device), lmbda,
                            loss_type, lv=j)
            loss_m.update(float(out["loss"]))
            bpp_m.update(float(out["bpp_loss"]))
            psnr_m.update(float(out["psnr"]))
        print(f"{tag} epoch {epoch} (lv {j}): Average losses:"
              f"\tLoss: {loss_m.avg:.3f} |"
              f"\tBpp loss: {bpp_m.avg:.2f} |"
              f"\tPSNR: {psnr_m.avg:.2f}")
        total += loss_m.avg
    return total / len(lambda_list)


if __name__ == "__main__":
    sys.exit(main())
