"""Train and eval steps (port of reslic_tcm_tpu/training/step.py).

One train step is the JAX step's sequence: the training forward and the
rate-distortion loss, backward, optax's global-norm clip, the main Adam
step; then the aux loss at the updated parameters, its backward (only
``quantiles`` gets a gradient) and the aux Adam step. While autograd
records, every layer runs its composed branch (``ops/layers.py``), so the
kernels are not on this path; ``eval_step`` runs the eval forward under
``torch.no_grad()``, which on the card goes through them.

The noise of step k comes from a ``torch.Generator`` on the batch's device
seeded from (seed, k) (``step_noise``), as the JAX trainer keys step k with
``PRNGKey(k)``: a run resumed from a checkpoint repeats the uninterrupted
one. Both steps run with TF32 off (``fp32_numerics``) whatever the caller's
TF32 flags. ``train_step(..., matmul_precision="bfloat16")`` is the JAX
step's ``make_train_step(matmul_precision=...)`` (the trainer's ``--bf16``):
the forward, the loss, the backward and the aux loss run inside
``ops/layers.py::matmul_precision``, so the composed convolutions and
linears take bf16 operands with fp32 sums and the window attention runs
the JAX package's bf16 body; the parameters, their gradients (through the
casts, onto the fp32 weights) and both Adam states stay fp32. ``eval_step``
(validation) stays fp32, as the JAX trainer's eval step runs outside the
precision. The rate level ``lv`` and the STanH temperature ``beta`` reach
the modules whose forward takes them, as in the JAX step; the STanH
codecs' ``gap_gaussian`` output becomes the ``gap`` metric (0 elsewhere),
which the trainer feeds to the beta annealing.

``shard_train_step(mesh)`` is the same step data-parallel over the mesh's
"data" ranks (and tensor-parallel over its "model" ranks where
``parallel.mesh.shard_params(tp=True)`` sliced the module): each rank
feeds its rows of the global batch and keeps its rows of the global
batch's noise, the gradients are averaged over the data ranks before the
clip (as the JAX step's all-reduce precedes optax's clip), the aux
gradients likewise, and the loss metrics are the global batch's. With the
same seed, a world of n ranks takes the one-process step on the whole
batch. An explicit bucketed ``all_reduce``, not DistributedDataParallel:
the step runs two optimisers and the aux backward outside the forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

import numpy as np
import torch
from torch import nn

from ..models.base import fp32_numerics, uniform_noise
from ..ops.layers import matmul_precision as precision_of
from .loss import rate_distortion_loss
from .optimizer import clip_by_global_norm, configure_optimizers


@dataclasses.dataclass
class TrainState:
    module: nn.Module  # a ChannelARModule or a Balle-2018 module
    optimizer: torch.optim.Optimizer  # main Adam: all but quantiles
    aux_optimizer: torch.optim.Optimizer | None  # aux Adam: quantiles (None: the model has none)
    clip_max_norm: float = 1.0
    step: int = 0


def create_train_state(module: nn.Module, learning_rate: float = 1e-4,
                       aux_learning_rate: float = 1e-3,
                       clip_max_norm: float = 1.0) -> TrainState:
    optimizer, aux_optimizer = configure_optimizers(module, learning_rate, aux_learning_rate)
    return TrainState(module, optimizer, aux_optimizer, clip_max_norm)


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def step_noise(seed: int, step: int, device):
    """The training forward's noise for step ``step``: U(-0.5, 0.5) from a
    generator on ``device`` seeded from (seed, step)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(step_seed(seed, step))
    return uniform_noise(generator)


def _level_kwargs(module: nn.Module, lv, beta) -> dict:
    """lv and beta for a forward that takes them (None: left out)."""
    params = inspect.signature(module.forward).parameters
    return {k: v for k, v in (("lv", lv), ("beta", beta)) if v is not None and k in params}


@contextlib.contextmanager
def _explain_cudnn_refusal(matmul_precision):
    """Re-raise cuDNN's refusal of a bf16 convolution under
    ``cudnn.deterministic`` (what the CLIs pin on the card) with what it
    means; the flag stays as it is."""
    try:
        yield
    except RuntimeError as e:
        if (matmul_precision is None or not torch.backends.cudnn.deterministic
                or "cudnn" not in str(e).lower()):
            raise
        raise RuntimeError(
            "bf16 train step: cuDNN has no deterministic algorithm for one of the step's bf16 "
            "convolutions at this shape (torch.backends.cudnn.deterministic stays on; train in "
            f"fp32, without --bf16): {e}") from e


@fp32_numerics()
def train_step(state: TrainState, batch: torch.Tensor, lmbda: float, noise,
               loss_type: str = "mse", lv: int | None = None, beta: float | None = None,
               sync=None, matmul_precision: str | None = None) -> dict:
    """One step on ``batch`` (NCHW in [0, 1], on the module's device) with
    the ``noise`` callable of the training forward, at rate level ``lv``
    and STanH temperature ``beta`` where the module takes them. Updates the
    state in place; returns the metrics as 0-d tensors: loss, bpp_loss,
    mse_loss (or ms_ssim_loss), gap, grad_norm (the main gradients' global
    norm before the clip) and aux_loss (after the aux step). ``sync``: the
    sharded step's ``parallel.mesh.GradientSync`` (``shard_train_step``),
    None in one process. ``matmul_precision``: None (fp32) or "bfloat16"
    (module docstring)."""
    with precision_of(matmul_precision), _explain_cudnn_refusal(matmul_precision):
        return _train_step(state, batch, lmbda, noise, loss_type, lv, beta, sync)


def _train_step(state, batch, lmbda, noise, loss_type, lv, beta, sync) -> dict:
    module = state.module
    state.optimizer.zero_grad(set_to_none=True)
    out = module(batch, training=True, noise=noise, **_level_kwargs(module, lv, beta))
    losses = rate_distortion_loss(out, batch, lmbda, loss_type)
    losses["loss"].backward()
    params = state.optimizer.param_groups[0]["params"]
    norm = None
    if sync is not None:
        sync.reduce(params)
        norm = sync.norm(params)
    grad_norm = clip_by_global_norm(params, state.clip_max_norm, norm)
    state.optimizer.step()

    if state.aux_optimizer is not None:
        state.aux_optimizer.zero_grad(set_to_none=True)
        module.aux_loss().backward()
        if sync is not None:
            sync.reduce(state.aux_optimizer.param_groups[0]["params"])
        state.aux_optimizer.step()

    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["gap"] = out.get("gap_gaussian", losses["loss"].new_zeros(())).detach()
    if sync is not None:
        metrics = sync.mean(metrics)
    metrics["grad_norm"] = grad_norm
    with torch.no_grad():
        metrics["aux_loss"] = module.aux_loss()
    state.step += 1
    return metrics


def shard_train_step(mesh, matmul_precision: str | None = None):
    """``train_step`` sharded over ``mesh`` (``parallel.mesh.make_mesh``;
    the module placed by ``shard_params``) at ``matmul_precision``: the
    returned step(state, batch, lmbda, noise, loss_type="mse", lv=None,
    beta=None) takes this rank's rows of the global batch
    (``parallel.mesh.shard_batch``) and the global batch's ``noise``
    callable (``step_noise`` at the same seed on every rank), and returns
    the global batch's metrics on every rank."""
    from ..parallel.mesh import GradientSync, rank_noise
    from ..parallel.multihost import rank_and_size

    rank, size = rank_and_size(mesh)

    def step(state: TrainState, batch, lmbda, noise, loss_type="mse", lv=None, beta=None):
        return train_step(state, batch, lmbda, rank_noise(noise, rank, size), loss_type, lv,
                          beta, sync=GradientSync(mesh, state.module),
                          matmul_precision=matmul_precision)
    return step


@torch.no_grad()
@fp32_numerics()
def eval_step(module: nn.Module, batch: torch.Tensor, lmbda: float,
              loss_type: str = "mse", lv: int | None = None) -> dict:
    """The eval forward's losses on ``batch`` (NCHW) at rate level ``lv``
    (where the module takes it) and the PSNR of the clipped x_hat, in fp32
    whatever the caller's matmul precision."""
    with precision_of(None):
        out = module(batch, **_level_kwargs(module, lv, None))
    losses = rate_distortion_loss(out, batch, lmbda, loss_type)
    mse = torch.mean((torch.clamp(out["x_hat"], 0, 1) - batch) ** 2)
    losses["psnr"] = -10.0 * torch.log10(mse)
    return losses
