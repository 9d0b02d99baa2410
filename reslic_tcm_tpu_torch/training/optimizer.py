"""Main and aux optimisers (port of reslic_tcm_tpu/training/optimizer.py).

The main Adam trains every parameter except the entropy bottleneck's
``quantiles``; the aux Adam trains only those, driven by the aux loss.
The main step first clips the gradients by their global norm with optax's
rule (``clip_by_global_norm``), as the JAX package's optax chain does.
"""

from __future__ import annotations

import torch
from torch import nn


def configure_optimizers(module: nn.Module, learning_rate: float = 1e-4,
                         aux_learning_rate: float = 1e-3):
    """(main Adam over every parameter but the ``quantiles``, aux Adam over
    the ``quantiles``), with optax's Adam defaults (betas 0.9, 0.999, eps
    1e-8); the clipping is ``clip_by_global_norm``, applied by the train
    step between the backward pass and the main step."""
    main, aux = [], []
    for name, p in module.named_parameters():
        (aux if name.split(".")[-1] == "quantiles" else main).append(p)
    return (torch.optim.Adam(main, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8),
            torch.optim.Adam(aux, lr=float(aux_learning_rate), betas=(0.9, 0.999), eps=1e-8))


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float | None) -> torch.Tensor:
    """optax's clip_by_global_norm on the ``.grad`` of ``params``: the
    gradients stay as they are when their global norm is below
    ``max_norm`` and become g / norm * max_norm otherwise (no clipping when
    ``max_norm`` is 0 or None). Unlike ``clip_grad_norm_`` it adds no 1e-6
    to the norm. A parameter without a gradient gets zeros (optax counts it
    as a zero gradient). A few foreach launches in all, however many
    tensors. Returns the norm before clipping."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm:
        # g / 1 * 1 is g: one pair of launches either way, and no host sync
        one = torch.ones_like(norm)
        keep = norm < max_norm
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, max_norm))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
