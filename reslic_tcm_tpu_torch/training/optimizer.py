"""Main and aux optimisers (port of reslic_tcm_tpu/training/optimizer.py).

The main Adam trains every parameter except the entropy bottleneck's
``quantiles``; the aux Adam trains only those, driven by the aux loss.
The main step first clips the gradients by their global norm with optax's
rule (``clip_by_global_norm``), as the JAX package's optax chain does.
``freeze_all_but_stanh`` (the trainer's ``--freeze``) leaves only the
STanH staircases and the synthesis transforms to the main Adam.
"""

from __future__ import annotations

import torch
from torch import nn


def _is_quantiles(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


def freeze_all_but_stanh(module: nn.Module) -> list[str]:
    """The reference's unlock_only_stanh fine-tuning (reference
    balle18_stanh.py:65-86, the JAX package's
    ``freeze_all_but_stanh_labels(params, g_s_tune=True)``): every
    parameter stops wanting a gradient except the STanH ``w``/``b``, the
    synthesis transforms (``g_s`` and its per-level clones ``g_s_{i}``)
    and the ``quantiles`` (the aux Adam's). Returns the frozen names."""
    frozen = []
    for name, p in module.named_parameters():
        parts = name.split(".")
        if "stanh" in parts[:-1] or parts[0].startswith("g_s") or _is_quantiles(name):
            continue
        p.requires_grad_(False)
        frozen.append(name)
    return frozen


def configure_optimizers(module: nn.Module, learning_rate: float = 1e-4,
                         aux_learning_rate: float = 1e-3):
    """(main Adam over every parameter that wants a gradient but the
    ``quantiles``, aux Adam over the ``quantiles`` or None when the module
    has none), with optax's Adam defaults (betas 0.9, 0.999, eps 1e-8); the
    clipping is ``clip_by_global_norm`` over the main Adam's parameters,
    applied by the train step between the backward pass and the main step."""
    main, aux = [], []
    for name, p in module.named_parameters():
        if _is_quantiles(name):
            aux.append(p)
        elif p.requires_grad:
            main.append(p)
    adam = lambda params, lr: torch.optim.Adam(  # noqa: E731
        params, lr=float(lr), betas=(0.9, 0.999), eps=1e-8)
    return adam(main, learning_rate), (adam(aux, aux_learning_rate) if aux else None)


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float | None, norm=None) -> torch.Tensor:
    """optax's clip_by_global_norm on the ``.grad`` of ``params``: the
    gradients stay as they are when their global norm is below
    ``max_norm`` and become g / norm * max_norm otherwise (no clipping when
    ``max_norm`` is 0 or None). Unlike ``clip_grad_norm_`` it adds no 1e-6
    to the norm. A parameter without a gradient gets zeros (optax counts it
    as a zero gradient). A few foreach launches in all, however many
    tensors. ``norm``: the global norm where the caller has it (the sharded
    step's, over every rank's slices), else computed here. Returns the norm
    before clipping."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if norm is None:
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
