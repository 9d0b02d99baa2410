"""Rate-distortion loss (port of reslic_tcm_tpu/training/loss.py)."""

from __future__ import annotations

import math

import torch

from ..utils.metrics import ms_ssim


def rate_distortion_loss(output: dict, target: torch.Tensor, lmbda: float,
                         loss_type: str = "mse") -> dict:
    """loss = lambda * 255^2 * MSE + bpp, or lambda * (1 - MS-SSIM) + bpp
    (``loss_type="ms-ssim"``). ``target`` and ``output["x_hat"]`` are NCHW
    in [0, 1]; ``output["likelihoods"]`` holds the forward's likelihoods."""
    n, _, h, w = target.shape
    num_pixels = n * h * w
    out = {"bpp_loss": sum(torch.sum(torch.log(lik)) / (-math.log(2) * num_pixels)
                           for lik in output["likelihoods"].values())}
    if loss_type == "mse":
        out["mse_loss"] = torch.mean((output["x_hat"] - target) ** 2)
        out["loss"] = lmbda * 255 ** 2 * out["mse_loss"] + out["bpp_loss"]
    else:
        out["ms_ssim_loss"] = ms_ssim(output["x_hat"].permute(0, 2, 3, 1),
                                      target.permute(0, 2, 3, 1))
        out["loss"] = lmbda * (1 - out["ms_ssim_loss"]) + out["bpp_loss"]
    return out
