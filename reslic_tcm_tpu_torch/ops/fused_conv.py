"""Fused residual-conv kernels B2 and B3 (port of reslic_tcm_tpu/ops/fused_conv.py).

* ``fused_residual_block``: ``leaky(conv3x3(leaky(conv3x3(x) + b1)) + b2) + x``
  with torch padding 1 on each conv and slope 0.01 (the ConvTransBlock
  conv branch). CUDA kernel ``csrc/fused_conv.cu::residual_block_kernel``.
* ``fused_conv_gdn``: ``y = conv3x3(x) + b``; ``y * rsqrt(y^2 . gamma^T + beta)``
  (GDN) or ``y * sqrt(...)`` (IGDN); ``+ skip``. CUDA kernel
  ``csrc/fused_conv.cu::conv_gdn_kernel``.

Both wrappers take NHWC activations and the modules' own parameters in
torch layout (OIHW conv weights; GDN's gamma and beta already derived). On
a CPU tensor they run the plain PyTorch version beside them; on a CUDA
tensor they launch the kernel or raise. Each counts its kernel launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_NEG_SLOPE = 0.01
# channel counts each kernel has an instance for (TCM N=64, 96 and 128 run
# B2 at C = N and B3 at C = 2N)
KERNEL_CHANNELS = {"fused_residual_block": (64, 96, 128),
                   "fused_conv_gdn": (64, 128, 192, 256)}


def plain_residual_block(x, w1, b1, w2, b2):
    """Plain PyTorch version of B2 (NHWC in and out, OIHW weights)."""
    xc = x.permute(0, 3, 1, 2)
    mid = F.leaky_relu(F.conv2d(xc, w1, b1, padding=1), _NEG_SLOPE)
    out = F.leaky_relu(F.conv2d(mid, w2, b2, padding=1), _NEG_SLOPE) + xc
    return out.permute(0, 2, 3, 1).contiguous()


def plain_conv_gdn(x, w, b, gamma, beta, skip, *, inverse: bool):
    """Plain PyTorch version of B3 (NHWC in and out, OIHW weights, derived
    gamma [out, in] and beta)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    norm = F.conv2d(y * y, gamma[:, :, None, None], beta)
    norm = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (y * norm).permute(0, 2, 3, 1) + skip


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_conv")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_residual_block_f32.argtypes = [vp] * 6 + [i] * 4 + [vp]
        lib.fused_residual_block_f32.restype = ctypes.c_int
        lib.fused_conv_gdn_f32.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.fused_conv_gdn_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_channels(kernel: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[-1] not in KERNEL_CHANNELS[kernel]:
        raise ValueError(f"the {kernel} kernel takes NHWC with C in "
                         f"{KERNEL_CHANNELS[kernel]}, got {tuple(x.shape)}")


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.detach().permute(2, 3, 1, 0).contiguous()


def fused_residual_block(x, w1, b1, w2, b2):
    """x: [B, H, W, C] NHWC float32; w1, w2: [C, C, 3, 3]; b1, b2: [C]."""
    if x.device.type == "cpu":
        return plain_residual_block(x, w1, b1, w2, b2)
    _check_channels("fused_residual_block", x)
    bsz, h, w, c = x.shape
    build.check_inference(x, w1, b1, w2, b2)
    build.check_tensor("x", x, (bsz, h, w, c), x.device, contiguous=True)
    build.check_params(x.device, w1=(w1, (c, c, 3, 3)), b1=(b1, (c,)),
                       w2=(w2, (c, c, 3, 3)), b2=(b2, (c,)))
    w1k, w2k = _hwio(w1), _hwio(w2)
    b1k, b2k = b1.detach().contiguous(), b2.detach().contiguous()
    out = torch.empty_like(x)
    rc = _lib().fused_residual_block_f32(
        build.ptr(x), build.ptr(w1k), build.ptr(b1k), build.ptr(w2k), build.ptr(b2k), build.ptr(out),
        bsz, h, w, c, build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_residual_block kernel launch failed: cudaError {rc}")
    fused_residual_block.launches += 1
    return out


fused_residual_block.launches = 0


def fused_conv_gdn(x, w, b, gamma, beta, skip, *, inverse: bool):
    """x, skip: [B, H, W, C] NHWC float32; w: [C, C, 3, 3]; b, beta: [C];
    gamma: [C, C] derived, gamma[k, j] weighs channel j into output k."""
    if x.device.type == "cpu":
        return plain_conv_gdn(x, w, b, gamma, beta, skip, inverse=inverse)
    _check_channels("fused_conv_gdn", x)
    bsz, h, wd, c = x.shape
    build.check_inference(x, w, b, gamma, beta, skip)
    build.check_tensor("x", x, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_tensor("skip", skip, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_params(x.device, w=(w, (c, c, 3, 3)), b=(b, (c,)), gamma=(gamma, (c, c)),
                       beta=(beta, (c,)))
    wk = _hwio(w)
    bk, betak = b.detach().contiguous(), beta.detach().contiguous()
    gt = gamma.detach().t().contiguous()
    out = torch.empty_like(x)
    rc = _lib().fused_conv_gdn_f32(
        build.ptr(x), build.ptr(wk), build.ptr(bk), build.ptr(gt), build.ptr(betak), build.ptr(skip), build.ptr(out),
        bsz, h, wd, c, int(inverse),
        build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_conv_gdn kernel launch failed: cudaError {rc}")
    fused_conv_gdn.launches += 1
    return out


fused_conv_gdn.launches = 0
