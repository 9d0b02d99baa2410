"""Fused residual-conv kernels B2 and B3 (port of reslic_tcm_tpu/ops/fused_conv.py).

* ``fused_residual_block``: ``leaky(conv3x3(leaky(conv3x3(x) + b1)) + b2) + x``
  with torch padding 1 on each conv and slope 0.01 (the ConvTransBlock
  conv branch): two launches of ``csrc/fused_conv.cu::conv_gemm_kernel``,
  conv1 into a scratch ``mid``, then conv2 with the residual.
* ``fused_conv_gdn``: ``y = conv3x3(x) + b``; ``y * rsqrt(y^2 . gamma^T + beta)``
  (GDN) or ``y * sqrt(...)`` (IGDN); ``+ skip``: the conv launch into a
  scratch ``y``, then the 1x1 GDN launch of the same kernel.

Both wrappers take NHWC activations and the modules' own parameters in
torch layout (OIHW conv weights; GDN's gamma and beta already derived). On
a CPU tensor they run the plain PyTorch version beside them; on a CUDA
tensor they launch the kernels or raise. ``<wrapper>.launches`` counts the
wrapper's calls that launched, one per call (each such call makes two
kernel launches). The kernel's tile is chosen from (H, W, C) by
``tile_config``; ``tile=`` forces one (the bits do not depend on it).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

_NEG_SLOPE = 0.01
# channel counts each kernel has an instance for (TCM N=64, 96, 128 and 192
# run B2 at C = N and B3 at C = 2N)
KERNEL_CHANNELS = {"fused_residual_block": (64, 96, 128, 192),
                   "fused_conv_gdn": (64, 128, 192, 256, 384)}
# the kernel's tile instances, in the order of the C entries' `tile` argument
TILES = ("large", "small")
SMS = 132  # streaming multiprocessors of an H100 SXM


def tile_shape(tile: str, c: int) -> tuple[int, int]:
    """(pixels, channels) of one block's output tile; mirrors
    ``LargeTile``/``SmallTile`` in csrc/fused_conv.cu."""
    if tile == "large":
        return 128, next(bn for bn in (128, 64, 32) if c % bn == 0)
    if tile == "small":
        return 32, 32
    raise ValueError(f"no tile {tile!r}; the kernel has {TILES}")


def tile_config(h: int, w: int, c: int) -> str:
    """The tile for an H x W x C image: the large one where it gives at
    least one block per SM, else the small one (so that 24x16 and 96x64
    images still fill the card)."""
    bm, bn = tile_shape("large", c)
    return "large" if -(-h * w // bm) * (c // bn) >= SMS else "small"


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
        lib.fused_residual_block_f32.argtypes = [vp] * 7 + [i] * 5 + [vp]
        lib.fused_residual_block_f32.restype = ctypes.c_int
        lib.fused_conv_gdn_f32.argtypes = [vp] * 8 + [i] * 6 + [vp]
        lib.fused_conv_gdn_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_channels(kernel: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[-1] not in KERNEL_CHANNELS[kernel]:
        raise ValueError(f"the {kernel} kernel takes NHWC with C in "
                         f"{KERNEL_CHANNELS[kernel]}, got {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the {kernel} kernel indexes with 32-bit ints, got {tuple(x.shape)}")


def _tile_index(tile, h: int, w: int, c: int) -> int:
    tile = tile_config(h, w, c) if tile is None else tile
    tile_shape(tile, c)  # raises for an unknown tile
    return TILES.index(tile)


def _check_aligned(**tensors) -> None:
    """The kernel reads and writes these as float4."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.detach().permute(2, 3, 1, 0).contiguous()


def fused_residual_block(x, w1, b1, w2, b2, *, tile=None):
    """x: [B, H, W, C] NHWC float32; w1, w2: [C, C, 3, 3]; b1, b2: [C].
    tile: None (chosen from the shape) or one of ``TILES``."""
    if x.device.type == "cpu":
        return plain_residual_block(x, w1, b1, w2, b2)
    _check_channels("fused_residual_block", x)
    bsz, h, w, c = x.shape
    build.check_inference(x, w1, b1, w2, b2)
    build.check_tensor("x", x, (bsz, h, w, c), x.device, contiguous=True)
    build.check_params(x.device, w1=(w1, (c, c, 3, 3)), b1=(b1, (c,)),
                       w2=(w2, (c, c, 3, 3)), b2=(b2, (c,)))
    t = _tile_index(tile, h, w, c)
    w1k, w2k = _hwio(w1), _hwio(w2)
    b1k, b2k = b1.detach().contiguous(), b2.detach().contiguous()
    _check_aligned(x=x, b1=b1k, b2=b2k)
    mid, out = torch.empty_like(x), torch.empty_like(x)
    rc = _lib().fused_residual_block_f32(
        build.ptr(x), build.ptr(w1k), build.ptr(b1k), build.ptr(w2k), build.ptr(b2k),
        build.ptr(mid), build.ptr(out), bsz, h, w, c, t, build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_residual_block kernel launch failed: cudaError {rc}")
    fused_residual_block.launches += 1
    return out


fused_residual_block.launches = 0


def fused_conv_gdn(x, w, b, gamma, beta, skip, *, inverse: bool, tile=None):
    """x, skip: [B, H, W, C] NHWC float32; w: [C, C, 3, 3]; b, beta: [C];
    gamma: [C, C] derived, gamma[k, j] weighs channel j into output k.
    tile: None (chosen from the shape) or one of ``TILES``."""
    if x.device.type == "cpu":
        return plain_conv_gdn(x, w, b, gamma, beta, skip, inverse=inverse)
    _check_channels("fused_conv_gdn", x)
    bsz, h, wd, c = x.shape
    build.check_inference(x, w, b, gamma, beta, skip)
    build.check_tensor("x", x, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_tensor("skip", skip, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_params(x.device, w=(w, (c, c, 3, 3)), b=(b, (c,)), gamma=(gamma, (c, c)),
                       beta=(beta, (c,)))
    t = _tile_index(tile, h, wd, c)
    wk = _hwio(w)
    bk, betak = b.detach().contiguous(), beta.detach().contiguous()
    gt = gamma.detach().t().contiguous()
    _check_aligned(b=bk, beta=betak, skip=skip)
    y, out = torch.empty_like(x), torch.empty_like(x)
    rc = _lib().fused_conv_gdn_f32(
        build.ptr(x), build.ptr(wk), build.ptr(bk), build.ptr(gt), build.ptr(betak),
        build.ptr(skip), build.ptr(y), build.ptr(out), bsz, h, wd, c, int(inverse), t,
        build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_conv_gdn kernel launch failed: cudaError {rc}")
    fused_conv_gdn.launches += 1
    return out


fused_conv_gdn.launches = 0
