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
wrapper's calls that launched the float32 instances, one per call (each
such call makes two kernel launches), ``<wrapper>.launches_bf16`` those
that launched the bf16 ones. The kernel's tile is chosen from (H, W, C) by
``tile_config`` (``tile_config_bf16`` for the bf16 instance); ``tile=``
forces one (the bits do not depend on it).

``compute_dtype=torch.bfloat16`` is the TPU kernels' bf16 mode: the
operands of each product are rounded to bf16 where the Pallas bodies cast
them (B2: x, w1, mid, w2; B3: x, w, y*y and gamma) and the sums, the bias,
the activations, GDN's beta, square root and skip stay fp32. On the card it
launches ``csrc/fused_conv_bf16.cu``, the same implicit GEMM on the tensor
cores (a cast kernel writes bf16(x) once; wgmma over a tile's bf16 input
staged once with its border by a tensor copy, W streamed by the copy
engine; B3's conv also writes bf16(y*y) for its GDN launch); the plain
version rounds at the same points and computes in fp32 between them.
``prepare_residual_block`` / ``prepare_conv_gdn`` give the weights in each
instance's layout, which the modules build once per type.
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


def tile_shape_bf16(tile: str, c: int) -> tuple[int, int, int]:
    """(rows, columns, channels) of one block's output tile in the bf16
    instance; mirrors ``ConvTile`` in csrc/fused_conv_bf16.cu. Large: 16x16
    pixels over 64 channels at C=64 and 96 at C=96 and 192, 8x16 pixels over
    128 at C=128 and 256 and 192 at C=384; small: 8x16 pixels over half as
    many channels. On an H100 (PERF.md §6) the 8x16 x 128 tile beat
    16x16 x 64 at every main-path map of C=128 and 256 but 24x16."""
    if tile not in TILES:
        raise ValueError(f"no tile {tile!r}; the kernel has {TILES}")
    square = c == 64 or (c % 96 == 0 and c != 384)
    nb = 192 if c == 384 else 96 if c % 96 == 0 else 64 if c == 64 else 128
    if tile == "large":
        return (16 if square else 8), 16, nb
    return 8, 16, nb // 2


def tile_blocks_bf16(tile: str, h: int, w: int, c: int) -> int:
    """Blocks of the bf16 instance's grid over one H x W x C image."""
    th, tw, nb = tile_shape_bf16(tile, c)
    return -(-h // th) * -(-w // tw) * (c // nb)


# bf16 conv: the large tile from this many blocks of its grid on. On an H100
# (PERF.md §6) the large tile won at 96 blocks (96x64 at C=256 and
# 384, 192x128 at C=64) and lost at 48 (96x64 at C=128 and 192) and below.
LARGE_TILE_BLOCKS = 96


def tile_config_bf16(h: int, w: int, c: int) -> str:
    """The bf16 instance's tile for an H x W x C image: the large one where
    its grid has at least LARGE_TILE_BLOCKS blocks, else the small one."""
    return "large" if tile_blocks_bf16("large", h, w, c) >= LARGE_TILE_BLOCKS else "small"


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def rounder(compute_dtype):
    """The cast of a product's operand in the kernels' ``compute_dtype``
    mode: identity in float32; in bf16 a round to bf16 and back to fp32
    (the plain versions then sum the exact products in fp32)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype}: expected one of {COMPUTE_DTYPES}")
    if compute_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(compute_dtype).to(torch.float32)


def plain_residual_block(x, w1, b1, w2, b2, *, compute_dtype=torch.float32):
    """Plain PyTorch version of B2 (NHWC in and out, OIHW weights)."""
    rd = rounder(compute_dtype)
    xc = x.permute(0, 3, 1, 2)
    mid = F.leaky_relu(F.conv2d(rd(xc), rd(w1), b1, padding=1), _NEG_SLOPE)
    out = F.leaky_relu(F.conv2d(rd(mid), rd(w2), b2, padding=1), _NEG_SLOPE) + xc
    return out.permute(0, 2, 3, 1).contiguous()


def plain_conv_gdn(x, w, b, gamma, beta, skip, *, inverse: bool, compute_dtype=torch.float32):
    """Plain PyTorch version of B3 (NHWC in and out, OIHW weights, derived
    gamma [out, in] and beta)."""
    rd = rounder(compute_dtype)
    y = F.conv2d(rd(x.permute(0, 3, 1, 2)), rd(w), b, padding=1)
    norm = F.conv2d(rd(y * y), rd(gamma)[:, :, None, None], beta)
    norm = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (y * norm).permute(0, 2, 3, 1) + skip


def kgroups(m: torch.Tensor) -> torch.Tensor:
    """A [N][K] matrix (each output's K inputs) as the bf16 instances'
    [K/8][N][8]: k-groups of 8 inputs, each holding every output's 8 values,
    the operand layout their wgmma reads (csrc/hopper_wgmma.cuh)."""
    n, k = m.shape
    return m.reshape(n, k // 8, 8).permute(1, 0, 2).contiguous().to(torch.bfloat16)


def _conv_weight(w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """A 3x3 OIHW weight in the kernel's layout: float32 HWIO [3, 3, Cin,
    Cout] (the fp32 instance's [9C][C] matrix) or bf16 [9C/8, Cout, 8]
    (``kgroups`` of the [Cout][9C] matrix, k = tap * C + input channel,
    taps in row-major order)."""
    w = w.detach()
    if compute_dtype == torch.float32:
        return w.permute(2, 3, 1, 0).contiguous()
    return kgroups(w.permute(0, 2, 3, 1).reshape(w.shape[0], -1))


def prepare_residual_block(w1, w2, *, compute_dtype=torch.float32) -> tuple:
    """B2's weights in the ``compute_dtype`` instance's layout, for
    ``fused_residual_block(prepared=...)``."""
    rounder(compute_dtype)  # raises for a type without instances
    return _conv_weight(w1, compute_dtype), _conv_weight(w2, compute_dtype)


def prepare_conv_gdn(w, gamma, *, compute_dtype=torch.float32) -> tuple:
    """B3's weights (conv weight, derived gamma) in the ``compute_dtype``
    instance's layout, for ``fused_conv_gdn(prepared=...)``: gamma^T
    [in][out] in float32, ``kgroups`` of gamma [out][in] in bf16."""
    rounder(compute_dtype)  # raises for a type without instances
    gamma = gamma.detach()
    gk = gamma.t().contiguous() if compute_dtype == torch.float32 else kgroups(gamma)
    return _conv_weight(w, compute_dtype), gk


def _lib(compute_dtype) -> tuple:
    """(B2's entry, B3's entry) of the compute_dtype instances' library."""
    bf16 = compute_dtype == torch.bfloat16
    lib = build.load("fused_conv_bf16" if bf16 else "fused_conv")
    suffix = "bf16" if bf16 else "f32"
    b2, b3 = (getattr(lib, f"fused_residual_block_{suffix}"),
              getattr(lib, f"fused_conv_gdn_{suffix}"))
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        # the bf16 instance takes scratch for bf16(x) (and B3's bf16(y*y)) too
        b2.argtypes = [vp] * (8 if bf16 else 7) + [i] * 5 + [vp]
        b2.restype = ctypes.c_int
        b3.argtypes = [vp] * (10 if bf16 else 8) + [i] * 6 + [vp]
        b3.restype = ctypes.c_int
        lib._argtypes_set = True
    return b2, b3


def _check_channels(kernel: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[-1] not in KERNEL_CHANNELS[kernel]:
        raise ValueError(f"the {kernel} kernel takes NHWC with C in "
                         f"{KERNEL_CHANNELS[kernel]}, got {tuple(x.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"the {kernel} kernel indexes with 32-bit ints, got {tuple(x.shape)}")


def _tile_index(tile, h: int, w: int, c: int, compute_dtype) -> int:
    if tile is None:
        tile = (tile_config if compute_dtype == torch.float32 else tile_config_bf16)(h, w, c)
    tile_shape(tile, c)  # raises for an unknown tile
    return TILES.index(tile)


def _check_aligned(**tensors) -> None:
    """The kernel reads and writes these as float4."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")


def _check_prepared(prepared, want: tuple, compute_dtype, device) -> None:
    """``prepared`` must be this instance's weights: the shapes of
    ``prepare_*`` for this C, in ``compute_dtype``, on ``device``."""
    if (len(prepared) != len(want) or any(
            p.dtype != compute_dtype or p.device != device or tuple(p.shape) != s
            or not p.is_contiguous() for p, s in zip(prepared, want))):
        raise ValueError(f"prepared: expected contiguous {compute_dtype} weights of shapes "
                         f"{want} on {device}, got "
                         f"{[(p.dtype, tuple(p.shape), str(p.device)) for p in prepared]}")


def _weight_shape(c: int, compute_dtype, taps: int = 9) -> tuple:
    if compute_dtype == torch.float32:
        return (3, 3, c, c) if taps == 9 else (c, c)
    return (taps * c // 8, c, 8)


def _launched(wrapper, compute_dtype) -> None:
    if compute_dtype == torch.float32:
        wrapper.launches += 1
    else:
        wrapper.launches_bf16 += 1


def fused_residual_block(x, w1, b1, w2, b2, *, tile=None, compute_dtype=torch.float32,
                         prepared=None):
    """x: [B, H, W, C] NHWC float32; w1, w2: [C, C, 3, 3]; b1, b2: [C].
    tile: None (chosen from the shape: ``tile_config``, or
    ``tile_config_bf16`` in bf16) or one of ``TILES``. compute_dtype:
    torch.float32 or torch.bfloat16 (the operands of the products; the
    output is float32 either way). prepared: ``prepare_residual_block`` of
    w1 and w2 at this compute_dtype (built here when None)."""
    if x.device.type == "cpu":
        return plain_residual_block(x, w1, b1, w2, b2, compute_dtype=compute_dtype)
    rounder(compute_dtype)  # raises for a type without instances
    _check_channels("fused_residual_block", x)
    bsz, h, w, c = x.shape
    build.check_inference(x, w1, b1, w2, b2)
    build.check_tensor("x", x, (bsz, h, w, c), x.device, contiguous=True)
    build.check_params(x.device, w1=(w1, (c, c, 3, 3)), b1=(b1, (c,)),
                       w2=(w2, (c, c, 3, 3)), b2=(b2, (c,)))
    t = _tile_index(tile, h, w, c, compute_dtype)
    if prepared is None:
        prepared = prepare_residual_block(w1, w2, compute_dtype=compute_dtype)
    _check_prepared(prepared, (_weight_shape(c, compute_dtype),) * 2, compute_dtype, x.device)
    w1k, w2k = prepared
    b1k, b2k = b1.detach().contiguous(), b2.detach().contiguous()
    _check_aligned(x=x, b1=b1k, b2=b2k)
    # the bf16 instance keeps conv1's output in bf16, where the TPU kernel rounds
    # it, and reads x as bf16(x), written once by a cast kernel
    mid, out = torch.empty_like(x, dtype=compute_dtype), torch.empty_like(x)
    xb = torch.empty_like(mid) if compute_dtype == torch.bfloat16 else None
    rc = _lib(compute_dtype)[0](
        build.ptr(x), build.ptr(w1k), build.ptr(b1k), build.ptr(w2k), build.ptr(b2k),
        *(() if xb is None else (build.ptr(xb),)), build.ptr(mid), build.ptr(out), bsz, h, w,
        c, t, build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_residual_block kernel launch failed: cudaError {rc}")
    _launched(fused_residual_block, compute_dtype)
    return out


fused_residual_block.launches = 0
fused_residual_block.launches_bf16 = 0


def fused_conv_gdn(x, w, b, gamma, beta, skip, *, inverse: bool, tile=None,
                   compute_dtype=torch.float32, prepared=None):
    """x, skip: [B, H, W, C] NHWC float32; w: [C, C, 3, 3]; b, beta: [C];
    gamma: [C, C] derived, gamma[k, j] weighs channel j into output k.
    tile: None (chosen from the shape: ``tile_config``, or
    ``tile_config_bf16`` in bf16) or one of ``TILES``. compute_dtype:
    torch.float32 or torch.bfloat16. prepared: ``prepare_conv_gdn`` of w and
    gamma at this compute_dtype (built here when None)."""
    if x.device.type == "cpu":
        return plain_conv_gdn(x, w, b, gamma, beta, skip, inverse=inverse,
                              compute_dtype=compute_dtype)
    rounder(compute_dtype)  # raises for a type without instances
    _check_channels("fused_conv_gdn", x)
    bsz, h, wd, c = x.shape
    build.check_inference(x, w, b, gamma, beta, skip)
    build.check_tensor("x", x, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_tensor("skip", skip, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_params(x.device, w=(w, (c, c, 3, 3)), b=(b, (c,)), gamma=(gamma, (c, c)),
                       beta=(beta, (c,)))
    t = _tile_index(tile, h, wd, c, compute_dtype)
    if prepared is None:
        prepared = prepare_conv_gdn(w, gamma, compute_dtype=compute_dtype)
    _check_prepared(prepared, (_weight_shape(c, compute_dtype),
                               _weight_shape(c, compute_dtype, taps=1)), compute_dtype, x.device)
    wk, gk = prepared
    bk, betak = b.detach().contiguous(), beta.detach().contiguous()
    _check_aligned(b=bk, beta=betak, skip=skip)
    if compute_dtype == torch.bfloat16:  # its conv reads x in 16-byte vectors
        _check_aligned(x=x)
    y, out = torch.empty_like(x), torch.empty_like(x)
    if compute_dtype == torch.bfloat16:  # scratch: bf16(x), and y's bf16(y*y) for the GDN launch
        xb, y2 = (torch.empty_like(x, dtype=compute_dtype) for _ in range(2))
        ptrs = (build.ptr(xb), build.ptr(y), build.ptr(y2))
    else:
        ptrs = (build.ptr(y),)
    rc = _lib(compute_dtype)[1](
        build.ptr(x), build.ptr(wk), build.ptr(bk), build.ptr(gk), build.ptr(betak),
        build.ptr(skip), *ptrs, build.ptr(out), bsz, h, wd, c, int(inverse), t,
        build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"fused_conv_gdn kernel launch failed: cudaError {rc}")
    _launched(fused_conv_gdn, compute_dtype)
    return out


fused_conv_gdn.launches = 0
fused_conv_gdn.launches_bf16 = 0
