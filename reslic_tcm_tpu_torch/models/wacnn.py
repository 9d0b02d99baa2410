"""WACNN, the window-attention CNN codec (port of reslic_tcm_tpu/models/wacnn.py),
eval path.

  g_a: [conv5x5 s2, GDN] x2 -> Win_noShift_Attention(N, w8, shift 4)
       -> conv5x5 s2, GDN -> conv5x5 s2 (-> M) -> Win_noShift_Attention(M, w4, shift 2)
  g_s: the mirror with 5x5 stride-2 transposed convs and IGDN
  h_a / h_mean_s / h_scale_s: plain conv/GELU transforms (subpel upsampling)
  entropy: factorized z (N channels) and a 10-slice channel-AR Gaussian with
  5-layer parameter transforms and latent residual prediction, no SWAtten.

The window-8 attention at N runs through kernel B1's attention-only flavour,
the window-4 attention at M through kernel B4 (``ops/window_attention.py``).
Modules are NCHW and carry the reference PyTorch state-dict names.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..entropy.factorized import EntropyBottleneck
from ..entropy.stanh_models import StanhEntropyBottleneck
from ..ops.layers import GDN, Deconv, StackedConv1x1, conv, subpel_conv3x3
from ..ops.window_attention import Win_noShift_Attention, WindowAttention
from .base import ChannelARCodec, ChannelARModule


def _cc5(in_ch: int, dims: Sequence[int], out_ch: int) -> nn.Sequential:
    """5-layer conv3x3/GELU parameter transform."""
    layers = []
    for d in dims:
        layers += [conv(in_ch, d, 3), nn.GELU()]
        in_ch = d
    return nn.Sequential(*layers, conv(in_ch, out_ch, 3))


def _g_s(N: int, M: int) -> nn.Sequential:
    return nn.Sequential(
        Win_noShift_Attention(M, 8, 4, 2),
        Deconv(M, N, 5, 2), GDN(N, inverse=True),
        Deconv(N, N, 5, 2), GDN(N, inverse=True),
        Win_noShift_Attention(N, 8, 8, 4),
        Deconv(N, N, 5, 2), GDN(N, inverse=True),
        Deconv(N, 3, 5, 2),
    )


class WACNN(ChannelARModule):
    """The WACNN codec module (NCHW)."""

    def __init__(self, N: int = 192, M: int = 320, num_slices: int = 10,
                 max_support_slices: int = 5, hyper_dims: Sequence[int] = (320, 288, 256),
                 mean_dims: Sequence[int] = (192, 224, 256, 288),
                 cc_dims: Sequence[int] = (224, 176, 128, 64)):
        super().__init__()
        self.N, self.M = N, M
        self.num_slices, self.max_support_slices = num_slices, max_support_slices
        hd0, hd1, hd2 = hyper_dims
        m0, m1, m2, m3 = mean_dims

        self.g_a = nn.Sequential(
            conv(3, N, 5, 2), GDN(N),
            conv(N, N, 5, 2), GDN(N),
            Win_noShift_Attention(N, 8, 8, 4),
            conv(N, N, 5, 2), GDN(N),
            conv(N, M, 5, 2),
            Win_noShift_Attention(M, 8, 4, 2),
        )
        self.g_s = _g_s(N, M)
        self.h_a = nn.Sequential(
            conv(M, hd0, 3), nn.GELU(),
            conv(hd0, hd1, 3), nn.GELU(),
            conv(hd1, hd2, 3, 2), nn.GELU(),
            conv(hd2, m1, 3), nn.GELU(),
            conv(m1, N, 3, 2),
        )

        def hyper_s():
            return nn.Sequential(
                conv(N, m0, 3), nn.GELU(),
                subpel_conv3x3(m0, m1, 2), nn.GELU(),
                conv(m1, m2, 3), nn.GELU(),
                subpel_conv3x3(m2, m3, 2), nn.GELU(),
                conv(m3, M, 3),
            )

        self.h_mean_s = hyper_s()
        self.h_scale_s = hyper_s()
        slice_ch = M // num_slices
        support = [M + slice_ch * min(i, max_support_slices) for i in range(num_slices)]
        self.cc_mean_transforms = nn.ModuleList(_cc5(c, cc_dims, slice_ch) for c in support)
        self.cc_scale_transforms = nn.ModuleList(_cc5(c, cc_dims, slice_ch) for c in support)
        self.lrp_transforms = nn.ModuleList(
            _cc5(c + slice_ch, cc_dims, slice_ch) for c in support)
        self.entropy_bottleneck = EntropyBottleneck(N)


@torch.no_grad()
def draw_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Redraw every randomly initialised parameter from ``gen``, in module
    order, with torch's default distributions: convolution and linear
    weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (fan_in over the
    weight's dims 1..), relative-position tables N(0, 0.02) clipped at two
    standard deviations, entropy-bottleneck biases U(-0.5, 0.5). GDN and the
    rest of the entropy bottleneck keep their fixed initial values. Each
    level of a StackedConv1x1 is drawn as its own 1x1 convolution (fan_in
    = cin); the STanH entropy bottleneck's biases as the plain one's, its
    staircase and the STanH conditionals keep their fixed initial values."""

    def uniform_(p, bound):
        p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform_(m.weight, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, StackedConv1x1):
            bound = 1.0 / math.sqrt(m.weight.shape[1])
            uniform_(m.weight, bound)
            uniform_(m.bias, bound)
        elif isinstance(m, WindowAttention):
            t = m.relative_position_bias_table
            t.copy_(torch.randn(t.shape, generator=gen).clamp_(-2, 2) * 0.02)
        elif isinstance(m, (EntropyBottleneck, StanhEntropyBottleneck)):
            for name, p in m.named_parameters():
                if name.startswith("_bias"):
                    uniform_(p, 0.5)


def make_wacnn(N: int = 192, M: int = 320, device="cuda", seed: int = 0,
               **ladders) -> ChannelARCodec:
    """Build a WACNN codec on ``device`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (load trained weights with
    ``utils.torch_convert``). ``ladders``: hyper_dims, mean_dims, cc_dims,
    num_slices, max_support_slices."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    with torch.random.fork_rng(devices=[]):  # leave the caller's global RNG as it was
        module = WACNN(N=N, M=M, **ladders)
    draw_weights(module, torch.Generator().manual_seed(seed))
    return ChannelARCodec(module, device)
