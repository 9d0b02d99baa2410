"""LIC-TCM (port of reslic_tcm_tpu/models/tcm.py).

  g_a: RBWS(3->2N) -> [ConvTransBlock x2, RBWS] x2 -> ConvTransBlock x2 -> conv3x3(->M, s2)
  g_s: the mirror with ResidualBlockUpsample and a subpel output
  h_a / h_mean_s / h_scale_s: window-4 ConvTransBlock hyper transforms
  entropy: factorized z and a channel-AR Gaussian over num_slices slices with
  SWAtten support attention and latent residual prediction.

Modules are NCHW and carry the reference PyTorch state-dict names, so the
bridge in ``utils/torch_convert.py`` fills them from the JAX package's
parameters and a released ``.pth.tar`` loads with ``load_state_dict``.

Training: with ``remat`` each ConvTransBlock runs under
``torch.utils.checkpoint`` while autograd records (its activations are
recomputed in the backward pass, at the forward's matmul precision), the
JAX module's ``nn.remat``.
Drop-path is the identity (``ops/layers.py::DropPath``), as in the JAX
module, whose Sequentials leave ``deterministic`` at its default.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..entropy.factorized import EntropyBottleneck
from ..ops.layers import (ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride,
                          ResidualUnit, conv, conv1x1, matmul_precision, matmul_precision_in_use,
                          records_grad, subpel_conv3x3, to_nchw, to_nhwc)
from ..ops.window_attention import SwinBlock, SwinTransformerBlock
from .base import ChannelARCodec, ChannelARModule


class ConvTransBlock(nn.Module):
    """Parallel conv / Swin mixture block: 1x1 split into a conv branch
    (ResidualBlock plus an extra skip) and a Swin branch, 1x1 merge,
    residual add."""

    def __init__(self, conv_dim: int, trans_dim: int, head_dim: int, window_size: int,
                 type: str = "W", drop_path: float = 0.0, remat: bool = False):
        super().__init__()
        both = conv_dim + trans_dim
        self.conv_dim = conv_dim
        self.remat = remat
        self.conv1_1 = conv1x1(both, both)
        self.conv1_2 = conv1x1(both, both)
        self.conv_block = ResidualBlock(conv_dim)
        self.trans_block = SwinTransformerBlock(trans_dim, head_dim, window_size, type,
                                                drop_path)

    def forward(self, x):
        if self.remat and records_grad(self):
            # the recompute runs in the backward, on the card in autograd's own
            # thread, which does not see this thread's matmul precision
            return checkpoint(self._forward_at, x, matmul_precision_in_use(),
                              use_reentrant=False)
        return self._forward(x)

    def _forward_at(self, x, precision):
        with matmul_precision(precision):
            return self._forward(x)

    def _forward(self, x):
        h = self.conv1_1(x)
        conv_x, trans_x = h[:, : self.conv_dim], h[:, self.conv_dim :]
        conv_x = self.conv_block(conv_x) + conv_x
        trans_x = to_nchw(self.trans_block(to_nhwc(trans_x)))
        return x + self.conv1_2(torch.cat([conv_x, trans_x], dim=1))


class SWAtten(nn.Module):
    """Swin-augmented attention gate over the slice supports: 1x1 in,
    a * sigmoid(b(swin(x))) + identity, 1x1 out (ReLU residual units)."""

    def __init__(self, input_dim: int, output_dim: int, head_dim: int = 16,
                 window_size: int = 8, inter_dim: int = 128):
        super().__init__()
        n = inter_dim
        self.in_conv = conv1x1(input_dim, n)
        self.non_local_block = SwinBlock(n, head_dim, window_size)
        self.conv_a = nn.Sequential(ResidualUnit(n), ResidualUnit(n), ResidualUnit(n))
        self.conv_b = nn.Sequential(ResidualUnit(n), ResidualUnit(n), ResidualUnit(n),
                                    conv1x1(n, n))
        self.out_conv = conv1x1(n, output_dim)

    def forward(self, x):
        x = self.in_conv(x)
        z = to_nchw(self.non_local_block(to_nhwc(x)))
        out = self.conv_a(x) * torch.sigmoid(self.conv_b(z)) + x
        return self.out_conv(out)


def _cc_transform(in_ch: int, out_ch: int) -> nn.Sequential:
    """3-layer conv/GELU parameter transform."""
    return nn.Sequential(conv(in_ch, 224, 3), nn.GELU(), conv(224, 128, 3), nn.GELU(),
                         conv(128, out_ch, 3))


class TCM(ChannelARModule):
    """The TCM codec module (NCHW)."""

    def __init__(self, config: Sequence[int] = (2, 2, 2, 2, 2, 2),
                 head_dim: Sequence[int] = (8, 16, 32, 32, 16, 8), N: int = 128, M: int = 320,
                 num_slices: int = 5, max_support_slices: int = 5, hyper_ch: int = 192,
                 atten_inter_dim: int = 128, drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.N, self.M, self.hyper_ch = N, M, hyper_ch
        self.num_slices, self.max_support_slices = num_slices, max_support_slices
        window = 8
        # the JAX module's schedule: each stage's i-th block takes dpr[i]
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(config))]

        def ctb_stage(stage: int):
            return [ConvTransBlock(N, N, head_dim[stage], window, "W" if i % 2 == 0 else "SW",
                                   dpr[i], remat)
                    for i in range(config[stage])]

        def hyper_ctbs():
            return [ConvTransBlock(N, N, 32, 4, "W" if i % 2 == 0 else "SW", 0.0, remat)
                    for i in range(config[0])]

        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, 2 * N, 2), *ctb_stage(0),
            ResidualBlockWithStride(2 * N, 2 * N, 2), *ctb_stage(1),
            ResidualBlockWithStride(2 * N, 2 * N, 2), *ctb_stage(2),
            conv(2 * N, M, 3, stride=2),
        )
        self.g_s = nn.Sequential(
            ResidualBlockUpsample(M, 2 * N, 2), *ctb_stage(3),
            ResidualBlockUpsample(2 * N, 2 * N, 2), *ctb_stage(4),
            ResidualBlockUpsample(2 * N, 2 * N, 2), *ctb_stage(5),
            subpel_conv3x3(2 * N, 3, 2),
        )
        self.h_a = nn.Sequential(
            ResidualBlockWithStride(M, 2 * N, 2), *hyper_ctbs(), conv(2 * N, hyper_ch, 3, stride=2),
        )
        self.h_mean_s = nn.Sequential(
            ResidualBlockUpsample(hyper_ch, 2 * N, 2), *hyper_ctbs(), subpel_conv3x3(2 * N, M, 2),
        )
        self.h_scale_s = nn.Sequential(
            ResidualBlockUpsample(hyper_ch, 2 * N, 2), *hyper_ctbs(), subpel_conv3x3(2 * N, M, 2),
        )
        slice_ch = M // num_slices
        support = [M + slice_ch * min(i, 5) for i in range(num_slices)]
        self.atten_mean = nn.ModuleList(
            nn.Sequential(SWAtten(c, c, 16, window, atten_inter_dim)) for c in support)
        self.atten_scale = nn.ModuleList(
            nn.Sequential(SWAtten(c, c, 16, window, atten_inter_dim)) for c in support)
        self.cc_mean_transforms = nn.ModuleList(_cc_transform(c, slice_ch) for c in support)
        self.cc_scale_transforms = nn.ModuleList(_cc_transform(c, slice_ch) for c in support)
        self.lrp_transforms = nn.ModuleList(
            _cc_transform(c + slice_ch, slice_ch) for c in support)
        self.entropy_bottleneck = EntropyBottleneck(hyper_ch)


def make_tcm(N: int = 128, M: int = 320, config=(2, 2, 2, 2, 2, 2),
             head_dim=(8, 16, 32, 32, 16, 8), num_slices: int = 5, hyper_ch: int = 192,
             atten_inter_dim: int = 128, device="cuda", seed: int = 0,
             drop_path_rate: float = 0.0, remat: bool = False) -> ChannelARCodec:
    """Build a TCM codec on ``device`` with random weights drawn from
    ``seed`` (load trained weights with ``utils.torch_convert``); ``remat``
    checkpoints the ConvTransBlocks in training."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = TCM(config=tuple(config), head_dim=tuple(head_dim), N=N, M=M,
                     num_slices=num_slices, hyper_ch=hyper_ch, atten_inter_dim=atten_inter_dim,
                     drop_path_rate=drop_path_rate, remat=remat)
    return ChannelARCodec(module, device)
