"""Auxiliary gain-model layers (port of reslic_tcm_tpu/models/gain/extra_layers.py).

ResBlock and NonLocalAttention come from the reference's gain utils; no
model uses them, and the port keeps them beside the JAX package's. The
reference's NonLocalAttention returns its input and discards the attention
output; ``passthrough_bug=True`` reproduces that, the default returns the
computed output. NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.layers import conv


class ResBlock(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 + identity."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv(channels, channels, 3)
        self.conv2 = conv(channels, channels, 3)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


class NonLocalAttention(nn.Module):
    """x + trunk(x) * sigmoid(activate(attn(x))), trunk and attn three
    ResBlocks each."""

    def __init__(self, channels: int, passthrough_bug: bool = False):
        super().__init__()
        self.passthrough_bug = passthrough_bug
        for branch in ("trunk", "attn"):
            for i in range(3):
                self.add_module(f"{branch}_{i}", ResBlock(channels))
        self.activate = conv(channels, channels, 1)

    def forward(self, x):
        trunk = attn = x
        for i in range(3):
            trunk = getattr(self, f"trunk_{i}")(trunk)
            attn = getattr(self, f"attn_{i}")(attn)
        out = x + trunk * torch.sigmoid(self.activate(attn))
        return x if self.passthrough_bug else out
