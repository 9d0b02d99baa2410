"""Swin window attention (port of reslic_tcm_tpu/ops/window_attention.py), NHWC.

WMSA, SwinTransformerBlock (the reference's ``Block``) and SwinBlock of the
TCM ConvTransBlock and SWAtten, and WindowAttention, WinBasedAttention and
Win_noShift_Attention of WACNN, with the reference's parameter names.
Routing follows the JAX package:

* a window-8 SwinTransformerBlock runs as one fused sub-block through
  ``flash_window_block`` (kernel B1); window-4 blocks (TCM's hyper
  transforms) stay composed;
* WinBasedAttention takes B1's attention-only flavour when the window is a
  multiple of 8, the shift 0 or half the window and H and W multiples of
  the window; otherwise it pads, rolls and partitions the map and runs
  WindowAttention on the windows with the -100 shift mask;
* WindowAttention on a batch of windows is ``fused_qkv_attention`` (kernel
  B4).

Under ``layers.matmul_precision("bfloat16")`` the linears take bf16
operands (``layers.Linear``), B1 runs its bf16 instances (both flavours),
and the composed WMSA and the composed MLP run in bf16 as the JAX
package's do under its ``_score_dtype()`` (window_attention.py:170-176,
:258-261): the windows cast to bf16 before qkv and the whole attention body
in bf16 up to its output, and LN2's output cast to bf16 before the MLP,
each branch back to fp32 before its residual. WindowAttention (WACNN's
window-4 attention at M) then runs the JAX module's composed bf16 body
(window_attention.py:364-392: q, k and v cast to bf16, scores, bias, mask,
softmax and P.v in bf16, the output back to fp32 before proj) through
``plain_qkv_attention(compute_dtype=torch.bfloat16)``: B4 keeps its fp32
instance and is not launched in bf16 mode, as the JAX package computes this
attention outside any Pallas kernel (and B4's Pallas body casts to fp32).

While autograd records, or inside ``layers.plain_versions()``
(``layers.composed``), each module takes its composed branch instead, on
either device, as the JAX package does in training: SwinTransformerBlock LN -> WMSA (-inf mask) -> DropPath -> LN ->
MLP -> DropPath, WinBasedAttention its pad/roll/-100-mask path, and
WindowAttention the composed qkv -> softmax -> proj (B4's plain version on
the live parameters).

Each kernel wrapper runs the kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor. Each module builds its kernel's weights (the
transposed, q-scaled matrices and the gathered relative-position bias) once,
through ``cached``, and rebuilds them only when a parameter changes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flash_window_attn import (KERNEL_WINDOW, flash_window_block, prepare_window_block,
                                shift_window_mask, window_partition, window_reverse)
from .layers import (DropPath, Linear, ResidualUnit, cached, composed, compute_dtype, conv1x1,
                     to_nchw, to_nhwc)
from .qkv_attention import fused_qkv_attention, plain_qkv_attention, prepare_qkv_attention


def relative_position_index(w: int) -> np.ndarray:
    """[w*w, w*w] indices into a flattened (2w-1)x(2w-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[:, :, 0] * (2 * w - 1) + rel[:, :, 1]).astype(np.int32)


class WMSA(nn.Module):
    """Window multi-head self-attention of the TCM ConvTransBlock; type 'SW'
    applies a cyclic shift of w//2. Composed PyTorch, NHWC."""

    def __init__(self, dim: int, head_dim: int, window_size: int, type: str = "W"):
        super().__init__()
        self.dim, self.head_dim, self.window_size, self.type = dim, head_dim, window_size, type
        self.n_heads = dim // head_dim
        w = window_size
        self.relative_position_params = nn.Parameter(
            torch.zeros(self.n_heads, 2 * w - 1, 2 * w - 1))
        nn.init.trunc_normal_(self.relative_position_params, std=0.02)
        self.embedding_layer = Linear(dim, 3 * dim)
        self.linear = Linear(dim, dim)
        self.register_buffer(
            "_rel_index", torch.from_numpy(relative_position_index(w).astype(np.int64)).reshape(-1),
            persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """[heads, w*w, w*w] relative-position bias."""
        t = self.window_size ** 2
        return self.relative_position_params.reshape(self.n_heads, -1)[:, self._rel_index].reshape(
            self.n_heads, t, t)

    def forward(self, x):
        w = self.window_size
        b, h, wd, c = x.shape
        if self.type != "W":
            x = torch.roll(x, shifts=(-(w // 2), -(w // 2)), dims=(1, 2))
        windows = window_partition(x, w)
        if compute_dtype() is torch.bfloat16:
            # the whole attention body in bf16 (the JAX package's _score_dtype)
            windows = windows.to(torch.bfloat16)
        qkv = self.embedding_layer(windows).reshape(b, windows.shape[1], w * w, 3, self.n_heads,
                                                    self.head_dim)
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        sim = torch.einsum("bnphc,bnqhc->bnhpq", q, k) * self.head_dim ** -0.5
        sim = sim + self.rel_bias()[None, None].to(sim.dtype)
        if self.type != "W":
            mask = torch.from_numpy(shift_window_mask(h // w, wd // w, w, w // 2)).to(x.device)
            sim = sim.masked_fill(mask[None, :, None], float("-inf"))
        probs = torch.softmax(sim, dim=-1)
        out = torch.einsum("bnhpq,bnqhc->bnphc", probs, v).reshape(b, -1, w * w, self.dim)
        out = window_reverse(self.linear(out).to(x.dtype), w, h, wd)
        if self.type != "W":
            out = torch.roll(out, shifts=(w // 2, w // 2), dims=(1, 2))
        return out


class SwinTransformerBlock(nn.Module):
    """LN -> WMSA -> DropPath -> +res; LN -> MLP(4x, GELU) -> DropPath ->
    +res (the reference's ``Block``), NHWC. A window-8 block runs as kernel
    B1 unless autograd records; drop-path is the identity, as in the JAX
    module's deterministic call."""

    def __init__(self, dim: int, head_dim: int, window_size: int, type: str = "W",
                 drop_path: float = 0.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.msa = WMSA(dim, head_dim, window_size, type)
        self.ln2 = nn.LayerNorm(dim)
        self.mlp = nn.Sequential(Linear(dim, 4 * dim), nn.GELU(), Linear(4 * dim, dim))
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        msa = self.msa
        w = msa.window_size
        cd = compute_dtype()
        if w != KERNEL_WINDOW or composed(self):
            x = x + self.drop_path(msa(self.ln1(x)))
            # under bf16 the MLP runs in bf16 (the JAX package's _score_dtype)
            return x + self.drop_path(self.mlp(self.ln2(x).to(cd))).to(x.dtype)
        shifted = msa.type != "W"
        if shifted:
            x = torch.roll(x, shifts=(-(w // 2), -(w // 2)), dims=(1, 2))
        args, prepared = self.kernel_weights(cd)
        out = flash_window_block(x.contiguous(), *args, head_dim=msa.head_dim, window=w,
                                 shifted=shifted, prepared=prepared, compute_dtype=cd)
        if shifted:
            out = torch.roll(out, shifts=(w // 2, w // 2), dims=(1, 2))
        return out

    def kernel_weights(self, compute_dtype=torch.float32):
        """(flash_window_block's weight arguments, prepare_window_block of
        them at ``compute_dtype``), built once per type while the
        parameters are unchanged."""
        msa = self.msa

        def make():
            args = (msa.embedding_layer.weight, msa.embedding_layer.bias, msa.linear.weight,
                    msa.linear.bias, self.ln1.weight, self.ln1.bias, msa.rel_bias(),
                    (self.ln2.weight, self.ln2.bias, self.mlp[0].weight, self.mlp[0].bias,
                     self.mlp[2].weight, self.mlp[2].bias))
            return args, prepare_window_block(*args, head_dim=msa.head_dim,
                                              compute_dtype=compute_dtype)

        return cached(self, f"flash_window_block_{compute_dtype}", self.parameters(), make)


class SwinBlock(nn.Module):
    """W + SW block pair on an NHWC map. Pads to a window multiple and crops
    back (the JAX package's behaviour, not the reference's no-crop bug)."""

    def __init__(self, dim: int, head_dim: int, window_size: int, drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.block_1 = SwinTransformerBlock(dim, head_dim, window_size, "W", drop_path)
        self.block_2 = SwinTransformerBlock(dim, head_dim, window_size, "SW", drop_path)

    def forward(self, x):
        w = self.window_size
        _, h, wd, _ = x.shape
        ph, pw = (-h) % w, (-wd) % w
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = self.block_2(self.block_1(x))
        if ph or pw:
            x = x[:, :h, :wd, :]
        return x


class WindowAttention(nn.Module):
    """Relative-position-bias window MHSA over [B_, N, C] windows (the
    reference's win_attention.py WindowAttention): kernel B4 on the card."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        w = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * w - 1) * (2 * w - 1), num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.register_buffer(
            "_rel_index", torch.from_numpy(relative_position_index(w).astype(np.int64)).reshape(-1),
            persistent=False)

    def rel_bias(self) -> torch.Tensor:
        """[heads, w*w, w*w] relative-position bias."""
        t = self.window_size ** 2
        return self.relative_position_bias_table[self._rel_index].reshape(
            t, t, self.num_heads).permute(2, 0, 1)

    def kernel_weights(self):
        """(fused_qkv_attention's weight arguments, prepare_qkv_attention of
        them), built once while the parameters are unchanged."""
        def make():
            args = (self.qkv.weight, self.qkv.bias, self.rel_bias(), self.proj.weight,
                    self.proj.bias)
            return args, prepare_qkv_attention(*args)

        return cached(self, "fused_qkv_attention", self.parameters(), make)

    def window_block_weights(self, compute_dtype=torch.float32):
        """(flash_window_block's attention-only weight arguments,
        prepare_window_block of them at ``compute_dtype``), built once per
        type while the parameters are unchanged."""
        def make():
            args = (self.qkv.weight, self.qkv.bias, self.proj.weight, self.proj.bias, None,
                    None, self.rel_bias(), None)
            return args, prepare_window_block(*args, head_dim=self.dim // self.num_heads,
                                              compute_dtype=compute_dtype)

        return cached(self, f"flash_window_block_{compute_dtype}", self.parameters(), make)

    def forward(self, x, mask=None):
        """x: [B_, N, C] windows; mask: [nW, N, N] additive (window i takes
        mask[i % nW]) or None. Under bf16 the composed bf16 body (module
        docstring), on either device and with or without autograd."""
        cd = compute_dtype()
        if composed(self) or cd is torch.bfloat16:
            return plain_qkv_attention(x, self.qkv.weight, self.qkv.bias, self.rel_bias(),
                                       self.proj.weight, self.proj.bias, mask, compute_dtype=cd)
        args, prepared = self.kernel_weights()
        return fused_qkv_attention(x.contiguous(), *args, mask, prepared=prepared)


@functools.lru_cache(maxsize=16)
def region_mask(h: int, wd: int, w: int, s: int) -> np.ndarray:
    """The composed path's [nW, w*w, w*w] shift mask of an h x wd map rolled
    by -s: -100 between tokens of different regions, else 0."""
    img = np.zeros((h, wd), np.int32)
    cnt = 0
    for hs in (slice(0, h - w), slice(h - w, h - s), slice(h - s, h)):
        for ws in (slice(0, wd - w), slice(wd - w, wd - s), slice(wd - s, wd)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // w, w, wd // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WinBasedAttention(nn.Module):
    """Shifted-window attention with a residual shortcut (the reference's
    win_attention.py WinBasedAttention), NHWC."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8, shift_size: int = 0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, window_size, num_heads)

    def forward(self, x):
        w, s = self.window_size, self.shift_size
        if w % KERNEL_WINDOW == 0 and s in (0, w // 2) and x.shape[1] % w == 0 \
                and x.shape[2] % w == 0 and not composed(self):
            return self._fused(x)
        shortcut = x
        oh, ow = x.shape[1], x.shape[2]
        ph, pw = (-oh) % w, (-ow) % w
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        b, h, wd, c = x.shape
        mask = None
        if s > 0:
            mask = torch.from_numpy(region_mask(h, wd, w, s)).to(x.device)
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        windows = window_partition(x, w).reshape(-1, w * w, c)
        out = self.attn(windows, mask).reshape(b, -1, w * w, c)
        x = window_reverse(out, w, h, wd)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        if ph or pw:
            x = x[:, :oh, :ow, :]
        return shortcut + x

    def _fused(self, x):
        """x + attn(x) as B1's attention-only flavour (the -1e9 boundary mask
        on the rolled map; the composed path's -100 gives the same softmax
        to below 1e-40), at the current compute type."""
        cd = compute_dtype()
        w, s = self.window_size, self.shift_size
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        args, prepared = self.attn.window_block_weights(cd)
        out = flash_window_block(x.contiguous(), *args, head_dim=self.dim // self.num_heads,
                                 window=w, shifted=s > 0, with_ln=False, prepared=prepared,
                                 compute_dtype=cd)
        if s > 0:
            out = torch.roll(out, shifts=(s, s), dims=(1, 2))
        return out


class Win_noShift_Attention(nn.Module):
    """Gated window-attention block ``a * sigmoid(b) + x`` (the reference's
    layers.py Win_noShift_Attention), NCHW: a = three GELU residual units on
    x; b = WinBasedAttention on x, three GELU residual units and a 1x1."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8, shift_size: int = 0):
        super().__init__()
        self.conv_a = nn.Sequential(*(ResidualUnit(dim, nn.GELU) for _ in range(3)))
        self.win_attn = WinBasedAttention(dim, num_heads, window_size, shift_size)
        self.conv_b = nn.Sequential(*(ResidualUnit(dim, nn.GELU) for _ in range(3)),
                                    conv1x1(dim, dim))

    def forward(self, x):
        a = self.conv_a(x)
        b = self.conv_b(to_nchw(self.win_attn(to_nhwc(x))))
        return a * torch.sigmoid(b) + x
