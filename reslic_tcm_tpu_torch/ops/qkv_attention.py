"""Per-window qkv attention, kernel B4 (port of the repository's per-head
Pallas attention kernel, pallas_attn_perhead.py::fused_qkv_attention).

``fused_qkv_attention`` computes, for each window of ``[Nw, T, C]`` tokens,
``proj(softmax(q k^T * hd^-0.5 + rel_bias (+ mask)) v)``: the qkv
projection, per-head attention with the relative-position bias and an
optional additive mask, and the output projection, with no LayerNorm, MLP
or residual. It is exactly what WindowAttention computes on a batch of
windows, so ``window_attention.WindowAttention.forward`` is this function.
On a CUDA tensor it launches ``csrc/qkv_attention.cu``; on a CPU tensor it
runs ``plain_qkv_attention``, WindowAttention's composed math. Launches are
counted in ``fused_qkv_attention.launches``.

Argument order is the JAX function's; weights are in torch layout
([out, in] linears) straight from the module.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# (T, C, head_dim) instances of the kernel
KERNEL_SHAPES = {(16, 320, 40)}


def plain_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask=None):
    """Plain PyTorch version of B4: windows [Nw, T, C]; w_qkv [3C, C];
    rel_bias [heads, T, T]; w_proj [C, C]; mask [nW, T, T] additive with Nw
    a multiple of nW (window i takes mask[i % nW]), or None. q is scaled
    before q.k, as WindowAttention does."""
    nw, t, c = windows.shape
    heads = rel_bias.shape[0]
    hd = c // heads
    qkv = (windows @ w_qkv.t() + b_qkv).reshape(nw, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1) + rel_bias[None]
    if mask is not None:
        n_mask = mask.shape[0]
        attn = (attn.reshape(nw // n_mask, n_mask, heads, t, t) + mask[None, :, None]).reshape(
            nw, heads, t, t)
    out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(nw, t, c)
    return out @ w_proj.t() + b_proj


def _lib() -> ctypes.CDLL:
    lib = build.load("qkv_attention")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.qkv_attention_f32.argtypes = [vp] * 8 + [i] * 5 + [ctypes.c_float, vp]
        lib.qkv_attention_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def fused_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask=None):
    """windows: [Nw, T, C] float32; w_qkv: [3C, C]; b_qkv: [3C];
    rel_bias: [heads, T, T]; w_proj: [C, C]; b_proj: [C]; mask: [nW, T, T]
    additive (Nw a multiple of nW) or None. Returns [Nw, T, C]."""
    if windows.device.type == "cpu":
        return plain_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask)
    nw, t, c = windows.shape
    heads = rel_bias.shape[0]
    hd = c // heads
    if (t, c, hd) not in KERNEL_SHAPES or heads * hd != c:
        raise ValueError(f"fused_qkv_attention kernel takes (T, C, head_dim) in "
                         f"{sorted(KERNEL_SHAPES)}; got windows {tuple(windows.shape)} with "
                         f"{heads} heads")
    dev = windows.device
    build.check_inference(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj,
                          *(() if mask is None else (mask,)))
    build.check_tensor("windows", windows, (nw, t, c), dev, contiguous=True)
    build.check_params(dev, w_qkv=(w_qkv, (3 * c, c)), b_qkv=(b_qkv, (3 * c,)),
                       rel_bias=(rel_bias, (heads, t, t)), w_proj=(w_proj, (c, c)),
                       b_proj=(b_proj, (c,)))
    n_mask = 0
    if mask is not None:
        n_mask = mask.shape[0]
        build.check_tensor("mask", mask, (n_mask, t, t), dev)
        if n_mask == 0 or nw % n_mask:
            raise ValueError(f"mask: {n_mask} windows do not divide {nw}")
        mask = mask.detach().contiguous()
    args = [w_qkv.detach().t().contiguous(), b_qkv.detach().contiguous(),
            rel_bias.detach().contiguous(), w_proj.detach().t().contiguous(),
            b_proj.detach().contiguous()]
    out = torch.empty_like(windows)
    rc = _lib().qkv_attention_f32(
        build.ptr(windows), build.ptr(out), *[build.ptr(a) for a in args],
        ctypes.c_void_p(None if mask is None else mask.data_ptr()),
        nw, t, c, hd, n_mask, ctypes.c_float(hd ** -0.5), build.stream(windows))
    if rc != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: cudaError {rc}")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
