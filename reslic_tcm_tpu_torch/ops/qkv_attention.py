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

The kernel takes G windows per CTA and splits the heads over a cluster of
K CTAs, (G, K) chosen from the shape by ``group_config``; the output is the
same, bit for bit, for every (G, K).

Argument order is the JAX function's; weights are in torch layout
([out, in] linears) straight from the module. ``prepare_qkv_attention``
gives them in the kernel's layout, which a caller may build once and pass
as ``prepared`` (window_attention.py caches it per module).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

# (T, C, head_dim) instances of the kernel
KERNEL_SHAPES = {(16, 320, 40)}
# (windows per CTA, CTAs per cluster) with an instance, for each shape
GROUPS = ((2, 4), (2, 8))
# split the heads over 8 CTAs below this many windows, over 4 from it on
SPLIT8_BELOW_WINDOWS = 32


def group_config(windows: int, t: int, c: int, head_dim: int) -> tuple[int, int]:
    """(G, K) of the kernel for ``windows`` windows of t tokens, c channels.
    On an H100 (kernel device time, PERF.md §6; (2, 2), (4, 2), (4, 4) and
    (4, 8) measured too, slower) two windows per CTA pay at every count,
    with the heads over 8 CTAs below 32 windows (16: 0.029 ms against 0.036
    at (2, 4)) and over 4 from 48 on (48: 0.047 against 0.051 at (2, 8);
    96: 0.074 against 0.106)."""
    return (2, 8) if windows < SPLIT8_BELOW_WINDOWS else (2, 4)


def _linear(x, w, b, compute_dtype):
    """x . w^T + b; under bf16 the operands as bf16 with fp32 sums, the
    result rounded to bf16 as cuBLAS gives it and back in fp32 before the
    fp32 bias (``layers.Linear``'s bf16 branch)."""
    if compute_dtype == torch.float32:
        return x @ w.t() + b
    return F.linear(x.to(torch.bfloat16), w.to(torch.bfloat16)).float() + b


def plain_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask=None,
                        compute_dtype=torch.float32):
    """Plain PyTorch version of B4: windows [Nw, T, C]; w_qkv [3C, C];
    rel_bias [heads, T, T]; w_proj [C, C]; mask [nW, T, T] additive with Nw
    a multiple of nW (window i takes mask[i % nW]), or None. q is scaled
    before q.k, as WindowAttention does. compute_dtype=torch.bfloat16 is
    the JAX module's composed bf16 body (window_attention.py:364-392): the
    linears take bf16 operands, q (scaled in fp32), k and v are cast to
    bf16, and the scores, the bias and the mask (both cast to bf16), the
    softmax and P.v are computed in bf16, the output back in fp32 before
    proj. B4's kernel has no such form."""
    nw, t, c = windows.shape
    heads = rel_bias.shape[0]
    hd = c // heads
    qkv = _linear(windows, w_qkv, b_qkv, compute_dtype).reshape(nw, t, 3, heads, hd).permute(
        2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    if compute_dtype != torch.float32:
        q, k, v = q.to(compute_dtype), k.to(compute_dtype), v.to(compute_dtype)
    attn = q @ k.transpose(-2, -1) + rel_bias[None].to(q.dtype)
    if mask is not None:
        n_mask = mask.shape[0]
        attn = (attn.reshape(nw // n_mask, n_mask, heads, t, t)
                + mask[None, :, None].to(q.dtype)).reshape(nw, heads, t, t)
    out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(nw, t, c).float()
    return _linear(out, w_proj, b_proj, compute_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("qkv_attention")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.qkv_attention_f32.argtypes = [vp] * 8 + [i] * 5 + [ctypes.c_float, i, i, vp]
        lib.qkv_attention_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def prepare_qkv_attention(w_qkv, b_qkv, rel_bias, w_proj, b_proj) -> tuple:
    """The kernel's weights from the wrapper's (torch layout, checked here):
    [in, out] matrices, all contiguous, in the C interface's order."""
    c = w_proj.shape[0]
    heads, t = rel_bias.shape[0], rel_bias.shape[-1]
    build.check_params(w_qkv.device, w_qkv=(w_qkv, (3 * c, c)), b_qkv=(b_qkv, (3 * c,)),
                       rel_bias=(rel_bias, (heads, t, t)), w_proj=(w_proj, (c, c)),
                       b_proj=(b_proj, (c,)))
    return tuple(a.detach().contiguous() for a in (w_qkv.t(), b_qkv, rel_bias, w_proj.t(),
                                                  b_proj))


def fused_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask=None, *,
                        split: tuple[int, int] | None = None, prepared: tuple | None = None):
    """windows: [Nw, T, C] float32; w_qkv: [3C, C]; b_qkv: [3C];
    rel_bias: [heads, T, T]; w_proj: [C, C]; b_proj: [C]; mask: [nW, T, T]
    additive (Nw a multiple of nW) or None. ``split`` forces the kernel's
    (windows per CTA, CTAs per cluster), one of ``GROUPS`` (default
    ``group_config``); the result is the same for each. ``prepared``:
    ``prepare_qkv_attention`` of these weights, built by the caller.
    Returns [Nw, T, C]."""
    if windows.device.type == "cpu":
        return plain_qkv_attention(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj, mask)
    nw, t, c = windows.shape
    heads = rel_bias.shape[0]
    hd = c // heads
    if (t, c, hd) not in KERNEL_SHAPES or heads * hd != c:
        raise ValueError(f"fused_qkv_attention kernel takes (T, C, head_dim) in "
                         f"{sorted(KERNEL_SHAPES)}; got windows {tuple(windows.shape)} with "
                         f"{heads} heads")
    if split is None:
        split = group_config(nw, t, c, hd)
    elif tuple(split) not in GROUPS:
        raise ValueError(f"fused_qkv_attention kernel takes split (G, K) in {GROUPS}, "
                         f"got {split}")
    dev = windows.device
    build.check_inference(windows, w_qkv, b_qkv, rel_bias, w_proj, b_proj,
                          *(() if mask is None else (mask,)))
    build.check_tensor("windows", windows, (nw, t, c), dev, contiguous=True)
    if windows.data_ptr() % 16:
        raise ValueError("fused_qkv_attention kernel reads the windows in 16-byte vectors: "
                         "they must be 16-byte aligned")
    n_mask = 0
    if mask is not None:
        n_mask = mask.shape[0]
        build.check_tensor("mask", mask, (n_mask, t, t), dev)
        if n_mask == 0 or nw % n_mask:
            raise ValueError(f"mask: {n_mask} windows do not divide {nw}")
        mask = mask.detach().contiguous()
    if prepared is None:
        prepared = prepare_qkv_attention(w_qkv, b_qkv, rel_bias, w_proj, b_proj)
    if len(prepared) != 5 or prepared[0].device != dev or prepared[2].shape != (heads, t, t):
        raise ValueError(f"prepared: expected prepare_qkv_attention's weights for {heads} "
                         f"heads of {t} tokens on {dev}")
    out = torch.empty_like(windows)
    rc = _lib().qkv_attention_f32(
        build.ptr(windows), build.ptr(out), *[build.ptr(a) for a in prepared],
        ctypes.c_void_p(None if mask is None else mask.data_ptr()),
        nw, t, c, hd, n_mask, ctypes.c_float(hd ** -0.5), *split, build.stream(windows))
    if rc != 0:
        raise RuntimeError(f"fused_qkv_attention kernel launch failed: cudaError {rc}")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0
