"""Flash window attention, kernel B1 (port of reslic_tcm_tpu/ops/flash_window_attn.py).

``flash_window_block`` computes a whole Swin sub-block over each 8x8 window
of an NHWC map: LN1 -> qkv -> per-head window attention with the relative
position bias (and, for the shifted flavour on the pre-rolled map, the
-1e9 boundary mask) -> proj -> residual, then LN2 -> Linear(4C) -> exact
GELU -> Linear(C) -> residual. With ``with_ln=False, mlp=None`` (WACNN's
WinBasedAttention) it is ``x + proj(attn(x))``: no LayerNorm and no MLP
branch. On a CUDA tensor it launches ``csrc/flash_window_attn.cu``; on a
CPU tensor it runs ``plain_window_block``, the plain PyTorch version
written with explicit einsums. Launches of either flavour are counted in
``flash_window_block.launches``.

The LN+MLP kernel splits each window over a cluster of K CTAs when the
grid would be small (``cluster_size``: fewer than ``CLUSTER_BELOW_WINDOWS``
windows x batch), K chosen from the shape alone; its output is the same,
bit for bit, for every K.

Weights come in torch layout ([out, in] linears) straight from the modules.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import build

NEG_INF = -1e9
KERNEL_WINDOW = 8
# (C, head_dim) instances of the kernel, per flavour
KERNEL_SHAPES_FULL = {(c, hd) for c in (64, 96, 128) for hd in (8, 16, 32)}  # LN1 + MLP
KERNEL_SHAPES_ATTN = {(128, 16), (192, 24)}  # with_ln=False, mlp=None
# LN+MLP: split each window over a cluster below this many windows x batch.
# On an H100 (kernel device time, PERF.md) the split of (128, 16) over 8
# CTAs pays at 4 and 24 windows (TCM's SWAtten at 768x512) and loses from
# 48 windows on, where one CTA per window is faster.
CLUSTER_BELOW_WINDOWS = 32


def max_cluster(c: int, head_dim: int) -> int:
    """The largest cluster (CTAs per window) that splits the heads evenly."""
    heads = c // head_dim
    return next(k for k in (8, 4, 2, 1) if heads % k == 0)


def cluster_size(c: int, head_dim: int, windows: int) -> int:
    """CTAs per window of the LN+MLP kernel for ``windows`` windows x batch:
    the largest split below CLUSTER_BELOW_WINDOWS, else none."""
    return max_cluster(c, head_dim) if windows < CLUSTER_BELOW_WINDOWS else 1


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nWh*nWw, w*w, C]."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // w) * (wd // w), w * w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """[B, nW, w*w, C] -> [B, H, W, C]."""
    b, c = windows.shape[0], windows.shape[-1]
    x = windows.reshape(b, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, wd, c)


def shift_window_mask(h_windows: int, w_windows: int, w: int, shift: int) -> np.ndarray:
    """Boolean mask [nW, w*w, w*w], True = blocked: the SW-MSA mask of the
    rolled map (the last window row and column mix content wrapped around
    by the roll)."""
    s = w - shift
    mask = np.zeros((h_windows, w_windows, w, w, w, w), dtype=bool)
    mask[-1, :, :s, :, s:, :] = True
    mask[-1, :, s:, :, :s, :] = True
    mask[:, -1, :, :s, :, s:] = True
    mask[:, -1, :, s:, :, :s] = True
    return mask.reshape(h_windows * w_windows, w * w, w * w)


def _layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias


def plain_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp=None,
                       *, head_dim: int, window: int, shifted: bool, with_ln: bool = True):
    """Plain PyTorch version of B1: the composed counterpart of the JAX
    package's reference_window_block plus the LN2/MLP branch. x: NHWC,
    pre-rolled for the shifted flavour; rel_bias: [heads, w*w, w*w];
    mlp = (ln2_scale, ln2_bias, w1 [4C, C], b1, w2 [C, 4C], b2) or None;
    with_ln=False feeds x straight into qkv (ln_* are then unread)."""
    b, hgt, wid, c = x.shape
    w = window
    nh = c // head_dim
    ln = _layer_norm(x, ln_scale, ln_bias) if with_ln else x
    windows = window_partition(ln, w)
    qkv = torch.einsum("bnpc,oc->bnpo", windows, wqkv) + bqkv
    qkv = qkv.reshape(b, -1, w * w, 3, nh, head_dim)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    sim = torch.einsum("bnphd,bnqhd->bnhpq", q, k) * head_dim ** -0.5
    sim = sim + rel_bias[None, None]
    if shifted:
        blocked = torch.from_numpy(shift_window_mask(hgt // w, wid // w, w, w // 2)).to(x.device)
        sim = torch.where(blocked[None, :, None], NEG_INF + sim, sim)
    probs = torch.softmax(sim, dim=-1)
    out = torch.einsum("bnhpq,bnqhd->bnphd", probs, v).reshape(b, -1, w * w, c)
    out = torch.einsum("bnpc,oc->bnpo", out, wproj) + bproj
    res = x + window_reverse(out, w, hgt, wid)
    if mlp is None:
        return res
    ln2_scale, ln2_bias, w1, b1, w2, b2 = mlp
    hid = F.gelu(torch.einsum("bhwc,oc->bhwo", _layer_norm(res, ln2_scale, ln2_bias), w1) + b1)
    return res + (torch.einsum("bhwk,ok->bhwo", hid, w2) + b2)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_window_attn")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_window_block_f32.argtypes = [vp] * 15 + [i] * 7 + [vp]
        lib.flash_window_block_f32.restype = ctypes.c_int
        lib.window_attention_block_f32.argtypes = [vp] * 7 + [i] * 6 + [vp]
        lib.window_attention_block_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def flash_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp=None,
                       *, head_dim: int, window: int, shifted: bool, with_ln: bool = True,
                       cluster: int | None = None):
    """x: [B, H, W, C] NHWC float32 (pre-rolled for the shifted flavour);
    wqkv: [3C, C]; bqkv: [3C]; wproj: [C, C]; bproj, ln_*: [C];
    rel_bias: [C/head_dim, w*w, w*w]; mlp = (ln2_scale, ln2_bias,
    w1 [4C, C], b1 [4C], w2 [C, 4C], b2 [C]) or None. The kernel has two
    flavours: LN1 and the MLP (``with_ln=True`` and an ``mlp``), or neither
    (``with_ln=False, mlp=None``; ln_* may be None). ``cluster`` forces the
    LN+MLP kernel's CTAs per window (1 or ``max_cluster``; default
    ``cluster_size`` of the shape); the result is the same for each. Returns
    the block's output."""
    if x.device.type == "cpu":
        return plain_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias,
                                  mlp, head_dim=head_dim, window=window, shifted=shifted,
                                  with_ln=with_ln)
    bsz, h, wd, c = x.shape
    full = with_ln and mlp is not None
    shapes = KERNEL_SHAPES_FULL if full else KERNEL_SHAPES_ATTN
    if (with_ln != (mlp is not None) or window != KERNEL_WINDOW
            or (c, head_dim) not in shapes or h % window or wd % window):
        raise ValueError(
            f"flash_window_block kernel takes window {KERNEL_WINDOW}, H and W multiples of "
            f"it, and (C, head_dim) in {sorted(KERNEL_SHAPES_FULL)} with LN1 and an MLP or in "
            f"{sorted(KERNEL_SHAPES_ATTN)} with neither; got x {tuple(x.shape)}, window "
            f"{window}, head_dim {head_dim}, with_ln={with_ln}, mlp={mlp is not None}")
    if x.data_ptr() % 16:
        raise ValueError("flash_window_block kernel reads x in 16-byte vectors: x must be "
                         "16-byte aligned")
    t = window * window
    windows = bsz * (h // window) * (wd // window)
    if not full:
        cluster = 1
    elif cluster is None:
        cluster = cluster_size(c, head_dim, windows)
    elif cluster not in (1, max_cluster(c, head_dim)):
        raise ValueError(f"flash_window_block kernel at (C, head_dim) = ({c}, {head_dim}) "
                         f"takes cluster 1 or {max_cluster(c, head_dim)}, got {cluster}")
    build.check_inference(x, wqkv, bqkv, wproj, bproj, rel_bias, *(mlp or ()),
                          *((ln_scale, ln_bias) if with_ln else ()))
    build.check_tensor("x", x, (bsz, h, wd, c), x.device, contiguous=True)
    build.check_params(
        x.device, wqkv=(wqkv, (3 * c, c)), bqkv=(bqkv, (3 * c,)), wproj=(wproj, (c, c)),
        bproj=(bproj, (c,)), rel_bias=(rel_bias, (c // head_dim, t, t)))
    # [in, out] weights with head_dim^-0.5 folded into the q columns
    colscale = torch.ones(3 * c, device=x.device)
    colscale[:c] = head_dim ** -0.5
    attn = [(wqkv.detach().t() * colscale).contiguous(), (bqkv.detach() * colscale).contiguous(),
            wproj.detach().t().contiguous(), bproj.detach().contiguous()]
    rel = rel_bias.detach().contiguous()
    out = torch.empty_like(x)
    if full:
        ln2_scale, ln2_bias, w1, b1, w2, b2 = mlp
        build.check_params(
            x.device, ln_scale=(ln_scale, (c,)), ln_bias=(ln_bias, (c,)),
            ln2_scale=(ln2_scale, (c,)), ln2_bias=(ln2_bias, (c,)), w1=(w1, (4 * c, c)),
            b1=(b1, (4 * c,)), w2=(w2, (c, 4 * c)), b2=(b2, (c,)))
        rest = [ln_scale, ln_bias, rel, ln2_scale, ln2_bias, w1.detach().t(), b1,
                w2.detach().t(), b2]
        rest = [a.detach().contiguous() for a in rest]
        rc = _lib().flash_window_block_f32(
            build.ptr(x), build.ptr(out), *[build.ptr(a) for a in attn + rest],
            bsz, h, wd, c, head_dim, cluster, int(shifted), build.stream(x))
    else:
        rc = _lib().window_attention_block_f32(
            build.ptr(x), build.ptr(out), *[build.ptr(a) for a in attn], build.ptr(rel),
            bsz, h, wd, c, head_dim, int(shifted), build.stream(x))
    if rc != 0:
        raise RuntimeError(f"flash_window_block kernel launch failed: cudaError {rc}")
    flash_window_block.launches += 1
    return out


flash_window_block.launches = 0
