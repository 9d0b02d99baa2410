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

Both flavours split each window over a cluster of K CTAs, K chosen from
the shape alone: the LN+MLP flavour when the grid would be small
(``cluster_size``: fewer than ``CLUSTER_BELOW_WINDOWS`` windows x batch)
and at C=192 always (``min_cluster``: its window needs two CTAs' shared
memory), the attention-only flavour by ``attn_cluster_size``. The output is
the same, bit for bit, for every K.

Weights come in torch layout ([out, in] linears) straight from the modules;
``prepare_window_block`` gives them in the kernel's layout, which a caller
may build once and pass as ``prepared`` (window_attention.py caches it per
module and compute type).

``compute_dtype=torch.bfloat16`` is the TPU kernel's bf16 mode, in both
flavours: the operands of the products are rounded to bf16 where the
Pallas body casts them (LN1's output, or x without LN, and wqkv; q and k;
the softmax's probabilities and v; the heads' output and wproj; LN2's
output and w1; the GELU's output and w2), the q scale folded into wqkv in
fp32 first; LN, the bias and the -1e9 mask, softmax, GELU, the biases and
the residuals stay fp32. On the card it launches tensor-core kernels:
``csrc/flash_window_attn_bf16.cu`` (``swin_block_bf16_kernel``) for LN+MLP,
at the fp32 flavour's clusters, and ``csrc/window_attn_bf16.cu``
(``window_attn_bf16_kernel``) for attention-only, whose persistent clusters
keep their share of W in shared memory for the launch
(``attn_cluster_size_bf16`` chooses K from ``ATTN_CLUSTERS_BF16``,
``attn_grid`` the clusters; ``grid`` forces them); their launches are
counted in ``flash_window_block.launches_bf16``. The LN+MLP kernel also
takes G windows a CTA (one warpgroup each, sharing every staged weight
tile): ``window_group`` chooses G from the grid, and
``flash_window_block_at`` forces any (cluster, G) it has an instance for.
Every option gives the same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .fused_conv import kgroups, rounder

NEG_INF = -1e9
KERNEL_WINDOW = 8
# (C, head_dim) instances of the kernel, per flavour
KERNEL_SHAPES_FULL = {(c, hd) for c in (64, 96, 128, 192) for hd in (8, 16, 32)}  # LN1 + MLP
KERNEL_SHAPES_ATTN = {(128, 16), (192, 24)}  # with_ln=False, mlp=None
# LN+MLP: split each window over a cluster below this many windows x batch.
# On an H100 (kernel device time, PERF.md) the split of (128, 16) over 8
# CTAs pays at 4 and 24 windows (TCM's SWAtten at 768x512) and loses from
# 48 windows on, where one CTA per window is faster.
CLUSTER_BELOW_WINDOWS = 32
# C=192 (whose window needs a cluster of at least 2): the largest split
# pays while the grid has at most this many CTAs (``cluster_size``)
CLUSTER_CTAS_192 = 64


# attention-only: the clusters with an instance, for each (C, head_dim) of
# KERNEL_SHAPES_ATTN
ATTN_CLUSTERS = (1, 2, 4)


def attn_cluster_size(c: int, head_dim: int, windows: int) -> int:
    """CTAs per window of the attention-only kernel for ``windows`` windows
    x batch. On an H100 (kernel device time, PERF.md §6) 4 pays below 32
    windows (16: 0.046 ms at C=192 against 0.070 at 2), 2 below 192 (64:
    0.071 against 0.115 at 4 and 0.133 at 1) and at C=128 at every count
    (two such CTAs share an SM; 384: 0.196 against 0.211 at 1), and 1 at
    C=192 from 192 on (384: 0.406 against 0.427 at 2)."""
    if windows < 32:
        return 4
    return 2 if windows < 192 or c == 128 else 1


# attention-only, bf16 (csrc/window_attn_bf16.cu): the clusters with an
# instance at each C of KERNEL_SHAPES_ATTN; a rank keeps its share of W in
# shared memory, which at C=192 takes two CTAs at least
ATTN_CLUSTERS_BF16 = {128: (2, 4), 192: (2, 4)}


# the bf16 attention-only kernel's rule: 4 CTAs a window below
# ATTN_QUAD_BELOW_BF16 windows x batch, else 2
ATTN_QUAD_BELOW_BF16 = 32


def attn_cluster_size_bf16(c: int, head_dim: int, windows: int) -> int:
    """CTAs per window of the bf16 attention-only kernel for ``windows``
    windows x batch (one of ``ATTN_CLUSTERS_BF16[c]``), the same at both
    widths. On an H100 (kernel device time over 4-768 windows, PERF.md §6)
    4 pays below 32 windows (16: 0.0123 ms at C=192 against 0.0143 at 2;
    0.0100 against 0.0115 at C=128) and 2 from there on (32: 0.0144 against
    0.0197 at 4; 384: 0.0558 against 0.1082 at 4, and 0.0426 at C=128)."""
    return 4 if windows < ATTN_QUAD_BELOW_BF16 else 2


_max_clusters: dict = {}  # (device index, C, head_dim, cluster) -> resident clusters


def attn_grid(c: int, head_dim: int, cluster: int, windows: int, device) -> int:
    """The persistent clusters the bf16 attention-only kernel launches by
    default on ``device``: as many as the card holds at once (the
    library's occupancy query, asked once per device and instance), at most
    one a window."""
    key = (torch.device(device).index, c, head_dim, cluster)
    if key not in _max_clusters:
        with torch.cuda.device(torch.device(device)):
            n = _attn_lib().window_attention_bf16_max_clusters(c, head_dim, cluster)
        if n <= 0:
            raise RuntimeError(f"window_attn_bf16 occupancy query failed: cudaError {-n}")
        _max_clusters[key] = n
    return min(windows, _max_clusters[key])


def max_cluster(c: int, head_dim: int) -> int:
    """The largest cluster (CTAs per window) that splits the heads evenly."""
    heads = c // head_dim
    return next(k for k in (8, 4, 2, 1) if heads % k == 0)


def min_cluster(c: int) -> int:
    """The smallest cluster of the LN+MLP kernel at C channels: 2 at
    C=192, whose window does not fit one CTA's shared memory (266 KB against
    227 KB; 200 KB per CTA split in two), else 1."""
    return 2 if c == 192 else 1


def cluster_size(c: int, head_dim: int, windows: int) -> int:
    """CTAs per window of the LN+MLP kernel for ``windows`` windows x batch:
    the largest split below CLUSTER_BELOW_WINDOWS, else one CTA. At C=192
    the largest split while it makes at most CLUSTER_CTAS_192 CTAs, else
    two: on an H100 (kernel device time over 10 interleaved rounds,
    PERF.md §6) 8 beats 2 at 4 windows (hd 8: 0.138 against 0.227 ms) and
    loses at 16 (0.264 against 0.227), 4 beats 2 at 16 (hd 16: 0.173
    against 0.215) and loses at 32 (0.346 against 0.216), and 2 wins from
    there on (1536 windows: 5.37 against 13.00 at 8)."""
    k = max_cluster(c, head_dim)
    if c == 192:
        return k if windows * k <= CLUSTER_CTAS_192 else min_cluster(c)
    return k if windows < CLUSTER_BELOW_WINDOWS else 1


# bf16 LN+MLP kernel: windows a CTA (one warpgroup each); two only at the
# smallest cluster
GROUPS_BF16 = (1, 2)
# two windows a CTA from this many CTAs of the grid on.
# On an H100 (PERF.md §6) two won at 96 CTAs (C=192's 96 windows over
# clusters of 2: 0.0735 against 0.0884 ms) and at 192 and more, and lost or
# tied at 48 (96 windows at C=64 and 128).
GROUP_CTAS = 96


def window_group(c: int, head_dim: int, windows: int, cluster: int) -> int:
    """Windows a CTA of the bf16 LN+MLP kernel for ``windows`` windows x
    batch at ``cluster`` CTAs a window: two (each staged weight tile then
    feeds two windows' products) where the grid keeps at least GROUP_CTAS
    CTAs, else one. Two exist only at the smallest cluster."""
    if cluster != min_cluster(c):
        return 1
    return 2 if -(-windows // 2) * cluster >= GROUP_CTAS else 1


def window_groups(c: int, cluster: int) -> tuple:
    """The windows a CTA the bf16 LN+MLP kernel has an instance for."""
    return GROUPS_BF16 if cluster == min_cluster(c) else (1,)


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


def _q_scaled(wqkv, bqkv, head_dim: int):
    """wqkv [3C, C] and bqkv with head_dim^-0.5 folded into the q rows, in
    fp32 (before any bf16 cast, as the TPU kernel folds it)."""
    c = wqkv.shape[1]
    colscale = torch.ones(3 * c, device=wqkv.device)
    colscale[:c] = head_dim ** -0.5
    return wqkv * colscale[:, None], bqkv * colscale


def plain_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp=None,
                       *, head_dim: int, window: int, shifted: bool, with_ln: bool = True,
                       compute_dtype=torch.float32):
    """Plain PyTorch version of B1: the composed counterpart of the JAX
    package's reference_window_block plus the LN2/MLP branch. x: NHWC,
    pre-rolled for the shifted flavour; rel_bias: [heads, w*w, w*w];
    mlp = (ln2_scale, ln2_bias, w1 [4C, C], b1, w2 [C, 4C], b2) or None;
    with_ln=False feeds x straight into qkv (ln_* are then unread).
    compute_dtype=torch.bfloat16 rounds each product's operands to bf16 at
    the Pallas body's cast points (module docstring)."""
    rd = rounder(compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    b, hgt, wid, c = x.shape
    w = window
    nh = c // head_dim
    ln = _layer_norm(x, ln_scale, ln_bias) if with_ln else x
    windows = window_partition(ln, w)
    if bf16:
        wqkv, bqkv = _q_scaled(wqkv, bqkv, head_dim)
    qkv = torch.einsum("bnpc,oc->bnpo", rd(windows), rd(wqkv)) + bqkv
    qkv = qkv.reshape(b, -1, w * w, 3, nh, head_dim)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    sim = torch.einsum("bnphd,bnqhd->bnhpq", rd(q), rd(k))
    if not bf16:
        sim = sim * head_dim ** -0.5
    sim = sim + rel_bias[None, None]
    if shifted:
        blocked = torch.from_numpy(shift_window_mask(hgt // w, wid // w, w, w // 2)).to(x.device)
        sim = torch.where(blocked[None, :, None], NEG_INF + sim, sim)
    probs = torch.softmax(sim, dim=-1)
    out = torch.einsum("bnhpq,bnqhd->bnphd", rd(probs), rd(v)).reshape(b, -1, w * w, c)
    out = torch.einsum("bnpc,oc->bnpo", rd(out), rd(wproj)) + bproj
    res = x + window_reverse(out, w, hgt, wid)
    if mlp is None:
        return res
    ln2_scale, ln2_bias, w1, b1, w2, b2 = mlp
    hid = F.gelu(torch.einsum("bhwc,oc->bhwo", rd(_layer_norm(res, ln2_scale, ln2_bias)),
                              rd(w1)) + b1)
    return res + (torch.einsum("bhwk,ok->bhwo", rd(hid), rd(w2)) + b2)


def _lib(compute_dtype=torch.float32, c: int = 0) -> ctypes.CDLL:
    """The instances' library; the bf16 LN+MLP instances at C >= 128 live in
    a library of their own (ops/build.py)."""
    if compute_dtype == torch.bfloat16:
        lib = build.load("flash_window_attn_bf16_wide" if c >= 128 else "flash_window_attn_bf16")
        if not hasattr(lib, "_argtypes_set"):
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_window_block_bf16.argtypes = [vp] * 15 + [i] * 8 + [vp]
            lib.flash_window_block_bf16.restype = ctypes.c_int
            lib._argtypes_set = True
        return lib
    lib = build.load("flash_window_attn")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_window_block_f32.argtypes = [vp] * 15 + [i] * 7 + [vp]
        lib.flash_window_block_f32.restype = ctypes.c_int
        lib.window_attention_block_f32.argtypes = [vp] * 7 + [i] * 7 + [vp]
        lib.window_attention_block_f32.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _attn_lib() -> ctypes.CDLL:
    """The bf16 attention-only kernel's library (csrc/window_attn_bf16.cu)."""
    lib = build.load("window_attn_bf16")
    if not hasattr(lib, "_argtypes_set"):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.window_attention_block_bf16.argtypes = [vp] * 7 + [i] * 8 + [vp]
        lib.window_attention_block_bf16.restype = ctypes.c_int
        lib.window_attention_bf16_max_clusters.argtypes = [i] * 3
        lib.window_attention_bf16_max_clusters.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def prepare_window_block(wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp=None,
                         *, head_dim: int, compute_dtype=torch.float32) -> tuple:
    """The kernel's weights from the wrapper's (torch layout, checked here),
    contiguous, head_dim^-0.5 folded into the q columns of wqkv and bqkv;
    LN1 and the MLP's only when ``mlp`` is given. The float32 instance takes
    [in, out] matrices; the bf16 ones (``compute_dtype=torch.bfloat16``)
    take them in bf16 as ``kgroups`` [in/8, out, 8], wqkv's rows head by
    head (each head's q, k and v rows together), the vectors and the bias
    table in fp32. The order is the C interface's after x and out."""
    rounder(compute_dtype)  # raises for a type without instances
    c = wproj.shape[0]
    dev = wqkv.device
    t = rel_bias.shape[-1]
    build.check_params(
        dev, wqkv=(wqkv, (3 * c, c)), bqkv=(bqkv, (3 * c,)), wproj=(wproj, (c, c)),
        bproj=(bproj, (c,)), rel_bias=(rel_bias, (c // head_dim, t, t)))
    bf16 = compute_dtype == torch.bfloat16
    with torch.no_grad():
        wq, bq = _q_scaled(wqkv, bqkv, head_dim)
        # a matrix of the float32 instance is [in, out]
        mat = lambda m: m.detach().t().contiguous()  # noqa: E731
        if bf16:  # k-groups in bf16, wqkv's rows head by head
            nh = c // head_dim
            heads = torch.arange(3 * c, device=dev).reshape(3, nh, head_dim)
            mat = lambda m: kgroups(m.detach())  # noqa: E731
            wq = wq[heads.permute(1, 0, 2).reshape(-1)]
        attn = [mat(wq), bq.contiguous(), mat(wproj), bproj.detach().contiguous()]
        if mlp is None:
            return (*attn, rel_bias.detach().contiguous())
        ln2_scale, ln2_bias, w1, b1, w2, b2 = mlp
        build.check_params(
            dev, ln_scale=(ln_scale, (c,)), ln_bias=(ln_bias, (c,)),
            ln2_scale=(ln2_scale, (c,)), ln2_bias=(ln2_bias, (c,)), w1=(w1, (4 * c, c)),
            b1=(b1, (4 * c,)), w2=(w2, (c, 4 * c)), b2=(b2, (c,)))
        vec = [ln_scale, ln_bias, rel_bias, ln2_scale, ln2_bias]
        return (*attn, *(a.detach().contiguous() for a in vec), mat(w1),
                b1.detach().contiguous(), mat(w2), b2.detach().contiguous())


def flash_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp=None,
                       *, head_dim: int, window: int, shifted: bool, with_ln: bool = True,
                       cluster: int | None = None, prepared: tuple | None = None,
                       compute_dtype=torch.float32, grid: int | None = None):
    """x: [B, H, W, C] NHWC float32 (pre-rolled for the shifted flavour);
    wqkv: [3C, C]; bqkv: [3C]; wproj: [C, C]; bproj, ln_*: [C];
    rel_bias: [C/head_dim, w*w, w*w]; mlp = (ln2_scale, ln2_bias,
    w1 [4C, C], b1 [4C], w2 [C, 4C], b2 [C]) or None. The kernel has two
    flavours: LN1 and the MLP (``with_ln=True`` and an ``mlp``), or neither
    (``with_ln=False, mlp=None``; ln_* may be None). ``cluster`` forces the
    kernel's CTAs per window (LN+MLP: ``min_cluster`` or ``max_cluster``, default
    ``cluster_size``; attention-only: one of ``ATTN_CLUSTERS``, default
    ``attn_cluster_size``, or in bf16 one of ``ATTN_CLUSTERS_BF16[C]``,
    default ``attn_cluster_size_bf16``), and ``grid`` (the bf16
    attention-only kernel only) its persistent clusters, 1 to the windows x
    batch (default ``attn_grid``); the result is the same for each.
    ``prepared``: ``prepare_window_block`` of these weights, built by the
    caller (the kernel then reads it instead of preparing the weights
    again), at this ``compute_dtype`` (torch.float32 or torch.bfloat16,
    either flavour). Returns the block's output (float32)."""
    return _window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp,
                         head_dim=head_dim, window=window, shifted=shifted, with_ln=with_ln,
                         cluster=cluster, group=None, prepared=prepared,
                         compute_dtype=compute_dtype, grid=grid)


def flash_window_block_at(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp,
                          *, head_dim: int, window: int, shifted: bool, cluster: int,
                          group: int, prepared: tuple | None = None):
    """``flash_window_block`` of the LN+MLP flavour in bf16 with both of its
    kernel's splits forced: ``cluster`` CTAs a window (``min_cluster`` or
    ``max_cluster``) and ``group`` windows a CTA (one of
    ``window_groups(C, cluster)``). The result is the same for each; the
    call counts in ``flash_window_block.launches_bf16``. On a CPU tensor it
    runs the plain bf16 version."""
    return _window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp,
                         head_dim=head_dim, window=window, shifted=shifted, with_ln=True,
                         cluster=cluster, group=group, prepared=prepared,
                         compute_dtype=torch.bfloat16, grid=None)


def _window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias, mlp, *,
                  head_dim, window, shifted, with_ln, cluster, group, prepared, compute_dtype,
                  grid):
    if x.device.type == "cpu":
        return plain_window_block(x, wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias,
                                  mlp, head_dim=head_dim, window=window, shifted=shifted,
                                  with_ln=with_ln, compute_dtype=compute_dtype)
    rounder(compute_dtype)  # raises for a type without instances
    bf16 = compute_dtype == torch.bfloat16
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
    windows = bsz * (h // window) * (wd // window)
    persistent = bf16 and not full  # the bf16 attention-only kernel
    clusters = ((min_cluster(c), max_cluster(c, head_dim)) if full
                else ATTN_CLUSTERS_BF16[c] if persistent else ATTN_CLUSTERS)
    if cluster is None:
        cluster = (cluster_size if full else attn_cluster_size_bf16 if persistent
                   else attn_cluster_size)(c, head_dim, windows)
    elif cluster not in clusters:
        raise ValueError(f"flash_window_block kernel at (C, head_dim) = ({c}, {head_dim}) "
                         f"takes cluster {' or '.join(map(str, sorted(set(clusters))))}, "
                         f"got {cluster}")
    if group is None:
        group = window_group(c, head_dim, windows, cluster) if full and bf16 else 1
    elif not (full and bf16) or group not in window_groups(c, cluster):
        raise ValueError(f"flash_window_block's bf16 LN+MLP kernel at C={c}, cluster {cluster} "
                         f"takes {window_groups(c, cluster)} windows a CTA, got {group}")
    if grid is not None and not (persistent and 1 <= grid <= windows):
        raise ValueError(f"flash_window_block: grid takes the bf16 attention-only kernel's "
                         f"persistent clusters, 1 to {windows} here; got {grid}")
    build.check_inference(x, wqkv, bqkv, wproj, bproj, rel_bias, *(mlp or ()),
                          *((ln_scale, ln_bias) if with_ln else ()))
    build.check_tensor("x", x, (bsz, h, wd, c), x.device, contiguous=True)
    if prepared is None:
        prepared = prepare_window_block(wqkv, bqkv, wproj, bproj, ln_scale, ln_bias, rel_bias,
                                        mlp, head_dim=head_dim, compute_dtype=compute_dtype)
    t = window * window
    if (len(prepared) != (13 if full else 5) or prepared[0].device != x.device
            or prepared[0].dtype != compute_dtype
            or prepared[6 if full else 4].shape != (c // head_dim, t, t)):
        raise ValueError(f"prepared: expected prepare_window_block's weights for this flavour, "
                         f"C={c}, head_dim {head_dim}, {t} tokens and {compute_dtype}, on "
                         f"{x.device}")
    out = torch.empty_like(x)
    ptrs = (build.ptr(x), build.ptr(out), *[build.ptr(a) for a in prepared])
    if persistent:
        if grid is None:
            grid = attn_grid(c, head_dim, cluster, windows, x.device)
        rc = _attn_lib().window_attention_block_bf16(*ptrs, bsz, h, wd, c, head_dim, cluster,
                                                     grid, int(shifted), build.stream(x))
    elif bf16:
        rc = _lib(compute_dtype, c).flash_window_block_bf16(
            *ptrs, bsz, h, wd, c, head_dim, cluster, group, int(shifted), build.stream(x))
    else:
        lib = _lib()
        fn = lib.flash_window_block_f32 if full else lib.window_attention_block_f32
        rc = fn(*ptrs, bsz, h, wd, c, head_dim, cluster, int(shifted), build.stream(x))
    if rc != 0:
        raise RuntimeError(f"flash_window_block kernel launch failed: cudaError {rc}")
    if bf16:
        flash_window_block.launches_bf16 += 1
    else:
        flash_window_block.launches += 1
    return out


flash_window_block.launches = 0
flash_window_block.launches_bf16 = 0
