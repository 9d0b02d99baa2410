"""Layer library (port of reslic_tcm_tpu/ops/layers.py), NCHW.

Module and parameter names follow the reference PyTorch state dict
(CompressAI's layers): OIHW convolutions, ``[out, in]`` linears, GDN's
``beta``/``gamma``. ResidualBlock, ResidualBlockWithStride and
ResidualBlockUpsample reach the fused-conv kernels (``ops/fused_conv.py``)
through their wrappers, which run the kernel on a CUDA tensor and the plain
PyTorch version on a CPU tensor.

Routing, for these blocks and the window-attention modules (``composed``):
while autograd records (``records_grad``: grad mode on and a parameter
that wants a gradient), or inside ``plain_versions()``, a module takes its
composed branch, the JAX package's unfused layers, on either device;
otherwise it calls the kernel wrapper. The kernels have no backward, and
their wrappers raise on tensors that want a gradient, so a routing mistake
fails loudly.

Matmul precision (the JAX package's ``jax.default_matmul_precision``, which
its codec enters around every compiled pass): inside
``matmul_precision("bfloat16")`` (per thread, a context variable) the
kernel layers hand ``compute_dtype=torch.bfloat16`` to their wrappers, and
the composed convolutions and linears (``Conv2d``, ``Linear``, which the
``conv*`` helpers build, ``Deconv`` and ``StackedConv1x1``; the state-dict
names are nn.Conv2d's, nn.Linear's and nn.ConvTranspose2d's) take bf16
operands and accumulate in fp32. Activations between layers stay fp32.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading

import torch
import torch.nn.functional as F
from torch import nn

from .fused_conv import (fused_conv_gdn, fused_residual_block, prepare_conv_gdn,
                         prepare_residual_block)
from .math import lower_bound


def gelu(x):
    """Exact erf GELU (torch's default, as the reference uses)."""
    return F.gelu(x)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.01)


def records_grad(module: nn.Module) -> bool:
    """True while autograd records through ``module``: grad mode is on and
    one of its parameters wants a gradient (the composed branch's cue)."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters())


_PLAIN_VERSIONS = contextvars.ContextVar("plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Inside this block every kernel layer takes its composed branch on
    either device: on the card, the plain versions of B1-B4 that a kernel
    run is held against. Per thread (a context variable)."""
    token = _PLAIN_VERSIONS.set(True)
    try:
        yield
    finally:
        _PLAIN_VERSIONS.reset(token)


def composed(module: nn.Module) -> bool:
    """The routing rule: the composed branch while autograd records through
    ``module`` or inside ``plain_versions()``, else the kernel wrapper."""
    return _PLAIN_VERSIONS.get() or records_grad(module)


PRECISIONS = (None, "bfloat16")
_MATMUL_PRECISION = contextvars.ContextVar("matmul_precision", default=None)


@contextlib.contextmanager
def matmul_precision(precision: str | None):
    """Inside this block the products and convolutions run at
    ``precision``: None (full fp32) or "bfloat16" (bf16 operands, fp32
    sums). Per thread (a context variable)."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul precision {precision!r}: expected one of {PRECISIONS}")
    token = _MATMUL_PRECISION.set(precision)
    try:
        yield
    finally:
        _MATMUL_PRECISION.reset(token)


def matmul_precision_in_use() -> str | None:
    """The precision ``matmul_precision`` set in this thread's context (None:
    fp32). A recompute that autograd runs in its own thread re-enters it
    (models/tcm.py's remat)."""
    return _MATMUL_PRECISION.get()


def compute_dtype() -> torch.dtype:
    """The products' operand type here: torch.bfloat16 inside
    ``matmul_precision("bfloat16")``, else torch.float32."""
    return torch.bfloat16 if _MATMUL_PRECISION.get() == "bfloat16" else torch.float32


_cache_lock = threading.Lock()


def cached(owner: nn.Module, name: str, sources, make):
    """``make()``, built once for ``owner`` under ``name`` and returned again
    while every tensor of ``sources`` keeps its ``data_ptr()`` and
    ``_version``: an in-place update (``load_snapshot_into``, an optimiser
    step), a move to another device or a swapped tensor builds it anew. The
    entry holds the sources, so no address it was keyed on is reused while
    it lives. With autograd recording and a source that wants a gradient it
    is built afresh on every call, so the plain path sees the live
    parameters. Threads fill an entry one at a time (the pipelined codec
    runs passes in several threads). Entries of another compute type take
    another ``name``, so a layer never reads the other mode's weights."""
    sources = tuple(sources)
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()
    stamp = tuple((t.data_ptr(), t._version) for t in sources)
    with _cache_lock:
        store = owner.__dict__.setdefault("_prepared", {})
        hit = store.get(name)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, sources, make())
            store[name] = hit
    return hit[2]


def _bf16_weight(layer: nn.Module) -> torch.Tensor:
    return cached(layer, "bf16_weight", (layer.weight,), lambda: layer.weight.to(torch.bfloat16))


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters and state-dict names) that follows the
    matmul precision: under bf16 it convolves bf16 operands, cuDNN summing
    in fp32. cuDNN hands back bf16, so the result is rounded once more
    before it returns to fp32 and takes the bias in fp32: that rounding is
    where the port differs from the TPU's single-pass bf16 convolution,
    which keeps the fp32 sum. (PyTorch's bf16 convolution on the CPU rounds
    its result the same way.)"""

    def forward(self, x):
        if compute_dtype() is torch.float32:
            return super().forward(x)
        out = F.conv2d(x.to(torch.bfloat16), _bf16_weight(self), None, self.stride,
                       self.padding, self.dilation, self.groups).float()
        return out if self.bias is None else out + self.bias[:, None, None]


class Linear(nn.Linear):
    """nn.Linear (same parameters and state-dict names) that follows the
    matmul precision: under bf16 an fp32 input is multiplied as bf16 with
    fp32 sums, the result rounded to bf16 by cuBLAS (as ``Conv2d``) and
    returned in fp32 plus the fp32 bias. A bf16 input (the body of the
    composed window attention, which the JAX package runs in bf16) gives a
    bf16 result with the bias rounded to bf16, as the JAX package's bf16
    Dense does."""

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return F.linear(x, _bf16_weight(self), self.bias.to(torch.bfloat16))
        if compute_dtype() is torch.float32:
            return super().forward(x)
        return F.linear(x.to(torch.bfloat16), _bf16_weight(self)).float() + self.bias


class DropPath(nn.Module):
    """Per-sample stochastic depth, as the JAX package's DropPath is called:
    its one caller, SwinTransformerBlock, sits in the transforms'
    Sequentials, which pass only x, so ``deterministic`` keeps its default
    and drop-path is the identity at any rate. The module keeps ``rate``
    for the schedule's names; its random branch is not ported, since
    neither package draws it."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return x


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 1) -> nn.Conv2d:
    """Conv2d with torch-style symmetric padding k//2."""
    return Conv2d(in_ch, out_ch, kernel_size, stride, padding=kernel_size // 2)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    return conv(in_ch, out_ch, 3, stride)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    return conv(in_ch, out_ch, 1, stride)


def subpel_conv3x3(in_ch: int, out_ch: int, r: int = 1) -> nn.Sequential:
    """3x3 conv + pixel shuffle (CompressAI's subpel_conv3x3)."""
    return nn.Sequential(conv3x3(in_ch, out_ch * r * r), nn.PixelShuffle(r))


class Deconv(nn.ConvTranspose2d):
    """ConvTranspose2d(k, stride s, padding k//2, output_padding s-1): H and W
    grow by exactly s. IOHW weight; the bridge turns the JAX package's
    input-dilated HWIO kernel into it. Follows the matmul precision as
    ``Conv2d`` does: under bf16 bf16 operands with cuDNN's fp32 sums, the
    result rounded once to bf16 by cuDNN (where the TPU's single pass keeps
    the fp32 sum), back in fp32 before the fp32 bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding=kernel_size // 2,
                         output_padding=stride - 1)

    def forward(self, x):
        if compute_dtype() is torch.float32:
            return super().forward(x)
        out = F.conv_transpose2d(x.to(torch.bfloat16), _bf16_weight(self), None, self.stride,
                                 self.padding, self.output_padding, self.groups,
                                 self.dilation).float()
        return out + self.bias[:, None, None]


class StackedConv1x1(nn.Module):
    """One 1x1 convolution per rate level, stacked: ``weight`` [n_rates,
    cin, cout] and ``bias`` [n_rates, cout], the JAX package's layout, so
    the bridge copies them as they are; ``forward(x, lv)`` applies level
    ``lv``'s (WACNN-STanH's "convolution" refinement). Under bf16 the
    product takes bf16 operands with fp32 sums, the result rounded to bf16
    and back in fp32 before the fp32 bias, as ``Conv2d`` (the JAX package's
    models/stanh/variants.py:44 runs under the codec's precision)."""

    def __init__(self, n_rates: int, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_rates, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(n_rates, out_ch))

    def forward(self, x, lv: int):
        w = self.weight[lv]
        if compute_dtype() is not torch.float32:
            x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        return torch.einsum("bihw,io->bohw", x, w).float() + self.bias[lv][:, None, None]


_GDN_BETA_MIN = 1e-6
_GDN_GAMMA_INIT = 0.1
_GDN_REPARAM_OFFSET = 2 ** -18


def _gdn_derived(beta_r, gamma_r, beta_min=_GDN_BETA_MIN,
                 reparam_offset=_GDN_REPARAM_OFFSET):
    """Resolve CompressAI's GDN reparametrization: the stored weights are
    sqrt(value + pedestal), recovered with LowerBound and a square."""
    pedestal = reparam_offset ** 2
    beta_bound = (beta_min + pedestal) ** 0.5
    beta = lower_bound(beta_r, beta_bound) ** 2 - pedestal
    gamma = lower_bound(gamma_r, reparam_offset) ** 2 - pedestal
    return beta, gamma


class GDN(nn.Module):
    """Generalized divisive normalization, CompressAI parametrization.
    ``inverse=True`` is IGDN (multiplies by the square root)."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        pedestal = _GDN_REPARAM_OFFSET ** 2
        self.inverse = inverse
        self.beta = nn.Parameter(torch.full((channels,), (1.0 + pedestal) ** 0.5))
        self.gamma = nn.Parameter(
            torch.sqrt(_GDN_GAMMA_INIT * torch.eye(channels) + pedestal))

    def derived(self):
        """(beta, gamma) after the reparametrization; gamma[k, j] weighs
        input channel j's power into output channel k."""
        return _gdn_derived(self.beta, self.gamma)

    def forward(self, x):
        beta, gamma = self.derived()
        if compute_dtype() is torch.float32:
            norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
        else:  # B3's bf16 cast points: x*x and gamma
            norm = F.conv2d((x * x).to(torch.bfloat16), gamma.to(torch.bfloat16)[:, :, None, None])
            norm = norm.float() + beta[:, None, None]
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return x * norm


class ResidualUnit(nn.Module):
    """CompressAI AttentionBlock residual unit: 1x1 -> act -> 3x3 -> act ->
    1x1, residual add, trailing activation: ReLU (TCM's SWAtten) or, with
    ``act=nn.GELU``, exact-erf GELU (WACNN's window-attention blocks)."""

    def __init__(self, n: int, act=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            conv1x1(n, n // 2), act(), conv3x3(n // 2, n // 2), act(),
            conv1x1(n // 2, n),
        )
        self.act = act()

    def forward(self, x):
        return self.act(self.conv(x) + x)


class ResidualBlock(nn.Module):
    """conv3x3 -> lrelu -> conv3x3 -> lrelu + x (CompressAI ResidualBlock
    with in_ch == out_ch, the ConvTransBlock conv branch), as one fused
    kernel (B2) on the card; composed while autograd records."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = conv3x3(channels, channels)
        self.conv2 = conv3x3(channels, channels)

    def forward(self, x):
        if composed(self):
            return leaky_relu(self.conv2(leaky_relu(self.conv1(x)))) + x
        cd = compute_dtype()
        w1, w2 = self.conv1.weight, self.conv2.weight
        prepared = cached(self, f"fused_residual_block_{cd}", (w1, w2),
                          lambda: prepare_residual_block(w1, w2, compute_dtype=cd))
        out = fused_residual_block(
            to_nhwc(x), w1, self.conv1.bias, w2, self.conv2.bias, compute_dtype=cd,
            prepared=prepared,
        )
        return to_nchw(out)


def _conv_gdn(owner: nn.Module, x, conv_layer: nn.Conv2d, gdn: GDN, skip):
    """B3 over NHWC x: ``gdn(conv_layer(x)) + skip`` at the current compute
    type, its weights prepared once per type (``cached``)."""
    cd = compute_dtype()
    beta, gamma = gdn.derived()
    prepared = cached(owner, f"fused_conv_gdn_{cd}", (conv_layer.weight, gdn.gamma),
                      lambda: prepare_conv_gdn(conv_layer.weight, gamma, compute_dtype=cd))
    return fused_conv_gdn(x, conv_layer.weight, conv_layer.bias, gamma, beta, skip,
                          inverse=gdn.inverse, compute_dtype=cd, prepared=prepared)


class ResidualBlockWithStride(nn.Module):
    """conv3x3(stride) -> lrelu -> conv3x3 -> GDN + strided 1x1 skip; the
    conv3x3 -> GDN -> + skip tail runs as one fused kernel (B3)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv1 = conv3x3(in_ch, out_ch, stride)
        self.conv2 = conv3x3(out_ch, out_ch)
        self.gdn = GDN(out_ch)
        self.skip = conv1x1(in_ch, out_ch, stride) if stride != 1 or in_ch != out_ch else None

    def forward(self, x):
        out = leaky_relu(self.conv1(x))
        skip = self.skip(x) if self.skip is not None else x
        if composed(self):
            return self.gdn(self.conv2(out)) + skip
        res = _conv_gdn(self, to_nhwc(out), self.conv2, self.gdn, to_nhwc(skip))
        return to_nchw(res)


class ResidualBlockUpsample(nn.Module):
    """subpel-up -> lrelu -> conv3x3 -> IGDN + subpel-up identity; the
    conv3x3 -> IGDN -> + identity tail runs as one fused kernel (B3)."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2):
        super().__init__()
        self.subpel_conv = subpel_conv3x3(in_ch, out_ch, upsample)
        self.conv = conv3x3(out_ch, out_ch)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = subpel_conv3x3(in_ch, out_ch, upsample)

    def forward(self, x):
        out = leaky_relu(self.subpel_conv(x))
        identity = self.upsample(x)
        if composed(self):
            return self.igdn(self.conv(out)) + identity
        res = _conv_gdn(self, to_nhwc(out), self.conv, self.igdn, to_nhwc(identity))
        return to_nchw(res)
