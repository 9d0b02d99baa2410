"""Gain-unit variable-rate codecs (port of reslic_tcm_tpu/models/gain/gained.py,
after Cui et al., "Asymmetric Gained Deep Image Compression with Continuous
Rate Adaptation").

Each rate level has four channel gain vectors: ``Gain`` and ``InverseGain``
on y ([levels, M]), ``HyperGain`` and ``InverseHyperGain`` on z ([levels,
N]), applied as |G[lv]| channel by channel. Between two levels the codec
interpolates, geometrically |G[s]|^(1-l) |G[s+1]|^l or linearly, on both
sides of the channel.

  GainedScaleHyperprior: the Balle-2018 scale hyperprior with gains; unlike
    the plain one, h_a takes y (not |y|), and its h_s ends in a ReLU.
  GainedMSHyperprior: the mean-scale variant; the eval y_hat is
    round(y - mu) + mu (the scale variant's is round(y)).
  GainedWACNN: WACNN through ChannelARModule's gain hooks; its codec is the
    channel-AR codec at discrete levels only.
  GainedHyperpriorCodec: compress(x, s, l) / decompress(strings, shape, s,
    l) at level s interpolated a share l towards level s + 1.

Modules are NCHW; the codecs' public tensors NHWC. The gain parameters
start at ones, or with ``gain_init_spread`` > 1 on a geometric ladder over
the y gains (level 0 scaled by 1/spread, the top level by spread), the JAX
package's option.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...entropy import factorized as fz
from ...ops.layers import to_nchw, to_nhwc
from ...ops.math import gaussian_likelihood
from ..balle2018 import HyperpriorCodec, MeanScaleHyperprior, ScaleHyperprior
from ..base import ChannelARCodec, codec_pass
from ..wacnn import WACNN, draw_weights


def interpolate_gain(g_lo, g_hi, l: float, mode: str = "geometric"):
    """|g_lo| and |g_hi| mixed a share ``l`` towards g_hi: geometrically
    (the paper's exponential interpolation) or linearly."""
    g_lo, g_hi = torch.abs(g_lo), torch.abs(g_hi)
    if mode == "linear":
        return g_lo * (1 - l) + g_hi * l
    return g_lo ** (1 - l) * g_hi ** l


def gain_ladder(levels: int, channels: int, spread: float) -> np.ndarray | None:
    """The y gains' initial [levels, channels] geometric ladder from
    1/spread to spread, or None (start at ones) unless spread > 1 and
    there are several levels."""
    if not (spread > 1.0 and levels > 1):
        return None
    expo = 2.0 * np.arange(levels, dtype=np.float32) / (levels - 1) - 1.0
    return np.repeat((spread ** expo)[:, None], channels, axis=1)


# the gain matrices in the order the rate-distortion forward applies them
GAIN_NAMES = ("Gain", "HyperGain", "InverseHyperGain", "InverseGain")


def scaled(t: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """NCHW ``t`` times a per-channel vector."""
    return t * gain[None, :, None, None]


class _Gains:
    """The four gain matrices (``Gain``, ``InverseGain``: [levels, M];
    ``HyperGain``, ``InverseHyperGain``: [levels, N])."""

    def _make_gains(self, levels: int, M: int, N: int, spread: float = 0.0) -> None:
        self.levels = levels
        g = gain_ladder(levels, M, float(spread or 0.0))
        if g is None:
            g = np.ones((levels, M), np.float32)
        self.Gain = nn.Parameter(torch.from_numpy(g.copy()))
        self.InverseGain = nn.Parameter(torch.from_numpy(1.0 / g))
        self.HyperGain = nn.Parameter(torch.ones(levels, N))
        self.InverseHyperGain = nn.Parameter(torch.ones(levels, N))


class _GainedHyperprior(_Gains):
    """The gained rate-distortion forward and the codec's device pieces, on
    a Balle-2018 hyperprior (g_a, h_a, h_s, g_s, the entropy bottleneck)."""

    def __init__(self, N: int = 192, M: int = 320, levels: int = 1,
                 gain_init_spread: float = 0.0):
        super().__init__(N, M)
        self._make_gains(levels, M, N, gain_init_spread)

    def level_gains(self, lv: int) -> tuple:
        """(|Gain|, |HyperGain|, |InverseHyperGain|, |InverseGain|) of level lv."""
        return tuple(torch.abs(getattr(self, n)[lv]) for n in GAIN_NAMES)

    def forward(self, x, training: bool = False, noise=None, lv: int = 0, gains=None):
        """Rate-distortion forward (NCHW) at level ``lv``, or with ``gains``
        (``level_gains``' four vectors, e.g. interpolated): with
        ``training`` z and y take U(-0.5, 0.5) from ``noise(shape)`` (z
        first, as the JAX module draws them)."""
        gain, hyper_gain, inv_hyper, inv_gain = gains or self.level_gains(lv)
        y = scaled(self.g_a(x), gain)
        z = scaled(self.h_a(y), hyper_gain)
        eb = self.entropy_bottleneck
        z_hat, z_lik = eb(z, training=training,
                          noise=noise(eb.noise_shape(z)) if training else None)
        scales, means = self.gaussian_params(scaled(z_hat, inv_hyper))
        if training:
            y_hat = y + noise(y.shape)
        elif means is None:
            y_hat = torch.round(y)
        else:
            y_hat = torch.round(y - means) + means
        y_lik = gaussian_likelihood(y_hat, scales, means)
        y_hat = scaled(y_hat, inv_gain)
        return {"y": y, "y_hat": y_hat, "x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_lik, "z": z_lik}}

    def analyze_gained(self, x, gain, hyper_gain):
        """(y, z) with the given (already |.|) gain vectors."""
        y = scaled(self.g_a(x), gain)
        return y, scaled(self.h_a(y), hyper_gain)

    def synthesize_gained(self, y_hat, inv_gain):
        return torch.clamp(self.g_s(scaled(y_hat, inv_gain)), 0.0, 1.0)


class GainedScaleHyperprior(_GainedHyperprior, ScaleHyperprior):
    """The scale hyperprior with gain units; h_a takes y."""

    def hyper_input(self, y):
        return y


class GainedMSHyperprior(_GainedHyperprior, MeanScaleHyperprior):
    """The mean-scale hyperprior with gain units."""


class GainedWACNN(_Gains, WACNN):
    """WACNN with gain units around the slice loop, through the
    ChannelARModule gain hooks."""

    def __init__(self, N: int = 192, M: int = 320, levels: int = 1,
                 gain_init_spread: float = 0.0, **wacnn):
        super().__init__(N=N, M=M, **wacnn)
        self._make_gains(levels, M, N, gain_init_spread)

    def gain_y(self, y, lv: int):
        return scaled(y, torch.abs(self.Gain[lv]))

    def gain_z(self, z, lv: int):
        return scaled(z, torch.abs(self.HyperGain[lv]))

    def inv_gain_z(self, z_hat, lv: int):
        return scaled(z_hat, torch.abs(self.InverseHyperGain[lv]))

    def inv_gain_y(self, y_hat, lv: int):
        return scaled(y_hat, torch.abs(self.InverseGain[lv]))


class GainedHyperpriorCodec(HyperpriorCodec):
    """A gained hyperprior on a device plus the host rANS coder:
    compress(x, s, l) and decompress(strings, shape, s, l) code at level s
    interpolated a share l towards s + 1 (``interp``: "geometric" or
    "linear"). The y_hat both return is the coded, gained latent (NHWC)."""

    def __init__(self, module, device, interp: str = "geometric"):
        super().__init__(module, device)
        self.interp = interp

    def _gains(self, name: str, s: int, l: float) -> torch.Tensor:
        """|G[s]| interpolated a share l towards |G[s + 1]|; |G[s]| alone at
        the last level."""
        g = getattr(self.module, name).detach()
        last = g.shape[0] - 1
        if s == last:
            return torch.abs(g[s])
        return interpolate_gain(g[s], g[min(s + 1, last)], l, self.interp)

    @torch.no_grad()
    @codec_pass
    def forward(self, x, lv: int = 0, l: float = 0.0) -> dict:
        """Eval forward (bpp estimate) of NHWC images at level ``lv``, or
        with ``l`` > 0 at ``compress``'s gains for (s=lv, l)."""
        gains = tuple(self._gains(n, lv, l) for n in GAIN_NAMES) if l else None
        out = self.module(self._input(x), lv=lv, gains=gains)
        return {"x_hat": to_nhwc(out["x_hat"]),
                "likelihoods": {k: to_nhwc(v) for k, v in out["likelihoods"].items()}}

    def _code(self, y, z, inv_hyper) -> dict:
        """The streams of NCHW y and z: z through the factorized tables, y
        through the Gaussian conditional with the parameters of z_hat
        times the inverse hyper gain, what the decoder computes."""
        z_np = z.cpu().numpy()
        z_strings = fz.compress(z_np, self._medians, self.eb_tables)
        med = self._medians.reshape(1, -1, 1, 1)
        gc = self.gaussian_conditional
        z_hat = gc.dequantize(gc.quantize(z_np, med), med)
        indexes, means = self._gaussian_params(
            scaled(torch.from_numpy(z_hat).to(self.device), inv_hyper))
        y_nhwc = to_nhwc(y).cpu().numpy()
        y_hat = gc.dequantize(gc.quantize(y_nhwc, means), means)
        return {"strings": [gc.compress(y_nhwc, indexes, means), z_strings],
                "shape": (z.shape[2], z.shape[3]),
                "y_hat": torch.from_numpy(y_hat).to(self.device)}

    def _decode(self, strings, shape, inv_hyper):
        """(y_hat NCHW, z_hat times the inverse hyper gain) of ``_code``'s
        streams."""
        z_hat = fz.decompress(strings[1], shape, self._medians, self.eb_tables)
        z_scaled = scaled(torch.from_numpy(z_hat).to(self.device), inv_hyper)
        indexes, means = self._gaussian_params(z_scaled)
        y_hat = self.gaussian_conditional.decompress(strings[0], indexes, means)
        return to_nchw(torch.from_numpy(y_hat).to(self.device)), z_scaled

    @torch.no_grad()
    @codec_pass
    def compress(self, x, s: int = 0, l: float = 0.0) -> dict:
        """x: NHWC in [0, 1]. Returns {"strings": [y strings, z strings],
        "shape": z's (h, w), "y_hat": the coded latent (NHWC)}."""
        self._require_tables()
        y, z = self.module.analyze_gained(self._input(x), self._gains("Gain", s, l),
                                          self._gains("HyperGain", s, l))
        return self._code(y, z, self._gains("InverseHyperGain", s, l))

    @torch.no_grad()
    @codec_pass
    def decompress(self, strings, shape, s: int = 0, l: float = 0.0) -> dict:
        """Returns {"x_hat": NHWC in [0, 1], "y_hat": NHWC}."""
        self._require_tables()
        y_hat, _ = self._decode(strings, shape, self._gains("InverseHyperGain", s, l))
        x_hat = self.module.synthesize_gained(y_hat, self._gains("InverseGain", s, l))
        return {"x_hat": to_nhwc(x_hat), "y_hat": to_nhwc(y_hat)}


def _seeded(module: nn.Module, seed: int) -> nn.Module:
    draw_weights(module, torch.Generator().manual_seed(seed))
    return module


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def make_gained_hyperprior(kind: str = "scale", N: int = 192, M: int = 320,
                           lmbda_list: Sequence[float] = (0.043,), device="cuda", seed: int = 0,
                           gain_init_spread: float = 0.0) -> GainedHyperpriorCodec:
    """A gained hyperprior codec (``kind``: scale or mean-scale), one level
    per lambda, with random weights drawn as wacnn.py's ``draw_weights``
    (load trained ones with ``utils.torch_convert``)."""
    device = _check_device(device)
    cls = {"scale": GainedScaleHyperprior, "mean-scale": GainedMSHyperprior}[kind]
    with torch.random.fork_rng(devices=[]):  # leave the caller's global RNG as it was
        module = cls(N=N, M=M, levels=len(lmbda_list), gain_init_spread=gain_init_spread)
    return GainedHyperpriorCodec(_seeded(module, seed), device)


def make_gained_wacnn(N: int = 192, M: int = 320, lmbda_list: Sequence[float] = (0.05,),
                      device="cuda", seed: int = 0, gain_init_spread: float = 0.0,
                      **ladders) -> ChannelARCodec:
    """A gained WACNN codec, one level per lambda (discrete levels only),
    with random weights; ``ladders`` as ``make_wacnn``'s."""
    device = _check_device(device)
    with torch.random.fork_rng(devices=[]):
        module = GainedWACNN(N=N, M=M, levels=len(lmbda_list),
                             gain_init_spread=gain_init_spread, **ladders)
    return ChannelARCodec(_seeded(module, seed), device)
