"""Spatial-channel gained hyperprior (port of reslic_tcm_tpu/models/gain/sc.py).

The channel gain vectors of gained.py plus a spatial modulation from a
quality map: SFT blocks (x * (1 + gamma(q)) + beta(q)) between the split
analysis and synthesis stages, fed on the encoder by features of the
quality map and on the decoder by features generated from z_hat. The
codec takes the quality map as an NHWC [B, H, W, 1] array:
compress(x, qmap, s, l), decompress(strings, shape, s, l). Modules are NCHW.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...entropy.factorized import EntropyBottleneck
from ...ops.layers import GDN, Deconv, conv, to_nhwc
from ...ops.math import gaussian_likelihood
from ..base import codec_pass
from .gained import GainedHyperpriorCodec, _check_device, _Gains, _seeded, scaled


def leaky01(x):
    return F.leaky_relu(x, negative_slope=0.1)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of jax.image.resize's "linear" method along
    one axis (triangle kernel, widened when shrinking, each column
    normalised), computed in float32 as JAX computes them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def adaptive_avg_pool(x, out_hw):
    """NCHW ``x`` pooled to ``out_hw``: the mean of each block where the
    ratio is an integer (the only case this architecture produces), else
    jax.image.resize's linear resize."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        return F.avg_pool2d(x, (h // oh, w // ow))
    out = x
    # fp32 in the bf16 mode too: jax.image.resize contracts at
    # Precision.HIGHEST, which the codec's default precision does not lower
    if h != oh:
        out = torch.einsum("bchw,hH->bcHw", out,
                           torch.from_numpy(_resize_weights(h, oh)).to(x.device))
    if w != ow:
        out = torch.einsum("bchw,wW->bchW", out,
                           torch.from_numpy(_resize_weights(w, ow)).to(x.device))
    return out


class SFT(nn.Module):
    """x * (1 + gamma(q)) + beta(q), q the quality features pooled to x's
    size (spatial feature transform)."""

    def __init__(self, x_ch: int, q_ch: int, ks: int = 3, nhidden: int = 128):
        super().__init__()
        self.mlp_shared = conv(q_ch, nhidden, ks)
        self.mlp_gamma = conv(nhidden, x_ch, ks)
        self.mlp_beta = conv(nhidden, x_ch, ks)

    def forward(self, x, qmap):
        actv = torch.relu(self.mlp_shared(adaptive_avg_pool(qmap, x.shape[2:])))
        return x * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


def _lk():
    return nn.LeakyReLU(0.1)


def _down(N: int) -> nn.Sequential:
    return nn.Sequential(conv(N, N, 3, 2), _lk(), conv(N, N, 1))


def _up(N: int) -> nn.Sequential:
    return nn.Sequential(Deconv(N, N, 3, 2), _lk(), conv(N, N, 1))


class SCGainedHyperprior(_Gains, nn.Module):
    """Spatial-channel gained hyperprior: g_a in four stages with SFT after
    the first three, g_s in four stages with SFT before each, h_a/h_s of the
    mean-scale hyperprior's shape with sigma alone out of h_s."""

    def __init__(self, N: int = 192, M: int = 320, levels: int = 1):
        super().__init__()
        self.N, self.M = N, M
        self.qmap_feature_ga0 = nn.Sequential(conv(4, N * 2, 3), _lk(), conv(N * 2, N, 3), _lk(),
                                              conv(N, N, 3))
        for i in (1, 2, 3):
            self.add_module(f"qmap_feature_ga{i}", _down(N))
            self.add_module(f"ga_SFT{i}", SFT(N, N))
        self.g_a1 = nn.Sequential(conv(3, N, 5, 2), GDN(N))
        self.g_a2 = nn.Sequential(conv(N, N, 5, 2), GDN(N))
        self.g_a3 = nn.Sequential(conv(N, N, 5, 2), GDN(N))
        self.g_a4 = nn.Sequential(conv(N, M, 5, 2))

        self.qmap_feature_generation = nn.Sequential(
            Deconv(N, N // 2, 3, 2), _lk(), Deconv(N // 2, N // 4, 5, 2), _lk(),
            conv(N // 4, N // 4, 3))
        self.qmap_feature_gs0 = nn.Sequential(
            conv(N // 4 + M, N * 4, 3), _lk(), conv(N * 4, N * 2, 3), _lk(), conv(N * 2, N, 3))
        for i in (1, 2, 3):
            self.add_module(f"qmap_feature_gs{i}", _up(N))
        self.gs_SFT0 = SFT(M, N)
        for i in (1, 2, 3):
            self.add_module(f"gs_SFT{i}", SFT(N, N))
        self.g_s1 = nn.Sequential(Deconv(M, N, 5, 2), GDN(N, inverse=True))
        self.g_s2 = nn.Sequential(Deconv(N, N, 5, 2), GDN(N, inverse=True))
        self.g_s3 = nn.Sequential(Deconv(N, N, 5, 2), GDN(N, inverse=True))
        self.g_s4 = nn.Sequential(Deconv(N, 3, 5, 2))

        self.h_a = nn.Sequential(conv(M, N, 3), nn.LeakyReLU(0.01), conv(N, N, 5, 2),
                                 nn.LeakyReLU(0.01), conv(N, N, 5, 2))
        self.h_s = nn.Sequential(Deconv(N, M, 5, 2), nn.LeakyReLU(0.01),
                                 Deconv(M, M * 3 // 2, 5, 2), nn.LeakyReLU(0.01),
                                 conv(M * 3 // 2, M, 3))
        self.entropy_bottleneck = EntropyBottleneck(N)
        self._make_gains(levels, M, N)

    def g_a(self, x, qmap):
        """Analysis modulated by the quality map's features."""
        q = self.qmap_feature_ga1(self.qmap_feature_ga0(torch.cat([qmap, x], dim=1)))
        x = self.ga_SFT1(self.g_a1(x), q)
        q = self.qmap_feature_ga2(q)
        x = self.ga_SFT2(self.g_a2(x), q)
        q = self.qmap_feature_ga3(q)
        x = self.ga_SFT3(self.g_a3(x), q)
        return self.g_a4(x)

    def g_s(self, x, z_hat):
        """Synthesis modulated by features generated from z_hat."""
        w = self.qmap_feature_gs0(torch.cat([self.qmap_feature_generation(z_hat), x], dim=1))
        x = self.gs_SFT0(x, w)
        for i in (1, 2, 3):
            w = getattr(self, f"qmap_feature_gs{i}")(w)
            x = getattr(self, f"gs_SFT{i}")(getattr(self, f"g_s{i}")(x), w)
        return self.g_s4(x)

    def gaussian_params(self, z_hat):
        """(scales, no means)."""
        return self.h_s(z_hat), None

    def forward(self, x, qmap, training: bool = False, noise=None, lv: int = 0):
        """Rate-distortion forward (NCHW x, qmap [B, 1, H, W]) at level lv;
        with ``training`` z and y take U(-0.5, 0.5) from ``noise(shape)``."""
        y = scaled(self.g_a(x, qmap), torch.abs(self.Gain[lv]))
        z = scaled(self.h_a(y), torch.abs(self.HyperGain[lv]))
        eb = self.entropy_bottleneck
        z_hat, z_lik = eb(z, training=training,
                          noise=noise(eb.noise_shape(z)) if training else None)
        z_hat = scaled(z_hat, torch.abs(self.InverseHyperGain[lv]))
        scales = self.h_s(z_hat)
        y_hat = y + noise(y.shape) if training else torch.round(y)
        y_lik = gaussian_likelihood(y_hat, scales, None)
        y_hat = scaled(y_hat, torch.abs(self.InverseGain[lv]))
        return {"y": y, "y_hat": y_hat, "x_hat": self.g_s(y_hat, z_hat),
                "likelihoods": {"y": y_lik, "z": z_lik}}

    def analyze_gained(self, x, qmap, gain, hyper_gain):
        y = scaled(self.g_a(x, qmap), gain)
        return y, scaled(self.h_a(y), hyper_gain)

    def synthesize_gained(self, y_hat, z_hat_scaled, inv_gain):
        return torch.clamp(self.g_s(scaled(y_hat, inv_gain), z_hat_scaled), 0.0, 1.0)

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()


class SCGainedCodec(GainedHyperpriorCodec):
    """compress(x, qmap, s, l) / decompress(strings, shape, s, l); qmap an
    NHWC [B, H, W, 1] array, x NHWC."""

    @torch.no_grad()
    @codec_pass
    def forward(self, x, qmap, lv: int = 0) -> dict:
        out = self.module(self._input(x), self._input(qmap), lv=lv)
        return {"x_hat": to_nhwc(out["x_hat"]),
                "likelihoods": {k: to_nhwc(v) for k, v in out["likelihoods"].items()}}

    @torch.no_grad()
    @codec_pass
    def compress(self, x, qmap, s: int = 0, l: float = 0.0) -> dict:
        self._require_tables()
        y, z = self.module.analyze_gained(self._input(x), self._input(qmap),
                                          self._gains("Gain", s, l),
                                          self._gains("HyperGain", s, l))
        return self._code(y, z, self._gains("InverseHyperGain", s, l))

    @torch.no_grad()
    @codec_pass
    def decompress(self, strings, shape, s: int = 0, l: float = 0.0) -> dict:
        self._require_tables()
        y_hat, z_scaled = self._decode(strings, shape, self._gains("InverseHyperGain", s, l))
        x_hat = self.module.synthesize_gained(y_hat, z_scaled, self._gains("InverseGain", s, l))
        return {"x_hat": to_nhwc(x_hat), "y_hat": to_nhwc(y_hat)}


def make_sc_gained(N: int = 192, M: int = 320, lmbda_list: Sequence[float] = (0.043,),
                   device="cuda", seed: int = 0) -> SCGainedCodec:
    """An SC gained codec, one level per lambda, with random weights."""
    device = _check_device(device)
    with torch.random.fork_rng(devices=[]):
        module = SCGainedHyperprior(N=N, M=M, levels=len(lmbda_list))
    return SCGainedCodec(_seeded(module, seed), device)
