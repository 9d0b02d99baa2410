"""Entropy models under STanH quantization (port of
reslic_tcm_tpu/entropy/stanh_models.py).

* ``StanhGaussianConditional``: the conditional Gaussian likelihood
  integrated over the non-uniform STanH intervals, with the stacked
  per-rate-level quantizer (reference adaptive_gaussian_conditional.py).
* ``StanhEntropyBottleneck``: the factorized learned-CDF chain with STanH
  quantization (reference adaptive_entropy_bottleneck.py), no quantiles.

Coding contract, as in the JAX package: symbols are level indexes (offset
0), each CDF row integrates the model's pmf over the STanH levels, and the
tables are built on the host with numpy and scipy from the same derived
state (``stanh.np_state``), so they are bit-identical to the JAX
package's. Modules take NCHW tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.special
import torch
from torch import nn

from ..ops.math import lower_bound, standardized_cumulative
from . import stanh as sq
from .factorized import CodingTables, EntropyBottleneck, _np_logits_cumulative, _sigmoid


def stanh_gaussian_likelihood(values, scales, state: sq.StanhState, means=None,
                              scale_bound: float = 0.11, likelihood_bound: float = 1e-9):
    """P(level bin of v | sigma) under non-uniform intervals
    (reference adaptive_gaussian_conditional.py:541-580)."""
    v = values - means if means is not None else values
    v0, v1 = sq.interval_bounds(v, state)
    s = lower_bound(scales, scale_bound)
    pos = v >= 0
    upper = torch.where(pos, standardized_cumulative((v0 - v) / s),
                        standardized_cumulative((v + v1) / s))
    lower = torch.where(pos, standardized_cumulative((-v1 - v) / s),
                        standardized_cumulative((v - v0) / s))
    lik = upper - lower
    if likelihood_bound > 0:
        lik = lower_bound(lik, likelihood_bound)
    return lik


class StanhGaussianConditional(nn.Module):
    """Per-rate-level STanH Gaussian conditional (reference
    adaptive_gaussian_conditional.py:312-617). Training soft-quantizes
    ``values`` (``values - means`` only with ``removing_mean``) and takes
    the likelihood around the means; eval hard-quantizes ``values - means``
    and adds the means back."""

    def __init__(self, n_rates: int = 1, num_sigmoids=0, extrema=5, symmetric: bool = False,
                 trainable: bool = True, removing_mean: bool = False,
                 scale_bound: float = 0.11, likelihood_bound: float = 1e-9):
        super().__init__()
        self.symmetric, self.removing_mean = symmetric, removing_mean
        self.scale_bound, self.likelihood_bound = scale_bound, likelihood_bound
        self.stanh = sq.StanhQuantizer(n_rates, num_sigmoids, extrema, symmetric, trainable)

    def forward(self, values, scales, means=None, training: bool = True, beta=10.0,
                lv: int = 0):
        state = self.stanh.state(lv)
        if training:
            if means is not None and self.removing_mean:
                y_hat = sq.soft_quantize(values - means, state, beta) + means
            else:
                y_hat = sq.soft_quantize(values, state, beta)
        elif means is not None:
            y_hat = sq.hard_quantize(values - means, state, self.symmetric) + means
        else:
            y_hat = sq.hard_quantize(values, state, self.symmetric)
        lik = stanh_gaussian_likelihood(y_hat, scales, state, means, self.scale_bound,
                                        self.likelihood_bound)
        return y_hat, lik

    def gap(self, values, beta, lv: int):
        state = self.stanh.state(lv)
        return sq.compute_gap(values, sq.soft_quantize(values, state, beta),
                              sq.hard_quantize(values, state, self.symmetric))

    # ------------------------- codec-path helpers -------------------------

    def symbols(self, values, means, lv: int):
        """Level indexes of ``values - means`` (int64)."""
        v = values - means if means is not None else values
        return sq.to_symbols(v, self.stanh.state(lv))

    def dequantize(self, symbols, means, lv: int):
        v = sq.from_symbols(symbols, self.stanh.state(lv))
        return v + means if means is not None else v

    def wb(self, lv: int):
        """Level ``lv``'s (w, b) as float32 numpy arrays."""
        p = self.stanh
        return (p.w[lv].detach().cpu().numpy().astype(np.float32),
                p.b[lv].detach().cpu().numpy().astype(np.float32))


def _cum(x):
    return 0.5 * scipy.special.erfc(-(2 ** -0.5) * np.asarray(x, np.float64))


def _quantized_rows(pmf: np.ndarray, tail: np.ndarray) -> CodingTables:
    """One 16-bit CDF row per pmf row, the tail mass as its last bin."""
    from ..coding.rans import pmf_to_quantized_cdf

    k, n_levels = pmf.shape
    cdf = np.zeros((k, n_levels + 2), np.int32)
    for i in range(k):
        q = pmf_to_quantized_cdf(np.concatenate([pmf[i], tail[i]], axis=0), 16)
        cdf[i, : q.shape[0]] = q
    return CodingTables(quantized_cdf=cdf, cdf_length=np.full(k, n_levels + 2, np.int32),
                        offset=np.zeros(k, np.int32))


def build_stanh_scale_tables(w: np.ndarray, b: np.ndarray, symmetric: bool,
                             scale_table: np.ndarray) -> CodingTables:
    """Per-scale-index CDF rows over the STanH levels (reference
    adaptive_gaussian_conditional.py:397-455, offset 0, symbols = level
    indexes)."""
    state = sq.np_state(w, b, symmetric)
    samples = state.cum_w[None, :].astype(np.float32)  # [1, L]
    v0 = state.distance_left[None, :].astype(np.float32)
    v1 = state.distance_right[None, :].astype(np.float32)
    s = np.asarray(scale_table, np.float32)[:, None]  # [K, 1]
    pos = samples >= 0
    upper = np.where(pos, _cum((v0 - samples) / s), _cum((samples + v1) / s))
    lower = np.where(pos, _cum((-v1 - samples) / s), _cum((samples - v0) / s))
    pmf = np.maximum(upper - lower, 0.0)
    tail = np.maximum(2 * lower[:, :1], 1e-12)
    return _quantized_rows(pmf, tail)


class StanhEntropyBottleneck(nn.Module):
    """Factorized prior with STanH quantization (reference
    adaptive_entropy_bottleneck.py:299-708): the chain parameters carry
    CompressAI's names (``_matrix{i}``, ``_bias{i}``, ``_factor{i}``); no
    quantiles and no aux loss, the STanH levels bound the support. It
    quantizes with level 0's staircase whatever the rate level, as the JAX
    module does."""

    def __init__(self, channels: int, n_rates: int = 1, num_sigmoids=0, extrema=5,
                 symmetric: bool = False, trainable: bool = True,
                 filters: Tuple[int, ...] = (3, 3, 3, 3), init_scale: float = 10.0,
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.filters = tuple(filters)
        self.symmetric = symmetric
        self.likelihood_bound = likelihood_bound
        f = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1 / scale / f[i + 1]))
            self.register_parameter(
                f"_matrix{i}", nn.Parameter(torch.full((channels, f[i + 1], f[i]), init)))
            self.register_parameter(
                f"_bias{i}", nn.Parameter(torch.rand(channels, f[i + 1], 1) - 0.5))
            if i < len(self.filters):
                self.register_parameter(
                    f"_factor{i}", nn.Parameter(torch.zeros(channels, f[i + 1], 1)))
        self.stanh = sq.StanhQuantizer(n_rates, num_sigmoids, extrema, symmetric, trainable)

    _logits_cumulative = EntropyBottleneck._logits_cumulative

    def chain_params(self) -> dict:
        """The chain as float32 numpy arrays keyed like the JAX parameter
        tree (matrix0, bias0, factor0, ...)."""
        return {name.lstrip("_"): p.detach().cpu().numpy().astype(np.float32)
                for name, p in self.named_parameters(recurse=False)}

    def _likelihood(self, values):
        """values: [C, 1, n]. The interval likelihood at absolute positions
        (reference adaptive_entropy_bottleneck.py:551-666)."""
        v0d, v1d = sq.interval_bounds(values, self.stanh.state(0))
        lower = self._logits_cumulative(values - v0d)
        upper = self._logits_cumulative(values + v1d)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    @staticmethod
    def _values(x):
        b, c, h, w = x.shape
        return x.permute(1, 0, 2, 3).reshape(c, 1, -1)

    def forward(self, x, training: bool = True, beta=10.0, lv: int = 0):
        """x: NCHW -> (x_hat, likelihoods), both NCHW."""
        b, c, h, w = x.shape
        values = self._values(x)
        state = self.stanh.state(0)
        if training:
            v_hat = sq.soft_quantize(values, state, beta)
        else:
            v_hat = sq.hard_quantize(values, state, self.symmetric)
        lik = self._likelihood(v_hat)
        if self.likelihood_bound > 0:
            lik = lower_bound(lik, self.likelihood_bound)
        v_hat = v_hat.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return v_hat, lik.reshape(c, b, h, w).permute(1, 0, 2, 3)

    def gap(self, x, beta):
        values = self._values(x)
        state = self.stanh.state(0)
        return sq.compute_gap(values, sq.soft_quantize(values, state, beta),
                              sq.hard_quantize(values, state, self.symmetric))

    def aux_loss(self) -> torch.Tensor:
        return self._matrix0.new_zeros(())


def build_stanh_factorized_tables(chain_params: dict, w: np.ndarray, b: np.ndarray,
                                  symmetric: bool,
                                  filters: Tuple[int, ...] = (3, 3, 3, 3)) -> CodingTables:
    """Per-channel CDF rows over the STanH levels through the learned chain
    (reference adaptive_entropy_bottleneck.py:481-514)."""
    state = sq.np_state(w, b, symmetric)
    channels = np.asarray(chain_params["matrix0"]).shape[0]
    lvl = state.cum_w.astype(np.float32)  # [L]
    samples = np.tile(lvl[None, None, :], (channels, 1, 1))  # [C, 1, L]
    v0 = samples - state.distance_left[None, None, :]
    v1 = samples + state.distance_right[None, None, :]
    lower = _np_logits_cumulative(chain_params, filters, v0)
    upper = _np_logits_cumulative(chain_params, filters, v1)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]
    # the mass outside the level range (below the first, above the last interval)
    tail = np.maximum(_sigmoid(lower[:, 0, :1]) + _sigmoid(-upper[:, 0, -1:]), 1e-12)
    return _quantized_rows(pmf, tail)
