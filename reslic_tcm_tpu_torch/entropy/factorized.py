"""Factorized-prior entropy bottleneck (port of
reslic_tcm_tpu/entropy/factorized.py).

The learned CDF is CompressAI's matrix/bias/factor monotone chain; the
parameter names (``_matrix{i}``, ``_bias{i}``, ``_factor{i}``,
``quantiles``) are CompressAI's. The module's forward runs on the device in
NCHW; the CDF-table build and the z coding run on the host in numpy, as in
the JAX package, so the tables are byte-identical to its.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.math import lower_bound


@dataclasses.dataclass(frozen=True)
class CodingTables:
    """Integer-CDF state built by update(); not checkpointed."""

    quantized_cdf: np.ndarray  # int32 [num_indexes, max_cdf_length]
    cdf_length: np.ndarray  # int32 [num_indexes]
    offset: np.ndarray  # int32 [num_indexes]


class EntropyBottleneck(nn.Module):
    """Learned factorized prior over an NCHW latent. Eval rounds the values
    around the medians; training adds U(-0.5, 0.5) noise instead. Either
    way the likelihoods of the quantized values are returned."""

    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, tail_mass: float = 1e-9,
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.filters = tuple(filters)
        self.tail_mass = tail_mass
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
        self.quantiles = nn.Parameter(
            torch.tensor([[[-init_scale, 0.0, init_scale]]]).repeat(channels, 1, 1))

    def chain_params(self) -> dict:
        """The chain and quantiles as float32 numpy arrays, keyed like the
        JAX package's parameter tree (matrix0, bias0, factor0, quantiles)."""
        return {name.lstrip("_"): p.detach().cpu().numpy().astype(np.float32)
                for name, p in self.named_parameters()}

    def _logits_cumulative(self, inputs, detach: bool = False):
        """The chain c(x) on [C, 1, n] inputs; ``detach`` keeps the chain's
        own parameters out of the gradient (the aux loss)."""
        logits = inputs
        for i in range(len(self.filters) + 1):
            matrix, bias = getattr(self, f"_matrix{i}"), getattr(self, f"_bias{i}")
            if detach:
                matrix, bias = matrix.detach(), bias.detach()
            # fp32 in the bf16 mode too, where the TPU rounds it: it moves only
            # the forward's z likelihood (ROADMAP A15b)
            logits = torch.matmul(F.softplus(matrix), logits) + bias
            if i < len(self.filters):
                factor = getattr(self, f"_factor{i}")
                if detach:
                    factor = factor.detach()
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def medians(self) -> torch.Tensor:
        """Per-channel median of the learned distribution, shape [C]."""
        return self.quantiles[:, 0, 1].detach()

    def _likelihood(self, values):
        lower = self._logits_cumulative(values - 0.5)
        upper = self._logits_cumulative(values + 0.5)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))

    def noise_shape(self, x: torch.Tensor) -> tuple:
        """Shape of the training noise for the NCHW latent x: [C, 1, B*H*W],
        its values in (c, b, h, w) order, as the JAX module draws it."""
        b, c, h, w = x.shape
        return (c, 1, b * h * w)

    def forward(self, x: torch.Tensor, training: bool = False, noise=None):
        """x: NCHW. Returns (x_hat, likelihoods), both NCHW. With
        ``training`` the values are x + noise, ``noise`` being U(-0.5, 0.5)
        of ``noise_shape(x)``; without, they are rounded around the
        medians."""
        b, c, h, w = x.shape
        values = x.permute(1, 0, 2, 3).reshape(c, 1, -1)
        if training:
            if noise is None or tuple(noise.shape) != values.shape:
                raise ValueError(f"training needs noise of shape {tuple(values.shape)}")
            values_hat = values + noise
        else:
            medians = self.medians()[:, None, None]
            values_hat = torch.round(values - medians) + medians
        likelihood = self._likelihood(values_hat)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)
        values_hat = values_hat.reshape(c, b, h, w).permute(1, 0, 2, 3)
        likelihood = likelihood.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return values_hat, likelihood

    def aux_loss(self) -> torch.Tensor:
        """Quantile-fitting loss of the aux optimiser:
        sum |c(quantiles) - [-t, 0, t]| with t = log(2 / tail_mass - 1) and
        the chain detached, so that only ``quantiles`` gets a gradient."""
        logits = self._logits_cumulative(self.quantiles, detach=True)
        t = math.log(2 / self.tail_mass - 1)
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype, device=logits.device)
        return torch.sum(torch.abs(logits - target))


# ----------------------------------------------------------------------------
# Host side: CDF tables and z coding (numpy).
# ----------------------------------------------------------------------------


def _np_logits_cumulative(params: dict, filters: Tuple[int, ...], inputs: np.ndarray):
    logits = inputs.astype(np.float32)
    for i in range(len(filters) + 1):
        matrix = np.asarray(params[f"matrix{i}"], np.float32)
        logits = np.matmul(np.logaddexp(0.0, matrix), logits)  # softplus
        logits = logits + np.asarray(params[f"bias{i}"], np.float32)
        if i < len(filters):
            factor = np.asarray(params[f"factor{i}"], np.float32)
            logits = logits + np.tanh(factor) * np.tanh(logits)
    return logits


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def build_tables(params: dict, filters: Tuple[int, ...] = (3, 3, 3, 3)) -> CodingTables:
    """Integer CDF tables from the learned chain and quantiles (CompressAI
    EntropyBottleneck.update()): support [median - minima, median + maxima],
    pmf from the chain at sample +- 0.5, then the integer quantizer."""
    from ..coding.rans import pmf_to_quantized_cdf

    quantiles = np.asarray(params["quantiles"], np.float32)
    medians = quantiles[:, 0, 1]
    minima = np.maximum(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32), 0)
    maxima = np.maximum(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32), 0)

    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = np.arange(max_length, dtype=np.float32)
    samples = samples[None, None, :] + pmf_start[:, None, None]  # [C,1,L]

    half = np.float32(0.5)
    lower = _np_logits_cumulative(params, filters, samples - half)
    upper = _np_logits_cumulative(params, filters, samples + half)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower))[:, 0, :]
    tail_mass = _sigmoid(lower[:, 0, :1]) + _sigmoid(-upper[:, 0, -1:])

    c = pmf.shape[0]
    cdf = np.zeros((c, max_length + 2), dtype=np.int32)
    for i in range(c):
        prob = np.concatenate([pmf[i, : pmf_length[i]], tail_mass[i]], axis=0)
        q = pmf_to_quantized_cdf(prob, 16)
        cdf[i, : q.shape[0]] = q

    return CodingTables(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-minima).astype(np.int32),
    )


def compress(z: np.ndarray, medians: np.ndarray, tables: CodingTables) -> list[bytes]:
    """Encode an NCHW latent to one string per batch element (channel-major
    symbol order, channel c coded with CDF row c)."""
    from ..coding.rans import encode_with_indexes

    z = np.asarray(z, np.float32)
    b, c, h, w = z.shape
    symbols = np.rint(z - np.asarray(medians, np.float32).reshape(1, c, 1, 1)).astype(np.int32)
    indexes = np.repeat(np.arange(c, dtype=np.int32), h * w)
    return [
        encode_with_indexes(symbols[i].reshape(-1), indexes, tables.quantized_cdf,
                            tables.cdf_length, tables.offset)
        for i in range(b)
    ]


def decompress(strings: list[bytes], shape_hw, medians: np.ndarray,
               tables: CodingTables) -> np.ndarray:
    """Decode strings back to the NCHW latent (medians re-added)."""
    from ..coding.rans import decode_with_indexes

    h, w = shape_hw
    c = tables.quantized_cdf.shape[0]
    indexes = np.repeat(np.arange(c, dtype=np.int32), h * w)
    out = np.empty((len(strings), c, h, w), np.float32)
    med = np.asarray(medians, np.float32).reshape(c, 1)
    for i, s in enumerate(strings):
        vals = decode_with_indexes(s, indexes, tables.quantized_cdf, tables.cdf_length,
                                   tables.offset)
        out[i] = (vals.reshape(c, h * w).astype(np.float32) + med).reshape(c, h, w)
    return out
