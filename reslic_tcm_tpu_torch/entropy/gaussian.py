"""Conditional Gaussian entropy model (port of reslic_tcm_tpu/entropy/gaussian.py).

The scale-indexed CDF tables are built on the host with numpy and scipy
exactly as the JAX package builds them, so they are byte-identical
(tests/golden/gaussian_tables.json pins them); the device math (likelihood,
scale indexes) lives in ``ops/math.py``. ``GaussianConditional.compress``
and ``decompress`` code a whole latent through the host rANS coder, one
string per batch element, in the order of the arrays they are given (the
Balle-2018 codecs pass NHWC, as the JAX package does).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.special
import scipy.stats
import torch

from ..ops.math import SCALES_MIN, build_indexes, gaussian_likelihood, get_scale_table
from .factorized import CodingTables


def _std_cum(x: np.ndarray) -> np.ndarray:
    return (0.5 * scipy.special.erfc(-(2 ** -0.5) * np.asarray(x, np.float32))).astype(np.float32)


def build_scale_tables(scale_table: np.ndarray, tail_mass: float = 1e-9) -> CodingTables:
    """Per-scale-index quantized CDF tables (CompressAI update()): support
    +-ceil(sigma * Q(1 - tail/2)) around 0, the unit-width Gaussian integral
    at each integer, and a last bin holding twice the tail mass for bypass
    coding."""
    from ..coding.rans import pmf_to_quantized_cdf

    scale_table = np.asarray(scale_table, np.float32)
    multiplier = -scipy.stats.norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length, dtype=np.int32) - pmf_center[:, None]).astype(np.float32)
    s = scale_table[:, None]
    upper = _std_cum((0.5 - samples) / s)
    lower = _std_cum((-0.5 - samples) / s)
    pmf = upper - lower
    tail = 2 * lower[:, :1]

    n = scale_table.shape[0]
    cdf = np.zeros((n, max_length + 2), dtype=np.int32)
    for i in range(n):
        prob = np.concatenate([pmf[i, : pmf_length[i]], tail[i]], axis=0)
        q = pmf_to_quantized_cdf(prob, 16)
        cdf[i, : q.shape[0]] = q

    return CodingTables(
        quantized_cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-pmf_center).astype(np.int32),
    )


@dataclasses.dataclass
class GaussianConditional:
    """The scale table and, after update_scale_table(), its CDF tables; the
    likelihood and scale indexes on the device, the coding on the host."""

    scale_table: np.ndarray | None = None
    scale_bound: float = SCALES_MIN
    tail_mass: float = 1e-9
    likelihood_bound: float = 1e-9
    tables: CodingTables | None = None

    def update_scale_table(self, scale_table=None) -> "GaussianConditional":
        if scale_table is None:
            scale_table = get_scale_table().numpy()
        self.scale_table = np.asarray(scale_table, np.float32)
        self.tables = build_scale_tables(self.scale_table, self.tail_mass)
        return self

    def likelihood(self, inputs, scales, means=None) -> torch.Tensor:
        return gaussian_likelihood(inputs, scales, means, scale_bound=self.scale_bound,
                                   likelihood_bound=self.likelihood_bound)

    def indexes(self, scales: torch.Tensor) -> torch.Tensor:
        """int32 scale-table index of each sigma, on the scales' device."""
        if self.scale_table is None:
            raise ValueError("call update_scale_table() first")
        return build_indexes(scales, torch.from_numpy(self.scale_table))

    def _require_tables(self) -> CodingTables:
        if self.tables is None:
            raise ValueError("Uninitialized CDFs. Run update_scale_table() first")
        return self.tables

    @staticmethod
    def quantize(values, means=None) -> np.ndarray:
        """int32 symbols rint(values - means) of float32 arrays."""
        values = np.asarray(values, np.float32)
        if means is not None:
            values = values - np.asarray(means, np.float32)
        return np.rint(values).astype(np.int32)

    @staticmethod
    def dequantize(symbols, means=None) -> np.ndarray:
        """float32 symbols (+ means): the values the decoder rebuilds."""
        out = np.asarray(symbols).astype(np.float32)
        return out if means is None else out + np.asarray(means, np.float32)

    def compress(self, values, indexes, means=None) -> list[bytes]:
        """values, indexes, means: [B, ...] arrays; one string per batch
        element, its symbols in the arrays' element order."""
        from ..coding.rans import encode_with_indexes

        t = self._require_tables()
        symbols = self.quantize(values, means)
        indexes = np.asarray(indexes, np.int32)
        return [encode_with_indexes(symbols[i].reshape(-1), indexes[i].reshape(-1),
                                    t.quantized_cdf, t.cdf_length, t.offset)
                for i in range(symbols.shape[0])]

    def decompress(self, strings, indexes, means=None) -> np.ndarray:
        """The float32 values of ``indexes``' shape coded in ``strings``."""
        from ..coding.rans import decode_with_indexes

        t = self._require_tables()
        indexes = np.asarray(indexes, np.int32)
        flat = indexes.reshape(indexes.shape[0], -1)
        symbols = np.stack([decode_with_indexes(s, flat[i], t.quantized_cdf, t.cdf_length,
                                                t.offset) for i, s in enumerate(strings)])
        return self.dequantize(symbols.reshape(indexes.shape), means)
