"""STanH variable-rate codecs (port of reslic_tcm_tpu/models/stanh/variants.py):
TCM-STanH, WACNN-STanH and the Balle scale hyperprior with STanH.

One rate-agnostic backbone and one learnable STanH quantizer per rate level
(stacked ``[n_rates, L]`` parameters); the level ``lv`` is a Python int,
beta is annealed on the host, and the forward adds the ``gap`` outputs
that drive the annealing. The codecs code symbols that are level indexes
over per-level CDF tables, the JAX package's coding contract.

The channel-AR codec's encoder is the port's mirrored encoder
(``ChannelARCodec.encode_symbols``: the decoder's own per-slice
functions), so ``forward_codec_consistent`` is that encoder plus the STanH
likelihood at the coded symbols: its x_hat and y_hat are what the decoder
rebuilds. Modules are NCHW; the codecs' public tensors NHWC.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...entropy import factorized as fz
from ...entropy import stanh as sq
from ...entropy.stanh_models import (StanhEntropyBottleneck, StanhGaussianConditional,
                                     build_stanh_factorized_tables, build_stanh_scale_tables,
                                     stanh_gaussian_likelihood)
from ...ops.layers import StackedConv1x1, to_nhwc
from ...ops.math import build_indexes, get_scale_table
from ..balle2018 import HyperpriorCodec, ScaleHyperprior
from ..base import ChannelARCodec, codec_pass, fp32_numerics
from ..tcm import TCM
from ..wacnn import WACNN, _g_s, draw_weights

DEFAULT_BETA = 10.0


def _beta(beta):
    return DEFAULT_BETA if beta is None else beta


class _StanhChannelAR:
    """The STanH slice-entropy, gap and codec hooks of TCM/WACNN-STanH:
    slices are soft- (training) or hard-quantized by level lv's staircase
    and draw no noise; symbols are level indexes."""

    def _init_stanh(self, n_rates, num_sigmoids, extrema, symmetric, stanh_trainable,
                    removing_mean):
        self.n_rates, self.symmetric = n_rates, symmetric
        self.gaussian_conditional = StanhGaussianConditional(
            n_rates, num_sigmoids, extrema, symmetric, stanh_trainable, removing_mean)

    def slice_entropy(self, i, y_slice, sigma, mu, training, beta, lv, noise=None):
        return self.gaussian_conditional(y_slice, sigma, means=mu, training=training,
                                         beta=_beta(beta), lv=lv)

    def extra_outputs(self, y, training, beta, lv):
        return {"gap_gaussian": self.gaussian_conditional.gap(y, _beta(beta), lv)}

    def quantize_slice(self, i, y, mu, lv=0):
        """int16 level indexes of slice i's y - mu."""
        c = self.M // self.num_slices
        return self.gaussian_conditional.symbols(y[:, i * c : (i + 1) * c], mu, lv).to(
            torch.int16)

    def decode_slice_dequant_finish(self, i, mean_support, symbols, mu, lv=0):
        return self._lrp(i, mean_support, self.gaussian_conditional.dequantize(symbols, mu, lv))

    @torch.no_grad()
    def encode_stanh(self, x, lv: int = 0, scale_table=None) -> dict:
        """The STanH codec's encoder in one pass (the JAX mixin's
        ``encode_stanh``): for NCHW images x at level lv, {"z": the hyper
        latent before rounding, NCHW; "symbols": level lv's level indexes of
        y - mu (int64), "indexes": the scale indexes of sigma in
        ``scale_table`` (int32; default the 64-entry Gaussian table), both
        [S, B, C/S, h, w], slice by slice}. Each slice's y_hat, which the
        later slices' parameters read, is the decoder's: the levels of its
        symbols plus mu, then the LRP. JAX's are NHWC: z [B, h, w, C],
        symbols and indexes [S, B, h, w, C/S]. No codec path calls it (the
        codecs code with ``quantize_slice``); it is the JAX package's
        counterpart for callers."""
        scale_table = get_scale_table() if scale_table is None else torch.as_tensor(scale_table)
        y, z, z_hat = self.analysis(x, lv)
        latent_means, latent_scales = self.hyper_synthesis(z_hat, lv)
        c = self.M // self.num_slices
        y_hat_slices, symbols, indexes = [], [], []
        for i in range(self.num_slices):
            mu, sigma, mean_support = self._mu_sigma(i, latent_means, latent_scales,
                                                     self.slice_support(y_hat_slices),
                                                     tuple(y.shape[2:]))
            sym = self.gaussian_conditional.symbols(y[:, i * c : (i + 1) * c], mu, lv)
            symbols.append(sym)
            indexes.append(build_indexes(sigma, scale_table))
            y_hat_slices.append(self._lrp(i, mean_support,
                                          self.gaussian_conditional.dequantize(sym, mu, lv)))
        return {"z": z, "symbols": torch.stack(symbols), "indexes": torch.stack(indexes)}


class TCMStanh(_StanhChannelAR, TCM):
    """TCM with per-level STanH conditionals (reference
    models/stanh/tcm_stanh.py:312-463)."""

    def __init__(self, n_rates: int = 1, num_sigmoids=0, extrema=80, symmetric: bool = False,
                 stanh_trainable: bool = True, removing_mean: bool = False, **tcm):
        super().__init__(**tcm)
        self._init_stanh(n_rates, num_sigmoids, extrema, symmetric, stanh_trainable,
                         removing_mean)


class WACNNStanh(_StanhChannelAR, WACNN):
    """WACNN with per-level STanH conditionals and the decoder refinement
    modes (reference models/stanh/wacnn_stanh.py:131-335): "none";
    "convolution", level lv's 1x1 convolution (``refine``) before g_s;
    "multiple", one g_s clone per level (``g_s_{i}``, no shared g_s, as in
    the JAX parameter tree)."""

    def __init__(self, N: int = 192, M: int = 320, n_rates: int = 1, num_sigmoids=0,
                 extrema=80, symmetric: bool = False, stanh_trainable: bool = True,
                 removing_mean: bool = False, refinement: str = "none", **wacnn):
        if refinement not in ("none", "convolution", "multiple"):
            raise ValueError(f"unknown refinement {refinement!r}")
        super().__init__(N=N, M=M, **wacnn)
        self._init_stanh(n_rates, num_sigmoids, extrema, symmetric, stanh_trainable,
                         removing_mean)
        self.refinement = refinement
        if refinement == "convolution":
            self.refine = StackedConv1x1(n_rates, M, M)
        elif refinement == "multiple":
            del self.g_s
            for i in range(n_rates):
                self.add_module(f"g_s_{i}", _g_s(N, M))

    def apply_synthesis(self, y_hat, lv):
        if self.refinement == "multiple":
            return getattr(self, f"g_s_{lv}")(y_hat)
        if self.refinement == "convolution":
            return self.g_s(self.refine(y_hat, lv))
        return self.g_s(y_hat)


class ScaleHyperpriorStanh(ScaleHyperprior):
    """Balle scale hyperprior with STanH on y and, with ``fact_stanh``, on z
    (reference models/stanh/balle18_stanh.py:8-138). With ``fact_stanh``
    the module holds ``entropy_bottleneck_stanh`` and no plain entropy
    bottleneck (the JAX module never calls it, so its tree has none); the
    factorized STanH is single-rate, built from level 0's knobs. Its
    training forward draws noise only for a plain z."""

    def __init__(self, N: int = 128, M: int = 192, n_rates: int = 1, num_sigmoids=0,
                 extrema=80, symmetric: bool = False, stanh_trainable: bool = True,
                 removing_mean: bool = False, fact_stanh: bool = True):
        super().__init__(N, M)
        self.n_rates, self.symmetric, self.fact_stanh = n_rates, symmetric, fact_stanh
        self.gaussian_conditional = StanhGaussianConditional(
            n_rates, num_sigmoids, extrema, symmetric, stanh_trainable, removing_mean)
        if fact_stanh:
            del self.entropy_bottleneck
            self.entropy_bottleneck_stanh = StanhEntropyBottleneck(
                N, num_sigmoids=sq.per_level_cfg(num_sigmoids, n_rates)[0],
                extrema=sq.per_level_cfg(extrema, n_rates)[0], symmetric=symmetric,
                trainable=stanh_trainable)

    def forward(self, x, training: bool = False, noise=None, lv: int = 0, beta=None,
                beta_factorized=None):
        beta = _beta(beta)
        beta_f = beta if beta_factorized is None else beta_factorized
        y, z = self.analyze(x)
        if self.fact_stanh:
            eb = self.entropy_bottleneck_stanh
            gap_factorized = eb.gap(z, beta_f)
            z_hat, z_lik = eb(z, training=training, beta=beta_f)
        else:
            eb = self.entropy_bottleneck
            gap_factorized = z.new_zeros(())
            z_hat, z_lik = eb(z, training=training,
                              noise=noise(eb.noise_shape(z)) if training else None)
        y_hat, y_lik = self.gaussian_conditional(y, self.h_s(z_hat), means=None,
                                                 training=training, beta=beta, lv=lv)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_lik, "z": z_lik},
                "gap_gaussian": self.gaussian_conditional.gap(y, beta, lv),
                "gap_factorized": gap_factorized}

    def aux_loss(self) -> torch.Tensor:
        if self.fact_stanh:
            return self.entropy_bottleneck_stanh.aux_loss()
        return self.entropy_bottleneck.aux_loss()


# ---------------------------------------------------------------------------
# Codecs: per-level CDF tables, symbols = level indexes.
# ---------------------------------------------------------------------------


class StanhChannelARCodec(ChannelARCodec):
    """update/compress/decompress of TCM/WACNN-STanH at a rate level ``lv``:
    the base codec's mirrored encoder and batched decoder, with level lv's
    STanH tables coding y."""

    def __init__(self, module, device):
        super().__init__(module, device)
        self.stanh_tables: dict[int, fz.CodingTables] = {}

    @fp32_numerics()
    def update(self):
        super().update()
        gc = self.module.gaussian_conditional
        self.stanh_tables = {
            lv: build_stanh_scale_tables(*gc.wb(lv), self.module.symmetric,
                                         self.gaussian_conditional.scale_table)
            for lv in range(self.module.n_rates)}
        return True

    def y_tables(self, lv: int = 0) -> fz.CodingTables:
        return self.stanh_tables[lv]

    @torch.no_grad()
    @codec_pass
    def forward_codec_consistent(self, x, lv: int = 0) -> dict:
        """The eval forward through the encoder's own per-slice functions
        (``encode_symbols``'s): its symbols, x_hat and y_hat are the ones
        compress()/decompress() give. The y likelihood is the STanH interval
        integral at the coded level, the z likelihood the factorized model
        at round(z - median). Returns {"x_hat", "likelihoods": {"y", "z"},
        "y_hat", "symbols"}, tensors NHWC (symbols int16, slice by slice as
        ``encode_symbols`` orders them)."""
        self._require_tables()
        m = self.module
        gc = m.gaussian_conditional
        xc = self._input(x)
        y, z, z_hat = m.analysis(xc, lv)
        y_shape = tuple(y.shape[2:])
        latent_means, latent_scales = m.hyper_synthesis(z_hat, lv)
        _, z_lik = m.entropy_bottleneck(z)
        state = gc.stanh.state(lv)
        syms, y_liks, y_hat_slices = [], [], []
        for i in range(m.num_slices):
            mu, sigma, mean_support = m._mu_sigma(
                i, latent_means, latent_scales, m.slice_support(y_hat_slices), y_shape)
            sym = m.quantize_slice(i, y, mu, lv)
            y_hat_raw = gc.dequantize(sym, mu, lv)
            y_liks.append(stanh_gaussian_likelihood(y_hat_raw, sigma, state, mu,
                                                    gc.scale_bound, gc.likelihood_bound))
            y_hat_slices.append(m._lrp(i, mean_support, y_hat_raw))
            syms.append(sym)
        y_hat = torch.cat(y_hat_slices, dim=1)
        return {"x_hat": to_nhwc(m.synthesize(y_hat, lv)),
                "likelihoods": {"y": to_nhwc(torch.cat(y_liks, dim=1)), "z": to_nhwc(z_lik)},
                "y_hat": to_nhwc(y_hat), "symbols": torch.stack(syms, dim=1)}


class StanhHyperpriorCodec(HyperpriorCodec):
    """update/compress/decompress of ScaleHyperpriorStanh at a rate level.
    z: with ``fact_stanh`` STanH level indexes with one CDF row per channel,
    channel-major (the encoder codes z, then decodes it to get the z_hat
    the decoder sees); else the factorized tables. y: level indexes, one
    string per image, in the JAX package's order (channel-major: C, H, W
    of each image)."""

    def __init__(self, module: ScaleHyperpriorStanh, device):
        super().__init__(module, device)
        self.stanh_tables: dict[int, fz.CodingTables] = {}

    @fp32_numerics()
    def update(self):
        m = self.module
        self.gaussian_conditional.update_scale_table()
        gc = m.gaussian_conditional
        self.stanh_tables = {
            lv: build_stanh_scale_tables(*gc.wb(lv), m.symmetric,
                                         self.gaussian_conditional.scale_table)
            for lv in range(m.n_rates)}
        if m.fact_stanh:
            eb = m.entropy_bottleneck_stanh
            w, b = (p[0].detach().cpu().numpy().astype(np.float32)
                    for p in (eb.stanh.w, eb.stanh.b))
            self.eb_tables = build_stanh_factorized_tables(eb.chain_params(), w, b,
                                                           m.symmetric, eb.filters)
        else:
            eb = m.entropy_bottleneck
            self.eb_tables = fz.build_tables(eb.chain_params(), eb.filters)
            self._medians = eb.medians().cpu().numpy()
        return True

    @torch.no_grad()
    @codec_pass
    def forward(self, x, lv: int = 0) -> dict:
        """Eval forward (bpp estimate) at rate level ``lv``; outputs NHWC."""
        out = self.module(self._input(x), lv=lv)
        return {"x_hat": to_nhwc(out["x_hat"]),
                "likelihoods": {k: to_nhwc(v) for k, v in out["likelihoods"].items()}}

    def aux_loss(self) -> torch.Tensor:
        return self.module.aux_loss()

    def _z_state(self):
        return self.module.entropy_bottleneck_stanh.stanh.state(0)

    @staticmethod
    def _code(symbols: torch.Tensor, indexes: torch.Tensor, t: fz.CodingTables) -> list:
        """One string per image of NCHW symbols and indexes, channel-major."""
        from ...coding.rans import encode_with_indexes

        symbols = symbols.cpu().numpy().astype(np.int32)
        indexes = indexes.cpu().numpy().astype(np.int32)
        return [encode_with_indexes(symbols[i].reshape(-1), indexes[i].reshape(-1),
                                    t.quantized_cdf, t.cdf_length, t.offset)
                for i in range(symbols.shape[0])]

    def _decode(self, strings, indexes: torch.Tensor, t: fz.CodingTables) -> torch.Tensor:
        from ...coding.rans import decode_with_indexes

        idx = indexes.cpu().numpy().astype(np.int32)
        ks = [decode_with_indexes(s, idx[i].reshape(-1), t.quantized_cdf, t.cdf_length,
                                  t.offset).reshape(idx.shape[1:])
              for i, s in enumerate(strings)]
        return torch.from_numpy(np.stack(ks).astype(np.int64)).to(self.device)

    def _z_indexes(self, b: int, shape) -> torch.Tensor:
        c = self.eb_tables.quantized_cdf.shape[0]
        return torch.arange(c, dtype=torch.int32).reshape(1, c, 1, 1).expand(b, c, *shape)

    def _decode_z(self, z_strings, shape) -> torch.Tensor:
        """NCHW z_hat from the z strings."""
        if not self.module.fact_stanh:
            return torch.from_numpy(
                fz.decompress(z_strings, shape, self._medians, self.eb_tables)).to(self.device)
        ks = self._decode(z_strings, self._z_indexes(len(z_strings), shape), self.eb_tables)
        return sq.from_symbols(ks, self._z_state())

    @torch.no_grad()
    @codec_pass
    def compress(self, x, lv: int = 0) -> dict:
        """x: NHWC in [0, 1]. Returns {"strings": [y strings, z strings], one
        per image; "shape": z's (h, w); "y_hat": the NHWC latent the decoder
        rebuilds}."""
        self._require_tables()
        m = self.module
        y, z = m.analyze(self._input(x))
        zh, zw = z.shape[2], z.shape[3]
        if m.fact_stanh:
            z_strings = self._code(sq.to_symbols(z, self._z_state()),
                                   self._z_indexes(z.shape[0], (zh, zw)), self.eb_tables)
        else:
            z_strings = fz.compress(z.cpu().numpy(), self._medians, self.eb_tables)
        indexes = self.gaussian_conditional.indexes(m.h_s(self._decode_z(z_strings, (zh, zw))))
        gc = m.gaussian_conditional
        ys = gc.symbols(y, None, lv)
        return {"strings": [self._code(ys, indexes, self.stanh_tables[lv]), z_strings],
                "shape": (zh, zw), "y_hat": to_nhwc(gc.dequantize(ys, None, lv))}

    @torch.no_grad()
    @codec_pass
    def decompress(self, strings, shape, lv: int = 0) -> dict:
        """Decode ``compress``'s strings. Returns {"x_hat": NHWC in [0, 1],
        "y_hat": NHWC}."""
        self._require_tables()
        m = self.module
        indexes = self.gaussian_conditional.indexes(m.h_s(self._decode_z(strings[1], shape)))
        ks = self._decode(strings[0], indexes, self.stanh_tables[lv])
        y_hat = m.gaussian_conditional.dequantize(ks, None, lv)
        return {"x_hat": to_nhwc(m.synthesize(y_hat)), "y_hat": to_nhwc(y_hat)}


# ------------------------------- factories --------------------------------


def _stanh_kwargs(gaussian_configuration: Sequence[dict]) -> dict:
    """The per-level quantizer knobs of the per-lambda config dicts (one
    value when every level has the same)."""
    g0 = gaussian_configuration[0]

    def knob(key):
        vals = tuple(int(g[key]) for g in gaussian_configuration)
        return vals[0] if len(set(vals)) == 1 else vals

    return dict(n_rates=len(gaussian_configuration), num_sigmoids=knob("num_sigmoids"),
                extrema=knob("extrema"), symmetric=bool(g0["symmetry"]),
                stanh_trainable=bool(g0.get("trainable", True)),
                removing_mean=bool(g0.get("removing_mean", False)))


def _build(cls, kwargs, device, seed):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    with torch.random.fork_rng(devices=[]):  # leave the caller's global RNG as it was
        module = cls(**kwargs)
    draw_weights(module, torch.Generator().manual_seed(seed))
    return module, device


def make_wacnn_stanh(gaussian_configuration, N: int = 192, M: int = 320,
                     refinement: str = "none", device="cuda", seed: int = 0,
                     **ladders) -> StanhChannelARCodec:
    """WACNN-STanH on ``device`` with random weights drawn from ``seed``
    (wacnn.py's ``draw_weights``; trained weights through
    ``utils.torch_convert``). ``ladders``: as ``make_wacnn``'s."""
    module, device = _build(WACNNStanh, dict(
        N=N, M=M, refinement=refinement, **_stanh_kwargs(gaussian_configuration), **ladders),
        device, seed)
    return StanhChannelARCodec(module, device)


def make_tcm_stanh(gaussian_configuration, N: int = 128, M: int = 320, device="cuda",
                   seed: int = 0, **tcm) -> StanhChannelARCodec:
    """TCM-STanH on ``device`` with torch's default initialisation under
    ``seed`` (as ``make_tcm``); ``tcm``: TCM's constructor arguments."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = TCMStanh(N=N, M=M, **_stanh_kwargs(gaussian_configuration), **tcm)
    return StanhChannelARCodec(module, device)


def make_scale_stanh(gaussian_configuration, N: int = 128, M: int = 192,
                     fact_stanh: bool = True, device="cuda", seed: int = 0
                     ) -> StanhHyperpriorCodec:
    """ScaleHyperpriorStanh on ``device`` with random weights drawn from
    ``seed`` (wacnn.py's ``draw_weights``)."""
    module, device = _build(ScaleHyperpriorStanh, dict(
        N=N, M=M, fact_stanh=fact_stanh, **_stanh_kwargs(gaussian_configuration)),
        device, seed)
    return StanhHyperpriorCodec(module, device)
