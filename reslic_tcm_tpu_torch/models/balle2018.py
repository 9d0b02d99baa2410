"""Balle-2018 hyperprior family (port of reslic_tcm_tpu/models/balle2018.py):
FactorizedPrior, ScaleHyperprior and MeanScaleHyperprior (CompressAI's
bmshj2018 / mbt2018-mean models).

  g_a: [conv5x5 s2, GDN] x3 -> conv5x5 s2 (-> M)
  g_s: [Deconv5x5 s2, IGDN] x3 -> Deconv5x5 s2 (-> 3)
  FactorizedPrior: y through the entropy bottleneck alone.
  ScaleHyperprior: z = h_a(|y|) through the entropy bottleneck, sigma =
  h_s(z_hat), y through a zero-mean Gaussian conditional.
  MeanScaleHyperprior: z = h_a(y), (sigma, mu) = h_s(z_hat) split in two.

No kernel lies on this path (5x5 stride-2 convolutions and an unfused
GDN, as in the JAX package). The modules are NCHW, carry the reference
state-dict names, and take the port's training interface: ``forward(x,
training, noise)`` with the noise from a callable (z first, then y) and
``aux_loss()``, so ``training/step.py::train_step`` drives them.
``HyperpriorCodec`` is the host codec, NHWC at its boundary like
``ChannelARCodec``; FactorizedPrior codes y through the factorized
tables, the others y through ``GaussianConditional`` and z through the
factorized tables, in the JAX package's stream layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..entropy import factorized as fz
from ..entropy.factorized import EntropyBottleneck
from ..entropy.gaussian import GaussianConditional
from ..ops.layers import GDN, Deconv, conv, to_nchw, to_nhwc
from ..ops.math import gaussian_likelihood
from .base import MatmulPrecision, codec_pass
from .wacnn import draw_weights


def _g_a(N: int, M: int) -> nn.Sequential:
    return nn.Sequential(conv(3, N, 5, 2), GDN(N), conv(N, N, 5, 2), GDN(N),
                         conv(N, N, 5, 2), GDN(N), conv(N, M, 5, 2))


def _g_s(N: int, M: int) -> nn.Sequential:
    return nn.Sequential(Deconv(M, N, 5, 2), GDN(N, inverse=True),
                         Deconv(N, N, 5, 2), GDN(N, inverse=True),
                         Deconv(N, N, 5, 2), GDN(N, inverse=True), Deconv(N, 3, 5, 2))


class _Balle(nn.Module):
    """g_a, g_s and the entropy bottleneck (over y's M channels or z's N)."""

    def __init__(self, N: int, M: int, bottleneck: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = _g_a(N, M)
        self.g_s = _g_s(N, M)
        self.entropy_bottleneck = EntropyBottleneck(bottleneck)

    def synthesize(self, y_hat):
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.aux_loss()


class FactorizedPrior(_Balle):
    """y -> the entropy bottleneck only."""

    def __init__(self, N: int = 128, M: int = 192):
        super().__init__(N, M, M)

    def forward(self, x, training: bool = False, noise=None):
        """Rate-distortion forward (NCHW): y rounded around the medians, or
        with ``training`` y + U(-0.5, 0.5) from ``noise(shape)``."""
        y = self.g_a(x)
        eb = self.entropy_bottleneck
        y_hat, y_lik = eb(y, training=training,
                          noise=noise(eb.noise_shape(y)) if training else None)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_lik}}


class ScaleHyperprior(_Balle):
    """z = h_a(|y|); a zero-mean Gaussian conditional with sigma = h_s(z_hat)."""

    def __init__(self, N: int = 128, M: int = 192):
        super().__init__(N, M, N)
        self.h_a, self.h_s = self._hyper_transforms(N, M)

    @staticmethod
    def _hyper_transforms(N: int, M: int):
        return (nn.Sequential(conv(M, N, 3, 1), nn.ReLU(), conv(N, N, 5, 2), nn.ReLU(),
                              conv(N, N, 5, 2)),
                nn.Sequential(Deconv(N, N, 5, 2), nn.ReLU(), Deconv(N, N, 5, 2), nn.ReLU(),
                              conv(N, M, 3, 1), nn.ReLU()))

    def hyper_input(self, y):
        return torch.abs(y)

    def gaussian_params(self, z_hat):
        """(scales, means or None)."""
        return self.h_s(z_hat), None

    def analyze(self, x):
        y = self.g_a(x)
        return y, self.h_a(self.hyper_input(y))

    def forward(self, x, training: bool = False, noise=None):
        """Rate-distortion forward (NCHW): with ``training`` z and y take
        U(-0.5, 0.5) from ``noise(shape)`` (z first, as the JAX module
        draws them), else z is rounded around the medians and y around mu."""
        y, z = self.analyze(x)
        eb = self.entropy_bottleneck
        z_hat, z_lik = eb(z, training=training,
                          noise=noise(eb.noise_shape(z)) if training else None)
        scales, means = self.gaussian_params(z_hat)
        if training:
            y_hat = y + noise(y.shape)
        elif means is None:
            y_hat = torch.round(y)
        else:
            y_hat = torch.round(y - means) + means
        y_lik = gaussian_likelihood(y_hat, scales, means)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_lik, "z": z_lik}}


class MeanScaleHyperprior(ScaleHyperprior):
    """z = h_a(y) (no abs); (sigma, mu) are h_s(z_hat)'s two channel halves."""

    @staticmethod
    def _hyper_transforms(N: int, M: int):
        return (nn.Sequential(conv(M, N, 3, 1), nn.LeakyReLU(0.01), conv(N, N, 5, 2),
                              nn.LeakyReLU(0.01), conv(N, N, 5, 2)),
                nn.Sequential(Deconv(N, M, 5, 2), nn.LeakyReLU(0.01),
                              Deconv(M, M * 3 // 2, 5, 2), nn.LeakyReLU(0.01),
                              conv(M * 3 // 2, M * 2, 3, 1)))

    def hyper_input(self, y):
        return y

    def gaussian_params(self, z_hat):
        scales, means = self.h_s(z_hat).chunk(2, dim=1)
        return scales, means


class HyperpriorCodec(MatmulPrecision):
    """A Balle-2018 module on a device plus the host rANS coder (the
    reference's update() / compress() / decompress() / forward API). Its
    tensors are NHWC; each pass runs under ``fp32_numerics``, whatever the
    caller's TF32 flags, and at the codec's matmul precision
    (``codec_pass``; ``set_matmul_precision("bfloat16")`` is the JAX codec's
    bf16 mode, ``_jit`` balle2018.py:177-191). ``update()``'s tables stay
    fp32."""

    def __init__(self, module: FactorizedPrior | ScaleHyperprior, device):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.gaussian_conditional = GaussianConditional()
        self.eb_tables: fz.CodingTables | None = None
        self._medians: np.ndarray | None = None

    @property
    def factorized(self) -> bool:
        return isinstance(self.module, FactorizedPrior)

    def _input(self, x) -> torch.Tensor:
        """NHWC image(s) in [0, 1] -> NCHW float32 on the codec's device."""
        return to_nchw(torch.as_tensor(x, dtype=torch.float32).to(self.device))

    def update(self):
        """Build the integer CDF tables (must run before real coding)."""
        self.gaussian_conditional.update_scale_table()
        eb = self.module.entropy_bottleneck
        self.eb_tables = fz.build_tables(eb.chain_params(), eb.filters)
        self._medians = eb.medians().cpu().numpy()
        return True

    def _require_tables(self):
        if self.eb_tables is None:
            raise RuntimeError("call update() before compress() or decompress()")

    @torch.no_grad()
    @codec_pass
    def forward(self, x, lv: int = 0) -> dict:
        """Eval forward (bpp estimate) of NHWC images; outputs NHWC. ``lv``
        (here and in compress/decompress): the rate level of the
        variable-rate codecs' API, one level here."""
        out = self.module(self._input(x))
        return {"x_hat": to_nhwc(out["x_hat"]),
                "likelihoods": {k: to_nhwc(v) for k, v in out["likelihoods"].items()}}

    def aux_loss(self) -> torch.Tensor:
        return self.module.aux_loss()

    def _gaussian_params(self, z_hat: torch.Tensor):
        """(scale indexes, means or None) of y as NHWC numpy arrays, from the
        NCHW z_hat on the device: what encoder and decoder both compute."""
        scales, means = self.module.gaussian_params(z_hat)
        indexes = to_nhwc(self.gaussian_conditional.indexes(scales)).cpu().numpy()
        return indexes, None if means is None else to_nhwc(means).cpu().numpy()

    @torch.no_grad()
    @codec_pass
    def compress(self, x, lv: int = 0) -> dict:
        """x: NHWC in [0, 1]. Returns {"strings": [y strings] for
        FactorizedPrior, else [y strings, z strings], one per image;
        "shape": the coded latent's (h, w) (y's for FactorizedPrior, z's
        otherwise), as the JAX codec gives them; "y_hat": the NHWC latent
        the decoder must reproduce}."""
        self._require_tables()
        m = self.module
        xc = self._input(x)
        med = self._medians.reshape(1, -1, 1, 1)
        if self.factorized:
            y = m.g_a(xc).cpu().numpy()
            y_hat = self.gaussian_conditional.dequantize(
                self.gaussian_conditional.quantize(y, med), med)
            return {"strings": [fz.compress(y, self._medians, self.eb_tables)],
                    "shape": (y.shape[2], y.shape[3]),
                    "y_hat": to_nhwc(torch.from_numpy(y_hat).to(self.device))}
        y, z = m.analyze(xc)
        z_np = z.cpu().numpy()
        z_strings = fz.compress(z_np, self._medians, self.eb_tables)
        z_hat = self.gaussian_conditional.dequantize(
            self.gaussian_conditional.quantize(z_np, med), med)
        indexes, means = self._gaussian_params(torch.from_numpy(z_hat).to(self.device))
        y_nhwc = to_nhwc(y).cpu().numpy()
        gc = self.gaussian_conditional
        y_hat = gc.dequantize(gc.quantize(y_nhwc, means), means)
        return {"strings": [gc.compress(y_nhwc, indexes, means), z_strings],
                "shape": (z.shape[2], z.shape[3]),
                "y_hat": torch.from_numpy(y_hat).to(self.device)}

    @torch.no_grad()
    @codec_pass
    def decompress(self, strings, shape, lv: int = 0) -> dict:
        """Decode ``compress``'s strings. Returns {"x_hat": NHWC in [0, 1],
        "y_hat": NHWC}."""
        self._require_tables()
        if self.factorized:
            y_hat = torch.from_numpy(
                fz.decompress(strings[0], shape, self._medians, self.eb_tables)).to(self.device)
        else:
            z_hat = fz.decompress(strings[1], shape, self._medians, self.eb_tables)
            indexes, means = self._gaussian_params(torch.from_numpy(z_hat).to(self.device))
            y_hat = to_nchw(torch.from_numpy(
                self.gaussian_conditional.decompress(strings[0], indexes, means)).to(self.device))
        return {"x_hat": to_nhwc(self.module.synthesize(y_hat)), "y_hat": to_nhwc(y_hat)}


KINDS = {"factorized": FactorizedPrior, "scale": ScaleHyperprior,
         "mean-scale": MeanScaleHyperprior}


def make_balle(kind: str = "mean-scale", N: int = 128, M: int = 192, device="cuda",
               seed: int = 0) -> HyperpriorCodec:
    """Build a Balle-2018 codec (``kind``: factorized, scale or mean-scale)
    on ``device`` with random weights drawn from a ``torch.Generator``
    seeded with ``seed`` (wacnn.py's ``draw_weights``; load trained weights
    with ``utils.torch_convert``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    with torch.random.fork_rng(devices=[]):  # leave the caller's global RNG as it was
        module = KINDS[kind](N=N, M=M)
    draw_weights(module, torch.Generator().manual_seed(seed))
    return HyperpriorCodec(module, device)
