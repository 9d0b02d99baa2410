"""Channel-autoregressive codec base (port of reslic_tcm_tpu/models/base.py,
the rate-distortion forward (eval and training) and the host-codec paths).

``ChannelARModule`` holds the rate-distortion forward and the per-slice
helpers shared by the encoder and the decoder, in NCHW. Its training
forward takes the uniform noise from a ``noise`` callable (``uniform_noise``
or ``replayed_noise``), drawn in the JAX module's order: z first, then the
slices in order. The JAX module's entropy hooks (``slice_entropy``,
``extra_outputs``, ``apply_synthesis``) and the codec hooks
(``quantize_slice``, ``decode_slice_dequant_finish``, ``synthesize``)
take the rate level ``lv``, a Python int that the STanH variants use
(models/stanh/variants.py) and the plain codecs ignore. ``ChannelARCodec``
pairs a module on a device with the host rANS coder behind the
reference's ``update()`` / ``compress()`` / ``decompress()`` API; its
public tensors are NHWC, like the JAX package's.

Mirrored encoder: the encoder computes each slice's mu, scale indexes and
y_hat with the decoder's own per-slice functions on the same shapes, so
the indexes match the decoder's bit for bit. (Two different programs for
the same math can differ by an ulp in sigma, which is enough to move a
scale index across a table boundary and desynchronize the decode.)
For the same reason every pass of ``ChannelARCodec`` runs in full fp32
(``fp32_numerics``): with TF32 on, cuDNN's convolutions would round
differently in an encoder and a decoder run under different settings.

Gain hooks: ``gain_y``, ``gain_z``, ``inv_gain_z`` and ``inv_gain_y`` are
identities here; the gain codecs (models/gain/gained.py) scale the latents
by level lv's channel gains. The codec codes the gained y, so the y_hat
that ``compress`` and ``decompress`` return is in that domain, before the
inverse gain that ``synthesize`` applies.

Pipelined host codec: the encoder is split into a device stage, which
enqueues every kernel of a batch and ends in non-blocking copies into
pinned host buffers and a CUDA event, and a host stage, which waits on
that event and runs rANS. ``compress_pipelined`` enqueues batch i+1 while
a worker thread codes batch i; ``roundtrip_pipelined`` also decodes batch
i in worker threads while the next batches encode. On the CPU the same
code runs in order.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from ..entropy import factorized as fz
from ..entropy.gaussian import GaussianConditional
from ..ops.layers import to_nchw, to_nhwc
from ..ops.math import build_indexes, gaussian_likelihood, ste_round


_numerics_lock = threading.Lock()
_numerics_depth = 0
_numerics_saved: tuple = ()


@contextlib.contextmanager
def fp32_numerics():
    """Run the block with TF32 off for cuDNN convolutions and cuBLAS matrix
    products, and give back the caller's two flags afterwards. Usable as a
    decorator (``@fp32_numerics()``). The flags are global, so the blocks
    of all threads share one depth count: the first to enter saves the
    flags, every entry turns TF32 off, and only the last to leave restores
    them, so no pass of another thread runs with TF32 on."""
    global _numerics_depth, _numerics_saved
    with _numerics_lock:
        if _numerics_depth == 0:
            _numerics_saved = (torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32)
        _numerics_depth += 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _numerics_lock:
            _numerics_depth -= 1
            if _numerics_depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _numerics_saved


def uniform_noise(generator: torch.Generator):
    """A ``noise`` callable for the training forward: U(-0.5, 0.5) tensors of
    the asked shape drawn from ``generator``, on its device."""
    return lambda shape: torch.rand(shape, generator=generator, device=generator.device) - 0.5


def replayed_noise(tensors):
    """A ``noise`` callable that hands out ``tensors`` in order, each checked
    against the shape asked for (noise recorded elsewhere, e.g. the JAX
    module's draws)."""
    it = iter(tensors)

    def draw(shape):
        u = next(it)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"replayed noise has shape {tuple(u.shape)}, the forward asks "
                             f"for {tuple(shape)}")
        return u
    return draw


class ChannelARModule(nn.Module):
    """Base of the channel-AR codecs. Subclasses create g_a, g_s, h_a,
    h_mean_s, h_scale_s, entropy_bottleneck, cc_mean_transforms,
    cc_scale_transforms, lrp_transforms and, where the codec has them
    (TCM, not WACNN), atten_mean and atten_scale, and set num_slices,
    max_support_slices and M. The z channels are the entropy bottleneck's."""

    num_slices: int
    max_support_slices: int
    M: int

    def slice_support(self, y_hat_slices: list) -> list:
        if self.max_support_slices < 0:
            return list(y_hat_slices)
        return list(y_hat_slices[: self.max_support_slices])

    def _z_offset(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()[None, :, None, None]

    def _mu_sigma(self, i: int, latent_means, latent_scales, support, y_shape):
        """(mu, sigma, mean_support) for slice i."""
        h, w = y_shape
        atten_mean = getattr(self, "atten_mean", None)
        atten_scale = getattr(self, "atten_scale", None)
        mean_support = torch.cat([latent_means] + support, dim=1)
        if atten_mean is not None:
            mean_support = atten_mean[i](mean_support)
        mu = self.cc_mean_transforms[i](mean_support)[:, :, :h, :w]
        scale_support = torch.cat([latent_scales] + support, dim=1)
        if atten_scale is not None:
            scale_support = atten_scale[i](scale_support)
        sigma = self.cc_scale_transforms[i](scale_support)[:, :, :h, :w]
        return mu, sigma, mean_support

    def _lrp(self, i: int, mean_support, y_hat_slice):
        """Latent residual prediction."""
        lrp = self.lrp_transforms[i](torch.cat([mean_support, y_hat_slice], dim=1))
        return y_hat_slice + 0.5 * torch.tanh(lrp)

    # ------------------------- entropy hooks -------------------------
    # The STanH variants (models/stanh/variants.py) override these: they
    # quantize the slices with their learnable staircase and add the gap.

    def slice_entropy(self, i: int, y_slice, sigma, mu, training: bool, beta, lv: int,
                      noise=None):
        """(y_hat_slice, likelihood) of slice i. Eval takes the likelihood
        at round(y - mu) + mu, training at y + U(-0.5, 0.5) from
        ``noise(shape)``; y_hat is the STE round around mu either way."""
        if training:
            lik_point = y_slice + noise(y_slice.shape)
        else:
            lik_point = torch.round(y_slice - mu) + mu
        lik = gaussian_likelihood(lik_point, sigma, mu)
        return ste_round(y_slice - mu) + mu, lik

    def extra_outputs(self, y, training: bool, beta, lv: int) -> dict:
        return {}

    def apply_synthesis(self, y_hat, lv: int):
        return self.g_s(y_hat)

    # -------------------------- gain hooks --------------------------
    # Identities here; the gain codecs (models/gain/gained.py) scale y and z
    # by level lv's channel gains and undo it before the synthesis.

    def gain_y(self, y, lv: int):
        return y

    def gain_z(self, z, lv: int):
        return z

    def inv_gain_z(self, z_hat, lv: int):
        return z_hat

    def inv_gain_y(self, y_hat, lv: int):
        return y_hat

    def forward(self, x, training: bool = False, noise=None, lv: int = 0, beta=None):
        """Rate-distortion forward (NCHW) at rate level ``lv`` (STanH
        temperature ``beta``; the plain codecs ignore both). Each slice goes
        through ``slice_entropy``, then the LRP; y_hat through
        ``apply_synthesis``. With ``training`` the noise comes from
        ``noise(shape)``, called for z and then for each slice that draws."""
        if training and noise is None:
            raise ValueError("the training forward needs a noise callable")
        y = self.gain_y(self.g_a(x), lv)
        y_shape = y.shape[2:]
        z = self.gain_z(self.h_a(y), lv)
        eb = self.entropy_bottleneck
        z_noise = noise(eb.noise_shape(z)) if training else None
        _, z_likelihoods = eb(z, training=training, noise=z_noise)
        z_offset = self._z_offset()
        z_hat = self.inv_gain_z(ste_round(z - z_offset) + z_offset, lv)
        latent_scales = self.h_scale_s(z_hat)
        latent_means = self.h_mean_s(z_hat)

        y_hat_slices, y_lik, mu_list, scale_list = [], [], [], []
        for i, y_slice in enumerate(y.chunk(self.num_slices, dim=1)):
            support = self.slice_support(y_hat_slices)
            mu, sigma, mean_support = self._mu_sigma(i, latent_means, latent_scales, support,
                                                     y_shape)
            mu_list.append(mu)
            scale_list.append(sigma)
            y_hat_slice, lik = self.slice_entropy(i, y_slice, sigma, mu, training, beta, lv,
                                                  noise)
            y_lik.append(lik)
            y_hat_slices.append(self._lrp(i, mean_support, y_hat_slice))

        x_hat = self.apply_synthesis(self.inv_gain_y(torch.cat(y_hat_slices, dim=1), lv), lv)
        out = {
            "x_hat": x_hat,
            "likelihoods": {"y": torch.cat(y_lik, dim=1), "z": z_likelihoods},
            "para": {"means": torch.cat(mu_list, dim=1), "scales": torch.cat(scale_list, dim=1),
                     "y": y},
        }
        out.update(self.extra_outputs(y, training, beta, lv))
        return out

    def aux_loss(self) -> torch.Tensor:
        """The entropy bottleneck's quantile loss (the aux optimiser's)."""
        return self.entropy_bottleneck.aux_loss()

    # ------------------------- codec-path pieces -------------------------

    def analysis(self, x, lv: int = 0):
        """(y, z, z_hat) at rate level lv, in the gained domain; z_hat is
        exactly what the decoder rebuilds from the z bitstream."""
        y = self.gain_y(self.g_a(x), lv)
        z = self.gain_z(self.h_a(y), lv)
        z_offset = self._z_offset()
        return y, z, torch.round(z - z_offset) + z_offset

    def hyper_synthesis(self, z_hat, lv: int = 0):
        """(latent means, latent scales) of the decoded z_hat (gained domain)."""
        z_hat = self.inv_gain_z(z_hat, lv)
        return self.h_mean_s(z_hat), self.h_scale_s(z_hat)

    def decode_slice_params(self, i: int, latent_means, latent_scales, y_hat_slices, y_shape,
                            scale_table):
        """Per-slice decode step: (mu, uint8 scale indexes, mean_support)."""
        support = self.slice_support(y_hat_slices)
        mu, sigma, mean_support = self._mu_sigma(i, latent_means, latent_scales, support,
                                                 y_shape)
        return mu, build_indexes(sigma, scale_table).to(torch.uint8), mean_support

    def quantize_slice(self, i: int, y, mu, lv: int = 0):
        """int16 symbols round(y_i - mu) of slice i."""
        c = self.M // self.num_slices
        return torch.round(y[:, i * c : (i + 1) * c] - mu).to(torch.int16)

    def decode_slice_dequant_finish(self, i: int, mean_support, symbols, mu, lv: int = 0):
        """Dequantize the int16 symbols and apply the LRP refinement."""
        return self._lrp(i, mean_support, symbols.to(mu.dtype) + mu)

    def synthesize(self, y_hat, lv: int = 0):
        """The clipped image of the coded y_hat (gained domain)."""
        return torch.clamp(self.apply_synthesis(self.inv_gain_y(y_hat, lv), lv), 0.0, 1.0)


class ChannelARCodec:
    """A ChannelARModule on a device plus the host rANS coder (the
    reference's update() / compress() / decompress() / forward API). Each
    pass runs under ``fp32_numerics``, whatever the caller's TF32 flags."""

    def __init__(self, module: ChannelARModule, device):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.gaussian_conditional = GaussianConditional()
        self.eb_tables: fz.CodingTables | None = None
        self._scale_table: torch.Tensor | None = None
        self._medians: np.ndarray | None = None

    def _input(self, x) -> torch.Tensor:
        """NHWC image(s) in [0, 1] -> NCHW float32 on the codec's device. A
        host array reaches the card through pinned memory without blocking
        the host, so the caller can enqueue work ahead of the card."""
        t = torch.as_tensor(x, dtype=torch.float32)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return to_nchw(t.to(self.device))

    @fp32_numerics()
    def update(self):
        """Build the integer CDF tables (must run before real coding)."""
        self.gaussian_conditional.update_scale_table()
        eb = self.module.entropy_bottleneck
        self.eb_tables = fz.build_tables(eb.chain_params(), eb.filters)
        self._scale_table = torch.from_numpy(self.gaussian_conditional.scale_table).to(self.device)
        self._medians = eb.medians().cpu().numpy()
        return True

    def _require_tables(self):
        if self.eb_tables is None:
            raise RuntimeError("call update() before compress() or decompress()")

    def y_tables(self, lv: int = 0) -> fz.CodingTables:
        """The CDF tables that code y at rate level ``lv`` (one set here)."""
        return self.gaussian_conditional.tables

    @torch.no_grad()
    @fp32_numerics()
    def forward(self, x, lv: int = 0) -> dict:
        """Eval forward (bpp estimate) of NHWC images at rate level ``lv``;
        outputs NHWC."""
        out = self.module(self._input(x), lv=lv)
        return {
            "x_hat": to_nhwc(out["x_hat"]),
            "likelihoods": {k: to_nhwc(v) for k, v in out["likelihoods"].items()},
            "para": {k: to_nhwc(v) for k, v in out["para"].items()},
        }

    def compress(self, x, lv: int = 0) -> dict:
        """x: NHWC in [0, 1], batch 1, coded at rate level ``lv``. Returns
        {"strings": [[y], [z]], "shape", "y_hat"}: the reference's two keys
        plus the encoder's y_hat (NHWC), which the decoder must reproduce
        exactly."""
        if x.shape[0] != 1:
            raise ValueError("compress() codes one image per call; use compress_batch()")
        return self.compress_batch(x, lv)[0]

    @torch.no_grad()
    @fp32_numerics()
    def _encode_device_stage(self, x, lv: int = 0) -> dict:
        """The encoder's device work for a batch of NHWC images at rate
        level ``lv``, enqueued without blocking: symbols (int16) and scale
        indexes (uint8), [B, n] ordered slice by slice and channel-major
        within a slice, and the NCHW z, each copied into a host buffer
        (pinned on the card); ``ready``, the CUDA event after the copies
        (None on the CPU); and y_hat, the NHWC latent on the device that the
        decoder must reproduce."""
        self._require_tables()
        m = self.module
        xc = self._input(x)
        b = xc.shape[0]
        y, z, z_hat = m.analysis(xc, lv)
        y_shape = tuple(y.shape[2:])
        latent_means, latent_scales = m.hyper_synthesis(z_hat, lv)
        syms, idxs, y_hat_slices = [], [], []
        for i in range(m.num_slices):
            mu, indexes, mean_support = m.decode_slice_params(
                i, latent_means, latent_scales, y_hat_slices, y_shape, self._scale_table)
            sym = m.quantize_slice(i, y, mu, lv)
            y_hat_slices.append(m.decode_slice_dequant_finish(i, mean_support, sym, mu, lv))
            syms.append(sym)
            idxs.append(indexes)
        staged = {"y_hat": to_nhwc(torch.cat(y_hat_slices, dim=1)), "ready": None}
        for key, t in (("symbols", torch.stack(syms, dim=1).reshape(b, -1)),
                       ("indexes", torch.stack(idxs, dim=1).reshape(b, -1)), ("z", z)):
            staged[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            staged[key].copy_(t, non_blocking=True)
        if xc.is_cuda:
            staged["ready"] = torch.cuda.Event(blocking=True)
            staged["ready"].record()
        return staged

    @staticmethod
    def _encode_host_stage(staged: dict):
        """(symbols, indexes, z, y_hat) of a staged batch once its copies
        have landed: int32 [B, n] numpy arrays, z NCHW numpy, y_hat as
        staged."""
        if staged["ready"] is not None:
            staged["ready"].synchronize()
        return (staged["symbols"].numpy().astype(np.int32),
                staged["indexes"].numpy().astype(np.int32), staged["z"].numpy(), staged["y_hat"])

    def encode_symbols(self, x, lv: int = 0):
        """The encoder up to the entropy coder: (symbols, indexes, z, y_hat)
        for a batch of NHWC images at rate level ``lv`` (``_encode_host_stage``
        of ``_encode_device_stage``)."""
        return self._encode_host_stage(self._encode_device_stage(x, lv))

    def compress_batch(self, x, lv: int = 0) -> list[dict]:
        """Encode a batch at rate level ``lv``: the device stage, then each
        image's y and z streams on the host."""
        return self._code_staged(self._encode_device_stage(x, lv), lv)

    def _code_staged(self, staged: dict, lv: int) -> list[dict]:
        """The host stage of a staged batch: wait for its copies, then code
        each image's y and z streams (one thread per image)."""
        symbols, indexes, z, y_hat = self._encode_host_stage(staged)
        b, _, zh, zw = z.shape
        t = self.y_tables(lv)

        def encode_one(j):
            from ..coding.rans import encode_with_indexes

            y_string = encode_with_indexes(symbols[j], indexes[j], t.quantized_cdf,
                                           t.cdf_length, t.offset)
            z_strings = fz.compress(z[j : j + 1], self._medians, self.eb_tables)
            return {"strings": [[y_string], z_strings], "shape": (int(zh), int(zw)),
                    "y_hat": y_hat[j : j + 1]}

        if b == 1:
            return [encode_one(0)]
        with ThreadPoolExecutor(max_workers=min(8, b)) as pool:
            return list(pool.map(encode_one, range(b)))

    def compress_pipelined(self, batches, lv: int = 0) -> list[dict]:
        """Encode a sequence of NHWC batches at rate level ``lv`` with the
        device and the host overlapped: each batch's device stage is
        enqueued while a worker thread waits for an earlier batch's copies
        and codes it. Returns ``compress_batch``'s dicts, batch after batch."""
        futures = []
        with ThreadPoolExecutor(max_workers=2) as pool:
            for x in batches:
                futures.append(pool.submit(self._code_staged, self._encode_device_stage(x, lv),
                                           lv))
            return [enc for f in futures for enc in f.result()]

    def roundtrip_pipelined(self, batches, lv: int = 0, decode_workers: int = 2) -> list[dict]:
        """Encode and decode a sequence of NHWC batches at rate level ``lv``
        with the two directions overlapped: batch i decodes in one of
        ``decode_workers`` threads while later batches encode. Returns per
        batch {"encs": compress_batch's dicts, "x_hat", "y_hat"}
        (``decompress_batch``'s, NHWC)."""
        def decode(encs):
            dec = self.decompress_batch([e["strings"] for e in encs], encs[0]["shape"], lv)
            return {"encs": encs, "x_hat": dec["x_hat"], "y_hat": dec["y_hat"]}

        with ThreadPoolExecutor(max_workers=2) as enc_pool, \
                ThreadPoolExecutor(max_workers=decode_workers) as dec_pool:
            encoded = [enc_pool.submit(self._code_staged, self._encode_device_stage(x, lv), lv)
                       for x in batches]
            decoded = [dec_pool.submit(decode, f.result()) for f in encoded]
            return [f.result() for f in decoded]

    def decompress(self, strings, shape, lv: int = 0) -> dict:
        return self.decompress_batch([strings], shape, lv)

    @torch.no_grad()
    @fp32_numerics()
    def decompress_batch(self, strings_list, shape, lv: int = 0) -> dict:
        """Decode B bitstreams coded at rate level ``lv`` together; each
        image keeps its own rANS decoder state. Returns {"x_hat": NHWC in
        [0, 1], "y_hat": NHWC}."""
        self._require_tables()
        from ..coding.rans import RansDecoder

        m = self.module
        z_hat = np.concatenate(
            [fz.decompress(s[1], shape, self._medians, self.eb_tables) for s in strings_list],
            axis=0)
        latent_means, latent_scales = m.hyper_synthesis(torch.from_numpy(z_hat).to(self.device),
                                                        lv)
        y_shape = (shape[0] * 4, shape[1] * 4)
        t = self.y_tables(lv)
        b = len(strings_list)
        decoders = []
        for s in strings_list:
            d = RansDecoder()
            d.set_stream(s[0][0])
            decoders.append(d)

        def decode_slice(j, idx_np):
            return decoders[j].decode_stream(idx_np[j].reshape(-1), t.quantized_cdf,
                                             t.cdf_length, t.offset)

        y_hat_slices = []
        pool = ThreadPoolExecutor(max_workers=min(8, b)) if b > 1 else None
        try:
            for i in range(m.num_slices):
                mu, indexes, mean_support = m.decode_slice_params(
                    i, latent_means, latent_scales, y_hat_slices, y_shape, self._scale_table)
                idx_np = indexes.cpu().numpy()
                if pool is None:
                    rows = [decode_slice(0, idx_np)]
                else:
                    rows = list(pool.map(lambda j: decode_slice(j, idx_np), range(b)))
                sym = torch.from_numpy(
                    np.stack(rows).reshape(idx_np.shape).astype(np.int16)).to(self.device)
                y_hat_slices.append(
                    m.decode_slice_dequant_finish(i, mean_support, sym, mu, lv))
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        y_hat = torch.cat(y_hat_slices, dim=1)
        return {"x_hat": to_nhwc(m.synthesize(y_hat, lv)), "y_hat": to_nhwc(y_hat)}
