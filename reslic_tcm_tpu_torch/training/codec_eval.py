"""Real-codec evaluation (port of reslic_tcm_tpu/training/codec_eval.py):
pad each image to a multiple of 64, compress -> decompress through the
host rANS coder, and report bpp from the true stream sizes and PSNR and
MS-SSIM from the decoded pixels.
"""

from __future__ import annotations

import time

import torch

from ..ops.launches import launch_counts, launches_since
from ..ops.math import compute_padding, crop_nhwc, pad_nhwc
from ..utils.helper import AverageMeter
from ..utils.metrics import ms_ssim, psnr


def bpp_calculation(num_pixels: int, strings) -> tuple[float, float, float]:
    """(total, hyper, main) bpp from stream lengths. A codec with one stream
    group (FactorizedPrior: y alone) has a hyper bpp of 0; the JAX function
    reads ``strings[1]`` whatever the codec and raises there."""
    bpp_hyper = sum(len(s) for s in strings[1]) * 8.0 / num_pixels if len(strings) > 1 else 0.0
    bpp_main = len(strings[0][0]) * 8.0 / num_pixels
    return bpp_hyper + bpp_main, bpp_hyper, bpp_main


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rate_kwargs(codec, lv: int) -> dict:
    """The keywords that code at rate level ``lv``: a gained hyperprior's
    (s=lv, l=0), what the JAX function falls back to for it, else lv."""
    from ..models.gain.gained import GainedHyperpriorCodec
    from ..models.gain.sc import SCGainedCodec

    if isinstance(codec, SCGainedCodec):
        raise ValueError("scale_gain_sc needs a quality map input, which compress_with_ac "
                         "does not take: call its compress(x, qmap, s, l)")
    if isinstance(codec, GainedHyperpriorCodec):
        return {"s": lv, "l": 0.0}
    return {"lv": lv}


def compress_with_ac(codec, images, lv: int = 0, min_div: int = 64, verbose: bool = True,
                     log=print, records: list | None = None):
    """Average (bpp, psnr) over HWC float32 images in [0, 1] through the real
    codec at rate level ``lv`` (``rate_kwargs``). With ``records``, appends one dict per image: bpp (total, y, z),
    PSNR, MS-SSIM (None below its minimum size), encode and decode ms (host
    clock around work that ends in a device synchronise), the kernel
    launches of each pass, whether the decoder reproduced the encoder's
    y_hat exactly, and the decoded NHWC x_hat of the padded image."""
    bpp_m, psnr_m, ssim_m = AverageMeter(), AverageMeter(), AverageMeter()
    dev = codec.device
    rate = rate_kwargs(codec, lv)
    for i, img in enumerate(images):
        x = torch.as_tensor(img, dtype=torch.float32, device=dev)[None]
        h, w = x.shape[1], x.shape[2]
        pad, _ = compute_padding(h, w, min_div=min_div)
        x_padded = pad_nhwc(x, pad)
        sync(dev)
        before, t0 = launch_counts(), time.perf_counter()
        enc = codec.compress(x_padded, **rate)
        sync(dev)
        t1 = time.perf_counter()
        launches_compress, before = launches_since(before), launch_counts()
        dec = codec.decompress(enc["strings"], enc["shape"], **rate)
        sync(dev)
        t2 = time.perf_counter()
        launches_decompress = launches_since(before)

        x_hat = crop_nhwc(torch.clamp(dec["x_hat"], 0, 1), pad)
        bpp, bpp_h, bpp_y = bpp_calculation(h * w, enc["strings"])
        p = float(psnr(x, x_hat))
        bpp_m.update(bpp)
        psnr_m.update(p)
        try:
            s = float(ms_ssim(x, x_hat))
            ssim_m.update(s)
        except ValueError:
            s = None  # image too small for 5-scale MS-SSIM
        if verbose:
            log(f"[{i}] bpp={bpp:.4f} (y={bpp_y:.4f} z={bpp_h:.4f}) psnr={p:.2f}")
        if records is not None:
            records.append({
                "bpp": bpp, "bpp_y": bpp_y, "bpp_z": bpp_h, "psnr": p, "ms_ssim": s,
                "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
                "launches_compress": launches_compress,
                "launches_decompress": launches_decompress,
                "y_hat_exact": bool(torch.equal(enc["y_hat"], dec["y_hat"])),
                "x_hat": dec["x_hat"],
            })
    return bpp_m.avg, psnr_m.avg
