"""Evaluation CLI (port of reslic_tcm_tpu/cli/eval.py).

Same flags and report lines as the JAX CLI. ``--model tcm`` (the default)
loads a TCM checkpoint, pads each image to a multiple of 128, then either
runs the real codec (``--real``: compress -> decompress through the host
rANS coder, or with ``--device-coder`` through the analytic device coder,
``compress_device_analytic`` -> ``decompress_device_analytic``, bpp from
the container's size) or the forward-only bpp estimate, and reports PSNR,
MS-SSIM (dB), bpp and time; its loop is ``evaluate(codec, images)``,
callable with arrays. Every other registry name the port builds takes the JAX CLI's
generic branch: the real codec through
``training.codec_eval.compress_with_ac`` (pad 64) or the pad-128 forward
estimate, one ``[level lv] ...`` line per rate level (``--lv``: one level,
-1 every level of a variable-rate codec, one per lambda; the STanH codecs
take the quantizer knobs they were trained with from ``--lambda_list`` and
``--gauss_*``; the gained hyperprior codes level lv at s=lv, l=0).
``scale_gain_sc`` needs a quality map and is refused, as by the JAX CLI;
``--device-coder`` with another model than TCM is refused too (the JAX CLI
reads it only on its TCM branch).
On the TCM forward-estimate branch, as in the JAX CLI, ``--shard-spatial n``
splits each padded image's rows over the n ranks of a process group
(``parallel/spatial.py::mesh_sharded_forward``; one process per rank, e.g.
``torchrun --nproc-per-node n``; n = 1 sets up a world of one), else
``--tile t`` (with ``--tile-overlap``) runs an image whose padded side
exceeds t as overlapping tiles (``tiled_forward``).
``--bf16`` (TCM only, as the JAX CLI reads it only on its TCM branch) sets
the codec's matmul precision to bfloat16 after it is built
(``ChannelARCodec.set_matmul_precision``): the forward estimate, the real
codec (host or device coder) and the tiled forward run with bf16 operands
and fp32 sums; ``--shard-spatial``'s forward stays fp32, as the JAX CLI
runs it outside the codec's programs.
``--checkpoint`` takes a ``.npz`` snapshot, a reference PyTorch state dict
or a checkpoint the train CLI saved (``load_checkpoint``); an orbax
directory of the JAX package is refused. Images are read by
``data/datasets.py::read_image`` (PNG and PPM without Pillow).
Runs on the CUDA device unless ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..data.datasets import list_images, read_image
from ..ops.launches import launch_counts, launches_since
from ..ops.math import compute_padding, crop_nhwc, pad_nhwc
from ..training.codec_eval import compress_with_ac, sync
from ..utils.metrics import compute_psnr, ms_ssim, msssim_to_db

PAD = 128


def parse_args(argv):
    parser = argparse.ArgumentParser(description="Example testing script.")
    parser.add_argument("--cuda", action="store_true", help="Use cuda")
    parser.add_argument("--clip_max_norm", default=1.0, type=float,
                        help="gradient clipping max norm (default: %(default)s")
    parser.add_argument("--checkpoint", type=str, help="Path to a checkpoint")
    parser.add_argument("--data", type=str, help="Path to dataset")
    parser.add_argument("--real", action="store_true", default=True)
    parser.set_defaults(real=False)
    parser.add_argument("--N", type=int, default=128)
    parser.add_argument("--M", type=int, default=320)
    parser.add_argument("--platform", type=str, default=None,
                        help="cpu to run on the CPU (default: the CUDA device)")
    parser.add_argument("--tile", type=int, default=0)
    parser.add_argument("--tile-overlap", type=int, default=64)
    parser.add_argument("--shard-spatial", type=int, default=0)
    parser.add_argument("--device-coder", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--model", type=str, default="tcm")
    parser.add_argument("--lambda_list", nargs="+", type=float, default=[0.0025])
    parser.add_argument("--gauss_num_sigmoids", nargs="+", type=int, default=None)
    parser.add_argument("--gauss_extrema", nargs="+", type=int, default=None)
    parser.add_argument("--gauss_trainable", nargs="+", type=str, default=None)
    parser.add_argument("--lv", type=int, default=-1)
    return parser.parse_args(argv)


def evaluate(codec, images, real: bool = True, log=print, device_coder: bool = False,
             tile: int = 0, tile_overlap: int = 64, shard_spatial: int = 0) -> dict:
    """Evaluate ``codec`` on HWC float32 images in [0, 1], each padded to a
    multiple of 128. Returns the averages and one record per image: bpp (the
    coded size with ``real``, else the forward estimate), PSNR, MS-SSIM in
    dB, times in ms, the kernel launches of each pass and, with ``real``,
    whether the decoder reproduced the encoder's y_hat exactly. With
    ``device_coder`` the real codec is the analytic device coder. The
    forward estimate runs spatially sharded over the ``shard_spatial``
    ranks of the process group, else tiled when ``tile`` is set and the
    padded image's larger side exceeds it (``_forward_estimate``)."""
    dev = codec.device
    # the launches counted are those of the codec's precision's instances
    cd = getattr(codec, "compute_dtype", torch.float32)
    records = []
    for img in images:
        x = torch.as_tensor(img, dtype=torch.float32, device=dev)[None]
        h, w = x.shape[1], x.shape[2]
        pad, _ = compute_padding(h, w, PAD)
        xp = pad_nhwc(x, pad)
        rec = {}
        if real:
            sync(dev)
            before, t0 = launch_counts(cd), time.perf_counter()
            enc = codec.compress_device_analytic(xp) if device_coder else codec.compress(xp)
            sync(dev)
            t1 = time.perf_counter()
            rec["launches_compress"] = launches_since(before, cd)
            before = launch_counts(cd)
            dec = (codec.decompress_device_analytic(enc) if device_coder
                   else codec.decompress(enc["strings"], enc["shape"]))
            sync(dev)
            t2 = time.perf_counter()
            rec["launches_decompress"] = launches_since(before, cd)
            rec.update(encode_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                       y_hat_exact=bool(torch.equal(enc["y_hat"], dec["y_hat"])))
            x_hat = crop_nhwc(dec["x_hat"], pad)
            nbytes = (enc["nbytes"] if device_coder else
                      len(enc["strings"][0][0]) + sum(len(s) for s in enc["strings"][1]))
            rec["bpp"] = nbytes * 8.0 / (h * w)
        else:
            sync(dev)
            before, t0 = launch_counts(cd), time.perf_counter()
            x_hat, bits, pixels = _forward_estimate(codec, xp, tile, tile_overlap, shard_spatial)
            sync(dev)
            rec["forward_ms"] = (time.perf_counter() - t0) * 1e3
            rec["launches_forward"] = launches_since(before, cd)
            x_hat = crop_nhwc(x_hat, pad)
            rec["bpp"] = bits / pixels
        rec["psnr"] = compute_psnr(x, x_hat)
        rec["ms_ssim_db"] = msssim_to_db(float(ms_ssim(x, x_hat)))
        if real:
            log(f"Bitrate: {rec['bpp']:.3f}bpp")
            log(f"MS-SSIM: {rec['ms_ssim_db']:.2f}dB")
            log(f"PSNR: {rec['psnr']:.2f}dB")
        else:
            log(f"PSNR: {rec['psnr']:.2f}dB")
            log(f"MS-SSIM: {rec['ms_ssim_db']:.2f}dB")
            log(f"Bit-rate: {rec['bpp']:.3f}bpp")
        records.append(rec)
    n = len(records)
    times = [r.get("forward_ms", r.get("encode_ms", 0.0) + r.get("decode_ms", 0.0))
             for r in records]
    summary = {
        "psnr": sum(r["psnr"] for r in records) / n,
        "ms_ssim_db": sum(r["ms_ssim_db"] for r in records) / n,
        "bpp": sum(r["bpp"] for r in records) / n,
        "time_ms": sum(times) / n,
        "records": records,
    }
    log(f"average_PSNR: {summary['psnr']:.2f}dB")
    log(f"average_MS-SSIM: {summary['ms_ssim_db']:.4f}")
    log(f"average_Bit-rate: {summary['bpp']:.3f} bpp")
    log(f"average_time: {summary['time_ms']:.3f} ms")
    return summary


def _forward_estimate(codec, xp, tile: int, tile_overlap: int, shard_spatial: int):
    """(x_hat clipped, NHWC at xp's size; bits; the pixels they cover) of the
    padded NHWC image ``xp``, as the JAX CLI's forward branch: spatially
    sharded (rows padded, edge values repeated, to a multiple of 128 a
    rank; halo min(128, rows a rank)), tiled, or the monolithic forward."""
    from ..ops.layers import to_nchw, to_nhwc
    from ..parallel.spatial import mesh_sharded_forward, tiled_forward, total_bits

    hp, wp = xp.shape[1], xp.shape[2]
    if shard_spatial:
        rows = -(-hp // (128 * shard_spatial)) * (128 * shard_spatial)
        xs = torch.nn.functional.pad(to_nchw(xp), (0, 0, 0, rows - hp), mode="replicate")
        x_hat, bits = mesh_sharded_forward(codec.module, xs, None,
                                           min(128, rows // shard_spatial))
        return to_nhwc(x_hat)[:, :hp], bits, rows * wp
    if tile and max(hp, wp) > tile:
        x_hat, bits = tiled_forward(codec, xp, tile, tile_overlap)
        return x_hat, bits, hp * wp
    out = codec.forward(xp)
    return torch.clamp(out["x_hat"], 0, 1), total_bits(out["likelihoods"]), hp * wp


def load_checkpoint(codec, path: str) -> None:
    """A committed ``.npz`` snapshot of JAX parameters, a reference PyTorch
    ``.pth``/``.pth.tar``/``.pt`` state dict, or a checkpoint of the train
    CLI (``utils/checkpoint.py::save_checkpoint``, any other file name:
    ``.ckpt`` in practice). A snapshot must hold every parameter of the
    codec (entries it has no place for are listed). A PyTorch file loads
    non-strictly, as the JAX CLI's converter loads it
    (``utils/torch_convert.py::warm_start_codec``: CDF buffers ignored,
    parameters without a twin in the file kept at their init), and the
    missing and unused counts are printed. A train CLI checkpoint's
    ``state_dict`` loads strictly, as the JAX CLI loads its own trainer's
    parameters. The caller's ``update()`` then rebuilds the derived tables
    from the loaded parameters."""
    from ..utils.checkpoint import load_checkpoint as load_train_checkpoint
    from ..utils.torch_convert import load_snapshot_into, warm_start_codec

    if path.endswith(".npz"):
        unused = load_snapshot_into(codec.module, path, allow_unused=True)
        if unused:
            print(f"ignored {len(unused)} snapshot entries: {', '.join(unused)}")
        return
    if path.endswith((".pth", ".pth.tar", ".pt")):
        report = warm_start_codec(codec, path, log=False)
        if report["missing"] or report["unused"]:
            print(f"converter: {len(report['missing'])} missing, "
                  f"{len(report['unused'])} unused torch keys")
        return
    if os.path.isdir(path):
        raise NotImplementedError(
            "orbax checkpoint directories need JAX: snapshot them to .npz with the "
            "repository's snapshot_ckpt.py first")
    codec.module.load_state_dict(load_train_checkpoint(path)["state_dict"], strict=True)


def _device(args) -> torch.device:
    device = torch.device("cpu" if args.platform == "cpu" else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass --platform cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return device


def _eval_generic(args, device, img_list) -> int:
    """Any registry model the port builds: the real codec through
    ``compress_with_ac`` or the pad-128 forward estimate, at ``--lv`` or at
    every rate level. The model is built from the train parser's defaults
    with this CLI's model, widths, lambdas and quantizer knobs, as the JAX
    CLI builds it."""
    from ..models import get_model
    from ..utils.parser import parse_args as train_parse

    targs = train_parse([])
    targs.model, targs.N, targs.M = args.model, args.N, args.M
    targs.lambda_list = args.lambda_list
    for knob in ("gauss_num_sigmoids", "gauss_extrema", "gauss_trainable"):
        if getattr(args, knob) is not None:
            setattr(targs, knob, getattr(args, knob))
    codec, *_ = get_model(targs, device=device)
    if args.checkpoint:
        print("Loading", args.checkpoint)
        load_checkpoint(codec, args.checkpoint)
    n_levels = getattr(codec.module, "n_rates", getattr(codec.module, "levels", 1))
    levels = [args.lv] if args.lv >= 0 else list(range(n_levels))
    if args.real:
        codec.update()
        for lv in levels:
            bpp, psnr_v = compress_with_ac(codec, (read_image(p) for p in img_list), lv=lv)
            print(f"[level {lv}] average_Bit-rate: {bpp:.3f} bpp | "
                  f"average_PSNR: {psnr_v:.2f}dB")
        return 0
    for lv in levels:
        psnr_sum = bit_rate = 0.0
        for path in img_list:
            x = torch.as_tensor(read_image(path), device=device)[None]
            pad, _ = compute_padding(x.shape[1], x.shape[2], PAD)
            xp = pad_nhwc(x, pad)
            out = codec.forward(xp, lv=lv)
            x_hat = crop_nhwc(torch.clamp(out["x_hat"], 0, 1), pad)
            num_pixels = xp.shape[1] * xp.shape[2]
            bit_rate += sum(float(-torch.log2(lik).sum())
                            for lik in out["likelihoods"].values()) / num_pixels
            psnr_sum += compute_psnr(x, x_hat)
        n = len(img_list)
        print(f"[level {lv}] average_PSNR: {psnr_sum / n:.2f}dB | "
              f"average_Bit-rate: {bit_rate / n:.3f} bpp")
    return 0


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.device_coder and args.model != "tcm":
        raise NotImplementedError(
            f"--device-coder codes TCM only, as in the JAX CLI (its other models take the host "
            f"coder); drop it for --model {args.model}")
    if args.bf16 and args.model != "tcm":
        raise NotImplementedError(
            f"--bf16 runs TCM only, as the JAX CLI reads it only on its TCM branch; the other "
            f"codecs take the bf16 mode through their set_matmul_precision(\"bfloat16\"): drop "
            f"it for --model {args.model}")
    device = _device(args)
    if not args.shard_spatial:
        return _main(args, device, print)
    from ..parallel.multihost import ensure_world, is_coordinator

    created = not torch.distributed.is_initialized()
    ensure_world(args.shard_spatial, device)
    try:
        return _main(args, device, print if is_coordinator() else lambda *_: None)
    finally:
        if created:
            torch.distributed.destroy_process_group()


def _main(args, device, log) -> int:
    from ..models.tcm import make_tcm

    img_list = list_images(args.data)
    if not img_list:
        print(f"no images under {args.data}")
        return 1
    if args.model == "scale_gain_sc":
        print("scale_gain_sc needs a quality map input; evaluate it via "
              "tests/test_gain_models.py or a script of your own")
        return 1
    if args.model != "tcm":
        return _eval_generic(args, device, img_list)
    codec = make_tcm(N=args.N, M=args.M, device=device)
    if args.bf16:
        codec.set_matmul_precision("bfloat16")
    if args.checkpoint:
        print("Loading", args.checkpoint)
        load_checkpoint(codec, args.checkpoint)
    if args.real:
        codec.update()
    evaluate(codec, (read_image(p) for p in img_list), real=args.real, log=log,
             device_coder=args.device_coder, tile=args.tile, tile_overlap=args.tile_overlap,
             shard_spatial=args.shard_spatial)
    return 0


if __name__ == "__main__":
    sys.exit(main())
