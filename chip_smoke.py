#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py                 # on a machine with the card
    python3 chip_smoke.py --cpu-rehearsal # the slices, train and CLI phases on the CPU, no card

Drives reslic_tcm_tpu_torch only (no JAX; Pillow is not used, whether or not
it is installed), in these phases:

1. Device: the card's name and power limit; TF32 off, cuDNN deterministic.
2. Build: every library of ops/build.py's SOURCES (the kernels of B1-B4
   in fp32 and bf16, the device coder's kernels: nvcc, one process per
   library, all at once; the host rANS coder: g++) into
   reslic_tcm_tpu_torch/_build/.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths of TCM-S, TCM N=128, TCM N=192 and WACNN give
   it (768x512 image): max abs error against 1e-4 * max(1, max |plain|),
   time per call (CUDA events after warm-up, the wrapper's host work
   included) and the device time per call (torch.profiler, every kernel the
   call runs), the plain version's time, and the least time the card could
   take (fp32 CUDA-core peak 67 TFLOP/s vs 3.35 TB/s, whichever binds),
   the achieved TFLOP/s and share of that bound (device time), and each
   slice's sum per forward pass. B2 and B3 also print the tile the wrapper
   chose and run the other tile on the same input: the two outputs must be
   equal, bit for bit (the other tile's device time is printed beside).
   B1's attention-only flavour runs at every cluster it has an instance for
   and B4 at every (windows per CTA, CTAs per cluster): each output must
   equal the wrapper's choice's, bit for bit. B4's library time is one
   F.multi_head_attention_forward call (rel_bias + mask as its additive
   attn_mask, built outside the timed region), held against the plain
   version; B1's attention-only flavour gets the same call on the
   pre-partitioned windows, with partition, roll and residual outside it.
   Then each split of B1 (LN+MLP: the smallest cluster, one CTA per window
   or two at C=192, and the largest; attention-only: every cluster) and of
   B4 runs on the same input at the main-path shapes and around the
   choices' thresholds: the outputs must be equal, bit for bit, and the
   kernel's device time over 10 interleaved rounds of launches is printed.
   Where the profiler loses kernel records three times over, a device time
   is printed as not measured (NaN or null) beside the CUDA-event time.
   Then the bf16 instances (csrc/fused_conv_bf16.cu,
   csrc/flash_window_attn_bf16.cu, csrc/window_attn_bf16.cu) at the TCM-S,
   N=128 and N=192 main-path shapes of B1 (LN+MLP), B2 and B3, and at
   WACNN N=192's and N=128's of B1's attention-only flavour (a row of its
   own, flash_window_block_attn_bf16): each against its plain bf16 version
   on the card (max abs error against 4e-3 * max(1, max |plain|): the two
   round the same operands to bf16 and sum in other orders, so a value can
   round to the neighbouring bf16 value), its device time beside the fp32
   instance's on the same input (both with prepared weights), the bound
   (bf16 tensor-core peak 989 TFLOP/s vs 3.35 TB/s, weights counted in
   bf16); B2/B3's other tile, B1 LN+MLP's every (cluster, windows a CTA)
   (flash_window_block_at) and the attention-only flavour's every option
   (attn_bf16_forces: each cluster at several persistent grids) on the
   same input give the same bits. The attention-only row also times one
   F.multi_head_attention_forward call in bf16 (its library yardstick,
   held to the plain bf16 version at the same tolerance).
4. TCM slices, each evaluate() on two seeded 768x512 synthetic images, the
   forward estimate and then real compress -> decompress, asserting an
   exact decode of y_hat, the documented kernel launches per pass, and
   agreement with the CPU plain path on a small image:
   TCM-S (N=64, M=320) with the committed lambda=0.013 weights (real bpp
   within 3% of the estimate); TCM N=128 (the eval CLI's default width)
   and TCM N=192 (the train CLI's default width), M=320, with seeded random
   weights (bpp printed, not held to a limit).
5. compress_with_ac slices: WACNN (N=192, M=320) and the three Balle-2018
   codecs (factorized, scale and mean-scale hyperprior, N=192, M=320) with
   seeded random weights: the forward estimate (evaluate()) and the real
   codec (training.codec_eval.compress_with_ac) on the same two images.
   Asserts an exact decode of y_hat, a decoded x_hat equal to the forward's
   clipped x_hat within 1e-5, the documented launches per pass (WACNN: B1
   and B4; Balle: none, no kernel lies on its path), and agreement with the
   CPU plain path on a small image. Real vs estimated bpp is printed, not
   held to a limit: with random weights tail symbols may take the coder's
   bypass.
5a. STanH slices, each level of three in turn on the same two images:
   WACNN-STanH (N=192, M=320) with the committed trained
   checkpoints/wacnn_stanh_vr_r5.npz (16 steps per level, extrema 32/16/8,
   lambda 0.0025/0.013/0.05): the forward estimate,
   forward_codec_consistent, compress and decompress; exact y_hat (also
   forward_codec_consistent's), real bpp within 3% of the codec-consistent
   estimate, bpp and PSNR per level, both rising from level 0 to level 2
   (finer steps buy quality with rate), the share of y symbols where the
   monolithic forward's staircase differs from the codec's (printed), and
   WACNN's launches per pass (forward_codec_consistent: g_a and g_s); then
   the card's forward at level 1 against the CPU plain path on a 256x256
   image (symbols that round the other way counted and held to 0.1%).
   TCM-STanH N=128 (the registry's `-m stanh` with three lambdas: 160
   steps at extrema 80) with random weights: TCM's launches per pass and
   an exact decode at each level. The scale hyperprior with STanH on y and
   z (`-m scale_stanh`, N=192, M=320, random weights): the z and y streams
   decoded to the encoder's symbols. Then WACNN-STanH's one-pass
   encode_stanh at each level on the first image: its level indexes equal
   the codec's symbols.
5b. Train, through training/step.py (what cli/train.py runs), lambda
   0.013, crops of seeded synthetic images: TCM-S from the committed
   weights at batch 16 of 256x256 (the train CLI's defaults; 3 warm-up and
   10 timed steps with remat, one step without), TCM N=192 with random
   weights at batch 2 of 256x256 (1 and 3 steps, then one without remat),
   the mean-scale hyperprior (N=192, M=320) at batch 16 of 256x256 (3 and
   10 steps) and WACNN-STanH from the committed snapshot at batch 16 of
   256x256 (3 and 10 steps; a level per step from random.Random(0) and its
   lambda, beta from a gap_stoc schedule (beta 10, factor 25) that each
   step's gap advances, both printed per step), and the gained scale
   hyperprior from its committed snapshot at batch 16 of 256x256 (3 and 10
   steps, a level per step and its lambda): loss, bpp, mse, aux per
   step, ms per step on the host clock ending in a synchronise, images/s,
   peak memory; the wrappers'
   launch counters must stay at 0 (every layer is composed under
   autograd). Then one step at 1x256x256 on the card and on the CPU from
   the same weights and noise (drawn on the CPU): loss within 1e-4
   relative, pre-clip gradient norm within 1e-3. Then a no_grad validation
   forward on 2 images of 256x256 at the updated weights (TCM: B1, B2 and
   B3 launched 32, 18 and 9 times) and agreement with the CPU plain path as
   in the slices' reference check (the hyperprior: x_hat against the CPU's
   g_s of the card's y_hat, and the elements of y_hat and z_hat that round
   the other way on the CPU counted and held to 0.1%). --cpu-rehearsal
   runs them at batch 2 of 128x128.
5c. (run before 5b) Gain slices on the same two images: the gained scale hyperprior
   (N=192, M=320) with the committed trained checkpoints/scale_gain_vr_r5.npz
   (three levels, lambda 0.0025/0.013/0.05) at levels 0, 1, 2 and at
   (s=0, l=0.5) and (s=1, l=0.5): the forward estimate at that point's
   gains, compress and decompress, exact y_hat, the decoded x_hat equal to
   the forward's clipped x_hat within 1e-5, real bpp within 3% of the
   estimate, bpp and PSNR per point, byte-identical streams at (s=0, l=1)
   and (s=1, l=0); then the card against the CPU plain path at level 1 on
   a 256x256 image (latents that round the other way held to 0.1%).
   wacnn_gain (N=192, M=320, lambda 0.0025 and 0.05, --gain_init_spread 2,
   random weights) at both levels through compress_with_ac: exact decode,
   x_hat against the forward within 1e-5, WACNN's B1 and B4 launches per
   pass, bpp rising from level 0 to level 1. scale_gain_sc (random
   weights) with a seeded quality map: exact decode at (s=0, l=0.5).
5d. (run before 5b) Pipelined host codec on TCM-S (the committed weights), 4 batches of 8
   seeded 768x512 images: serial compress_batch + decompress_batch,
   compress_pipelined then serial decode, roundtrip_pipelined; streams
   byte-identical to
   the serial ones, decoded y_hat exact, MP/s per variant (median of 3
   runs), the serial run's launches; the caller's TF32 flags set True
   and read False inside every pass.
5e. (run before 5b) Device coder on TCM-S (the committed weights): the
   coder kernels D1-D4 (csrc/device_rans.cu, built in phase 2) against
   their plain versions on the card, bit for bit (words, counts, headers,
   totals, decoded symbols and the final carry), on one 768x512 image's
   real slice inputs at k=1024 (D1 the y and z streams, D2 the z stream
   and the five y segments chained, D3, D4 the five segments) and on batch
   0 of 5d at the serving path's k=4096 (D1 and D2 its z stream at its kz,
   compacted; D3 the y stream, D4 its five segments), each with its time
   (CUDA events) beside the plain version's and its bound (the bytes and
   float32 operations these inputs need); on every one of these inputs
   each kernel's device time over 10 interleaved rounds (`split` lines,
   as phase 3's), every variant equal to the plain version bit for bit:
   D1 its one configuration, D2 each variant (lanes a CTA, table staged
   in shared memory or read where it lies) that takes the table, D3 its
   one configuration, D4 every cluster size (CTAs in the cluster); then the two images
   of the slices through compress_device / decompress_device and the
   analytic pair (exact y_hat, the table path's x_hat within 1e-5 of the
   host codec's decode, the clamped symbols, encode and decode ms as the
   median of 3, real bpp beside the host codec's and the estimate, B1-B3
   launched as by compress and decompress), the coder kernels' launches
   on that path;
   then serve_roundtrip_metrics and serve_roundtrip_pipelined over 5d's
   batches at k=4096 beside the serial host path (MP/s, median of 3; the
   last timed run of each decodes every batch's y_hat exactly) and the
   profile of one run of each, with D1-D4's device time in it.
5f. (run before 5b) Parallel, TCM-S from the committed weights: tiled_forward
   of one 2048x1408 mosaic of 5d's first batch (seeded synthetic 768x512
   images, 3x3, cropped) in 512x512 tiles (overlap 64, 8 tiles a
   chunk: 20 tiles in 3 chunks) through B1-B3, launches counted (3 x one
   forward pass's) and the path's kernels required; the same through their
   plain versions on the card (ops/layers.py::plain_versions: x_hat within
   1e-4, bits within 1e-4 relative) and the monolithic forward (mean
   |x_hat difference| < 0.02, PSNR between them > 25 dB, bpp within 5%);
   ms, MP/s, bpp and PSNR of each and a profile of one tiled pass. Then a
   world of one over NCCL: mesh_sharded_forward of 5d's first 768x512
   image (halo 64) against the module's forward of the image with its two
   zero halos (x_hat within 1e-4, bits within 1e-4 relative) and the
   monolithic forward (mean |difference| < 0.02; the bits' gap printed),
   shard_for_inference with compress_batch / decompress_batch of that
   batch of 8 (streams byte-identical to the unsharded codec's, y_hat exact),
   and shard_train_step on TCM-S at 16 x 256x256 against train_step from
   the same weights and seed (loss within 1e-6 relative over two steps, ms
   per step of each). The phase's wall time is printed and held to 90 s.
5j. (after 5f) D4 beyond 8192 lanes: at k = 8193, 12288, 16384, 65536 and
   100,000 (not a multiple of 32), three chained segments of 4 steps of
   seeded Gaussian symbols (sigma log-uniform over [0.05, 300]) through
   the wrapper's cluster and every cluster size it offers (a thread a lane
   up to 16,384 lanes on 16 CTAs, beyond that several lanes a thread kept
   in memory): values and carries equal to the plain version's, bit for bit,
   its time (CUDA events), the plain version's, the bound, and each
   instance's device time (`split` lines; a `d4_wide` line a k). Then
   TCM-S through the analytic device codec at k=16384 on 5d's first batch
   of 8 (48 steps a slice): the decode exact on the wrapper's cluster and
   on each cluster forced, a second encode writing the same container,
   decode ms per cluster.
5k. (after 5j) A world of one over NCCL: the device-coder and pipelined
   paths after shard_for_inference (compress_device / decompress_device,
   the analytic pair, compress_pipelined, roundtrip_pipelined,
   serve_roundtrip_pipelined, serve_roundtrip_metrics,
   roundtrip_device_pipelined over two batches of two of 5d's images):
   streams byte-identical to an unsharded codec's, decodes exact, ms of
   each; then parallel/dryrun.py's dryrun_multichip(1) (a rank process of
   its own, one train step of its small TCM, finite loss).
5g. (run before 5b) bf16 mode (set_matmul_precision("bfloat16"), the eval
   CLI's --bf16 for TCM): TCM-S with the committed weights and TCM N=192
   with seeded weights (phase 4's codecs) on phase 4's two 768x512 images:
   the forward estimate, compress and decompress (exact y_hat, the
   documented launches per pass, every one a bf16 instance), and on TCM-S
   the table device coder's pair (exact y_hat); then phase 5's WACNN
   (seeded), mean-scale hyperprior (seeded), trained gained scale
   hyperprior at level 1 and trained WACNN-STanH at level 1: the forward
   estimate, compress and decompress (exact y_hat, the decoded x_hat equal
   to the bf16 forward's clipped x_hat within 1e-5, WACNN-STanH's to
   forward_codec_consistent's), bf16 launches per pass (WACNN and
   WACNN-STanH: B1's attention-only bf16 instance 2 / 1 / 1; B4 and every
   fp32 instance 0); bpp and PSNR beside the same codec's fp32 forward; the
   device's busy time and idle share of one profiled forward in each mode;
   the phase's wall time.
5h. (after 5b) bf16 training: TCM N=192 at batch 2 of 256x256 (5b's
   tcm192 slice) with the train CLI's --bf16 precision, 1 warm-up and 3
   timed steps: ms per step and images/s beside 5b's fp32 step, peak
   memory, finite metrics, no kernel launched, parameters and Adam states
   fp32, and a profile of one more step.
5i. (after 5b) The CLIs as a user runs them, on a corpus the port writes
   (PNG through data/png.py), with Pillow blocked whether or not it is
   installed (in this process through sys.modules, in the subprocesses by
   a PIL package first on PYTHONPATH whose import raises; whether it is
   installed is printed): `python -m
   reslic_tcm_tpu_torch.data.synthetic <tmp>/corpus 32` as a subprocess
   (32 train images of 512x512, 24 test images of 512x768; seconds
   printed); cli/train.py::main trains TCM-S (N=64, M=320) from the
   committed weights for one epoch (32 images, batch 16: two steps; lambda
   0.013) and validates on 8 test crops and on the 24 test images as the
   "Kodak" set (finite losses, the epoch's best and _very_best.ckpt saved,
   B1-B3 launched 32 / 18 / 9 per validation forward, none in the steps;
   wall seconds by utils/profiling.timed); then cli/eval.py::main on the
   test images with --checkpoint <_very_best.ckpt> --N 64 --M 320 --real,
   with the host coder, with --device-coder and with --bf16: every image's
   y_hat exact, B1-B3 launched 26 / 12 / 6 per compress and 26 / 10 / 5
   per decompress (their bf16 instances under --bf16, no fp32 one), D1-D4
   1 / 1 / 1 / 5 per image under --device-coder (none otherwise), the
   printed average bpp and PSNR equal to evaluate()'s on a codec that
   loaded the same checkpoint (same precision and coder); MP/s, encode and
   decode ms per image, bpp and PSNR per run (`cli_eval` lines), the
   device coder's bpp gap to the host coder's; and the host-coder run once
   more as `python -m reslic_tcm_tpu_torch.cli.eval ...`, its printed
   averages equal to the in-process run's. --cpu-rehearsal writes a
   corpus of 4 + 2 images of 256x256 in process and trains at batch 2 of
   128x128.
6. Profile: torch.profiler over one warm forward, compress and decompress
   of each slice at 768x512 (scale_gain_sc aside), over one step of each
   train slice and over one run of the serial and each pipelined variant
   (compress_pipelined alone, without its decode): the device's
   busy time and idle share of each, and the kernels that take the most
   device time.
7. Summary: the kernels line (B1-B4; B1-B3's launches include the tiled
   pass's and the CLI phase's; B1-B3's bf16 instances as rows of their own,
   their launches the bf16 phase's and the --bf16 eval run's), the
   coder_kernels line (D1-D4, with the --device-coder eval run's), the
   card line, the wall time, and last the {"ok": true, "device": ...} line.

Each slice is driven with every launch counter set to 0 just before it and
read just after; a kernel of that slice's path that was not launched fails
the run.

A hang dumps every thread's stack and exits non-zero after BUDGET_S.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np

BUDGET_S = 1150  # seconds; a run must end within 1200 (a full run on an H100 took 891)
TOL = 1e-4
TOL_BF16 = 4e-3  # bf16 instances vs their plain bf16 versions (phase 3's docstring)
PEAK_FLOPS = 67e12  # H100 SXM fp32, CUDA cores (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16, dense tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
SNAPSHOT = os.path.join("checkpoints", "tcm_s_lambda0.013_r5.npz")
IMAGE_HW = (768, 512)
SEED = 0
PROFILE_TRIES = 3  # the profiler can lose a kernel's record; profile again up to this often

def _launches(b1, b2, b3, b4):
    return {"flash_window_block": b1, "fused_residual_block": b2, "fused_conv_gdn": b3,
            "fused_qkv_attention": b4}


# Launches per pass at 768x512 (the tables in PERF.md; checked against the
# wrappers' counters in phases 4 and 5).
_TCM_LAUNCHES = {"forward": _launches(32, 18, 9, 0), "compress": _launches(26, 12, 6, 0),
                 "decompress": _launches(26, 10, 5, 0)}
_NO_LAUNCHES = {p: _launches(0, 0, 0, 0) for p in ("forward", "compress", "decompress")}
BALLE_KINDS = ("factorized", "scale", "mean-scale")
PASS_LAUNCHES = {
    "tcm": _TCM_LAUNCHES,
    "tcm128": _TCM_LAUNCHES,  # the same layers at twice the width
    "tcm192": _TCM_LAUNCHES,  # and at three times
    "wacnn": {"forward": _launches(2, 0, 0, 2), "compress": _launches(1, 0, 0, 1),
              "decompress": _launches(1, 0, 0, 1)},
    # the STanH codecs launch as their backbones do; forward_codec_consistent
    # runs g_a and g_s
    "wacnn-stanh": {"forward": _launches(2, 0, 0, 2),
                    "forward_codec_consistent": _launches(2, 0, 0, 2),
                    "compress": _launches(1, 0, 0, 1), "decompress": _launches(1, 0, 0, 1)},
    "tcm-stanh": _TCM_LAUNCHES,
    "scale-stanh": _NO_LAUNCHES,
    # the gain codecs launch as their backbones do
    "wacnn-gain": {"forward": _launches(2, 0, 0, 2), "compress": _launches(1, 0, 0, 1),
                   "decompress": _launches(1, 0, 0, 1)},
    "scale-gain": _NO_LAUNCHES,
    "scale-gain-sc": _NO_LAUNCHES,
    # TCM-S's compress + decompress per batch, whatever the batch size
    "pipelined": _TCM_LAUNCHES,
    # TCM-S through the device coder: the same passes, the coding on the card
    "device-coder": _TCM_LAUNCHES,
    # no kernel lies on the Balle-2018 path (5x5 stride-2 convolutions, unfused GDN)
    **{f"balle-{kind}": _NO_LAUNCHES for kind in BALLE_KINDS},
    # TCM-S's tiled pass at 2048x1408 (the parallel phase): one forward
    # pass's launches for each of its 3 chunks of 8 tiles
    "tiled": {"forward": {k: 3 * n for k, n in _TCM_LAUNCHES["forward"].items()}},
}
# the kernels each slice's path must launch
PATH_KERNELS = {s: [k for k, n in p["forward"].items() if n] for s, p in PASS_LAUNCHES.items()}

# (kernel, shape, option, {slice: launches per 768x512 forward pass on that
# slice's path}). shape: [B, H, W, C] for B1-B3, [windows, tokens, C] for
# B4. option: (head_dim, shifted, with LN1 and the MLP) for B1, inverse for
# B3, None for B2, (heads, masked) for B4. The slices: TCM-S ("tcm"), TCM
# N=128 ("tcm128"), TCM N=192 ("tcm192") and WACNN ("wacnn").
_TCM_SLICES = {64: "tcm", 128: "tcm128", 192: "tcm192"}


def _tcm_cases(n, kernel):
    """TCM at width n: B1 LN+MLP at C=n on g_a/g_s's three stages (W and
    SW once each in g_a and in g_s), B2 at C=n (two ConvTransBlocks per
    stage, six in the hyper transforms at 24x16), B3 at C=2n (RBWS's GDN in
    g_a and h_a, RBU's IGDN in g_s, h_mean_s and h_scale_s)."""
    s = _TCM_SLICES[n]
    if kernel == "flash_window_block":
        return [(kernel, (1, h, w, n), (hd, shifted, True), {s: 2})
                for (h, w), hd in (((384, 256), 8), ((192, 128), 16), ((96, 64), 32))
                for shifted in (False, True)]
    if kernel == "fused_residual_block":
        return [(kernel, (1, h, w, n), None, {s: k})
                for (h, w), k in (((384, 256), 4), ((192, 128), 4), ((96, 64), 4), ((24, 16), 6))]
    return [(kernel, (1, h, w, 2 * n), inverse, {s: 2 if inverse and h == 24 else 1})
            for inverse in (False, True) for h, w in ((384, 256), (192, 128), (96, 64), (24, 16))]


_B1, _B2, _B3 = "flash_window_block", "fused_residual_block", "fused_conv_gdn"
KERNEL_CASES = _tcm_cases(64, _B1) + [
    (_B1, (1, 48, 32, 128), (16, shifted, True), {"tcm": 10, "tcm128": 10, "tcm192": 10})
    for shifted in (False, True)  # SWAtten
] + _tcm_cases(128, _B1) + [
    (_B1, (1, 192, 128, 192), (24, False, False), {}),
    (_B1, (1, 192, 128, 192), (24, True, False), {"wacnn": 2}),
    (_B1, (1, 192, 128, 128), (16, False, False), {}),  # WACNN N=128
    (_B1, (1, 192, 128, 128), (16, True, False), {}),
] + [c for k in (_B2, _B3) for n in (64, 128) for c in _tcm_cases(n, k)] + [
    c for k in (_B1, _B2, _B3) for c in _tcm_cases(192, k)] + [
    ("fused_qkv_attention", (96, 16, 320), (8, False), {}),
    ("fused_qkv_attention", (96, 16, 320), (8, True), {"wacnn": 2}),
]

CONV_KERNELS = ("fused_residual_block", "fused_conv_gdn")  # B2, B3: one conv kernel, two tiles
LIBRARY_KERNELS = ("fused_qkv_attention",)  # one PyTorch call computes the whole function

# phase 3's bf16 rows: B1's LN+MLP flavour, B2 and B3 at the TCM slices'
# shapes, and B1's attention-only flavour at WACNN N=192's and N=128's (the
# fp32 rows' shapes)
BF16_KERNELS = (_B1, _B2, _B3)
BF16_CASES = [c for c in KERNEL_CASES if c[0] in BF16_KERNELS
              and ((c[0] == _B1 and not c[2][2]) or set(c[3]) & set(_TCM_SLICES.values()))]
_B1_ATTN_BF16 = "flash_window_block_attn_bf16"


def _bf16_row(kernel, option) -> str:
    """The kernels line's row of a bf16 case: B1's attention-only flavour
    has a row of its own (another kernel, window_attn_bf16_kernel)."""
    return _B1_ATTN_BF16 if kernel == _B1 and not option[2] else f"{kernel}_bf16"


# bf16 row -> (wrapper, source, the phase 5g slices whose launches it counts:
# both B1 rows share the wrapper's launches_bf16, each flavour on its own slices)
BF16_ROWS = {
    f"{_B1}_bf16": (_B1, "reslic_tcm_tpu_torch/csrc/flash_window_attn_bf16.cu",
                    ("bf16-tcm", "bf16-tcm192", "cli-bf16")),
    _B1_ATTN_BF16: (_B1, "reslic_tcm_tpu_torch/csrc/window_attn_bf16.cu",
                    ("bf16-wacnn", "bf16-wacnn-stanh")),
    f"{_B2}_bf16": (_B2, "reslic_tcm_tpu_torch/csrc/fused_conv_bf16.cu", None),
    f"{_B3}_bf16": (_B3, "reslic_tcm_tpu_torch/csrc/fused_conv_bf16.cu", None),
}

KERNEL_SOURCES = {
    "flash_window_block": ("reslic_tcm_tpu_torch/csrc/flash_window_attn.cu",
                           "reslic_tcm_tpu/ops/flash_window_attn.py:239"),
    "fused_residual_block": ("reslic_tcm_tpu_torch/csrc/fused_conv.cu",
                             "reslic_tcm_tpu/ops/fused_conv.py:137"),
    "fused_conv_gdn": ("reslic_tcm_tpu_torch/csrc/fused_conv.cu",
                       "reslic_tcm_tpu/ops/fused_conv.py:237"),
    "fused_qkv_attention": ("reslic_tcm_tpu_torch/csrc/qkv_attention.cu",
                            "artifacts/pallas_attn_perhead.py:80"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _stopwatch():
    """lap(label) logs the seconds since the previous lap (or the start)."""
    last = [time.perf_counter()]

    def lap(label: str) -> None:
        now = time.perf_counter()
        log(f"time {label}: {now - last[0]:.1f} s")
        last[0] = now
    return lap


# ------------------------------- phase 1 --------------------------------


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log(f"device: {name}; devices: {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log("numerics: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False, cudnn.deterministic=True, "
        "cudnn.benchmark=False (plain versions in full fp32)")
    return name, smi


# ------------------------------- phase 2 --------------------------------


def phase_build():
    from reslic_tcm_tpu_torch.ops import build

    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(report)} "
        f"(route: nvcc/g++ -> .so -> ctypes) into {build.BUILD_DIR}; each compile "
        + ", ".join(f"{name} {rec['seconds']:.1f} s" for name, rec in report.items()))
    for name, rec in report.items():
        for line in rec["log"].splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


# ------------------------------- phase 3 --------------------------------


def _cost(kernel: str, shape, option, weight_bytes: int = 4):
    """(FLOPs, bytes) the function needs: matmul and conv multiply-adds at 2
    FLOP each; each input (activations, weights, bias tables and mask) read
    once and each output written once, in fp32, except the weight matrices
    of B1-B3 at ``weight_bytes`` each (2: the bf16 instances). B1 counts
    LN1 and the MLP only in the flavour that has them."""
    if kernel == "fused_qkv_attention":
        nw, t, c = shape
        heads, masked = option
        flops = nw * (2 * t * c * 4 * c + 4 * t * t * c)
        inputs = 4 * c * c + 4 * c + heads * t * t + (nw * t * t if masked else 0)
        return flops, 4 * (2 * nw * t * c + inputs)
    b, h, w, c = shape
    px = b * h * w
    if kernel == "flash_window_block":
        t = 64
        windows = px // t
        full = option[2]
        mlp = 8 * c if full else 0
        flops = windows * (2 * t * c * (3 * c + c + mlp) + 4 * t * t * c)
        matrices, vectors = 4 * c * c, 4 * c + t * t * (c // option[0])
        if full:
            matrices += 8 * c * c  # w1, w2
            vectors += 5 * c + 4 * c  # LN1, LN2, b1, b2
        nbytes = 4 * (2 * px * c + vectors) + weight_bytes * matrices
    elif kernel == "fused_residual_block":
        flops = px * 2 * (2 * 9 * c * c)
        nbytes = 4 * (2 * px * c + 2 * c) + weight_bytes * 2 * 9 * c * c
    else:
        flops = px * (2 * 9 * c * c + 2 * c * c)
        nbytes = 4 * (3 * px * c + 3 * c) + weight_bytes * (9 * c * c + c * c)
    return flops, nbytes


def _inputs(torch, kernel, shape, option, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev)

    if kernel == "fused_qkv_attention":
        nw, t, c = shape
        heads, masked = option
        # WACNN's mask: one image's [nW, T, T] of 0 / -100 (the diagonal open)
        mask = torch.where(torch.rand(nw, t, t, generator=g) < 0.3, -100.0, 0.0)
        mask[:, torch.arange(t), torch.arange(t)] = 0.0
        return (r(nw, t, c), r(3 * c, c, scale=c ** -0.5), r(3 * c, scale=0.1),
                r(heads, t, t, scale=0.5), r(c, c, scale=c ** -0.5), r(c, scale=0.1),
                mask.to(dev) if masked else None), {}
    b, h, w, c = shape
    if kernel == "flash_window_block":
        hd, shifted, full = option
        args = (r(b, h, w, c), r(3 * c, c, scale=c ** -0.5), r(3 * c, scale=0.1),
                r(c, c, scale=c ** -0.5), r(c, scale=0.1), 1 + r(c, scale=0.1), r(c, scale=0.1),
                r(c // hd, 64, 64, scale=0.5),
                (1 + r(c, scale=0.1), r(c, scale=0.1), r(4 * c, c, scale=c ** -0.5),
                 r(4 * c, scale=0.1), r(c, 4 * c, scale=(4 * c) ** -0.5), r(c, scale=0.1)))
        if not full:
            args = args[:5] + (None, None, args[7], None)
        return args, dict(head_dim=hd, window=8, shifted=shifted, with_ln=full)
    conv = (r(b, h, w, c), r(c, c, 3, 3, scale=(9 * c) ** -0.5), r(c, scale=0.1))
    if kernel == "fused_residual_block":
        return conv + (r(c, c, 3, 3, scale=(9 * c) ** -0.5), r(c, scale=0.1)), {}
    gamma = torch.rand(c, c, generator=g).to(dev) * 0.01
    beta = 0.5 + torch.rand(c, generator=g).to(dev)
    return conv + (gamma, beta, r(b, h, w, c)), dict(inverse=option)


def mha_mask(torch, rel_bias, mask, nw: int):
    """The [Nw*heads, T, T] additive attn_mask of multi_head_attention_forward
    for B4's rel_bias [heads, T, T] and mask [nW, T, T] (window i takes
    mask[i % nW]) or None: row w*heads + h is rel_bias[h] (+ mask[w % nW])."""
    heads, t, _ = rel_bias.shape
    m = rel_bias[None].expand(nw, heads, t, t)
    if mask is not None:
        m = m + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]
    return m.reshape(nw * heads, t, t).contiguous()


def library_qkv_attention(torch, windows, w_qkv, b_qkv, attn_mask, w_proj, b_proj, heads: int):
    """B4's function as one PyTorch call: qkv in-projection, scores scaled by
    head_dim^-0.5 plus attn_mask (mha_mask), softmax, P.v and the out
    projection. windows [Nw, T, C] -> [Nw, T, C]. A yardstick only: the port
    never calls it."""
    x = windows.transpose(0, 1)
    out, _ = torch.nn.functional.multi_head_attention_forward(
        x, x, x, x.shape[-1], heads, w_qkv, b_qkv, None, None, False, 0.0, w_proj, b_proj,
        training=False, need_weights=False, attn_mask=attn_mask)
    return out.transpose(0, 1)


def _library(torch, kernel, shape, option, args, dtype=None):
    """(the library call on these inputs, its output -> the kernel's output's
    layout) for B4 and B1's attention-only flavour; the attn_mask (and for
    B1 the partition into windows) is built here, outside the timed call.
    dtype=torch.bfloat16 (B1): the call's operands (windows, weights, biases
    and attn_mask) in bf16, the residual added in fp32 outside it."""
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F

    if kernel == "fused_qkv_attention":
        windows, w_qkv, b_qkv, rel, w_proj, b_proj, mask = args
        attn_mask = mha_mask(torch, rel, mask, shape[0])
        return (lambda: library_qkv_attention(torch, windows, w_qkv, b_qkv, attn_mask, w_proj,
                                              b_proj, option[0]), lambda out: out)
    x, w_qkv, b_qkv, w_proj, b_proj, _, _, rel, _ = args
    b, h, w, c = shape
    hd, shifted, _ = option
    windows = F.window_partition(x, 8).reshape(-1, 64, c)
    blocked = None
    if shifted:
        blocked = torch.from_numpy(F.shift_window_mask(h // 8, w // 8, 8, 4)).to(x.device)
        blocked = torch.where(blocked, F.NEG_INF, 0.0).float()
    attn_mask = mha_mask(torch, rel, blocked, windows.shape[0])
    if dtype is not None:
        windows, w_qkv, b_qkv, attn_mask, w_proj, b_proj = (
            t.to(dtype) for t in (windows, w_qkv, b_qkv, attn_mask, w_proj, b_proj))
    return (lambda: library_qkv_attention(torch, windows, w_qkv, b_qkv, attn_mask, w_proj, b_proj,
                                          c // hd),
            lambda out: x + F.window_reverse(out.float().reshape(b, -1, 64, c), 8, h, w))


def _splits(kernel, shape, option):
    """{split: the wrapper's keyword that forces it} over every split the
    kernel has an instance for at this shape (None where it has one way)."""
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import qkv_attention as Q

    if kernel == "fused_qkv_attention":
        return {s: {"split": s} for s in Q.GROUPS}
    if kernel == "flash_window_block":
        hd, _, full = option
        ks = (F.min_cluster(shape[3]), F.max_cluster(shape[3], hd)) if full else F.ATTN_CLUSTERS
        return {k: {"cluster": k} for k in dict.fromkeys(ks)}
    return None


def attn_bf16_forces(args, kw, prep, shape):
    """{option: call} over the options the bf16 attention-only wrapper can
    force at this shape (B1 attention-only, csrc/window_attn_bf16.cu): each
    cluster of ATTN_CLUSTERS_BF16 at its default persistent grid ("K"), at
    a grid that leaves some clusters one window short ("KxG", G = windows //
    2 + 1) and at one cluster ("Kx1": every window in turn)."""
    import torch

    from reslic_tcm_tpu_torch.ops import flash_window_attn as F

    b, h, w, c = shape
    windows = b * (h // 8) * (w // 8)
    forces = {}
    for k in F.ATTN_CLUSTERS_BF16[c]:
        for g in dict.fromkeys((None, windows // 2 + 1, 1)):
            forces[str(k) if g is None else f"{k}x{g}"] = (
                lambda k=k, g=g: F.flash_window_block(*args, **kw, cluster=k, grid=g,
                                                      prepared=prep, compute_dtype=torch.bfloat16))
    return forces


def _chosen_split(kernel, shape, option):
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import qkv_attention as Q

    if kernel == "fused_qkv_attention":
        nw, t, c = shape
        return Q.group_config(nw, t, c, c // option[0])
    b, h, w, c = shape
    hd, _, full = option
    return (F.cluster_size if full else F.attn_cluster_size)(c, hd, b * (h // 8) * (w // 8))


def _time_ms(torch, fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps: int) -> float:
    """Device time per call of fn: all its kernels and copies (profiler),
    profiled again (up to PROFILE_TRIES times) when the profiler recorded
    no device event at all; NaN (not measured) if it never does, the
    CUDA-event time of the same call standing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        log("profiler: no device events recorded; profiling again")
    log(f"profiler: no device events in {PROFILE_TRIES} tries; device time not measured")
    return float("nan")


def phase_kernels(torch):
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import fused_conv as C
    from reslic_tcm_tpu_torch.ops import qkv_attention as Q

    fns = {
        "flash_window_block": (F.flash_window_block, F.plain_window_block),
        "fused_residual_block": (C.fused_residual_block, C.plain_residual_block),
        "fused_conv_gdn": (C.fused_conv_gdn, C.plain_conv_gdn),
        "fused_qkv_attention": (Q.fused_qkv_attention, Q.plain_qkv_attention),
    }
    dev = torch.device("cuda")
    per_kernel, per_slice_kernel = {}, {}
    with torch.no_grad():
        for i, (kernel, shape, option, per_slice) in enumerate(KERNEL_CASES):
            per_pass = sum(per_slice.values())
            kern, plain = fns[kernel]
            args, kw = _inputs(torch, kernel, shape, option, dev, SEED + i)
            got = kern(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kernel} {shape}: non-finite output")
            err = float((got - want).abs().max())
            bound = TOL * max(1.0, float(want.abs().max()))
            reps = 20 if np.prod(shape) >= 96 * 64 * 64 else 100
            ms = _time_ms(torch, lambda: kern(*args, **kw), reps)
            device_ms = _device_ms(torch, lambda: kern(*args, **kw), reps)
            plain_ms = _time_ms(torch, lambda: plain(*args, **kw), reps)
            flops, nbytes = _cost(kernel, shape, option)
            t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            case = {"kernel": kernel, "shape": list(shape), "option": option,
                    "per_forward": per_slice, "max_abs_err": err, "tol": bound, "ms": ms,
                    "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                    "tflops": flops / device_ms / 1e9,
                    "share_of_bound": max(t_ops, t_bytes) / device_ms}
            if kernel in CONV_KERNELS:
                # the other tile on the same input must give the same bits
                case["tile"] = C.tile_config(*shape[1:])
                other = C.TILES[1 - C.TILES.index(case["tile"])]
                case["equal_across_tiles"] = bool(torch.equal(got, kern(*args, **kw, tile=other)))
                case["other_tile_device_ms"] = _device_ms(
                    torch, lambda: kern(*args, **kw, tile=other), reps)
            elif kernel == "fused_qkv_attention" or not option[2]:
                # every split on the same input must give the chosen one's bits
                case["split"] = _chosen_split(kernel, shape, option)
                case["equal_across_splits"] = all(
                    bool(torch.equal(got, kern(*args, **kw, **force)))
                    for force in _splits(kernel, shape, option).values())
                lib, to_out = _library(torch, kernel, shape, option, args)
                case["library_ms"] = _time_ms(torch, lib, reps)
                case["library_err"] = float((to_out(lib()) - want).abs().max())
                if kernel == "flash_window_block":
                    case["library_note"] = "partition, roll and residual outside the call"
            log("kernel_case " + json.dumps(case))
            if not err <= bound:
                raise AssertionError(f"{kernel} {shape} {option}: max abs err {err:.3e} "
                                     f"exceeds {bound:.3e}")
            if kernel in CONV_KERNELS and not case["equal_across_tiles"]:
                raise AssertionError(f"{kernel} {shape} {option}: the {case['tile']} and "
                                     f"{other} tiles give different bits")
            if "equal_across_splits" in case and not case["equal_across_splits"]:
                raise AssertionError(f"{kernel} {shape} {option}: the splits give different bits")
            if "library_err" in case and not case["library_err"] <= bound:
                raise AssertionError(f"{kernel} {shape} {option}: the library call disagrees "
                                     f"with the plain version by {case['library_err']:.3e}")
            k = per_kernel.setdefault(kernel, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                               "library_ms": 0.0, "t_ops": 0.0, "t_bytes": 0.0})
            k["library_ms"] += case.get("library_ms", 0.0) * per_pass
            k["max_abs_err"] = max(k["max_abs_err"], err)
            k["ms"] += ms * per_pass
            k["plain_ms"] += plain_ms * per_pass
            k["t_ops"] += t_ops * per_pass
            k["t_bytes"] += t_bytes * per_pass
            for slice_name, n in per_slice.items():
                sk = per_slice_kernel.setdefault((slice_name, kernel), dict.fromkeys(
                    ("launches", "ms", "device_ms", "plain_ms", "bound_ms"), 0.0))
                sk["launches"] += n
                for key, v in (("ms", ms), ("device_ms", device_ms), ("plain_ms", plain_ms),
                               ("bound_ms", max(t_ops, t_bytes))):
                    sk[key] += v * n
    for (slice_name, kernel), sk in per_slice_kernel.items():
        log("kernel_per_pass " + json.dumps({"slice": slice_name, "kernel": kernel, **sk}))
    return per_kernel


def _prepared(kernel, args, kw, compute_dtype):
    """The wrapper's prepared weights for this case at compute_dtype."""
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import fused_conv as C

    if kernel == _B1:
        return F.prepare_window_block(*args[1:], head_dim=kw["head_dim"],
                                      compute_dtype=compute_dtype)
    if kernel == _B2:
        return C.prepare_residual_block(args[1], args[3], compute_dtype=compute_dtype)
    return C.prepare_conv_gdn(args[1], args[3], compute_dtype=compute_dtype)


def phase_kernels_bf16(torch):
    """Phase 3's bf16 rows (module docstring). Returns, per row, the sums
    over one forward pass of TCM-S, TCM N=128 and TCM N=192 (B1 LN+MLP, B2,
    B3) or of WACNN N=192 (B1 attention-only)."""
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import fused_conv as C

    fns = {_B1: (F.flash_window_block, F.plain_window_block),
           _B2: (C.fused_residual_block, C.plain_residual_block),
           _B3: (C.fused_conv_gdn, C.plain_conv_gdn)}
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    t0 = time.perf_counter()
    per_kernel, per_slice_kernel = {}, {}
    with torch.no_grad():
        for i, (kernel, shape, option, per_slice) in enumerate(BF16_CASES):
            per_pass = sum(per_slice.values())
            kern, plain = fns[kernel]
            args, kw = _inputs(torch, kernel, shape, option, dev, SEED + 500 + i)
            prep = {dt: _prepared(kernel, args, kw, dt) for dt in (bf16, torch.float32)}
            run = {dt: (lambda dt=dt, **force: kern(*args, **kw, **force, compute_dtype=dt,
                                                    prepared=prep[dt]))
                   for dt in (bf16, torch.float32)}
            got = run[bf16]()
            want = plain(*args, **kw, compute_dtype=bf16)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kernel} bf16 {shape}: non-finite output")
            diff = (got - want).abs()
            err = float(diff.max())
            bound = TOL_BF16 * max(1.0, float(want.abs().max()))
            reps = 10 if np.prod(shape) >= 96 * 64 * 64 else 50
            ms = _time_ms(torch, run[bf16], reps)
            device_ms = _device_ms(torch, run[bf16], reps)
            fp32_device_ms = _device_ms(torch, run[torch.float32], reps)
            plain_ms = _time_ms(torch, lambda: plain(*args, **kw, compute_dtype=bf16), reps)
            flops, nbytes = _cost(kernel, shape, option, weight_bytes=2)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            if kernel == _B1 and not option[2]:
                forces = attn_bf16_forces(args, kw, prep[bf16], shape)
            elif kernel == _B1:  # every (cluster, windows a CTA) of the LN+MLP kernel
                at = {n: v for n, v in kw.items() if n != "with_ln"}
                forces = {f"{k}x{g}": lambda k=k, g=g: F.flash_window_block_at(
                    *args, cluster=k, group=g, prepared=prep[bf16], **at)
                    for k in dict.fromkeys((F.min_cluster(shape[3]),
                                            F.max_cluster(shape[3], option[0])))
                    for g in F.window_groups(shape[3], k)}
            else:
                forces = {t: lambda t=t: run[bf16](tile=t) for t in C.TILES}
            equal = all(bool(torch.equal(got, f())) for f in forces.values())
            row = _bf16_row(kernel, option)
            case = {"kernel": row, "shape": list(shape), "option": option,
                    "per_forward": per_slice, "max_abs_err": err, "tol": bound,
                    "share_beyond_1e-5": float((diff > 1e-5).float().mean()), "ms": ms,
                    "device_ms": device_ms, "fp32_device_ms": fp32_device_ms,
                    "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                    "tflops": flops / device_ms / 1e9,
                    "share_of_bound": max(t_ops, t_bytes) / device_ms,
                    "splits": list(forces), "equal_across_splits": equal}
            if kernel == _B1 and not option[2]:
                # one F.multi_head_attention_forward call in bf16 (the fp32 rows'
                # yardstick; partition, roll and residual outside it)
                lib, to_out = _library(torch, kernel, shape, option, args, bf16)
                case["library_ms"] = _time_ms(torch, lib, reps)
                case["library_err"] = float((to_out(lib()) - want).abs().max())
            log("kernel_case_bf16 " + json.dumps(case))
            if not err <= bound:
                raise AssertionError(f"{kernel} bf16 {shape} {option}: max abs err {err:.3e} "
                                     f"exceeds {bound:.3e}")
            if not equal:
                raise AssertionError(f"{kernel} bf16 {shape} {option}: the splits {list(forces)} "
                                     f"give different bits")
            if "library_err" in case and not case["library_err"] <= bound:
                raise AssertionError(f"{kernel} bf16 {shape} {option}: the bf16 library call "
                                     f"disagrees with the plain version by "
                                     f"{case['library_err']:.3e}")
            library_ms = case.get("library_ms", 0.0)
            k = per_kernel.setdefault(row, dict.fromkeys(
                ("max_abs_err", "ms", "device_ms", "fp32_device_ms", "plain_ms", "library_ms",
                 "t_ops", "t_bytes"), 0.0))
            k["max_abs_err"] = max(k["max_abs_err"], err)
            for key, v in (("ms", ms), ("device_ms", device_ms), ("fp32_device_ms", fp32_device_ms),
                           ("plain_ms", plain_ms), ("library_ms", library_ms), ("t_ops", t_ops),
                           ("t_bytes", t_bytes)):
                k[key] += v * per_pass
            for slice_name, n in per_slice.items():
                sk = per_slice_kernel.setdefault((slice_name, row), dict.fromkeys(
                    ("launches", "ms", "device_ms", "fp32_device_ms", "plain_ms", "library_ms",
                     "bound_ms"), 0.0))
                sk["launches"] += n
                for key, v in (("ms", ms), ("device_ms", device_ms),
                               ("fp32_device_ms", fp32_device_ms), ("plain_ms", plain_ms),
                               ("library_ms", library_ms), ("bound_ms", max(t_ops, t_bytes))):
                    sk[key] += v * n
    for (slice_name, kernel), sk in per_slice_kernel.items():
        if kernel != _B1_ATTN_BF16:
            sk["library_ms"] = None  # no single PyTorch call computes it
        log("kernel_per_pass_bf16 " + json.dumps({"slice": slice_name, "kernel": kernel, **sk}))
    log(f"phase 3 bf16 rows: {time.perf_counter() - t0:.1f} s")
    return per_kernel


# Shapes at which phase 3 runs every split of a kernel on the same input,
# holds the outputs to equal bits and times each. B1 LN+MLP (the smallest
# cluster, one CTA per window or two at C=192, against the largest): the
# SWAtten shape (24 windows), each g_a/g_s shape of TCM-S, TCM N=128 and
# TCM N=192 (96, 384 and 1536 windows; C=192 also at 256x256's 16, 64 and
# 256 windows and at 32, 16 and 4 windows), and SWAtten's (128, 16) at 4,
# 32, 48 and 96 windows, around the wrapper's threshold. B1 attention-only (every
# cluster): WACNN N=192 and N=128's
# g_a/g_s shape (384 windows) in both flavours, and 64 and 16 windows
# (256x256 and 128x128 images). B4 (every (windows per CTA, CTAs per
# cluster)): WACNN's 96 windows with and without a mask, and 16, 24, 48
# and 192.
SPLIT_CASES = [("flash_window_block", (1, 48, 32, 128), (16, True, True))] + [
    ("flash_window_block", (1, h, w, c), (hd, False, True)) for c in (64, 128, 192)
    for (h, w), hd in (((384, 256), 8), ((192, 128), 16), ((96, 64), 32))] + [
    ("flash_window_block", (1, h, w, 192), (hd, True, True))
    for (h, w), hd in (((128, 128), 8), ((64, 64), 16), ((32, 32), 32), ((64, 32), 8),
                       ((32, 64), 16), ((32, 32), 8), ((32, 32), 16), ((16, 16), 8),
                       ((16, 16), 16))] + [
    ("flash_window_block", (1, h, w, 128), (16, True, True))
    for h, w in ((16, 16), (32, 64), (64, 48), (96, 64))] + [
    ("flash_window_block", (1, 192, 128, c), (c // 8, shifted, False))
    for c in (192, 128) for shifted in (True, False)] + [
    ("flash_window_block", (1, h, h, c), (c // 8, True, False))
    for c in (192, 128) for h in (64, 32)] + [
    ("fused_qkv_attention", (nw, 16, 320), (8, masked))
    for nw, masked in ((96, True), (96, False), (16, True), (24, True), (48, True),
                       (192, True))]
SPLIT_ROUNDS = 10
KERNEL_SYMBOLS = {"flash_window_block": "swin_block_kernel",
                  "fused_qkv_attention": "qkv_attention_kernel"}


def phase_splits(torch):
    """Every split of B1 (both flavours) and of B4 on the same input: equal
    bit for bit, and each split's kernel device time (profiler) over
    SPLIT_ROUNDS interleaved rounds of launches (each round runs every split
    once, in turn forward and backward), beside the wrapper's time per call
    (CUDA events, host work included) and the split the wrapper chooses."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import qkv_attention as Q

    dev = torch.device("cuda")
    wrappers = {"flash_window_block": F.flash_window_block,
                "fused_qkv_attention": Q.fused_qkv_attention}
    with torch.no_grad():
        for i, (kernel, shape, option) in enumerate(SPLIT_CASES):
            args, kw = _inputs(torch, kernel, shape, option, dev, SEED + 100 + i)
            fn = wrappers[kernel]
            splits = _splits(kernel, shape, option)
            names = list(splits)
            outs, call_ms = {}, {}
            for name in names:
                force = splits[name]
                outs[name] = fn(*args, **kw, **force)
                call_ms[name] = _time_ms(torch, lambda: fn(*args, **kw, **force), 20)
            torch.cuda.synchronize()
            equal = all(bool(torch.equal(outs[names[0]], outs[n])) for n in names)
            order = [n for r in range(SPLIT_ROUNDS) for n in (names if r % 2 == 0 else names[::-1])]
            for _ in range(PROFILE_TRIES):  # the profiler can lose a kernel's record
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for n in order:
                        fn(*args, **kw, **splits[n])
                    torch.cuda.synchronize()
                runs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                               and KERNEL_SYMBOLS[kernel] in e.name),
                              key=lambda e: e.time_range.start)
                if len(runs) == len(order):
                    break
                log(f"split {kernel} {list(shape)}: the profiler saw {len(runs)} kernel runs "
                    f"of {len(order)}; profiling again")
            else:  # the bits are still checked; the CUDA-event call_ms stand alone
                log(f"split {kernel} {list(shape)}: the profiler lost kernel records in "
                    f"{PROFILE_TRIES} tries; device time not measured")
                runs = []
            dev_ms = {n: [] for n in names}
            for n, e in zip(order, runs):
                dev_ms[n].append(e.time_range.elapsed_us() / 1e3)
            log("split " + json.dumps({
                "kernel": kernel, "shape": list(shape), "option": option,
                "splits": names, "equal": equal, "call_ms": [call_ms[n] for n in names],
                "device_ms_median": [float(np.median(dev_ms[n])) if dev_ms[n] else None
                                     for n in names],
                "device_ms": [dev_ms[n] for n in names],
                "chosen": _chosen_split(kernel, shape, option)}))
            if not equal:
                raise AssertionError(f"{kernel} {shape} {option}: the splits {names} disagree")


# ------------------------------- phase 4 --------------------------------


def _load_codec(device):
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    codec = make_tcm(N=64, M=320, device=device)
    load_snapshot_into(codec.module, SNAPSHOT)
    codec.update()
    return codec


def _make_tcm(n):
    def make(device):
        from reslic_tcm_tpu_torch.models.tcm import make_tcm

        codec = make_tcm(N=n, M=320, device=device, seed=SEED)
        codec.update()
        return codec
    return make


SLICES = {
    "tcm": (_load_codec, f"TCM-S N=64 M=320 from {SNAPSHOT}"),
    "tcm128": (_make_tcm(128), f"TCM N=128 M=320, random weights (seed {SEED})"),
    "tcm192": (_make_tcm(192), f"TCM N=192 M=320, random weights (seed {SEED})"),
}


def _check_launches(j, name, got, want, on_card):
    want = {k: v if on_card else 0 for k, v in want.items()}
    if got != want:
        raise AssertionError(f"image {j} {name}: launches {got}, expected {want}")


def phase_slice(torch, device, hw, slice_name="tcm"):
    """A TCM slice (TCM-S with the committed weights, or TCM N=128 with
    random ones): evaluate(), estimate then real. Real bpp is held within 3%
    of the estimate only with the trained weights."""
    from reslic_tcm_tpu_torch.cli.eval import evaluate
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    make, what = SLICES[slice_name]
    codec = make(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice {slice_name}: {what} on {device}; two {hw[0]}x{hw[1]} "
        f"synthetic images (seed {SEED}); set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    reset_launch_counts()
    est = evaluate(codec, images, real=False, log=lambda m: log("  " + m))
    real = evaluate(codec, images, real=True, log=lambda m: log("  " + m))
    launches = launch_counts()

    for j, (e, r) in enumerate(zip(est["records"], real["records"])):
        log(f"image {j}: estimate {e['bpp']:.4f} bpp, real {r['bpp']:.4f} bpp, "
            f"PSNR {r['psnr']:.3f} dB, MS-SSIM {r['ms_ssim_db']:.3f} dB, "
            f"forward {e['forward_ms']:.1f} ms, encode {r['encode_ms']:.1f} ms, "
            f"decode {r['decode_ms']:.1f} ms")
        if not r["y_hat_exact"]:
            raise AssertionError(f"image {j}: decode did not reproduce the encoder's y_hat")
        if slice_name == "tcm" and not abs(r["bpp"] - e["bpp"]) <= 0.03 * e["bpp"]:
            raise AssertionError(f"image {j}: real bpp {r['bpp']:.4f} not within 3% of the "
                                 f"estimate {e['bpp']:.4f}")
        for name, got in (("forward", e["launches_forward"]),
                          ("compress", r["launches_compress"]),
                          ("decompress", r["launches_decompress"])):
            _check_launches(j, name, got, PASS_LAUNCHES[slice_name][name], on_card)
    log(f"launches per pass (each image): {json.dumps(PASS_LAUNCHES[slice_name])}")
    return codec, launches


def _make_wacnn(device):
    from reslic_tcm_tpu_torch.models.wacnn import make_wacnn

    codec = make_wacnn(N=192, M=320, device=device, seed=SEED)
    codec.update()
    return codec


def _make_balle(kind):
    def make(device):
        from reslic_tcm_tpu_torch.models.balle2018 import make_balle

        codec = make_balle(kind, N=192, M=320, device=device, seed=SEED)
        codec.update()
        return codec
    return make


# the slices whose real codec runs through training.codec_eval.compress_with_ac
AC_SLICES = {
    "wacnn": (_make_wacnn, "WACNN N=192 M=320"),
    **{f"balle-{kind}": (_make_balle(kind), f"Balle-2018 {kind} N=192 M=320")
       for kind in BALLE_KINDS},
}


def phase_ac_slice(torch, device, hw, slice_name):
    """WACNN or a Balle-2018 codec at full width with seeded random weights:
    the forward estimate through evaluate(), the real codec through
    compress_with_ac(); exact y_hat, and the decoded x_hat equal to the
    forward's clipped x_hat within 1e-5."""
    from reslic_tcm_tpu_torch.cli.eval import evaluate
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.training.codec_eval import compress_with_ac

    t0 = time.perf_counter()
    make, what = AC_SLICES[slice_name]
    codec = make(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice {slice_name}: {what}, random weights (seed {SEED}) on {device}; the same two "
        f"{hw[0]}x{hw[1]} images; set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    reset_launch_counts()
    est = evaluate(codec, images, real=False, log=lambda m: log("  " + m))
    real = []
    compress_with_ac(codec, images, log=lambda m: log("  " + m), records=real)
    launches = launch_counts()

    with torch.no_grad():
        for j, (img, e, r) in enumerate(zip(images, est["records"], real)):
            log(f"image {j}: estimate {e['bpp']:.4f} bpp, real {r['bpp']:.4f} bpp "
                f"(y {r['bpp_y']:.4f}, z {r['bpp_z']:.4f}), PSNR {r['psnr']:.3f} dB, "
                f"forward {e['forward_ms']:.1f} ms, encode {r['encode_ms']:.1f} ms, "
                f"decode {r['decode_ms']:.1f} ms")
            if not r["y_hat_exact"]:
                raise AssertionError(f"image {j}: decode did not reproduce the encoder's y_hat")
            fwd = torch.clamp(codec.forward(img[None])["x_hat"], 0, 1)
            err = float((r["x_hat"] - fwd).abs().max())
            log(f"image {j}: decoded x_hat vs the forward's clipped x_hat, max abs err {err:.3e}")
            if not err <= 1e-5:
                raise AssertionError(f"image {j}: decoded x_hat differs from the forward's")
            for name, got in (("forward", e["launches_forward"]),
                              ("compress", r["launches_compress"]),
                              ("decompress", r["launches_decompress"])):
                _check_launches(j, name, got, PASS_LAUNCHES[slice_name][name], on_card)
    log(f"launches per pass (each image): {json.dumps(PASS_LAUNCHES[slice_name])}")
    return codec, launches


def phase_reference(torch, codec, make):
    """The card's forward against the CPU plain path at the same weights
    (``make("cpu")``) on a small image: the slice-level reference check,
    x_hat within 1e-3."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    img = synth_image(np.random.default_rng(SEED + 7), 256, 256)[None]
    got = codec.forward(img)
    cpu = make("cpu")
    want = cpu.forward(img)
    for key in ("x_hat",):
        a, b = got[key].cpu(), want[key]
        err = float((a - b).abs().max())
        tol = 1e-3
        log(f"reference: 256x256 {key} card vs CPU plain path, max abs err {err:.3e} "
            f"(limit {tol:.3e})")
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise AssertionError(f"card forward disagrees with the CPU reference: {err:.3e}")
    for key in want["likelihoods"]:
        a, b = got["likelihoods"][key].cpu(), want["likelihoods"][key]
        bits_a, bits_b = float(-torch.log2(a).sum()), float(-torch.log2(b).sum())
        log(f"reference: {key} bits card {bits_a:.2f} vs CPU {bits_b:.2f}")
        if not abs(bits_a - bits_b) <= 1e-3 * bits_b + 1.0:
            raise AssertionError(f"{key} rate disagrees with the CPU reference")


# -------------------------------- STanH ---------------------------------

STANH_SNAPSHOT = os.path.join("checkpoints", "wacnn_stanh_vr_r5.npz")
# the snapshot's configuration (its .json): three levels trained at these
# lambdas, 16 sigmoids each, extrema 32 / 16 / 8
STANH_LAMBDAS = (0.0025, 0.013, 0.05)
STANH_LEVELS = [{"beta": 10, "num_sigmoids": 16, "annealing": "gap_stoc", "symmetry": False,
                 "gap_factor": 25, "extrema": e, "trainable": True, "removing_mean": False}
                for e in (32, 16, 8)]
FLIP_SHARE = 1e-3  # STanH symbols that may round the other way on the other device


def _make_wacnn_stanh(device):
    """WACNN-STanH (N=192, M=320, three levels) with the committed trained
    weights; every snapshot entry placed."""
    from reslic_tcm_tpu_torch.models.stanh.variants import make_wacnn_stanh
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    codec = make_wacnn_stanh(STANH_LEVELS, N=192, M=320, device=device, seed=SEED)
    unused = load_snapshot_into(codec.module, STANH_SNAPSHOT)
    if unused:
        raise AssertionError(f"{STANH_SNAPSHOT}: entries left over: {unused}")
    codec.update()
    return codec


def _registry_args(argv):
    from reslic_tcm_tpu_torch.utils.parser import parse_args

    return parse_args(argv)


def _make_tcm_stanh(device):
    """TCM-STanH N=128 from the registry (`-m stanh`, three lambdas, the
    train parser's quantizer defaults), random weights."""
    from reslic_tcm_tpu_torch.models import get_model

    codec, *_ = get_model(_registry_args(["-m", "stanh", "--N", "128", "--lambda_list",
                                          *map(str, STANH_LAMBDAS)]), device=device)
    codec.update()
    return codec


def _make_scale_stanh(device):
    """The registry's scale-STanH (`-m scale_stanh`, STanH on z), N=192,
    M=320, random weights."""
    from reslic_tcm_tpu_torch.models import get_model

    codec, *_ = get_model(_registry_args(["-m", "scale_stanh", "--N", "192", "--M", "320"]),
                          device=device)
    codec.update()
    return codec


def _bits(torch, likelihoods) -> float:
    return sum(float(-torch.log2(lik).sum()) for lik in likelihoods.values())


def _stanh_symbols(module, out, lv):
    """The STanH level indexes of an eval forward's y around its means
    (NCHW tensors or the codec's NHWC ones, as given)."""
    return module.gaussian_conditional.symbols(out["para"]["y"], out["para"]["means"], lv)


def _timed(torch, device, fn, compute_dtype=None):
    """(fn(), ms on the host clock ending in a synchronise, launches of the
    instances of ``compute_dtype``: float32 by default)."""
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since

    cd = compute_dtype or torch.float32
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    before, t0 = launch_counts(cd), time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3, launches_since(before, cd)


def phase_stanh_wacnn(torch, device, hw):
    """WACNN-STanH with the committed trained weights, each level in turn on
    the two seeded images: the forward estimate, forward_codec_consistent,
    compress and decompress; exact y_hat, real bpp within 3% of the
    codec-consistent estimate, bpp and PSNR per level (both must rise from
    level 0 to level 2: finer steps buy quality with rate), the share of y
    symbols where the monolithic forward's staircase differs from the
    codec's (printed), the launches per pass."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.utils.metrics import compute_psnr

    t0 = time.perf_counter()
    codec = _make_wacnn_stanh(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice wacnn-stanh: WACNN-STanH N=192 M=320 from {STANH_SNAPSHOT} (3 levels, lambda "
        f"{STANH_LAMBDAS}, 16 steps, extrema 32/16/8) on {device}; the same two {hw[0]}x{hw[1]} "
        f"images; set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    want = {p: {k: v if on_card else 0 for k, v in n.items()}
            for p, n in PASS_LAUNCHES["wacnn-stanh"].items()}
    px = hw[0] * hw[1]
    levels = []
    reset_launch_counts()
    for lv in range(3):
        recs = []
        for j, img in enumerate(images):
            x = img[None]
            rec, launches = {}, {}
            fwd, rec["forward_ms"], launches["forward"] = _timed(
                torch, device, lambda: codec.forward(x, lv=lv))
            cc, rec["cc_ms"], launches["forward_codec_consistent"] = _timed(
                torch, device, lambda: codec.forward_codec_consistent(x, lv=lv))
            enc, rec["encode_ms"], launches["compress"] = _timed(
                torch, device, lambda: codec.compress(x, lv=lv))
            dec, rec["decode_ms"], launches["decompress"] = _timed(
                torch, device, lambda: codec.decompress(enc["strings"], enc["shape"], lv=lv))
            if launches != want:
                raise AssertionError(f"level {lv} image {j}: launches {launches}, "
                                     f"expected {want}")
            if not (torch.equal(enc["y_hat"], dec["y_hat"])
                    and torch.equal(cc["y_hat"], dec["y_hat"])):
                raise AssertionError(f"level {lv} image {j}: the decoded y_hat is not the "
                                     f"encoder's (or forward_codec_consistent's)")
            sym_fwd = _stanh_symbols(codec.module, fwd, lv).permute(0, 3, 1, 2)
            rec["forward_flip_share"] = float(
                (sym_fwd != cc["symbols"].reshape(sym_fwd.shape)).float().mean())
            rec["bpp_estimate"] = _bits(torch, fwd["likelihoods"]) / px
            rec["bpp_cc"] = _bits(torch, cc["likelihoods"]) / px
            rec["bpp"] = (len(enc["strings"][0][0])
                          + sum(len(s) for s in enc["strings"][1])) * 8.0 / px
            rec["psnr"] = compute_psnr(torch.as_tensor(x, device=dec["x_hat"].device),
                                       dec["x_hat"])
            log(f"wacnn-stanh level {lv} image {j}: real {rec['bpp']:.4f} bpp, "
                f"codec-consistent estimate {rec['bpp_cc']:.4f}, forward estimate "
                f"{rec['bpp_estimate']:.4f}, PSNR {rec['psnr']:.3f} dB, forward "
                f"{rec['forward_ms']:.1f} ms, codec-consistent {rec['cc_ms']:.1f} ms, encode "
                f"{rec['encode_ms']:.1f} ms, decode {rec['decode_ms']:.1f} ms, y symbols where "
                f"the forward's staircase differs from the codec's: "
                f"{rec['forward_flip_share']:.2e}")
            if not abs(rec["bpp"] - rec["bpp_cc"]) <= 0.03 * rec["bpp_cc"]:
                raise AssertionError(f"level {lv} image {j}: real bpp {rec['bpp']:.4f} not "
                                     f"within 3% of the estimate {rec['bpp_cc']:.4f}")
            recs.append(rec)
        levels.append({k: float(np.mean([r[k] for r in recs])) for k in recs[0]})
        log("stanh_level " + json.dumps({"slice": "wacnn-stanh", "lv": lv, **levels[-1]}))
    launches = launch_counts()
    bpp, psnr = [lvl["bpp"] for lvl in levels], [lvl["psnr"] for lvl in levels]
    if not (bpp[0] < bpp[1] < bpp[2] and psnr[0] < psnr[1] < psnr[2]):
        raise AssertionError(f"levels 0-2 are not a rate ladder: bpp {bpp}, PSNR {psnr}")
    log(f"launches per pass (each image and level): {json.dumps(want)}")
    # the one-pass encode_stanh (after the path's launches were read): its
    # level indexes are the codec's symbols, slice by slice
    x = images[0][None]
    for lv in range(3):
        with torch.no_grad():
            got = codec.module.encode_stanh(codec._input(x), lv)["symbols"]
        want_sym = codec.encode_symbols(x, lv)[0]
        got = got.permute(1, 0, 2, 3, 4).reshape(1, -1).cpu().numpy()
        if not np.array_equal(got, want_sym):
            raise AssertionError(f"level {lv}: encode_stanh's symbols differ from the codec's "
                                 f"({int((got != want_sym).sum())} of {got.size})")
    log(f"wacnn-stanh encode_stanh on {device}: level indexes equal to the codec's symbols at "
        f"levels 0-2 ({got.size} a level)")
    return codec, launches


def _stanh_flips(torch, module_a, a, module_b, b, lv, label):
    """Symbols of two eval forwards (same weights, other devices) that round
    the other way; printed, held to FLIP_SHARE. Returns the count."""
    sa, sb = _stanh_symbols(module_a, a, lv).cpu(), _stanh_symbols(module_b, b, lv).cpu()
    flips = int((sa != sb).sum())
    log(f"{label}: STanH symbols card vs CPU differing {flips} of {sa.numel()}")
    if not flips <= FLIP_SHARE * sa.numel():
        raise AssertionError(f"{label}: {flips} STanH symbols differ card vs CPU")
    return flips


def phase_stanh_reference(torch, codec, make, lv):
    """The card's forward at level lv against the CPU plain path at the
    same weights on a 256x256 image: symbols that round the other way
    counted and held to 0.1%; x_hat within 1e-3 (where a symbol flipped,
    its neighbourhood may move by more: then the 99th percentile of the
    error is held to 1e-3) and the rate within 1e-3 relative."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    img = synth_image(np.random.default_rng(SEED + 7), 256, 256)[None]
    got = codec.forward(img, lv=lv)
    cpu = make("cpu")
    want = cpu.forward(img, lv=lv)
    flips = _stanh_flips(torch, codec.module, got, cpu.module, want, lv,
                         f"reference level {lv}")
    err = (got["x_hat"].cpu() - want["x_hat"]).abs()
    worst, p99 = float(err.max()), float(err.flatten().quantile(0.99))
    log(f"reference level {lv}: 256x256 x_hat card vs CPU plain path, max abs err {worst:.3e}, "
        f"99th percentile {p99:.3e} (limit 1.000e-03 on the max, on the 99th percentile "
        f"where a symbol flipped)")
    if not (bool(torch.isfinite(got["x_hat"]).all()) and (worst if flips == 0 else p99) <= 1e-3):
        raise AssertionError(f"card forward disagrees with the CPU reference: {worst:.3e}")
    bits_a, bits_b = _bits(torch, got["likelihoods"]), _bits(torch, want["likelihoods"])
    log(f"reference level {lv}: bits card {bits_a:.2f} vs CPU {bits_b:.2f}")
    if not abs(bits_a - bits_b) <= 1e-3 * bits_b + 1.0 + 64.0 * flips:
        raise AssertionError("rate disagrees with the CPU reference")


def phase_stanh_tcm(torch, device, hw):
    """TCM-STanH N=128 (random weights, the registry's defaults: 160 steps
    at extrema 80, three levels) on the two images at each level: the
    forward, compress and decompress, exact y_hat, TCM's launches per
    pass."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    codec = _make_tcm_stanh(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice tcm-stanh: TCM-STanH N=128 M=320 (registry -m stanh, 3 levels, "
        f"{codec.module.gaussian_conditional.stanh.w.shape[1]} steps), random weights (seed "
        f"{SEED}) on {device}; set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    px = hw[0] * hw[1]
    reset_launch_counts()
    for lv in range(3):
        for j, img in enumerate(images):
            x = img[None]
            fwd, fwd_ms, l_fwd = _timed(torch, device, lambda: codec.forward(x, lv=lv))
            enc, enc_ms, l_enc = _timed(torch, device, lambda: codec.compress(x, lv=lv))
            dec, dec_ms, l_dec = _timed(
                torch, device, lambda: codec.decompress(enc["strings"], enc["shape"], lv=lv))
            for name, got in (("forward", l_fwd), ("compress", l_enc), ("decompress", l_dec)):
                _check_launches(j, f"level {lv} {name}", got, PASS_LAUNCHES["tcm-stanh"][name],
                                on_card)
            if not torch.equal(enc["y_hat"], dec["y_hat"]):
                raise AssertionError(f"tcm-stanh level {lv} image {j}: inexact decode")
            real = (len(enc["strings"][0][0]) + sum(len(s) for s in enc["strings"][1])) * 8 / px
            log(f"tcm-stanh level {lv} image {j}: real {real:.4f} bpp, estimate "
                f"{_bits(torch, fwd['likelihoods']) / px:.4f}, forward {fwd_ms:.1f} ms, encode "
                f"{enc_ms:.1f} ms, decode {dec_ms:.1f} ms, y_hat exact")
    log(f"launches per pass (each image and level): {json.dumps(PASS_LAUNCHES['tcm-stanh'])}")
    return codec, launch_counts()


def phase_stanh_scale(torch, device, hw):
    """The scale hyperprior with STanH on y and z (random weights): exact
    decode, and the z and y streams decoded to the encoder's symbols."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.entropy import stanh as sq
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    codec = _make_scale_stanh(device)
    m = codec.module
    reset_launch_counts()
    for j in range(2):
        x = synth_image(np.random.default_rng(SEED + j), *hw)[None]
        enc, enc_ms, l_enc = _timed(torch, device, lambda: codec.compress(x))
        dec, dec_ms, l_dec = _timed(torch, device,
                                    lambda: codec.decompress(enc["strings"], enc["shape"]))
        with torch.no_grad():
            y, z = m.analyze(codec._input(x))
            z_sym = sq.to_symbols(z, codec._z_state())
        z_dec = codec._decode(enc["strings"][1], codec._z_indexes(1, enc["shape"]),
                              codec.eb_tables)
        z_exact = bool(torch.equal(z_dec, z_sym))
        y_exact = bool(torch.equal(enc["y_hat"], dec["y_hat"]))
        px = hw[0] * hw[1]
        log(f"scale-stanh image {j}: y {len(enc['strings'][0][0]) * 8 / px:.4f} bpp, z "
            f"{len(enc['strings'][1][0]) * 8 / px:.4f} bpp ({len(np.unique(z_sym.cpu()))} z "
            f"levels used), encode {enc_ms:.1f} ms, decode {dec_ms:.1f} ms, z symbols decoded "
            f"exactly {z_exact}, y_hat exact {y_exact}, launches {json.dumps(l_enc)} / "
            f"{json.dumps(l_dec)}")
        if not (z_exact and y_exact):
            raise AssertionError(f"scale-stanh image {j}: inexact decode")
    return codec, launch_counts()


# the STanH eval slices: (phase, the codec's maker for the card-vs-CPU
# reference check at level 1, or None: random weights, no reference)
STANH_SLICES = {
    "wacnn-stanh": (phase_stanh_wacnn, _make_wacnn_stanh),
    "tcm-stanh": (phase_stanh_tcm, None),
    "scale-stanh": (phase_stanh_scale, None),
}


# --------------------------------- gain ---------------------------------

GAIN_SNAPSHOT = os.path.join("checkpoints", "scale_gain_vr_r5.npz")
# the snapshot's configuration (its .json): three levels trained at these
# lambdas, every gain started at ones
GAIN_LAMBDAS = (0.0025, 0.013, 0.05)
# (s, l): level s interpolated a share l towards level s + 1
GAIN_POINTS = ((0, 0.0), (1, 0.0), (2, 0.0), (0, 0.5), (1, 0.5))
WACNN_GAIN_LAMBDAS = (0.0025, 0.05)


def _make_scale_gain(device):
    """The gained scale hyperprior (N=192, M=320, three levels) with the
    committed trained weights; every snapshot entry placed."""
    from reslic_tcm_tpu_torch.models.gain.gained import make_gained_hyperprior
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    codec = make_gained_hyperprior("scale", N=192, M=320, lmbda_list=GAIN_LAMBDAS,
                                   device=device, seed=SEED)
    unused = load_snapshot_into(codec.module, GAIN_SNAPSHOT)
    if unused:
        raise AssertionError(f"{GAIN_SNAPSHOT}: entries left over: {unused}")
    codec.update()
    return codec


def _make_wacnn_gain(device):
    """The registry's wacnn_gain (N=192, M=320, lambda 0.0025 and 0.05,
    --gain_init_spread 2), random weights. At random init y rounds to zero
    whatever the gain, so g_a's last convolution is scaled by 40 and the
    sigma transforms' last by 60 (as tests/test_torch_port_wacnn.py does):
    y then takes many symbols over many scale indexes, and the gains move
    the rate."""
    from reslic_tcm_tpu_torch.models import get_model

    codec, *_ = get_model(_registry_args(
        ["-m", "wacnn_gain", "--N", "192", "--M", "320", "--gain_init_spread", "2",
         "--lambda_list", *map(str, WACNN_GAIN_LAMBDAS)]), device=device)
    m = codec.module
    with torch_no_grad():
        for layer, factor in [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms]:
            layer.weight.mul_(factor)
            layer.bias.mul_(factor)
    codec.update()
    return codec


def _make_scale_gain_sc(device):
    """The registry's scale_gain_sc (N=192, M=320, two levels), random weights."""
    from reslic_tcm_tpu_torch.models import get_model

    codec, *_ = get_model(_registry_args(["-m", "scale_gain_sc", "--N", "192", "--M", "320",
                                          "--lambda_list", "0.0025", "0.05"]), device=device)
    codec.update()
    return codec


def torch_no_grad():
    import torch

    return torch.no_grad()


def _nbytes(enc) -> int:
    return sum(len(s) for group in enc["strings"] for s in group)


def phase_gain_scale(torch, device, hw):
    """The trained gained scale hyperprior at each of GAIN_POINTS on the two
    images: the forward estimate at that point's gains, compress and
    decompress; exact y_hat, the decoded x_hat equal to the forward's
    clipped x_hat within 1e-5, real bpp within 3% of the estimate, bpp and
    PSNR per point; (s=0, l=1) and (s=1, l=0) code the same gains, so give
    byte-identical streams."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.utils.metrics import compute_psnr

    t0 = time.perf_counter()
    codec = _make_scale_gain(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice scale-gain: gained scale hyperprior N=192 M=320 from {GAIN_SNAPSHOT} (3 "
        f"levels, lambda {GAIN_LAMBDAS}) on {device}; the same two {hw[0]}x{hw[1]} images; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    px = hw[0] * hw[1]
    enc = codec.compress(images[0][None])  # warm-up: the first call of each pass
    codec.decompress(enc["strings"], enc["shape"])
    codec.forward(images[0][None])
    reset_launch_counts()
    for s, l in GAIN_POINTS:
        recs = []
        for j, img in enumerate(images):
            x = img[None]
            rec = {}
            fwd, rec["forward_ms"], l_fwd = _timed(torch, device, lambda: codec.forward(x, s, l))
            enc, rec["encode_ms"], l_enc = _timed(torch, device, lambda: codec.compress(x, s, l))
            dec, rec["decode_ms"], l_dec = _timed(
                torch, device, lambda: codec.decompress(enc["strings"], enc["shape"], s, l))
            for name, got in (("forward", l_fwd), ("compress", l_enc), ("decompress", l_dec)):
                _check_launches(j, f"(s={s}, l={l}) {name}", got,
                                PASS_LAUNCHES["scale-gain"][name], on_card)
            if not torch.equal(enc["y_hat"], dec["y_hat"]):
                raise AssertionError(f"scale-gain (s={s}, l={l}) image {j}: inexact decode")
            rec["x_hat_err"] = float((dec["x_hat"] - torch.clamp(fwd["x_hat"], 0, 1)).abs().max())
            rec["bpp_estimate"] = _bits(torch, fwd["likelihoods"]) / px
            rec["bpp"] = _nbytes(enc) * 8.0 / px
            rec["psnr"] = compute_psnr(torch.as_tensor(x, device=dec["x_hat"].device),
                                       dec["x_hat"])
            log(f"scale-gain (s={s}, l={l}) image {j}: real {rec['bpp']:.4f} bpp, estimate "
                f"{rec['bpp_estimate']:.4f}, PSNR {rec['psnr']:.3f} dB, decoded x_hat vs the "
                f"forward's max abs err {rec['x_hat_err']:.3e}, forward {rec['forward_ms']:.1f} "
                f"ms, encode {rec['encode_ms']:.1f} ms, decode {rec['decode_ms']:.1f} ms, "
                f"y_hat exact")
            if not rec["x_hat_err"] <= 1e-5:
                raise AssertionError(f"scale-gain (s={s}, l={l}) image {j}: decoded x_hat "
                                     f"differs from the forward's")
            if not abs(rec["bpp"] - rec["bpp_estimate"]) <= 0.03 * rec["bpp_estimate"]:
                raise AssertionError(f"scale-gain (s={s}, l={l}) image {j}: real bpp "
                                     f"{rec['bpp']:.4f} not within 3% of the estimate "
                                     f"{rec['bpp_estimate']:.4f}")
            recs.append(rec)
        log("gain_point " + json.dumps({"slice": "scale-gain", "s": s, "l": l, **{
            k: float(np.mean([r[k] for r in recs])) for k in recs[0]}}))
    x = images[0][None]
    same = codec.compress(x, 0, 1.0)["strings"] == codec.compress(x, 1, 0.0)["strings"]
    log(f"scale-gain: (s=0, l=1) and (s=1, l=0) streams byte-identical: {same}")
    if not same:
        raise AssertionError("scale-gain: (s=0, l=1) and (s=1, l=0) give other streams")
    return codec, launch_counts()


def _hyperprior_latents(torch, module, x, lv=0):
    """(z_hat, y_hat, g_s's input) of a gained hyperprior module's eval
    forward on NCHW x at level lv (the plain hyperprior's at no gain)."""
    from reslic_tcm_tpu_torch.models.gain.gained import scaled

    if hasattr(module, "level_gains"):
        gain, hyper_gain, inv_hyper, inv_gain = module.level_gains(lv)
        y, z = module.analyze_gained(x, gain, hyper_gain)
    else:
        (y, z), inv_hyper = module.analyze(x), None
    z_hat, _ = module.entropy_bottleneck(z)
    _, means = module.gaussian_params(z_hat if inv_hyper is None else scaled(z_hat, inv_hyper))
    y_hat = torch.round(y) if means is None else torch.round(y - means) + means
    return z_hat, y_hat, y_hat if inv_hyper is None else scaled(y_hat, inv_gain)


def _rounding_flips(torch, card, cpu, label):
    """Elements of (z_hat, y_hat) that round the other way on the CPU;
    printed, held to FLIP_SHARE. Returns the count."""
    flips = {k: int(((a.cpu() - b).abs() > 0.5).sum())
             for k, a, b in (("z", card[0], cpu[0]), ("y", card[1], cpu[1]))}
    n = cpu[0].numel() + cpu[1].numel()
    log(f"{label}: rounding flips card vs CPU {json.dumps(flips)} of {cpu[0].numel()} z and "
        f"{cpu[1].numel()} y elements")
    if not flips["z"] + flips["y"] <= FLIP_SHARE * n:
        raise AssertionError(f"{label}: {flips} rounding flips card vs CPU")
    return flips["z"] + flips["y"]


def phase_gain_reference(torch, codec, make, lv):
    """The card's gained forward at level lv against the CPU plain path at
    the same weights on a 256x256 image: elements of z_hat and y_hat that
    round the other way counted and held to 0.1%; x_hat against the CPU's
    g_s of the card's own y_hat within 1e-3, and the rate within 1e-3
    relative (plus 64 bits per flip)."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.layers import to_nhwc

    img = synth_image(np.random.default_rng(SEED + 7), 256, 256)[None]
    cpu = make("cpu")
    with torch.no_grad():
        xc, xp = codec._input(img), cpu._input(img)
        card_latents, cpu_latents = (_hyperprior_latents(torch, codec.module, xc, lv),
                                     _hyperprior_latents(torch, cpu.module, xp, lv))
        flips = _rounding_flips(torch, card_latents, cpu_latents, f"reference level {lv}")
        got = codec.forward(img, lv)
        want = cpu.forward(img, lv)
        ref = to_nhwc(torch.clamp(cpu.module.g_s(card_latents[2].cpu()), 0, 1))
    err = float((torch.clamp(got["x_hat"], 0, 1).cpu() - ref).abs().max())
    log(f"reference level {lv}: 256x256 x_hat card vs the CPU's g_s of the card's y_hat, max "
        f"abs err {err:.3e} (limit 1.000e-03)")
    if not (bool(torch.isfinite(got["x_hat"]).all()) and err <= 1e-3):
        raise AssertionError(f"card forward disagrees with the CPU reference: {err:.3e}")
    bits_a, bits_b = _bits(torch, got["likelihoods"]), _bits(torch, want["likelihoods"])
    log(f"reference level {lv}: bits card {bits_a:.2f} vs CPU {bits_b:.2f}")
    if not abs(bits_a - bits_b) <= 1e-3 * bits_b + 1.0 + 64.0 * flips:
        raise AssertionError("rate disagrees with the CPU reference")


def phase_gain_wacnn(torch, device, hw):
    """wacnn_gain (random weights, gains on a ladder of spread 2) at each
    of its two levels on the two images: the forward estimate, compress and
    decompress through compress_with_ac; exact y_hat, the decoded x_hat
    equal to the forward's clipped x_hat within 1e-5, B1 and B4 launches
    per pass as WACNN's, bpp rising from level 0 to level 1."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.training.codec_eval import compress_with_ac

    t0 = time.perf_counter()
    codec = _make_wacnn_gain(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    log(f"slice wacnn-gain: gained WACNN N=192 M=320 (registry -m wacnn_gain, lambda "
        f"{WACNN_GAIN_LAMBDAS}, --gain_init_spread 2), random weights (seed {SEED}) on {device}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    on_card = device == "cuda"
    px = hw[0] * hw[1]
    bpp = []
    reset_launch_counts()
    for lv in range(len(WACNN_GAIN_LAMBDAS)):
        real = []
        compress_with_ac(codec, images, lv=lv, log=lambda m: log("  " + m), records=real)
        for j, (img, r) in enumerate(zip(images, real)):
            fwd, fwd_ms, l_fwd = _timed(torch, device, lambda: codec.forward(img[None], lv=lv))
            for name, got in (("forward", l_fwd), ("compress", r["launches_compress"]),
                              ("decompress", r["launches_decompress"])):
                _check_launches(j, f"level {lv} {name}", got, PASS_LAUNCHES["wacnn-gain"][name],
                                on_card)
            if not r["y_hat_exact"]:
                raise AssertionError(f"wacnn-gain level {lv} image {j}: inexact decode")
            err = float((r["x_hat"] - torch.clamp(fwd["x_hat"], 0, 1)).abs().max())
            log(f"wacnn-gain level {lv} image {j}: real {r['bpp']:.4f} bpp (y {r['bpp_y']:.4f}, z "
                f"{r['bpp_z']:.4f}), estimate {_bits(torch, fwd['likelihoods']) / px:.4f}, PSNR "
                f"{r['psnr']:.3f} dB, decoded x_hat vs the forward's max abs err {err:.3e}, "
                f"forward {fwd_ms:.1f} ms, encode {r['encode_ms']:.1f} ms, decode "
                f"{r['decode_ms']:.1f} ms, y_hat exact")
            if not err <= 1e-5:
                raise AssertionError(f"wacnn-gain level {lv} image {j}: decoded x_hat differs")
        bpp.append(float(np.mean([r["bpp"] for r in real])))
    log(f"wacnn-gain: mean real bpp per level {bpp}; launches per pass (each image and level): "
        f"{json.dumps(PASS_LAUNCHES['wacnn-gain'])}")
    if not bpp[0] < bpp[1]:
        raise AssertionError(f"wacnn-gain: bpp does not rise from level 0 to level 1: {bpp}")
    return codec, launch_counts()


def phase_gain_sc(torch, device, hw):
    """scale_gain_sc (random weights) with a seeded quality map on the two
    images at (s=0, l=0.5): exact decode."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    codec = _make_scale_gain_sc(device)
    px = hw[0] * hw[1]
    reset_launch_counts()
    for j in range(2):
        x = synth_image(np.random.default_rng(SEED + j), *hw)[None]
        qmap = np.random.default_rng(SEED + 10 + j).uniform(size=(1, *hw, 1)).astype(np.float32)
        enc, enc_ms, l_enc = _timed(torch, device, lambda: codec.compress(x, qmap, 0, 0.5))
        dec, dec_ms, l_dec = _timed(
            torch, device, lambda: codec.decompress(enc["strings"], enc["shape"], 0, 0.5))
        exact = bool(torch.equal(enc["y_hat"], dec["y_hat"]))
        log(f"scale-gain-sc (s=0, l=0.5) image {j}: {_nbytes(enc) * 8 / px:.4f} bpp, encode "
            f"{enc_ms:.1f} ms, decode {dec_ms:.1f} ms, y_hat exact {exact}, launches "
            f"{json.dumps(l_enc)} / {json.dumps(l_dec)}")
        if not exact:
            raise AssertionError(f"scale-gain-sc image {j}: inexact decode")
    return codec, launch_counts()


# the gain eval slices: (phase, the codec's maker for the card-vs-CPU
# reference check at level 1, or None)
GAIN_SLICES = {
    "scale-gain": (phase_gain_scale, _make_scale_gain),
    "wacnn-gain": (phase_gain_wacnn, None),
    "scale-gain-sc": (phase_gain_sc, None),
}


# ------------------------------ pipelined -------------------------------

PIPE_BATCH = 8  # bench.py's default batch
PIPE_BATCHES = 4
PIPE_REPEATS = 3


def _flag_hooks(module, seen):
    """Forward hooks that record the two TF32 flags inside g_a, g_s and
    h_mean_s; returns their handles."""
    import torch

    def record(*_):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    return [m.register_forward_hook(record) for m in (module.g_a, module.g_s, module.h_mean_s)]


def phase_pipelined(torch, device, hw, batch=PIPE_BATCH, n_batches=PIPE_BATCHES,
                    repeats=PIPE_REPEATS):
    """TCM-S (the committed weights) over n_batches seeded batches of
    ``batch`` images: serial compress_batch + decompress_batch,
    compress_pipelined then serial decode, and roundtrip_pipelined. Every
    variant's streams
    must equal the serial ones, byte for byte, and its decode reproduce the
    encoder's y_hat exactly; MP/s per variant (median of ``repeats``
    runs); the serial run's launches; the caller's TF32 flags set True,
    read False inside every pass (hooks on g_a, g_s, h_mean_s) and True
    again after. Returns the codec, the batches and the serial launches."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    codec = _load_codec(device)
    images = [synth_image(np.random.default_rng(SEED + 100 + j), *hw) for j in range(batch)]
    batches = [np.stack(images[k:] + images[:k]) for k in range(n_batches)]
    mp = n_batches * batch * hw[0] * hw[1] / 1e6
    log(f"pipelined: TCM-S from {SNAPSHOT} on {device}, {n_batches} batches of {batch} x "
        f"{hw[0]}x{hw[1]} (batch k: {batch} seeded synthetic images, seeds {SEED + 100}.., "
        f"rotated by k), {mp:.3f} MP a run; set-up {time.perf_counter() - t0:.1f} s")

    def serial():
        encs = [codec.compress_batch(x) for x in batches]
        return encs, [codec.decompress_batch([e["strings"] for e in es], es[0]["shape"])
                      for es in encs]

    def compress_pipelined():
        flat = codec.compress_pipelined(batches)
        encs = [flat[k * batch:(k + 1) * batch] for k in range(n_batches)]
        return encs, [codec.decompress_batch([e["strings"] for e in es], es[0]["shape"])
                      for es in encs]

    def roundtrip():
        out = codec.roundtrip_pipelined(batches)
        return [o["encs"] for o in out], out

    variants = {"serial": serial, "compress_pipelined + serial decode": compress_pipelined,
                "roundtrip_pipelined": roundtrip}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    hooks = _flag_hooks(codec.module, seen)
    try:
        reset_launch_counts()
        want_encs, _ = serial()
        sync()
        serial_launches = launch_counts()
        want = [[e["strings"] for e in es] for es in want_encs]
        rates = {}
        for name, fn in variants.items():
            times = []
            for _ in range(repeats + 1):  # the first run warms up
                sync()
                t1 = time.perf_counter()
                encs, decs = fn()
                sync()
                times.append(time.perf_counter() - t1)
                if [[e["strings"] for e in es] for es in encs] != want:
                    raise AssertionError(f"pipelined {name}: streams differ from the serial ones")
                for es, dec in zip(encs, decs):
                    if not torch.equal(torch.cat([e["y_hat"] for e in es]), dec["y_hat"]):
                        raise AssertionError(f"pipelined {name}: inexact decode")
            rates[name] = mp / float(np.median(times[1:]))
            log(f"pipelined {name}: {rates[name]:.3f} MP/s (median of {repeats} runs of "
                f"{mp:.3f} MP: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms; warm-up "
                f"{times[0] * 1e3:.1f} ms), streams byte-identical to serial, y_hat exact")
        log("pipelined_rates " + json.dumps(rates))
        flags_inside = sorted(set(seen))
        caller = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        log(f"pipelined: TF32 flags inside the passes {flags_inside} ({len(seen)} hook calls), "
            f"the caller's {caller}")
        if flags_inside != [(False, False)] or caller != (True, True):
            raise AssertionError("a pipelined pass ran with TF32 on, or the caller's flags "
                                 "were lost")
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    want_launches = {k: n_batches * (PASS_LAUNCHES["tcm"]["compress"][k]
                                     + PASS_LAUNCHES["tcm"]["decompress"][k])
                     for k in serial_launches}
    _check_launches(0, "pipelined serial run", serial_launches, want_launches, device == "cuda")
    log(f"pipelined serial run launches {json.dumps(serial_launches)} (the pipelined variants "
        f"write the counters from several threads and are not held to counts)")
    return codec, batches, serial_launches


# ------------------------------ device coder ------------------------------

DC_K = 1024  # compress_device*'s default lanes
SERVE_K = 4096  # serve_roundtrip_*'s default lanes
DC_REPEATS = 3
CODER_SOURCE = "reslic_tcm_tpu_torch/csrc/device_rans.cu"
# float32 operations of the analytic coders (an erf: 10 fmas at 2, 4 more;
# Phi: 2 more; a symbol's parameters: 2 Phi and 8 more; a boundary: Phi and 5
# more). D3 needs a symbol's parameters and its 2 boundaries; D4 its
# parameters and the boundaries that a search over its nb bins needs,
# ceil(log2 nb) + 1. D1 and D2 do integer work only, so their bound is their
# bytes.
_PHI_OPS = 26
_PARAM_OPS = 2 * _PHI_OPS + 8
_BOUNDARY_OPS = _PHI_OPS + 5


def _run_plain(torch, fn, on_card):
    """(fn(), ms on the host clock ending in a synchronise)."""
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _equal(torch, a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(torch, u, v) for u, v in zip(a, b))
    return bool(torch.equal(a, b))


def _coder_case(torch, name, label, kern, plain, on_card, nbytes, ops, reps):
    """Kernel D1-D4 against its plain version on the same inputs, bit for
    bit: the kernel's time per call of ``kern`` (CUDA events, after warm-up),
    the plain version's (one run, host clock), the bound from the bytes the
    launches must move (``nbytes``, or a function of the plain version's
    output that gives them) and their float32 operations. ``kern`` and
    ``plain`` return what they decode or encode and the carry, if any."""
    want, plain_ms = _run_plain(torch, plain, on_card)
    if not on_card:
        log(f"coder_case {name} {label}: plain version {plain_ms:.1f} ms (kernels run on the "
            f"card only)")
        return {"plain_ms": plain_ms}, want
    got = kern()
    torch.cuda.synchronize()
    equal = _equal(torch, got, want)
    ms = _time_ms(torch, kern, reps)
    if callable(nbytes):
        nbytes = nbytes(want)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    case = {"kernel": name, "case": label, "equal": equal, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "mbytes": nbytes / 1e6}
    log("coder_case " + json.dumps(case))
    if not equal:
        raise AssertionError(f"{name} {label}: the kernel and its plain version differ")
    return case, want


def _table_entries(torch, sym, idx, t):
    """(distinct table entries, distinct rows) that coding ``sym`` with the
    scale indexes ``idx`` touches: an escaped symbol takes its row's escape
    bin."""
    idx = idx.long()
    val = sym.long() - t.offset[idx].long()
    top = t.cdf_length[idx].long() - 2
    val = torch.where((val < 0) | (val >= top), top, val)
    return (int(torch.unique(idx * t.packed.shape[1] + val).numel()),
            int(torch.unique(idx).numel()))


def _encode_bytes(torch, sym, idx, t, counts):
    """D1's bytes: symbols and indexes read (int32), the table entries and
    rows they touch (packed; cdf_length and offset), the emitted words and
    the counts written."""
    entries, rows = _table_entries(torch, sym, idx, t)
    return sym.numel() * 8 + entries * 4 + rows * 8 + (int(counts.sum()) + counts.numel()) * 4


def _decode_bytes(torch, sym, idx, t, counts, launches):
    """D2's bytes: indexes read, symbols written (int32), the table entries
    and rows the decoded symbols touch (an entry and its bucket, 6 bytes;
    cdf_length and offset), the words past the two that decoder_init
    reads, and per launch each lane's base read and carry (state, read
    pointer) read and written."""
    entries, rows = _table_entries(torch, sym, idx, t)
    k = counts.numel()
    return (idx.numel() * 8 + entries * 6 + rows * 8 + (int(counts.sum()) - 2 * k) * 4
            + launches * k * 40)


def _search_ops(torch, sigma) -> int:
    """D4's float32 operations on ``sigma``: per symbol its parameters and
    ceil(log2 nb) + 1 boundaries (see _PHI_OPS)."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    nb = 2 * ar.support(sigma).double() + 1
    evals = int((torch.ceil(torch.log2(nb)) + 1).sum())
    return sigma.numel() * _PARAM_OPS + evals * _BOUNDARY_OPS


CODER_SYMBOLS = {"encode_lanes": "rans_encode_kernel", "decode_lanes": "rans_decode_kernel",
                 "gaussian_encode_lanes": "gaussian_encode_kernel",
                 "gaussian_decode_lanes": "gaussian_decode_kernel"}


def _cxx(v) -> str:
    """A template argument as the profiler's kernel name spells it."""
    return str(v).lower() if isinstance(v, bool) else str(v)


def _coder_splits(torch, name, label, calls, want, chosen, per_call):
    """Each instance of a coder kernel on the same inputs (D1, D3: their one
    configuration; D2: every variant that takes the table; D4: every
    cluster size), ``calls`` keyed by its template arguments (() for
    none): each call's output and carry must
    equal ``want``, the plain version's, bit for bit. Prints a ``split``
    line: each one's time per call (CUDA events, the wrapper's host work
    included) and its device time (profiler) over SPLIT_ROUNDS interleaved
    rounds, each round calling every one in turn, forward and backward.
    Each instance is a kernel of its own name, so its launches are told
    apart by name: a record the profiler drops leaves one launch fewer
    (``launches_seen``), and a call's device time is the mean launch times
    ``per_call``, the launches a call makes. Returns ``chosen``'s (the
    wrapper's choice), or None where the profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(calls)
    equal, call_ms = {}, {}
    for n in names:
        got = calls[n]()
        torch.cuda.synchronize()
        equal[n] = _equal(torch, got, want)
        call_ms[n] = _time_ms(torch, calls[n], 3)
    symbols = {n: CODER_SYMBOLS[name] + (f"<{', '.join(map(_cxx, n))}>" if n else "(")
               for n in names}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(SPLIT_ROUNDS):
            for n in (names if r % 2 == 0 else names[::-1]):
                calls[n]()
        torch.cuda.synchronize()
    runs = {n: [] for n in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if symbols[n] in e.name:
                    runs[n].append(e.time_range.elapsed_us() / 1e3)
    per_call_ms = {n: float(np.mean(v)) * per_call if v else None for n, v in runs.items()}
    log("split " + json.dumps({
        "kernel": name, "case": label, "splits": [list(n) for n in names],
        "equal": all(equal.values()), "call_ms": [call_ms[n] for n in names],
        "device_ms_per_call": [per_call_ms[n] for n in names],
        "launches_seen": [len(runs[n]) for n in names],
        "launches": SPLIT_ROUNDS * per_call, "chosen": list(chosen)}))
    bad = [n for n in names if not equal[n]]
    if bad:
        raise AssertionError(f"{name} {label}: {bad} differ from the plain version")
    return per_call_ms[chosen]


def _d4_key(dk, k, cluster) -> tuple:
    """D4's instance at k lanes on ``cluster`` CTAs as its template arguments
    (CTAs, whether a thread holds one lane; else its lanes are kept in
    memory)."""
    return (cluster, dk.decode_lanes_per_thread(k, cluster) == 1)


def _d4_calls(dk, k, kern) -> dict:
    """{D4's template arguments: kern(cluster)} for every cluster size the
    wrapper offers at k lanes."""
    return {_d4_key(dk, k, c): (lambda c=c: kern(c)) for c in dk.decode_clusters(k)}


def _coder_kernel_checks(torch, codec, x1, x8, on_card):
    """D1-D4 against their plain versions on one image's real slice inputs
    (k=1024: the y and z streams, the five y segments chained) and on a
    batch of 8 at the serving path's k=4096 (D1 and D2 its z stream at its
    kz, compacted as the analytic container holds it; D3 the y stream, D4
    its five segments). Returns per kernel its record for one image (sums
    over its launches in one image's encode or decode at k=1024)."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.coding import device_rans as dr

    tables = codec._device_tables(0)
    yt, zt = tables["y"], tables["z"]
    t_in = codec.device_coder_inputs(x1)
    n, n_slice = t_in["y"].numel(), t_in["slice_symbols"]
    segments = n // n_slice
    kz, z_cap = codec._z_lanes(t_in, DC_K)
    z_rows = torch.arange(zt.cdf.shape[0], dtype=torch.int32, device=codec.device).repeat(
        t_in["z"].numel() // zt.cdf.shape[0])
    per = {}

    def add(name, case, launches):
        rec = per.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_ops": 0.0,
                                    "t_bytes": 0.0, "launches_per_image": 0, "device_ms": None})
        for key in ("ms", "plain_ms", "bound_ms"):
            rec[key] += case.get(key, 0.0)
        if case.get("device_ms") is not None:
            rec["device_ms"] = (rec["device_ms"] or 0.0) + case["device_ms"]
        rec["launches_per_image"] += launches
        if "bound_by" in case:
            t = case["bound_ms"]
            rec["t_ops" if case["bound_by"] == "operations" else "t_bytes"] += t

    def encode_case(label, sym, idx, t, k, cap):
        case, stream = _coder_case(
            torch, "encode_lanes", label,
            lambda: dk.encode_lanes(sym, idx, t.packed, t.cdf_length, t.offset, k, cap),
            lambda: dr.plain_encode_lanes(sym, idx, t.cdf, t.cdf_length, t.offset, k, cap,
                                          t.packed),
            on_card, lambda out: _encode_bytes(torch, sym, idx, t, out[1]), 0, 20)
        if on_card:
            case["device_ms"] = _coder_splits(
                torch, "encode_lanes", label,
                {(): lambda: dk.encode_lanes(sym, idx, t.packed, t.cdf_length, t.offset, k,
                                             cap)}, stream, (), 1)
        if bool((stream[1] > cap).any()):
            raise AssertionError(f"encode_lanes {label}: a lane outgrew its cap {cap}")
        return case, stream

    # D1: the y stream and the z stream of one image
    streams = {}
    for part, sym, idx, t, k, cap in (("y", t_in["y"], t_in["indexes"], yt, DC_K,
                                       max(64, n // DC_K)),
                                      ("z", t_in["z"], z_rows, zt, kz, z_cap)):
        case, streams[part] = encode_case(f"{part} k={k}", sym, idx, t, k, cap)
        add("encode_lanes", case, 1)

    # D2: the z stream, then the five y segments chained
    def decode_case(label, words, counts, idx, t, k, n_seg, want, offsets=None):
        carry0 = dr.decoder_init(words, counts, offsets)
        base = dr.lane_base(words, k, offsets)
        parts = idx.split(idx.numel() // n_seg)

        def kern(variant=None):
            x, rp = carry0[0].clone(), carry0[1].clone()
            out = [dk.decode_lanes(x, rp, words, base, p, t.search, k) if variant is None
                   else dk.decode_with(x, rp, words, base, p, t.search, k, variant)
                   for p in parts]
            return torch.cat(out), x, rp

        def plain():
            carry, out = carry0, []
            for p in parts:
                carry, syms = dr.plain_decode_lanes(carry, words, base, p, t.cdf, t.cdf_length,
                                                    t.offset, k, t.inverse, t.packed)
                out.append(syms)
            return (torch.cat(out), *carry)

        nbytes = _decode_bytes(torch, want, idx, t, counts, n_seg)
        case, got = _coder_case(torch, "decode_lanes", label, kern, plain, on_card, nbytes, 0, 5)
        if not torch.equal(got[0], want):
            raise AssertionError(f"decode_lanes {label}: the stream decoded to other symbols")
        if on_card:
            case["device_ms"] = _coder_splits(
                torch, "decode_lanes", label,
                {v: (lambda v=v: kern(v)) for v in dk.decode_variants(t.search)}, got,
                dk.decode_variant(t.search), n_seg)
        return case

    add("decode_lanes", decode_case(f"z k={kz}", *streams["z"], z_rows, zt, kz, 1, t_in["z"]), 1)
    add("decode_lanes", decode_case(f"y k={DC_K}, {segments} segments", *streams["y"],
                                    t_in["indexes"], yt, DC_K, segments, t_in["y"]), segments)

    # D1 and D2 on the serving path's z stream: a batch of 8 at kz
    a8 = codec.device_coder_inputs(x8, analytic=True)
    kz8, z_cap8 = codec._z_lanes(a8, SERVE_K)
    z_rows8 = torch.arange(zt.cdf.shape[0], dtype=torch.int32, device=codec.device).repeat(
        a8["z"].numel() // zt.cdf.shape[0])
    _, (z_words, z_counts) = encode_case(f"z batch {len(x8)} k={kz8}", a8["z"], z_rows8, zt,
                                            kz8, z_cap8)
    z_flat, _ = ar.compact_stream(z_words, z_counts, max(4 * kz8, a8["z"].numel() // 2))
    decode_case(f"z batch {len(x8)} k={kz8}, compacted", z_flat, z_counts, z_rows8, zt, kz8, 1,
                a8["z"], ar.lane_offsets(z_counts))

    # D3 and D4: one image at k=1024 and the batch of 8 at k=4096, then D3's
    # device time and D4 at every cluster size on the same inputs
    for a_in, k, label in ((codec.device_coder_inputs(x1, analytic=True), DC_K, "batch 1"),
                           (a8, SERVE_K, f"batch {len(x8)}")):
        sym, sigma, n_all = a_in["y"], a_in["sigma"], a_in["y"].numel()
        n_seg = n_all // a_in["slice_symbols"]

        def encode():
            return dk.gaussian_encode_lanes(sym, sigma, k)

        case, lanes = _coder_case(
            torch, "gaussian_encode_lanes", f"{label} k={k}", encode,
            lambda: ar.plain_encode_gaussian_lanes(sym, sigma, k),
            on_card, n_all * 13 + k * 8, n_all * (_PARAM_OPS + 2 * _BOUNDARY_OPS), 5)
        if on_card:
            case["device_ms"] = _coder_splits(
                torch, "gaussian_encode_lanes", f"{label} k={k}",
                {(): encode}, lanes, (), 1)
        header, flat, total, _ = ar.compact_grouped(*lanes, n_all)
        flat = torch.cat([flat, flat.new_zeros(k)])
        seg = a_in["slice_symbols"]
        carry0 = ar.decode_gaussian_grouped_init(header)

        def kern(cluster=None):
            x_, g = carry0[0].clone(), carry0[1].clone()
            out = [dk.gaussian_decode_lanes(x_, g, flat, sigma[i * seg:(i + 1) * seg], k)
                   if cluster is None else
                   dk.decode_on_cluster(x_, g, flat, sigma[i * seg:(i + 1) * seg], k, cluster)
                   for i in range(n_seg)]
            return torch.cat(out), x_, g

        def plain():
            carry, out = carry0, []
            for i in range(n_seg):
                carry, vals = ar.plain_decode_gaussian_lanes(carry, flat,
                                                             sigma[i * seg:(i + 1) * seg], k)
                out.append(vals)
            return (torch.cat(out), *carry)

        # sigma read, symbols written, every grouped word read, per launch
        # each lane's state read and written and the stream pointer
        n_dec = n_seg * seg
        dcase, got = _coder_case(torch, "gaussian_decode_lanes",
                                 f"{label} k={k}, {n_seg} segments", kern, plain, on_card,
                                 n_dec * 8 + int(total) * 4 + n_seg * (k * 16 + 16),
                                 _search_ops(torch, sigma[:n_dec]), 3)
        if not torch.equal(got[0], sym[:n_dec]):
            raise AssertionError(f"gaussian_decode_lanes {label}: decoded other symbols")
        if on_card:
            dcase["device_ms"] = _coder_splits(
                torch, "gaussian_decode_lanes", f"{label} k={k}, {n_seg} segments",
                _d4_calls(dk, k, kern), got, _d4_key(dk, k, dk.decode_cluster(k)), n_seg)
        if k == DC_K:
            add("gaussian_encode_lanes", case, 1)
            add("gaussian_decode_lanes", dcase, n_seg)
        log(f"coder {label}: {n_all} y symbols, {int(total)} grouped words, "
            f"{int(a_in['clamped'])} clamped")
    return per


def phase_device_coder(torch, device, hw, batches, repeats=DC_REPEATS):
    """The device coder on TCM-S (the committed weights): D1-D4 against
    their plain versions on real slice inputs (card only; the CPU runs the
    plain versions), then the two seeded images through compress_device /
    decompress_device and the analytic pair (exact y_hat, the table path's
    x_hat against the host codec's decode within 1e-5, the analytic path's
    clamped symbols, encode and decode ms as the median of ``repeats``,
    real bpp beside the host codec's and the estimate, the launches of
    B1-B3 per pass), then serve_roundtrip_metrics and
    serve_roundtrip_pipelined over ``batches`` (k=4096) beside the serial
    host path in MP/s (median of ``repeats``). Returns the codec, the
    main path's B1-B4 launches, the coder kernels' launches on it and
    their per-image records."""
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts

    t0 = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    codec = _load_codec(device)
    images = [synth_image(np.random.default_rng(SEED + i), *hw)[None] for i in range(2)]
    log(f"device coder: TCM-S from {SNAPSHOT} on {device}, the two {hw[0]}x{hw[1]} images of "
        f"the slices (seed {SEED}); k={DC_K}; set-up {time.perf_counter() - t0:.1f} s")
    per_kernel = _coder_kernel_checks(torch, codec, images[0], batches[0], on_card)

    profiles = {
        "table": (codec.compress_device, lambda enc: codec.decompress_device(enc)),
        "analytic": (codec.compress_device_analytic,
                     lambda enc: codec.decompress_device_analytic(enc)),
    }
    path_launches = dict.fromkeys(launch_counts(), 0)  # B1-B4 in the device profiles' passes
    dk.reset_launch_counts()
    for j, x in enumerate(images):
        npix = hw[0] * hw[1]
        est = _bits(torch, codec.forward(x)["likelihoods"]) / npix
        host_ms = []
        for _ in range(repeats):
            host, enc_ms, _ = _timed(torch, device, lambda: codec.compress(x))
            host_dec, dec_ms, _ = _timed(
                torch, device, lambda: codec.decompress(host["strings"], host["shape"]))
            host_ms.append((enc_ms, dec_ms))
        host_bpp = (len(host["strings"][0][0]) + sum(map(len, host["strings"][1]))) * 8 / npix
        for name, (compress, decompress) in profiles.items():
            enc_ms, dec_ms = [], []
            for _ in range(repeats):
                enc, ms, launches_c = _timed(torch, device, lambda: compress(x))
                enc_ms.append(ms)
                dec, ms, launches_d = _timed(torch, device, lambda: decompress(enc))
                dec_ms.append(ms)
            for launches in (launches_c, launches_d):
                for kernel, n in launches.items():
                    path_launches[kernel] += n * repeats
            _check_launches(j, f"{name} compress_device", launches_c,
                            PASS_LAUNCHES["tcm"]["compress"], on_card)
            _check_launches(j, f"{name} decompress_device", launches_d,
                            PASS_LAUNCHES["tcm"]["decompress"], on_card)
            if not torch.equal(enc["y_hat"], dec["y_hat"]):
                raise AssertionError(f"image {j} {name}: decode did not reproduce y_hat")
            x_err = float((dec["x_hat"] - host_dec["x_hat"]).abs().max())
            rec = {"image": j, "profile": name, "k": DC_K, "bpp": enc["nbytes"] * 8 / npix,
                   "host_bpp": host_bpp, "estimate_bpp": est,
                   "encode_ms": float(np.median(enc_ms)), "decode_ms": float(np.median(dec_ms)),
                   "host_encode_ms": float(np.median([t[0] for t in host_ms])),
                   "host_decode_ms": float(np.median([t[1] for t in host_ms])),
                   "y_hat_exact": True, "x_hat_vs_host": x_err,
                   "clamped": enc.get("clamped"), "launches_compress": launches_c,
                   "launches_decompress": launches_d}
            log("device_coder " + json.dumps(rec))
            if name == "table" and not x_err <= 1e-5:
                raise AssertionError(f"image {j}: the table path's x_hat is {x_err:.2e} from "
                                     f"the host codec's")
    sync()
    coder_launches = dk.launch_counts()
    log(f"device coder path launches {json.dumps(path_launches)}; coder kernels "
        f"{json.dumps(coder_launches)}")
    if on_card:
        for name in dk.launch_counts():
            if coder_launches[name] == 0:
                raise AssertionError(f"{name} was never launched on the device-coder path")

    b = len(batches[0])
    mp = len(batches) * b * hw[0] * hw[1] / 1e6

    def serial():
        out = []
        for x in batches:
            encs = codec.compress_batch(x)
            out.append((encs, codec.decompress_batch([e["strings"] for e in encs],
                                                     encs[0]["shape"])))
        return out

    def served_pairs(results):
        return [(r["enc"]["y_hat"], r["y_hat"]) for r in results]

    serial_name = "serial compress_batch + decompress_batch"
    metrics_name = f"serve_roundtrip_metrics k={SERVE_K}"
    # variant -> (run, its (encoder's y_hat, decoder's y_hat) per batch)
    variants = {serial_name: (serial, lambda results: [
                    (torch.cat([e["y_hat"] for e in encs]), dec["y_hat"])
                    for encs, dec in results]),
                metrics_name: (lambda: codec.serve_roundtrip_metrics(batches, k=SERVE_K),
                               served_pairs),
                f"serve_roundtrip_pipelined k={SERVE_K}":
                    (lambda: codec.serve_roundtrip_pipelined(batches, k=SERVE_K), served_pairs)}
    rates, last = {}, {}
    for name, (fn, pairs) in variants.items():
        times = []
        for _ in range(repeats + 1):  # the first run warms up
            sync()
            t1 = time.perf_counter()
            last[name] = fn()
            sync()
            times.append(time.perf_counter() - t1)
        rates[name] = mp / float(np.median(times[1:]))
        log(f"device coder serve {name}: {rates[name]:.3f} MP/s (median of {repeats} runs of "
            f"{mp:.3f} MP: {', '.join(f'{t * 1e3:.1f}' for t in times[1:])} ms)")
        # the last timed run's decodes against its encoder, batch by batch
        for j, (want, got) in enumerate(pairs(last[name])):
            if not torch.equal(want, got):
                raise AssertionError(f"device coder serve {name}: batch {j} decoded another "
                                     f"y_hat than its encoder's")
        log(f"device coder serve {name}: y_hat exact in all {len(batches)} batches of the last "
            f"timed run")
    log("device_coder_rates " + json.dumps(rates))
    psnr = [float(v) for r in last[metrics_name] for v in r["psnr"]]
    log(f"device coder serve: PSNR on {device} {min(psnr):.3f}-{max(psnr):.3f} dB over "
        f"{len(psnr)} images")
    if on_card:
        for name, (fn, _) in variants.items():
            _profile_window(torch, f"device coder {name} ({len(batches)} x {b} x "
                            f"{hw[0]}x{hw[1]})", fn, watch=tuple(CODER_SYMBOLS.values()))
    return codec, path_launches, coder_launches, per_kernel


# ------------------------------- parallel -------------------------------

# TCM-S over 512x512 tiles (the JAX CLI's --tile default) of one 2048x1408
# image: 20 tiles, 3 chunks of 8 (the last padded with 4 empty tiles)
TILED_HW = (2048, 1408)
TILE, TILE_OVERLAP, TILE_BATCH = 512, 64, 8
DP_BATCH, DP_HW = 16, (256, 256)
PARALLEL_BUDGET_S = 90.0


def _psnr(torch, a, b) -> float:
    return float(-10 * torch.log10(((a - b) ** 2).mean()))


def _mosaic(images, hw) -> np.ndarray:
    """[1, h, w, 3]: ``images`` (equal sizes) laid in rows, in turn, over
    h x w and cropped to it."""
    ih, iw = images[0].shape[:2]
    rows, cols = -(-hw[0] // ih), -(-hw[1] // iw)
    grid = [[images[(r * cols + c) % len(images)] for c in range(cols)] for r in range(rows)]
    return np.block([[[im] for im in row] for row in grid])[None, :hw[0], :hw[1]]


def phase_parallel(torch, device, images, tiled_hw=TILED_HW, tile=TILE, tile_batch=TILE_BATCH,
                   train_batch=DP_BATCH, train_hw=DP_HW):
    """The parallel slice on one device, TCM-S with the committed weights,
    on ``images`` (the pipelined phase's first batch of seeded synthetic
    images). Tiled: ``tiled_forward`` of one ``tiled_hw`` mosaic of them
    (tile 512, overlap 64, ``tile_batch`` a chunk) through the kernels (launches
    counted: each chunk's forward launches B1-B3 as one forward pass does),
    then through their plain versions on the same device (x_hat within TOL,
    bits within 1e-4 relative) and against the monolithic forward (mean
    |x_hat difference| below 0.02, PSNR between them above 25 dB, bpp
    within 5%), with ms, MP/s, bpp and PSNR of each and a profile of one
    tiled pass. Then a world of one (NCCL on the card, gloo on the CPU):
    ``mesh_sharded_forward`` of the first image against the module's forward of
    the image with its two 64-row zero halos (x_hat within TOL, bits within
    1e-4 relative) and against the monolithic forward (mean |difference|
    below 0.02, as the JAX package's test; the bits are printed: the zero
    halo at the outer edges adds 8-9% at 768x512 on TCM-S);
    ``shard_for_inference`` on the batch of ``images``, streams
    byte-identical to the unsharded codec's and the decode's y_hat exact;
    the sharded train step (``shard_train_step``) at ``train_batch`` x
    ``train_hw`` against ``train_step`` from the same weights and seed,
    loss within 1e-6 relative over two steps, ms per step of each. Returns
    the tiled pass's launches."""
    from reslic_tcm_tpu_torch.cli.train import to_device
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.ops.layers import plain_versions, to_nchw, to_nhwc
    from reslic_tcm_tpu_torch.parallel import mesh as pmesh
    from reslic_tcm_tpu_torch.parallel.multihost import free_port, initialize_distributed
    from reslic_tcm_tpu_torch.parallel.spatial import (STRIDES, mesh_sharded_forward, tile_grid,
                                                       tiled_forward)
    from reslic_tcm_tpu_torch.training.step import (create_train_state, shard_train_step,
                                                    step_noise, train_step)

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    codec = _load_codec(device)
    h, w = tiled_hw
    x = torch.from_numpy(_mosaic(images, tiled_hw)).to(device)
    n_chunks = -(-len(tile_grid(h, w, tile, TILE_OVERLAP)) // tile_batch)
    log(f"parallel: TCM-S from {SNAPSHOT} on {device}; tiled_forward of one {h}x{w} mosaic of "
        f"the pipelined phase's {len(images)} seeded synthetic {images[0].shape[0]}x"
        f"{images[0].shape[1]} images, tile {tile}, overlap {TILE_OVERLAP}, {tile_batch} tiles "
        f"a chunk: {n_chunks} chunks; set-up {time.perf_counter() - t_phase:.1f} s")
    run = lambda: tiled_forward(codec, x, tile, TILE_OVERLAP, tile_batch)  # noqa: E731
    reset_launch_counts()
    (x_tiled, bits_tiled), ms_first = timed(run)
    launches = launch_counts()
    want = {k: n_chunks * v if on_card else 0 for k, v in PASS_LAUNCHES["tcm"]["forward"].items()}
    log(f"parallel tiled: launches {json.dumps(launches)} ({n_chunks} chunks x one forward "
        f"pass's)")
    if launches != want:
        raise AssertionError(f"tiled launches {launches}, expected {want}")
    (x_again, _), ms_tiled = timed(run)
    before = launch_counts()
    with plain_versions():
        (x_plain, bits_plain), ms_plain = timed(run)
    if launch_counts() != before:
        raise AssertionError("the plain versions launched a kernel")
    mono, ms_mono = timed(lambda: codec.forward(x))
    x_mono = torch.clamp(mono["x_hat"], 0, 1)
    bits_mono = _bits(torch, mono["likelihoods"])
    err = float((x_tiled - x_plain).abs().max())
    tol = TOL * max(1.0, float(x_plain.abs().max()))
    mp = h * w / 1e6
    diff = (x_tiled - x_mono).abs()
    bpp = {"tiled": bits_tiled / (h * w), "plain": bits_plain / (h * w),
           "monolithic": bits_mono / (h * w)}
    log(f"parallel tiled: kernels vs plain versions on {device}: x_hat max abs err {err:.3e} "
        f"(limit {tol:.3e}), bits {bits_tiled:.2f} vs {bits_plain:.2f} (relative "
        f"{abs(bits_tiled - bits_plain) / bits_plain:.2e}, limit 1e-4); repeat run equal: "
        f"{bool(torch.equal(x_tiled, x_again))}")
    log(f"parallel tiled: {ms_tiled:.1f} ms ({mp / ms_tiled * 1e3:.2f} MP/s; first run "
        f"{ms_first:.1f} ms), plain versions {ms_plain:.1f} ms, monolithic forward "
        f"{ms_mono:.1f} ms ({mp / ms_mono * 1e3:.2f} MP/s); bpp tiled {bpp['tiled']:.4f}, "
        f"monolithic {bpp['monolithic']:.4f}; PSNR tiled {_psnr(torch, x_tiled, x):.3f} dB, "
        f"monolithic {_psnr(torch, x_mono, x):.3f} dB; tiled vs monolithic: mean |diff| "
        f"{float(diff.mean()):.2e}, PSNR {_psnr(torch, x_tiled, x_mono):.2f} dB")
    if not (bool(torch.isfinite(x_tiled).all()) and err <= tol
            and abs(bits_tiled - bits_plain) <= 1e-4 * bits_plain):
        raise AssertionError("tiled forward: the kernels disagree with their plain versions")
    if not (float(diff.mean()) < 0.02 and _psnr(torch, x_tiled, x_mono) > 25
            and abs(bits_tiled - bits_mono) <= 0.05 * bits_mono):
        raise AssertionError("tiled forward strays from the monolithic forward")
    if on_card:
        _profile_window(torch, f"tiled TCM-S {h}x{w} ({n_chunks} chunks of {tile_batch} x "
                        f"{tile}x{tile})", run, watch=("swin_block_kernel", "conv_gemm_kernel"))

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)
    try:
        backend = torch.distributed.get_backend()
        sh, sw = images[0].shape[:2]
        img = torch.from_numpy(images[:1]).to(device)
        (x_sh, bits_sh), ms_sh = timed(
            lambda: mesh_sharded_forward(codec.module, to_nchw(img), None, halo=64))
        # one rank's halo is two bands of 64 zero rows: its forward is the
        # module's on the image so padded, centre rows kept
        with torch.no_grad():
            padded = codec.module(torch.nn.functional.pad(to_nchw(img), (0, 0, 64, 64)))
        x_pad = torch.clamp(padded["x_hat"][:, :, 64:64 + sh], 0, 1)
        bits_pad = _bits(torch, {k: lik[:, :, 64 // STRIDES[k]:(64 + sh) // STRIDES[k]]
                                 for k, lik in padded["likelihoods"].items()})
        mono = codec.forward(img)
        bits_m = _bits(torch, mono["likelihoods"])
        d = float((to_nhwc(x_sh) - torch.clamp(mono["x_hat"], 0, 1)).abs().mean())
        e = float((x_sh - x_pad).abs().max())
        log(f"parallel {backend} world of 1: mesh_sharded_forward {sh}x{sw}, halo 64: "
            f"{ms_sh:.1f} ms; against the zero-padded forward: x_hat max abs err {e:.2e} "
            f"(limit {TOL:.0e}), bits {bits_sh:.2f} vs {bits_pad:.2f} (limit 1e-4 relative); "
            f"against the monolithic forward: mean |x_hat diff| {d:.2e} (limit 2e-2), bits "
            f"{bits_sh:.2f} vs {bits_m:.2f} ({bits_sh / bits_m - 1:+.2%}, not held: the zero "
            f"halo at the outer edges)")
        if not (e <= TOL and abs(bits_sh - bits_pad) <= 1e-4 * bits_pad and d < 0.02):
            raise AssertionError("mesh_sharded_forward disagrees with its reference")

        batch, serve_batch = images, len(images)
        ref, ms_ref = timed(lambda: codec.compress_batch(batch))
        served = _load_codec(device)
        served.shard_for_inference()
        encs, ms_enc = timed(lambda: served.compress_batch(batch))
        dec, ms_dec = timed(lambda: served.decompress_batch([e["strings"] for e in encs],
                                                            encs[0]["shape"]))
        same = [e["strings"] for e in encs] == [e["strings"] for e in ref]
        exact = bool(torch.equal(dec["y_hat"], torch.cat([e["y_hat"] for e in encs])))
        log(f"parallel {backend} world of 1: shard_for_inference, batch {serve_batch} x "
            f"{sh}x{sw}: compress_batch {ms_enc:.1f} ms (unsharded {ms_ref:.1f}), "
            f"decompress_batch {ms_dec:.1f} ms; streams byte-identical to the unsharded "
            f"codec's: {same}; y_hat exact: {exact}")
        if not (same and exact and tuple(dec["x_hat"].shape) == (serve_batch, sh, sw, 3)):
            raise AssertionError("data-parallel serving differs from the unsharded codec")

        mesh = pmesh.make_mesh()
        crops = _crops(train_batch, train_hw, SEED + 3)
        one = create_train_state(_train_tcm_s(device))
        sharded = create_train_state(pmesh.shard_params(mesh, _train_tcm_s(device)))
        step = shard_train_step(mesh)
        for k in range(2):
            want, ms_one = timed(lambda: train_step(
                one, to_device(crops, device), TRAIN_LAMBDA, step_noise(SEED, one.step, device)))
            got, ms_dp = timed(lambda: step(
                sharded, pmesh.shard_batch(mesh, to_device(crops, device)), TRAIN_LAMBDA,
                step_noise(SEED, sharded.step, device)))
            a, b = float(got["loss"]), float(want["loss"])
            log(f"parallel {backend} world of 1: train step {k + 1}, TCM-S {train_batch} x "
                f"{train_hw[0]}x{train_hw[1]}: shard_train_step loss {a:.6f} vs train_step "
                f"{b:.6f} (relative {abs(a - b) / abs(b):.2e}, limit 1e-6), {ms_dp:.1f} vs "
                f"{ms_one:.1f} ms per step")
            if not abs(a - b) <= 1e-6 * abs(b):
                raise AssertionError("shard_train_step differs from train_step")
    finally:
        torch.distributed.destroy_process_group()
    wall = time.perf_counter() - t_phase
    log(f"parallel: phase wall {wall:.1f} s (limit {PARALLEL_BUDGET_S:.0f} s on the card)")
    if on_card and wall > PARALLEL_BUDGET_S:
        raise AssertionError(f"the parallel phase took {wall:.1f} s")
    return launches


# ------------------------------ wide lanes ------------------------------

# D4 beyond 8192 lanes: three k a thread a lane takes on 16 CTAs (8193 and
# 12288 fill them partly), 65536 and 100,000 (not a multiple of 32), whose
# lanes a thread keeps in memory: 4 and 7 a thread on 16 CTAs
WIDE_KS = (8193, 12288, 16384, 65536, 100000)
WIDE_STEPS = 12  # three chained segments of 4 steps
WIDE_CODEC_K = 16384  # the analytic codec on TCM-S's batch of 8: 48 steps a slice


def _lane_case(torch, seed, n, device):
    """(sigma float32, symbols int32) of n Gaussian symbols on ``device``:
    sigma log-uniform over [0.05, 300], symbols clamped to their support,
    and each in a bin of width zero moved one bin down (no encoder of the
    analytic scheme can code a symbol there)."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)
    sym = np.round(rng.normal(0.0, 1.3, n) * sigma).astype(np.int32)
    sigma, sym = torch.from_numpy(sigma).to(device), torch.from_numpy(sym).to(device)
    c = ar.support(sigma)
    sym = torch.minimum(torch.maximum(sym, -c), c).to(torch.int32)
    p = ar.coder_params(sigma)
    while True:
        zero = ar._start_freq(sym, p)[1] == 0
        if not bool(zero.any()):
            return sigma, sym
        sym = torch.where(zero, sym - 1, sym)


def phase_wide_lanes(torch, device, x8):
    """D4 at more lanes than 16 CTAs of 512 (``WIDE_KS``) on the card: per
    k, three chained segments of seeded Gaussian symbols through the
    wrapper's choice and every cluster size it offers (``_coder_case`` and
    ``_coder_splits``: values and carries equal to the plain version's, bit
    for bit, CUDA-event and profiler times, the bound); then TCM-S (the
    committed weights) through the analytic device codec at k=16384 on the
    batch ``x8`` of 768x512 images: the decode exact on the wrapper's
    cluster and again with each cluster size forced, a second encode
    writing the same container. Returns each k's device ms per launch on
    the wrapper's cluster."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar
    from reslic_tcm_tpu_torch.coding import device_kernels as dk

    t0 = time.perf_counter()
    on_card = device == "cuda"
    per_k = {}
    for k in WIDE_KS:
        sigma, sym = _lane_case(torch, SEED + k, k * WIDE_STEPS, device)
        ws = ar.plain_encode_gaussian_lanes(sym, sigma, k)
        header, flat, total, _ = ar.compact_grouped(*ws, sym.numel())
        flat = torch.cat([flat, flat.new_zeros(k)])
        carry0 = ar.decode_gaussian_grouped_init(header)
        parts = sigma.split(sigma.numel() // 3)

        def kern(cluster=None):
            x_, g = carry0[0].clone(), carry0[1].clone()
            out = [dk.decode_on_cluster(x_, g, flat, s_, k, cluster or dk.decode_cluster(k))
                   for s_ in parts]
            return torch.cat(out), x_, g

        def plain():
            carry, out = carry0, []
            for s_ in parts:
                carry, vals = ar.plain_decode_gaussian_lanes(carry, flat, s_, k)
                out.append(vals)
            return (torch.cat(out), *carry)

        label = f"k={k}, 3 segments of {WIDE_STEPS // 3} steps"
        case, got = _coder_case(torch, "gaussian_decode_lanes", label, kern, plain, on_card,
                                sym.numel() * 8 + int(total) * 4 + 3 * (k * 16 + 16),
                                _search_ops(torch, sigma), 3)
        if not torch.equal(got[0], sym):
            raise AssertionError(f"D4 {label}: decoded other symbols")
        if on_card:
            device_ms = _coder_splits(torch, "gaussian_decode_lanes", label,
                                      _d4_calls(dk, k, kern), got,
                                      _d4_key(dk, k, dk.decode_cluster(k)), 3)
            per_k[k] = None if device_ms is None else device_ms / 3
            log("d4_wide " + json.dumps({
                "k": k, "steps": WIDE_STEPS, "clusters": dk.decode_clusters(k),
                "chosen": list(_d4_key(dk, k, dk.decode_cluster(k))),
                "device_ms_per_launch": per_k[k],
                "device_us_per_step": None if per_k[k] is None
                else per_k[k] * 1e3 / (WIDE_STEPS // 3),
                "call_ms_per_3_launches": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"]}))

    codec = _load_codec(device)
    enc = codec.compress_device_analytic(x8, k=WIDE_CODEC_K)
    again = codec.compress_device_analytic(x8, k=WIDE_CODEC_K)
    if not np.array_equal(enc["packed"], again["packed"]):
        raise AssertionError("two encodes of one batch wrote other containers")
    n_slice = enc["y_hat"].numel() // codec.module.num_slices
    decode_ms = {}
    chosen, wrapper_choice = dk.decode_cluster(WIDE_CODEC_K), dk.decode_cluster
    for cluster in [None] + dk.decode_clusters(WIDE_CODEC_K):
        if cluster is not None:
            dk.decode_cluster = lambda k, c=cluster: c  # noqa: E731  (forced, then restored)
        try:
            dec, ms, _ = _timed(torch, device, lambda: codec.decompress_device_analytic(enc))
        finally:
            dk.decode_cluster = wrapper_choice
        decode_ms["wrapper" if cluster is None else str(cluster)] = ms
        if not torch.equal(dec["y_hat"], enc["y_hat"]):
            raise AssertionError(f"analytic codec k={WIDE_CODEC_K}, cluster {cluster}: the "
                                 f"decode did not reproduce y_hat")
    log("wide_codec " + json.dumps({
        "model": "TCM-S", "batch": len(x8), "hw": list(x8.shape[1:3]), "k": WIDE_CODEC_K,
        "steps_per_slice": n_slice // WIDE_CODEC_K, "clusters": dk.decode_clusters(WIDE_CODEC_K),
        "wrapper_cluster": chosen, "y_hat_exact_on_every_cluster": True,
        "same_container_twice": True, "bpp": enc["nbytes"] * 8 / (x8.shape[0] * x8.shape[1]
                                                                  * x8.shape[2]),
        "decode_ms": decode_ms}))
    log(f"wide lanes: phase wall {time.perf_counter() - t0:.1f} s")
    return per_k


# ---------------------------- sharded coders ----------------------------


def _same_streams(a, b) -> bool:
    """Two device-coder results (a dict with "packed" or "device_streams")
    or lists of host-coder dicts with equal streams."""
    if isinstance(a, list):
        return [e["strings"] for e in a] == [e["strings"] for e in b]
    if "packed" in a:
        return bool(np.array_equal(a["packed"], b["packed"]))
    return all(np.array_equal(u, v) for name in ("y", "z")
               for u, v in zip(a["device_streams"][name], b["device_streams"][name]))


def phase_sharded_coders(torch, device, batches):
    """The device-coder and pipelined paths after ``shard_for_inference`` in
    a world of one (NCCL on the card), TCM-S with the committed weights, on
    ``batches`` (two batches of two 768x512 images): compress_device /
    decompress_device and the analytic pair on the first batch,
    compress_pipelined, roundtrip_pipelined, serve_roundtrip_pipelined,
    serve_roundtrip_metrics and roundtrip_device_pipelined over both; every
    stream byte-identical to an unsharded codec's same call, every decode
    exact, ms of each side printed. Then ``parallel/dryrun.py``'s
    ``dryrun_multichip(1)``: its own rank process, one train step of its
    small TCM, a finite loss."""
    from reslic_tcm_tpu_torch.parallel import dryrun
    from reslic_tcm_tpu_torch.parallel.multihost import free_port, initialize_distributed

    t0 = time.perf_counter()
    one = _load_codec(device)
    served = _load_codec(device)
    x = batches[0]
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device)
    try:
        served.shard_for_inference()
        rows = []
        for name, call, check in (
                ("compress_device", lambda c: c.compress_device(x, k=DC_K),
                 lambda c, e: c.decompress_device(e)),
                ("compress_device_analytic", lambda c: c.compress_device_analytic(x, k=DC_K),
                 lambda c, e: c.decompress_device_analytic(e)),
                ("compress_pipelined", lambda c: c.compress_pipelined(batches), None),
                ("roundtrip_pipelined", lambda c: c.roundtrip_pipelined(batches), None),
                ("serve_roundtrip_pipelined",
                 lambda c: c.serve_roundtrip_pipelined(batches, k=SERVE_K), None),
                ("serve_roundtrip_metrics",
                 lambda c: c.serve_roundtrip_metrics(batches, k=SERVE_K), None),
                ("roundtrip_device_pipelined",
                 lambda c: c.roundtrip_device_pipelined(batches, k=DC_K), None)):
            want, ms_one = _run_plain(torch, lambda: call(one), device == "cuda")
            got, ms_sh = _run_plain(torch, lambda: call(served), device == "cuda")
            if name in ("compress_device", "compress_device_analytic"):
                same = _same_streams(got, want)
                exact = bool(torch.equal(check(served, got)["y_hat"], got["y_hat"]))
            elif name == "compress_pipelined":
                same, exact = _same_streams(got, want), True
            elif name == "roundtrip_pipelined":
                same = all(_same_streams(g["encs"], w["encs"]) for g, w in zip(got, want))
                exact = all(torch.equal(g["y_hat"], torch.cat([e["y_hat"] for e in g["encs"]]))
                            for g in got)
            else:
                same = all(_same_streams(g["enc"], w["enc"]) for g, w in zip(got, want))
                exact = all(torch.equal(g["y_hat"], g["enc"]["y_hat"]) for g in got)
            rows.append({"path": name, "streams_equal": same, "exact": exact,
                         "ms_sharded": ms_sh, "ms_unsharded": ms_one})
            log("sharded_coder " + json.dumps(rows[-1]))
            if not (same and exact):
                raise AssertionError(f"sharded {name}: streams or decodes differ from the "
                                     f"unsharded codec's")
    finally:
        torch.distributed.destroy_process_group()
    t1 = time.perf_counter()
    loss = dryrun.dryrun_multichip(1, device)
    log(f"dryrun_multichip(1) on {device}: loss {loss:.6f}, {time.perf_counter() - t1:.1f} s "
        f"with its rank process's start")
    log(f"sharded coders: phase wall {time.perf_counter() - t0:.1f} s")


# -------------------------------- train ---------------------------------

TRAIN_LAMBDA = 0.013


def _train_tcm_s(device, remat=True):
    """TCM-S from the committed weights, as the trainer builds it."""
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    module = make_tcm(N=64, M=320, device=device, remat=remat).module
    load_snapshot_into(module, SNAPSHOT)
    return module


def _train_tcm192(device, remat=True):
    from reslic_tcm_tpu_torch.models.tcm import make_tcm

    return make_tcm(N=192, M=320, device=device, seed=SEED, remat=remat).module


def _train_balle(device, remat=True):
    from reslic_tcm_tpu_torch.models.balle2018 import make_balle

    return make_balle("mean-scale", N=192, M=320, device=device, seed=SEED).module


def _train_wacnn_stanh(device, remat=True):
    """WACNN-STanH from the committed trained weights, as the trainer
    builds it for the snapshot's configuration."""
    from reslic_tcm_tpu_torch.models.stanh.variants import make_wacnn_stanh
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    module = make_wacnn_stanh(STANH_LEVELS, N=192, M=320, device=device, seed=SEED).module
    load_snapshot_into(module, STANH_SNAPSHOT)
    return module


def _train_scale_gain(device, remat=True):
    """The gained scale hyperprior from the committed trained weights."""
    return _make_scale_gain(device).module


# slice -> (the module as the trainer builds it, what it is, whether it has
# remat, the validation forward's launches)
TRAIN_SLICES = {
    "tcm": (_train_tcm_s, f"TCM-S N=64 M=320 from {SNAPSHOT}", True, _TCM_LAUNCHES["forward"]),
    "tcm192": (_train_tcm192, f"TCM N=192 M=320, random weights (seed {SEED})", True,
               _TCM_LAUNCHES["forward"]),
    "balle-mean-scale": (_train_balle, f"Balle-2018 mean-scale N=192 M=320, random weights "
                         f"(seed {SEED})", False, _NO_LAUNCHES["forward"]),
    "wacnn-stanh": (_train_wacnn_stanh, f"WACNN-STanH N=192 M=320 from {STANH_SNAPSHOT}, a "
                    f"random level per step (random.Random({SEED})) and its lambda, "
                    f"beta from configure_annealings (gap_stoc, beta 10, factor 25)", False,
                    PASS_LAUNCHES["wacnn"]["forward"]),
    "scale-gain": (_train_scale_gain, f"gained scale hyperprior N=192 M=320 from "
                   f"{GAIN_SNAPSHOT}, a random level per step (random.Random({SEED})) and its "
                   f"lambda", False, _NO_LAUNCHES["forward"]),
}
# each train slice's median ms per fp32 step (phase 5b), beside which phase
# 5h prints its bf16 step
TRAIN_MS = {}
# the train slices whose step takes a rate level: their lambdas, one per level
LEVEL_TRAIN = {"wacnn-stanh": STANH_LAMBDAS, "scale-gain": GAIN_LAMBDAS}
# those whose step also takes a STanH temperature
STANH_TRAIN = ("wacnn-stanh",)
# the hyperpriors, whose validation counts the latents that round the other
# way on the CPU
HYPERPRIOR_TRAIN = ("balle-mean-scale", "scale-gain")


def _crops(n, hw, seed):
    """n crops of hw from seeded synthetic 384x384 images (the trainer's
    random crop), as an NHWC float32 batch."""
    from reslic_tcm_tpu_torch.data.datasets import random_crop
    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    rng = np.random.default_rng(seed)
    images = [synth_image(np.random.default_rng(seed + i), 384, 384) for i in range(-(-n // 4))]
    return np.stack([random_crop(images[i // 4], hw, rng) for i in range(n)])


def _set_remat(module, on: bool) -> None:
    for m in module.modules():
        if hasattr(m, "remat"):
            m.remat = on


def _timed_step(torch, state, batch, seed, device, lmbda=TRAIN_LAMBDA, lv=None, beta=None,
                precision=None):
    """One train step through training/step.py at matmul ``precision``;
    (metrics as floats, host ms ending in a synchronise)."""
    from reslic_tcm_tpu_torch.training.step import step_noise, train_step

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    m = train_step(state, batch, lmbda, step_noise(seed, state.step, device), lv=lv, beta=beta,
                   matmul_precision=precision)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    m = {k: float(v) for k, v in m.items()}
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"train step {state.step}: non-finite metrics {m}")
    return m, ms


def phase_train(torch, device, slice_name, batch_size, hw, warmup, steps):
    """Training of a TRAIN_SLICES model through training/step.py (the step
    cli/train.py runs): warm-up and timed steps (with remat where the model
    has it, then one step without), the card's step against the CPU's from
    the same weights and noise, then validation (through the eval kernels
    where the model has them) against the CPU plain path at the updated
    weights. A LEVEL_TRAIN slice draws a level per step from a seeded
    random.Random and takes that level's lambda; a STanH slice also the
    beta of one gap_stoc annealing schedule, which each step's gap then
    advances. Their card vs CPU step runs at the last level (and the last
    beta); a STanH validation counts the symbols that round the other way
    on the CPU, a hyperprior's the latents. Returns the train state and
    the batch."""
    import random

    from reslic_tcm_tpu_torch.cli.train import to_device
    from reslic_tcm_tpu_torch.models.base import replayed_noise, uniform_noise
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.training.step import create_train_state, eval_step, train_step
    from reslic_tcm_tpu_torch.utils.helper import configure_annealings

    make, what, has_remat, validation_launches = TRAIN_SLICES[slice_name]
    stanh = slice_name in STANH_TRAIN
    level_lambdas = LEVEL_TRAIN.get(slice_name)
    levels = random.Random(SEED)
    annealing = configure_annealings({"annealing": "gap_stoc", "beta": 10, "gap_factor": 25})
    lmbda, lv, beta = TRAIN_LAMBDA, None, None
    on_card = device == "cuda"
    t0 = time.perf_counter()
    state = create_train_state(make(device))
    batch = to_device(_crops(batch_size, hw, SEED), device)
    log(f"train {slice_name}: {what} on {device}, remat {'on' if has_remat else 'n/a'}, lambda "
        f"{level_lambdas or TRAIN_LAMBDA}, batch {batch_size} x {hw[0]}x{hw[1]} "
        f"synthetic crops (seed {SEED}), "
        f"Adam lr 1e-4 / aux 1e-3, clip 1.0; set-up {time.perf_counter() - t0:.1f} s")
    log(f"train numerics (cli/train.py sets the same on the card): matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 {torch.backends.cudnn.allow_tf32}, "
        f"deterministic {torch.backends.cudnn.deterministic}, benchmark "
        f"{torch.backends.cudnn.benchmark}")

    reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for k in range(warmup + steps):
        if level_lambdas:
            lv = levels.randrange(len(level_lambdas))
            lmbda = level_lambdas[lv]
        if stanh:
            beta = float(annealing.beta)
        m, ms = _timed_step(torch, state, batch, SEED, device, lmbda, lv, beta)
        if stanh:
            annealing.step(gap=m["gap"], epoch=0, loss=m["loss"])
        if k >= warmup:
            times.append(ms)
        level = f"level {lv}, " if level_lambdas else ""
        if stanh:
            level += f"beta {beta:.4f}, gap {m['gap']:.6f}, "
        log(f"train {slice_name} step {state.step} ({'timed' if k >= warmup else 'warm-up'}): "
            f"{level}loss {m['loss']:.4f}, bpp {m['bpp_loss']:.4f}, mse {m['mse_loss']:.6f}, "
            f"aux {m['aux_loss']:.3f}, grad norm {m['grad_norm']:.3f}, {ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    med = float(np.median(times))
    TRAIN_MS[slice_name] = med
    log(f"train {slice_name} remat {'on' if has_remat else 'n/a'}: median {med:.1f} ms per step "
        f"(min {min(times):.1f}, max {max(times):.1f}, {len(times)} steps), "
        f"{batch_size * 1e3 / med:.2f} images/s, peak memory {peak:.2f} GiB")
    if has_remat:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _set_remat(state.module, False)
        m, ms = _timed_step(torch, state, batch, SEED, device, lmbda, lv, beta)
        _set_remat(state.module, True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        log(f"train {slice_name} remat off: step {state.step}: loss {m['loss']:.4f}, {ms:.1f} ms, "
            f"{batch_size * 1e3 / ms:.2f} images/s, peak memory {peak:.2f} GiB")
    launches = launch_counts()
    log(f"train {slice_name} launches (composed under autograd): {json.dumps(launches)}")
    if any(launches.values()):
        raise AssertionError(f"the train steps launched kernels: {launches}")

    # the card's step against the CPU's, from the same weights and noise
    if level_lambdas:
        lv = len(level_lambdas) - 1
        lmbda = level_lambdas[lv]
    if stanh:
        beta = float(annealing.beta)
    check_hw = (256, 256) if on_card else hw
    x = _crops(1, check_hw, SEED + 1)
    drawn = []
    cpu_noise = uniform_noise(torch.Generator().manual_seed(SEED))
    cpu_state = create_train_state(make("cpu"))
    want = train_step(cpu_state, to_device(x, "cpu"), lmbda,
                      lambda shape: drawn.append(cpu_noise(shape)) or drawn[-1], lv=lv,
                      beta=beta)
    dev_state = create_train_state(make(device))
    got = train_step(dev_state, to_device(x, device), lmbda,
                     replayed_noise([u.to(device) for u in drawn]), lv=lv, beta=beta)
    if stanh:
        log(f"train {slice_name} step {device} vs CPU at level {lv}, beta {beta:.4f}: gap "
            f"{float(got['gap']):.6f} vs {float(want['gap']):.6f}")
    for key, tol in (("loss", 1e-4), ("grad_norm", 1e-3)):
        a, b = float(got[key]), float(want[key])
        log(f"train {slice_name} step {device} vs CPU (1x{check_hw[0]}x{check_hw[1]}): {key} "
            f"{a:.6f} vs {b:.6f}, relative {abs(a - b) / abs(b):.2e} (limit {tol:.0e})")
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"train step {key} on {device} differs from the CPU's")

    # validation after the steps: the eval kernels at the updated weights
    val = to_device(_crops(2, check_hw, SEED + 2), device)
    module = state.module
    reset_launch_counts()
    with torch.no_grad():
        out = module(val)
    launches = launch_counts()
    losses = eval_step(module, val, TRAIN_LAMBDA)
    want_launches = {k: v if on_card else 0 for k, v in validation_launches.items()}
    log(f"validation {slice_name} forward (2x{check_hw[0]}x{check_hw[1]}): launches "
        f"{json.dumps(launches)}, loss {float(losses['loss']):.4f}, bpp "
        f"{float(losses['bpp_loss']):.4f}, PSNR {float(losses['psnr']):.3f} dB")
    if launches != want_launches:
        raise AssertionError(f"validation launches {launches}, expected {want_launches}")
    cpu = make("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    with torch.no_grad():
        ref = cpu(val.cpu())
        if slice_name in HYPERPRIOR_TRAIN:
            # x_hat against the CPU's g_s of the card's own y_hat: a y or z
            # that lands within an ulp of a rounding boundary may round the
            # other way on the other device, which moves x_hat by far more
            # than the limit; such flips are counted and held to 0.1%
            card = _hyperprior_latents(torch, module, val)
            _rounding_flips(torch, card, _hyperprior_latents(torch, cpu, val.cpu()),
                            f"validation {slice_name}")
            ref = dict(ref, x_hat=cpu.g_s(card[2].cpu()))
    # a STanH symbol within an ulp of a step may round the other way on the
    # CPU: counted, held to 0.1%; its neighbourhood in x_hat may then move
    # by more than the limit, so the 99th percentile of the error is held
    flips = (_stanh_flips(torch, module, out, cpu, ref, 0, f"validation {slice_name}")
             if stanh else 0)
    cpu_loss = float(eval_step(cpu, val.cpu(), TRAIN_LAMBDA)["loss"])
    diff = (out["x_hat"].cpu() - ref["x_hat"]).abs()
    err = float(diff.max()) if flips == 0 else float(diff.flatten().quantile(0.99))
    log(f"validation {slice_name} vs CPU plain path at the updated weights: x_hat "
        f"{'max abs err' if flips == 0 else '99th percentile of the error'} {err:.3e} (limit "
        f"1.000e-03), loss {float(losses['loss']):.4f} vs {cpu_loss:.4f}")
    if not (bool(torch.isfinite(out["x_hat"]).all()) and err <= 1e-3):
        raise AssertionError("validation forward disagrees with the CPU plain path")
    for key in ref["likelihoods"]:
        bits_a = float(-torch.log2(out["likelihoods"][key].cpu()).sum())
        bits_b = float(-torch.log2(ref["likelihoods"][key]).sum())
        log(f"validation {slice_name}: {key} bits card {bits_a:.2f} vs CPU {bits_b:.2f}")
        if not abs(bits_a - bits_b) <= 1e-3 * bits_b + 1.0 + 64.0 * flips:
            raise AssertionError(f"validation {key} rate disagrees with the CPU plain path")
    return state, batch


# ------------------------------- profile --------------------------------


# bf16 phase (5g): the slices it drives, each on phase 4's codec of that name
BF16_SLICES = {"bf16-tcm": "tcm", "bf16-tcm192": "tcm192"}
# the launches per pass are TCM's, every one a bf16 instance (B4 is not on its path)
BF16_PASS_LAUNCHES = {p: {k: n for k, n in ls.items() if k in BF16_KERNELS}
                      for p, ls in _TCM_LAUNCHES.items()}


def phase_bf16(torch, codecs: dict, device, hw):
    """Phase 5g (module docstring). Returns {slice: the bf16 instances'
    launches on its path}."""
    from reslic_tcm_tpu_torch.cli.eval import evaluate
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    bf16, on_card = torch.bfloat16, device == "cuda"
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    paths = {}
    for name, base in BF16_SLICES.items():
        codec = codecs[base]
        fp32 = evaluate(codec, images, real=False, log=lambda m: None)
        codec.set_matmul_precision("bfloat16")
        try:
            reset_launch_counts()
            est = evaluate(codec, images, real=False, log=lambda m: log("  " + m))
            real = evaluate(codec, images, real=True, log=lambda m: log("  " + m))
            if base == "tcm":
                batch = np.stack(images)
                enc = codec.compress_device(batch)
                dec = codec.decompress_device(enc)
                if not torch.equal(dec["y_hat"], enc["y_hat"]):
                    raise AssertionError(f"{name}: the table device coder's decode did not "
                                         f"reproduce the encoder's y_hat")
                log(f"{name}: table device coder, two images in one stream: {enc['nbytes']} "
                    f"bytes, y_hat exact")
            paths[name] = launch_counts(bf16)
            fp32_launches = launch_counts()
            for j, (f, e, r) in enumerate(zip(fp32["records"], est["records"], real["records"])):
                log(f"{name} image {j}: bf16 estimate {e['bpp']:.4f} bpp, PSNR {e['psnr']:.3f} "
                    f"dB, real {r['bpp']:.4f} bpp, PSNR {r['psnr']:.3f} dB; fp32 estimate "
                    f"{f['bpp']:.4f} bpp, PSNR {f['psnr']:.3f} dB; forward {e['forward_ms']:.1f} "
                    f"ms (fp32 {f['forward_ms']:.1f}), encode {r['encode_ms']:.1f} ms, decode "
                    f"{r['decode_ms']:.1f} ms")
                if not r["y_hat_exact"]:
                    raise AssertionError(f"{name} image {j}: decode did not reproduce the "
                                         f"encoder's y_hat")
                for pass_name, got in (("forward", e["launches_forward"]),
                                       ("compress", r["launches_compress"]),
                                       ("decompress", r["launches_decompress"])):
                    _check_launches(j, f"{name} {pass_name}", got,
                                    BF16_PASS_LAUNCHES[pass_name], on_card)
            if any(fp32_launches.values()):
                raise AssertionError(f"{name}: fp32 instances launched in bf16 mode: "
                                     f"{fp32_launches}")
            for kernel in BF16_KERNELS:
                if on_card and paths[name][kernel] == 0:
                    raise AssertionError(f"{kernel}'s bf16 instance was never launched on the "
                                         f"{name} path")
            log(f"main path {name}: bf16 launches {json.dumps(paths[name])}")
            if on_card:
                img = images[0][None]
                for mode in ("bfloat16", None):
                    codec.set_matmul_precision(mode)
                    codec.forward(img)
                    _profile_window(torch, f"{name} forward, matmul precision {mode}",
                                    lambda: codec.forward(img))
        finally:
            codec.set_matmul_precision(None)
    log(f"phase bf16: {time.perf_counter() - t0:.1f} s")
    return paths


def _bf16_launches(b1):
    return {_B1: b1, _B2: 0, _B3: 0}


# bf16 phase (5g), the other codecs: slice -> (phase 5's codec of that name,
# the rate level), driven through their own passes at that level
BF16_CODEC_SLICES = {"bf16-wacnn": ("wacnn", 0), "bf16-balle-mean-scale": ("balle-mean-scale", 0),
                     "bf16-scale-gain": ("scale-gain", 1), "bf16-wacnn-stanh": ("wacnn-stanh", 1)}
# their bf16 launches per pass: B1's attention-only bf16 instance on WACNN's
# path (B4 is not launched: the window-4 attention composes in bf16, as in
# the JAX package), nothing on the hyperpriors'
_WACNN_BF16 = {"forward": _bf16_launches(2), "compress": _bf16_launches(1),
               "decompress": _bf16_launches(1)}
BF16_CODEC_LAUNCHES = {
    "bf16-wacnn": _WACNN_BF16,
    "bf16-wacnn-stanh": {**_WACNN_BF16, "forward_codec_consistent": _bf16_launches(2)},
    "bf16-balle-mean-scale": {p: _bf16_launches(0) for p in _WACNN_BF16},
    "bf16-scale-gain": {p: _bf16_launches(0) for p in _WACNN_BF16},
}


def phase_bf16_codecs(torch, codecs: dict, device, hw):
    """Phase 5g's other codecs (module docstring): WACNN, the mean-scale
    hyperprior, the trained gained scale hyperprior and WACNN-STanH, each at
    its BF16_CODEC_SLICES level on phase 4's two images, in bf16 mode: the
    forward estimate, compress and decompress; exact y_hat, the decoded
    x_hat equal to the bf16 forward's clipped x_hat within 1e-5 (WACNN-STanH:
    forward_codec_consistent's, its codec's own forward), the bf16 launches
    per pass and no fp32 instance; bpp and PSNR beside the fp32 mode's.
    Returns {slice: the bf16 instances' launches on its path}."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.training.codec_eval import rate_kwargs
    from reslic_tcm_tpu_torch.utils.metrics import compute_psnr

    t0 = time.perf_counter()
    bf16, on_card = torch.bfloat16, device == "cuda"
    images = [synth_image(np.random.default_rng(SEED + i), *hw) for i in range(2)]
    px = hw[0] * hw[1]
    paths = {}
    for name, (base, lv) in BF16_CODEC_SLICES.items():
        codec = codecs[base]
        rate = rate_kwargs(codec, lv)
        consistent = getattr(codec, "forward_codec_consistent", None)
        want = BF16_CODEC_LAUNCHES[name]
        fp32 = []
        for img in images:
            out = codec.forward(img[None], lv)
            x = torch.as_tensor(img[None], device=out["x_hat"].device)
            fp32.append((_bits(torch, out["likelihoods"]) / px,
                         compute_psnr(x, torch.clamp(out["x_hat"], 0, 1))))
        codec.set_matmul_precision("bfloat16")
        try:
            reset_launch_counts()
            for j, img in enumerate(images):
                x = img[None]
                launches = {}
                fwd, fwd_ms, launches["forward"] = _timed(
                    torch, device, lambda: codec.forward(x, lv), bf16)
                ref = fwd
                if consistent is not None:
                    ref, _, launches["forward_codec_consistent"] = _timed(
                        torch, device, lambda: consistent(x, lv=lv), bf16)
                enc, enc_ms, launches["compress"] = _timed(
                    torch, device, lambda: codec.compress(x, **rate), bf16)
                dec, dec_ms, launches["decompress"] = _timed(
                    torch, device, lambda: codec.decompress(enc["strings"], enc["shape"], **rate),
                    bf16)
                for pass_name, got in launches.items():
                    _check_launches(j, f"{name} {pass_name}", got, want[pass_name], on_card)
                if not torch.equal(enc["y_hat"], dec["y_hat"]):
                    raise AssertionError(f"{name} image {j}: decode did not reproduce the "
                                         f"encoder's y_hat")
                err = float((dec["x_hat"] - torch.clamp(ref["x_hat"], 0, 1)).abs().max())
                xt = torch.as_tensor(x, device=dec["x_hat"].device)
                est = _bits(torch, fwd["likelihoods"]) / px
                est_psnr = compute_psnr(xt, torch.clamp(fwd["x_hat"], 0, 1))
                real, real_psnr = _nbytes(enc) * 8.0 / px, compute_psnr(xt, dec["x_hat"])
                log(f"{name} level {lv} image {j}: bf16 estimate {est:.4f} bpp, PSNR "
                    f"{est_psnr:.3f} dB, real {real:.4f} bpp, PSNR {real_psnr:.3f} dB; fp32 "
                    f"estimate {fp32[j][0]:.4f} bpp, PSNR {fp32[j][1]:.3f} dB; decoded x_hat vs "
                    f"the bf16 {'codec-consistent ' if consistent else ''}forward's max abs err "
                    f"{err:.3e}; forward {fwd_ms:.1f} ms, encode {enc_ms:.1f} ms, decode "
                    f"{dec_ms:.1f} ms, y_hat exact")
                if not err <= 1e-5:
                    raise AssertionError(f"{name} image {j}: decoded x_hat differs from the "
                                         f"bf16 forward's by {err:.3e}")
            paths[name] = launch_counts(bf16)
            fp32_launches = launch_counts()
            if any(fp32_launches.values()):
                raise AssertionError(f"{name}: fp32 instances launched in bf16 mode: "
                                     f"{fp32_launches}")
            for kernel, n in want["forward"].items():
                if on_card and n and paths[name][kernel] == 0:
                    raise AssertionError(f"{kernel}'s bf16 instance was never launched on the "
                                         f"{name} path")
            log(f"main path {name}: bf16 launches {json.dumps(paths[name])}, fp32 launches "
                f"{json.dumps(fp32_launches)}")
            if on_card:
                for mode in ("bfloat16", None):
                    codec.set_matmul_precision(mode)
                    codec.forward(images[0][None], lv)
                    _profile_window(torch, f"{name} forward, matmul precision {mode}",
                                    lambda: codec.forward(images[0][None], lv))
        finally:
            codec.set_matmul_precision(None)
    log(f"phase bf16 codecs: {time.perf_counter() - t0:.1f} s")
    return paths


def phase_train_bf16(torch, device, slice_name, batch_size, hw, warmup, steps):
    """Phase 5h (module docstring): TRAIN_SLICES' ``slice_name`` trained with
    the trainer's --bf16 precision through training/step.py: warm-up and
    timed steps (remat on where the model has it), ms per step and images/s
    beside phase 5b's fp32 step, peak memory, finite metrics, no kernel
    launched, parameters and Adam states fp32; on the card a profile of one
    more step."""
    from reslic_tcm_tpu_torch.cli.train import to_device
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.training.step import create_train_state

    make, what, _, _ = TRAIN_SLICES[slice_name]
    on_card = device == "cuda"
    t0 = time.perf_counter()
    state = create_train_state(make(device))
    batch = to_device(_crops(batch_size, hw, SEED), device)
    log(f"train bf16 {slice_name}: {what} on {device}, matmul precision bfloat16, batch "
        f"{batch_size} x {hw[0]}x{hw[1]}; cuDNN deterministic "
        f"{torch.backends.cudnn.deterministic}; set-up {time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for k in range(warmup + steps):
        m, ms = _timed_step(torch, state, batch, SEED, device, precision="bfloat16")
        if k >= warmup:
            times.append(ms)
        log(f"train bf16 {slice_name} step {state.step} ({'timed' if k >= warmup else 'warm-up'}"
            f"): loss {m['loss']:.4f}, bpp {m['bpp_loss']:.4f}, mse {m['mse_loss']:.6f}, aux "
            f"{m['aux_loss']:.3f}, grad norm {m['grad_norm']:.3f}, {ms:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    med = float(np.median(times))
    fp32 = TRAIN_MS.get(slice_name, float("nan"))
    log(f"train bf16 {slice_name}: median {med:.1f} ms per step (min {min(times):.1f}, max "
        f"{max(times):.1f}, {len(times)} steps), {batch_size * 1e3 / med:.2f} images/s, peak "
        f"memory {peak:.2f} GiB; fp32 (phase 5b) {fp32:.1f} ms per step, "
        f"{batch_size * 1e3 / fp32:.2f} images/s: {fp32 / med:.2f}x")
    launches = (launch_counts(), launch_counts(torch.bfloat16))
    if any(launches[0].values()) or any(launches[1].values()):
        raise AssertionError(f"the bf16 train steps launched kernels: {launches}")
    tensors = [*state.module.parameters(), *(v for opt in (state.optimizer, state.aux_optimizer)
                                             if opt is not None for st in opt.state.values()
                                             for key, v in st.items() if key != "step")]
    if any(t.dtype != torch.float32 for t in tensors):
        raise AssertionError("bf16 training left a parameter or an Adam state off fp32")
    if on_card:
        _profile_window(torch, f"train step bf16 ({slice_name}, {batch_size}x{hw[0]}x{hw[1]})",
                        lambda: _timed_step(torch, state, batch, SEED, device,
                                            precision="bfloat16"))
    log(f"phase train bf16: {time.perf_counter() - t0:.1f} s")


# --------------------------------- CLIs ---------------------------------

# phase 5i: the corpus writer's train images (512x512; two steps at batch 16)
# and the validation's test crops; the writer's 24 test images (512x768) are
# the "Kodak" stand-in and the eval CLI's data
CLI_TRAIN_IMAGES = 32
CLI_VAL_IMAGES = 8
CLI_TEST_IMAGES = 24  # generate_corpus's default n_test
# D1-D4's launches per image on the analytic device coder's path (PERF.md):
# D1 and D3 encode z and y, D2 decodes z, D4 the five y segments
CLI_CODER_LAUNCHES = {"encode_lanes": 1, "decode_lanes": 1, "gaussian_encode_lanes": 1,
                      "gaussian_decode_lanes": 5}
_REPO = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def _without_pillow(tmp):
    """Pillow made unimportable for the block, whether or not it is
    installed: in this process through sys.modules, in subprocesses through
    the environment it yields (a PIL package first on PYTHONPATH whose
    import raises)."""
    blocker = os.path.join(tmp, "no_pillow", "PIL")
    os.makedirs(blocker)
    with open(os.path.join(blocker, "__init__.py"), "w") as f:
        f.write('raise ImportError("Pillow is blocked for this run")\n')
    path = [os.path.dirname(blocker), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    saved = {name: sys.modules.get(name) for name in ("PIL", "PIL.Image")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield env
    finally:
        for name, module in saved.items():
            if module is None:
                del sys.modules[name]
            else:
                sys.modules[name] = module


def _run_cli(main, argv):
    """(exit code, standard output) of a CLI's ``main(argv)`` run in this
    process; the output's tail is printed when the run raises."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except BaseException:
        log("  ... " + buf.getvalue()[-4000:])
        raise
    return rc, buf.getvalue()


def _printed_averages(out: str) -> dict:
    """The eval CLI's printed average PSNR and bpp, as printed."""
    found = {}
    for line in out.splitlines():
        if line.startswith("average_PSNR: "):
            found["psnr"] = line.split()[1]
        elif line.startswith("average_Bit-rate: "):
            found["bpp"] = line.split()[1]
    if set(found) != {"psnr", "bpp"}:
        raise AssertionError(f"the eval CLI printed no averages:\n{out[-2000:]}")
    return found


def _as_printed(summary: dict) -> dict:
    return {"psnr": f"{summary['psnr']:.2f}dB", "bpp": f"{summary['bpp']:.3f}"}


def phase_cli(torch, device, rehearsal=False):
    """Phase 5i (module docstring): the corpus writer, the train CLI and the
    eval CLI as a user runs them. Returns the launches of B1-B3 (fp32: the
    train CLI's validation and the host and device-coder eval runs; bf16: the
    --bf16 eval run) and D1-D4's (the device-coder run)."""
    import importlib.util
    import tempfile

    from reslic_tcm_tpu_torch.cli import eval as peval
    from reslic_tcm_tpu_torch.cli import train as ptrain
    from reslic_tcm_tpu_torch.cli.eval import evaluate
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.data.datasets import list_images, read_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from reslic_tcm_tpu_torch.utils.checkpoint import load_checkpoint
    from reslic_tcm_tpu_torch.utils.profiling import throughput_mp_s, timed

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    installed = importlib.util.find_spec("PIL") is not None
    platform = [] if on_card else ["--platform", "cpu"]
    with (tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp,
          _without_pillow(tmp) as env):
        blocked = subprocess.run([sys.executable, "-c", "import PIL"], env=env,
                                 capture_output=True).returncode != 0
        if not blocked or importlib.util.find_spec("PIL") is not None:
            raise AssertionError("Pillow could not be blocked")
        log(f"cli: Pillow installed: {installed}; blocked for the phase, in this process and "
            f"its subprocesses")
        corpus = os.path.join(tmp, "corpus")
        # 1. the corpus, as a user writes it (the rehearsal writes a small
        # one in this process: the module's command writes 24 images of
        # 512x768, too many for the CPU)
        t0 = time.perf_counter()
        if rehearsal:
            from reslic_tcm_tpu_torch.data.synthetic import generate_corpus

            n_train, n_val, n_test = 4, 2, 2
            generate_corpus(corpus, n_train=n_train, n_test=n_test, train_size=(256, 256),
                            test_size=(256, 256))
        else:
            n_train, n_val, n_test = CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_TEST_IMAGES
            subprocess.run([sys.executable, "-m", "reslic_tcm_tpu_torch.data.synthetic", corpus,
                            str(n_train)], cwd=_REPO, env=env, check=True, timeout=300,
                           stdout=subprocess.DEVNULL)
        test_dir = os.path.join(corpus, "test", "data")
        counts = [len(list_images(os.path.join(corpus, s, "data"))) for s in ("train", "test")]
        if counts != [n_train, n_test]:
            raise AssertionError(f"the corpus writer wrote {counts} images, not "
                                 f"{[n_train, n_test]}")
        log(f"cli corpus: {n_train} train and {n_test} test images in "
            f"{time.perf_counter() - t0:.1f} s")

        # 2. the train CLI: TCM-S from the committed weights, one epoch
        batch = 2 if rehearsal else 16
        argv = ["-m", "tcm", "--N", "64", "--M", "320", "-d", corpus, "--checkpoint", SNAPSHOT,
                "--lambda_list", "0.013", "-e", "1", "--num_images", str(n_train),
                "--num_images_val", str(n_val), "--batch-size", str(batch),
                "--save_path", os.path.join(tmp, "runs"), "--kodak", test_dir, *platform]
        if rehearsal:
            argv += ["--patch-size", "128", "128", "--test-batch-size", "2"]
        reset_launch_counts()
        times = {}
        with timed("train CLI", times):
            rc, out = _run_cli(ptrain.main, argv)
        train_launches = launch_counts()
        if rc != 0:
            raise AssertionError(f"the train CLI exited {rc}")
        losses = [float(line.split("Loss:")[1].split("|")[0]) for line in out.splitlines()
                  if "Loss:" in line]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"the train CLI's losses: {losses}")
        ckpts = {f for _, _, fs in os.walk(os.path.join(tmp, "runs")) for f in fs}
        very_best = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(tmp, "runs"))
                     for f in fs if f == "_very_best.ckpt"]
        if len(very_best) != 1 or not any("best" in f and f != "_very_best.ckpt"
                                          for f in ckpts):
            raise AssertionError(f"the train CLI saved {sorted(ckpts)}")
        # validation: one forward a batch of test crops, one a "Kodak" image;
        # no kernel in the train steps (composed under autograd)
        forwards = -(-n_val // (2 if rehearsal else 8)) + n_test
        want = {k: forwards * n for k, n in _TCM_LAUNCHES["forward"].items()}
        _check_launches(0, "train CLI validation", train_launches, want, on_card)
        log(f"cli train: {len(losses)} losses {losses} finite; {times['train CLI']:.1f} s; "
            f"validation launches {json.dumps(train_launches)} ({forwards} forwards); "
            f"saved {sorted(ckpts)}")

        # 3. the eval CLI on the checkpoint just saved, in three modes
        images = [read_image(p) for p in list_images(test_dir)]
        pixels = sum(img.shape[0] * img.shape[1] for img in images)
        fp32, bf16 = {k: 0 for k in _TCM_LAUNCHES["forward"]}, None
        coder = {k: 0 for k in CLI_CODER_LAUNCHES}
        per_mode = {}
        for mode, extra in (("host", []), ("device", ["--device-coder"]), ("bf16", ["--bf16"])):
            dtype = torch.bfloat16 if mode == "bf16" else torch.float32
            argv = ["--data", test_dir, "--checkpoint", very_best[0], "--N", "64", "--M", "320",
                    "--real", *extra, *platform]
            summaries = []

            def recording(*args, **kw):
                summaries.append(evaluate(*args, **kw))
                return summaries[-1]

            reset_launch_counts()
            dk.reset_launch_counts()
            peval.evaluate = recording  # the CLI's loop, its records kept
            try:
                t0 = time.perf_counter()
                rc, out = _run_cli(peval.main, argv)
                wall = time.perf_counter() - t0
            finally:
                peval.evaluate = evaluate
            launches = {"fp32": launch_counts(), "bf16": launch_counts(torch.bfloat16),
                        "coder": dk.launch_counts()}
            if rc != 0 or len(summaries) != 1:
                raise AssertionError(f"eval CLI {mode}: exit {rc}, {len(summaries)} evaluations")
            records = summaries[0]["records"]
            if len(records) != n_test or not all(r["y_hat_exact"] for r in records):
                raise AssertionError(f"eval CLI {mode}: y_hat exact on "
                                     f"{sum(r['y_hat_exact'] for r in records)} of {n_test}")
            for j, r in enumerate(records):
                for name in ("compress", "decompress"):
                    want = {k: v for k, v in _TCM_LAUNCHES[name].items()
                            if k in r[f"launches_{name}"]}
                    _check_launches(j, f"eval CLI {mode} {name}", r[f"launches_{name}"], want,
                                    on_card)
            idle = "fp32" if mode == "bf16" else "bf16"
            if any(launches[idle].values()):
                raise AssertionError(f"eval CLI {mode}: {idle} instances launched "
                                     f"{launches[idle]}")
            want = {k: n_test * n if mode == "device" else 0 for k, n in CLI_CODER_LAUNCHES.items()}
            _check_launches(0, f"eval CLI {mode} coder", launches["coder"], want, on_card)

            # the same files through evaluate() on a codec that loaded the
            # same checkpoint, at the same precision and coder
            codec = make_tcm(N=64, M=320, device=device)
            if mode == "bf16":
                codec.set_matmul_precision("bfloat16")
            codec.module.load_state_dict(load_checkpoint(very_best[0])["state_dict"], strict=True)
            codec.update()
            ref = evaluate(codec, images, real=True, log=lambda *_: None,
                                 device_coder=mode == "device")
            del codec
            printed = _printed_averages(out)
            if printed != _as_printed(ref):
                raise AssertionError(f"eval CLI {mode}: printed {printed}, evaluate() "
                                     f"{_as_printed(ref)}")
            enc = sum(r["encode_ms"] for r in records)
            dec = sum(r["decode_ms"] for r in records)
            per_mode[mode] = summaries[0]
            if mode == "bf16":
                bf16 = launches["bf16"]
            else:
                fp32 = {k: fp32[k] + launches["fp32"][k] for k in fp32}
            if mode == "device":
                coder = launches["coder"]
            log("cli_eval " + json.dumps({
                "mode": mode, "images": n_test, "wall_s": wall, "bpp": summaries[0]["bpp"],
                "psnr": summaries[0]["psnr"], "ms_ssim_db": summaries[0]["ms_ssim_db"],
                "encode_ms": enc / n_test, "decode_ms": dec / n_test,
                "mp_s": throughput_mp_s(pixels, (enc + dec) / 1e3),
                "printed": printed, "launches": launches[
                    "bf16" if mode == "bf16" else "fp32"],
                "coder_launches": launches["coder"],
                "bpp_gap_to_host": (summaries[0]["bpp"] / per_mode["host"]["bpp"] - 1
                                    if mode == "device" else None)}))

        # 4. the host-coder run once more as a user starts it
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "reslic_tcm_tpu_torch.cli.eval", "--data",
                              test_dir, "--checkpoint", very_best[0], "--N", "64", "--M", "320",
                              "--real", *platform], cwd=_REPO, env=env, capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"python -m reslic_tcm_tpu_torch.cli.eval exited "
                                 f"{run.returncode}:\n{run.stderr[-3000:]}")
        printed = _printed_averages(run.stdout)
        if printed != _as_printed(per_mode["host"]):
            raise AssertionError(f"python -m ...cli.eval printed {printed}, the host run "
                                 f"{_as_printed(per_mode['host'])}")
        log(f"cli eval as a command: {printed} in {time.perf_counter() - t0:.1f} s")
    fp32 = {k: fp32[k] + train_launches[k] for k in fp32}
    log(f"cli: phase wall {time.perf_counter() - t_phase:.1f} s")
    return fp32, bf16, coder


def phase_profile(torch, codecs: dict):
    """torch.profiler over one warm 768x512 forward, compress and decompress
    of each slice's codec: the device's busy time and idle share of the
    window (host clock, ending in a synchronise), and the kernels that take
    the most device time."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    img = synth_image(np.random.default_rng(SEED), *IMAGE_HW)[None]
    for slice_name, codec in codecs.items():
        enc = codec.compress(img)
        passes = {"forward": lambda: codec.forward(img),
                  "compress": lambda: codec.compress(img),
                  "decompress": lambda: codec.decompress(enc["strings"], enc["shape"])}
        for pass_name, fn in passes.items():
            fn()
            _profile_window(torch, f"{slice_name} {pass_name}", fn)


def _profile_window(torch, label: str, fn, watch=()) -> None:
    """torch.profiler over one call of fn: the window (host clock, ending in
    a synchronise), the device's busy time and idle share, the top kernels,
    and the device time and launches of each kernel named in ``watch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile {label}: the profiler recorded no device kernels; busy time and idle "
            f"share not measured")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile {label}: window {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall:.3f}, {len(kernels)} kernel names")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")
    for symbol in watch:
        hits = [e for e in kernels if symbol in e.key]
        log(f"  {symbol}: {sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms device, "
            f"{sum(e.count for e in hits)} launches")


# --------------------------------- main ---------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the slices (256x256), the train phases (batch 2 of "
                         "128x128) and the CLI phase (a corpus of 256x256 images) on the CPU "
                         "through the plain versions; never prints the ok line")
    args = ap.parse_args()
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    t0 = time.perf_counter()
    import torch

    if args.cpu_rehearsal:
        torch.set_num_threads(min(4, os.cpu_count() or 1))
        launches, codecs = {}, {}
        for slice_name in SLICES:
            codecs[slice_name], launches[slice_name] = phase_slice(torch, "cpu", (256, 256),
                                                                   slice_name)
        launches.update(phase_bf16(torch, codecs, "cpu", (256, 256)))
        for slice_name in AC_SLICES:
            codecs[slice_name], launches[slice_name] = phase_ac_slice(torch, "cpu", (256, 256),
                                                                      slice_name)
        for slice_name, (phase, _) in {**STANH_SLICES, **GAIN_SLICES}.items():
            codecs[slice_name], launches[slice_name] = phase(torch, "cpu", (256, 256))
        launches.update(phase_bf16_codecs(torch, codecs, "cpu", (256, 256)))
        del codecs
        _, pipe_batches, launches["pipelined"] = phase_pipelined(torch, "cpu", (256, 256), 2, 2,
                                                                 1)
        _, launches["device-coder"], coder_launches, _ = phase_device_coder(
            torch, "cpu", (256, 256), pipe_batches, repeats=1)
        launches["tiled"] = phase_parallel(torch, "cpu", pipe_batches[0], (640, 512), 256, 4,
                                           train_batch=2, train_hw=(128, 128))
        phase_wide_lanes(torch, "cpu", pipe_batches[0])
        phase_sharded_coders(torch, "cpu", [pipe_batches[0][:1], pipe_batches[0][1:]])
        for slice_name in TRAIN_SLICES:
            phase_train(torch, "cpu", slice_name, 2, (128, 128), 1, 2)
        phase_train_bf16(torch, "cpu", "tcm192", 2, (128, 128), 1, 2)
        launches["cli"], launches["cli-bf16"], cli_coder = phase_cli(torch, "cpu", rehearsal=True)
        coder_launches = {k: n + cli_coder[k] for k, n in coder_launches.items()}
        log("kernels " + json.dumps({"launches": launches}))
        log("coder_kernels " + json.dumps({"launches": coder_launches}))
        log(f"rehearsal done in {time.perf_counter() - t0:.1f} s (no ok line: no card)")
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card", file=sys.stderr)
        return 2
    import reslic_tcm_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    lap = _stopwatch()
    card, smi = phase_device(torch)
    phase_build()
    lap("device and build")
    per_kernel = phase_kernels(torch)
    lap("phase 3 kernels")
    phase_splits(torch)
    lap("phase 3 splits")
    per_kernel_bf16 = phase_kernels_bf16(torch)
    lap("phase 3 bf16 rows")

    paths, codecs = {}, {}
    for slice_name, (make, _) in SLICES.items():
        codecs[slice_name], paths[slice_name] = phase_slice(torch, "cuda", IMAGE_HW, slice_name)
        phase_reference(torch, codecs[slice_name], make)
    for slice_name, (make, _) in AC_SLICES.items():
        codecs[slice_name], paths[slice_name] = phase_ac_slice(torch, "cuda", IMAGE_HW,
                                                               slice_name)
        phase_reference(torch, codecs[slice_name], make)
    for slice_name, (phase, make) in STANH_SLICES.items():
        codecs[slice_name], paths[slice_name] = phase(torch, "cuda", IMAGE_HW)
        if make is not None:
            phase_stanh_reference(torch, codecs[slice_name], make, lv=1)
    for slice_name, (phase, make) in GAIN_SLICES.items():
        codecs[slice_name], paths[slice_name] = phase(torch, "cuda", IMAGE_HW)
        if make is not None:
            phase_gain_reference(torch, codecs[slice_name], make, lv=1)
    lap("phases 4-5c slices")
    del codecs["scale-gain-sc"]  # its passes take a quality map: not profiled
    pipe_codec, pipe_batches, paths["pipelined"] = phase_pipelined(torch, "cuda", IMAGE_HW)
    lap("phase 5d pipelined")
    _, paths["device-coder"], coder_launches, coder_per_image = phase_device_coder(
        torch, "cuda", IMAGE_HW, pipe_batches)
    lap("phase 5e device coder")
    paths["tiled"] = phase_parallel(torch, "cuda", pipe_batches[0])
    lap("phase 5f parallel")
    phase_wide_lanes(torch, "cuda", pipe_batches[0])
    lap("phase 5j wide lanes")
    phase_sharded_coders(torch, "cuda", [pipe_batches[0][:2], pipe_batches[0][2:4]])
    lap("phase 5k sharded coders")
    bf16_paths = phase_bf16(torch, codecs, "cuda", IMAGE_HW)
    bf16_paths.update(phase_bf16_codecs(torch, codecs, "cuda", IMAGE_HW))
    lap("phase 5g bf16")
    torch.cuda.synchronize()
    for path, launches in paths.items():
        log(f"main path {path}: launches {json.dumps(launches)}")
        for kernel in PATH_KERNELS[path]:
            if launches[kernel] == 0:
                raise AssertionError(f"{kernel} was never launched on the {path} path")
    trained = {
        "tcm": phase_train(torch, "cuda", "tcm", 16, (256, 256), 3, 10),
        "tcm192": phase_train(torch, "cuda", "tcm192", 2, (256, 256), 1, 3),
        "balle-mean-scale": phase_train(torch, "cuda", "balle-mean-scale", 16, (256, 256), 3, 10),
        "wacnn-stanh": phase_train(torch, "cuda", "wacnn-stanh", 16, (256, 256), 3, 10),
        "scale-gain": phase_train(torch, "cuda", "scale-gain", 16, (256, 256), 3, 10),
    }
    lap("phase 5b train")
    paths["cli"], bf16_paths["cli-bf16"], cli_coder = phase_cli(torch, "cuda")
    coder_launches = {k: n + cli_coder[k] for k, n in coder_launches.items()}
    lap("phase 5i CLIs")
    phase_train_bf16(torch, "cuda", "tcm192", 2, (256, 256), 1, 3)
    lap("phase 5h train bf16")
    phase_profile(torch, codecs)
    def serial_roundtrip():
        for x in pipe_batches:
            encs = pipe_codec.compress_batch(x)
            pipe_codec.decompress_batch([e["strings"] for e in encs], encs[0]["shape"])

    for label, fn in (("serial compress_batch + decompress_batch", serial_roundtrip),
                      ("compress_pipelined", lambda: pipe_codec.compress_pipelined(pipe_batches)),
                      ("roundtrip_pipelined",
                       lambda: pipe_codec.roundtrip_pipelined(pipe_batches))):
        _profile_window(torch, f"pipelined {label} ({len(pipe_batches)} x {PIPE_BATCH} x "
                        f"{IMAGE_HW[0]}x{IMAGE_HW[1]})", fn)
    for slice_name, (train_state, train_batch) in trained.items():
        b, _, h, w = train_batch.shape
        _profile_window(torch, f"train step ({slice_name}, {b}x{h}x{w})",
                        lambda: _timed_step(torch, train_state, train_batch, SEED, "cuda"))

    lap("phase 6 profile")
    kernels = []
    for kernel, k in per_kernel.items():
        src, tpu = KERNEL_SOURCES[kernel]
        n = sum(launches[kernel] for launches in paths.values())
        kernels.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": tpu,
            "launches": n, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": max(k["t_ops"], k["t_bytes"]),
            "bound_by": "operations" if k["t_ops"] >= k["t_bytes"] else "bytes",
            "library_ms": k["library_ms"] if kernel in LIBRARY_KERNELS else None,
        })
        log(f"kernel {kernel}: {n} launches on the main paths, max abs err "
            f"{k['max_abs_err']:.2e}, {k['ms'] * 1e3:.0f} us per forward pass "
            f"(plain {k['plain_ms'] * 1e3:.0f} us, bound {max(k['t_ops'], k['t_bytes']) * 1e3:.0f} us)")
    for kernel, k in per_kernel_bf16.items():
        base, src, counted = BF16_ROWS[kernel]
        n = sum(launches[base] for name, launches in bf16_paths.items()
                if counted is None or name in counted)
        kernels.append({
            "name": kernel, "route": "cuda", "source": src,
            "replaces": KERNEL_SOURCES[base][1], "launches": n, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": max(k["t_ops"], k["t_bytes"]),
            "bound_by": "operations" if k["t_ops"] >= k["t_bytes"] else "bytes",
            "library_ms": k["library_ms"] if kernel == _B1_ATTN_BF16 else None,
            # null where the profiler lost a case's records (not measured)
            "device_ms": None if np.isnan(k["device_ms"]) else k["device_ms"],
            "fp32_device_ms": None if np.isnan(k["fp32_device_ms"]) else k["fp32_device_ms"],
        })
        log(f"kernel {kernel}: {n} launches on the bf16 paths, max abs err "
            f"{k['max_abs_err']:.2e}, device {k['device_ms'] * 1e3:.0f} us per forward pass "
            f"(fp32 instance {k['fp32_device_ms'] * 1e3:.0f} us, plain {k['plain_ms'] * 1e3:.0f} "
            f"us, bound {max(k['t_ops'], k['t_bytes']) * 1e3:.0f} us)")
    log("bf16 rows (*_bf16): launches: the bf16 phase's runs (two images, all passes: B1 "
        "LN+MLP, B2, B3 on TCM-S, with its device-coder pair, and TCM N=192) and the eval "
        "CLI's --bf16 run (phase 5i, TCM-S, 24 images, compress and decompress; B1 "
        "attention-only on WACNN and WACNN-STanH at level 1, with forward_codec_consistent); "
        "ms, plain_ms, device_ms, fp32_device_ms and bound_ms: the launches of one 768x512 "
        "forward pass of TCM-S, TCM N=128 and TCM N=192 (B1 LN+MLP, B2, B3) or of WACNN "
        "N=192 (B1 attention-only) at their main-path shapes, with prepared weights; "
        "bound_ms against the bf16 tensor-core peak, weights counted in bf16; library_ms: "
        "B1 attention-only: one F.multi_head_attention_forward call in bf16 a launch "
        "(partition, roll and residual outside it), null for the others: no single PyTorch "
        "call computes them")
    log("launches: the slices' main-path runs (two images each, all three passes, every "
        "level or point of the variable-rate slices), the pipelined phase's serial run, the "
        "device-coder path's runs, the parallel phase's tiled pass (B1-B3) and the CLIs' "
        "phase (B1-B3: the train CLI's validation and the eval CLI's host and device-coder "
        "runs); "
        "ms, plain_ms, library_ms and bound_ms: the kernel's launches in one 768x512 forward "
        "pass of TCM-S plus one of TCM N=128, one of TCM N=192 and one of WACNN, at their "
        "main-path shapes (kernel_per_pass lines: each slice's share); "
        "library_ms: one F.multi_head_attention_forward call per B4 launch; null for B1-B3: "
        "no single PyTorch call computes them (the kernel_case lines time that call for B1's "
        "attention-only flavour, with partition, roll and residual outside it)")
    log(json.dumps({"kernels": kernels}))
    from reslic_tcm_tpu_torch.coding.device_kernels import REPLACES

    coder_kernels = []
    for kernel, rec in coder_per_image.items():
        coder_kernels.append({
            "name": kernel, "route": "cuda", "source": CODER_SOURCE, "replaces": REPLACES[kernel],
            "launches": coder_launches[kernel], "max_abs_err": 0.0, "ms": rec["ms"],
            "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["t_ops"] + rec["t_bytes"],
            "bound_by": "operations" if rec["t_ops"] > rec["t_bytes"] else "bytes",
            "library_ms": None, "launches_per_image": rec["launches_per_image"]})
    log("coder kernels (replace lax.scan programs, not Pallas kernels): launches: the "
        "device-coder path's runs (two images, both profiles, each run "
        f"{DC_REPEATS} times) and the eval CLI's --device-coder run (24 images); ms, plain_ms and bound_ms: one 768x512 image's launches "
        "(D1: its y and z encode, D2: its z and five y segments, D3: one, D4: five y "
        "segments); device_ms: the profiler's time of each at its wrapper's variant (`split` "
        "lines; null: not measured); max_abs_err 0: the kernels equal their plain versions bit for bit; "
        "library_ms null: no PyTorch call codes rANS")
    log("coder_kernels " + json.dumps({"coder_kernels": coder_kernels}))
    log(f"card: {smi}")
    log(f"wall: {time.perf_counter() - t0:.1f} s")
    faulthandler.cancel_dump_traceback_later()
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
