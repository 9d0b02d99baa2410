"""Ablation timings of the bf16 kernels B1 (LN+MLP) and B2/B3's conv at the
main path's 768x512 shapes, cuDNN's bf16 conv as a yardstick, and a probe of
csrc/hopper_wgmma.cuh's conventions (descriptors, the fragment layout, bulk
copies), on the card:

    python3 tools/bf16_redesign/ablate.py [SRC_DIR]

SRC_DIR (default: the package's csrc/) holds the kernel sources to ablate;
the ablations (products off, W staging off, the MLP or attention off, A's
loads off, the GDN launch off) are made by patching copies of them under
runs/bf16_ablate/ (the sources themselves have no such switch). The patches
match the first versions of the two .cu files (the parent of the redesign:
`git archive <parent> reslic_tcm_tpu_torch/csrc`). Prints `step0` and
`probe` JSON lines."""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.getcwd()
sys.path.insert(0, ROOT)
HERE = os.path.dirname(os.path.abspath(__file__))
ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
SRC = os.path.abspath(ARGS[0]) if ARGS else os.path.join(ROOT, "reslic_tcm_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "runs", "bf16_ablate")
OUT = os.path.join(WORK, "build")
os.makedirs(OUT, exist_ok=True)
NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def log(*a):
    print(*a, flush=True)


def patched_copy(dst):
    os.makedirs(dst, exist_ok=True)
    for f in ("bf16_mma.cuh", "window_attn_common.cuh", "flash_window_attn_bf16.cu",
              "fused_conv_bf16.cu"):
        shutil.copy(os.path.join(SRC, f), dst)
    p = os.path.join(dst, "bf16_mma.cuh")
    s = open(p).read()
    # products off: the fragments still load, the tensor cores idle
    no_mma = ("#ifdef ABL_NO_MMA\n"
              "  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]) * 0.f;\n"
              "  return;\n#endif\n")
    s = s.replace("const uint32_t (&b)[2]) {\n  asm volatile(\n      \"mma.sync",
                  "const uint32_t (&b)[2]) {\n" + no_mma + "  asm volatile(\n      \"mma.sync", 1)
    head = "__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src) {\n"
    s = s.replace(head, head + "#ifdef ABL_NO_CPASYNC\n  return;\n#endif\n", 1)
    assert s.count("ABL_") == 2, "bf16_mma patch"
    open(p, "w").write(s)
    p = os.path.join(dst, "fused_conv_bf16.cu")
    s = open(p).read()
    pre = ("#ifdef ABL_NO_A\n#define ABL_NOA 1\n#else\n#define ABL_NOA 0\n#endif\n"
           "#ifdef ABL_NO_GDN\n#define ABL_SKIP_GDN 1\n#else\n#define ABL_SKIP_GDN 0\n#endif\n")
    s = s.replace('#include "bf16_mma.cuh"\n', '#include "bf16_mma.cuh"\n' + pre, 1)
    n0 = s.count("((amask[i] >> tap) & 1u)")
    s = s.replace("((amask[i] >> tap) & 1u)", "(!ABL_NOA && ((amask[i] >> tap) & 1u))")
    s = s.replace("  if (e != cudaSuccess) return e;\n  return launch_gemm<C, kGdn",
                  "  if (e != cudaSuccess || ABL_SKIP_GDN) return e;\n  return launch_gemm<C, kGdn", 1)
    assert n0 == 1 and "ABL_SKIP_GDN) return" in s, "conv patch"
    open(p, "w").write(s)
    p = os.path.join(dst, "flash_window_attn_bf16.cu")
    s = open(p).read()
    pre = ("#ifdef ABL_NO_MLP\n#define ABL_MLP 0\n#else\n#define ABL_MLP 1\n#endif\n"
           "#ifdef ABL_NO_ATT\n#define ABL_ATT 0\n#else\n#define ABL_ATT 1\n#endif\n")
    s = s.replace('#include "window_attn_common.cuh"\n', '#include "window_attn_common.cuh"\n' + pre, 1)
    s = s.replace("for (int s = 0; s < 4 * C / kStep; ++s) {",
                  "for (int s = 0; s < ABL_MLP * 4 * C / kStep; ++s) {", 1)
    s = s.replace("task < 4 * G::HK; task += kWarps)", "task < ABL_ATT * 4 * G::HK; task += kWarps)")
    s = re.sub(r"#define SWIN_BF16_INSTANCES\(X\)[^\n]*\n(?:[^\n]*\\\n)*[^\n]*\n",
               "#define SWIN_BF16_INSTANCES(X) X(64, 8, 1) X(64, 16, 1) X(64, 32, 1) X(128, 8, 1) "
               "X(128, 16, 1) X(128, 16, 8) X(128, 32, 1) X(192, 8, 2) X(192, 16, 2) X(192, 32, 2)\n",
               s, count=1)
    s = re.sub(r"#define ATTN_BF16_INSTANCES\(X\) \\\n[^\n]*\n",
               "#define ATTN_BF16_INSTANCES(X) X(192, 24, 1)\n", s, count=1)
    assert "ABL_MLP * 4" in s and s.count("ABL_ATT * 4") == 2 and "X(192, 32, 2)\n" in s
    open(p, "w").write(s)


def patched_copy_new(dst):
    """The same switches in copies of the redesigned sources (wgmma, the copy
    engine's W ring, the resident halo)."""
    os.makedirs(dst, exist_ok=True)
    for f in ("bf16_mma.cuh", "hopper_wgmma.cuh", "window_attn_common.cuh",
              "flash_window_attn_bf16.cu", "fused_conv_bf16.cu"):
        shutil.copy(os.path.join(SRC, f), dst)
    flags = ("#ifdef ABL_NO_MMA\n#define ABL_MMA 0\n#else\n#define ABL_MMA 1\n#endif\n"
             "#ifdef ABL_NO_FILL\n#define ABL_FILL 0\n#else\n#define ABL_FILL 1\n#endif\n"
             "#ifdef ABL_NO_ATT\n#define ABL_ATT 0\n#else\n#define ABL_ATT 1\n#endif\n")
    p = os.path.join(dst, "fused_conv_bf16.cu")
    s = open(p).read()
    s = s.replace('#include "hopper_wgmma.cuh"\n', '#include "hopper_wgmma.cuh"\n' + flags, 1)
    s = s.replace("        mbar_expect_tx(&full[s], G::STAGE_BYTES);\n",
                  "#ifdef ABL_NO_WCOPY\n        mbar_arrive(&full[s]);\n        continue;\n#endif\n"
                  "        mbar_expect_tx(&full[s], G::STAGE_BYTES);\n", 1)
    s = s.replace("#pragma unroll\n        for (int i = 0; i < G::KC / 8; ++i)\n          bulk_copy(",
                  "#ifdef ABL_ONECOPY\n        bulk_copy(ring + s * G::STAGE_BYTES, src, G::STAGE_BYTES, &full[s]);\n"
                  "        continue;\n#endif\n#pragma unroll\n        for (int i = 0; i < G::KC / 8; ++i)\n          bulk_copy(", 1)
    # the halo: filled by threads (an intermediate revision) or by tensor copies
    s = s.replace("if (yy >= 0 && yy < H && xx >= 0 && xx < W)\n                v[u] = load8(",
                  "if (ABL_FILL && yy >= 0 && yy < H && xx >= 0 && xx < W)\n                v[u] = load8(", 1)
    s = s.replace("          mbar_expect_tx(&halo_ready[q], G::KC / 8 * G::NPIX * 16);\n",
                  "          if (!ABL_FILL) {\n            mbar_arrive(&halo_ready[q]);\n"
                  "            goto w_stage;\n          }\n"
                  "          mbar_expect_tx(&halo_ready[q], G::KC / 8 * G::NPIX * 16);\n", 1)
    s = s.replace("        // W: stage q = (tap, chunk j)", "      w_stage:\n        // W: stage q = (tap, chunk j)", 1)
    s = s.replace("        wgmma_bf16<NB>(acc[m],", "        if (ABL_MMA) wgmma_bf16<NB>(acc[m],", 1)
    assert s.count("ABL_") in (13, 14), ("conv patch", s.count("ABL_"))
    open(p, "w").write(s)
    p = os.path.join(dst, "flash_window_attn_bf16.cu")
    s = open(p).read()
    s = s.replace('#include "hopper_wgmma.cuh"\n', '#include "hopper_wgmma.cuh"\n' + flags, 1)
    s = s.replace("    mbar_expect_tx(&full[slot], S::KC / 8 * n * 16);\n",
                  "#ifdef ABL_NO_WCOPY\n    mbar_arrive(&full[slot]);\n    return;\n#endif\n"
                  "    mbar_expect_tx(&full[slot], S::KC / 8 * n * 16);\n", 1)
    s = s.replace("        wgmma_bf16<N>(acc, da, db);", "        if (ABL_MMA) wgmma_bf16<N>(acc, da, db);", 1)
    s = s.replace("#pragma unroll\n    for (int i = 0; i < S::KC / 8; ++i)\n      bulk_copy(",
                  "#ifdef ABL_ONECOPY\n    bulk_copy(dst, base + (static_cast<size_t>(kg0) * ld + row0) * 8, "
                  "S::KC / 8 * n * 16, &full[slot]);\n    return;\n#endif\n"
                  "#pragma unroll\n    for (int i = 0; i < S::KC / 8; ++i)\n      bulk_copy(", 1)
    s = s.replace("      head_attention_wg<HD, S::GW>(", "      if (ABL_ATT) head_attention_wg<HD, S::GW>(", 1)
    s = s.replace("    if (tid % 128 == 0) mbar_expect_tx(&xbar[w], kT * C * 4);\n    __syncwarp();\n    for (int t",
                  "#ifdef ABL_NO_XCOPY\n    if (tid % 128 == 0) mbar_arrive(&xbar[w]);\n    if (false)\n#else\n"
                  "    if (tid % 128 == 0) mbar_expect_tx(&xbar[w], kT * C * 4);\n    __syncwarp();\n#endif\n    for (int t", 1)
    s = re.sub(r"#define ATTN_BF16_INSTANCES\(X\) \\\n[^\n]*\n",
               "#define ATTN_BF16_INSTANCES(X) X(192, 24, 1)\n", s, count=1)
    assert s.count("ABL_") == 14, ("b1 patch", s.count("ABL_"))
    open(p, "w").write(s)


VARIANTS_NEW = {
    "b1": {"full": [], "no_mma": ["-DABL_NO_MMA"], "no_wcopy": ["-DABL_NO_WCOPY"],
           "no_att": ["-DABL_NO_ATT"], "no_xcopy": ["-DABL_NO_XCOPY"],
           "one_copy": ["-DABL_ONECOPY"]},
    "conv": {"full": [], "no_mma": ["-DABL_NO_MMA"], "no_wcopy": ["-DABL_NO_WCOPY"],
             "no_halo": ["-DABL_NO_FILL"], "conv_only": ["-DABL_NO_GDN"],
             "one_copy": ["-DABL_ONECOPY"]},
}
NEW = "--new" in sys.argv


VARIANTS = {
    "b1": {"full": [], "no_mma": ["-DABL_NO_MMA"], "no_wstage": ["-DABL_NO_CPASYNC"],
           "no_mlp": ["-DABL_NO_MLP"], "no_att": ["-DABL_NO_ATT"]},
    "conv": {"full": [], "no_mma": ["-DABL_NO_MMA"], "no_wstage": ["-DABL_NO_CPASYNC"],
             "no_aload": ["-DABL_NO_A"], "conv_only": ["-DABL_NO_GDN"]},
}
FILES = {"b1": "flash_window_attn_bf16.cu", "conv": "fused_conv_bf16.cu"}


def build_all():
    src = os.path.join(WORK, "src")
    (patched_copy_new if NEW else patched_copy)(src)
    if NEW:  # the GDN launch's switch, as in the first version's patch
        p = os.path.join(src, "fused_conv_bf16.cu")
        t = open(p).read()
        t = t.replace("  if (e != cudaSuccess) return e;\n  return launch_conv<C, kGdn",
                      "#ifdef ABL_NO_GDN\n  return e;\n#endif\n  if (e != cudaSuccess) return e;\n"
                      "  return launch_conv<C, kGdn", 1)
        assert "ABL_NO_GDN" in t
        open(p, "w").write(t)
    procs = {}
    t0 = time.perf_counter()
    for k, vs in (VARIANTS_NEW if NEW else VARIANTS).items():
        for v, fl in vs.items():
            # the redesigned B1 source builds its C >= 128 instances apart (SWIN_WIDE)
            for kk, wide in ((k, []),) + (((k + "w", ["-DSWIN_WIDE"]),) if NEW and k == "b1" else ()):
                out = os.path.join(OUT, f"lib{kk}_{v}.so")
                procs[(kk, v)] = (subprocess.Popen(
                    [NVCC, *FLAGS, *fl, *wide, os.path.join(src, FILES[k]), "-o", out],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    probe_out = os.path.join(OUT, "libprobe.so")
    procs[("probe", "")] = (subprocess.Popen(
        [NVCC, *FLAGS, "-I", os.path.join(ROOT, "reslic_tcm_tpu_torch", "csrc"),
         os.path.join(HERE, "wgmma_probe.cu"), "-o", probe_out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), probe_out)
    libs = {}
    for key, (p, out) in procs.items():
        text, _ = p.communicate()
        log(f"build {key}: rc {p.returncode} at {time.perf_counter() - t0:.1f} s")
        if key[1] in ("full", ""):
            for line in text.splitlines():
                if "error" in line or "registers" in line or "spill" in line or "Compiling entry" in line:
                    log("  ptxas", key[0], line.strip())
        if p.returncode != 0:
            log(text[-6000:])
            continue
        libs[key] = ctypes.CDLL(out)
    return libs


# ------------------------------ the wgmma probe ------------------------------

def run_probe(lib):
    fn = lib.probe
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, vp, i, vp, i, vp] + [i] * 8
    fn.restype = i
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def vals(*s):
        return (torch.randint(-4, 5, s, generator=g).float() / 4).to(torch.bfloat16)

    def kmajor(mat, rows_pad):
        """[R][K] -> image [K/8][rows_pad][8] (rows past R zero)."""
        r, k = mat.shape
        img = torch.zeros(k // 8, rows_pad, 8, dtype=torch.bfloat16)
        img[:, :r] = mat.reshape(r, k // 8, 8).permute(1, 0, 2)
        return img

    results = []

    def case(name, n, aimg, a_rows_logical, a_off, a_lbo, a_sbo, k):
        bm = vals(n, k)
        bimg = kmajor(bm, n)
        a_dev, b_dev = aimg.contiguous().to(dev), bimg.contiguous().to(dev)
        d = torch.full((64, n), float("nan"), device=dev)
        rc = fn(n, a_dev.data_ptr(), a_dev.numel() * 2, b_dev.data_ptr(), b_dev.numel() * 2,
                d.data_ptr(), a_off, a_lbo, a_sbo, 2 * a_lbo, n * 16, 128, 2 * n * 16, k // 16)
        torch.cuda.synchronize()
        want = a_rows_logical.float() @ bm.float().t()
        err = float((d.cpu() - want).abs().max()) if rc == 0 else float("nan")
        results.append({"case": name, "n": n, "rc": rc, "max_err": err})
        log("probe " + json.dumps(results[-1]))

    k = 64
    for n in (8, 24, 64, 96, 144, 192):
        a = vals(64, k)
        case(f"a-layout n{n}", n, kmajor(a, 64), a, 0, 1024, 128, k)
    a = vals(64, k)
    case("padded lbo n192", 192, kmajor(a, 65), a, 0, 65 * 16, 128, k)
    # halo: a 10 x 18 grid of pixels (+1 pad row), the 8x8 block (by, bx) =
    # (0, 1) shifted by the tap (dy, dx) = (2, 1)
    hh, hw, npad = 10, 18, 181
    pix = vals(hh * hw, k)
    img = kmajor(pix, npad)
    by, bx, dy, dx = 0, 1, 2, 1
    rows = torch.stack([pix[(by * 8 + dy + r // 8) * hw + bx * 8 + dx + r % 8] for r in range(64)])
    case("halo n96", 96, img, rows, ((by * 8 + dy) * hw + bx * 8 + dx) * 16, npad * 16, hw * 16, k)
    return results


# ------------------------------ timing the kernels ------------------------------

def time_ms(fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    libs = build_all()
    if ("probe", "") in libs:
        run_probe(libs[("probe", "")])
    import chip_smoke as S
    from reslic_tcm_tpu_torch.ops import flash_window_attn as F
    from reslic_tcm_tpu_torch.ops import fused_conv as C
    from reslic_tcm_tpu_torch.ops import build

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    vp, ii = ctypes.c_void_p, ctypes.c_int
    for key, lib in libs.items():
        if key[0] in ("b1", "b1w"):
            lib.flash_window_block_bf16.argtypes = [vp] * 15 + [ii] * (8 if NEW else 7) + [vp]
        elif key[0] == "conv":
            lib.fused_residual_block_bf16.argtypes = [vp] * 7 + [ii] * 5 + [vp]
            lib.fused_conv_gdn_bf16.argtypes = [vp] * 8 + [ii] * 6 + [vp]
    P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    cases = [c for c in S.BF16_CASES if c[0] != S._B1 or c[2][2]]
    seen = set()
    with torch.no_grad():
        for n, (kernel, shape, option, per_slice) in enumerate(cases):
            key = (kernel, tuple(shape), option if kernel != S._B1 else option[0])
            if key in seen:
                continue  # shifted and unshifted B1 time alike; one of them
            seen.add(key)
            args, kw = S._inputs(torch, kernel, shape, option, dev, 900 + n)
            prep = S._prepared(kernel, args, kw, bf16)
            b, h, w, c = shape
            st = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            reps = 20 if h * w >= 96 * 64 else 100
            rec = {"kernel": kernel, "shape": list(shape), "option": option,
                   "per_pass": sum(per_slice.values())}
            if kernel == S._B1:
                hd = option[0]
                k = F.cluster_size(c, hd, b * (h // 8) * (w // 8))
                x = args[0]
                out = torch.empty_like(x)
                g = F.window_group(c, hd, b * (h // 8) * (w // 8), k) if NEW else 1
                rec["cluster"], rec["group"] = k, g
                rec["grid"] = [-(-(h // 8) * (w // 8) // g) * k, b]
                split = (k, g) if NEW else (k,)
                for v in (VARIANTS_NEW if NEW else VARIANTS)["b1"]:
                    lib = libs.get(("b1w" if NEW and c >= 128 else "b1", v))
                    if lib is None:
                        continue
                    call = lambda lib=lib: lib.flash_window_block_bf16(  # noqa: E731
                        P(x), P(out), *[P(a) for a in prep], b, h, w, c, hd, *split,
                        int(option[1]), st)
                    rec[v] = time_ms(call, reps)
            else:
                if NEW:
                    tile = C.tile_config_bf16(h, w, c)
                    th, tw, nb = C.tile_shape_bf16(tile, c)
                    rec["grid"] = [-(-h // th) * -(-w // tw) * b, c // nb]
                else:
                    tile = C.tile_config(h, w, c)
                    bm, bn = C.tile_shape(tile, c)
                    rec["grid"] = [-(-b * h * w // bm), c // bn]
                t = C.TILES.index(tile)
                rec["tile"] = tile
                x = args[0]
                out = torch.empty_like(x)
                for v in (VARIANTS_NEW if NEW else VARIANTS)["conv"]:
                    lib = libs.get(("conv", v))
                    if lib is None:
                        continue
                    if kernel == S._B2:
                        if v == "conv_only":
                            continue
                        mid = torch.empty_like(x, dtype=bf16)
                        b1k, b2k = args[2].contiguous(), args[4].contiguous()
                        call = lambda lib=lib, mid=mid, b1k=b1k, b2k=b2k: lib.fused_residual_block_bf16(  # noqa: E731
                            P(x), P(prep[0]), P(b1k), P(prep[1]), P(b2k), P(mid), P(out), b, h, w, c, t, st)
                    else:
                        y = torch.empty_like(x)
                        call = lambda lib=lib, y=y: lib.fused_conv_gdn_bf16(  # noqa: E731
                            P(x), P(prep[0]), P(args[2]), P(prep[1]), P(args[4]), P(args[5]), P(y),
                            P(out), b, h, w, c, int(option), t, st)
                    rec[v] = time_ms(call, reps)
                # cuDNN bf16, channels_last, the same conv (yardstick; bias none)
                xb = x.permute(0, 3, 1, 2).to(bf16).contiguous(memory_format=torch.channels_last)
                wb = args[1].to(bf16).contiguous(memory_format=torch.channels_last)
                rec["cudnn_conv3x3"] = time_ms(lambda: torch.nn.functional.conv2d(xb, wb, padding=1), reps)
                if kernel == S._B3:
                    gb = args[3].to(bf16)[:, :, None, None].contiguous(memory_format=torch.channels_last)
                    rec["cudnn_conv1x1"] = time_ms(lambda: torch.nn.functional.conv2d(xb, gb), reps)
            flops, nbytes = S._cost(kernel, shape, option, weight_bytes=2)
            rec["bound_ms"] = max(flops / S.PEAK_BF16_FLOPS, nbytes / S.PEAK_BYTES) * 1e3
            log("step0 " + json.dumps(rec))


if __name__ == "__main__":
    main()
