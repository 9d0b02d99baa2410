"""Times the bf16 instances of B1 (LN+MLP), B2 and B3 of one source tree at
chip_smoke.py's main-path shapes on the card: the profiler's device ms and
the CUDA-event ms per call of the wrapper's choice, the error against the
plain bf16 version, a digest of the output's bits (two trees that give the
same bits give the same digest), and with --options every tile or (cluster,
windows a CTA), their bits held equal. To compare two trees on one card, run it on
each on one card, in turns (parent, change, change, parent):

    python3 tools/bf16_redesign/compare.py <tree> <tag> [--options] [--only=<kernel>]

<tree> is a checkout of the repo (e.g. `git archive <commit>` unpacked under
runs/); prints `measure` JSON lines."""

import hashlib
import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
tag = sys.argv[2]
options = "--options" in sys.argv
only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")]
os.chdir(root)
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from reslic_tcm_tpu_torch.ops import build  # noqa: E402
from reslic_tcm_tpu_torch.ops import flash_window_attn as F  # noqa: E402
from reslic_tcm_tpu_torch.ops import fused_conv as C  # noqa: E402

t0 = time.perf_counter()
rep = build.build([n for n in build.SOURCES if n.endswith(("_bf16", "_bf16_wide"))])
print(json.dumps({"tag": tag, "build_s": time.perf_counter() - t0}), flush=True)
for name, r in rep.items():
    for line in r["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "smem" in line:
            print(f"ptxas[{tag}:{name}] {line.strip()}", flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev, bf16 = torch.device("cuda"), torch.bfloat16
fns = {S._B1: (F.flash_window_block, F.plain_window_block),
       S._B2: (C.fused_residual_block, C.plain_residual_block),
       S._B3: (C.fused_conv_gdn, C.plain_conv_gdn)}
cases = [c for c in S.BF16_CASES if c[0] != S._B1 or c[2][2]]
with torch.no_grad():
    for i, (kernel, shape, option, per_slice) in enumerate(cases):
        if only and kernel not in only:
            continue
        args, kw = S._inputs(torch, kernel, shape, option, dev, S.SEED + 500 + i)
        prep = S._prepared(kernel, args, kw, bf16)
        kern, plain = fns[kernel]
        run = lambda **f: kern(*args, **kw, **f, compute_dtype=bf16, prepared=prep)  # noqa: E731
        got = run()
        want = plain(*args, **kw, compute_dtype=bf16)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = S.TOL_BF16 * max(1.0, float(want.abs().max()))
        reps = 10 if shape[1] * shape[2] * shape[3] >= 96 * 64 * 64 else 50
        rec = {"tag": tag, "kernel": kernel, "shape": list(shape), "option": option,
               "per_slice": per_slice, "max_abs_err": err, "tol": tol,
               "digest": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
               "finite": bool(torch.isfinite(got).all()),
               "ms": S._time_ms(torch, run, reps), "device_ms": S._device_ms(torch, run, reps)}
        flops, nbytes = S._cost(kernel, shape, option, weight_bytes=2)
        rec["bound_ms"] = max(flops / S.PEAK_BF16_FLOPS, nbytes / S.PEAK_BYTES) * 1e3
        if options:
            forces = {}
            if kernel == S._B1:
                at = {n: v for n, v in kw.items() if n != "with_ln"}
                ks = dict.fromkeys((F.min_cluster(shape[3]), F.max_cluster(shape[3], option[0])))
                if hasattr(F, "flash_window_block_at"):
                    b, h, w, c = shape
                    rec["chosen"] = [F.cluster_size(c, option[0], b * h * w // 64)]
                    rec["chosen"].append(F.window_group(c, option[0], b * h * w // 64,
                                                        rec["chosen"][0]))
                    for k in ks:
                        for g in F.window_groups(shape[3], k):
                            forces[f"{k}x{g}"] = (lambda k=k, g=g: F.flash_window_block_at(
                                *args, cluster=k, group=g, prepared=prep, **at))
                else:
                    for k in ks:
                        forces[f"{k}"] = lambda k=k: run(cluster=k)
            else:
                rec["chosen"] = (C.tile_config_bf16 if hasattr(C, "tile_config_bf16")
                                 else C.tile_config)(*shape[1:])
                for t in C.TILES:
                    forces[t] = lambda t=t: run(tile=t)
            rec["equal"] = all(bool(torch.equal(got, f())) for f in forces.values())
            rec["options_device_ms"] = {n: S._device_ms(torch, f, reps) for n, f in forces.items()}
        print("measure " + json.dumps(rec), flush=True)
