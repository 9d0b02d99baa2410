#!/usr/bin/env python3
"""Device time of the device coder's D4 kernel (``gaussian_decode_lanes``)
in several source trees, in turns, on one card.

    python3 tools/d4_compare.py <tree> [<tree> ...] [--rounds 2]

Each tree is a checkout of this repository (unpack another commit with
``git archive`` under ``runs/``). For every round, each tree in turn runs in
a process of its own, builds its ``device_rans`` library from its own
sources and times its D4 wrapper, on the wrapper's cluster, at the device
coder's main-path shapes: one 768x512 TCM-S image at k=1024 (five segments
of 96 steps) and the serving path's batch of 8 at k=4096 (five segments of
192 steps), then at k=16384 and 65536 (four segments of 12 steps) where
the tree's wrapper takes them. The inputs are the same in every tree:
seeded Gaussian symbols with sigma log-uniform over [0.05, 300] (larger
bins than TCM-S's latents, so longer searches), each segment's values
checked against the plain version. Prints one JSON line per tree and
round: the profiler's mean device ms per launch by shape, the card's name
and power limit. Run the trees as parent, change, change, parent to see
the spread (``--rounds 2`` with the parent first)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

# (label, lanes, steps a segment, segments)
SHAPES = (("image k=1024", 1024, 96, 5), ("batch 8 k=4096", 4096, 192, 5),
          ("k=16384", 16384, 12, 4), ("k=65536", 65536, 12, 4))
REPS = 20


def _child(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from reslic_tcm_tpu_torch.coding import analytic_rans as ar
    from reslic_tcm_tpu_torch.coding import device_kernels as dk

    cuda = torch.device("cuda")
    out = {}
    for label, k, steps, n_seg in SHAPES:
        rng = np.random.default_rng(k)
        n = k * steps * n_seg
        sigma = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)
        sym = np.round(rng.normal(0.0, 1.3, n) * sigma).astype(np.int32)
        sigma, sym = torch.from_numpy(sigma), torch.from_numpy(sym)
        c = ar.support(sigma)
        sym = torch.minimum(torch.maximum(sym, -c), c).to(torch.int32)
        p = ar.coder_params(sigma)
        while True:
            zero = ar._start_freq(sym, p)[1] == 0
            if not bool(zero.any()):
                break
            sym = torch.where(zero, sym - 1, sym)
        header, flat, _, _ = ar.compact_grouped(*ar.plain_encode_gaussian_lanes(sym, sigma, k), n)
        flat = torch.cat([flat, flat.new_zeros(k)]).to(cuda)
        segs = [s.contiguous() for s in sigma.to(cuda).split(k * steps)]
        carry0 = [t.to(cuda) for t in ar.decode_gaussian_grouped_init(header)]

        def run():
            x, g = carry0[0].clone(), carry0[1].clone()
            return torch.cat([dk.gaussian_decode_lanes(x, g, flat, s, k) for s in segs])

        try:
            got = run()
        except ValueError as e:  # a lane count this tree's wrapper refuses
            out[label] = f"refused: {e}"
            continue
        if not torch.equal(got.cpu(), sym):
            raise AssertionError(f"{tree} {label}: decoded other values")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "gaussian_decode_kernel" in e.name]
        out[label] = {"device_ms_per_launch": float(np.mean(times)) if times else None,
                      "launches_seen": len(times), "launches": REPS * n_seg,
                      "device_us_per_step": float(np.mean(times)) * 1e3 / steps if times
                      else None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"tree": tree, "card": smi.strip(), "d4": out}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--child":
        _child(args[1])
        return 0
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if not args:
        print(__doc__)
        return 2
    for _ in range(rounds):
        order = args if _ % 2 == 0 else args[::-1]
        for tree in order:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                 os.path.abspath(tree)]).returncode
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
