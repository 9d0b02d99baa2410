"""RD-curve plotting CLI (port of reslic_tcm_tpu/cli/rd_plot.py; reference
src/rd_plot.py).

Plots rate-distortion curves (bpp vs PSNR) for one or more result sets. The
reference hardcodes its tables (rd_plot.py:118-128); those anchors are kept
available via --include-reference, and arbitrary curves can be passed as
JSON files {"name": ..., "bpp": [...], "psnr": [...]}. Needs matplotlib,
imported when a figure is drawn:

    python -m reslic_tcm_tpu_torch.cli.rd_plot --include-reference --output rd.png
"""

from __future__ import annotations

import argparse
import json
import sys

# In-code anchors from the reference (rd_plot.py:118-128, train.py:122-123).
REFERENCE_CURVES = {
    "proposed (stanh multi-rate)": {
        "bpp": [0.0952, 0.14, 0.179, 0.21, 0.236, 0.274, 0.325, 0.406, 0.446,
                0.486, 0.57, 0.7315],
        "psnr": [26.21, 27.23, 28.74, 29.374, 29.79, 30.342, 30.937, 31.535,
                 32.078, 32.49, 33.34, 34.633],
    },
    "gain": {
        "bpp": [0.09, 0.2024, 0.342, 0.7252, 0.8835],
        "psnr": [25.9183, 27.582, 29.256, 34.186, 35.235],
    },
    "base": {
        "bpp": [0.1313, 0.2089, 0.3199, 0.4784, 0.6687],
        "psnr": [27.5815, 29.1967, 30.9722, 32.8382, 34.5263],
    },
}


def plot_rate_distorsion(curves: dict, output: str, title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for name, c in curves.items():
        ax.plot(c["bpp"], c["psnr"], marker="o", label=name)
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.savefig(output, dpi=150, bbox_inches="tight")
    print(f"saved {output}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="RD curve plotting")
    parser.add_argument("--curves", nargs="*", default=[],
                        help="JSON files with {name, bpp, psnr}")
    parser.add_argument("--include-reference", action="store_true",
                        help="overlay the reference's published anchors")
    parser.add_argument("--output", type=str, default="rd_plot.png")
    parser.add_argument("--title", type=str, default="")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    curves = {}
    if args.include_reference:
        curves.update(REFERENCE_CURVES)
    for path in args.curves:
        with open(path) as f:
            c = json.load(f)
        curves[c.get("name", path)] = {"bpp": c["bpp"], "psnr": c["psnr"]}
    if not curves:
        parser.error("nothing to plot: pass --curves and/or --include-reference")
    plot_rate_distorsion(curves, args.output, args.title)
    return 0


if __name__ == "__main__":
    sys.exit(main())
