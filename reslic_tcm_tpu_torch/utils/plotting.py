"""Training-time diagnostic figures (port of reslic_tcm_tpu/utils/plotting.py).

plot_sos: the learned STanH staircase, soft (at the current beta) vs hard,
for one rate level (reference plotting.py:6-65), on ``entropy/stanh.py``.
plot_rate_distorsion: RD curves (reference plotting.py:79-159). Both return
matplotlib figures. matplotlib is imported inside each function (Agg
backend); nothing else of the port needs it. wandb is not ported: the JAX
functions' ``wandb_run`` parameter is dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def plot_sos(w: np.ndarray, b: np.ndarray, symmetric: bool, beta: float,
             lv: int = 0, span: float | None = None):
    """Figure of soft-vs-hard staircase for quantizer params (w, b)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..entropy import stanh as sq

    state = sq.derive_state(torch.as_tensor(np.asarray(w, np.float32)),
                            torch.as_tensor(np.asarray(b, np.float32)), symmetric)
    cw = state.cum_w.numpy()
    span = span if span is not None else float(abs(cw).max()) * 1.2 + 1
    x = np.linspace(-span, span, 2001, dtype=np.float32)
    xt = torch.from_numpy(x)
    soft = sq.soft_quantize(xt, state, torch.tensor(beta, dtype=torch.float32)).numpy()
    hard = sq.hard_quantize(xt, state, symmetric).numpy()

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(x, hard, lw=1.0, label="hard staircase", color="#888")
    ax.plot(x, soft, lw=1.5, label=f"soft (beta={beta:.1f})")
    ax.scatter(cw, cw, s=8, color="crimson", zorder=3, label="levels")
    ax.set_xlabel("input")
    ax.set_ylabel("quantized")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title(f"STanH staircase (level {lv})")
    return fig


def plot_rate_distorsion(bpp_res: dict, psnr_res: dict, epoch: int = 0):
    """RD curves from {name: [bpp...]} / {name: [psnr...]} dicts
    (reference plotting.py:79-159)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for name in bpp_res:
        if name in psnr_res:
            order = np.argsort(np.asarray(bpp_res[name]))
            ax.plot(
                np.asarray(bpp_res[name])[order],
                np.asarray(psnr_res[name])[order],
                marker="o",
                label=name,
            )
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title(f"rate-distortion (epoch {epoch})")
    return fig
