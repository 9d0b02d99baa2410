"""Procedural natural-image-statistics images (port of
reslic_tcm_tpu/data/synthetic.py, numpy only).

Dead leaves (overlapping ellipses with power-law sizes), 1/f^alpha Gaussian
random fields with correlated RGB channels, gradient polygons and oriented
gratings, mixed per image: a proxy for photographs where no image dataset
is available. The same seed gives the same image as the JAX package's
generator.

``generate_corpus`` writes the JAX writer's corpus, root/{train,test}/data
/synth_NNNNN.png (the ImageFolder layout), pixel for pixel, through
``data/png.py`` instead of Pillow:

    python -m reslic_tcm_tpu_torch.data.synthetic <root> <n_train>
"""

from __future__ import annotations

import os

import numpy as np


def _grf(rng: np.random.Generator, h: int, w: int, alpha: float) -> np.ndarray:
    """1/f^alpha Gaussian random field in [0,1], shape [h, w]."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = f ** (-alpha / 2.0)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, amp.shape)
    spec = amp * (np.cos(phase) + 1j * np.sin(phase))
    img = np.fft.irfft2(spec, s=(h, w))
    img -= img.min()
    m = img.max()
    return img / m if m > 0 else img


def _grf_rgb(rng, h, w) -> np.ndarray:
    alpha = rng.uniform(1.6, 2.4)
    base = _grf(rng, h, w, alpha)
    out = np.empty((h, w, 3), np.float32)
    corr = rng.uniform(0.6, 0.95)
    for c in range(3):
        out[..., c] = corr * base + (1 - corr) * _grf(rng, h, w, alpha)
    lo, hi = rng.uniform(0, 0.25), rng.uniform(0.75, 1.0)
    return (lo + (hi - lo) * out).astype(np.float32)


def _dead_leaves(rng, h, w, n_min=60, n_max=220) -> np.ndarray:
    """Overlapping ellipses, power-law radii, smooth per-leaf shading."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    img[:] = rng.uniform(0, 1, 3)
    n = int(rng.integers(n_min, n_max))
    rmin, rmax = 0.015 * min(h, w), 0.45 * min(h, w)
    for _ in range(n):
        # p(r) ~ r^-2.6 between rmin and rmax (scale-invariant regime)
        u = rng.uniform()
        expo = -1.6
        r = (rmin**expo + u * (rmax**expo - rmin**expo)) ** (1 / expo)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ar = rng.uniform(0.4, 1.0)
        th = rng.uniform(0, np.pi)
        ct, st = np.cos(th), np.sin(th)
        dy, dx = yy - cy, xx - cx
        u1 = ct * dx + st * dy
        u2 = -st * dx + ct * dy
        mask = (u1 / r) ** 2 + (u2 / (r * ar)) ** 2 <= 1.0
        col = rng.uniform(0, 1, 3).astype(np.float32)
        # gentle linear shading inside the leaf
        gdir = rng.uniform(-1, 1, 2)
        shade = 1.0 + 0.25 * (gdir[0] * dy + gdir[1] * dx) / max(r, 1.0)
        shade = np.clip(shade, 0.6, 1.4)
        for c in range(3):
            img[..., c] = np.where(mask, np.clip(col[c] * shade, 0, 1),
                                   img[..., c])
    return img


def _gradient_polys(rng, h, w) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = rng.uniform(-1, 1, (3, 2))
    base = np.stack(
        [0.5 + 0.4 * (a[c, 0] * (yy / h - 0.5) + a[c, 1] * (xx / w - 0.5))
         for c in range(3)], -1,
    )
    for _ in range(int(rng.integers(2, 7))):
        k = rng.uniform(-1, 1, 2)
        b = rng.uniform(-0.3, 0.3)
        half = (k[0] * (yy / h - 0.5) + k[1] * (xx / w - 0.5)) > b
        col = rng.uniform(0, 1, 3)
        mix = rng.uniform(0.5, 1.0)
        for c in range(3):
            base[..., c] = np.where(half, mix * col[c] + (1 - mix) * base[..., c],
                                    base[..., c])
    return np.clip(base, 0, 1).astype(np.float32)


def _grating(rng, h, w) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(int(rng.integers(1, 4))):
        f = rng.uniform(0.01, 0.15)
        th = rng.uniform(0, np.pi)
        ph = rng.uniform(0, 2 * np.pi)
        img += np.sin(2 * np.pi * f * (np.cos(th) * xx + np.sin(th) * yy) + ph)
    img = (img - img.min()) / max(np.ptp(img), 1e-6)
    col0, col1 = rng.uniform(0, 1, 3), rng.uniform(0, 1, 3)
    return (img[..., None] * col0 + (1 - img[..., None]) * col1).astype(np.float32)


def synth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One composite image [h, w, 3] float32 in [0,1]."""
    kinds = rng.choice(4, size=int(rng.integers(1, 3)), replace=False)
    layers = []
    for kind in kinds:
        layers.append([_dead_leaves, _grf_rgb, _gradient_polys, _grating][kind](rng, h, w))
    img = layers[0]
    for extra in layers[1:]:
        m = _grf(rng, h, w, rng.uniform(1.5, 2.5))[..., None].astype(np.float32)
        img = img * m + extra * (1 - m)
    # sensor-ish noise + slight blur variation
    img = img + rng.normal(0, rng.uniform(0.002, 0.01), img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def generate_corpus(root: str, n_train: int = 400, n_test: int = 24,
                    train_size=(512, 512), test_size=(512, 768),
                    seed: int = 0, skip_existing: bool = True) -> str:
    """Write root/{train,test}/data/*.png; returns root."""
    from .png import write_png

    for split, n, size in (("train", n_train, train_size),
                           ("test", n_test, test_size)):
        d = os.path.join(root, split, "data")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            path = os.path.join(d, f"synth_{i:05d}.png")
            if skip_existing and os.path.exists(path):
                continue
            rng = np.random.default_rng(seed * 1_000_003 + (0 if split == "train" else 500_000) + i)
            img = synth_image(rng, *size)
            write_png(path, (img * 255).round().astype(np.uint8))
    return root


if __name__ == "__main__":
    import sys

    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/synth_corpus"
    n_train = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    generate_corpus(root, n_train=n_train)
    print(root)
