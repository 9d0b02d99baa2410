"""Host-side data pipeline (port of reslic_tcm_tpu/data/datasets.py; numpy).
PNG and binary PPM are read by ``data/png.py``, with or without Pillow;
only JPEG, BMP and WebP files import Pillow, when one is read.

ImageFolder over root/{split}/data capped at num_images (reference
dataset/utils.py:21-60) with random crops for training and center crops for
validation (reference train.py:106-112), a shuffling, prefetching batch
iterator, and the full-resolution Kodak test set (reference
train.py:39-54). Batches are NHWC float32 in [0, 1].
"""

from __future__ import annotations

import os
import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np

from .png import read_png, read_ppm

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp"}


def list_images(directory) -> list[Path]:
    return [f for f in sorted(Path(directory).iterdir())
            if f.is_file() and f.suffix.lower() in _IMG_EXTS]


def read_image_u8(path) -> np.ndarray:
    """HWC uint8 RGB: PNG and PPM through ``data/png.py``, the other formats
    through Pillow's ``convert("RGB")``."""
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        return read_png(path)
    if suffix == ".ppm":
        return read_ppm(path)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: reading {suffix} images needs Pillow, which is not "
                          f"installed; PNG and PPM images are read without it") from None
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def read_image(path) -> np.ndarray:
    """HWC float32 in [0, 1] (reference utils/helper.py:76-80)."""
    return read_image_u8(path).astype(np.float32) / 255.0


def _pad_to(img: np.ndarray, size) -> np.ndarray:
    """Reflect-pad an image smaller than ``size`` up to it."""
    h, w = img.shape[:2]
    th, tw = size
    if h < th or w < tw:
        img = np.pad(img, ((0, max(th - h, 0)), (0, max(tw - w, 0)), (0, 0)), mode="reflect")
    return img


def random_crop(img: np.ndarray, size, rng: np.random.Generator) -> np.ndarray:
    img = _pad_to(img, size)
    h, w = img.shape[:2]
    th, tw = size
    i = int(rng.integers(0, h - th + 1))
    j = int(rng.integers(0, w - tw + 1))
    return img[i : i + th, j : j + tw]


def center_crop(img: np.ndarray, size) -> np.ndarray:
    img = _pad_to(img, size)
    h, w = img.shape[:2]
    th, tw = size
    i, j = (h - th) // 2, (w - tw) // 2
    return img[i : i + th, j : j + tw]


class ImageFolder:
    """root/{split}/data image list capped at num_images. Decoded images are
    kept in RAM as uint8 up to RESLIC_DATA_CACHE_MB (default 16384), so
    later epochs only crop and normalise."""

    def __init__(self, root, num_images: int = 300000, split: str = "train",
                 patch_size=(256, 256), train: bool = True, cache_mb: float | None = None):
        splitdir = Path(root) / split / "data"
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{root}"')
        self.samples = list_images(splitdir)[:num_images]
        self.patch_size = tuple(patch_size)
        self.train = train
        if cache_mb is None:
            cache_mb = float(os.environ.get("RESLIC_DATA_CACHE_MB", 16384))
        self._cache_budget = int(cache_mb * 1e6)
        self._cache: dict = {}
        self._cache_bytes = 0

    def __len__(self):
        return len(self.samples)

    def _read_u8(self, index: int) -> np.ndarray:
        img = self._cache.get(index)
        if img is None:
            img = read_image_u8(self.samples[index])
            if self._cache_bytes + img.nbytes <= self._cache_budget:
                self._cache[index] = img
                self._cache_bytes += img.nbytes
        return img

    def get(self, index: int, rng: np.random.Generator) -> np.ndarray:
        img = self._read_u8(index)
        crop = (random_crop(img, self.patch_size, rng) if self.train
                else center_crop(img, self.patch_size))
        return crop.astype(np.float32) / 255.0


class Loader:
    """Shuffling batch iterator over an ImageFolder, one reader thread
    prefetching up to ``prefetch`` batches: the order and crops of epoch e
    come from (seed, e)."""

    def __init__(self, dataset: ImageFolder, batch_size: int, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True, prefetch: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def worker():
            wrng = np.random.default_rng((self.seed, self.epoch, 1))
            for b in range(n_batches):
                idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                q.put(np.stack([self.ds.get(int(i), wrng) for i in idx], axis=0))
            q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        self.epoch += 1


class KodakDataset:
    """Full-resolution test images, batch 1 (reference train.py:39-54)."""

    def __init__(self, root):
        self.samples = list_images(root)
        if not self.samples:
            raise RuntimeError(f"no images under {root}")

    def __len__(self):
        return len(self.samples)

    def __iter__(self):
        for f in self.samples:
            yield read_image(f)[None]  # [1, H, W, 3]
