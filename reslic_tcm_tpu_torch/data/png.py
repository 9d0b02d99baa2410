"""PNG and binary PPM images without Pillow: the standard library's ``zlib``
and ``struct``, numpy, and a small C++ library for PNG's row filters.

``read_png`` returns HWC uint8 RGB as Pillow's ``Image.open(p).convert("RGB")``
does: grey is replicated, alpha is dropped without compositing, a palette is
looked up (``tRNS`` ignored). It takes bit depth 8 for grey, RGB, grey with
alpha and RGBA, and palettes at bit depths 1, 2, 4 and 8, checks every
chunk's CRC, skips ancillary chunks, and raises ``ValueError`` naming the
file and the feature for 16-bit samples, Adam7 interlacing and a corrupt
stream. The rows are unfiltered by ``csrc/png_unfilter.cpp`` (built by
``ops/build.py`` with g++ at first use): Paeth and Average read the
reconstructed pixel on the left, so a row runs in sequence.

``write_png`` writes 8-bit RGB, not interlaced, one IDAT at zlib level 6,
each row under the filter whose output has the least sum of absolute
values (read as signed bytes), the heuristic of the PNG specification's
section 12.8. ``read_ppm`` reads binary PPM (``P6``, maxval 255).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, the bit depths read)
_COLOUR_TYPES = {0: (1, (8,)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)), 6: (4, (8,))}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")


def _unfilter_lib():
    from ..ops import build

    lib = build.load("png_unfilter")
    if not hasattr(lib, "_argtypes_set"):
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [_u8p, _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib._argtypes_set = True
    return lib


def _chunks(path, data: bytes):
    """(type, body) of each chunk up to IEND, every CRC checked."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (no PNG signature)")
    pos = len(_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: corrupt PNG stream (truncated before IEND)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: corrupt PNG stream (truncated {ctype!r} chunk)")
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{path}: corrupt PNG stream (CRC mismatch in the {ctype!r} chunk)")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def read_png(path) -> np.ndarray:
    """HWC uint8 RGB of the PNG file at ``path`` (module docstring)."""
    header = palette = None
    idat = []
    for ctype, body in _chunks(path, Path(path).read_bytes()):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: corrupt PNG stream (IHDR of {len(body)} bytes)")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20:
            raise ValueError(f"{path}: unknown critical PNG chunk {ctype!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: corrupt PNG stream (no {'IHDR' if header is None else 'IDAT'})")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour not in _COLOUR_TYPES:
        raise ValueError(f"{path}: corrupt PNG stream (colour type {colour})")
    channels, depths = _COLOUR_TYPES[colour]
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG samples are not supported (8-bit only)")
    if depth not in depths:
        raise ValueError(f"{path}: bit depth {depth} for {_COLOUR_NAMES[colour]} PNG images "
                         f"is not supported")
    if interlace == 1:
        raise ValueError(f"{path}: Adam7-interlaced PNG files are not supported")
    if compression or filtering or interlace or not width or not height:
        raise ValueError(f"{path}: corrupt PNG stream (IHDR {header})")
    stride = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG stream (zlib: {e})") from None
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: corrupt PNG stream ({len(raw)} image bytes, "
                         f"{height * (stride + 1)} expected)")
    src = np.frombuffer(raw, np.uint8, height * (stride + 1))
    rows = np.empty((height, stride), np.uint8)
    bad = _unfilter_lib().png_unfilter(src, rows, height, stride,
                                       max(1, channels * depth // 8))
    if bad:
        raise ValueError(f"{path}: corrupt PNG stream (filter type "
                         f"{src[(bad - 1) * (stride + 1)]} on row {bad - 1})")
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width, None]
    else:
        samples = rows.reshape(height, width, channels)
    if colour == 3:
        if palette is None or len(palette) % 3:
            raise ValueError(f"{path}: corrupt PNG stream (palette image without a valid PLTE)")
        table = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        index = samples[..., 0]
        if int(index.max()) >= len(table):
            raise ValueError(f"{path}: corrupt PNG stream (palette index {int(index.max())} "
                             f"beyond the {len(table)} entries)")
        return table[index]
    if channels <= 2:  # grey, grey+alpha
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img: np.ndarray) -> bytes:
    """The filtered stream of HWC uint8 ``img``: a type byte and the row
    under each of the five filters, the least sum of |signed byte| kept."""
    h = img.shape[0]
    x = img.reshape(h, -1).astype(np.int16)
    bpp = img.shape[2]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    corner = np.zeros_like(x)
    corner[1:, bpp:] = x[:-1, :-bpp]
    candidates = np.stack([x, x - left, x - up, x - (left + up) // 2,
                           x - _paeth(left, up, corner)]).astype(np.uint8)
    cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(axis=2)
    best = np.argmin(cost, axis=0)
    chosen = candidates[best, np.arange(h)]
    return np.concatenate([best.astype(np.uint8)[:, None], chosen], axis=1).tobytes()


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def write_png(path, img_u8: np.ndarray) -> None:
    """Write HWC uint8 RGB ``img_u8`` to ``path`` as an 8-bit RGB PNG."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 or not img.size:
        raise ValueError(f"write_png takes a non-empty HWC uint8 RGB array, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(_filter_rows(img), 6))
        + _chunk(b"IEND", b""))


def read_ppm(path) -> np.ndarray:
    """HWC uint8 RGB of a binary PPM file (``P6``, maxval 255)."""
    data = Path(path).read_bytes()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace() and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: corrupt PPM header")
        fields.append(data[start:pos])
    if fields[0] != b"P6":
        raise ValueError(f"{path}: only binary PPM (P6) is read, not {fields[0]!r}")
    try:
        width, height, maxval = (int(f) for f in fields[1:])
    except ValueError:
        raise ValueError(f"{path}: corrupt PPM header {fields}") from None
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval} is not supported (255 only)")
    pos += 1  # the one whitespace byte after maxval
    n = width * height * 3
    if len(data) - pos < n:
        raise ValueError(f"{path}: corrupt PPM file ({len(data) - pos} bytes of {n})")
    return np.frombuffer(data, np.uint8, n, pos).reshape(height, width, 3).copy()
