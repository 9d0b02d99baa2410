"""The device coder's lane kernels D1-D4 (csrc/device_rans.cu), bound with ctypes.

* ``encode_lanes`` (D1): table rANS encode with the packed table, each
  lane's words written in emission order into its row; producer warps
  look up the entries and the reciprocals of freq, a walker warp runs the
  lanes' state chain;
* ``decode_lanes`` (D2): table rANS decode of one segment with the search
  table (``device_rans.search_table``), staged in shared memory where it
  fits, the carry updated in place;
* ``gaussian_encode_lanes`` (D3): the analytic coder's reverse walk from
  sigma, the emitted words left for ``analytic_rans.compact_grouped``;
  producer warps compute each symbol's (start, freq) into a ring of tiles
  and a walker warp runs the lanes' state chain over them; it raises where
  a symbol lies in a bin of width zero, as the plain version does;
* ``gaussian_decode_lanes`` (D4): the analytic grouped decode of one
  segment, the carry updated in place, its lanes spread over a cluster of
  ``decode_cluster(k)`` CTAs, a thread a lane up to 16,384 lanes and
  ``decode_lanes_per_thread(k, cluster)`` consecutive lanes a thread,
  kept in global memory, beyond that.

Each takes any lane count k that its tensors can index (k below 2^31), as
the JAX package's scans do.

They replace the JAX package's lax.scan lane loops, not Pallas kernels.
Each wrapper takes CUDA tensors only and raises on anything else (a CPU
tensor included: coding/device_rans.py and analytic_rans.py run the plain
versions for those); it checks dtypes, shapes and the device, launches on
the current stream, raises if the launch fails, and adds one to its
``launches`` counter.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import build

MAX_LANES = 2**31 - 1  # every kernel indexes its lanes with a C int
MAX_SHARED_BYTES = 232448  # shared memory a CTA can take on an H100 (D2's staged table)
# D2's variants, (lanes a CTA, table staged in shared memory):
# csrc/device_rans.cu's TABLE_DECODE_INSTANCES, in that order. On an H100
# (PERF.md §6), staged, 128 lanes a CTA beat 32 and 8 at every main-path
# shape; unstaged, 32 and 128 were within 3%; staged beat unstaged 1.6-2.6x.
TABLE_DECODE_VARIANTS = ((128, True), (32, False))
INDEX_CHUNK = 32  # D2: steps of indexes a lane stages at a time, two chunks in flight
MAX_THREADS = 1024
# D4's cluster sizes (csrc/device_rans.cu's DECODE_INSTANCES)
DECODE_CLUSTERS = (1, 2, 4, 8, 16)


def decode_clusters(k: int) -> list:
    """D4's cluster sizes K for k >= 1 lanes: every K <= k (1 at least)."""
    return [c for c in DECODE_CLUSTERS if c <= k]


def decode_cluster(k: int) -> int:
    """D4's cluster size at k lanes: the largest (0 for k < 1). On an H100
    (PERF.md §6) 16 CTAs were the fastest at k=4096 and within 1% of the
    fastest at k=1024; the result does not depend on it."""
    return max(decode_clusters(k), default=0)


def decode_lanes_per_thread(k: int, cluster: int) -> int:
    """The lanes a thread of D4 holds at k lanes on ``cluster`` CTAs: 1 (its
    one-lane form, state in registers) where a CTA of ceil(k / cluster)
    lanes fits in 1024 threads, else as many as put the CTA within 1024
    threads (its form that keeps the states in global memory;
    csrc/device_rans.cu's one_lane_a_thread and launcher)."""
    return -(-(-(-k // cluster)) // MAX_THREADS)


def _lib() -> ctypes.CDLL:
    lib = build.load("device_rans")
    if not hasattr(lib, "_argtypes_set"):
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rans_encode_lanes.argtypes = [vp, vp, vp, i, vp, vp, i, i, i, vp, vp, vp]
        lib.rans_decode_lanes.argtypes = [vp, ll, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp,
                                          vp]
        lib.gaussian_encode_lanes.argtypes = [vp, vp, i, i, vp, vp, vp, vp, vp]
        lib.gaussian_decode_lanes.argtypes = [vp, vp, vp, ll, vp, i, i, i, vp, vp]
        for fn in (lib.rans_encode_lanes, lib.rans_decode_lanes, lib.gaussian_encode_lanes,
                   lib.gaussian_decode_lanes):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _require_cuda(kernel: str, *tensors) -> torch.device:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"the {kernel} kernel takes CUDA tensors, got one on {device}")
    return device


def _check(name: str, t, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {device}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _steps(n: int, k: int) -> int:
    if k <= 0 or n % k:
        raise ValueError(f"{n} symbols do not fill lanes of {k}")
    return n // k


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")


def encode_lanes(symbols, indexes, packed, cdf_length, offset, k: int, cap: int):
    """D1. symbols, indexes: int32 [steps * k] (padded); packed: int32 [R, L];
    cdf_length, offset: int32 [R]. Returns (words int32 [k, cap], counts
    int32 [k])."""
    dev = _require_cuda("encode_lanes", symbols)
    steps = _steps(symbols.numel(), k)
    r, length = packed.shape
    _check("symbols", symbols, torch.int32, (steps * k,), dev)
    _check("indexes", indexes, torch.int32, (steps * k,), dev)
    _check("packed", packed, torch.int32, None, dev)
    _check("cdf_length", cdf_length, torch.int32, (r,), dev)
    _check("offset", offset, torch.int32, (r,), dev)
    words = torch.zeros((k, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(k, dtype=torch.int32, device=dev)
    p = build.ptr
    _raise_on(_lib().rans_encode_lanes(
        p(symbols), p(indexes), p(packed), length, p(cdf_length), p(offset), steps, k, cap,
        p(words), p(counts), build.stream(symbols)), "encode_lanes")
    encode_lanes.launches += 1
    return words, counts


encode_lanes.launches = 0


def decode_shared_bytes(search, variant: tuple) -> int:
    """The shared memory a CTA of D2's ``variant`` (lanes, staged) takes for
    ``search``: the table where staged and two chunks of each lane's
    indexes (csrc/device_rans.cu's decode_smem_bytes)."""
    lanes, staged = variant
    return (search.layout.numel() * 4 if staged else 0) + 2 * INDEX_CHUNK * lanes * 4


def decode_variants(search) -> list:
    """D2's variants (lanes a CTA, staged) that take ``search``, a
    ``device_rans.SearchTable``: a staged one only where the table fits in
    a CTA's shared memory beside the indexes."""
    return [v for v in TABLE_DECODE_VARIANTS
            if decode_shared_bytes(search, v) <= MAX_SHARED_BYTES]


def decode_variant(search) -> tuple:
    """D2's variant for ``search``: staged where the table fits (y's 143 KB
    and TCM-S's z table do), else read where it lies."""
    return decode_variants(search)[0]


def decode_lanes(x, rp, words, base, indexes, search, k: int):
    """D2. x, rp: int64 [k] carry, updated in place; words: int32 stream
    read at base[lane] + rp (base int64 [k]); indexes: int32 [steps * k];
    search: ``device_rans.SearchTable`` on the device. Returns the symbols,
    int32 [steps * k]."""
    out = decode_with(x, rp, words, base, indexes, search, k, decode_variant(search))
    decode_lanes.launches += 1
    return out


def decode_with(x, rp, words, base, indexes, search, k: int, variant: tuple):
    """``decode_lanes`` with D2's ``variant`` (one of ``decode_variants``),
    without counting the launch: the same bits in every variant, which the
    card tests and chip_smoke.py's timings of each use. A staged variant
    refuses a table larger than a CTA's shared memory."""
    dev = _require_cuda("decode_lanes", indexes)
    steps = _steps(indexes.numel(), k)
    layout = search.layout
    for name, t in (("x", x), ("rp", rp), ("base", base)):
        _check(name, t, torch.int64, (k,), dev)
    _check("words", words, torch.int32, None, dev)
    _check("indexes", indexes, torch.int32, (steps * k,), dev)
    _check("search.layout", layout, torch.int32, None, dev)
    if words.numel() == 0:
        raise ValueError("words: an empty stream")
    if layout.dim() != 1 or layout.numel() % 4 or layout.data_ptr() % 16:
        raise ValueError("search.layout: expected a 16-byte aligned int32 vector of a "
                         "multiple of 4 words (device_rans.search_table)")
    if variant not in TABLE_DECODE_VARIANTS:
        raise ValueError(f"the decode_lanes kernel has no variant {variant}; it has "
                         f"{list(TABLE_DECODE_VARIANTS)}")
    if decode_shared_bytes(search, variant) > MAX_SHARED_BYTES:
        raise ValueError(f"the decode_lanes kernel's {variant} CTA takes at most "
                         f"{MAX_SHARED_BYTES} bytes of shared memory, its indexes "
                         f"{decode_shared_bytes(search, (variant[0], False))} of them; this "
                         f"table has {layout.numel() * 4}")
    out = torch.empty(steps * k, dtype=torch.int32, device=dev)
    p = build.ptr
    _raise_on(_lib().rans_decode_lanes(
        p(words), words.numel(), p(base), p(x), p(rp), p(indexes), p(layout), layout.numel(),
        search.buckets_at, search.entries_at, search.shift, steps, k,
        TABLE_DECODE_VARIANTS.index(variant), p(out), build.stream(indexes)), "decode_lanes")
    return out


decode_lanes.launches = 0


def gaussian_encode_lanes(symbols, sigma, k: int):
    """D3. symbols: int32 [steps * k], clamped to their support; sigma:
    float32 [steps * k]. Returns (ws int32 [steps, k], need bool [steps,
    k], x int64 [k]). Raises where a symbol lies in a bin of width zero
    (freq 0), which the analytic scheme cannot code, as the plain version
    does (it waits for the kernel to read that flag)."""
    dev = _require_cuda("gaussian_encode_lanes", symbols)
    steps = _steps(symbols.numel(), k)
    _check("symbols", symbols, torch.int32, (steps * k,), dev)
    _check("sigma", sigma, torch.float32, (steps * k,), dev)
    ws = torch.empty((steps, k), dtype=torch.int32, device=dev)
    need = torch.empty((steps, k), dtype=torch.bool, device=dev)
    x = torch.empty(k, dtype=torch.int64, device=dev)
    zero_freq = torch.zeros(1, dtype=torch.int32, device=dev)
    p = build.ptr
    _raise_on(_lib().gaussian_encode_lanes(
        p(symbols), p(sigma), steps, k, p(ws), p(need), p(x), p(zero_freq),
        build.stream(symbols)), "gaussian_encode_lanes")
    gaussian_encode_lanes.launches += 1
    if int(zero_freq):
        raise RuntimeError("ZeroDivisionError: a symbol lies in an analytic bin of width zero "
                           "(freq 0), which the scheme cannot code")
    return ws, need, x


gaussian_encode_lanes.launches = 0


def gaussian_decode_lanes(x, g, flat, sigma, k: int):
    """D4. x: int64 [k] states and g: int64 [] stream pointer, updated in
    place; flat: int32 grouped stream of at least k words; sigma: float32
    [steps * k]. Returns the values, int32 [steps * k]."""
    out = decode_on_cluster(x, g, flat, sigma, k, decode_cluster(k))
    gaussian_decode_lanes.launches += 1
    return out


def decode_on_cluster(x, g, flat, sigma, k: int, cluster: int):
    """``gaussian_decode_lanes`` on a cluster of ``cluster`` CTAs (one of
    ``decode_clusters(k)``), without counting the launch: the same bits at
    every size, which the card tests and chip_smoke.py's timings of each
    size use."""
    dev = _require_cuda("gaussian_decode_lanes", sigma)
    steps = _steps(sigma.numel(), k)
    if k > MAX_LANES:
        raise ValueError(f"the gaussian_decode_lanes kernel indexes up to {MAX_LANES} lanes, "
                         f"got {k}")
    if cluster not in decode_clusters(k):
        raise ValueError(f"the gaussian_decode_lanes kernel has no cluster of {cluster} CTAs "
                         f"at k={k}; it has {decode_clusters(k)}")
    _check("x", x, torch.int64, (k,), dev)
    _check("g", g, torch.int64, (), dev)
    _check("flat", flat, torch.int32, None, dev)
    _check("sigma", sigma, torch.float32, (steps * k,), dev)
    if flat.numel() < k:
        raise ValueError(f"flat: {flat.numel()} words, the window reads {k}")
    out = torch.empty(steps * k, dtype=torch.int32, device=dev)
    p = build.ptr
    _raise_on(_lib().gaussian_decode_lanes(
        p(x), p(g), p(flat), flat.numel(), p(sigma), steps, k, cluster, p(out),
        build.stream(sigma)),
        "gaussian_decode_lanes")
    return out


gaussian_decode_lanes.launches = 0

WRAPPERS = (encode_lanes, decode_lanes, gaussian_encode_lanes, gaussian_decode_lanes)
# the JAX function each kernel replaces (file:line)
REPLACES = {
    "encode_lanes": "reslic_tcm_tpu/coding/device_rans.py:196",
    "decode_lanes": "reslic_tcm_tpu/coding/device_rans.py:377",
    "gaussian_encode_lanes": "reslic_tcm_tpu/coding/analytic_rans.py:250",
    "gaussian_decode_lanes": "reslic_tcm_tpu/coding/analytic_rans.py:335",
}


def launch_counts() -> dict:
    """{wrapper name: kernel launches so far}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
