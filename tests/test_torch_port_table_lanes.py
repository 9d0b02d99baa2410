"""The table lane kernels' arithmetic, modelled on the CPU (numpy and torch
only; the kernels run on the card, tests/test_torch_port_cuda.py).

D2 (``rans_decode_kernel``, csrc/device_rans.cu) finds each symbol in the
search table that ``device_rans.search_table`` builds: a bucket index per
row, then a binary search of the entries between a bucket's symbol and the
next one's. ``_kernel_lookup`` repeats that search step for step, and must
give the inverse table's symbol (``build_inverse_table``) and the packed
table's entry for every (row, cf) of the 64-row scale table that codes y
and of a 192-row factorized z table. D1 (``rans_encode_kernel``) divides by
a reciprocal: ``_kernel_put`` repeats its quotient and remainder, which must
equal x // freq and x % freq for every freq in [1, 65535].
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_inputs import coder_tables, scale_tables  # noqa: E402

from reslic_tcm_tpu_torch.coding import device_kernels as dk  # noqa: E402
from reslic_tcm_tpu_torch.coding import device_rans as dr  # noqa: E402
from reslic_tcm_tpu_torch.entropy.factorized import build_tables  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401


def z_tables(seed=0, c=192):
    """(cdf, cdf_length, offset) of a factorized prior over ``c`` channels
    (``EntropyBottleneck.update``'s tables) from seeded chain parameters and
    quantiles: rows of 4 to 33 entries, as TCM-S's z table has."""
    rng = np.random.default_rng(seed)
    f = (1, 3, 3, 3, 3, 1)
    scale = 10.0 ** (1 / 5)
    params = {}
    for i in range(5):
        init = np.log(np.expm1(1 / scale / f[i + 1]))
        params[f"matrix{i}"] = init + rng.normal(0, 0.3, (c, f[i + 1], f[i]))
        params[f"bias{i}"] = rng.uniform(-0.5, 0.5, (c, f[i + 1], 1))
        if i < 4:
            params[f"factor{i}"] = rng.normal(0, 0.3, (c, f[i + 1], 1))
    med = rng.normal(0, 0.5, c)
    params["quantiles"] = np.stack([med - rng.uniform(0.5, 15, c), med,
                                    med + rng.uniform(0.5, 15, c)], 1)[:, None, :]
    t = build_tables({n: np.asarray(p, np.float32) for n, p in params.items()})
    return t.quantized_cdf, t.cdf_length, t.offset


def _kernel_lookup(search, row, cf):
    """D2's search for each cf in ``row``, as the kernel runs it: (symbol,
    entry)."""
    layout = search.layout
    e0, b0, length, _ = (int(v) for v in layout[4 * row:4 * row + 4])
    buckets = layout[search.buckets_at:search.entries_at].view(np.uint16).astype(np.int32)
    entries = layout[search.entries_at:].view(np.uint32)[e0:e0 + length - 1]
    bucket = b0 + (cf >> search.shift)
    lo = buckets[bucket]
    hi = np.minimum(buckets[bucket + 1], length - 2)
    todo = np.flatnonzero(lo < hi)
    while todo.size:  # the lanes whose search goes on
        l, h = lo[todo], hi[todo]
        mid = (l + h + 1) >> 1
        right = (entries[mid] >> 16) <= cf[todo]
        l = np.where(right, mid, l)
        h = np.where(right, h, mid - 1)
        lo[todo], hi[todo] = l, h
        todo = todo[l < h]
    return lo, entries[lo]


@pytest.mark.parametrize("make", [scale_tables, z_tables], ids=["scale", "z"])
def test_search_finds_the_inverse_tables_symbol_at_every_cf(make):
    cdf, length, offset = make()
    search = dr.search_table(cdf, length, offset)
    inverse = dr.build_inverse_table(cdf, length)
    packed = dr.build_packed_table(cdf, length)
    cf = np.arange(1 << 16, dtype=np.int32)
    for r in range(cdf.shape[0]):
        sym, entry = _kernel_lookup(search, r, cf)
        np.testing.assert_array_equal(sym, inverse[r])
        np.testing.assert_array_equal(entry, packed[r, inverse[r]])


def test_search_table_layout():
    """Rows, buckets and entries where the kernel reads them; the sizes
    that decide the staged variant (y: 142,688 bytes; TCM-S-like z: fits)."""
    cdf, length, offset = scale_tables()
    search = dr.search_table(cdf, length, offset)
    info = search.layout[:search.buckets_at].reshape(-1, 4)
    np.testing.assert_array_equal(info[:, 2], length)
    np.testing.assert_array_equal(info[:, 3], offset)
    np.testing.assert_array_equal(info[:, 0], np.concatenate([[0], np.cumsum(length - 1)[:-1]]))
    assert search.layout.size % 4 == 0 and search.entries_at % 4 == 0
    assert search.shift == 16 - dr.BUCKET_BITS
    assert search.layout.nbytes == 142_688 <= dk.MAX_SHARED_BYTES
    assert dr.search_table(*z_tables()).layout.nbytes <= dk.MAX_SHARED_BYTES
    big = dr.search_table(*coder_tables(44, r=200, width=2000))
    assert big.layout.nbytes > dk.MAX_SHARED_BYTES


def test_d2_variants_follow_the_shared_memory_budget():
    """Every variant for a table that fits, the staged one by default; only
    those that read the table where it lies for one that does not."""
    fits = dr.lane_tables(*coder_tables(40), "cpu").search
    big = dr.lane_tables(*coder_tables(44, r=200, width=2000), "cpu").search
    assert dk.decode_variants(fits) == list(dk.TABLE_DECODE_VARIANTS)
    assert dk.decode_variant(fits) == dk.decode_variants(fits)[0]
    assert dk.decode_variant(fits)[1]
    assert dk.decode_variants(big) == [v for v in dk.TABLE_DECODE_VARIANTS if not v[1]]
    assert dk.decode_variant(big) == dk.decode_variants(big)[0]


@pytest.mark.parametrize("bad", ["short", "not 2^16", "decreasing", "empty last bin"])
def test_search_table_refuses_rows_that_are_not_cdfs(bad):
    cdf, length, offset = coder_tables(40)
    cdf, length = cdf.copy(), length.copy()
    n = int(length[2])
    if bad == "short":
        length[2] = 1
    elif bad == "not 2^16":
        cdf[2, n - 1] = 65535
    elif bad == "decreasing":
        cdf[2, 1], cdf[2, 2] = cdf[2, 2], cdf[2, 1] - 1
    else:
        cdf[2, n - 2] = 1 << 16
    with pytest.raises(ValueError, match="row 2"):
        dr.search_table(cdf, length, offset)


def _kernel_put(x, start, freq):
    """D1's state update (csrc/device_rans.cu ``put``) on uint64 arrays
    holding uint32 values: the quotient from m = 0xFFFFFFFF // freq, then
    one correction. Returns (quotient, remainder, new state)."""
    m = np.uint64(0xFFFFFFFF) // freq
    q = (x * m) >> np.uint64(32)
    r = x - q * freq
    over = r >= freq
    q = np.where(over, q + 1, q)
    r = np.where(over, r - freq, r)
    return q, r, ((q << np.uint64(16)) | (r + start)) & np.uint64(0xFFFFFFFF)


def test_reciprocal_quotient_is_exact_for_every_freq():
    """Every freq in [1, 65535] at the states 0, freq * 2^16 - 1 (the largest
    a step divides after renormalising), 2^32 - 1, a multiple of freq and
    its predecessor, and 64 random uint32 states each."""
    rng = np.random.default_rng(0)
    freq = np.arange(1, 1 << 16, dtype=np.uint64)
    top = (freq << np.uint64(16)) - np.uint64(1)
    states = [np.zeros_like(freq), top, np.full_like(freq, 0xFFFFFFFF),
              (top // freq) * freq, (top // freq) * freq - np.uint64(1)]
    states += list(rng.integers(0, 1 << 32, (64, freq.size), dtype=np.uint64))
    for x in states:
        q, r, _ = _kernel_put(x, np.uint64(0), freq)
        np.testing.assert_array_equal(q, x // freq)
        np.testing.assert_array_equal(r, x % freq)


def test_kernel_put_is_the_plain_put():
    """The state update itself against ``device_rans.put`` on random
    renormalised states and table entries."""
    import torch

    rng = np.random.default_rng(1)
    freq = rng.integers(1, 1 << 16, 200_000).astype(np.uint64)
    start = (rng.integers(0, 1 << 16, freq.size).astype(np.uint64) % (np.uint64(65537) - freq))
    x = rng.integers(0, 1 << 32, freq.size, dtype=np.uint64) % (freq << np.uint64(16))
    _, _, got = _kernel_put(x, start, freq)
    want = dr.put(*(torch.from_numpy(a.astype(np.int64)) for a in (x, start, freq)))
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
