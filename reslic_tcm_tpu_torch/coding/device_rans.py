"""Interleaved rANS coding on the device (port of reslic_tcm_tpu/coding/device_rans.py).

K independent rANS lanes code one stream, so encoding and decoding run on
the card and only the compressed words cross to the host. The scheme is
the JAX package's, word for word (32-bit states, 16-bit renormalisation
words, 16-bit probability precision):

* symbol position p is coded by lane p % K at step p // K; positions past
  the last symbol code the symbol offset[0] (bin 0) under index 0;
* encoding walks the steps in reverse, so decoding walks them forward;
* each put emits at most one 16-bit word (state invariant [2^16, 2^32));
* a symbol outside its table takes the escape bin followed by two raw
  16-bit words (its int32 bits, high half first in decode order);
* every lane flushes its final state as two words (low, then high).

A stream is per-lane words ``[K, cap]`` (the valid prefix of each row) and
``counts [K]``; the analytic container instead keeps the lanes compacted
into one flat stream read at per-lane offsets (``lane_offsets``).

Tensors: symbols, indexes, words and counts are int32 (a word is a value in
[0, 2^16)); the CDF tables are int32, the inverse table int16 and the
packed table int32 holding the bits of JAX's uint32 ``start << 16 | freq``;
the search table (``search_table``) is one int32 array.
The decoder's carry is ``(x, rp)``, int64 [K] each: the lane states (uint32
values) and the read pointers.

On CUDA tensors the lane loops run as the kernels of ``csrc/device_rans.cu``
(``coding/device_kernels.py``: D1 encodes with the packed table, D2 decodes
with the search table); on CPU tensors as the plain versions
here, the JAX scan body vectorised over lanes with a Python loop over
steps. The choice follows the tensors' device, never a failure. JAX's
``compact="gather"`` option (a TPU tuning knob; both formulations give the
same bits) is not ported: the plain encoder compacts by scatter and the
kernel writes each lane's words in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PROB_BITS = 16
RANS_L = 1 << 16
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF


class DeviceStream(NamedTuple):
    words: np.ndarray  # uint16 [K, cap] (valid prefix per lane)
    counts: np.ndarray  # int32 [K]
    n_symbols: int


class SearchTable(NamedTuple):
    """D2's table (``search_table``): one int32 array of three parts, which
    the kernel stages in shared memory where it fits."""

    layout: torch.Tensor  # int32 [n], n a multiple of 4 (numpy from search_table)
    buckets_at: int  # where the bucket index starts (int32 words)
    entries_at: int  # where the entries start (int32 words)
    shift: int  # a bucket spans 2^shift cf


class LaneTables(NamedTuple):
    """One set of coding tables on a device, in the lane coders' types."""

    cdf: torch.Tensor  # int32 [R, L]
    cdf_length: torch.Tensor  # int32 [R]
    offset: torch.Tensor  # int32 [R]
    inverse: torch.Tensor  # int16 [R, 2^16] (the plain decoder's)
    packed: torch.Tensor  # int32 [R, L]
    search: SearchTable  # D2's


def build_inverse_table(cdf: np.ndarray, cdf_length: np.ndarray) -> np.ndarray:
    """Direct cf -> symbol lookup, uint16 [R, 2^16]: the decoder's binary
    search becomes one gather (8 MB for 64 rows)."""
    r = cdf.shape[0]
    inv = np.zeros((r, 1 << PROB_BITS), np.uint16)
    cfs = np.arange(1 << PROB_BITS, dtype=np.int64)
    for i in range(r):
        row = cdf[i, : int(cdf_length[i])].astype(np.int64)
        inv[i] = np.searchsorted(row, cfs, side="right") - 1
    return inv


def build_packed_table(cdf: np.ndarray, cdf_length: np.ndarray) -> np.ndarray:
    """(start << 16 | freq) uint32 [R, L]: one gather per encoded symbol."""
    cdf = cdf.astype(np.uint32)
    packed = np.zeros_like(cdf)
    packed[:, :-1] = (cdf[:, :-1] << 16) | (cdf[:, 1:] - cdf[:, :-1])
    return packed


BUCKET_BITS = 8  # D2's bucket index: 2^8 buckets a row, each 2^8 cf wide


def search_table(cdf: np.ndarray, cdf_length: np.ndarray, offset: np.ndarray) -> SearchTable:
    """D2's table, its layout an int32 numpy array [n] of three parts:

    * rows, int32 [R, 4]: where row r's entries and buckets start, its
      cdf_length and its offset;
    * the bucket index, uint16 [R, 2^BUCKET_BITS + 1] (two to an int32 word,
      low half first), from ``buckets_at``: bucket j of row r holds the last
      symbol s with cdf[r][s] <= j << shift, shift = 16 - BUCKET_BITS;
    * the entries, from ``entries_at``: row r's symbols s = 0 .. len - 2
      back to back, each ``start << 16 | freq`` as in the packed table,
      then zeros to a multiple of 4 words (the kernel copies 16 bytes at a
      time).

    The symbol with cf in bucket j is the last s in [bucket j, min(bucket
    j + 1, len - 2)] with start(s) <= cf: the inverse table's symbol, found
    by a short search (y's 64 rows: 106 KB of entries against the inverse
    table's 8 MB). Each row must be non-decreasing and reach 2^16 in its
    last entry only (every quantized CDF does: no bin is empty), else
    ValueError."""
    r = cdf.shape[0]
    lengths = np.asarray(cdf_length, np.int64)
    shift = PROB_BITS - BUCKET_BITS
    nb = (1 << BUCKET_BITS) + 1
    edges = np.arange(nb, dtype=np.int64) << shift
    buckets = np.zeros((r, nb), np.uint16)
    entries = []
    for i in range(r):
        row = cdf[i, : lengths[i]].astype(np.int64)
        if (lengths[i] < 2 or lengths[i] > 1 << 16 or row[0] < 0 or row[-2] >= 1 << PROB_BITS
                or row[-1] != 1 << PROB_BITS or (np.diff(row) < 0).any()):
            raise ValueError(f"row {i} of the table is not a CDF rising to 2^16 in its last "
                             f"of {lengths[i]} entries, which the D2 kernel needs")
        buckets[i] = np.searchsorted(row, edges, side="right") - 1
        entries.append((row[:-1] << 16) | np.diff(row))
    starts = np.concatenate([[0], np.cumsum(lengths - 1)[:-1]])
    rows = np.stack([starts, np.arange(r) * nb, lengths, np.asarray(offset, np.int64)], 1)
    buckets_at = 4 * r
    entries_at = buckets_at + -(-r * nb // 8) * 4
    n = entries_at + -(-int(starts[-1] + lengths[-1] - 1) // 4) * 4
    layout = np.zeros(n, np.uint32)
    layout[:buckets_at] = rows.reshape(-1).astype(np.int32).view(np.uint32)
    layout[buckets_at:entries_at].view(np.uint16)[: r * nb] = buckets.reshape(-1)
    flat = np.concatenate(entries)
    layout[entries_at:entries_at + flat.size] = flat
    return SearchTable(layout.view(np.int32), buckets_at, entries_at, shift)


def lane_tables(cdf, cdf_length, offset, device) -> LaneTables:
    """The tables of one CDF set (numpy) on ``device``, with the inverse,
    packed and search tables built from them."""
    t = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)  # noqa: E731
    inverse = build_inverse_table(cdf, cdf_length).astype(np.int16)
    packed = build_packed_table(cdf, cdf_length).view(np.int32)
    search = search_table(cdf, cdf_length, offset)
    return LaneTables(t(cdf, torch.int32), t(cdf_length, torch.int32), t(offset, torch.int32),
                      t(inverse, torch.int16), t(packed, torch.int32),
                      search._replace(layout=t(search.layout, torch.int32)))


def _kernels():
    from . import device_kernels

    return device_kernels


# ------------------------------- encode -------------------------------


def encode_interleaved(symbols, indexes, cdf, cdf_length, offset, k: int = 256,
                       cap: int | None = None, packed=None):
    """Encode int32 symbols under their table indexes. Returns (words int32
    [k, cap], counts int32 [k], overflow): ``cap`` bounds the words per lane
    (default: the worst case, 3 per step plus the flush) and overflow (a
    bool tensor) says a lane needed more; the caller retries with a bigger
    cap. On a CUDA tensor the packed table is required (kernel D1)."""
    symbols = symbols.reshape(-1).to(torch.int32)
    indexes = indexes.reshape(-1).to(torch.int32)
    n = symbols.numel()
    pad = (-n) % k
    if pad:
        symbols = torch.cat([symbols, offset[:1].to(torch.int32).expand(pad)])
        indexes = torch.cat([indexes, indexes.new_zeros(pad)])
    steps = symbols.numel() // k
    if cap is None:
        cap = steps * 3 + 2
    if symbols.is_cuda:
        if packed is None:
            raise ValueError("the CUDA lane encoder takes the packed table")
        words, counts = _kernels().encode_lanes(symbols, indexes, packed, cdf_length, offset,
                                                k, cap)
    else:
        words, counts = plain_encode_lanes(symbols, indexes, cdf, cdf_length, offset, k, cap,
                                           packed)
    return words, counts, (counts > cap).any()


def plain_encode_lanes(symbols, indexes, cdf, cdf_length, offset, k: int, cap: int,
                       packed=None):
    """Plain version of D1: (words int32 [k, cap], counts int32 [k]) of
    ``steps * k`` padded symbols; words past a lane's count are 0 and words
    past ``cap`` are dropped (the count keeps them)."""
    steps = symbols.numel() // k
    sym = symbols.reshape(steps, k).long()
    idx = indexes.reshape(steps, k).long()
    cdf, length, off = cdf.long(), cdf_length.long(), offset.long()
    x = torch.full((k,), RANS_L, dtype=torch.int64, device=symbols.device)
    ws, dos = [], []
    for s in range(steps - 1, -1, -1):
        sy, ix = sym[s], idx[s]
        max_value = length[ix] - 2
        val = sy - off[ix]
        esc = (val < 0) | (val >= max_value)
        raw = sy & MASK32
        w0 = x & MASK16
        x = torch.where(esc, ((x >> 16) << 16) | (raw & MASK16), x)
        w1 = x & MASK16
        x = torch.where(esc, ((x >> 16) << 16) | ((raw >> 16) & MASK16), x)
        val = torch.where(esc, max_value, val)
        if packed is not None:
            sf = packed[ix, val].long() & MASK32
            start, freq = sf >> 16, sf & MASK16
        else:
            start = cdf[ix, val]
            freq = cdf[ix, val + 1] - start
        need = x >= ((freq << 16) & MASK32)
        w2 = x & MASK16
        x = put(torch.where(need, x >> 16, x), start, freq)
        ws += [w0, w1, w2]
        dos += [esc, esc, need]
    return compact_lanes(torch.stack(ws), torch.stack(dos), x, cap)


def put(x, start, freq):
    """The encoder's state update after renormalisation (int64 holding uint32)."""
    return ((x // freq) << 16) | ((x % freq) + start)


def compact_lanes(ws, emitted, x, cap: int):
    """Per-lane words from a lane walk: ws [rows, k] words in emission order
    and ``emitted`` [rows, k] whether each was emitted, then the flush of the
    final states x (low, high). Returns (words int32 [k, cap], counts int32
    [k]); words past ``cap`` are dropped, the count keeps them."""
    k = x.numel()
    ones = torch.ones((2, k), dtype=torch.int64, device=x.device)
    ws = torch.cat([ws.long(), (x & MASK16)[None], ((x >> 16) & MASK16)[None]])
    dos = torch.cat([emitted.long(), ones])
    pos = torch.cumsum(dos, 0) - dos
    counts = pos[-1] + dos[-1]
    col = torch.where(dos > 0, pos.clamp(max=cap), cap)
    lanes = torch.arange(k, device=x.device).expand_as(col)
    buf = torch.zeros((k, cap + 1), dtype=torch.int64, device=x.device)
    buf[lanes.reshape(-1), col.reshape(-1)] = ws.reshape(-1)
    return buf[:, :cap].to(torch.int32).contiguous(), counts.to(torch.int32)


# ------------------------------- decode -------------------------------


def lane_base(words, k: int, lane_offsets):
    """Where lane j's word 0 lies in ``words.reshape(-1)``."""
    if lane_offsets is not None:
        return lane_offsets.long()
    return torch.arange(k, dtype=torch.int64, device=words.device) * words.shape[1]


def read_at(flat, base, rp):
    """Each lane's word at its read pointer (clamped into the stream, as
    JAX's gathers clamp)."""
    return flat[(base + rp.clamp(min=0)).clamp(max=flat.numel() - 1)].long()


def decoder_init(words, counts, offsets=None):
    """The decoder's carry (x, rp) from a stream: words int32 [k, cap], or
    a flat stream read at ``offsets[lane] + j`` (analytic_rans.compact_stream)."""
    k = counts.numel()
    flat = words.reshape(-1)
    base = lane_base(words, k, offsets)
    rp = counts.long() - 1
    hi = read_at(flat, base, rp)
    rp = rp - 1
    lo = read_at(flat, base, rp)
    return (hi << 16) | lo, rp - 1


def decode_segment(carry, words, indexes, cdf, cdf_length, offset, k: int, inverse=None,
                   packed=None, lane_offsets=None, search=None):
    """Decode len(indexes) symbols (a multiple of k), carrying the lanes'
    state: the channel-AR slice loop chains segments on the device. Returns
    (carry, symbols int32). With ``lane_offsets``, ``words`` is a flat
    compacted stream. On a CUDA tensor the search table is required (kernel
    D2) and the other tables are not read; on a CPU tensor the inverse and
    packed tables are used where given."""
    indexes = indexes.reshape(-1).to(torch.int32)
    x, rp = carry
    base = lane_base(words, k, lane_offsets)
    if indexes.is_cuda:
        if search is None:
            raise ValueError("the CUDA lane decoder takes the search table")
        x, rp = x.clone(), rp.clone()
        syms = _kernels().decode_lanes(x, rp, words, base, indexes, search, k)
        return (x, rp), syms
    return plain_decode_lanes((x, rp), words, base, indexes, cdf, cdf_length, offset, k,
                              inverse, packed)


def plain_decode_lanes(carry, words, base, indexes, cdf, cdf_length, offset, k: int,
                       inverse=None, packed=None):
    """Plain version of D2 (and the binary-search and cdf variants that JAX
    also has): ((x, rp), symbols int32)."""
    steps = indexes.numel() // k
    idx_g = indexes.reshape(steps, k).long()
    cdf, length, off = cdf.long(), cdf_length.long(), offset.long()
    search_iters = int(np.ceil(np.log2(cdf.shape[1]))) + 1
    flat = words.reshape(-1)
    x, rp = carry

    def get_bits16(x, rp, do):
        val = x & MASK16
        x2 = x >> 16
        need = x2 < RANS_L
        x2 = torch.where(need, (x2 << 16) | read_at(flat, base, rp), x2)
        rp2 = torch.where(need, rp - 1, rp)
        return torch.where(do, val, 0), torch.where(do, x2, x), torch.where(do, rp2, rp)

    out = []
    for t in range(steps):
        idx = idx_g[t]
        cf = x & MASK16
        if inverse is not None:
            s = inverse[idx, cf].long()
        else:
            lo = torch.zeros_like(idx)
            hi = length[idx] - 1
            for _ in range(search_iters):
                mid = (lo + hi + 1) >> 1
                go_right = cdf[idx, mid] <= cf
                lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid - 1)
            s = lo
        if packed is not None:
            sf = packed[idx, s].long() & MASK32
            start, freq = sf >> 16, sf & MASK16
        else:
            start = cdf[idx, s]
            freq = cdf[idx, s + 1] - start
        x = (freq * (x >> 16) + cf - start) & MASK32
        need = x < RANS_L
        x = torch.where(need, (x << 16) | read_at(flat, base, rp), x)
        rp = torch.where(need, rp - 1, rp)
        esc = s == length[idx] - 2
        hi16, x, rp = get_bits16(x, rp, esc)
        lo16, x, rp = get_bits16(x, rp, esc)
        raw = (hi16 << 16) | lo16
        raw = torch.where(raw >= 1 << 31, raw - (1 << 32), raw)
        out.append(torch.where(esc, raw, s + off[idx]))
    syms = torch.cat(out) if out else indexes.new_zeros(0).long()
    return (x, rp), syms.to(torch.int32)


def decode_interleaved(words, counts, indexes, cdf, cdf_length, offset, n: int,
                       k: int = 256, inverse=None, packed=None, lane_offsets=None, search=None):
    """Decode a whole stream: int32 [n]."""
    indexes = indexes.reshape(-1).to(torch.int32)
    pad = (-n) % k
    if pad:
        indexes = torch.cat([indexes, indexes.new_zeros(pad)])
    carry = decoder_init(words, counts, offsets=lane_offsets)
    _, syms = decode_segment(carry, words, indexes, cdf, cdf_length, offset, k,
                             inverse=inverse, packed=packed, lane_offsets=lane_offsets,
                             search=search)
    return syms[:n]
