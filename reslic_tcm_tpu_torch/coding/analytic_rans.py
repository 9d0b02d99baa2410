"""Analytic (table-free) Gaussian rANS coding on the device (port of
reslic_tcm_tpu/coding/analytic_rans.py).

The y stream's CDF boundaries come in closed form from the continuous
sigma, not from tables: bin s of nb = 2c + 1 bins (c = ceil(6 sigma),
capped at 511) covers the value s - c, and

    B(s) = min(max(floor((Phi((s - c - 0.5) / sigma) - G0) * scale_inv), 0), A) + s,
    B(nb) = 2^16,  G0 = Phi((-c - 0.5) / sigma),  A = 2^16 - nb,
    scale_inv = A / (Phi((c + 0.5) / sigma) - G0).

The "+ s" gives every bin a frequency of at least 1; symbols are clamped
to [-c, c] before coding (the encoder's y_hat uses the clamped symbols), so
the stream needs no escape. The state machine is device_rans.py's.

Bits: a stream decodes only where the decoder computes the same boundary
bits as the encoder, and the JAX package's streams come from XLA's float32
erf, which torch.erf does not reproduce (it differs on about two thirds of
float32 inputs, by up to 5 ulp). ``erf`` here is XLA's: clamp to
+-3.7439211627767994, then x * alpha(x^2) / beta(x^2) with both polynomials
evaluated by Horner, each step one fused multiply-add (``_fma32``: exact
in float64, with the one double-rounding case corrected), every other step
one correctly rounded float32 operation in the order of the JAX source.
The CUDA kernels write the same formula with ``__fmaf_rn`` and the
``__f*_rn`` intrinsics, so nothing is contracted that XLA does not.

Layouts:
* grouped (``encode_gaussian_grouped``, the codec's): the words lie in
  decode-read order (step by step, lane ascending within a step) in one flat
  stream, plus a [k, 2] header of the final states; the decoder keeps one
  pointer and hands each renormalising lane the next word by its rank among
  them;
* ragged (``encode_gaussian``, ``decode_gaussian*``): per-lane words as in
  device_rans.py. Plain versions only: no codec path uses them.

The port's coder functions take sigma and derive the per-symbol parameters
themselves (``coder_params``), where JAX's take the parameter dict. On CUDA
tensors the grouped lane loops run as kernels D3 and D4
(``coding/device_kernels.py``), on CPU tensors as the plain versions here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device_rans as dr

PROB_BITS = 16
M_TOTAL = 1 << PROB_BITS
RANS_L = 1 << 16
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF
CMAX = 511  # max one-sided support -> nb <= 1023, 11 search iterations
SIGMA_MULT = 6.0  # support radius = ceil(6 sigma)
SEARCH_ITERS = 11
SCALES_MIN = 0.11
SCALES_MAX = 256.0

# XLA's float32 erf (its ErfImpl32): the clamp and the two polynomials in x^2
ERF_CLAMP = float(np.float32(3.7439211627767994))
ERF_ALPHA = tuple(float(np.float32(a)) for a in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084))
ERF_BETA = tuple(float(np.float32(b)) for b in (
    -1.1791602954361697e-7, 2.3547966471313185e-05, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0))
SQRT_HALF = float(np.float32(0.7071067811865476))


def _kernels():
    from . import device_kernels

    return device_kernels


# ------------------------------ arithmetic ------------------------------


def _fma32(a, b, c: float):
    """fma(a, b, c) of a float32 tensor pair and a float32 constant, rounded
    once. The product is exact in float64 and the sum is rounded there
    once; the float32 rounding of that can differ from the fused one only
    when the float64 sum is a float32 midpoint, where it is moved one
    float64 step toward the exact sum (TwoSum gives the side)."""
    p = a.double() * b.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    toward = torch.copysign(torch.full_like(s, float("inf")), e)
    s = torch.where(tie & (e != 0), torch.nextafter(s, toward), s)
    return s.float()


def erf(x):
    """XLA's float32 erf, bit for bit (float32 in and out)."""
    x = x.float().clamp(-ERF_CLAMP, ERF_CLAMP)
    x2 = x * x
    p = torch.full_like(x2, ERF_ALPHA[0])
    for c in ERF_ALPHA[1:]:
        p = _fma32(p, x2, c)
    q = torch.full_like(x2, ERF_BETA[0])
    for c in ERF_BETA[1:]:
        q = _fma32(q, x2, c)
    return (x * p) / q


def _phi(z):
    return (erf(z * SQRT_HALF) + 1.0) * 0.5


def support(sigma):
    """The support radius c (int32): min(ceil(6 sigma), 511) of the clamped sigma."""
    sigma = sigma.float().clamp(SCALES_MIN, SCALES_MAX)
    return torch.clamp(torch.ceil(sigma * SIGMA_MULT), max=float(CMAX)).to(torch.int32)


def coder_params(sigma, scales_min: float = SCALES_MIN, scales_max: float = SCALES_MAX) -> dict:
    """Per-symbol coding parameters of continuous sigma, shaped like it: c
    (int32 support radius), nb (int32 bins), coff (c + 0.5), inv_sigma, g0,
    scale_inv and a (the float32 bin budget 2^16 - nb)."""
    sigma = sigma.float().clamp(scales_min, scales_max)
    c = torch.clamp(torch.ceil(sigma * SIGMA_MULT), max=float(CMAX)).to(torch.int32)
    nb = 2 * c + 1
    coff = c.float() + 0.5
    inv_sigma = torch.ones_like(sigma) / sigma
    g0 = _phi(-coff * inv_sigma)
    g1 = _phi(coff * inv_sigma)
    a = (M_TOTAL - nb).float()
    scale_inv = a / (g1 - g0)
    return {"c": c, "nb": nb, "coff": coff, "inv_sigma": inv_sigma, "g0": g0,
            "scale_inv": scale_inv, "a": a}


def _boundary(s, p):
    """B(s) for bins s in [0, nb] (int64); B(nb) == 2^16 exactly. Shared by
    the encoder and the decoder, so both compute the same bits."""
    d = _phi((s.float() - p["coff"]) * p["inv_sigma"]) - p["g0"]
    raw = torch.floor(d * p["scale_inv"])
    raw = torch.minimum(raw, p["a"]).clamp(min=0.0)
    b = raw.long() + s.long()
    return torch.where(s >= p["nb"], M_TOTAL, b)


def clamp_symbols(sym, c):
    return torch.maximum(torch.minimum(sym, c), -c)


def _start_freq(symbols, p):
    s_all = symbols.long() + p["c"].long()
    start = _boundary(s_all, p)
    return start, _boundary(s_all + 1, p) - start


def _decode_step(x, p):
    """One decode step of k lanes before renormalisation: the bin s, the last
    with B(s) <= cf (11 halvings of [0, nb - 1]), and the updated states."""
    cf = x & MASK16
    lo = torch.zeros_like(x)
    hi = p["nb"].long() - 1
    for _ in range(SEARCH_ITERS):
        mid = (lo + hi + 1) >> 1
        go_right = _boundary(mid, p) <= cf
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid - 1)
    start = _boundary(lo, p)
    freq = _boundary(lo + 1, p) - start
    return lo, (freq * (x >> 16) + cf - start) & MASK32


def _step_params(p: dict, steps: int, k: int) -> dict:
    return {key: v.reshape(steps, k) for key, v in p.items()}


# ---------------------------- grouped layout ----------------------------


def encode_gaussian_lanes(symbols, sigma, k: int):
    """The lanes' reverse walk: (ws int32 [steps, k], need bool [steps, k],
    x int64 [k]) with ws[t, j] the low word of lane j's state before step t
    and need[t, j] whether it was emitted. Kernel D3 on CUDA tensors."""
    symbols = symbols.reshape(-1).to(torch.int32)
    sigma = sigma.reshape(-1).float()
    if symbols.numel() % k:
        raise ValueError(f"{symbols.numel()} symbols do not fill lanes of {k}")
    if symbols.is_cuda:
        return _kernels().gaussian_encode_lanes(symbols, sigma, k)
    return plain_encode_gaussian_lanes(symbols, sigma, k)


def plain_encode_gaussian_lanes(symbols, sigma, k: int):
    """Plain version of D3."""
    steps = symbols.numel() // k
    start, freq = _start_freq(symbols, coder_params(sigma))
    start, freq = start.reshape(steps, k), freq.reshape(steps, k)
    x = torch.full((k,), RANS_L, dtype=torch.int64, device=symbols.device)
    ws = torch.empty((steps, k), dtype=torch.int64, device=symbols.device)
    need = torch.empty((steps, k), dtype=torch.bool, device=symbols.device)
    for t in range(steps - 1, -1, -1):
        nd = x >= (freq[t] << 16)
        ws[t], need[t] = x & MASK16, nd
        x = dr.put(torch.where(nd, x >> 16, x), start[t], freq[t])
    return ws.to(torch.int32), need, x


def compact_grouped(ws, need, x, cap: int):
    """The grouped stream of the lanes' walk: (header int32 [k, 2] (final
    states, low and high half), flat int32 [cap] (the emitted words in
    decode-read order, zeros after them), total (words used), overflow)."""
    flatn = need.reshape(-1).long()
    pos = torch.cumsum(flatn, 0) - flatn
    total = pos[-1] + flatn[-1]
    dest = torch.where(flatn > 0, pos.clamp(max=cap), cap)
    flat = torch.zeros(cap + 1, dtype=torch.int32, device=ws.device)
    flat.scatter_(0, dest, ws.reshape(-1))
    header = torch.stack([x & MASK16, x >> 16], dim=-1).to(torch.int32)
    return header, flat[:cap], total, total > cap


def encode_gaussian_grouped(symbols, sigma, k: int = 1024, cap: int | None = None):
    """Encode clamped symbols under the analytic boundaries of sigma into
    the grouped layout: (header, flat, total, overflow) as
    ``compact_grouped``; ``cap`` defaults to one word per symbol."""
    if cap is None:
        cap = symbols.numel()
    return compact_grouped(*encode_gaussian_lanes(symbols, sigma, k), cap)


def decode_gaussian_grouped_init(header):
    x = (header[:, 1].long() << 16) | header[:, 0].long()
    return x, torch.zeros((), dtype=torch.int64, device=header.device)


def decode_gaussian_grouped_segment(carry, flat, sigma, k: int):
    """Decode len(sigma) symbols (a multiple of k), chaining (states, stream
    pointer). Each step reads the k words after the pointer (the window's
    start clamped to len(flat) - k, as XLA's dynamic_slice does), so a stream
    needs k words of headroom. Returns (carry, values int32). Kernel D4 on
    CUDA tensors."""
    sigma = sigma.reshape(-1).float()
    if sigma.numel() % k or flat.numel() < k:
        raise ValueError(f"{sigma.numel()} symbols in lanes of {k} from {flat.numel()} words")
    x, g = carry
    if sigma.is_cuda:
        x, g = x.clone(), g.clone()
        vals = _kernels().gaussian_decode_lanes(x, g, flat, sigma, k)
        return (x, g), vals
    return plain_decode_gaussian_lanes((x, g), flat, sigma, k)


def plain_decode_gaussian_lanes(carry, flat, sigma, k: int):
    """Plain version of D4."""
    steps = sigma.numel() // k
    p = _step_params(coder_params(sigma), steps, k)
    flat = flat.long()
    x, g = carry
    vals = []
    for t in range(steps):
        pt = {key: v[t] for key, v in p.items()}
        s, x = _decode_step(x, pt)
        need = (x < RANS_L).long()
        rank = torch.cumsum(need, 0) - need
        w = flat[(g.clamp(max=flat.numel() - k)).clamp(min=0) + rank]
        x = torch.where(need > 0, (x << 16) | w, x)
        g = g + need.sum()
        vals.append(s - pt["c"].long())
    out = torch.cat(vals) if vals else torch.zeros(0, dtype=torch.int64, device=x.device)
    return (x, g), out.to(torch.int32)


def decode_gaussian_grouped(header, flat, sigma, k: int):
    _, vals = decode_gaussian_grouped_segment(decode_gaussian_grouped_init(header), flat,
                                              sigma, k)
    return vals


# ----------------------------- ragged layout -----------------------------


def encode_gaussian(symbols, sigma, k: int = 1024, cap: int | None = None):
    """Encode clamped symbols into per-lane words: (words int32 [k, cap],
    counts int32 [k], overflow). Plain version only."""
    n = symbols.numel()
    if n % k:
        raise ValueError(f"{n} symbols do not fill lanes of {k}")
    steps = n // k
    if cap is None:
        cap = steps + 2
    ws, need, x = plain_encode_gaussian_lanes(symbols.reshape(-1).to(torch.int32),
                                              sigma.reshape(-1).float(), k)
    # the words leave in encode order: steps reversed
    words, counts = dr.compact_lanes(ws.flip(0), need.flip(0), x, cap)
    return words, counts, (counts > cap).any()


def compact_stream(buf, counts, flat_cap: int):
    """The per-lane words [k, cap] as one flat stream of ``flat_cap`` words
    (lane after lane, zeros after the last): (flat int32, overflow). Read it
    at ``lane_offsets(counts)[lane] + j``."""
    k, cap = buf.shape
    csum = torch.cumsum(counts.long(), 0)
    total = csum[-1]
    p = torch.arange(flat_cap, dtype=torch.int64, device=buf.device)
    lane = torch.searchsorted(csum, p + 1, side="left").clamp(max=k - 1)
    col = (p - (csum[lane] - counts.long()[lane])).clamp(0, cap - 1)
    flat = torch.where(p < total, buf[lane, col], 0).to(torch.int32)
    return flat, total > flat_cap


def lane_offsets(counts):
    return (torch.cumsum(counts.long(), 0) - counts.long()).to(torch.int32)


def decode_gaussian_segment(carry, words, sigma, k: int, offsets=None):
    """Decode len(sigma) symbols from per-lane words (or a flat stream at
    ``offsets``), chaining the carry of ``device_rans.decoder_init``.
    Returns (carry, values int32). Plain version only."""
    sigma = sigma.reshape(-1).float()
    steps = sigma.numel() // k
    p = _step_params(coder_params(sigma), steps, k)
    flat = words.reshape(-1)
    base = dr.lane_base(words, k, offsets)
    x, rp = carry
    vals = []
    for t in range(steps):
        pt = {key: v[t] for key, v in p.items()}
        s, x = _decode_step(x, pt)
        need = x < RANS_L
        x = torch.where(need, (x << 16) | dr.read_at(flat, base, rp), x)
        rp = torch.where(need, rp - 1, rp)
        vals.append(s - pt["c"].long())
    out = torch.cat(vals) if vals else torch.zeros(0, dtype=torch.int64, device=x.device)
    return (x, rp), out.to(torch.int32)


def decode_gaussian(words, counts, sigma, k: int, offsets=None):
    carry = dr.decoder_init(words, counts, offsets=offsets)
    _, vals = decode_gaussian_segment(carry, words, sigma, k, offsets=offsets)
    return vals
