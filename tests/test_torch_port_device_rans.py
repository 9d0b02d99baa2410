"""The port's device coders (reslic_tcm_tpu_torch/coding/device_rans.py and
analytic_rans.py) against the JAX package's on the CPU, at the coder level.

Everything here is exact: the same inputs must give the same words, counts,
headers, totals, symbols and carries, bit for bit. The analytic coder's
boundaries come from XLA's float32 erf, so the port's erf and per-symbol
parameters are held to zero ulp. JAX's streams come from its jitted coder
functions; its numpy oracles are a second reference at k=8. The CUDA
kernels D1-D4 behind these functions run only on the card
(tests/test_torch_port_cuda.py holds them against the plain versions here).

Inputs come from numpy seeds: Gaussian symbols with log-uniform sigma over
[0.05, 300] (the coder's whole support range, clamped), and six random CDF
tables whose symbols escape on purpose (out-of-range values and int32
extremes), n <= 16384 and k <= 128.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.coding import analytic_rans as JA
from reslic_tcm_tpu.coding import device_rans as JD
from reslic_tcm_tpu_torch.coding import analytic_rans as PA
from reslic_tcm_tpu_torch.coding import device_kernels as PK
from reslic_tcm_tpu_torch.coding import device_rans as PD
from tests.torch_port_inputs import coder_symbols, coder_tables, gaussian_inputs
from torch_port_threads import one_torch_thread  # noqa: E402,F401

K = 128
N = 128 * 128  # 16384 symbols: 128 steps of 128 lanes


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, want) -> None:
    """Exact equality of a port tensor and a JAX or numpy array."""
    got = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.size} differ"


def _sigmas(rng, n):
    return np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)


@pytest.fixture(scope="module")
def gaussian():
    """(clamped symbols int32 [N], sigma float32 [N])."""
    sigma, sym = gaussian_inputs(11, N)
    c = np.asarray(JA.coder_params(jnp.asarray(sigma))["c"])
    return np.clip(sym, -c, c).astype(np.int32), sigma


@pytest.fixture(scope="module")
def tables():
    """Six CDF rows of 5-20 bins (cdf, cdf_length, offset), int32."""
    return coder_tables(12)


_table_symbols = coder_symbols


def _port_tables(tables):
    return PD.lane_tables(*tables, "cpu")


# ------------------------------- erf and bins -------------------------------


def test_erf_matches_xla_bit_for_bit():
    """10^6 float32 values: uniform over [-6, 6] and log-uniform magnitudes
    over [1e-6, 6] of both signs; zero ulp against jax.lax.erf."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-6.0, 6.0, 500_000),
        np.where(rng.uniform(size=500_000) < 0.5, -1.0, 1.0)
        * np.exp(rng.uniform(np.log(1e-6), np.log(6.0), 500_000)),
    ]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf)(jnp.asarray(x)))
    got = PA.erf(_t(x)).numpy()
    assert int((got.view(np.int32) != want.view(np.int32)).sum()) == 0


def test_coder_params_and_boundaries_match_jax():
    """coder_params on 10^5 sigmas over [0.05, 300] (all seven fields), and
    B(s) at every bin edge s in [0, nb] of 2,000 of them; exact."""
    rng = np.random.default_rng(1)
    sigma = _sigmas(rng, 100_000)
    got, want = PA.coder_params(_t(sigma)), jax.jit(JA.coder_params)(jnp.asarray(sigma))
    assert set(got) == set(want)
    for key in want:
        _eq(got[key].view(torch.int32) if got[key].is_floating_point() else got[key],
            np.asarray(want[key]).view(np.int32))
    few = sigma[:2000]
    nb = np.asarray(JA.coder_params(jnp.asarray(few))["nb"])
    rows = np.repeat(np.arange(few.size), nb + 1)
    s = np.concatenate([np.arange(b + 1) for b in nb]).astype(np.int32)
    want_b = jax.jit(lambda s, sg: JA._boundary(s, JA.coder_params(sg)))(
        jnp.asarray(s), jnp.asarray(few[rows]))
    _eq(PA._boundary(_t(s), PA.coder_params(_t(few[rows]))), want_b)
    assert s.size > 100_000


def test_support_is_coder_params_c():
    sigma = _sigmas(np.random.default_rng(2), 10_000)
    assert torch.equal(PA.support(_t(sigma)), PA.coder_params(_t(sigma))["c"])


# ------------------------------- grouped layout -------------------------------


@pytest.fixture(scope="module")
def grouped(gaussian):
    """JAX's grouped stream of the Gaussian symbols: (header, flat, total)."""
    sym, sigma = gaussian
    enc = jax.jit(lambda s, sg: JA.encode_gaussian_grouped(s, JA.coder_params(sg), k=K, cap=N))
    header, flat, total, ovf = enc(jnp.asarray(sym), jnp.asarray(sigma))
    assert not bool(ovf)
    return np.asarray(header), np.asarray(flat), int(total)


def test_grouped_encoder_matches_jax(gaussian, grouped):
    sym, sigma = gaussian
    header, flat, total, ovf = PA.encode_gaussian_grouped(_t(sym), _t(sigma), k=K, cap=N)
    _eq(header, grouped[0])
    _eq(flat, grouped[1])
    assert int(total) == grouped[2] and not bool(ovf)
    # a cap below the total overflows, as JAX's does
    *_, ovf_small = PA.encode_gaussian_grouped(_t(sym), _t(sigma), k=K, cap=grouped[2] - 1)
    assert bool(ovf_small)


def test_grouped_decoder_chained_over_four_segments_matches_jax(gaussian, grouped):
    """Decode JAX's stream in four segments: the port's values are the
    symbols, and after each segment its carry equals JAX's carry."""
    sym, sigma = gaussian
    header, flat, _ = grouped
    flat = np.concatenate([flat, np.zeros(K, np.uint16)])
    seg = jax.jit(lambda c, f, sg: JA.decode_gaussian_grouped_segment(
        c, f, JA.coder_params(sg), K))
    jcarry = JA.decode_gaussian_grouped_init(jnp.asarray(header))
    carry = PA.decode_gaussian_grouped_init(_t(header.astype(np.int32)))
    flat_t = _t(flat.astype(np.int32))
    for part in np.split(np.arange(N), 4):
        jcarry, jvals = seg(jcarry, jnp.asarray(flat), jnp.asarray(sigma[part]))
        carry, vals = PA.decode_gaussian_grouped_segment(carry, flat_t, _t(sigma[part]), K)
        _eq(vals, jvals)
        _eq(vals, sym[part])
        _eq(carry[0], jcarry[0])
        assert int(carry[1]) == int(jcarry[1])
    _eq(PA.decode_gaussian_grouped(_t(header.astype(np.int32)), flat_t, _t(sigma), K), sym)


@pytest.mark.parametrize("k", [8193, 16384])
def test_grouped_decoder_beyond_8192_lanes_matches_jax(k):
    """At more lanes than D4 once took (8192), three steps of JAX's grouped
    stream decoded one segment a step: the port's values are the symbols,
    and its carry equals JAX's after each segment. The kernel has a
    cluster for such k (csrc/device_rans.cu; tests/test_torch_port_cuda.py
    holds it to this plain version on the card)."""
    sigma, sym = gaussian_inputs(13, 3 * k)
    c = np.asarray(JA.coder_params(jnp.asarray(sigma))["c"])
    sym = np.clip(sym, -c, c).astype(np.int32)
    header, flat, total, ovf = jax.jit(lambda s, sg: JA.encode_gaussian_grouped(
        s, JA.coder_params(sg), k=k, cap=3 * k))(jnp.asarray(sym), jnp.asarray(sigma))
    assert not bool(ovf)
    flat = np.concatenate([np.asarray(flat), np.zeros(k, np.uint16)])
    seg = jax.jit(lambda c, f, sg: JA.decode_gaussian_grouped_segment(
        c, f, JA.coder_params(sg), k))
    jcarry = JA.decode_gaussian_grouped_init(header)
    carry = PA.decode_gaussian_grouped_init(_t(np.asarray(header).astype(np.int32)))
    flat_t = _t(flat.astype(np.int32))
    for part in np.split(np.arange(3 * k), 3):
        jcarry, jvals = seg(jcarry, jnp.asarray(flat), jnp.asarray(sigma[part]))
        carry, vals = PA.decode_gaussian_grouped_segment(carry, flat_t, _t(sigma[part]), k)
        _eq(vals, jvals)
        _eq(vals, sym[part])
        _eq(carry[0], jcarry[0])
        assert int(carry[1]) == int(jcarry[1])
    assert PK.decode_clusters(k) == list(PK.DECODE_CLUSTERS)


# ------------------------------- table coder -------------------------------


@pytest.mark.parametrize("k,cap", [(K, None), (32, None), (K, 40)])
def test_interleaved_encoder_matches_jax(tables, k, cap):
    """Words, counts and overflow with escapes forced, from the cdf and from
    the packed table, against JAX's; n = 16,384 + 5 (a padded last step)."""
    sym, idx = _table_symbols(3, N + 5, tables[0].shape[0])
    pt = _port_tables(tables)
    jt = [jnp.asarray(a) for a in tables]
    jenc = jax.jit(lambda s, i, p: JD.encode_interleaved(s, i, *jt, k=k, cap=cap, packed=p))
    jw, jc, jovf = jenc(jnp.asarray(sym), jnp.asarray(idx),
                        jnp.asarray(JD.build_packed_table(*tables[:2])))
    for packed in (None, pt.packed):
        w, c, ovf = PD.encode_interleaved(_t(sym), _t(idx), pt.cdf, pt.cdf_length, pt.offset,
                                          k=k, cap=cap, packed=packed)
        _eq(w, jw)
        _eq(c, jc)
        assert bool(ovf) == bool(jovf)
    assert bool(jovf) == (cap is not None)


@pytest.mark.parametrize("inverse,packed", [(False, False), (True, False), (True, True),
                                            (False, True)])
def test_decode_segment_matches_jax(tables, inverse, packed):
    """JAX's stream decoded in four chained segments, with and without the
    inverse and packed tables: symbols and carries equal JAX's."""
    sym, idx = _table_symbols(4, N, tables[0].shape[0])
    pt = _port_tables(tables)
    jt = [jnp.asarray(a) for a in tables]
    jw, jc, _ = jax.jit(lambda s, i: JD.encode_interleaved(s, i, *jt, k=K))(
        jnp.asarray(sym), jnp.asarray(idx))
    j_inv = jnp.asarray(JD.build_inverse_table(*tables[:2])) if inverse else None
    j_pk = jnp.asarray(JD.build_packed_table(*tables[:2])) if packed else None
    seg = jax.jit(lambda c, w, i: JD.decode_segment(c, w, i, *jt, k=K, inverse=j_inv,
                                                    packed=j_pk))
    jcarry = JD.decoder_init(jw, jc)
    words = _t(np.asarray(jw).astype(np.int32))
    carry = PD.decoder_init(words, _t(jc))
    _eq(carry[0], jcarry[0])
    for part in np.split(np.arange(N), 4):
        jcarry, jsyms = seg(jcarry, jw, jnp.asarray(idx[part]))
        carry, syms = PD.decode_segment(carry, words, _t(idx[part]), pt.cdf, pt.cdf_length,
                                        pt.offset, K, inverse=pt.inverse if inverse else None,
                                        packed=pt.packed if packed else None)
        _eq(syms, jsyms)
        _eq(syms, sym[part])
        _eq(carry[0], jcarry[0])
        _eq(carry[1], jcarry[1])


def test_compact_stream_and_lane_offsets_match_jax(tables):
    """The per-lane words of a stream as one flat stream (with room to
    spare and too little), its lane offsets, and the flat stream decoded."""
    sym, idx = _table_symbols(5, 4096, tables[0].shape[0])
    pt = _port_tables(tables)
    w, c, _ = PD.encode_interleaved(_t(sym), _t(idx), pt.cdf, pt.cdf_length, pt.offset, k=64)
    jw, jc = jnp.asarray(w.numpy().astype(np.uint16)), jnp.asarray(c.numpy())
    total = int(c.sum())
    for flat_cap in (total + 100, total - 1):
        flat, ovf = PA.compact_stream(w, c, flat_cap)
        jflat, jovf = jax.jit(lambda b, n: JA.compact_stream(b, n, flat_cap))(jw, jc)
        _eq(flat, jflat)
        assert bool(ovf) == bool(jovf) == (flat_cap < total)
    offsets = PA.lane_offsets(c)
    _eq(offsets, JA.lane_offsets(jc))
    flat, _ = PA.compact_stream(w, c, total + 100)
    got = PD.decode_interleaved(flat, c, _t(idx), pt.cdf, pt.cdf_length, pt.offset, n=4096,
                                k=64, inverse=pt.inverse, packed=pt.packed, lane_offsets=offsets)
    _eq(got, sym)


# ------------------------------- ragged layout -------------------------------


def test_ragged_analytic_functions_match_jax(gaussian):
    """encode_gaussian's words and counts; decode_gaussian from the per-lane
    words and from their flat compaction, in two chained segments."""
    sym, sigma = gaussian
    sym, sigma = sym[:8192], sigma[:8192]
    jw, jc, jovf = jax.jit(lambda s, sg: JA.encode_gaussian(s, JA.coder_params(sg), k=K))(
        jnp.asarray(sym), jnp.asarray(sigma))
    w, c, ovf = PA.encode_gaussian(_t(sym), _t(sigma), k=K)
    _eq(w, jw)
    _eq(c, jc)
    assert not bool(ovf) and not bool(jovf)
    seg = jax.jit(lambda cr, ww, sg, off: JA.decode_gaussian_segment(
        cr, ww, JA.coder_params(sg), K, offsets=off))
    flat, _ = PA.compact_stream(w, c, int(c.sum()))
    for words, offsets in ((w, None), (flat, PA.lane_offsets(c))):
        jwords = jnp.asarray(words.numpy().astype(np.uint16))
        joff = None if offsets is None else jnp.asarray(offsets.numpy())
        jcarry = JD.decoder_init(jwords, jc, offsets=joff)
        carry = PD.decoder_init(words, c, offsets=offsets)
        for part in np.split(np.arange(8192), 2):
            jcarry, jvals = seg(jcarry, jwords, jnp.asarray(sigma[part]), joff)
            carry, vals = PA.decode_gaussian_segment(carry, words, _t(sigma[part]), K,
                                                     offsets=offsets)
            _eq(vals, jvals)
            _eq(vals, sym[part])
            _eq(carry[0], jcarry[0])
        _eq(PA.decode_gaussian(words, c, _t(sigma), K, offsets=offsets), sym)


# ------------------------------- numpy oracles -------------------------------


def test_numpy_oracles_at_k8(gaussian, tables, monkeypatch):
    """JAX's slow numpy references at k=8: the same words and counts, and
    each decodes the other's streams. The analytic oracle takes its erf from
    scipy, not XLA's (their bits differ, and so do the streams), so the
    port's coder runs on scipy's erf for that comparison: it holds the
    layout and the state machine, the erf tests above hold the bits."""
    import scipy.special

    sym, sigma = gaussian
    sym, sigma = sym[:512], sigma[:512]
    words, counts, _ = JA.encode_gaussian_np(sym, sigma, k=8)
    with monkeypatch.context() as m:
        m.setattr(PA, "erf", lambda x: torch.from_numpy(
            np.asarray(scipy.special.erf(x.numpy()), np.float32)))
        w, c, _ = PA.encode_gaussian(_t(sym), _t(sigma), k=8)
        _eq(c, counts)
        _eq(w[:, :words.shape[1]], words)
        _eq(PA.decode_gaussian(_t(words.astype(np.int32)), _t(counts), _t(sigma), 8), sym)
    _eq(JA.decode_gaussian_np(w.numpy(), c.numpy(), sigma, k=8), sym)

    tsym, tidx = _table_symbols(6, 1003, tables[0].shape[0])
    pt = _port_tables(tables)
    stream = JD.encode_interleaved_np(tsym, tidx, *tables, k=8)
    w, c, _ = PD.encode_interleaved(_t(tsym), _t(tidx), pt.cdf, pt.cdf_length, pt.offset, k=8)
    _eq(c, stream.counts)
    _eq(w[:, :stream.words.shape[1]], stream.words)
    got = PD.decode_interleaved(_t(stream.words.astype(np.int32)), _t(stream.counts),
                                _t(tidx), pt.cdf, pt.cdf_length, pt.offset, n=1003, k=8,
                                inverse=pt.inverse, packed=pt.packed)
    _eq(got, tsym)
    _eq(JD.decode_interleaved_np(PD.DeviceStream(w.numpy(), c.numpy(), 1003), tidx, *tables,
                                 k=8), tsym)


def test_port_tables_equal_jax_tables(tables):
    pt = _port_tables(tables)
    _eq(pt.inverse, JD.build_inverse_table(*tables[:2]).astype(np.int16))
    _eq(pt.packed, JD.build_packed_table(*tables[:2]).view(np.int32))
    np.testing.assert_array_equal(PD.build_inverse_table(*tables[:2]),
                                  JD.build_inverse_table(*tables[:2]))


# ------------------------------- the wrappers -------------------------------


def test_lane_kernels_refuse_cpu_tensors(gaussian, tables):
    """The kernel wrappers take CUDA tensors only; the coder functions run
    the plain versions for CPU tensors and never reach them."""
    sym, sigma = gaussian
    pt = _port_tables(tables)
    s, sg = _t(sym[:K]), _t(sigma[:K])
    x, rp = torch.zeros(K, dtype=torch.int64), torch.zeros(K, dtype=torch.int64)
    calls = [
        lambda: PK.encode_lanes(s, s, pt.packed, pt.cdf_length, pt.offset, K, 8),
        lambda: PK.decode_lanes(x, rp, s, rp, s, pt.search, K),
        lambda: PK.gaussian_encode_lanes(s, sg, K),
        lambda: PK.gaussian_decode_lanes(x, torch.zeros((), dtype=torch.int64), s, sg, K),
    ]
    before = PK.launch_counts()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert PK.launch_counts() == before
    assert set(PK.REPLACES) == set(before)
