"""What the analytic decoder's search (kernel D4, csrc/device_rans.cu) rests
on, checked on the CPU with the port's plain boundaries
(``analytic_rans._boundary``, bit for bit XLA's; tests/
test_torch_port_device_rans.py holds them to JAX's).

D4 finds a symbol's bin by halvings that stop when the bin is found, where
the JAX coder (and ``analytic_rans._decode_step``) runs 11 of them. Both
return the last bin s with B(s) <= cf, and so the same bin, because B is
non-decreasing in s. It is not strictly increasing: float32 Phi rounds
non-monotonically near 1, so in the upper tail raw(s) can drop by one where
"+ s" adds one, and B(s + 1) == B(s): a bin of width zero, which the JAX
encoder cannot code (it divides by freq = 0) and the decoder never returns.

Sigma: a log grid over the coder's range [0.11, 256] and uniform draws,
about 1.8 million boundaries in all (well under a second).
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.coding import analytic_rans as JA
from reslic_tcm_tpu_torch.coding import analytic_rans as ar
from reslic_tcm_tpu_torch.coding import device_kernels as dk
from torch_port_threads import one_torch_thread  # noqa: E402,F401

CU = os.path.join(os.path.dirname(ar.__file__), os.pardir, "csrc", "device_rans.cu")


@pytest.fixture(scope="module")
def grid():
    """(sigma float32 [n], nb int64 [n], B int64 [n, 1024]: B(s) for s in
    [0, nb], then 2^16)."""
    rng = np.random.default_rng(7)
    sigma = np.concatenate([np.exp(np.linspace(np.log(0.11), np.log(256.0), 3072)),
                            rng.uniform(0.11, 256.0, 1024)]).astype(np.float32)
    p = ar.coder_params(torch.from_numpy(sigma))
    nb = p["nb"].long()
    rows = torch.repeat_interleave(torch.arange(len(sigma)), nb + 1)
    s = torch.arange(rows.numel()) - (torch.cumsum(nb + 1, 0) - (nb + 1))[rows]
    table = torch.full((len(sigma), 2 * ar.CMAX + 2), ar.M_TOTAL, dtype=torch.int64)
    table[rows, s] = ar._boundary(s, {key: v[rows] for key, v in p.items()})
    return sigma, nb, table


def _zero_width(nb, table):
    """(rows, bins) of the bins s < nb with B(s + 1) == B(s)."""
    s = torch.arange(table.shape[1] - 1)
    flat = (table[:, 1:] == table[:, :-1]) & (s[None] < nb[:, None])
    return flat.nonzero(as_tuple=True)


def test_boundaries_are_non_decreasing_in_s(grid):
    sigma, nb, table = grid
    assert int(nb.min()) >= 3 and int(nb.max()) == 2 * ar.CMAX + 1
    assert bool((table[:, 0] == 0).all())
    assert bool((table[:, 1:] >= table[:, :-1]).all())
    # B(nb) == 2^16 and every bin below it ends at or under 2^16
    assert bool((table.gather(1, nb[:, None]) == ar.M_TOTAL).all())


def test_zero_width_bins_lie_in_the_upper_tail(grid):
    sigma, nb, table = grid
    rows, bins = _zero_width(nb, table)
    assert rows.numel() > 500
    c = (nb[rows] - 1) // 2
    # each at 0.83c or more above the centre bin c
    assert bool((bins - c >= 0.83 * c.double()).all())
    # sigma 9.120379 (nb 111): bins 102 and 103 share their start
    p = ar.coder_params(torch.tensor([9.120379], dtype=torch.float32))
    assert int(p["nb"]) == 111
    s = torch.arange(112)
    b = ar._boundary(s, {key: v.expand(112) for key, v in p.items()})
    assert [int(i) for i in torch.nonzero(b[1:] == b[:-1]).flatten()] == [102]


def test_a_symbol_in_a_zero_width_bin_cannot_be_coded():
    """Sigma 9.120379, symbol 47 (bin 102, c = 55): JAX's grouped coder
    decodes another value there, and the port's plain encoder refuses to
    divide by freq = 0. A reference quirk: the container stays JAX's."""
    k = 8
    sigma = np.full(4 * k, 9.120379, np.float32)
    sym = np.zeros(4 * k, np.int32)
    sym[3] = 47
    p = JA.coder_params(jnp.asarray(sigma))
    assert int(p["c"][0]) == 55
    header, flat, _, _ = JA.encode_gaussian_grouped(jnp.asarray(sym), p, k=k, cap=sym.size)
    vals = np.asarray(JA.decode_gaussian_grouped(
        header, jnp.concatenate([flat, jnp.zeros(k, flat.dtype)]), p, k))
    assert vals[3] != 47  # and the lane's later values go wrong with its state
    with pytest.raises(RuntimeError, match="ZeroDivision"):
        ar.plain_encode_gaussian_lanes(torch.from_numpy(sym), torch.from_numpy(sigma), k)


def _kernel_search(cf, nb, b_of):
    """The kernel's search for every lane at once: (bin, B(bin), B(bin +
    1), halvings), each halving at m = lo + ceil((hi - lo + 1) / 2) until
    lo == hi, start and freq from the values the halvings computed.
    ``b_of(lanes, m)``: B at points m of those lanes."""
    lo = torch.zeros_like(cf)
    hi = nb - 1
    b_lo = torch.zeros_like(cf)
    b_hi = torch.full_like(cf, ar.M_TOTAL)
    rounds = torch.zeros_like(cf)
    live = torch.arange(cf.numel())
    while live.numel():
        l_lo, l_hi = lo[live], hi[live]
        m = l_lo + (l_hi - l_lo + 2) // 2
        b = b_of(live, m)
        up = b <= cf[live]
        lo[live] = torch.where(up, m, l_lo)
        b_lo[live] = torch.where(up, b, b_lo[live])
        hi[live] = torch.where(up, l_hi, m - 1)
        b_hi[live] = torch.where(up, b_hi[live], b)
        rounds[live] += 1
        live = live[lo[live] < hi[live]]
    return lo, b_lo, b_hi, rounds


@pytest.fixture(scope="module")
def search_case(grid):
    """64 sigmas (48 from the log grid, 16 with zero-width bins) x all
    65,536 cf: (rows, cf, nb, the table, _decode_step's bin)."""
    sigma, nb, table = grid
    zero_rows = torch.unique(_zero_width(nb, table)[0])
    pick = torch.cat([torch.linspace(0, 3071, 48).long(),
                      zero_rows[torch.linspace(0, zero_rows.numel() - 1, 16).long()]])
    rows = pick.repeat_interleave(1 << 16)
    cf = torch.arange(1 << 16, dtype=torch.int64).repeat(len(pick))
    lane_nb = nb[rows]

    def lookup(s, p):
        return table[p["row"], s]

    real = ar._boundary
    ar._boundary = lookup  # _decode_step's 11 halvings over the same boundaries
    try:
        want, _ = ar._decode_step(cf | (1 << 16), {"nb": lane_nb, "row": rows})
    finally:
        ar._boundary = real
    return rows, cf, lane_nb, table, want


def test_kernel_search_finds_decode_steps_bin(search_case):
    rows, cf, nb, table, want = search_case
    table32, cf, nb = table.int(), cf.int(), nb.int()
    got, b_lo, b_hi, rounds = _kernel_search(cf, nb, lambda live, m: table32[rows[live], m])
    assert torch.equal(got.long(), want)
    assert torch.equal(b_lo, table32[rows, got]) and torch.equal(b_hi, table32[rows, got + 1])
    assert bool((b_lo <= cf).all() and (cf < b_hi).all())
    # ceil(log2 nb) halvings at most (JAX runs 11 at every nb)
    bound = torch.ceil(torch.log2(nb.double()) - 1e-9).long()
    assert bool((rounds <= bound).all())
    assert int(rounds.min()) == 1 and int(rounds.max()) == 10


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 8, 15, 16, 96, 1000, 1024, 2048, 4096, 8192,
                               8193, 12288, 16384, 16385, 65536, 100000, 131072, 131073, 10**6])
def test_decode_cluster_fits_one_cta_each(k):
    """Every k >= 1 gets a cluster: every size up to k, each CTA within 1024
    threads, a thread a lane where the CTA's lanes fit, else the fewest
    lanes a thread that fit (kept in memory)."""
    clusters = dk.decode_clusters(k)
    assert clusters and dk.decode_cluster(k) == max(clusters)
    assert clusters == [c for c in dk.DECODE_CLUSTERS if c <= k]
    for c in clusters:
        per_cta, lanes = -(-k // c), dk.decode_lanes_per_thread(k, c)
        assert -(-per_cta // lanes) <= dk.MAX_THREADS
        assert (lanes - 1) * dk.MAX_THREADS < per_cta
    # the codec's k=1024 and the serving path's k=4096 run on 16 CTAs, a
    # thread a lane up to 16,384 lanes; a smaller k on the most it fills
    assert dk.decode_cluster(k) == min(16, 1 << (k.bit_length() - 1))
    assert (dk.decode_lanes_per_thread(k, dk.decode_cluster(k)) == 1) == (k <= 16384)
    assert dk.decode_cluster(0) == 0


def test_wrapper_tables_match_the_kernel_instances():
    """The cluster sizes the decode wrapper allows are the source's
    DECODE_INSTANCES."""
    with open(CU) as f:
        src = f.read()
    line = src[src.index("#define DECODE_INSTANCES(X)"):].splitlines()[0]
    assert [int(v) for v in re.findall(r"X\((\d+)\)", line)] == list(dk.DECODE_CLUSTERS)
