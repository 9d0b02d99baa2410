"""Seeded inputs for the port's kernel tests (no JAX: the card's machine
runs the card tests without it)."""

from __future__ import annotations

import numpy as np
import torch

# the tiny TCM of the parallel slice's tests (tests/test_torch_port_tiled.py,
# tests/test_torch_port_parallel.py and its worker)
TINY_TCM = dict(N=32, M=40, hyper_ch=24, atten_inter_dim=16)


def err_ok(got, want, tol) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err
    return err


def attn_inputs(seed, b, h, w, c):
    """NHWC x and Swin sub-block weights in the JAX layout ([in, out])."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(0, scale, s)).astype(np.float32)  # noqa: E731
    x = f(b, h, w, c)
    weights = dict(
        wqkv=f(c, 3 * c, scale=c ** -0.5), bqkv=f(3 * c, scale=0.1),
        wproj=f(c, c, scale=c ** -0.5), bproj=f(c, scale=0.1),
        ln_scale=1 + f(c, scale=0.1), ln_bias=f(c, scale=0.1),
        ln2_scale=1 + f(c, scale=0.1), ln2_bias=f(c, scale=0.1),
        w1=f(c, 4 * c, scale=c ** -0.5), b1=f(4 * c, scale=0.1),
        w2=f(4 * c, c, scale=(4 * c) ** -0.5), b2=f(c, scale=0.1),
    )
    return x, weights


def port_attn_args(weights, rel_bias, to):
    """The port wrapper's arguments (torch layout [out, in]) from JAX-layout
    arrays."""
    t = lambda a: to(torch.from_numpy(np.ascontiguousarray(a)))  # noqa: E731
    wts = weights
    mlp = (t(wts["ln2_scale"]), t(wts["ln2_bias"]), t(wts["w1"].T), t(wts["b1"]),
           t(wts["w2"].T), t(wts["b2"]))
    return (t(wts["wqkv"].T), t(wts["bqkv"]), t(wts["wproj"].T), t(wts["bproj"]),
            t(wts["ln_scale"]), t(wts["ln_bias"]), t(rel_bias), mlp)


def qkv_inputs(seed, nw, t, c, heads, n_mask):
    """B4's inputs in the JAX layout: windows [nw, t, c], w_qkv [c, 3c],
    b_qkv, rel_bias [heads, t, t], w_proj [c, c], b_proj and an additive
    [n_mask, t, t] mask of 0 and -100 (each token sees at least itself)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(0, scale, s)).astype(np.float32)  # noqa: E731
    mask = np.where(rng.uniform(size=(n_mask, t, t)) < 0.3, -100.0, 0.0).astype(np.float32)
    mask[:, np.arange(t), np.arange(t)] = 0.0
    return (f(nw, t, c), f(c, 3 * c, scale=c ** -0.5), f(3 * c, scale=0.1),
            f(heads, t, t, scale=0.5), f(c, c, scale=c ** -0.5), f(c, scale=0.1), mask)


def conv_inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    w1 = rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c)).astype(np.float32)  # HWIO
    w2 = rng.normal(0, (9 * c) ** -0.5, (3, 3, c, c)).astype(np.float32)
    b1 = rng.normal(0, 0.1, c).astype(np.float32)
    b2 = rng.normal(0, 0.1, c).astype(np.float32)
    gamma = np.abs(rng.normal(0, 0.05, (c, c))).astype(np.float32)  # derived: >= 0
    beta = rng.uniform(0.5, 1.5, c).astype(np.float32)
    skip = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, w1, b1, w2, b2, gamma, beta, skip


def oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def coder_tables(seed, r=6, width=20):
    """(cdf, cdf_length, offset) int32: r CDF rows of 5..width bins, each
    bin at least 1 of 2^16, offsets in [-8, -1]."""
    rng = np.random.default_rng(seed)
    cdf = np.zeros((r, width), np.int32)
    length = np.zeros(r, np.int32)
    for i in range(r):
        n = int(rng.integers(5, width + 1))
        pmf = rng.uniform(0.1, 1.0, n - 1)
        edges = np.concatenate([[0], np.cumsum(np.maximum(1, np.round(
            pmf / pmf.sum() * (65536 - n))))]).astype(np.int64)
        edges[-1] = 65536
        cdf[i, :n] = np.minimum.accumulate(edges[::-1])[::-1]
        length[i] = n
    return cdf, length, rng.integers(-8, 0, r).astype(np.int32)


def coder_symbols(seed, n, r):
    """(symbols, indexes) int32 for ``coder_tables``' rows: small values,
    every 29th an escape (the int32 extremes among them)."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(-12, 14, n).astype(np.int32)
    sym[::29] = rng.integers(-2 ** 31, 2 ** 31 - 1, len(sym[::29]))
    sym[5 % n] = np.iinfo(np.int32).min
    sym[6 % n] = np.iinfo(np.int32).max
    return sym, rng.integers(0, r, n).astype(np.int32)


def scale_tables():
    """(cdf, cdf_length, offset) int32 of the 64-row Gaussian scale table
    every channel-AR codec codes y with (rows of 5 to 3,133 entries)."""
    from reslic_tcm_tpu_torch.entropy.gaussian import build_scale_tables
    from reslic_tcm_tpu_torch.ops.math import get_scale_table

    t = build_scale_tables(get_scale_table().numpy())
    return t.quantized_cdf, t.cdf_length, t.offset


def scale_symbols(seed, n):
    """(symbols, indexes) int32 for ``scale_tables``' rows: Gaussian symbols
    at each row's scale, so that every part of a wide row is reached, and
    the escapes of ``coder_symbols`` (every 29th, the int32 extremes)."""
    from reslic_tcm_tpu_torch.ops.math import get_scale_table

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 64, n).astype(np.int32)
    scale = get_scale_table().numpy()[idx]
    sym = np.round(rng.normal(0.0, 1.5, n) * scale).astype(np.int32)
    esc, _ = coder_symbols(seed, n, 1)
    sym[::29] = esc[::29]
    sym[5 % n], sym[6 % n] = esc[5 % n], esc[6 % n]
    return sym, idx


def gaussian_inputs(seed, n):
    """(sigma float32, symbols int32) of n Gaussian symbols, sigma
    log-uniform over [0.05, 300], before clamping to the coder's support."""
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(np.float32)
    return sigma, np.round(rng.normal(0.0, 1.3, n) * sigma).astype(np.int32)
