"""Port parity: ops/math, the entropy tables, the rANS coder, metrics and
the synthetic images of reslic_tcm_tpu_torch against the JAX package and the
committed goldens.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance: element-wise float32 math evaluated by two libraries may differ
in the last bits (erfc, exp), so float results are compared within a few
float32 ulps (stated at each check); integer results (indexes, CDF tables,
streams) and the synthetic images must be equal.
"""

from __future__ import annotations

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.data import synthetic as jsyn
from reslic_tcm_tpu.entropy import factorized as jfz
from reslic_tcm_tpu.ops import math as jm
from reslic_tcm_tpu_torch.coding import rans as prans
from reslic_tcm_tpu_torch.data import synthetic as psyn
from reslic_tcm_tpu_torch.entropy import factorized as pfz
from reslic_tcm_tpu_torch.entropy.gaussian import GaussianConditional, build_scale_tables
from reslic_tcm_tpu_torch.ops import math as pm
from reslic_tcm_tpu_torch.utils import metrics as pmet
from torch_port_threads import one_torch_thread  # noqa: E402,F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def test_scale_table_bits_match_jax_and_golden():
    got = pm.get_scale_table().numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jm.get_scale_table()).view(np.uint32))
    np.testing.assert_array_equal(
        got, np.asarray(_golden("gaussian_tables.json")["scale_table_u32"], np.uint32))


def test_build_indexes_golden_grid_element_for_element():
    table = pm.get_scale_table().numpy()
    below = np.nextafter(table, np.float32(0.0), dtype=np.float32)
    above = np.nextafter(table, np.float32(np.inf), dtype=np.float32)
    grid = np.concatenate([below, table, above,
                           np.float32([0.0, 1e-6, 0.05, 300.0, 1e6])]).astype(np.float32)
    got = pm.build_indexes(torch.from_numpy(grid), pm.get_scale_table()).numpy()
    np.testing.assert_array_equal(got, np.asarray(_golden("gaussian_tables.json")["grid_indexes"]))
    np.testing.assert_array_equal(got, np.asarray(jm.build_indexes(jnp.asarray(grid),
                                                                   jm.get_scale_table())))


def test_build_indexes_random_sigmas_match_jax():
    rng = np.random.default_rng(1)
    sigma = np.exp(rng.uniform(-4, 7, size=(2, 5, 7, 9))).astype(np.float32)
    got = pm.build_indexes(torch.from_numpy(sigma), pm.get_scale_table()).numpy()
    want = np.asarray(jm.build_indexes(jnp.asarray(sigma), jm.get_scale_table()))
    np.testing.assert_array_equal(got, want)


def test_gaussian_likelihood_and_rounding_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, size=(3, 6, 5, 7)).astype(np.float32)
    mu = rng.normal(0, 1, size=x.shape).astype(np.float32)
    sigma = np.exp(rng.uniform(-3, 3, size=x.shape)).astype(np.float32)
    got = pm.gaussian_likelihood(*map(torch.from_numpy, (x, sigma, mu))).numpy()
    want = np.asarray(jm.gaussian_likelihood(*map(jnp.asarray, (x, sigma, mu))))
    # the likelihood is a difference of two normal CDF values in [0, 1], each
    # within an ulp or two of 1.0 (6e-8) between libm's and XLA's erfc
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps)
    np.testing.assert_array_equal(pm.ste_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jm.ste_round(jnp.asarray(x))))


def test_lower_bound_gradient_matches_jax():
    x = np.float32([-2.0, 0.5, 1.0, 3.0])
    g = np.float32([1.0, -1.0, 1.0, -1.0])
    xt = torch.tensor(x, requires_grad=True)
    pm.lower_bound(xt, 1.0).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda v: jm.lower_bound(v, jnp.float32(1.0)), jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("hw", [(64, 64), (100, 130), (768, 512), (1, 257)])
def test_padding_matches_jax(hw):
    h, w = hw
    assert pm.compute_padding(h, w, 128) == jm.compute_padding(h, w, 128)
    x = np.random.default_rng(3).normal(size=(1, h, w, 3)).astype(np.float32)
    pad, _ = pm.compute_padding(h, w, 128)
    got = pm.pad_nhwc(torch.from_numpy(x), pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.pad_nhwc(jnp.asarray(x), pad)))
    np.testing.assert_array_equal(pm.crop_nhwc(got, pad).numpy(), x)


def test_gaussian_tables_byte_identical_to_golden():
    t = build_scale_tables(pm.get_scale_table().numpy())
    ref = _golden("gaussian_tables.json")["tables"]
    digest = hashlib.sha256(np.ascontiguousarray(t.quantized_cdf, np.int32).tobytes()).hexdigest()
    assert digest == ref["cdf_sha256"]
    assert list(t.quantized_cdf.shape) == ref["cdf_shape"]
    assert t.cdf_length.tolist() == ref["cdf_length"]
    assert t.offset.tolist() == ref["offset"]
    gc = GaussianConditional().update_scale_table()
    np.testing.assert_array_equal(gc.tables.quantized_cdf, t.quantized_cdf)


def test_entropy_bottleneck_tables_match_jax():
    # the chain at its initial values, perturbed (a trained-like chain)
    rng = np.random.default_rng(4)
    c = 6
    f = (1, 3, 3, 3, 3, 1)
    scale = 10.0 ** (1 / 5)
    params = {}
    for i in range(5):
        init = np.log(np.expm1(1 / scale / f[i + 1]))
        params[f"matrix{i}"] = (init + rng.normal(0, 0.1, (c, f[i + 1], f[i]))).astype(np.float32)
        params[f"bias{i}"] = rng.uniform(-0.5, 0.5, (c, f[i + 1], 1)).astype(np.float32)
        if i < 4:
            params[f"factor{i}"] = rng.normal(0, 0.1, (c, f[i + 1], 1)).astype(np.float32)
    q = np.float32([-10.0, 0.0, 10.0]) + rng.normal(0, 1, (c, 1, 3))
    params["quantiles"] = q.astype(np.float32)
    q = params["quantiles"]
    got, want = pfz.build_tables(params), jfz.build_tables(params)
    for field in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    z = (rng.normal(0, 3, (2, c, 3, 4)) + q[None, :, 0, 1, None, None]).astype(np.float32)
    med = q[:, 0, 1]
    strings = pfz.compress(z, med, got)
    assert strings == jfz.compress(z.transpose(0, 2, 3, 1), med, want)
    back = pfz.decompress(strings, (3, 4), med, got)
    np.testing.assert_array_equal(back, np.rint(z - med[None, :, None, None]) + med[None, :, None, None])


def test_rans_golden_streams_and_cdfs():
    from test_golden_bitstream import _cases, _pmf_cases

    g = _golden("rans_fixtures.json")
    for name, syms, idx, table, lens, offs in _cases():
        got = prans.encode_with_indexes(syms, idx, table, lens, offs)
        assert got.hex() == g["streams"][name]["stream_hex"], name
        np.testing.assert_array_equal(prans.decode_with_indexes(got, idx, table, lens, offs), syms)
        enc = prans.BufferedRansEncoder()
        for lo in range(0, len(syms), 50):
            enc.encode_with_indexes(syms[lo:lo + 50], idx[lo:lo + 50], table, lens, offs)
        assert enc.flush() == got
        dec = prans.RansDecoder()
        dec.set_stream(got)
        half = len(syms) // 2
        parts = [dec.decode_stream(idx[:half], table, lens, offs),
                 dec.decode_stream(idx[half:], table, lens, offs)]
        np.testing.assert_array_equal(np.concatenate(parts), syms)
    for name, pmf in _pmf_cases():
        np.testing.assert_array_equal(prans.pmf_to_quantized_cdf(pmf, 16),
                                      np.asarray(g["cdfs"][name]["cdf"], np.int32))


def test_rans_rejects_out_of_range_indexes():
    cdf = prans.pmf_to_quantized_cdf(np.float32([0.5, 0.48, 0.02]))[None]
    with pytest.raises(ValueError):
        prans.encode_with_indexes([0, 1], [0, 1], cdf, [4], [0])


def test_ms_ssim_and_psnr_match_goldens_and_jax():
    from gen_msssim_golden import make_pair

    from reslic_tcm_tpu.utils import metrics as jmet

    for case in _golden("msssim_golden.json"):
        a, b = make_pair(case["seed"], case["h"], case["w"], case["noise"])
        got = float(pmet.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - case["ms_ssim"]) < 2e-5, (case, got)
        assert abs(pmet.compute_psnr(torch.from_numpy(a), torch.from_numpy(b))
                   - jmet.compute_psnr(jnp.asarray(a), jnp.asarray(b))) < 1e-4
    assert pmet.msssim_to_db(1.0) == jmet.msssim_to_db(1.0)


def test_synthetic_images_identical_to_jax():
    for seed in range(3):
        a = psyn.synth_image(np.random.default_rng(seed), 48, 80)
        b = jsyn.synth_image(np.random.default_rng(seed), 48, 80)
        np.testing.assert_array_equal(a, b)
