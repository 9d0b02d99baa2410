"""The device coder profile of reslic_tcm_tpu_torch/models/base.py
(``ChannelARCodec.compress_device*``, ``decompress_device*``, the serving
pipelines) on the CPU, against the JAX codec at tiny widths.

Models: TCM at the size of the JAX package's own device-codec tests (N=32,
M=40, hyper_ch 24, SWAtten inter_dim 16, 128x128 images, k=128) with the
JAX codec's structure-only init plus seeded perturbations, bridged into the
port; and a tiny WACNN (N=32, M=40, seeded weights) for the port alone.
Inputs come from numpy seeds.

Tolerances: the port's own roundtrips are exact in y_hat. Against JAX, the
symbols and scale indexes may differ where sigma sits within float32 ulps
of a scale-table boundary (a one-ulp sigma difference flips an index and,
through the LRP, later symbols): up to 0.1% of the elements, as in
tests/test_torch_port_tcm.py; with no flip the streams are byte-identical.
The analytic coder uses sigma continuously, so its words equal JAX's where
the port's sigma equals JAX's bit for bit; on JAX's own sigma and symbols
they equal JAX's exactly (the coder-level guarantee of
tests/test_torch_port_device_rans.py). Decoded pixels: within 1e-5 of the
host codec's; uint8 pixels within one level; PSNR within 1e-4 dB.

Cost: one JAX codec for the file, compiled with most optimisations off;
JAX's whole-codec device paths run once each (compress_device and
compress_device_analytic), and one jitted program gives JAX's per-slice
sigma, symbols and indexes. No JAX decoder runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.coding import analytic_rans as JA
from reslic_tcm_tpu.models import base as jax_base
from reslic_tcm_tpu.models.tcm import make_tcm as jax_make_tcm
from reslic_tcm_tpu_torch.coding import analytic_rans as PA
from reslic_tcm_tpu_torch.coding import device_rans as PD
from reslic_tcm_tpu_torch.models import base as port_base
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.utils.metrics import compute_psnr
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from tests.test_torch_port_train_parity import WACNN_TINY
from torch_port_threads import one_torch_thread  # noqa: E402,F401

SMALL = dict(N=32, M=40, hyper_ch=24, atten_inter_dim=16)
K = 128
MAX_FLIP_SHARE = 1e-3


def _image(seed, b=1):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(b, 8, 8, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _jax_slice_inputs(jc, x):
    """JAX's analytic encoder up to the coder, as one jitted program: per
    slice sigma, the raw and the clamped symbols, and the scale indexes of
    sigma, each flattened in NHWC order and concatenated slice after slice."""
    module = jc.module

    def fn(v, x, scale_table):
        y, _, z_hat = module.apply(v, x, 0, method=jax_base.ChannelARModule.analysis)
        means, scales = module.apply(v, z_hat, 0, method=jax_base.ChannelARModule.hyper_synthesis)
        y_shape = (x.shape[1] // 16, x.shape[2] // 16)
        sigmas, raws, clamped, idxs, y_hat_slices = [], [], [], [], []
        for i in range(module.num_slices):
            mu, sigma, support = module.apply(
                v, i, means, scales, list(y_hat_slices), y_shape,
                method=jax_base.ChannelARModule.decode_slice_params_sigma)
            raw = module.apply(v, i, y, mu, method=jax_base.ChannelARModule.quantize_slice)
            sym = JA.clamp_symbols(raw.astype(jnp.int32), JA.coder_params(sigma)["c"])
            y_hat_slices.append(module.apply(
                v, i, support, sym.astype(jnp.int16), mu,
                method=jax_base.ChannelARModule.decode_slice_dequant_finish))
            sigmas.append(sigma.reshape(-1))
            raws.append(raw.reshape(-1).astype(jnp.int32))
            clamped.append(sym.reshape(-1))
            idxs.append(jax_base.build_indexes(sigma, scale_table).reshape(-1).astype(jnp.int32))
        return [jnp.concatenate(a) for a in (sigmas, raws, clamped, idxs)]

    scale_table = jnp.asarray(jc.gaussian_conditional.scale_table)
    return [np.array(a) for a in jax.jit(fn)(jc.variables, jnp.asarray(x), scale_table)]


@pytest.fixture(scope="module")
def coded():
    """The JAX and port codecs with the same weights, an image, and JAX's
    table streams, analytic container and per-slice coder inputs for it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    optimisations_off = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jc = jax_make_tcm(input_shape=(128, 128), fast_init=True, **SMALL)
        rng = np.random.default_rng(0)
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jc.params)[0]:
            names = [getattr(k, "key", str(k)) for k in path]
            v = np.asarray(leaf, np.float32)
            if names[-1] in ("bias", "scale"):  # structure-only init leaves these constant
                v = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
            flat["/".join(names)] = v
        tree = {}
        for key, v in flat.items():
            node = tree
            for p in key.split("/")[:-1]:
                node = node.setdefault(p, {})
            node[key.split("/")[-1]] = jnp.asarray(v)
        jc.variables = {"params": tree}
        pc = make_tcm(device="cpu", **SMALL)
        pc.module.load_state_dict(from_jax_params(flat), strict=True)
        jc.update()
        pc.update()
        x = _image(1)
        jax_enc = jc.compress_device(jnp.asarray(x), k=K)
        jax_analytic = jc.compress_device_analytic(jnp.asarray(x), k=K)
        jax_inputs = _jax_slice_inputs(jc, x)
    finally:
        jax.config.update("jax_disable_most_optimizations", optimisations_off)
    yield {"pc": pc, "x": x, "jax_enc": jax_enc, "jax_analytic": jax_analytic,
           "jax_inputs": jax_inputs}
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wacnn():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    codec = make_wacnn(N=32, M=40, device="cpu", seed=2, **WACNN_TINY)
    m = codec.module
    with torch.no_grad():  # y into the coder's range (random init rounds it to zero)
        for layer, factor in [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms]:
            layer.weight.mul_(factor)
            layer.bias.mul_(factor)
    codec.update()
    yield codec
    torch.set_num_threads(threads)


# ------------------------------ the port alone ------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("profile", ["table", "analytic"])
def test_tcm_device_roundtrip_is_exact(coded, batch, profile):
    """Both profiles reproduce the encoder's y_hat exactly, at batch 1 and
    3 (one stream for the batch); the decoded x_hat equals the host codec's
    decode within 1e-5 (the analytic profile's symbols are clamped to their
    support, so its y_hat may differ from the host codec's where one was)."""
    pc = coded["pc"]
    x = _image(5, batch) if batch > 1 else coded["x"]
    if profile == "table":
        enc = pc.compress_device(x, k=K)
        dec = pc.decompress_device(enc)
    else:
        enc = pc.compress_device_analytic(x, k=K)
        dec = pc.decompress_device_analytic(enc)
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    host = pc.decompress_batch([e["strings"] for e in pc.compress_batch(x)], enc["shape"])
    if profile == "table" or enc["clamped"] == 0:
        assert torch.equal(dec["y_hat"], host["y_hat"])
        np.testing.assert_allclose(dec["x_hat"].numpy(), host["x_hat"].numpy(), atol=1e-5)
    assert enc["batch"] == batch and enc["nbytes"] > 0


def test_wacnn_device_roundtrip_is_exact(wacnn):
    x = _image(7, 2)
    for enc, dec in ((e := wacnn.compress_device(x, k=K), wacnn.decompress_device(e)),
                     (a := wacnn.compress_device_analytic(x, k=K),
                      wacnn.decompress_device_analytic(a))):
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert float(enc["y_hat"].abs().max()) > 1.0  # y is coded, not all zeros
    with pytest.raises(ValueError, match="subpel"):
        wacnn.module.synthesize_raw_u8(enc["y_hat"].permute(0, 3, 1, 2))


def test_overflow_retries_with_a_bigger_cap_then_raises(coded, monkeypatch):
    """A cap of one word per lane is doubled until the stream fits (JAX's
    rule); a stream that never fits raises after four tries."""
    pc, x = coded["pc"], coded["x"]
    enc = pc.compress_device(x, k=K, cap=1)
    assert torch.equal(pc.decompress_device(enc)["y_hat"], enc["y_hat"])
    assert enc["device_streams"]["y"][0].shape[1] > 1
    tries = []

    def never_fits(*args, **kw):
        tries.append(kw["cap"])
        w, c, _ = PD.encode_interleaved.__wrapped__(*args, **kw)
        return w, c, torch.tensor(True)

    never_fits.__wrapped__ = PD.encode_interleaved
    monkeypatch.setattr(PD, "encode_interleaved", never_fits)
    with pytest.raises(RuntimeError, match="overflow"):
        pc.compress_device(x, k=K, cap=8)
    assert tries[:4] == [8, 16, 32, 64]


def test_analytic_container_grows_until_it_fits(coded):
    """A y stream that outgrows the 2-bits-a-symbol budget: the container is
    written again with a bigger y_flat_cap and still decodes exactly."""
    pc = coded["pc"]
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(1, 128, 128, 3)).astype(np.float32)  # noise: many bits a symbol
    enc = pc.compress_device_analytic(x, k=K)
    assert enc["y_flat_cap"] >= max(4 * K, enc["y_hat"].numel() // 8)
    assert torch.equal(pc.decompress_device_analytic(enc)["y_hat"], enc["y_hat"])


def test_raw_u8_and_device_psnr(coded):
    """synthesize_raw_u8 + unshuffle_u8 is the uint8 of the decoded x_hat
    (within one level), and the on-device PSNR is the host's within 1e-4 dB."""
    pc = coded["pc"]
    x = _image(3, 2)
    enc = pc.compress_device_analytic(x, k=K)
    plain = pc.decompress_device_analytic(enc)
    raw = pc.decompress_device_analytic(enc, raw_u8=True, psnr_vs=x)
    img = port_base.unshuffle_u8(raw["rgb_raw"].numpy())
    assert img.dtype == np.uint8 and img.shape == x.shape
    want = np.round(plain["x_hat"].numpy() * 255.0)
    assert np.abs(img.astype(np.float64) - want).max() <= 1.0
    for j in range(2):
        host = compute_psnr(torch.from_numpy(x[j:j + 1]),
                            torch.from_numpy(img[j:j + 1].astype(np.float32) / 255.0))
        assert abs(float(raw["psnr"][j]) - host) <= 1e-4
    with pytest.raises(ValueError, match="raw_u8"):
        pc.decompress_device_analytic(enc, psnr_vs=x)
    # keep_source keeps the encoder's own device copy of the images
    kept = pc.compress_device_analytic(x, k=K, keep_source=True)
    assert torch.equal(kept["x_dev"], torch.from_numpy(x))
    kept_raw = pc.decompress_device_analytic(kept, raw_u8=True, psnr_vs=kept["x_dev"])
    np.testing.assert_array_equal(kept_raw["psnr"].numpy(), raw["psnr"].numpy())


def test_serving_pipelines_give_the_serial_results(coded):
    """serve_roundtrip_pipelined and serve_roundtrip_metrics against the
    serial analytic calls, roundtrip_device_pipelined against the serial
    table calls, batch after batch (k=256 at batch 2)."""
    pc = coded["pc"]
    batches = [_image(20 + j, 2) for j in range(3)]
    served = pc.serve_roundtrip_pipelined(batches, k=256)
    metrics = pc.serve_roundtrip_metrics(batches, k=256)
    tabled = pc.roundtrip_device_pipelined(batches, k=256)
    assert len(served) == len(metrics) == len(tabled) == 3
    for x, s, m, t in zip(batches, served, metrics, tabled):
        enc = pc.compress_device_analytic(x, k=256)
        raw = pc.decompress_device_analytic(enc, raw_u8=True, psnr_vs=x)
        for got in (s, m):
            np.testing.assert_array_equal(got["enc"]["packed"], enc["packed"])
            assert "x_dev" not in got["enc"]
            assert torch.equal(got["y_hat"], enc["y_hat"])
        np.testing.assert_array_equal(s["rgb_raw"], raw["rgb_raw"].numpy())
        np.testing.assert_array_equal(m["psnr"], raw["psnr"].numpy())
        table = pc.compress_device(x, k=256)
        for name in ("y", "z"):
            for a, b in zip(t["enc"]["device_streams"][name], table["device_streams"][name]):
                np.testing.assert_array_equal(a, b)
        assert torch.equal(t["y_hat"], t["enc"]["y_hat"])
    assert pc.serve_roundtrip_pipelined([], k=256) == []


def test_lane_helpers_match_jax():
    for n, k in ((18432, 1024), (147456, 4096), (96, 1024), (7, 8)):
        assert port_base.math_gcd_pow2(n, k) == jax_base.math_gcd_pow2(n, k)
    raw = np.random.default_rng(4).integers(0, 256, (2, 3, 5, 12), dtype=np.uint8)
    np.testing.assert_array_equal(port_base.unshuffle_u8(raw), jax_base.unshuffle_u8(raw))


# ------------------------------ against JAX ------------------------------


def test_table_streams_match_jax(coded):
    """The table profile's symbols and indexes equal JAX's encoder's (flips
    within 0.1%); with no flip its y and z streams equal JAX's compress_device
    streams byte for byte, and the port decodes JAX's streams exactly."""
    pc, x = coded["pc"], coded["x"]
    _, raw, clamped, jidx = coded["jax_inputs"]
    # no symbol clamped: JAX's analytic chain is its table chain here
    assert np.array_equal(raw, clamped)
    inputs = pc.device_coder_inputs(x)
    flips = int((inputs["y"].numpy() != raw).sum() + (inputs["indexes"].numpy() != jidx).sum())
    print(f"table profile: {flips} of {2 * raw.size} symbols and indexes differ from JAX's")
    assert flips <= MAX_FLIP_SHARE * raw.size
    enc = pc.compress_device(x, k=K)
    jax_streams = coded["jax_enc"]["device_streams"]
    np.testing.assert_array_equal(enc["device_streams"]["z"][0], jax_streams["z"][0])
    np.testing.assert_array_equal(enc["device_streams"]["z"][1], jax_streams["z"][1])
    if flips == 0:
        for part in (0, 1):
            np.testing.assert_array_equal(enc["device_streams"]["y"][part], jax_streams["y"][part])
        dec = pc.decompress_device({**enc, "device_streams": jax_streams})
        assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert enc["nbytes"] == coded["jax_enc"]["nbytes"] or flips > 0


def test_analytic_container_matches_jax(coded):
    """The container's layout fields equal JAX's; its z part equals JAX's
    word for word. The port's coder on JAX's own per-slice sigma and
    symbols writes JAX's y words exactly; where the port's sigma equals
    JAX's bit for bit (the count of elements that differ is printed), the
    port's whole container is JAX's."""
    pc, x = coded["pc"], coded["x"]
    jenc = coded["jax_analytic"]
    jsigma, _, jsym, _ = coded["jax_inputs"]
    enc = pc.compress_device_analytic(x, k=K)
    for key in ("shape", "k", "kz", "y_flat_cap", "z_flat_cap", "batch", "coder"):
        assert enc[key] == jenc[key], key
    assert enc["packed"].dtype == np.uint16 and enc["packed"].shape == jenc["packed"].shape
    k, cap = enc["k"], enc["y_flat_cap"]
    y_end = 3 + 2 * k + cap
    np.testing.assert_array_equal(enc["packed"][y_end:], jenc["packed"][y_end:])

    header, flat, total, _ = PA.encode_gaussian_grouped(torch.from_numpy(jsym),
                                                        torch.from_numpy(jsigma), k=k, cap=cap)
    assert int(total) == int(jenc["packed"][1]) | (int(jenc["packed"][2]) << 16)
    np.testing.assert_array_equal(header.numpy().reshape(-1), jenc["packed"][3:3 + 2 * k])
    np.testing.assert_array_equal(flat.numpy(), jenc["packed"][3 + 2 * k:y_end])

    inputs = pc.device_coder_inputs(x, analytic=True)
    differ = int((inputs["sigma"].numpy().view(np.int32) != jsigma.view(np.int32)).sum())
    print(f"analytic profile: {differ} of {jsigma.size} sigma elements differ from JAX's")
    if differ == 0 and np.array_equal(inputs["y"].numpy(), jsym):
        np.testing.assert_array_equal(enc["packed"], jenc["packed"])
        assert enc["nbytes"] == jenc["nbytes"]
