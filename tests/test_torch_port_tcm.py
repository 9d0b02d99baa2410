"""Port parity for the whole slice: TCM eval forward and the real codec of
reslic_tcm_tpu_torch against the JAX package at the same weights, plus the
port's eval CLI on the CPU.

The JAX TCM is small (N=32, M=80, hyper_ch 24, SWAtten inter_dim 32,
config (2,2,2,2,2,2)) with structure-only init and seeded perturbations;
its parameters reach the port through the port's bridge. Inputs are numpy
arrays from a seed.

Tolerances: the forward outputs are float32 through ~60 layers with other
summation orders, compared at 1e-5 relative (max |port - jax| <= 1e-5 *
max(1, max |jax|)). Coding is exact: z strings must be byte-identical; y
symbols and scale indexes must be identical except where sigma sits within
float32 ulps of a scale-table boundary, which may flip an index (a
one-ulp sigma difference) and, through the LRP, a later symbol; such flips
are allowed up to 0.1% of the elements (ROADMAP queue C). The port's own
compress -> decompress must reproduce y_hat exactly.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.tcm import make_tcm as jax_make_tcm
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params, load_snapshot
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
MAX_FLIP_SHARE = 1e-3
SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                        "tcm_s_lambda0.013_r5.npz")
SMALL = dict(N=32, M=80, hyper_ch=24, atten_inter_dim=32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.fixture(scope="module")
def pair():
    """(JAX codec, port codec) with identical weights."""
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
    return jc, pc, flat


@pytest.fixture(scope="module")
def snapshot():
    return load_snapshot(SNAPSHOT)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    g = rng.uniform(size=(1, 8, 8, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def test_forward_matches_jax(pair, image):
    jc, pc, _ = pair
    want = jc.forward(jnp.asarray(image), training=False)
    got = pc.forward(image)
    _close(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k])
    for k in ("means", "scales", "y"):
        _close(got["para"][k], want["para"][k])


def test_codec_streams_match_jax(pair, image):
    jc, pc, _ = pair
    (_, (jsyms, jidxs, jz)), _ = jc._compress_device_stage(jnp.asarray(image))
    order = lambda parts: np.stack([np.asarray(p) for p in parts], 1).transpose(  # noqa: E731
        0, 1, 4, 2, 3).reshape(1, -1).astype(np.int32)
    want_sym, want_idx = order(jsyms), order(jidxs)
    sym, idx, z, _ = pc.encode_symbols(image)
    _close(z, np.asarray(jz).transpose(0, 3, 1, 2))
    flips = int((sym != want_sym).sum() + (idx != want_idx).sum())
    assert flips <= MAX_FLIP_SHARE * sym.size, flips
    jenc = jc.compress(jnp.asarray(image))
    penc = pc.compress(image)
    assert penc["strings"][1] == jenc["strings"][1]
    if flips == 0:
        assert penc["strings"][0] == jenc["strings"][0]


def test_port_roundtrip_is_exact(pair, image):
    _, pc, _ = pair
    enc = pc.compress(image)
    dec = pc.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    fwd = pc.forward(image)
    np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                               atol=1e-5)


def test_batched_codec_matches_single(pair, image):
    _, pc, _ = pair
    batch = np.concatenate([image, image[:, ::-1].copy()], axis=0)
    encs = pc.compress_batch(batch)
    dec = pc.decompress_batch([e["strings"] for e in encs], encs[0]["shape"])
    for j in range(2):
        single = pc.compress(batch[j : j + 1])
        assert encs[j]["strings"] == single["strings"]
        assert torch.equal(dec["y_hat"][j : j + 1], encs[j]["y_hat"])


def test_trained_tcm_s_matches_jax(snapshot, image):
    """The committed TCM-S weights (lambda 0.013) in both frameworks: the
    forward and the codec's streams agree on a 128x128 image."""
    jc = jax_make_tcm(N=64, M=320, input_shape=(128, 128), fast_init=True)
    tree = {}
    for key, v in snapshot.items():
        node = tree
        for p in key.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[key.split("/")[-1]] = jnp.asarray(v)
    jc.variables = {"params": tree}
    pc = make_tcm(N=64, M=320, device="cpu")
    pc.module.load_state_dict(from_jax_params(snapshot), strict=True)
    want = jc.forward(jnp.asarray(image), training=False)
    got = pc.forward(image)
    _close(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k])
    for k in ("means", "scales"):
        _close(got["para"][k], want["para"][k])
    jc.update()
    pc.update()
    jenc = jc.compress(jnp.asarray(image))
    penc = pc.compress(image)
    assert penc["strings"][1] == jenc["strings"][1]
    assert penc["strings"][0] == jenc["strings"][0]


def test_eval_cli_on_cpu_with_trained_weights(tmp_path, snapshot):
    """The CLI on a PNG with the committed TCM-S weights: the report lines,
    an exact decode, and a real bpp within 5% of the estimate (the image is
    padded from 176x192 to 256x256, so the two rates count different
    pixels; both are per source pixel here)."""
    from PIL import Image

    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    img = synth_image(np.random.default_rng(5), 176, 192)
    Image.fromarray((img * 255).round().astype(np.uint8)).save(tmp_path / "a.png")
    lines = []
    codec = make_tcm(N=64, M=320, device="cpu")
    codec.module.load_state_dict(from_jax_params(snapshot), strict=True)
    codec.update()
    x = peval.read_image(tmp_path / "a.png")
    real = peval.evaluate(codec, [x], real=True, log=lines.append)
    est = peval.evaluate(codec, [x], real=False, log=lines.append)
    rec = real["records"][0]
    assert rec["y_hat_exact"]
    assert rec["launches_compress"] == {"flash_window_block": 0, "fused_residual_block": 0,
                                        "fused_conv_gdn": 0, "fused_qkv_attention": 0}
    est_bpp = est["bpp"] * 256 * 256 / (176 * 192)
    assert abs(rec["bpp"] - est_bpp) <= 0.05 * est_bpp, (rec["bpp"], est_bpp)
    assert real["psnr"] == pytest.approx(est["psnr"], abs=1e-3)
    assert any(line.startswith("average_PSNR:") for line in lines)
    assert peval.main(["--data", str(tmp_path), "--platform", "cpu", "--N", "32",
                       "--M", "80", "--real"]) == 0


def test_load_checkpoint_reads_npz_snapshots(pair, tmp_path):
    _, pc, flat = pair
    np.savez(tmp_path / "small.npz", **{k: v.astype(np.float16) for k, v in flat.items()})
    codec = make_tcm(device="cpu", seed=3, **SMALL)
    peval.load_checkpoint(codec, str(tmp_path / "small.npz"))
    for k, v in pc.module.state_dict().items():
        want = torch.from_numpy(v.numpy().astype(np.float16).astype(np.float32))
        assert torch.equal(codec.module.state_dict()[k], want), k


@pytest.mark.parametrize("flag", [["--bf16"], ["--device-coder"],
                                  ["--tile", "128", "--tile-overlap", "32"],
                                  ["--shard-spatial", "2"],
                                  ["--model", "wacnn_gain", "--device-coder"]])
def test_eval_cli_refuses_unported_options(flag, tmp_path, capsys):
    """The JAX CLI's options that the port refused, each ported since.
    ``--bf16`` (ROADMAP A15): TCM codes a tiny image folder on the CPU in the
    bf16 mode and prints bpp and PSNR. ``--device-coder`` (A12): the same
    folder through the analytic device coder; with another model it
    raises, since the JAX CLI reads it only on its TCM branch. ``--tile``
    (A13): the forward estimate of the same folder through 128x128 tiles.
    ``--shard-spatial 2`` raises here because no process group of two ranks
    runs it."""
    if flag[0] in ("--bf16", "--device-coder", "--tile"):
        from PIL import Image

        from reslic_tcm_tpu_torch.data.synthetic import synth_image

        img = synth_image(np.random.default_rng(6), 176, 192)
        Image.fromarray((img * 255).round().astype(np.uint8)).save(tmp_path / "a.png")
        real = ["--real"] if flag in (["--device-coder"], ["--bf16"]) else []
        assert peval.main(["--data", str(tmp_path), "--platform", "cpu", "--N", "32",
                           "--M", "80", *real, *flag]) == 0
        out = capsys.readouterr().out
        assert "PSNR:" in out and "average_Bit-rate:" in out
        if real:
            assert "Bitrate:" in out
        return
    if flag == ["--shard-spatial", "2"]:
        with pytest.raises(ValueError, match="process group"):
            peval.main(["--data", ".", "--platform", "cpu", *flag])
        return
    with pytest.raises(NotImplementedError, match="TCM only"):
        peval.main(["--data", ".", "--platform", "cpu", *flag])
