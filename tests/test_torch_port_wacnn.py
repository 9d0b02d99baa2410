"""Port parity for the WACNN slice: the window attention of
reslic_tcm_tpu_torch (B1's attention-only flavour and B4's composed
counterpart) and the whole WACNN eval forward and real codec against the
JAX package at the same weights, the Deconv weight bridge, the committed
WACNN snapshot, and the port's eval CLI with ``--model wacnn`` on the CPU.

The JAX WACNN is the tiny one of tests/test_model_families.py (N=32, M=40,
hyper_dims (40,36,32), mean_dims (32,36,40,44), cc_dims (28,24,20,16)) at
128x128; its parameters reach the port through the port's bridge. Inputs
are numpy arrays from a seed.

Tolerances: the forward outputs are float32 through some 70 layers with
other summation orders, compared at 1e-5 relative (max |port - jax| <=
1e-5 * max(1, max |jax|)), as for TCM. Coding is exact: z strings must be
byte-identical; y symbols and scale indexes must be identical except where
sigma sits within float32 ulps of a scale-table boundary (allowed up to
0.1% of the elements, ROADMAP queue C). The port's own compress ->
decompress must reproduce y_hat exactly. The attention modules against
JAX's composed path: 2e-4 absolute and relative, the bound
tests/test_pallas_attn.py holds JAX's own fused path to (the kernels mask
with -1e9 and scale the scores after q.k; the composed path masks with
-100 and scales q).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.base import ChannelARCodec as JChannelARCodec
from reslic_tcm_tpu.models.wacnn import WACNN as JWACNN
from reslic_tcm_tpu.ops import window_attention as JW
from reslic_tcm_tpu.utils.torch_convert import convert_state_dict
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.models import get_model
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.ops import window_attention as PW
from reslic_tcm_tpu_torch.ops.launches import launch_counts
from reslic_tcm_tpu_torch.utils.torch_convert import (from_jax_params, load_snapshot_into,
                                                      torch_key)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
TOL_ATTN = 2e-4
MAX_FLIP_SHARE = 1e-3
TINY = dict(hyper_dims=(40, 36, 32), mean_dims=(32, 36, 40, 44), cc_dims=(28, 24, 20, 16))
SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                        "wacnn_stanh_vr_r5.npz")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _flat(params) -> dict:
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _image(h=128, w=128, seed=1):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(1, h // 16, w // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX codec, port codec, flat JAX params) with identical weights: the
    port's seeded random weights go to JAX through the JAX package's own
    converter, onto a parameter template from ``jax.eval_shape`` (an eager
    JAX init of this model takes a minute on the CPU). GDN is perturbed off
    its constant init; g_a's last conv and the cc_scale transforms' last
    convs are scaled up so that y (std ~0.09 at random init) and sigma
    (~0.04) span the coder's range: most symbols nonzero, some 30 scale
    indexes in use."""
    module = JWACNN(N=32, M=40, **TINY)
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(lambda: module.init(
        {"params": key, "noise": key}, jnp.zeros((1, 128, 128, 3)), training=True))["params"]
    pc = make_wacnn(N=32, M=40, device="cpu", seed=2, **TINY)
    rng = np.random.default_rng(0)
    m = pc.module
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(("beta", "gamma")):
                p.add_(torch.from_numpy(np.abs(rng.normal(0, 0.01, p.shape)).astype(np.float32)))
        for layer, factor in [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms]:
            layer.weight.mul_(factor)
            layer.bias.mul_(factor)
    sd = {k: v.numpy() for k, v in pc.module.state_dict().items()}
    params, report = convert_state_dict(sd, template)
    assert report == {"missing": [], "unused": []}
    jc = JChannelARCodec(module, {"params": params})
    jc.update()
    pc.update()
    return jc, pc, _flat(params)


# ------------------------------ attention ------------------------------


def _attention_pair(dim, heads, window, shift, seed):
    m = JW.WinBasedAttention(dim=dim, num_heads=heads, window_size=window, shift_size=shift)
    v = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2 * window, 2 * window, dim)))
    p = PW.WinBasedAttention(dim, heads, window, shift)
    p.load_state_dict(from_jax_params(_flat(v["params"])), strict=True)
    return m, v, p


@pytest.mark.parametrize("shift", [0, 4])
def test_win_based_attention_window8_matches_jax_composed(shift):
    """Window 8 takes B1's attention-only flavour in the port (its plain
    version on the CPU); JAX runs its composed path (fused attention off)."""
    m, v, p = _attention_pair(48, 2, 8, shift, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 16, 24, 48)).astype(np.float32)
    before = launch_counts()
    with torch.no_grad():
        got = p(torch.from_numpy(x))
    assert launch_counts() == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(v, jnp.asarray(x))),
                               rtol=TOL_ATTN, atol=TOL_ATTN)


@pytest.mark.parametrize("hw", [(8, 12), (10, 6)])
@pytest.mark.parametrize("shift", [0, 2])
def test_win_based_attention_window4_matches_jax_composed(shift, hw):
    """Window 4 is composed on both sides: pad, roll, partition, then
    WindowAttention (B4's plain version in the port) with the -100 mask;
    10x6 exercises the pad-and-crop."""
    m, v, p = _attention_pair(40, 8, 4, shift, seed=5)
    x = np.random.default_rng(6).normal(size=(2, *hw, 40)).astype(np.float32)
    with torch.no_grad():
        got = p(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(v, jnp.asarray(x))),
                               rtol=TOL_ATTN, atol=TOL_ATTN)


# ------------------------------- bridge --------------------------------


def test_bridge_roundtrip_through_jax_converter(pair):
    """port -> linen (the JAX package's convert_state_dict, in the fixture)
    -> port (this bridge) -> linen: every tensor comes back unchanged,
    the four Deconv kernels of g_s included."""
    jc, pc, flat = pair
    sd = from_jax_params(flat)
    own = pc.module.state_dict()
    assert sd.keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(sd[k], v), k
    params, report = convert_state_dict({k: v.numpy() for k, v in sd.items()}, jc.params)
    assert report == {"missing": [], "unused": []}
    back = _flat(params)
    deconvs = [k for k in flat if k.endswith("/kernel") and flat[k].ndim == 4
               and k.split("/")[-2] != "conv"]
    assert len(deconvs) == 4
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_deconv_matches_jax():
    from reslic_tcm_tpu.ops.layers import Deconv as JDeconv
    from reslic_tcm_tpu_torch.ops.layers import Deconv

    m = JDeconv(12, 5, 2)
    x = np.random.default_rng(7).normal(size=(1, 6, 5, 8)).astype(np.float32)
    v = m.init(jax.random.PRNGKey(7), jnp.asarray(x))
    p = torch.nn.Sequential(Deconv(8, 12, 5, 2))  # the bridge needs the parent's name
    p.load_state_dict(from_jax_params(
        {f"layers_0/{k}": a for k, a in _flat(v["params"]).items()}), strict=True)
    with torch.no_grad():
        got = p(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), m.apply(v, jnp.asarray(x)))


def test_committed_wacnn_snapshot_fills_full_width_port():
    """checkpoints/wacnn_stanh_vr_r5.npz holds a trained WACNN backbone under
    WACNN's names plus two STanH quantizer tables: every parameter of the
    full-width port (N=192, M=320) is filled with its shape, and exactly
    those two entries are left over."""
    codec = make_wacnn(192, 320, device="cpu")
    unused = load_snapshot_into(codec.module, SNAPSHOT, allow_unused=True)
    assert unused == ["gaussian_conditional/stanh/b", "gaussian_conditional/stanh/w"]
    with np.load(SNAPSHOT) as z:
        for path in ("g_s/layers_1/kernel", "g_a/layers_4/win_attn/attn/qkv/kernel"):
            key = torch_key(path, z.files)
            w = codec.module.state_dict()[key].numpy()
            want = z[path].astype(np.float32)
            want = (want.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1] if want.ndim == 4 else want.T)
            np.testing.assert_array_equal(w, want)
    with pytest.raises(ValueError, match="no parameter"):
        load_snapshot_into(make_wacnn(192, 320, device="cpu").module, SNAPSHOT)


# -------------------------------- slice --------------------------------


def test_forward_matches_jax(pair):
    jc, pc, _ = pair
    image = _image()
    want = jc.forward(jnp.asarray(image), training=False)
    got = pc.forward(image)
    _close(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        _close(got["likelihoods"][k], want["likelihoods"][k])
    for k in ("means", "scales", "y"):
        _close(got["para"][k], want["para"][k])


def test_codec_streams_match_jax(pair):
    jc, pc, _ = pair
    image = _image()
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


def test_port_roundtrip_is_exact(pair):
    _, pc, _ = pair
    image = _image()
    enc = pc.compress(image)
    dec = pc.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    fwd = pc.forward(image)
    np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                               atol=1e-5)


def test_get_model_builds_wacnn_and_refuses_the_rest():
    class Args:
        model, N, M = "wacnn", 32, 40

    codec, *rest = get_model(Args, device="cpu")
    assert rest == [None] * 4
    assert codec.module.num_slices == 10 and codec.module.max_support_slices == 5
    assert codec.module.cc_mean_transforms[9][0].weight.shape[1] == 40 + 4 * 5
    # the gain variant builds since the gain codecs' slice; a name the
    # registry does not know is refused
    Args.model, Args.lambda_list = "wacnn_gain", [0.0025, 0.05]
    gained, *_ = get_model(Args, device="cpu")
    assert gained.module.levels == 2 and gained.module.cc_mean_transforms[9][0].in_channels == 60
    Args.model = "wacnn_tiny"
    with pytest.raises(ValueError, match="unknown model"):
        get_model(Args, device="cpu")


def test_eval_cli_wacnn_on_cpu(tmp_path, capsys):
    """``--model wacnn --platform cpu`` end to end on a small PNG directory,
    real codec and forward estimate, at small N and M."""
    from PIL import Image

    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    for i, hw in enumerate([(176, 192), (64, 96)]):
        img = synth_image(np.random.default_rng(8 + i), *hw)
        Image.fromarray((img * 255).round().astype(np.uint8)).save(tmp_path / f"{i}.png")
    assert peval.main(["--data", str(tmp_path), "--platform", "cpu", "--model", "wacnn",
                       "--N", "32", "--M", "40", "--real"]) == 0
    real = capsys.readouterr().out.splitlines()
    assert real[-1].startswith("[level 0] average_Bit-rate:")
    assert sum(line.startswith("[") and "bpp=" in line for line in real) == 2
    assert peval.main(["--data", str(tmp_path), "--platform", "cpu", "--model", "wacnn",
                       "--N", "32", "--M", "40"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("[level 0] average_PSNR:")
