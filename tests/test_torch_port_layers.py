"""Port parity: the weight bridge, the composed layers and the window
attention of reslic_tcm_tpu_torch against the JAX package (composed paths,
kernels off).

Inputs and weights are made with numpy from a seed; JAX modules are
initialised, their parameters perturbed with seeded noise and copied into
the port modules through the port's own bridge (``from_jax_params``).
Tolerance: both sides compute in float32 with different summation orders
(convolutions, matmuls, softmax), so outputs agree to about 1e-5 relative:
max |port - jax| <= 1e-5 * max(1, max |jax|).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.ops import layers as JL
from reslic_tcm_tpu.ops import window_attention as JW
from reslic_tcm_tpu.utils.torch_convert import convert_state_dict
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.ops import layers as PL
from reslic_tcm_tpu_torch.ops import window_attention as PW
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params, load_snapshot
from torch_port_threads import one_torch_thread  # noqa: E402,F401

SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                        "tcm_s_lambda0.013_r5.npz")
TOL = 1e-5


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _init(module, x, seed, **kw):
    """JAX params of ``module``, perturbed with seeded noise, as a tree."""
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    rng = np.random.default_rng(seed)
    flat = {k: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
            for k, a in _flat(v["params"]).items()}
    return _unflat(flat)


def _load(port_module, params, wrap: str | None = None):
    """Copy a JAX module's params into the port module through the bridge.
    ``wrap`` names a parent module for paths the name table only knows
    inside one (ResidualUnit's convs live under SWAtten's conv_a{i})."""
    flat = _flat(params)
    if wrap is None:
        sd = from_jax_params(flat)
    else:
        sd = from_jax_params({f"{wrap}/{k}": v for k, v in flat.items()})
        head = wrap.replace("conv_a", "conv_a.") + "."
        sd = {k[len(head):]: v for k, v in sd.items()}
    port_module.load_state_dict(sd, strict=True)
    return port_module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ------------------------------- the bridge -------------------------------


@pytest.fixture(scope="module")
def snapshot():
    return load_snapshot(SNAPSHOT)


def test_snapshot_fills_every_port_parameter(snapshot):
    assert len(snapshot) == 1245
    sd = from_jax_params(snapshot)
    codec = make_tcm(N=64, M=320, device="cpu")
    own = codec.module.state_dict()
    assert set(sd) == set(own) and len(sd) == 1245
    codec.module.load_state_dict(sd, strict=True)
    k = snapshot["g_a/layers_1/trans_block/msa/embedding_layer/kernel"]
    np.testing.assert_array_equal(
        own["g_a.1.trans_block.msa.embedding_layer.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        codec.module.g_a[9].weight.detach().numpy(),
        snapshot["g_a/layers_9/conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        codec.module.g_s[0].conv.weight.detach().numpy(),
        snapshot["g_s/layers_0/conv/conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        codec.module.g_s[9][0].weight.detach().numpy(),
        snapshot["g_s/layers_9/conv/conv/kernel"].transpose(3, 2, 0, 1))


def test_linen_port_linen_roundtrip(snapshot):
    """JAX params -> port state dict -> the JAX package's own converter
    (torch state dict -> linen) gives back every leaf unchanged."""
    tree = _unflat(snapshot)
    sd = {k: v.numpy() for k, v in from_jax_params(snapshot).items()}
    back, report = convert_state_dict(sd, tree)
    assert not report["missing"] and not report["unused"], report
    flat_back = _flat(back)
    assert set(flat_back) == set(snapshot)
    for k, v in snapshot.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)


# ---------------------------- composed layers ----------------------------


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    x = np.random.default_rng(10).normal(size=(1, 6, 7, 12)).astype(np.float32)
    jm = JL.GDN(inverse=inverse)
    params = _init(jm, x, 10)
    pm = PL.GDN(12, inverse=inverse)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        _close(_nhwc(pm(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


def test_residual_unit():
    x = np.random.default_rng(11).normal(size=(1, 6, 10, 16)).astype(np.float32)
    jm = JL.ResidualUnit(16)
    params = _init(jm, x, 11)
    pm = _load(PL.ResidualUnit(16), params, wrap="conv_a0")
    with torch.no_grad():
        _close(_nhwc(pm(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("hw", [(8, 8), (10, 13)])
def test_residual_block(hw):
    x = np.random.default_rng(12).normal(size=(2, *hw, 16)).astype(np.float32)
    jm = JL.ResidualBlock(16)
    params = _init(jm, x, 12)
    pm = _load(PL.ResidualBlock(16), params)
    with torch.no_grad():
        _close(_nhwc(pm(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("cin,hw", [(3, (16, 12)), (16, (11, 9))])
def test_residual_block_with_stride(cin, hw):
    x = np.random.default_rng(13).normal(size=(1, *hw, cin)).astype(np.float32)
    jm = JL.ResidualBlockWithStride(16, stride=2)
    params = _init(jm, x, 13)
    pm = _load(PL.ResidualBlockWithStride(cin, 16, 2), params)
    with torch.no_grad():
        _close(_nhwc(pm(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


def test_residual_block_upsample():
    x = np.random.default_rng(14).normal(size=(1, 5, 6, 24)).astype(np.float32)
    jm = JL.ResidualBlockUpsample(16, upsample=2)
    params = _init(jm, x, 14)
    pm = _load(PL.ResidualBlockUpsample(24, 16, 2), params)
    with torch.no_grad():
        _close(_nhwc(pm(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


# ---------------------------- window attention ----------------------------


def test_relative_position_index_and_shift_mask_match_jax():
    for w in (4, 8):
        np.testing.assert_array_equal(PW.relative_position_index(w), JW.relative_position_index(w))
        np.testing.assert_array_equal(PW.shift_window_mask(3, 2, w, w // 2),
                                      JW.shift_window_mask(3, 2, w, w // 2))


@pytest.mark.parametrize("typ", ["W", "SW"])
@pytest.mark.parametrize("window,head_dim", [(4, 8), (8, 16)])
def test_swin_transformer_block(typ, window, head_dim):
    """window 4 runs the composed WMSA; window 8 the flash block's plain
    version (the JAX side is its composed block in both cases)."""
    x = np.random.default_rng(15).normal(size=(2, 16, 24, 32)).astype(np.float32)
    jm = JW.SwinTransformerBlock(dim=32, head_dim=head_dim, window_size=window, type=typ)
    params = _init(jm, x, 15)
    pm = _load(PW.SwinTransformerBlock(32, head_dim, window, typ), params)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("typ", ["W", "SW"])
def test_wmsa(typ):
    x = np.random.default_rng(16).normal(size=(1, 8, 12, 16)).astype(np.float32)
    jm = JW.WMSA(dim=16, head_dim=8, window_size=4, type=typ)
    params = _init(jm, x, 16)
    pm = _load(PW.WMSA(16, 8, 4, typ), params)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))


def test_swin_block_pads_and_crops():
    """12x20 is not a multiple of the window 8: padded, run, cropped back."""
    x = np.random.default_rng(17).normal(size=(1, 12, 20, 32)).astype(np.float32)
    jm = JW.SwinBlock(dim=32, head_dim=16, window_size=8)
    params = _init(jm, x, 17)
    pm = _load(PW.SwinBlock(32, 16, 8), params)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))
