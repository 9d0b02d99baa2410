"""Port parity for the STanH slice: the quantizer (reslic_tcm_tpu_torch/
entropy/stanh.py), its entropy models and coding tables
(entropy/stanh_models.py), the STanH codecs (models/stanh/variants.py:
TCM-STanH, WACNN-STanH in its three refinement modes, the scale
hyperprior with a STanH z), the STanH train step, ``--freeze``, the beta
annealing copy, the snapshot bridge, the registry and the CLIs, against
the JAX package on the CPU.

Models, at the JAX tests' tiny widths: WACNN-STanH N=32, M=40 (the WACNN
ladders of tests/test_torch_port_wacnn.py), TCM-STanH N=32, M=40 (hyper_ch
24, SWAtten inter_dim 16, one block per stage), scale-STanH N=16, M=24.
Each has three rate levels with extrema 8 (16 steps) and the port's seeded
weights, carried to JAX by inverting the port's bridge; as in the WACNN
and Balle tests, GDN is perturbed off its init and the last convolutions
of g_a (and h_a, the scale transforms) are scaled so that y, z and sigma
span many levels and scale indexes, and each level's staircase is
perturbed off its uniform init so that the levels differ. Inputs are
numpy arrays from a seed.

Tolerances: the derived quantizer state, level indexes, levels and
interval bounds equal to JAX's (the soft and hard staircases within 1e-6
relative, sums in another order); the CDF tables bit-identical to the JAX
builders and to tests/golden/stanh_tables.json; module and forward
outputs within 1e-5 relative (max |port - jax| <= 1e-5 * max(1, max
|jax|)); y and z streams byte-identical to the JAX codecs' at every level,
the decoded y_hat exact. WACNN-STanH's encoder runs no synthesis, so its
streams do not depend on the refinement mode: each mode's port codec
(the same backbone, its own g_s) is held to the JAX codec's streams, and
its x_hat to JAX's synthesis of that mode. The train step: three
steps at levels 0, 1, 2 with beta 10, 25, 60 against one jitted JAX step
(lv and beta traced, XLA's optimisations off, as
tests/test_torch_port_train_parity.py), z's noise replayed: the port's
trajectory's losses within 1e-4 relative; from JAX's parameters at each
step, loss within 1e-5 relative and gap within 1e-5. The models have four
slices (M=40, ten channels each) to keep the JAX compiles short. Torch
runs on one intra-op thread.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.entropy import annealings as JA
from reslic_tcm_tpu.entropy import stanh as JS
from reslic_tcm_tpu.entropy import stanh_models as JSM
from reslic_tcm_tpu.models.stanh import variants as JV
from reslic_tcm_tpu.training.optimizer import configure_optimizers as jax_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.cli import train as ptrain
from reslic_tcm_tpu_torch.entropy import annealings as PA
from reslic_tcm_tpu_torch.entropy import stanh as PS
from reslic_tcm_tpu_torch.entropy import stanh_models as PSM
from reslic_tcm_tpu_torch.models import NOT_PORTED, get_model
from reslic_tcm_tpu_torch.models.base import replayed_noise
from reslic_tcm_tpu_torch.models.stanh import variants as PV
from reslic_tcm_tpu_torch.training.optimizer import freeze_all_but_stanh
from reslic_tcm_tpu_torch.training.step import create_train_state, train_step
from reslic_tcm_tpu_torch.utils.parser import parse_args as train_args
from reslic_tcm_tpu_torch.utils.torch_convert import (from_jax_params, is_deconv_path,
                                                      load_snapshot_into, torch_key)
from tests.test_golden_stanh import GOLDEN, _digest, _fact_tables, _scale_tables, _wb
from tests.test_torch_port_train_parity import _flat, _recording_uniform, _rel, _tree
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
TOL_STAIR = 1e-6
TOL_TRAJ = 1e-4
LEVELS = 3
GCFG = [{"beta": 10, "num_sigmoids": 0, "annealing": "gap_stoc", "symmetry": False,
         "gap_factor": 25, "extrema": 8, "trainable": True, "removing_mean": False}
        for _ in range(LEVELS)]
WACNN_TINY = dict(hyper_dims=(40, 36, 32), mean_dims=(32, 36, 40, 44), cc_dims=(28, 24, 20, 16),
                  num_slices=4)
TCM_TINY = dict(hyper_ch=24, atten_inter_dim=16, config=(1, 1, 1, 1, 1, 1), num_slices=4)
MODES = ("none", "convolution", "multiple")
SNAPSHOT = "checkpoints/wacnn_stanh_vr_r5.npz"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_fast_compiles():
    """Torch on one intra-op thread (beside other workers' XLA compiles more
    threads thrash) and XLA's optimisations off for this file's compiles."""
    threads = torch.get_num_threads()
    off = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", off)
    torch.set_num_threads(threads)


def _update(jc):
    """The JAX codec's update() with XLA's optimisations on: its eager
    exp(linspace) scale table rounds as the port's pinned copy only then."""
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        jc.update()
    finally:
        jax.config.update("jax_disable_most_optimizations", True)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err
    return err


def _image(h=128, w=128, seed=1, batch=1):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(batch, h // 16, w // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _to_jax(template: dict, sd: dict) -> dict:
    """The port's state dict as flat JAX parameters on ``template``'s paths:
    the port's bridge (``torch_key`` and its layout transforms) inverted,
    one to one."""
    keys = list(template)
    out = {}
    for path in keys:
        v = sd[torch_key(path, keys)].detach().cpu().numpy()
        if path.endswith("/kernel") and v.ndim == 4 and is_deconv_path(path):
            v = v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        elif path.endswith("/kernel") and v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
        elif path.endswith("/kernel") and v.ndim == 2:
            v = v.T
        assert v.shape == tuple(template[path].shape), (path, v.shape)
        out[path] = np.ascontiguousarray(v, np.float32)
    assert {torch_key(p, keys) for p in keys} == set(sd)
    return out


def _template(module, hw, **kwargs) -> dict:
    """{flax path: ShapeDtypeStruct} of the module's parameters."""
    tree = jax.eval_shape(lambda: module.init(
        {"params": KEY, "noise": KEY}, jnp.zeros((1, *hw, 3)), **kwargs))["params"]
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@torch.no_grad()
def _perturb(module, scaled, seed=0):
    """GDN off its init, ``scaled`` (layer, factor) pairs scaled, and each
    level's staircase moved off its uniform init (heights x exp(N(0,
    0.2)), positions + N(0, 0.15))."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    for name, p in module.named_parameters():
        if name.endswith(("beta", "gamma")):
            p.add_(t(np.abs(rng.normal(0, 0.01, p.shape))))
        elif name.endswith("stanh.w"):
            p.mul_(t(np.exp(rng.normal(0, 0.2, p.shape))))
        elif name.endswith("stanh.b"):
            p.add_(t(rng.normal(0, 0.15, p.shape)))
    for layer, factor in scaled:
        layer.weight.mul_(factor)
        layer.bias.mul_(factor)


# ------------------------------ quantizer ------------------------------


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("L", [11, 16, 32, 160])
def test_derived_state_equals_jax(symmetric, L):
    """Levels, midpoints and half-widths bit for bit: JAX's CPU cumsum and
    sum orders (trained-like heights)."""
    rng = np.random.default_rng(L + symmetric)
    for _ in range(5):
        w = (np.abs(rng.normal(1, 0.5, L)) * rng.uniform(0.05, 8)).astype(np.float32)
        b = rng.normal(0, 4, L).astype(np.float32)
        for got, want in zip(PS.np_state(w, b, symmetric), JS.np_state(w, b, symmetric)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("symmetric", [False, True])
def test_quantizer_functions_match_jax(symmetric):
    """soft/hard staircase, to_symbols (left side: a value on b_i counts
    b_i as not below it), from_symbols and interval_bounds at random
    values, at each b and at each level midpoint."""
    rng = np.random.default_rng(3 + symmetric)
    w0, b0 = JS.init_w_b(0, 8, symmetric)
    pw, pb = PS.init_w_b(0, 8, symmetric)
    np.testing.assert_array_equal(pw, w0)
    np.testing.assert_array_equal(pb, b0)
    w = (w0 * np.exp(rng.normal(0, 0.2, w0.shape))).astype(np.float32)
    b = (b0 + rng.normal(0, 0.15, b0.shape)).astype(np.float32)
    js = JS.derive_state(jnp.asarray(w), jnp.asarray(b), symmetric)
    ps = PS.derive_state(torch.from_numpy(w), torch.from_numpy(b), symmetric)
    on_points = np.concatenate([np.asarray(js.b), np.asarray(js.average_points),
                                np.asarray(js.cum_w)])
    x = np.concatenate([rng.normal(0, 6, 500).astype(np.float32), on_points,
                        np.float32([-1e4, 1e4, 0.0])]).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(PS.to_symbols(xt, ps).numpy(), np.asarray(JS.to_symbols(xj, js)))
    k = JS.to_symbols(xj, js)
    np.testing.assert_array_equal(PS.from_symbols(torch.from_numpy(np.array(k)), ps).numpy(),
                                  np.asarray(JS.from_symbols(k, js)))
    for got, want in zip(PS.interval_bounds(xt, ps), JS.interval_bounds(xj, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(PS.hard_quantize(xt, ps, symmetric), JS.hard_quantize(xj, js, symmetric), TOL_STAIR)
    for beta in (1.0, 10.0, 200.0):
        _close(PS.soft_quantize(xt, ps, beta), JS.soft_quantize(xj, js, beta), TOL_STAIR)


def test_tables_match_golden_and_jax():
    """Both table builders bit for bit: against tests/golden/stanh_tables.json
    and the JAX builders, and the scale tables of the snapshot's three
    trained staircases against the JAX builder."""
    import json

    with open(GOLDEN) as f:
        gold = json.load(f)
    w, b = _wb()
    scale_table = np.exp(np.linspace(np.log(0.11), np.log(64.0), 16)).astype(np.float32)
    got = PSM.build_stanh_scale_tables(w, b, False, scale_table)
    assert _digest(got) == gold["gaussian_stanh"] == _digest(_scale_tables())
    rng = np.random.default_rng(9)
    chain = {}
    dims = [1, 3, 3, 3, 3, 1]
    for i in range(5):
        chain[f"matrix{i}"] = rng.normal(-1.0, 0.3, (6, dims[i + 1], dims[i])).astype(np.float32)
        chain[f"bias{i}"] = rng.normal(0.0, 0.5, (6, dims[i + 1], 1)).astype(np.float32)
        if i < 4:
            chain[f"factor{i}"] = rng.normal(0.0, 0.1, (6, dims[i + 1], 1)).astype(np.float32)
    wf, bf = _wb(seed=6)
    got = PSM.build_stanh_factorized_tables(chain, wf, bf, False)
    assert _digest(got) == gold["factorized_stanh"] == _digest(_fact_tables())
    with np.load(SNAPSHOT) as z:
        sw, sb = (z[f"gaussian_conditional/stanh/{k}"].astype(np.float32) for k in "wb")
    from reslic_tcm_tpu_torch.ops.math import get_scale_table

    scale_table = get_scale_table().numpy()
    for lv in range(3):
        got = PSM.build_stanh_scale_tables(sw[lv], sb[lv], False, scale_table)
        want = JSM.build_stanh_scale_tables(sw[lv], sb[lv], False, scale_table)
        for name in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


# --------------------------- entropy models ---------------------------


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("removing_mean", [False, True])
def test_gaussian_conditional_matches_jax(training, removing_mean):
    """y_hat and likelihood at level 1 (training: soft staircase of y, or of
    y - mu with removing_mean; eval: hard staircase of y - mu) and the gap."""
    rng = np.random.default_rng(11 + 2 * training + removing_mean)
    jm = JSM.StanhGaussianConditional(n_rates=2, extrema=8, removing_mean=removing_mean)
    y = rng.normal(0, 4, (2, 6, 5, 8)).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 2, y.shape)).astype(np.float32)
    means = rng.normal(0, 2, y.shape).astype(np.float32)
    pm = PSM.StanhGaussianConditional(n_rates=2, extrema=8, removing_mean=removing_mean)
    _perturb(pm, [])
    v = {"params": {"stanh": {k: jnp.asarray(getattr(pm.stanh, k).detach().numpy())
                              for k in "wb"}}}
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    want = jm.apply(v, jnp.asarray(y), jnp.asarray(scales), jnp.asarray(means),
                    training=training, beta=25.0, lv=1)
    got = pm(nchw(y), nchw(scales), nchw(means), training=training, beta=25.0, lv=1)
    for g, w in zip(got, want):
        _close(g.detach().permute(0, 2, 3, 1), w)
    _close(pm.gap(nchw(y), 25.0, 1), jm.apply(v, jnp.asarray(y), 25.0, 1, method=jm.gap))


@pytest.mark.parametrize("training", [False, True])
def test_entropy_bottleneck_matches_jax(training):
    rng = np.random.default_rng(21 + training)
    z = rng.normal(0, 3, (2, 3, 4, 6)).astype(np.float32)
    jm = JSM.StanhEntropyBottleneck(6, extrema=8)
    pm = PSM.StanhEntropyBottleneck(6, extrema=8)
    _perturb(pm, [])
    with torch.no_grad():
        for name, p in pm.named_parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    params = {k: jnp.asarray(v) for k, v in pm.chain_params().items()}
    params["stanh"] = {k: jnp.asarray(getattr(pm.stanh, k).detach().numpy()) for k in "wb"}
    v = {"params": params}
    want = jm.apply(v, jnp.asarray(z), training=training, beta=20.0)
    got = pm(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))),
             training=training, beta=20.0)
    for g, w in zip(got, want):
        _close(g.detach().permute(0, 2, 3, 1), w)
    _close(pm.gap(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))), 20.0),
           jm.apply(v, jnp.asarray(z), 20.0, method=jm.gap))


# ------------------------------- codecs -------------------------------


@pytest.fixture(scope="module")
def wacnn():
    """{mode: (JAX module, flat JAX params, port codec)} with one shared
    backbone, and the JAX none-mode codec (updated)."""
    modules = {mode: JV.WACNNStanh(N=32, M=40, refinement=mode, **WACNN_TINY,
                                   **JV._stanh_kwargs(GCFG)) for mode in MODES}
    base = _template(modules["none"], (128, 128), training=True)
    ports = {}
    for mode in MODES:
        pc = PV.make_wacnn_stanh(GCFG, N=32, M=40, refinement=mode, device="cpu", seed=2,
                                 **WACNN_TINY)
        if mode == "none":
            m = pc.module
            _perturb(m, [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms])
            shared = pc.module.state_dict()
        else:
            pc.module.load_state_dict({k: v for k, v in shared.items()
                                       if not k.startswith("g_s.")}, strict=False)
        ports[mode] = pc
    out = {}
    for mode in MODES:
        template = dict(base)
        if mode == "convolution":
            template["refine/kernel"] = np.zeros((LEVELS, 40, 40), np.float32)
            template["refine/bias"] = np.zeros((LEVELS, 40), np.float32)
        elif mode == "multiple":
            template = {k: v for k, v in base.items() if not k.startswith("g_s/")}
            template.update({f"g_s_{i}/{k[4:]}": v for i in range(LEVELS)
                             for k, v in base.items() if k.startswith("g_s/")})
        out[mode] = (modules[mode], _to_jax(template, ports[mode].module.state_dict()),
                     ports[mode])
        ports[mode].update()
    jc = JV.StanhChannelARCodec(modules["none"], {"params": _tree(out["none"][1])})
    _update(jc)
    return out, jc


@pytest.fixture(scope="module")
def wacnn_forwards(wacnn):
    """The JAX none-mode eval forward of the 128x128 image at each level
    ({lv: output}) and, per mode, JAX's synthesis (``apply_synthesis``: g_s,
    refine then g_s, or clone lv) as a function of an NHWC y_hat and lv;
    lv traced, one compile each."""
    models, _ = wacnn
    jm, flat, _ = models["none"]
    f = jax.jit(lambda v, xx, lv: jm.apply(v, xx, training=False, lv=lv))
    forward = {lv: f({"params": _tree(flat)}, jnp.asarray(_image()), jnp.int32(lv))
               for lv in range(LEVELS)}
    synth = {}
    for mode, (m, fl, _) in models.items():
        g = jax.jit(lambda v, yy, lv, m=m: m.apply(v, yy, lv, method=type(m).apply_synthesis))
        synth[mode] = lambda y_hat, lv, g=g, v={"params": _tree(fl)}: np.asarray(
            g(v, jnp.asarray(y_hat.numpy()), jnp.int32(lv)))
    return forward, synth


@pytest.fixture(scope="module")
def wacnn_streams(wacnn):
    """{lv: the JAX codec's compress()} of the 128x128 image."""
    _, jc = wacnn
    return {lv: jc.compress(jnp.asarray(_image()), lv=lv) for lv in range(LEVELS)}


@pytest.mark.parametrize("mode", MODES)
def test_wacnn_stanh_forward_matches_jax(wacnn, wacnn_forwards, mode):
    """The eval forward at each level: both likelihoods, means and scales
    against the JAX forward (one backbone for every mode), x_hat against it
    in mode "none" and against JAX's synthesis of the port's y_hat in the
    others; the levels differ."""
    pc = wacnn[0][mode][2]
    forward, synth = wacnn_forwards
    bits = []
    for lv in range(LEVELS):
        want = forward[lv]
        got = pc.forward(_image(), lv=lv)
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])
        for k in ("means", "scales"):
            _close(got["para"][k], want["para"][k])
        if mode == "none":
            _close(got["x_hat"], want["x_hat"])
        else:
            y_hat = pc.forward_codec_consistent(_image(), lv=lv)["y_hat"]
            _close(got["x_hat"], synth[mode](y_hat, lv))
        bits.append(float(-torch.log2(got["likelihoods"]["y"]).sum()))
    assert len(set(bits)) == LEVELS


@pytest.mark.parametrize("mode", MODES)
def test_wacnn_stanh_streams_match_jax(wacnn, wacnn_streams, wacnn_forwards, mode):
    """Per level: y and z strings byte-identical to the JAX codec's, the
    decode exact, the decoded x_hat JAX's clipped synthesis of the decoded
    y_hat in this mode; y takes many levels."""
    pc = wacnn[0][mode][2]
    x = _image()
    for lv in range(LEVELS):
        want = wacnn_streams[lv]
        enc = pc.compress(x, lv=lv)
        assert enc["strings"] == want["strings"], lv
        sym, *_ = pc.encode_symbols(x, lv)
        assert len(np.unique(sym)) >= 8
        dec = pc.decompress(enc["strings"], enc["shape"], lv=lv)
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        _close(dec["x_hat"], np.clip(wacnn_forwards[1][mode](dec["y_hat"], lv), 0, 1))


def test_forward_codec_consistent_is_the_codec(wacnn):
    """forward_codec_consistent's y_hat, symbols and x_hat are the codec's;
    its y bits are within 3% of the coded y stream (16-bit tables)."""
    pc = wacnn[0]["none"][2]
    x = _image()
    for lv in range(LEVELS):
        cc = pc.forward_codec_consistent(x, lv=lv)
        enc = pc.compress(x, lv=lv)
        dec = pc.decompress(enc["strings"], enc["shape"], lv=lv)
        assert torch.equal(cc["y_hat"], enc["y_hat"])
        assert torch.equal(cc["x_hat"], dec["x_hat"])
        sym, *_ = pc.encode_symbols(x, lv)
        np.testing.assert_array_equal(cc["symbols"].reshape(1, -1).numpy(), sym)
        lik = cc["likelihoods"]["y"]
        assert bool(((lik > 0) & (lik <= 1)).all())


@pytest.fixture(scope="module")
def tcm_stanh():
    """(JAX module, JAX codec (updated), port codec) of TCM-STanH with the
    same weights."""
    jm = JV.TCMStanh(N=32, M=40, **TCM_TINY, **JV._stanh_kwargs(GCFG))
    template = _template(jm, (128, 128), training=True)
    pc = PV.make_tcm_stanh(GCFG, N=32, M=40, device="cpu", seed=3, **TCM_TINY)
    m = pc.module
    _perturb(m, [(m.g_a[-1], 20.0)] + [(t[-1], 30.0) for t in m.cc_scale_transforms])
    jc = JV.StanhChannelARCodec(jm, {"params": _tree(_to_jax(template, m.state_dict()))})
    _update(jc)
    pc.update()
    return jm, jc, pc


def test_tcm_stanh_forward_and_streams_match_jax(tcm_stanh):
    jm, jc, pc = tcm_stanh
    x = _image(seed=4)
    f = jax.jit(lambda v, xx, lv: jm.apply(v, xx, training=False, lv=lv))
    for lv in range(LEVELS):
        want = f(jc.variables, jnp.asarray(x), jnp.int32(lv))
        got = pc.forward(x, lv=lv)
        _close(got["x_hat"], want["x_hat"])
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])
        enc = pc.compress(x, lv=lv)
        assert enc["strings"] == jc.compress(jnp.asarray(x), lv=lv)["strings"], lv
        dec = pc.decompress(enc["strings"], enc["shape"], lv=lv)
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert len(np.unique(pc.encode_symbols(x, lv)[0])) >= 8


@pytest.mark.parametrize("model", ["tcm", "wacnn"])
def test_encode_stanh_matches_jax(tcm_stanh, wacnn, model):
    """The one-pass ``encode_stanh`` at levels 0 and 2 (lv traced, one
    compile a model) on the same image and scale table: the level indexes
    and scale indexes equal JAX's element for element (the port's NCHW
    slices in JAX's NHWC order), z within 1e-5; the symbols are the
    codec's."""
    if model == "tcm":
        jm, jc, pc = tcm_stanh
        variables = jc.variables
    else:
        jm, flat, pc = wacnn[0]["none"]
        variables = {"params": _tree(flat)}
    table = PV.get_scale_table().numpy()
    f = jax.jit(lambda v, xx, st, lv: jm.apply(v, xx, st, lv, method=type(jm).encode_stanh))
    x = _image(seed=6)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for lv in (0, 2):
        want = f(variables, jnp.asarray(x), jnp.asarray(table), jnp.int32(lv))
        got = pc.module.encode_stanh(xt, lv)
        for key in ("symbols", "indexes"):
            np.testing.assert_array_equal(got[key].permute(0, 1, 3, 4, 2).numpy(),
                                          np.asarray(want[key]), err_msg=f"{key} lv {lv}")
        _close(got["z"].permute(0, 2, 3, 1), want["z"])
        assert len(np.unique(got["symbols"].numpy())) >= 8
        sym, idx, *_ = pc.encode_symbols(x, lv)
        np.testing.assert_array_equal(
            got["symbols"].permute(1, 0, 2, 3, 4).reshape(1, -1).numpy(), sym)


def test_scale_stanh_forward_and_streams_match_jax():
    """z coded as STanH level indexes, y per image channel-major: both
    string lists byte-identical to the JAX codec's at each level, the
    decode exact (z and y)."""
    jm = JV.ScaleHyperpriorStanh(N=16, M=24, fact_stanh=True, **JV._stanh_kwargs(GCFG))
    template = _template(jm, (64, 64), training=True)
    pc = PV.make_scale_stanh(GCFG, N=16, M=24, device="cpu", seed=4)
    m = pc.module
    _perturb(m, [(m.g_a[6], 40.0), (m.h_a[4], 40.0), (m.h_s[4], 30.0)])
    assert not hasattr(m, "entropy_bottleneck")
    jc = JV.StanhHyperpriorCodec(jm, {"params": _tree(_to_jax(template, m.state_dict()))})
    _update(jc)
    pc.update()
    x = _image(64, 64, seed=5, batch=2)
    f = jax.jit(lambda v, xx, lv: jm.apply(v, xx, training=False, lv=lv))
    for lv in range(LEVELS):
        want = f(jc.variables, jnp.asarray(x), jnp.int32(lv))
        got = pc.forward(x, lv=lv)
        _close(got["x_hat"], want["x_hat"])
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])
        enc = pc.compress(x, lv=lv)
        jenc = jc.compress(jnp.asarray(x), lv=lv)
        assert enc["strings"] == jenc["strings"], lv
        assert len(enc["strings"][0]) == len(enc["strings"][1]) == 2
        dec = pc.decompress(enc["strings"], enc["shape"], lv=lv)
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert len(np.unique(enc["y_hat"].numpy())) >= 8
        _close(dec["x_hat"], jc.decompress(jenc["strings"], jenc["shape"], lv=lv)["x_hat"])


# ------------------------------ training ------------------------------

BETAS = (10.0, 25.0, 60.0)
LMBDAS = (0.0025, 0.013, 0.05)


@pytest.fixture(scope="module")
def train_run(wacnn):
    """Three steps of the jitted JAX train step and of the port's, step k at
    level k with beta BETAS[k], from the same weights and batch, z's noise
    replayed: the two trajectories, and the port's step k from JAX's
    parameters before JAX's step k."""
    jm, flat, pc = wacnn[0]["none"]
    params = _tree(flat)
    x = np.random.default_rng(7).uniform(size=(2, 128, 128, 3)).astype(np.float32)
    noise = []
    main_tx, aux_tx = jax_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    jax_steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording_uniform(noise))
        step = jax.jit(make_train_step(jm, main_tx, aux_tx))
        for k in range(3):
            noise.clear()
            start = from_jax_params(_flat(state.params))
            state, m = step(state, jnp.asarray(x), jnp.float32(LMBDAS[k]),
                            jax.random.PRNGKey(k), jnp.int32(k), jnp.float32(BETAS[k]))
            jax.effects_barrier()
            jax_steps.append({"metrics": {k2: float(v) for k2, v in m.items()},
                              "noise": list(noise), "start": start})

    def port_module(sd):
        module = PV.make_wacnn_stanh(GCFG, N=32, M=40, device="cpu", seed=2,
                                     **WACNN_TINY).module
        module.load_state_dict(sd)
        return module.train()

    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    ps = create_train_state(port_module(pc.module.state_dict()), 1e-4, 1e-3, 1.0)
    trajectory, from_jax = [], []
    for k, j in enumerate(jax_steps):
        draws = [torch.from_numpy(np.array(d)) for d in j["noise"]]
        m = train_step(ps, xt, LMBDAS[k], replayed_noise(draws), lv=k, beta=BETAS[k])
        trajectory.append({k2: float(v) for k2, v in m.items()})
        m = train_step(create_train_state(port_module(j["start"])), xt, LMBDAS[k],
                       replayed_noise(draws), lv=k, beta=BETAS[k])
        from_jax.append({k2: float(v) for k2, v in m.items()})
    return jax_steps, trajectory, from_jax


def test_train_draws_only_z_noise(train_run):
    """STanH slices draw no noise: one draw per step, z's [C, 1, B*H*W]."""
    assert all(len(s["noise"]) == 1 and s["noise"][0].shape == (32, 1, 2 * 2 * 2)
               for s in train_run[0])


@pytest.mark.parametrize("step", range(3))
def test_train_step_matches_jax(train_run, step):
    """The port's own three-step trajectory: loss, bpp, MSE and aux loss
    within 1e-4 relative. From JAX's parameters before step k: loss within
    1e-5 relative and gap within 1e-5. (The gap is a difference of two
    MSEs of y against its staircases and jumps where an element of y
    crosses a step; the two trajectories' parameters differ where Adam's
    normalised update meets a gradient near 0, which moves y enough to
    make it jump, so it is held where the parameters are the same.)"""
    want, got, from_jax = (train_run[0][step]["metrics"], train_run[1][step],
                           train_run[2][step])
    for key in ("loss", "bpp_loss", "mse_loss", "aux_loss"):
        assert _rel(got[key], want[key]) <= TOL_TRAJ, (step, key, got[key], want[key])
    assert _rel(from_jax["loss"], want["loss"]) <= TOL, (from_jax["loss"], want["loss"])
    assert abs(from_jax["gap"] - want["gap"]) <= TOL * max(1.0, abs(want["gap"])), (
        from_jax["gap"], want["gap"])
    assert want["gap"] > 0


def _train_steps(module, steps=2, frozen=()):
    """Two port steps on a seeded batch; (parameters before, after)."""
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    state = create_train_state(module.train(), 1e-3, 1e-3, 1.0)
    x = torch.from_numpy(_image(64, 64, seed=8, batch=2).transpose(0, 3, 1, 2).copy())
    gen = torch.Generator().manual_seed(0)
    for k in range(steps):
        train_step(state, x, 0.013, lambda s: torch.rand(s, generator=gen) - 0.5, lv=k % 2,
                   beta=20.0)
    return before, dict(module.named_parameters())


def test_frozen_quantizer_and_freeze_leave_their_parameters():
    """trainable=False: the staircases get no gradient and stay; --freeze
    (freeze_all_but_stanh): only the staircases, g_s and the quantiles
    move."""
    frozen_cfg = [dict(g, trainable=False) for g in GCFG]
    m = PV.make_wacnn_stanh(frozen_cfg, N=32, M=40, device="cpu", seed=5, **WACNN_TINY).module
    before, after = _train_steps(m)
    for name in ("gaussian_conditional.stanh.w", "gaussian_conditional.stanh.b"):
        assert torch.equal(before[name], after[name]), name
    assert not torch.equal(before["g_a.0.weight"], after["g_a.0.weight"])

    m = PV.make_wacnn_stanh(GCFG, N=32, M=40, device="cpu", seed=5, **WACNN_TINY).module
    frozen = freeze_all_but_stanh(m)
    assert "g_a.0.weight" in frozen and "entropy_bottleneck._matrix0" in frozen
    before, after = _train_steps(m)
    for name in before:
        moved = not torch.equal(before[name], after[name])
        assert moved == (name not in frozen), name
    assert not torch.equal(before["gaussian_conditional.stanh.w"][:2],
                           after["gaussian_conditional.stanh.w"][:2])


@pytest.mark.parametrize("kind", ["gap_stoc", "gap", "linear", "linear_stoc", "loss",
                                  "random", "triangle"])
def test_annealing_copy_matches_jax(kind):
    """The beta sequence of each schedule for a seeded stream of gaps and
    losses, from configure_annealings."""
    cfg = {"annealing": kind, "beta": 10, "gap_factor": 25}
    j, p = JA.configure_annealings(cfg), PA.configure_annealings(cfg)
    rng = random.Random(4)
    for epoch in range(40):
        gap, loss = rng.uniform(0, 0.05), rng.uniform(1, 2)
        assert p.step(gap=gap, epoch=epoch, loss=loss) == j.step(gap=gap, epoch=epoch,
                                                                 loss=loss)
    assert PA.configure_annealings({"annealing": "none"}) is None


def test_snapshot_loads_whole():
    """checkpoints/wacnn_stanh_vr_r5.npz fills WACNN-STanH (N=192, M=320,
    three levels, 16 steps, extrema 32/16/8): all 547 entries placed, none
    left over, the staircases as the JAX package reads them."""
    m = PV.WACNNStanh(N=192, M=320, n_rates=3, num_sigmoids=16, extrema=(32, 16, 8))
    assert load_snapshot_into(m, SNAPSHOT) == []
    with np.load(SNAPSHOT) as z:
        assert len(z.files) == 547 == len(m.state_dict())
        np.testing.assert_array_equal(m.gaussian_conditional.stanh.w.detach().numpy(),
                                      z["gaussian_conditional/stanh/w"].astype(np.float32))


def test_registry_builds_the_stanh_names():
    """Every name of the JAX registry builds in the port (none is refused),
    and the STanH names with their levels and annealings."""
    from reslic_tcm_tpu.models import models_dict

    assert NOT_PORTED == {}
    args = train_args(["--N", "32", "--M", "24", "--lambda_list", "0.0025", "0.013", "0.05",
                       "--gauss_extrema", "8", "8", "8"])
    for name in models_dict:
        args.model = name
        codec, *_ = get_model(args, device="cpu")
        assert isinstance(codec.module, torch.nn.Module) and callable(codec.update), name
    for name, cls, n_rates in (("wacnn_stanh", PV.WACNNStanh, 3), ("stanh", PV.TCMStanh, 3),
                               ("scale_stanh", PV.ScaleHyperpriorStanh, 1)):
        args.model = name
        codec, gcfg, ann_g, fcfg, ann_f = get_model(args, device="cpu")
        assert type(codec.module) is cls and codec.module.n_rates == n_rates
        assert len(gcfg) == n_rates and gcfg[0]["extrema"] == 8
        assert isinstance(ann_g, PA.StanhAnnealing) and ann_g.type == "gap_stoc"
        assert (fcfg is None) == (name == "wacnn_stanh")
        assert codec.module.M == (320 if name == "stanh" else 24)


def _png_dir(path, n, hw, seed):
    from PIL import Image

    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.uniform(size=(*hw, 3)) * 255).astype(np.uint8)).save(
            path / f"{i}.png")


def test_clis_take_wacnn_stanh(tmp_path, capsys):
    """``-m wacnn_stanh --freeze`` trains one step on the CPU (beta annealed,
    validation per level); the eval CLI's real codec and estimate run every
    level (``--lv -1``) or one."""
    for split in ("train", "test"):
        _png_dir(tmp_path / "data" / split / "data", 2, (96, 96), 1)
    argv = ["--platform", "cpu", "-m", "wacnn_stanh", "--N", "32", "--M", "40", "--freeze",
            "-d", str(tmp_path / "data"), "--patch-size", "64", "64", "--batch-size", "2",
            "--test-batch-size", "1", "-n", "1", "--lambda_list", "0.0025", "0.013",
            "--gauss_trainable", "yes", "yes", "--gauss_extrema", "8", "8", "-e", "1",
            "--save_path", str(tmp_path / "runs"), "--kodak", str(tmp_path / "none")]
    assert ptrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "freeze: training only stanh (+ g_s) parameters" in out
    assert "stanh beta after epoch 0:" in out and "valid epoch 0 (lv 1)" in out
    _png_dir(tmp_path / "eval", 1, (64, 64), 2)
    common = ["--data", str(tmp_path / "eval"), "--platform", "cpu", "--model", "wacnn_stanh",
              "--N", "32", "--M", "40", "--lambda_list", "0.0025", "0.013",
              "--gauss_extrema", "8", "8"]
    assert peval.main(common + ["--real"]) == 0
    lines = [s for s in capsys.readouterr().out.splitlines() if s.startswith("[level")]
    assert [s.split("]")[0] for s in lines] == ["[level 0", "[level 1"]
    assert peval.main(common + ["--lv", "1"]) == 0
    lines = [s for s in capsys.readouterr().out.splitlines() if s.startswith("[level")]
    assert len(lines) == 1 and lines[0].startswith("[level 1] average_PSNR:")
