"""Port parity for the gain codecs (reslic_tcm_tpu_torch/models/gain/:
gained.py, sc.py, extra_layers.py) against the JAX package's on the CPU:
gain interpolation and the init ladder, the gained scale and mean-scale
hyperpriors (forward, streams at several (s, l), decode), the
spatial-channel codec, the pooling and the auxiliary layers, the trained
``scale_gain_vr_r5.npz`` snapshot, the registry names and the CLIs.
tests/test_torch_port_gain_wacnn.py holds GainedWACNN, and
tests/test_torch_port_train_parity_gain.py one train step of each of the
two against the jitted JAX step.

Models: the port's seeded weights (GDN perturbed off its init; g_a's,
h_a's and h_s's last convolutions scaled so that y and z take many symbols
over many scale indexes) carried to JAX by inverting the port's bridge
(``tests/test_torch_port_stanh.py::_to_jax``), at N=16, M=24, three
levels with y gains 0.5 / 1 / 2 (as tests/test_gain_models.py sets them)
and z gains -0.8 / 1 / 1.25 (|G| is applied). Image:
64x64 from a seed.

Gain interpolation: linear equals JAX's bit for bit; geometric equals it
at l = 0 and 1, and within 3 ulp at 0.25 and 0.5, where XLA's float32
pow and torch's round differently by an ulp in about 1-3% of the
elements (two pows and their product: up to 3 ulp seen). The
streams at an interpolated point are therefore compared at JAX's gains
(the port's codec handed JAX's vectors); at integer levels at its own.

Tolerances: forward outputs and decoded x_hat within 1e-5 relative
(max |port - jax| <= 1e-5 * max(1, max |jax|)); streams byte-identical;
the port's decode reproduces its encoder's y_hat exactly. The snapshot at
N=192, M=320 on a 128x128 crop: y symbols that round the other way at
most 0.1%, bpp within 0.5% of JAX's. XLA's optimisations are off for
the file's JAX compiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.gain import extra_layers as JX
from reslic_tcm_tpu.models.gain import gained as JG
from reslic_tcm_tpu.models.gain import sc as JSC
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.data.synthetic import synth_image
from reslic_tcm_tpu_torch.models import get_model
from reslic_tcm_tpu_torch.models.base import ChannelARCodec
from reslic_tcm_tpu_torch.models.gain import extra_layers as PX
from reslic_tcm_tpu_torch.models.gain import gained as PG
from reslic_tcm_tpu_torch.models.gain import sc as PSC
from reslic_tcm_tpu_torch.training.codec_eval import compress_with_ac
from reslic_tcm_tpu_torch.utils.parser import parse_args as train_args
from reslic_tcm_tpu_torch.utils.torch_convert import (from_jax_params, load_snapshot,
                                                      load_snapshot_into)
from tests.test_torch_port_stanh import _close, _to_jax, _update
from tests.test_torch_port_train_parity import _flat, _tree
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
LAMBDAS = (0.0025, 0.013, 0.05)
POINTS = ((0, 0.0), (0, 0.5), (1, 0.0), (2, 0.0))
SNAPSHOT = "checkpoints/scale_gain_vr_r5.npz"
KEY = jax.random.PRNGKey(0)
Y_GAINS = (0.5, 1.0, 2.0)
Z_GAINS = (-0.8, 1.0, 1.25)


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


def _image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(1, h // 16, w // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _template(module, *inputs) -> dict:
    """{flax path: ShapeDtypeStruct} of the module's parameters."""
    tree = jax.eval_shape(lambda: module.init({"params": KEY, "noise": KEY}, *inputs,
                                              training=True))["params"]
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(jmodule, pmodule, *inputs) -> dict:
    """The port module's weights as the JAX module's parameter tree."""
    return _tree(_to_jax(_template(jmodule, *inputs), pmodule.state_dict()))


def _level_rows(values, channels):
    return torch.tensor(values, dtype=torch.float32)[:, None].expand(len(values), channels)


@torch.no_grad()
def _perturbed(module, scaled, y_gains, z_gains, seed=0):
    """GDN off its init, ``scaled`` (layer, factor) pairs scaled, and the
    gains set level by level (inverses 1 / gain)."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        if name.endswith(("beta", "gamma")):
            p.add_(torch.from_numpy(np.abs(rng.normal(0, 0.01, p.shape)).astype(np.float32)))
    for layer, factor in scaled:
        layer.weight.mul_(factor)
        layer.bias.mul_(factor)
    module.Gain.copy_(_level_rows(y_gains, module.Gain.shape[1]))
    module.InverseGain.copy_(1.0 / module.Gain)
    module.HyperGain.copy_(_level_rows(z_gains, module.HyperGain.shape[1]))
    module.InverseHyperGain.copy_(1.0 / module.HyperGain)
    return module


JAX_HYPER = {"scale": JG.GainedScaleHyperprior, "mean-scale": JG.GainedMSHyperprior}


def _hyper_pair(kind):
    """(JAX codec, port codec) of the gained hyperprior ``kind`` with the
    same weights, both updated."""
    pc = PG.make_gained_hyperprior(kind, N=16, M=24, lmbda_list=LAMBDAS, device="cpu", seed=3)
    m = pc.module
    _perturbed(m, ((m.g_a[6], 40.0), (m.h_a[4], 40.0), (m.h_s[4], 30.0)), Y_GAINS, Z_GAINS)
    jm = JAX_HYPER[kind](N=16, M=24, levels=3)
    jc = JG.GainedHyperpriorCodec(jm, {"params": _jax_params(jm, m, jnp.zeros((1, 64, 64, 3)))})
    _update(jc)
    pc.update()
    return jc, pc


@pytest.fixture(scope="module", params=sorted(JAX_HYPER))
def hyper(request):
    return _hyper_pair(request.param)


def _jax_gains(jc):
    """The port codec's ``_gains`` replaced by JAX's vectors."""
    return lambda name, s, l: torch.from_numpy(np.array(jc._gains(name, s, l)))


# ---------------------------- gain vectors ----------------------------


@pytest.mark.parametrize("l", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("mode", ["geometric", "linear"])
def test_interpolate_gain_matches_jax(mode, l):
    rng = np.random.default_rng(1)
    lo, hi = (rng.uniform(0.2, 3.0, 4096) * rng.choice([-1, 1], 4096)).astype(np.float32), (
        rng.uniform(0.2, 3.0, 4096) * rng.choice([-1, 1], 4096)).astype(np.float32)
    want = np.asarray(JG.interpolate_gain(jnp.asarray(lo), jnp.asarray(hi), l, mode))
    got = PG.interpolate_gain(torch.from_numpy(lo), torch.from_numpy(hi), l, mode).numpy()
    if mode == "linear" or l in (0.0, 1.0):
        np.testing.assert_array_equal(got, want)
    else:  # XLA's float32 pow and torch's differ by an ulp here and there
        np.testing.assert_array_max_ulp(got, want, maxulp=3)


@pytest.mark.parametrize("spread", [0.0, 2.0])
def test_gain_init_spread_ladder_matches_jax(spread):
    """The four gain matrices at init, with the ladder (spread 2) and
    without (ones): JAX's module initialised for its gains alone."""
    jm = JG.GainedScaleHyperprior(N=16, M=32, levels=3, gain_init_spread=spread)
    want = jm.init({"params": KEY}, method=lambda m: m.Gain)["params"]
    got = PG.GainedScaleHyperprior(N=16, M=32, levels=3, gain_init_spread=spread)
    for name in PG.GAIN_NAMES:
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      np.asarray(want[name]))
    if spread:
        np.testing.assert_allclose(got.Gain[:, 0].detach().numpy(), [0.5, 1.0, 2.0], rtol=1e-6)


# ------------------------- gained hyperpriors -------------------------


def test_gained_hyperprior_forward_matches_jax(hyper):
    """x_hat and both likelihoods at each level; the levels code different
    rates (bigger y gain, more bits)."""
    jc, pc = hyper
    x = _image()
    rates = []
    for lv in range(3):
        want = jc.module.apply(jc.variables, jnp.asarray(x), training=False, lv=lv)
        got = pc.forward(x, lv)
        _close(got["x_hat"], want["x_hat"])
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])
        rates.append(float(-torch.log2(got["likelihoods"]["y"]).sum()))
    assert rates[0] < rates[1] < rates[2]


@pytest.mark.parametrize("s,l", POINTS)
def test_gained_hyperprior_streams_match_jax(hyper, monkeypatch, s, l):
    """Streams byte-identical to the JAX codec's at (s, l); the port's
    decode reproduces its encoder's y_hat, its x_hat equals JAX's decoded
    one, and at an integer level the forward's clipped x_hat."""
    jc, pc = hyper
    x = _image(seed=1)
    if l:
        monkeypatch.setattr(pc, "_gains", _jax_gains(jc))
    jenc = jc.compress(jnp.asarray(x), s=s, l=l)
    penc = pc.compress(x, s, l)
    assert penc["strings"] == jenc["strings"]
    assert tuple(penc["shape"]) == tuple(jenc["shape"])
    assert float(penc["y_hat"].abs().max()) >= 4  # y takes many symbols
    dec = pc.decompress(penc["strings"], penc["shape"], s, l)
    assert torch.equal(dec["y_hat"], penc["y_hat"])
    _close(dec["x_hat"], jc.decompress(jenc["strings"], jenc["shape"], s=s, l=l)["x_hat"])
    if not l:
        fwd = pc.forward(x, s)
        np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                                   atol=TOL)


def test_interpolated_point_of_the_port_codes_between_its_levels(hyper):
    """With its own gains the port codes (s=0, l=1) as (s=1, l=0), byte for
    byte, and (s=0, l=0.5) at a size between levels 0 and 1."""
    _, pc = hyper
    x = _image(seed=1)
    size = {(s, l): sum(len(b) for g in pc.compress(x, s, l)["strings"] for b in g)
            for s, l in ((0, 0.0), (0, 0.5), (1, 0.0))}
    assert pc.compress(x, 0, 1.0)["strings"] == pc.compress(x, 1, 0.0)["strings"]
    assert size[(0, 0.0)] <= size[(0, 0.5)] <= size[(1, 0.0)]


def test_bridge_round_trips_the_gain_parameters(hyper):
    """from_jax_params maps each JAX parameter, the four gain matrices
    among them, onto the port parameter it came from."""
    jc, pc = hyper
    sd = from_jax_params(_flat(jc.params))
    own = pc.module.state_dict()
    assert set(sd) == set(own) and set(PG.GAIN_NAMES) <= set(sd)
    for k in own:
        assert torch.equal(sd[k], own[k]), k


def test_gained_hyperprior_through_compress_with_ac(hyper):
    """compress_with_ac codes a gained hyperprior at (s=lv, l=0), the JAX
    function's route for it: its bpp is the stream size at that level."""
    jc, pc = hyper
    img = _image(seed=2)[0]
    for lv in range(3):
        records = []
        bpp, _ = compress_with_ac(pc, [img], lv=lv, verbose=False, records=records)
        enc = pc.compress(img[None], lv, 0.0)
        assert bpp == sum(len(b) for g in enc["strings"] for b in g) * 8.0 / (64 * 64)
        assert records[0]["y_hat_exact"]


# ------------------------------ SC codec ------------------------------


@pytest.fixture(scope="module")
def sc_pair():
    pc = PSC.make_sc_gained(N=16, M=24, lmbda_list=(0.01, 0.05), device="cpu", seed=5)
    m = pc.module
    _perturbed(m, ((m.g_a4[0], 40.0), (m.h_a[4], 40.0), (m.h_s[4], 30.0)), (0.7, 1.5),
               (1.0, -1.25))
    jm = JSC.SCGainedHyperprior(N=16, M=24, levels=2)
    params = _jax_params(jm, m, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)))
    jc = JSC.SCGainedCodec(jm, {"params": params})
    _update(jc)
    pc.update()
    qmap = np.random.default_rng(6).uniform(size=(1, 64, 64, 1)).astype(np.float32)
    return jc, pc, qmap


def test_sc_forward_matches_jax(sc_pair):
    jc, pc, qmap = sc_pair
    x = _image(seed=4)
    for lv in range(2):
        want = jc.module.apply(jc.variables, jnp.asarray(x), jnp.asarray(qmap), training=False,
                               lv=lv)
        got = pc.forward(x, qmap, lv)
        _close(got["x_hat"], want["x_hat"])
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])


def test_sc_streams_match_jax_and_decode_exactly(sc_pair, monkeypatch):
    """At (s=0, l=0.5), with JAX's interpolated gains."""
    jc, pc, qmap = sc_pair
    x = _image(seed=4)
    monkeypatch.setattr(pc, "_gains", _jax_gains(jc))
    jenc = jc.compress(jnp.asarray(x), jnp.asarray(qmap), s=0, l=0.5)
    penc = pc.compress(x, qmap, 0, 0.5)
    assert penc["strings"] == jenc["strings"]
    assert float(penc["y_hat"].abs().max()) >= 4
    dec = pc.decompress(penc["strings"], penc["shape"], 0, 0.5)
    assert torch.equal(dec["y_hat"], penc["y_hat"])
    _close(dec["x_hat"], jc.decompress(jenc["strings"], jenc["shape"], s=0, l=0.5)["x_hat"])


def test_sc_codec_is_refused_by_compress_with_ac(sc_pair):
    with pytest.raises(ValueError, match="quality map"):
        compress_with_ac(sc_pair[1], [_image()[0]], verbose=False)


@pytest.mark.parametrize("out_hw", [(6, 5), (3, 1), (5, 4), (7, 3), (16, 14)])
def test_adaptive_avg_pool_matches_jax(out_hw):
    """The block mean (integer ratios) and jax.image.resize's linear path
    (the others, shrinking and growing)."""
    x = np.random.default_rng(7).normal(size=(2, 12, 10, 3)).astype(np.float32)
    want = np.asarray(JSC.adaptive_avg_pool(jnp.asarray(x), out_hw))
    got = PSC.adaptive_avg_pool(torch.from_numpy(x.transpose(0, 3, 1, 2)), out_hw)
    _close(got.permute(0, 2, 3, 1), want, tol=1e-6)


@pytest.mark.parametrize("passthrough_bug", [False, True])
def test_extra_layers_match_jax(passthrough_bug):
    """NonLocalAttention (three ResBlocks per branch) with JAX's weights
    through the bridge, in both settings of the reference's pass-through."""
    jm = JX.NonLocalAttention(channels=8, passthrough_bug=passthrough_bug)
    x = np.random.default_rng(8).normal(size=(1, 12, 10, 8)).astype(np.float32)
    params = jm.init(KEY, jnp.zeros((1, 12, 10, 8)))["params"]
    flat = {k: v * 8.0 if k.endswith("activate/conv/bias") else v
            for k, v in _flat(params).items()}  # push the sigmoid off 1/2
    pm = PX.NonLocalAttention(8, passthrough_bug=passthrough_bug)
    pm.load_state_dict(from_jax_params(flat), strict=True)
    want = np.asarray(jm.apply({"params": _tree(flat)}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    _close(got, want)
    assert np.array_equal(want, x) == passthrough_bug


# ------------------------------ snapshot ------------------------------


def test_snapshot_loads_whole():
    """checkpoints/scale_gain_vr_r5.npz fills the gained scale hyperprior
    (N=192, M=320, three levels): all 59 entries placed, none left over."""
    m = PG.GainedScaleHyperprior(N=192, M=320, levels=3)
    assert load_snapshot_into(m, SNAPSHOT) == []
    with np.load(SNAPSHOT) as z:
        assert len(z.files) == 59 == len(m.state_dict())
        for name in PG.GAIN_NAMES:
            np.testing.assert_array_equal(getattr(m, name).detach().numpy(),
                                          z[name].astype(np.float32))


@pytest.fixture(scope="module")
def snapshot_pair():
    """Both codecs from the snapshot, upcast to float32 on both sides."""
    flat = load_snapshot(SNAPSHOT)
    jc = JG.GainedHyperpriorCodec(JG.GainedScaleHyperprior(N=192, M=320, levels=3),
                                  {"params": _tree(flat)})
    pc = PG.make_gained_hyperprior("scale", N=192, M=320, lmbda_list=LAMBDAS, device="cpu")
    assert load_snapshot_into(pc.module, SNAPSHOT) == []
    _update(jc)
    pc.update()
    x = synth_image(np.random.default_rng(11), 256, 256)[None, 64:192, 64:192]
    return jc, pc, np.ascontiguousarray(x)


@pytest.mark.parametrize("lv", range(3))
def test_snapshot_codec_matches_jax(snapshot_pair, lv):
    """On a 128x128 crop at each level: y symbols that round the other way
    at most 0.1%, bpp within 0.5% of JAX's; the port decodes exactly."""
    jc, pc, x = snapshot_pair
    m = jc.module
    gains = [jc._gains(n, lv, 0.0) for n in ("Gain", "HyperGain")]
    y_jax, _ = m.apply(jc.variables, jnp.asarray(x), *gains, method=type(m).analyze_gained)
    penc = pc.compress(x, lv, 0.0)
    flips = int((np.round(np.asarray(y_jax)) != penc["y_hat"].numpy()).sum())
    assert flips <= 1e-3 * penc["y_hat"].numel(), flips
    jbytes = sum(len(b) for g in jc.compress(jnp.asarray(x), s=lv)["strings"] for b in g)
    pbytes = sum(len(b) for g in penc["strings"] for b in g)
    assert abs(pbytes - jbytes) <= 5e-3 * jbytes, (pbytes, jbytes)
    dec = pc.decompress(penc["strings"], penc["shape"], lv, 0.0)
    assert torch.equal(dec["y_hat"], penc["y_hat"])


# ------------------------- registry and CLIs -------------------------


def test_get_model_builds_the_gain_names():
    """The gain names as the JAX registry builds them: one level per lambda,
    the ladder from --gain_init_spread (not for scale_gain_sc; the ladder's
    values against JAX's: test_gain_init_spread_ladder_matches_jax)."""
    args = train_args(["--N", "16", "--M", "40", "--lambda_list", *map(str, LAMBDAS),
                       "--gain_init_spread", "2"])
    for name, cls, codec_cls in (("scale_gain", PG.GainedScaleHyperprior,
                                  PG.GainedHyperpriorCodec),
                                 ("wacnn_gain", PG.GainedWACNN, ChannelARCodec),
                                 ("scale_gain_sc", PSC.SCGainedHyperprior, PSC.SCGainedCodec)):
        args.model = name
        codec, *rest = get_model(args, device="cpu")
        assert rest == [None] * 4
        assert type(codec.module) is cls and type(codec) is codec_cls
        assert codec.module.levels == 3 and codec.module.Gain.shape == (3, 40)
        assert codec.module.Gain.detach()[0, 0].item() == (1.0 if name == "scale_gain_sc" else 0.5)


def _png_dir(path, sizes):
    from PIL import Image

    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    for i, hw in enumerate(sizes):
        Image.fromarray((rng.uniform(size=(*hw, 3)) * 255).astype(np.uint8)).save(
            path / f"{i}.png")


def test_eval_cli_takes_the_gain_names(tmp_path, capsys):
    """``--model scale_gain`` through the generic branch on the CPU: one
    line per level (from the lambdas), real and estimated;
    ``scale_gain_sc`` is refused with JAX's message."""
    _png_dir(tmp_path, [(64, 64), (64, 128)])
    common = ["--data", str(tmp_path), "--platform", "cpu", "--N", "16", "--M", "24",
              "--lambda_list", *map(str, LAMBDAS)]
    assert peval.main(common + ["--model", "scale_gain", "--real"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in lines if ln.startswith("[level")] == [
        "[level 0", "[level 1", "[level 2"]
    assert peval.main(common + ["--model", "scale_gain", "--lv", "1"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("[level 1] average_PSNR:")
    assert peval.main(common + ["--model", "scale_gain_sc"]) == 1
    assert "needs a quality map" in capsys.readouterr().out
