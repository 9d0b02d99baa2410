"""The bf16 mode (``set_matmul_precision("bfloat16")``) of the port's WACNN,
Balle mean-scale hyperprior, gained scale hyperprior and scale-STanH
codecs on the CPU, against the JAX codecs in the same mode, at the tiny
widths of tests/test_torch_port_wacnn.py, ..._balle.py, ..._gain.py and
..._stanh.py (their weights and perturbations; the Balle codec's weights
are the port's seeded ones, perturbed as ..._balle.py perturbs its own).

What the JAX codecs' bf16 mode does on the CPU: XLA's CPU backend ignores
``jax.default_matmul_precision``, so the Balle, gain and STanH hyperpriors
compute as in fp32, and WACNN differs only by its explicit casts (the
composed window attention's q, k and v in bf16). The port rounds every
conv, transposed conv and linear operand to bf16 as the TPU does, and runs
B1's attention-only plain bf16 version and the composed bf16 window-4
attention. So the forwards differ by the port's operand rounding and, where
y - mu lands near a half, by a symbol that rounds the other way.
Tolerances, with what the run shows (the largest over the four codecs,
WACNN's but for bpp): x_hat mean |port - jax| <= 1e-2 and max <= 0.1
(5.6e-3 and 0.059); at most 2% of the y and of the z likelihoods beyond
1e-2 (0.86% and 0); bpp within 2% (0.29%, the gained hyperprior). The mode
must move x_hat from the fp32 mode's by a mean above 1e-4 (the least, the
gained hyperprior's: 8.5e-4), so a mode that rounds nothing fails.

The port's own bf16 codec decodes y_hat exactly and its decoded x_hat is
its bf16 forward's clipped x_hat within 1e-5; switching the mode back to
None gives the fp32 outputs again, bit for bit. JAX compiles with
``jax_disable_most_optimizations``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models import balle2018 as JB
from reslic_tcm_tpu.models.base import ChannelARCodec as JChannelARCodec
from reslic_tcm_tpu.models.stanh import variants as JV
from reslic_tcm_tpu.models.wacnn import WACNN as JWACNN
from reslic_tcm_tpu.utils.torch_convert import convert_state_dict
from reslic_tcm_tpu_torch.models import balle2018 as PB
from reslic_tcm_tpu_torch.models.stanh import variants as PV
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.ops.launches import launch_counts
from reslic_tcm_tpu_torch.ops.layers import Deconv, StackedConv1x1, matmul_precision
from tests.test_torch_port_gain import _hyper_pair
from tests.test_torch_port_stanh import GCFG, _perturb, _template, _to_jax, _update
from tests.test_torch_port_train_parity import _tree
from torch_port_threads import one_torch_thread  # noqa: E402,F401

BF16 = torch.bfloat16
TINY = dict(hyper_dims=(40, 36, 32), mean_dims=(32, 36, 40, 44), cc_dims=(28, 24, 20, 16))


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


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(1, h // 16, w // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _wacnn():
    """tests/test_torch_port_wacnn.py's pair: the port's seeded weights, GDN
    perturbed, y and sigma scaled into the coder's range, on a JAX template."""
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
    params, report = convert_state_dict({k: v.numpy() for k, v in m.state_dict().items()},
                                        template)
    assert report == {"missing": [], "unused": []}
    return JChannelARCodec(module, {"params": params}), pc


def balle_pair(kind: str):
    """(JAX codec, port codec) of a Balle hyperprior at N=16, M=24 with the
    port's seeded weights, perturbed as tests/test_torch_port_balle.py
    perturbs its pair (GDN off its init; g_a's, h_a's and h_s's last
    convolutions scaled by 40, 40 and 30), carried to a JAX template (no
    eager JAX init)."""
    pc = PB.make_balle(kind, N=16, M=24, device="cpu", seed=5)
    m = pc.module
    _perturb(m, [(m.g_a[6], 40.0), (m.h_a[4], 40.0), (m.h_s[4], 30.0)])
    jm = {"scale": JB.ScaleHyperprior, "mean-scale": JB.MeanScaleHyperprior}[kind](N=16, M=24)
    template = _template(jm, (64, 64), training=True)
    return JB.HyperpriorCodec(jm, {"params": _tree(_to_jax(template, m.state_dict()))}), pc


def _balle():
    return balle_pair("mean-scale")


def _scale_stanh():
    """tests/test_torch_port_stanh.py's scale-STanH pair (STanH z and y)."""
    jm = JV.ScaleHyperpriorStanh(N=16, M=24, fact_stanh=True, **JV._stanh_kwargs(GCFG))
    template = _template(jm, (64, 64), training=True)
    pc = PV.make_scale_stanh(GCFG, N=16, M=24, device="cpu", seed=4)
    m = pc.module
    _perturb(m, [(m.g_a[6], 40.0), (m.h_a[4], 40.0), (m.h_s[4], 30.0)])
    return JV.StanhHyperpriorCodec(jm, {"params": _tree(_to_jax(template, m.state_dict()))}), pc


# name -> (maker of the (JAX codec, port codec) pair, image side, rate level)
CODECS = {"wacnn": (_wacnn, 128, 0), "balle-mean-scale": (_balle, 64, 0),
          "scale-gain": (lambda: _hyper_pair("scale"), 64, 1),
          "scale-stanh": (_scale_stanh, 64, 1)}


@pytest.fixture(scope="module", params=sorted(CODECS))
def codec(request):
    """The pair, both updated, the image, JAX's bf16 forward of it at the
    level and the port's fp32 forward."""
    make, side, lv = CODECS[request.param]
    jc, pc = make()
    if request.param != "scale-gain":  # _hyper_pair updates both
        _update(jc)
        pc.update()
    x = _image(side, side, seed=3)
    jc.set_matmul_precision("bfloat16")
    jax_bf16 = jc.forward(jnp.asarray(x), training=False, lv=lv)
    return {"name": request.param, "pc": pc, "x": x, "lv": lv, "jax_bf16": jax_bf16,
            "port_fp32": pc.forward(x, lv)}


@pytest.fixture
def bf16_codec(codec):
    pc = codec["pc"]
    pc.set_matmul_precision("bfloat16")
    yield pc
    pc.set_matmul_precision(None)


def _bpp(likelihoods, pixels) -> float:
    return sum(float(-np.log2(np.asarray(v, np.float64)).sum())
               for v in likelihoods.values()) / pixels


def test_bf16_forward_matches_jax_bf16_forward(codec, bf16_codec):
    before = (launch_counts(), launch_counts(BF16))
    got = bf16_codec.forward(codec["x"], codec["lv"])
    assert (launch_counts(), launch_counts(BF16)) == before  # CPU tensors launch nothing
    want = codec["jax_bf16"]
    d = np.abs(got["x_hat"].numpy() - np.asarray(want["x_hat"]))
    assert d.mean() <= 1e-2 and d.max() <= 0.1, (d.mean(), d.max())
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for k in want["likelihoods"]:
        dk = np.abs(got["likelihoods"][k].numpy() - np.asarray(want["likelihoods"][k]))
        assert np.mean(dk > 1e-2) <= 0.02, (k, np.mean(dk > 1e-2))
    pixels = codec["x"].shape[1] * codec["x"].shape[2]
    bpp, want_bpp = _bpp(got["likelihoods"], pixels), _bpp(want["likelihoods"], pixels)
    assert abs(bpp - want_bpp) <= 2e-2 * want_bpp, (bpp, want_bpp)
    moved = float((got["x_hat"] - codec["port_fp32"]["x_hat"]).abs().mean())
    assert moved > 1e-4, moved


def test_bf16_roundtrip_is_exact(codec, bf16_codec):
    x, lv = codec["x"], codec["lv"]
    enc = bf16_codec.compress(x, lv)
    dec = bf16_codec.decompress(enc["strings"], enc["shape"], lv)
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert len(np.unique(enc["y_hat"].numpy())) >= 4  # y takes several symbols
    fwd = bf16_codec.forward(x, lv)
    np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                               atol=1e-5)


def test_precision_none_gives_the_fp32_bits_back(codec):
    pc, x, lv = codec["pc"], codec["x"], codec["lv"]
    pc.set_matmul_precision("bfloat16")
    assert pc.compute_dtype is BF16
    pc.forward(x, lv)
    pc.set_matmul_precision(None)
    again = pc.forward(x, lv)
    want = codec["port_fp32"]
    assert torch.equal(again["x_hat"], want["x_hat"])
    for k in want["likelihoods"]:
        assert torch.equal(again["likelihoods"][k], want["likelihoods"][k])
    with pytest.raises(ValueError, match="precision"):
        pc.set_matmul_precision("float16")


def test_deconv_and_stacked_conv_follow_the_precision():
    """The two layers the Conv2d/Linear subclasses do not cover: in fp32 the plain
    products, under bf16 bf16 operands with fp32 sums, the result rounded to
    bf16 before the fp32 bias (Conv2d's rounding); parameter names
    unchanged."""
    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    rd = lambda a: a.to(BF16).float()  # noqa: E731
    de = Deconv(6, 4, 5, 2)
    sc = StackedConv1x1(3, 6, 5)
    with torch.no_grad():
        sc.weight.copy_(t(3, 6, 5))
        sc.bias.copy_(t(3, 5))
        x = t(2, 6, 8, 8)
        fp32 = (de(x), sc(x, 2))
        with matmul_precision("bfloat16"):
            got = (de(x), sc(x, 2))
        want = (rd(torch.nn.functional.conv_transpose2d(rd(x), rd(de.weight), None, 2, 2, 1))
                + de.bias[:, None, None],
                rd(torch.einsum("bihw,io->bohw", rd(x), rd(sc.weight[2])))
                + sc.bias[2][:, None, None])
    assert set(dict(de.named_parameters())) == {"weight", "bias"}
    assert set(dict(sc.named_parameters())) == {"weight", "bias"}
    for g, w, f in zip(got, want, fp32):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
        assert float((g - f).abs().max()) > 1e-3
    assert torch.equal(fp32[0], torch.nn.ConvTranspose2d.forward(de, x))
