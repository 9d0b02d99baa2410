"""Port parity for the Balle-2018 slice: FactorizedPrior, ScaleHyperprior
and MeanScaleHyperprior of reslic_tcm_tpu_torch/models/balle2018.py, their
host codec and the Gaussian conditional's coding against the JAX package,
the registry names and the CLIs on the CPU, and a mean-scale train step
against the JAX package's jitted ``make_train_step``.

Models: the JAX package's ``make_balle`` at N=16, M=24 (the size of
tests/test_model_families.py), its parameters carried to the port by
``from_jax_params``. At random init y (std 0.05) and z round to zero and
sigma is one value everywhere, so the fixture perturbs GDN off its
constant (and symmetric) init and scales g_a's, h_a's and h_s's last
convolutions up: y and z then take many symbols and sigma spans some
twenty scale indexes. Image: 64x64 from a seed, as in the JAX tests.

Tolerances: forward outputs (float32, other summation orders) within
1e-5 relative (max |port - jax| <= 1e-5 * max(1, max |jax|)); streams
byte-identical; the port's decode reproduces its encoder's y_hat exactly
and its decoded x_hat is the forward's clipped x_hat within 1e-5. The
train step: as tests/test_torch_port_train_parity.py, step 1's loss, bpp
and MSE within 1e-5 relative, gradients per tensor within 1e-3 of its
max, each of three steps' loss, bpp and aux loss within 1e-4; one JAX step
compiled for the file, with XLA's optimisations off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.entropy.gaussian import GaussianConditional as JGaussianConditional
from reslic_tcm_tpu.models.balle2018 import HyperpriorCodec as JHyperpriorCodec
from reslic_tcm_tpu.models.balle2018 import make_balle as jax_make_balle
from reslic_tcm_tpu.training.optimizer import configure_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.cli import train as ptrain
from reslic_tcm_tpu_torch.entropy.gaussian import GaussianConditional
from reslic_tcm_tpu_torch.models import NOT_PORTED, get_model
from reslic_tcm_tpu_torch.models import balle2018 as PB
from reslic_tcm_tpu_torch.models.base import replayed_noise
from reslic_tcm_tpu_torch.training.codec_eval import bpp_calculation, compress_with_ac
from reslic_tcm_tpu_torch.training.step import create_train_state, train_step
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from tests.test_torch_port_train_parity import (B1, LMBDA, STEPS, TOL_GRAD, TOL_LOSS,
                                                TOL_TRAJ, _adam_mu, _flat, _recording_uniform,
                                                _rel, _tree)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
KINDS = ("factorized", "scale", "mean-scale")
# flax paths of the last convolutions the fixture scales, and by how much
SCALED = {"g_a/layers_6/conv": 40.0, "h_a/layers_4/conv": 40.0, "h_s/layers_4/conv": 30.0}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _image(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(1, h // 16, w // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    img += rng.normal(scale=0.02, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _perturbed(flat: dict) -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for key, v in flat.items():
        if key.endswith(("/beta", "/gamma")):
            v = v + np.abs(rng.normal(0, 0.01, v.shape)).astype(np.float32)
        out[key] = v * SCALED.get(key.rsplit("/", 1)[0], 1.0)
    return out


def _pair(kind):
    """(JAX codec, port codec, flat JAX params) with identical weights, both
    updated."""
    jc = jax_make_balle(kind, N=16, M=24, input_shape=(64, 64))
    flat = _perturbed(_flat(jc.params))
    jc = JHyperpriorCodec(jc.module, {"params": _tree(flat)})
    pc = PB.make_balle(kind, N=16, M=24, device="cpu")
    pc.module.load_state_dict(from_jax_params(flat), strict=True)
    jc.update()
    pc.update()
    return jc, pc, flat


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    return _pair(request.param)


def test_forward_matches_jax(pair):
    jc, pc, _ = pair
    x = _image()
    want = jc.forward(jnp.asarray(x), training=False)
    got = pc.forward(x)
    _close(got["x_hat"], want["x_hat"])
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for k in want["likelihoods"]:
        _close(got["likelihoods"][k], want["likelihoods"][k])


def test_streams_match_jax_and_decode_exactly(pair):
    """y and z strings byte-identical to the JAX codec's (not all zeros);
    the port's decode reproduces its encoder's y_hat and JAX's decoded
    x_hat, and equals its own forward's clipped x_hat."""
    jc, pc, _ = pair
    x = _image()
    jenc = jc.compress(jnp.asarray(x))
    penc = pc.compress(x)
    assert penc["strings"] == jenc["strings"]
    assert tuple(penc["shape"]) == tuple(jenc["shape"])
    assert len(penc["strings"]) == (1 if isinstance(pc.module, PB.FactorizedPrior) else 2)
    assert float(penc["y_hat"].abs().max()) >= 4  # y takes many symbols
    dec = pc.decompress(penc["strings"], penc["shape"])
    assert torch.equal(dec["y_hat"], penc["y_hat"])
    _close(dec["x_hat"], jc.decompress(jenc["strings"], jenc["shape"])["x_hat"])
    fwd = pc.forward(x)
    np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                               atol=TOL)


def test_bridge_fills_every_parameter(pair):
    """from_jax_params maps each JAX Balle parameter to exactly one port
    parameter of its shape (the Deconv kernels transposed and flipped)."""
    _, pc, flat = pair
    sd = from_jax_params(flat)
    own = pc.module.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in own)


@pytest.mark.parametrize("with_means", [False, True])
def test_gaussian_conditional_codes_like_jax(with_means):
    """GaussianConditional's likelihood, indexes, compress and decompress
    against the JAX package's on NHWC arrays, with and without means."""
    rng = np.random.default_rng(3 + with_means)
    values = rng.normal(0, 4, (2, 6, 5, 8)).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 3, values.shape)).astype(np.float32)
    means = rng.normal(0, 2, values.shape).astype(np.float32) if with_means else None
    jg = JGaussianConditional().update_scale_table()
    pg = GaussianConditional().update_scale_table()
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    _close(pg.likelihood(t(values), t(scales), t(means)),
           jg.likelihood(jnp.asarray(values), jnp.asarray(scales),
                         None if means is None else jnp.asarray(means)))
    idx = pg.indexes(t(scales)).numpy()
    np.testing.assert_array_equal(idx, np.asarray(jg.indexes(jnp.asarray(scales))))
    strings = pg.compress(values, idx, means)
    assert strings == jg.compress(values, idx, means)
    got = pg.decompress(strings, idx, means)
    np.testing.assert_array_equal(got, jg.decompress(strings, idx, means))
    np.testing.assert_array_equal(got, pg.dequantize(pg.quantize(values, means), means))


@pytest.mark.parametrize("name,cls", [("factorized", PB.FactorizedPrior),
                                      ("scale_hyperprior", PB.ScaleHyperprior),
                                      ("mean_scale_hyperprior", PB.MeanScaleHyperprior)])
def test_get_model_builds_the_balle_names(name, cls):
    class Args:
        model, N, M = name, 16, 24

    assert name not in NOT_PORTED
    codec, *rest = get_model(Args, device="cpu")
    assert rest == [None] * 4
    assert type(codec.module) is cls and isinstance(codec, PB.HyperpriorCodec)
    assert codec.module.g_a[6].out_channels == 24
    assert codec.module.entropy_bottleneck.quantiles.shape[0] == (
        24 if cls is PB.FactorizedPrior else 16)


def test_factorized_prior_through_compress_with_ac():
    """One stream group: bpp_calculation counts no hyper rate, and
    compress_with_ac drives FactorizedPrior (the JAX function raises
    IndexError there)."""
    assert bpp_calculation(8, [[b"abcd"]]) == (4.0, 0.0, 4.0)
    assert bpp_calculation(8, [[b"abcd"], [b"ab"]]) == (6.0, 2.0, 4.0)
    codec = PB.make_balle("factorized", N=16, M=24, device="cpu", seed=1)
    codec.update()
    records = []
    bpp, psnr = compress_with_ac(codec, [_image()[0]], verbose=False, records=records)
    assert records[0]["bpp_z"] == 0.0 and records[0]["bpp"] == records[0]["bpp_y"] == bpp
    assert records[0]["y_hat_exact"] and np.isfinite(psnr)


def _png_dir(path, sizes):
    from PIL import Image

    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    for i, hw in enumerate(sizes):
        img = (rng.uniform(size=(*hw, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(path / f"{i}.png")


def test_eval_and_train_clis_take_the_balle_names(tmp_path, capsys):
    """``--model mean_scale_hyperprior`` / ``factorized`` through the generic
    branches of both CLIs on the CPU: the real codec and the estimate, one
    train epoch with validation."""
    _png_dir(tmp_path / "eval", [(64, 64), (64, 128)])
    common = ["--data", str(tmp_path / "eval"), "--platform", "cpu", "--N", "16", "--M", "24"]
    assert peval.main(common + ["--model", "mean_scale_hyperprior", "--real"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("[level 0] average_Bit-rate:")
    assert peval.main(common + ["--model", "factorized"]) == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith("[level 0] average_PSNR:")
    for split in ("train", "test"):
        _png_dir(tmp_path / "data" / split / "data", [(96, 96)] * 2)
    assert ptrain.main(["--platform", "cpu", "-m", "factorized", "--N", "16", "--M", "24",
                        "-d", str(tmp_path / "data"), "--patch-size", "64", "64",
                        "--batch-size", "2", "--test-batch-size", "1", "-n", "1",
                        "--lambda_list", "0.013", "-e", "1", "--save_path",
                        str(tmp_path / "runs"), "--kodak", str(tmp_path / "none")]) == 0
    out = capsys.readouterr().out
    assert "Train epoch 0" in out and "valid epoch 0" in out


# ------------------------------ training ------------------------------


def _to_port_noise(draws) -> list:
    """JAX's draws as the port's forward asks for them: z as drawn, y from
    NHWC to NCHW."""
    z, y = draws
    return [torch.from_numpy(np.array(z)),
            torch.from_numpy(np.ascontiguousarray(y.transpose(0, 3, 1, 2)))]


@pytest.fixture(scope="module")
def run():
    """Three steps of the JAX mean-scale step and of the port's from the
    same weights, batch and noise: per step the metrics and JAX's noise,
    and both sides' clipped gradients of step 1."""
    jc, pc, flat = _pair("mean-scale")
    params = _tree(flat)
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    noise = []
    main_tx, aux_tx = configure_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    optimisations_off = jax.config.read("jax_disable_most_optimizations")
    jax_steps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording_uniform(noise))
        step = jax.jit(make_train_step(jc.module, main_tx, aux_tx))
        for k in range(STEPS):
            noise.clear()
            jax.config.update("jax_disable_most_optimizations", True)  # compiled at k = 0
            try:
                state, m = step(state, jnp.asarray(x), jnp.float32(LMBDA), jax.random.PRNGKey(k))
            finally:
                jax.config.update("jax_disable_most_optimizations", optimisations_off)
            jax.effects_barrier()
            jax_steps.append({"metrics": {k2: float(v) for k2, v in m.items()},
                              "noise": list(noise)})
            if k == 0:
                mu = _flat(_adam_mu(state.opt_state))
    jax_grads = from_jax_params({k: v / (1 - B1) for k, v in mu.items()})

    module = pc.module.train()
    ps = create_train_state(module, 1e-4, 1e-3, 1.0)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    port_steps = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside other workers' XLA compiles, more threads thrash
    try:
        for k in range(STEPS):
            m = train_step(ps, xt, LMBDA, replayed_noise(_to_port_noise(jax_steps[k]["noise"])))
            port_steps.append({k2: float(v) for k2, v in m.items()})
            if k == 0:
                named = dict(module.named_parameters())
                port_grads = {n: named[n].grad.clone() for n in jax_grads}
    finally:
        torch.set_num_threads(threads)
    return {"jax": jax_steps, "port": port_steps, "jax_grads": jax_grads,
            "port_grads": port_grads}


def test_train_noise_is_drawn_in_jax_order(run):
    """z first as [C, 1, B*H*W], then y as NHWC [B, h, w, M]."""
    z, y = run["jax"][0]["noise"]
    assert z.shape == (16, 1, 2 * 1 * 1) and y.shape == (2, 4, 4, 24)


def test_train_step_matches_jax(run):
    """Step 1's loss, bpp and MSE, and its clipped gradients."""
    want, got = run["jax"][0]["metrics"], run["port"][0]
    for key in ("loss", "bpp_loss", "mse_loss"):
        assert _rel(got[key], want[key]) <= TOL_LOSS, (key, got[key], want[key])
    assert set(run["port_grads"]) == set(run["jax_grads"])
    worst = 0.0
    for name, g in run["jax_grads"].items():
        err = float((run["port_grads"][name] - g).abs().max())
        scale = float(g.abs().max())
        assert err <= TOL_GRAD * scale or scale == err == 0.0, (name, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    print(f"mean-scale: step-1 loss {_rel(got['loss'], want['loss']):.2e} relative, worst "
          f"gradient error {worst:.2e} of its tensor's max")


@pytest.mark.parametrize("step", range(STEPS))
def test_three_step_trajectory_matches_jax(run, step):
    want, got = run["jax"][step]["metrics"], run["port"][step]
    for key in ("loss", "bpp_loss", "aux_loss"):
        assert _rel(got[key], want[key]) <= TOL_TRAJ, (step, key, got[key], want[key])
