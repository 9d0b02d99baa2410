"""Port units of training (reslic_tcm_tpu_torch) against the JAX package on
the CPU: the entropy bottleneck's training mode and aux loss, the
rate-distortion loss, the main and aux optimisers with optax's clip,
ReduceLROnPlateau, DropPath, the routing of the layers under autograd,
the prepared-weight cache after an optimiser step, resuming from a
checkpoint and the train CLI. Inputs are numpy arrays from a seed.

Tolerances: the entropy bottleneck's training likelihoods under the same
noise within 1e-5 relative, its aux loss and the aux loss's gradient within
1e-5 relative; the rate-distortion loss in both modes within 1e-5
relative; parameters after five optimiser steps within 1e-6 relative
(float32 Adam in two libraries); the scheduler's learning rates and a
resumed run equal exactly.
"""

from __future__ import annotations

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.entropy.factorized import EntropyBottleneck as JEntropyBottleneck
from reslic_tcm_tpu.ops.layers import DropPath as JDropPath
from reslic_tcm_tpu.training.loss import rate_distortion_loss as jax_rd_loss
from reslic_tcm_tpu.training.optimizer import configure_optimizers as jax_optimizers
from reslic_tcm_tpu.training.optimizer import set_learning_rate as jax_set_lr
from reslic_tcm_tpu.utils.checkpoint import ReduceLROnPlateau as JReduceLROnPlateau
from reslic_tcm_tpu_torch.cli import train as ptrain
from reslic_tcm_tpu_torch.entropy.factorized import EntropyBottleneck
from reslic_tcm_tpu_torch.models import get_model
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.ops import layers as PL
from reslic_tcm_tpu_torch.ops import window_attention as PW
from reslic_tcm_tpu_torch.ops.layers import DropPath
from reslic_tcm_tpu_torch.training.loss import rate_distortion_loss
from reslic_tcm_tpu_torch.training.optimizer import (clip_by_global_norm, configure_optimizers,
                                                     current_learning_rate, set_learning_rate)
from reslic_tcm_tpu_torch.training.step import (create_train_state, eval_step, step_noise,
                                                train_step)
from reslic_tcm_tpu_torch.utils.checkpoint import (ReduceLROnPlateau, load_checkpoint, restore,
                                                   save_checkpoint)
from reslic_tcm_tpu_torch.utils.parser import parse_args
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
TOL_OPT = 1e-6
TCM_SMALL = dict(N=32, M=80, hyper_ch=24, atten_inter_dim=32, config=(1, 1, 1, 1, 1, 1))
WACNN_TINY = dict(hyper_dims=(40, 36, 32), mean_dims=(32, 36, 40, 44), cc_dims=(28, 24, 20, 16))


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1e-30, float(np.abs(want).max())), err


# --------------------------- entropy bottleneck ---------------------------


@pytest.fixture(scope="module")
def eb_pair():
    """A JAX EntropyBottleneck (C=6) with a perturbed chain and quantiles,
    and the port's with the same parameters."""
    c = 6
    jm = JEntropyBottleneck(channels=c)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4, 4, c)), training=False)
    rng = np.random.default_rng(0)
    params = {k: np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape).astype(np.float32)
              for k, a in v["params"].items()}
    pm = EntropyBottleneck(c)
    pm.load_state_dict({(k if k == "quantiles" else "_" + k): torch.from_numpy(a)
                        for k, a in params.items()}, strict=True)
    return jm, {"params": {k: jnp.asarray(a) for k, a in params.items()}}, pm


def test_entropy_bottleneck_training_likelihoods_match_jax(eb_pair):
    """The same U(-0.5, 0.5) noise, drawn by JAX in its [C, 1, B*H*W]
    layout and handed to the port as it is."""
    jm, v, pm = eb_pair
    x = np.random.default_rng(1).normal(0, 3, (2, 5, 7, 6)).astype(np.float32)  # NHWC
    key = jax.random.PRNGKey(3)
    want_hat, want_lik = jm.apply(v, jnp.asarray(x), training=True, noise_rng=key)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    noise = jax.random.uniform(key, pm.noise_shape(xt), jnp.float32, -0.5, 0.5)
    got_hat, got_lik = pm(xt, training=True, noise=torch.from_numpy(np.array(noise)))
    _rel_close(got_hat.permute(0, 2, 3, 1).detach(), want_hat, TOL)
    _rel_close(got_lik.permute(0, 2, 3, 1).detach(), want_lik, TOL)
    with pytest.raises(ValueError):
        pm(xt, training=True)


def test_entropy_bottleneck_aux_loss_matches_jax_and_trains_only_quantiles(eb_pair):
    jm, v, pm = eb_pair
    want = float(jm.apply(v, method=lambda m: m.aux_loss()))
    want_grad = jax.grad(lambda p: jm.apply({"params": p}, method=lambda m: m.aux_loss()))(
        v["params"])
    pm.zero_grad(set_to_none=True)
    got = pm.aux_loss()
    got.backward()
    assert abs(float(got.detach()) - want) <= TOL * abs(want)
    for name, p in pm.named_parameters():
        if name == "quantiles":
            _rel_close(p.grad, want_grad["quantiles"], TOL)
        else:
            assert p.grad is None, name
            assert float(jnp.abs(want_grad[name.lstrip("_")]).max()) == 0.0


# -------------------------- rate-distortion loss --------------------------


@pytest.mark.parametrize("loss_type", ["mse", "ms-ssim"])
def test_rate_distortion_loss_matches_jax(loss_type):
    """The same output dict (NHWC for JAX, NCHW for the port); MS-SSIM
    needs sides above 160."""
    rng = np.random.default_rng(2)
    target = rng.uniform(size=(2, 176, 192, 3)).astype(np.float32)
    x_hat = np.clip(target + rng.normal(0, 0.05, target.shape), 0, 1).astype(np.float32)
    lik_y = rng.uniform(1e-3, 1, (2, 11, 12, 8)).astype(np.float32)
    lik_z = rng.uniform(1e-3, 1, (2, 3, 3, 4)).astype(np.float32)
    want = jax_rd_loss({"x_hat": jnp.asarray(x_hat),
                        "likelihoods": {"y": jnp.asarray(lik_y), "z": jnp.asarray(lik_z)}},
                       jnp.asarray(target), 0.013, loss_type)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))  # noqa: E731
    got = rate_distortion_loss({"x_hat": nchw(x_hat),
                                "likelihoods": {"y": nchw(lik_y), "z": nchw(lik_z)}},
                               nchw(target), 0.013, loss_type)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TOL * abs(float(want[k])), k


def test_ms_ssim_loss_is_differentiable():
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.uniform(size=(1, 3, 176, 176)).astype(np.float32))
    x_hat = (target + 0.05 * torch.from_numpy(rng.normal(size=(1, 3, 176, 176)).astype(
        np.float32))).requires_grad_()
    out = rate_distortion_loss({"x_hat": x_hat, "likelihoods": {}}, target, 1.0, "ms-ssim")
    out["loss"].backward()
    assert x_hat.grad is not None and bool(torch.isfinite(x_hat.grad).all())
    assert float(x_hat.grad.abs().max()) > 0


# ------------------------------ optimisers ------------------------------


class _TwoParams(torch.nn.Module):
    def __init__(self, w, b, q):
        super().__init__()
        self.layer = torch.nn.Linear(w.shape[1], w.shape[0])
        self.entropy_bottleneck = torch.nn.Module()
        self.entropy_bottleneck.quantiles = torch.nn.Parameter(torch.from_numpy(q.copy()))
        with torch.no_grad():
            self.layer.weight.copy_(torch.from_numpy(w))
            self.layer.bias.copy_(torch.from_numpy(b))


def test_optimizers_match_optax():
    """Five steps of seeded synthetic gradients through the main chain
    (optax's clip, then Adam) and the aux Adam, against
    ``configure_optimizers``' optax transforms: clipping active for three
    steps, inactive for two, the main learning rate halved after step 2."""
    import optax

    rng = np.random.default_rng(4)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    q = rng.normal(size=(3, 1, 3)).astype(np.float32)
    jparams = {"layer": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
               "entropy_bottleneck": {"quantiles": jnp.asarray(q)}}
    main_tx, aux_tx = jax_optimizers(jparams, 1e-2, 1e-3, 1.0)
    main_state, aux_state = main_tx.init(jparams), aux_tx.init(jparams)

    module = _TwoParams(w, b, q)
    opt, aux_opt = configure_optimizers(module, 1e-2, 1e-3)
    norms = []
    for k in range(5):
        scale = 10.0 if k < 3 else 1e-2
        gw, gb, gq = (scale * rng.normal(size=a.shape).astype(np.float32) for a in (w, b, q))
        if k == 3:
            main_state = jax_set_lr(main_state, 5e-3)
            set_learning_rate(opt, 5e-3)
        grads = {"layer": {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)},
                 "entropy_bottleneck": {"quantiles": jnp.asarray(gq)}}
        updates, main_state = main_tx.update(grads, main_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updates, aux_state = aux_tx.update(grads, aux_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        module.layer.weight.grad = torch.from_numpy(gw.copy())
        module.layer.bias.grad = torch.from_numpy(gb.copy())
        norms.append(float(clip_by_global_norm(opt.param_groups[0]["params"], 1.0)))
        opt.step()
        module.entropy_bottleneck.quantiles.grad = torch.from_numpy(gq.copy())
        aux_opt.step()
        _rel_close(module.layer.weight.detach(), jparams["layer"]["kernel"], TOL_OPT)
        _rel_close(module.layer.bias.detach(), jparams["layer"]["bias"], TOL_OPT)
        _rel_close(module.entropy_bottleneck.quantiles.detach(),
                   jparams["entropy_bottleneck"]["quantiles"], TOL_OPT)
    assert min(norms[:3]) > 1.0 > max(norms[3:])  # clipped, then not
    assert current_learning_rate(opt) == 5e-3 and current_learning_rate(aux_opt) == 1e-3


def test_clip_is_optax_rule_not_clip_grad_norm():
    """Above the limit g / norm * max (no +1e-6), below it g unchanged, and
    a parameter without a gradient counts as zeros."""
    p, r = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    norm = clip_by_global_norm([p, r], 1.0)
    assert float(norm) == 5.0
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0, 0.0]) / 5.0 * 1.0)
    assert torch.equal(r.grad, torch.zeros(2))
    p.grad = torch.tensor([0.3, 0.4, 0.0])
    clip_by_global_norm([p], 1.0)
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4, 0.0]))


def test_quantiles_go_to_the_aux_optimizer_only():
    module = make_tcm(device="cpu", **TCM_SMALL).module
    opt, aux_opt = configure_optimizers(module)
    aux = aux_opt.param_groups[0]["params"]
    assert len(aux) == 1 and aux[0] is module.entropy_bottleneck.quantiles
    main = opt.param_groups[0]["params"]
    assert len(main) == len(list(module.parameters())) - 1
    assert all(p is not aux[0] for p in main)


# ------------------------------- scheduler -------------------------------


def test_reduce_lr_on_plateau_follows_jax():
    metrics = [5.0, 4.0, 4.0, 4.1, 3.9999, 4.2, 4.0, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 2.0, 2.0,
               2.0, 2.0, 2.0, 2.0, 2.0]
    j, p = JReduceLROnPlateau(1e-4, "min", factor=0.5, patience=2), \
        ReduceLROnPlateau(1e-4, "min", factor=0.5, patience=2)
    got, want = [p.step(m) for m in metrics], [j.step(m) for m in metrics]
    assert got == want
    assert len(set(got)) >= 3  # the rate fell at least twice
    q = ReduceLROnPlateau(1.0)
    q.load_state_dict(p.state_dict())
    assert q.step(1.0) == j.step(1.0)


# -------------------------------- DropPath --------------------------------


def test_drop_path_is_the_identity_as_jax_calls_it():
    """JAX's DropPath at its default (deterministic) call, the only one the
    JAX transforms make, is the identity at any rate; so is the port's,
    with and without autograd."""
    x = np.random.default_rng(7).normal(size=(4, 3, 4, 5)).astype(np.float32)
    for rate in (0.0, 0.25):
        want = np.asarray(JDropPath(rate).apply({}, jnp.asarray(x)))
        got = DropPath(rate)(torch.from_numpy(x).requires_grad_())
        np.testing.assert_array_equal(got.detach().numpy(), want)
        with torch.no_grad():
            np.testing.assert_array_equal(DropPath(rate)(torch.from_numpy(x)).numpy(), want)


def test_tcm_drop_path_schedule_is_jax():
    """np.linspace(0, rate, sum(config)), the i-th block of each stage
    taking entry i, the hyper transforms none (JAX tcm.py:143-155)."""
    m = make_tcm(device="cpu", drop_path_rate=0.3, **dict(TCM_SMALL, config=(2, 2, 2, 2, 2, 2)))
    rates = np.linspace(0, 0.3, 12)
    ctbs = [b for b in m.module.g_a if hasattr(b, "trans_block")]
    assert [b.trans_block.drop_path.rate for b in ctbs] == [float(rates[i]) for i in (0, 1) * 3]
    hyper = [b for b in m.module.h_a if hasattr(b, "trans_block")]
    assert all(b.trans_block.drop_path.rate == 0.0 for b in hyper)


# -------------------------------- routing --------------------------------

_WRAPPERS = {PL: ("fused_residual_block", "fused_conv_gdn"),
             PW: ("flash_window_block", "fused_qkv_attention")}


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Count each kernel wrapper's calls from the layers (on the CPU the
    wrappers launch nothing, so their own counters stay at 0)."""
    calls = {}
    for mod, names in _WRAPPERS.items():
        for name in names:
            calls[name] = 0
            fn = getattr(mod, name)

            def spy(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    return calls


_TCM_CALLS = {"flash_window_block": 26, "fused_residual_block": 9, "fused_conv_gdn": 9,
              "fused_qkv_attention": 0}


@pytest.mark.parametrize("model, want", [
    ("tcm", _TCM_CALLS),
    ("tcm-drop-path", _TCM_CALLS),
    ("wacnn", {"flash_window_block": 2, "fused_residual_block": 0, "fused_conv_gdn": 0,
               "fused_qkv_attention": 2}),
])
def test_training_forward_calls_no_kernel_wrapper(wrapper_calls, model, want):
    """Under autograd every layer takes its composed branch: no wrapper is
    called; the no_grad eval forward calls each as often as the model's
    kernel layers. The route depends on the grad mode and the device only,
    so a drop-path rate changes neither count."""
    codec = (make_wacnn(N=32, M=40, device="cpu", **WACNN_TINY) if model == "wacnn"
             else make_tcm(device="cpu", remat=True, drop_path_rate=0.3 * (model != "tcm"),
                           **TCM_SMALL))
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(1, 3, 128, 128)).astype(
        np.float32))
    out = codec.module(x, training=True, noise=step_noise(0, 0, "cpu"))
    out["x_hat"].mean().backward()
    assert all(n == 0 for n in wrapper_calls.values()), wrapper_calls
    with torch.no_grad():
        codec.module(x)
    assert wrapper_calls == want


def test_composed_branches_equal_the_plain_versions():
    """Each kernel layer's composed branch (under grad) against its kernel
    wrapper's plain version (no_grad, CPU) on the same input."""
    torch.manual_seed(0)
    cases = [
        (PL.ResidualBlock(16), torch.randn(2, 16, 8, 8)),
        (PL.ResidualBlockWithStride(8, 16), torch.randn(2, 8, 8, 8)),
        (PL.ResidualBlockUpsample(16, 8), torch.randn(2, 16, 4, 4)),
        (PW.SwinTransformerBlock(16, 8, 8, "SW"), torch.randn(2, 16, 16, 16)),
        (PW.WinBasedAttention(16, 2, 8, 4), torch.randn(2, 16, 16, 16)),
        (PW.WindowAttention(16, 4, 2), torch.randn(6, 16, 16)),
    ]
    for module, x in cases:
        with torch.no_grad():
            want = module(x)
        got = module(x)
        assert got.requires_grad, type(module).__name__
        _rel_close(got.detach(), want, 1e-5)


def test_remat_gives_the_same_gradients():
    codecs = [make_tcm(device="cpu", remat=r, **TCM_SMALL) for r in (False, True)]
    x = torch.from_numpy(np.random.default_rng(6).uniform(size=(1, 3, 128, 128)).astype(
        np.float32))
    grads = []
    for c in codecs:
        c.module(x, training=True, noise=step_noise(1, 0, "cpu"))["x_hat"].sum().backward()
        grads.append([p.grad for p in c.module.parameters()])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            _rel_close(b, a, 1e-5)


def test_get_model_passes_remat():
    args = parse_args(["-m", "tcm", "--N", "32"])
    codec, *_ = get_model(args, device="cpu")
    ctb = codec.module.g_a[1]
    assert ctb.remat and ctb.trans_block.drop_path.rate == 0.0
    args = parse_args(["-m", "tcm", "--N", "32", "--no-remat"])
    assert not get_model(args, device="cpu")[0].module.g_a[1].remat


# ------------------------- weight cache and resume -------------------------


def test_eval_after_an_optimizer_step_uses_the_new_weights():
    """The prepared kernel weights (cached per module) follow the optimiser:
    a no_grad forward after a train step equals the same forward of a
    module freshly loaded with the updated state dict."""
    module = make_tcm(device="cpu", **TCM_SMALL).module
    x = torch.from_numpy(np.random.default_rng(7).uniform(size=(1, 3, 128, 128)).astype(
        np.float32))
    with torch.no_grad():
        before = module(x)["x_hat"]  # fills the cache
    state = create_train_state(module, learning_rate=1e-3)
    train_step(state, x, 0.013, step_noise(0, 0, "cpu"))
    with torch.no_grad():
        got = module(x)["x_hat"]
    fresh = make_tcm(device="cpu", seed=9, **TCM_SMALL).module
    fresh.load_state_dict(module.state_dict())
    with torch.no_grad():
        want = fresh(x)["x_hat"]
    assert torch.equal(got, want)
    assert not torch.equal(got, before)


def test_resume_matches_uninterrupted(tmp_path):
    """Three steps, a checkpoint, a fresh state restored from it and three
    more equal six uninterrupted steps exactly (the noise of step k comes
    from (seed, k))."""
    x = [torch.from_numpy(np.random.default_rng(10 + k).uniform(size=(1, 3, 128, 128)).astype(
        np.float32)) for k in range(6)]

    def run(state, start, end):
        for k in range(start, end):
            m = train_step(state, x[k], 0.013, step_noise(3, state.step, "cpu"))
        return m

    full = create_train_state(make_tcm(device="cpu", remat=True, **TCM_SMALL).module)
    m_full = run(full, 0, 6)
    half = create_train_state(make_tcm(device="cpu", remat=True, **TCM_SMALL).module)
    run(half, 0, 3)
    path = str(tmp_path / "ckpt.pt")
    scheduler = ReduceLROnPlateau(1e-4)
    scheduler.step(1.0)
    save_checkpoint(path, half, scheduler, epoch=0, val_loss=1.0)
    resumed = create_train_state(make_tcm(device="cpu", seed=5, remat=True, **TCM_SMALL).module)
    sched2 = ReduceLROnPlateau(1e-4)
    assert restore(resumed, load_checkpoint(path), sched2) == 1
    assert resumed.step == 3 and sched2.state_dict() == scheduler.state_dict()
    m_resumed = run(resumed, 3, 6)
    assert float(m_full["loss"]) == float(m_resumed["loss"])
    for a, b in zip(full.module.parameters(), resumed.module.parameters()):
        assert torch.equal(a, b)


def test_eval_step_reports_psnr():
    module = make_wacnn(N=32, M=40, device="cpu", **WACNN_TINY).module
    x = torch.from_numpy(np.random.default_rng(8).uniform(size=(1, 3, 128, 128)).astype(
        np.float32))
    out = eval_step(module, x, 0.013)
    with torch.no_grad():
        x_hat = module(x)["x_hat"].clamp(0, 1)
    want = -10 * torch.log10(torch.mean((x_hat - x) ** 2))
    assert abs(float(out["psnr"]) - float(want)) <= 1e-5 * abs(float(want))
    assert set(out) == {"loss", "bpp_loss", "mse_loss", "psnr"}


# ---------------------------------- CLI ----------------------------------


def _png_tree(root, n_train=2, n_test=1, size=(128, 144)):
    from PIL import Image

    rng = np.random.default_rng(11)
    for split, n in (("train", n_train), ("test", n_test)):
        d = root / split / "data"
        d.mkdir(parents=True)
        for i in range(n):
            img = (rng.uniform(size=(*size, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"{i}.png")


def test_train_cli_runs_an_epoch_and_the_tester(tmp_path, capsys):
    _png_tree(tmp_path / "data")
    save = tmp_path / "runs"
    common = ["--platform", "cpu", "-m", "tcm", "--N", "32", "-d", str(tmp_path / "data"),
              "--patch-size", "128", "128", "--batch-size", "2", "--test-batch-size", "1",
              "-n", "1", "--lambda_list", "0.013", "--save_path", str(save),
              "--kodak", str(tmp_path / "none"), "--seed", "1"]
    random.seed(0)
    assert ptrain.main(common + ["-e", "1"]) == 0
    out = capsys.readouterr().out
    assert "Train epoch 0" in out and "valid epoch 0" in out and "END OF EPOCH  0" in out
    ckpts = [os.path.join(dp, f) for dp, _, fs in os.walk(save) for f in fs if f.endswith(".ckpt")]
    assert len(ckpts) == 2  # the epoch's best and the very best
    payload = load_checkpoint(ckpts[0])
    assert payload["epoch"] == 0 and payload["step"] == 1 and np.isfinite(payload["loss"])
    assert ptrain.main(common + ["--tester", "--checkpoint", ckpts[0]]) == 0
    assert "valid epoch 0" in capsys.readouterr().out


@pytest.mark.parametrize("argv, refusal", [
    # --bf16 was refused until item 15's second half (A15b): it now trains
    # an epoch of a tiny TCM at two levels (the JAX trainer's bf16
    # precision), under the id it had while refused
    pytest.param(["-m", "tcm", "--N", "32", "--M", "80", "--lambda_list", "0.0025", "0.05",
                  "--bf16"], None, id="argv0-refusal0"),
    # --coordinator is ported (item 13): without the process count and this
    # process's id it is refused (tests/test_torch_port_parallel.py trains
    # through it)
    (["--coordinator", "localhost:1"], (ValueError, "process count")),
    # the last two cases keep the ids they had while STanH (item 10) and then
    # the gain codecs (item 11) were refused: wacnn_gain now trains an epoch;
    # scale_gain_sc stays refused, as no train step feeds its quality map
    pytest.param(["-m", "wacnn_gain", "--N", "32", "--M", "40", "--lambda_list", "0.0025",
                  "0.05", "--gain_init_spread", "2"], None, id="argv2-item 10"),
    pytest.param(["-m", "scale_gain_sc"], (ValueError, "quality map"), id="argv3-item 10"),
])
def test_train_cli_refuses_unported_options(argv, refusal, tmp_path, capsys):
    if refusal is not None:
        with pytest.raises(refusal[0], match=refusal[1]):
            ptrain.main(["--platform", "cpu", "-m", "tcm"] + argv)
        return
    _png_tree(tmp_path / "data", size=(128, 128))
    assert ptrain.main(["--platform", "cpu", "-d", str(tmp_path / "data"), "--patch-size", "128",
                        "128", "--batch-size", "2", "--test-batch-size", "1", "-n", "1", "-e",
                        "1", "--save_path", str(tmp_path / "runs"), "--kodak",
                        str(tmp_path / "none"), "--seed", "1"] + argv) == 0
    out = capsys.readouterr().out
    assert "Train epoch 0" in out and "valid epoch 0 (lv 1)" in out


def test_train_cli_needs_the_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.main(["-m", "tcm", "-d", str(tmp_path)])
