"""Port parity for training: the port's TCM train step
(reslic_tcm_tpu_torch/training/step.py) against the JAX package's jitted
``make_train_step`` on the CPU, from the same weights, batch and noise, for
three steps. tests/test_torch_port_train_parity_wacnn.py runs the same
tests on WACNN (a file of its own, so that ``--dist loadfile`` compiles
the two JAX steps on two workers at once).

Models: TCM at config (1,1,1,1,1,1), N=32, M=80, hyper_ch 24, SWAtten
inter_dim 32, with structure-only init and seeded perturbations (as in
tests/test_torch_port_tcm.py); the tiny WACNN of
tests/test_torch_port_wacnn.py (N=32, M=40) with the port's seeded weights,
carried to JAX by the JAX package's converter. Batch: 2x128x128 from a
seed, lambda 0.013, the JAX defaults lr 1e-4, aux lr 1e-3, clip 1.0.

The noise: JAX's step draws ``jax.random.uniform`` for z (as
[C, 1, B*H*W]) and then for each slice (NHWC). A wrapper, installed with
``pytest.MonkeyPatch`` while the step is traced, hands every draw to
``jax.debug.callback(..., ordered=True)``; the port's step replays the
recorded draws (the slices' moved to NCHW). No file of the JAX package
changes. The same kind of wrapper around the JAX base module's
``ste_round`` records the rounded values, to count the STE-round flips.

Gradients: JAX's are read from its first Adam moment after step 1 (mu =
(1 - b1) g, g being the clipped gradient) and carried to the port's
parameter names by ``from_jax_params``; its transforms (transposes, the
Deconv's transpose and spatial flip) are permutations, so the same map
carries gradients. The port's clipped gradients are the ``.grad`` its step
leaves behind.

Tolerances: the first step's loss, bpp and MSE within 1e-5 relative;
gradients per tensor max |port - jax| <= 1e-3 * max |g_jax|; loss, bpp and
aux loss of each of the three steps within 1e-4 relative; STE-round flips
at most 0.1% of the rounded elements (none were seen). Each JAX step is
compiled once per model, in a module fixture, with XLA's optimisations
off (``jax_disable_most_optimizations``: the compile is what costs; TCM
about 60 s, WACNN about 50 s on an 8-core CPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import reslic_tcm_tpu.models.base as jax_base
import reslic_tcm_tpu_torch.models.base as port_base
from reslic_tcm_tpu.models.tcm import make_tcm as jax_make_tcm
from reslic_tcm_tpu.models.wacnn import WACNN as JWACNN
from reslic_tcm_tpu.training.optimizer import configure_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu.utils.torch_convert import convert_state_dict
from reslic_tcm_tpu_torch.models.base import replayed_noise
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.training.step import create_train_state, train_step
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL_LOSS = 1e-5
TOL_GRAD = 1e-3
TOL_TRAJ = 1e-4
MAX_FLIP_SHARE = 1e-3
STEPS = 3
LMBDA = 0.013
B1 = 0.9  # Adam's first-moment decay (optax and torch default)
TCM_SMALL = dict(N=32, M=80, hyper_ch=24, atten_inter_dim=32, config=(1, 1, 1, 1, 1, 1))
WACNN_TINY = dict(hyper_dims=(40, 36, 32), mean_dims=(32, 36, 40, 44), cc_dims=(28, 24, 20, 16))


def _flat(params) -> dict:
    return {"/".join(getattr(k, "key", str(k)) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _tree(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        for p in key.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[key.split("/")[-1]] = jnp.asarray(v)
    return tree


def _tcm_pair():
    """(JAX module, JAX params, port module) with identical weights."""
    jc = jax_make_tcm(input_shape=(128, 128), fast_init=True, **TCM_SMALL)
    rng = np.random.default_rng(0)
    flat = {}
    for key, v in _flat(jc.params).items():
        if key.split("/")[-1] in ("bias", "scale"):  # constant under structure-only init
            v = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
        flat[key] = v
    pc = make_tcm(device="cpu", **TCM_SMALL)
    pc.module.load_state_dict(from_jax_params(flat), strict=True)
    return jc.module, _tree(flat), pc.module


def _wacnn_pair():
    """The tiny WACNN of tests/test_torch_port_wacnn.py: the port's seeded
    weights (GDN perturbed, y and sigma scaled into the coder's range) on a
    JAX template through the JAX package's converter."""
    module = JWACNN(N=32, M=40, **WACNN_TINY)
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(lambda: module.init(
        {"params": key, "noise": key}, jnp.zeros((1, 128, 128, 3)), training=True))["params"]
    m = make_wacnn(N=32, M=40, device="cpu", seed=2, **WACNN_TINY).module
    rng = np.random.default_rng(0)
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
    return module, params, m


def _adam_mu(opt_state):
    """The first-moment tree of the (only) ScaleByAdamState in an optax
    state; masked-out leaves (quantiles) are empty nodes."""
    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


def _record(sink, value) -> None:
    """Hand ``value`` to ``sink`` by an ordered debug callback (also under
    jit, where it runs when the compiled step does)."""
    jax.debug.callback(lambda a: sink.append(np.asarray(a)), value, ordered=True)


def _recording_uniform(sink):
    uniform = jax.random.uniform

    def wrapped(*args, **kwargs):
        out = uniform(*args, **kwargs)
        _record(sink, out)
        return out
    return wrapped


def _recording_ste_round(sink, ste_round, record):
    """``ste_round`` unchanged, with round(x) of each call recorded."""
    def wrapped(x):
        record(sink, x)
        return ste_round(x)
    return wrapped


def _to_port_noise(draws) -> list:
    """JAX's draws as the port's forward asks for them: z as drawn, each
    slice from NHWC to NCHW."""
    return [torch.from_numpy(np.array(draws[0]))] + [
        torch.from_numpy(np.ascontiguousarray(d.transpose(0, 3, 1, 2))) for d in draws[1:]]


def train_both(model: str) -> dict:
    """Three steps of the JAX step and of the port's from the same start
    (``model`` "tcm" or "wacnn"): per step the metrics, the noise and the
    STE-rounded values of each, and both sides' clipped gradients of step 1."""
    jmodule, params, pmodule = (_tcm_pair if model == "tcm" else _wacnn_pair)()
    x = np.random.default_rng(1).uniform(size=(2, 128, 128, 3)).astype(np.float32)

    noise, rounds = [], []
    main_tx, aux_tx = configure_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    optimisations_off = jax.config.read("jax_disable_most_optimizations")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording_uniform(noise))
        mp.setattr(jax_base, "ste_round", _recording_ste_round(
            rounds, jax_base.ste_round,
            lambda sink, x: _record(sink, jnp.round(jax.lax.stop_gradient(x)))))
        step = jax.jit(make_train_step(jmodule, main_tx, aux_tx))
        jax_steps = []
        for k in range(STEPS):
            noise.clear()
            rounds.clear()
            jax.config.update("jax_disable_most_optimizations", True)  # compiled at k = 0
            try:
                state, m = step(state, jnp.asarray(x), jnp.float32(LMBDA), jax.random.PRNGKey(k))
            finally:
                jax.config.update("jax_disable_most_optimizations", optimisations_off)
            jax.effects_barrier()
            jax_steps.append({"metrics": {k2: float(v) for k2, v in m.items()},
                              "noise": list(noise), "rounds": list(rounds)})
            if k == 0:
                mu = _flat(_adam_mu(state.opt_state))
    jax_grads = from_jax_params({k: v / (1 - B1) for k, v in mu.items()})

    port_rounds = []
    ps = create_train_state(pmodule, 1e-4, 1e-3, 1.0)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    port_steps = []
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_base, "ste_round", _recording_ste_round(
            port_rounds, port_base.ste_round,
            lambda sink, x: sink.append(torch.round(x.detach()))))
        torch.set_num_threads(1)  # beside other workers' XLA compiles, more threads thrash
        try:
            for k in range(STEPS):
                port_rounds.clear()
                m = train_step(ps, xt, LMBDA,
                               replayed_noise(_to_port_noise(jax_steps[k]["noise"])))
                port_steps.append({"metrics": {k2: float(v) for k2, v in m.items()},
                                   "rounds": list(port_rounds)})
                if k == 0:
                    named = dict(pmodule.named_parameters())
                    port_grads = {n: named[n].grad.clone() for n in jax_grads}
        finally:
            torch.set_num_threads(threads)
    return {"jax": jax_steps, "port": port_steps, "jax_grads": jax_grads,
            "port_grads": port_grads, "model": model}


@pytest.fixture(scope="module")
def run():
    return train_both("tcm")


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def test_noise_is_drawn_in_jax_order(run):
    """z first as [C, 1, B*H*W], then every slice as NHWC [B, h, w, C/S]."""
    draws = run["jax"][0]["noise"]
    slices = 5 if run["model"] == "tcm" else 10
    assert len(draws) == 1 + slices
    assert draws[0].shape[1] == 1 and draws[0].shape[2] == 2 * 2 * 2
    assert all(d.shape == (2, 8, 8, draws[1].shape[3]) for d in draws[1:])
    assert all(float(np.abs(d).max()) <= 0.5 for d in draws)


def test_training_forward_loss_matches_jax(run):
    want, got = run["jax"][0]["metrics"], run["port"][0]["metrics"]
    for key in ("loss", "bpp_loss", "mse_loss"):
        assert _rel(got[key], want[key]) <= TOL_LOSS, (key, got[key], want[key])


def test_ste_round_flips_are_rare(run):
    """The rounded values of every STE round (z around the medians, each
    slice around mu) in all three steps; the share that differs from JAX's
    is printed (pytest -s) and held to 0.1%."""
    flips = total = 0
    for j, p in zip(run["jax"], run["port"]):
        assert len(j["rounds"]) == len(p["rounds"])
        for a, b in zip(j["rounds"], p["rounds"]):
            b = b.numpy()
            if a.ndim == 4:  # JAX's NHWC
                a = a.transpose(0, 3, 1, 2)
            flips += int((a != b).sum())
            total += a.size
    print(f"{run['model']}: STE-round flips {flips} of {total} ({flips / total:.2e})")
    assert flips <= MAX_FLIP_SHARE * total


def test_gradients_match_jax(run):
    """Each main parameter's clipped gradient of step 1."""
    assert set(run["port_grads"]) == set(run["jax_grads"])
    worst = 0.0
    for name, want in run["jax_grads"].items():
        got = run["port_grads"][name]
        assert got.shape == want.shape, name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= TOL_GRAD * scale or scale == err == 0.0, (name, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    print(f"{run['model']}: worst gradient error {worst:.2e} of its tensor's max")


@pytest.mark.parametrize("step", range(STEPS))
def test_three_step_trajectory_matches_jax(run, step):
    want, got = run["jax"][step]["metrics"], run["port"][step]["metrics"]
    for key in ("loss", "bpp_loss", "aux_loss"):
        assert _rel(got[key], want[key]) <= TOL_TRAJ, (step, key, got[key], want[key])
