"""The port's bf16 train step (``train_step(..., matmul_precision=
"bfloat16")``, the trainer's ``--bf16``) on the CPU: the Balle scale
hyperprior's two steps against the JAX package's jitted
``make_train_step(..., matmul_precision="bfloat16")`` from the same
weights, batch and noise; TCM's bf16 training forward's loss against the
JAX module's bf16 training forward at the same noise; and the bf16 step's
gradients against the port's own fp32 step's, its parameters and Adam
states staying fp32.

What JAX's bf16 mode does on the CPU: XLA ignores the precision, so JAX's
Balle step is its fp32 step, and its TCM forward differs from fp32 only by
the explicit casts (the composed WMSA and the Swin MLP in bf16). The port
rounds every conv and linear operand to bf16, as the TPU does. Models: the
scale hyperprior of tests/test_torch_port_bf16_codecs.py (N=16, M=24,
perturbed as tests/test_torch_port_balle.py's) at 2x64x64 and the TCM of
tests/test_torch_port_train_parity.py (config (1,1,1,1,1,1), N=32, M=80)
at 2x128x128, lambda 0.013, the JAX defaults lr 1e-4, aux lr 1e-3, clip 1.0.

Tolerances, with what the run shows: each Balle step's loss, bpp, MSE and
aux loss within 1e-2 relative of JAX's (at most 3.9e-4); step 1's
gradients within 2e-2 of JAX's, relative over all the gradients together
(L2: 2.5e-3); TCM's bf16 forward loss, bpp and MSE within 1e-2 relative
(at most 1.4e-3). The bf16 step's gradients against the fp32 step's
within 2e-2, the same measure (3.3e-3), and above 1e-4, so a step that
rounds nothing fails. JAX compiles with ``jax_disable_most_optimizations``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.training.loss import rate_distortion_loss as jax_loss
from reslic_tcm_tpu.training.optimizer import configure_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu_torch.models.base import replayed_noise
from reslic_tcm_tpu_torch.ops.launches import launch_counts
from reslic_tcm_tpu_torch.ops.layers import matmul_precision
from reslic_tcm_tpu_torch.training.loss import rate_distortion_loss
from reslic_tcm_tpu_torch.training.step import create_train_state, step_noise, train_step
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from tests.test_torch_port_balle import _to_port_noise as balle_noise
from tests.test_torch_port_bf16_codecs import balle_pair
from tests.test_torch_port_train_parity import (B1, LMBDA, _adam_mu, _flat, _recording_uniform,
                                                _rel, _tcm_pair, _to_port_noise, _tree)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

STEPS = 2
TOL_LOSS = 1e-2
TOL_GRAD = 2e-2
TOL_SELF = 2e-2
FLOOR_SELF = 1e-4
BF16 = "bfloat16"


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


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def balle_run():
    """Two bf16 steps of the JAX scale-hyperprior step and of the port's from
    the same weights, batch and noise: per step the metrics, and both sides'
    clipped gradients of step 1."""
    jc, pc = balle_pair("scale")
    params = jc.variables["params"]
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    main_tx, aux_tx = configure_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    noise, jax_steps = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording_uniform(noise))
        step = jax.jit(make_train_step(jc.module, main_tx, aux_tx, matmul_precision=BF16))
        for k in range(STEPS):
            noise.clear()
            state, m = step(state, jnp.asarray(x), jnp.float32(LMBDA), jax.random.PRNGKey(k))
            jax.effects_barrier()
            jax_steps.append({"metrics": {k2: float(v) for k2, v in m.items()},
                              "noise": list(noise)})
            if k == 0:
                mu = _flat(_adam_mu(state.opt_state))
    jax_grads = from_jax_params({k: v / (1 - B1) for k, v in mu.items()})

    module = pc.module.train()
    ps = create_train_state(module, 1e-4, 1e-3, 1.0)
    port_steps = []
    for k in range(STEPS):
        m = train_step(ps, _nchw(x), LMBDA, replayed_noise(balle_noise(jax_steps[k]["noise"])),
                       matmul_precision=BF16)
        port_steps.append({k2: float(v) for k2, v in m.items()})
        if k == 0:
            named = dict(module.named_parameters())
            port_grads = {n: named[n].grad.clone() for n in jax_grads}
    return {"jax": jax_steps, "port": port_steps, "jax_grads": jax_grads,
            "port_grads": port_grads}


@pytest.mark.parametrize("step", range(STEPS))
def test_balle_bf16_steps_match_jax_bf16_steps(balle_run, step):
    want, got = balle_run["jax"][step]["metrics"], balle_run["port"][step]
    for key in ("loss", "bpp_loss", "mse_loss", "aux_loss"):
        print(f"Balle bf16 step {step} {key}: {_rel(got[key], want[key]):.2e} relative")
        assert _rel(got[key], want[key]) <= TOL_LOSS, (step, key, got[key], want[key])


def _global_rel(got: dict, want: dict) -> float:
    """|got - want| / |want| over all the gradients together (L2): a bf16
    tolerance that tensors of tiny gradients do not dominate."""
    assert set(got) == set(want)
    num = sum(float(((got[n] - g) ** 2).sum()) for n, g in want.items())
    return (num / sum(float((g ** 2).sum()) for g in want.values())) ** 0.5


def test_balle_bf16_gradients_match_jax_bf16_gradients(balle_run):
    err = _global_rel(balle_run["port_grads"], balle_run["jax_grads"])
    print(f"Balle bf16 step-1 gradients against JAX's: {err:.2e} relative")
    assert err <= TOL_GRAD, err


def test_tcm_bf16_training_forward_loss_matches_jax(monkeypatch):
    """The training forward (noise, composed layers, STE rounding) under the
    bf16 precision on both sides, at JAX's recorded noise."""
    jmodule, params, pmodule = _tcm_pair()
    x = np.random.default_rng(2).uniform(size=(2, 128, 128, 3)).astype(np.float32)
    noise = []
    monkeypatch.setattr(jax.random, "uniform", _recording_uniform(noise))
    fwd = jax.jit(lambda p, xx, r: jax_loss(
        jmodule.apply({"params": p}, xx, training=True, rngs={"noise": r}), xx, LMBDA))
    with jax.default_matmul_precision(BF16):
        want = {k: float(v) for k, v in fwd(params, jnp.asarray(x), jax.random.PRNGKey(3)).items()}
    jax.effects_barrier()
    xt = _nchw(x)
    with matmul_precision(BF16):
        out = pmodule.train()(xt, training=True, noise=replayed_noise(_to_port_noise(noise)))
        got = {k: float(v.detach()) for k, v in rate_distortion_loss(out, xt, LMBDA).items()}
    for key in ("loss", "bpp_loss", "mse_loss"):
        print(f"TCM bf16 forward {key}: {_rel(got[key], want[key]):.2e} relative")
        assert _rel(got[key], want[key]) <= TOL_LOSS, (key, got[key], want[key])


def test_bf16_step_gradients_near_the_fp32_steps_and_state_stays_fp32():
    """From the same start and noise, the bf16 step's clipped gradients
    against the fp32 step's; every parameter, gradient and Adam state fp32;
    no kernel launched (composed under autograd)."""
    _, _, pmodule = _tcm_pair()
    start = {k: v.clone() for k, v in pmodule.state_dict().items()}
    x = _nchw(np.random.default_rng(4).uniform(size=(2, 128, 128, 3)).astype(np.float32))
    grads, states = {}, {}
    before = launch_counts(), launch_counts(torch.bfloat16)
    for precision in (None, BF16):
        pmodule.load_state_dict(start)
        state = create_train_state(pmodule.train())
        m = train_step(state, x, LMBDA, step_noise(0, 0, "cpu"), matmul_precision=precision)
        assert all(np.isfinite(float(v)) for v in m.values())
        grads[precision] = {n: p.grad.clone() for n, p in pmodule.named_parameters()
                            if p.grad is not None}
        states[precision] = state
    assert (launch_counts(), launch_counts(torch.bfloat16)) == before
    err = _global_rel(grads[BF16], grads[None])
    print(f"TCM bf16 step-1 gradients against the fp32 step's: {err:.2e} relative")
    assert FLOOR_SELF < err <= TOL_SELF, err
    state = states[BF16]
    assert all(p.dtype == torch.float32 for p in pmodule.parameters())
    assert all(g.dtype == torch.float32 for g in grads[BF16].values())
    for opt in (state.optimizer, state.aux_optimizer):
        for s in opt.state.values():
            assert all(v.dtype == torch.float32 for k, v in s.items() if k != "step")


def test_remat_recomputes_at_the_forwards_precision_in_another_thread():
    """TCM's remat recomputes each ConvTransBlock in the backward, which on
    the card runs in autograd's own thread, outside the caller's
    matmul_precision context: the recompute must re-enter the forward's
    precision (else its saved tensors' types differ and autograd raises).
    Here a ConvTransBlock's backward runs in a fresh thread, as there, and
    gives the gradients of a backward in the calling thread."""
    import threading

    from reslic_tcm_tpu_torch.models.tcm import ConvTransBlock

    torch.manual_seed(0)
    block = ConvTransBlock(16, 16, 8, 8, "SW", remat=True)
    x = torch.randn(1, 32, 16, 16)
    grads = []
    for threaded in (False, True):
        block.zero_grad(set_to_none=True)
        with matmul_precision(BF16):
            loss = (block(x) ** 2).mean()
        if threaded:
            errors = []

            def backward():
                try:
                    loss.backward()
                except RuntimeError as e:
                    errors.append(e)
            t = threading.Thread(target=backward)
            t.start()
            t.join()
            assert not errors, errors
        else:
            loss.backward()
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n
