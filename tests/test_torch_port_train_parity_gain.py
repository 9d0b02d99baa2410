"""Port parity for training the gain codecs: one step of the gained scale
hyperprior (``scale_gain``) and of GainedWACNN (``wacnn_gain``) at rate
level 1, at tiny widths, against the JAX package's jitted
``make_train_step`` on the CPU from the same weights, batch and noise (the
JAX step's draws recorded by a wrapper around ``jax.random.uniform``, as
in tests/test_torch_port_train_parity.py, and replayed by the port). A
file of its own so that ``--dist loadfile`` compiles the two JAX steps
beside the gain codecs' tests.

Models: tests/test_torch_port_gain.py's gained scale hyperprior (N=16,
M=24, three levels) and tests/test_torch_port_gain_wacnn.py's GainedWACNN
(N=32, M=40, two levels). Batch: 2 images from a seed, lambda 0.013.

Tolerances: the step's loss, bpp and MSE within 1e-5 relative; the
clipped gradients (the four gain matrices among them) per tensor within
1e-3 of the tensor's max. XLA's optimisations are off for the compiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.training.optimizer import configure_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu_torch.models.base import replayed_noise
from reslic_tcm_tpu_torch.models.gain import gained as PG
from reslic_tcm_tpu_torch.training.step import create_train_state, train_step
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from tests.test_torch_port_gain import _hyper_pair, _one_thread_and_fast_compiles  # noqa: F401
from tests.test_torch_port_gain_wacnn import _pair as _wacnn_pair
from tests.test_torch_port_train_parity import (B1, LMBDA, TOL_GRAD, TOL_LOSS, _adam_mu, _flat,
                                                _recording_uniform, _rel)
from tests.test_torch_port_train_parity import _to_port_noise as _slices_to_port
from torch_port_threads import one_torch_thread  # noqa: E402,F401

KEY = jax.random.PRNGKey(0)


def _hyper_to_port(draws) -> list:
    """A hyperprior's draws as the port's forward asks for them: z as
    drawn, y from NHWC to NCHW."""
    z, y = draws
    return [torch.from_numpy(np.array(z)),
            torch.from_numpy(np.ascontiguousarray(y.transpose(0, 3, 1, 2)))]


MODELS = {"scale_gain": (lambda: _hyper_pair("scale"), 64, _hyper_to_port),
          "wacnn_gain": (_wacnn_pair, 128, _slices_to_port)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_gain_train_step_matches_jax(model):
    make, hw, to_port = MODELS[model]
    jc, pc = make()
    params = jc.variables["params"]
    x = np.random.default_rng(1).uniform(size=(2, hw, hw, 3)).astype(np.float32)
    noise = []
    main_tx, aux_tx = configure_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording_uniform(noise))
        step = jax.jit(make_train_step(jc.module, main_tx, aux_tx))
        state, m = step(state, jnp.asarray(x), jnp.float32(LMBDA), KEY, lv=1)
        jax.effects_barrier()
    want = {k: float(v) for k, v in m.items()}
    jax_grads = from_jax_params({k: v / (1 - B1) for k, v in _flat(_adam_mu(state.opt_state))
                                 .items()})

    module = pc.module.train()
    ps = create_train_state(module, 1e-4, 1e-3, 1.0)
    got = train_step(ps, torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), LMBDA,
                     replayed_noise(to_port(noise)), lv=1)
    for key in ("loss", "bpp_loss", "mse_loss"):
        assert _rel(float(got[key]), want[key]) <= TOL_LOSS, (key, float(got[key]), want[key])
    named = dict(module.named_parameters())
    assert set(PG.GAIN_NAMES) <= set(jax_grads) and set(jax_grads) <= set(named)
    for name, g in jax_grads.items():
        err = float((named[name].grad - g).abs().max())
        scale = float(g.abs().max())
        assert err <= TOL_GRAD * scale or scale == err == 0.0, (name, err, scale)
