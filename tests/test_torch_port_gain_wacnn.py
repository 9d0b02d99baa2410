"""Port parity for GainedWACNN (reslic_tcm_tpu_torch/models/gain/gained.py,
the registry's ``wacnn_gain``) against the JAX package's on the CPU: the
forward and the channel-AR codec's streams at each of two levels (its
train step: tests/test_torch_port_train_parity_gain.py). A file of its own
so that ``--dist loadfile`` compiles its JAX programs beside
tests/test_torch_port_gain.py's.

Model: the tiny WACNN of tests/test_torch_port_wacnn.py (N=32, M=40, the
JAX gain test's ladders) with the port's seeded weights (GDN perturbed,
g_a's last convolution scaled by 40 and each sigma transform's last by 60,
so that y takes many symbols over many scale indexes), y gains 0.7 / 1.5
(as tests/test_gain_models.py sets them) and z gains 1 / -1.25, carried to
JAX by inverting the port's bridge. Image: 128x128 from a seed.

Tolerances: forward likelihoods and x_hat within 1e-5 relative; streams
byte-identical; the port's decode reproduces its encoder's y_hat exactly,
and its x_hat equals JAX's decoded one and its own forward's clipped one
within 1e-5. XLA's optimisations are off for the file's JAX compiles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.base import ChannelARCodec as JChannelARCodec
from reslic_tcm_tpu.models.gain import gained as JG
from reslic_tcm_tpu_torch.models.gain import gained as PG
from tests.test_torch_port_gain import _one_thread_and_fast_compiles  # noqa: F401
from tests.test_torch_port_gain import _close, _image, _jax_params, _perturbed, _update
from tests.test_torch_port_train_parity import WACNN_TINY
from torch_port_threads import one_torch_thread  # noqa: E402,F401

KEY = jax.random.PRNGKey(0)
LAMBDAS = (0.0025, 0.05)


def _pair():
    """(JAX codec, port codec) of the tiny GainedWACNN, same weights, both
    updated."""
    pc = PG.make_gained_wacnn(N=32, M=40, lmbda_list=LAMBDAS, device="cpu", seed=2, **WACNN_TINY)
    m = pc.module
    _perturbed(m, [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms],
               (0.7, 1.5), (1.0, -1.25))
    jm = JG.GainedWACNN(N=32, M=40, levels=2, **WACNN_TINY)
    jc = JChannelARCodec(jm, {"params": _jax_params(jm, m, jnp.zeros((1, 128, 128, 3)))})
    _update(jc)
    pc.update()
    return jc, pc


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_forward_matches_jax_at_each_level(pair):
    jc, pc = pair
    x = _image(128, 128, seed=3)
    rates = []
    for lv in range(2):
        want = jc.forward(jnp.asarray(x), lv=lv)
        got = pc.forward(x, lv)
        _close(got["x_hat"], want["x_hat"])
        for k in ("y", "z"):
            _close(got["likelihoods"][k], want["likelihoods"][k])
        rates.append(float(-torch.log2(got["likelihoods"]["y"]).sum()))
    assert rates[0] < rates[1]


@pytest.mark.parametrize("lv", range(2))
def test_streams_match_jax_and_decode_exactly(pair, lv):
    jc, pc = pair
    x = _image(128, 128, seed=3)
    jenc = jc.compress(jnp.asarray(x), lv=lv)
    penc = pc.compress(x, lv)
    assert penc["strings"] == jenc["strings"]
    assert float(penc["y_hat"].abs().max()) >= 4
    dec = pc.decompress(penc["strings"], penc["shape"], lv)
    assert torch.equal(dec["y_hat"], penc["y_hat"])
    _close(dec["x_hat"], jc.decompress(jenc["strings"], jenc["shape"], lv=lv)["x_hat"])
    np.testing.assert_allclose(dec["x_hat"].numpy(),
                               np.clip(pc.forward(x, lv)["x_hat"].numpy(), 0, 1), atol=1e-5)
