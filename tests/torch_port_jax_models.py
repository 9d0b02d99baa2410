"""The JAX models that the parallel slice's tests hold the port against
(tests/test_torch_port_tiled.py, tests/test_torch_port_parallel.py), each
initialised once per process: the tiny TCM's structure-only init traces the
whole module, which costs seconds on the CPU. Every call returns a fresh
codec and a fresh dict of the same parameters."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from reslic_tcm_tpu.models.balle2018 import FactorizedPrior
from reslic_tcm_tpu.models.base import ChannelARCodec
from reslic_tcm_tpu.models.tcm import make_tcm
from tests.test_torch_port_balle import _perturbed
from tests.test_torch_port_train_parity import _flat, _tree
from tests.torch_port_inputs import TINY_TCM


@functools.cache
def _factorized(n: int, m: int, perturb: bool):
    module = FactorizedPrior(N=n, M=m)
    keys = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.jit(lambda p, q: module.init({"params": p, "noise": q},
                                                 jnp.zeros((1, 64, 64, 3)), training=True))(*keys)
    flat = _flat(variables["params"])
    return module, (_perturbed(flat) if perturb else flat)


def jax_factorized(n: int, m: int, perturb: bool):
    """(JAX module, flat params) of the factorized prior from one jitted
    init, perturbed as tests/test_torch_port_balle.py does with
    ``perturb``."""
    module, flat = _factorized(n, m, perturb)
    return module, dict(flat)


@functools.cache
def _tiny_tcm():
    jc = make_tcm(input_shape=(128, 128), fast_init=True, **TINY_TCM)
    rng = np.random.default_rng(0)
    flat = {}
    for key, v in _flat(jc.params).items():
        if key.rsplit("/", 1)[-1] in ("bias", "scale"):  # constant under structure-only init
            v = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
        flat[key] = v
    return jc.module, flat


def jax_tiny_tcm():
    """(JAX codec, flat params) of the tiny TCM: structure-only init with its
    constant leaves perturbed."""
    module, flat = _tiny_tcm()
    return ChannelARCodec(module, {"params": _tree(flat)}), dict(flat)
