"""Port parity for training on WACNN: the tests of
tests/test_torch_port_train_parity.py (noise order, the first step's
loss, STE-round flips, gradients, the three-step trajectory, with the
tolerances stated there) on the tiny WACNN (N=32, M=40) against the JAX
package's jitted train step. A file of its own so that ``--dist loadfile``
compiles the TCM and the WACNN JAX steps on two workers at once.
"""

from __future__ import annotations

import pytest

from tests.test_torch_port_train_parity import (  # noqa: F401  (collected here too)
    test_gradients_match_jax, test_noise_is_drawn_in_jax_order,
    test_ste_round_flips_are_rare, test_three_step_trajectory_matches_jax,
    test_training_forward_loss_matches_jax, train_both)
from torch_port_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def run():
    return train_both("wacnn")
