"""Port parity for the multi-rank paths of the parallel slice
(reslic_tcm_tpu_torch/parallel/, ``ChannelARCodec.shard_for_inference``,
``training/step.py::shard_train_step``) against the JAX package on the
8-device CPU mesh that tests/conftest.py makes.

One gloo world of 4 ranks on the CPU (tests/torch_port_parallel_worker.py,
torch and the port only) runs every multi-rank check once, on the inputs
and weights this file writes for it, while this process computes JAX's
answers. Held here:

- ``sharded_conv2d`` at world 4 against JAX's on a 4-device mesh: within
  1e-5 (max |port - jax| <= 1e-5 * max(1, max |jax|));
- ``mesh_sharded_forward`` of the factorized prior (N=8, M=12, 256x64,
  halo 64) against JAX's on a 4-device "spatial" mesh: x_hat within
  1e-5, bits within 1e-5 relative;
- ``shard_for_inference`` on a batch of 8 (the tiny TCM, N=32, M=40,
  hyper_ch 24, SWAtten inter_dim 16): streams byte-identical to JAX's
  sharded codec (tests/test_tensor_parallel.py:63), the same on every
  rank, and the decode's y_hat the encoder's exactly;
- the sharded train step of the factorized prior (N=128, M=128, so that
  tensor parallelism selects its kernels) at 4x32x32 with JAX's noise
  replayed row by row, data-parallel at world 4 and data x tensor parallel
  at (2, 2): every rank reports the same loss, within 1e-5 relative of
  JAX's single-device step; every parameter within rtol 1e-4, atol 1e-5 of
  it (tests/test_tensor_parallel.py:33's tolerances);
- the data-parallel step at world 4 of the mean-scale hyperprior (N=16,
  M=24, 4x64x64), which draws y's noise as NCHW and z's as the entropy
  bottleneck's [C, 1, B*h*w], with ``step_noise`` at one seed: every rank's
  loss within 1e-5 relative, and every parameter within rtol 1e-4, atol
  1e-5, of the one-process ``train_step`` on the whole batch from the same
  weights and seed;
- ``tensor_parallel_specs`` selects the leaves JAX's selects, by name;
- ``local_batch_size`` and ``distribute_batch`` at world 1 and world 4;
- at a data group of 2 ranks (the worker's 2 x 2 mesh), the tiny TCM's
  device-coder and pipelined paths after ``shard_for_inference``:
  compress_device and compress_device_analytic on a batch of 4 give the
  streams of an unsharded codec in the same process and of JAX's device
  codec at the same weights, byte for byte, and decode exactly; 3 images
  (which the ranks do not divide) run whole; the pipelines
  (roundtrip_device_pipelined, serve_roundtrip_pipelined and
  serve_roundtrip_metrics over that batch and its reverse) give the
  profiles' streams for it and decode every batch exactly; compress_pipelined and
  roundtrip_pipelined over the serving batch's halves give JAX's streams;
- ``batch_sharding`` and ``replicated`` place a batch and a tensor as
  ``shard_batch`` and ``replicate`` do;
- the dry run (``parallel/dryrun.py``): ``dryrun_multichip(4)`` over gloo
  (a 2 x 2 mesh, its wide kernels sliced over "model") gives a finite loss
  within 1e-5 relative of the one-process ``train_step`` on the same
  weights, zeros and noise (that step is held against JAX's by
  tests/test_torch_port_train_parity.py; a four-device JAX step would cost
  minutes of compile), and ``entry()``'s forward runs;
- the train CLI through ``--coordinator`` in a world of one.

JAX programs are compiled with XLA's optimisations off.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from reslic_tcm_tpu.parallel import spatial as jsp
from reslic_tcm_tpu.parallel.mesh import tensor_parallel_specs as jax_tp_specs
from reslic_tcm_tpu.training.optimizer import configure_optimizers
from reslic_tcm_tpu.training.step import create_train_state as jax_train_state
from reslic_tcm_tpu.training.step import make_train_step
from reslic_tcm_tpu_torch.models.balle2018 import FactorizedPrior
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.parallel import mesh as pmesh
from reslic_tcm_tpu_torch.parallel import multihost
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params, torch_key
from tests.test_torch_port_train_parity import _flat, _tree
from tests.torch_port_inputs import TINY_TCM, err_ok
from tests.torch_port_jax_models import jax_factorized, jax_tiny_tcm
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
WORLD = 4
LMBDA = 0.01
STEP_DIMS = ((4, 1), (2, 2))  # data-parallel, then data x tensor parallel
DEV_K = 128  # the device coder's lanes on the tiny TCM's batch of 4
HERE = os.path.dirname(os.path.abspath(__file__))


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1), ("data", "model"))


def _uniform_from(values):
    """jax.random.uniform whose draws of the training noise, U(-0.5, 0.5) of
    the next value's shape, hand out ``values`` in order (traced once, as
    constants); other draws (flax's shape checks of initialisers) pass
    through. ``values`` is empty afterwards when every one was drawn."""
    uniform = jax.random.uniform

    def replay(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if values and (minval, maxval, tuple(shape)) == (-0.5, 0.5, values[0].shape):
            return jnp.asarray(values.pop(0), dtype)
        return uniform(key, shape, dtype, minval, maxval)
    return replay


def _jax_step(module, flat, x, noise):
    """JAX's single-device step: (loss, flat params after it)."""
    params = _tree(flat)
    main_tx, aux_tx = configure_optimizers(params)
    state = jax_train_state(params, main_tx, aux_tx)
    values = [noise]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _uniform_from(values))
        step = jax.jit(make_train_step(module, main_tx, aux_tx))
        state, metrics = step(state, jnp.asarray(x), jnp.float32(LMBDA), jax.random.PRNGKey(0))
    assert not values, "the step did not draw the replayed noise"
    return float(metrics["loss"]), _flat(state.params)


def _spawn(inputs, out):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    port = multihost.free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"), inputs, out,
         str(port), str(WORLD), str(rank)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """{"port": the gloo world's results, "jax": JAX's answers, ...}."""
    rng = np.random.default_rng(3)
    balle8, flat8 = jax_factorized(8, 12, perturb=True)
    balle128, flat128 = jax_factorized(128, 128, perturb=False)
    jc, flat_tcm = jax_tiny_tcm()
    inputs = {
        "conv_x": rng.normal(size=(2, 64, 32, 8)).astype(np.float32),
        "conv_k": (rng.normal(size=(5, 3, 8, 4)) * 0.1).astype(np.float32),
        "fwd_x": rng.uniform(size=(1, 256, 64, 3)).astype(np.float32),
        "serve_x": np.random.default_rng(7).uniform(size=(8, 128, 128, 3)).astype(np.float32),
        "dev_x": np.random.default_rng(8).uniform(size=(4, 128, 128, 3)).astype(np.float32),
        "dev_k": np.int64(DEV_K),
        "step_x": rng.uniform(size=(4, 32, 32, 3)).astype(np.float32),
        # the factorized prior's one draw: y's noise as [C, 1, B*h*w]
        "step_noise": rng.uniform(-0.5, 0.5, size=(128, 1, 4 * 2 * 2)).astype(np.float32),
        "ms_x": rng.uniform(size=(4, 64, 64, 3)).astype(np.float32),
        "ms_seed": np.int64(5),
        "lmbda": np.float32(LMBDA),
        "step_dims": np.array(STEP_DIMS),
    }
    for prefix, flat in (("balle8", flat8), ("balle128", flat128), ("tcm", flat_tcm)):
        inputs.update({f"{prefix}/{k}": v.numpy() for k, v in from_jax_params(flat).items()})
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "inputs.npz", **inputs)
    procs = _spawn(str(tmp / "inputs.npz"), str(tmp / "out.npz"))
    try:
        want = {}
        off = jax.config.read("jax_disable_most_optimizations")
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            mesh4 = _mesh(WORLD)
            want["conv"] = jax.jit(lambda x, k: jsp.sharded_conv2d(x, k, mesh4, "data"))(
                inputs["conv_x"], inputs["conv_k"])
            spatial = Mesh(np.asarray(jax.devices()[:WORLD]), ("spatial",))
            want["fwd_x_hat"], want["fwd_bits"] = jax.jit(
                lambda v, x: jsp.mesh_sharded_forward(balle8, v, x, spatial, "spatial", 64))(
                {"params": _tree(flat8)}, inputs["fwd_x"])
            jc.update()
            jc.shard_for_inference(mesh4)
            want["serve"] = jc.compress_batch(jnp.asarray(inputs["serve_x"]))
            jd = jax_tiny_tcm()[0]
            jd.update()
            want["table"] = jd.compress_device(jnp.asarray(inputs["dev_x"]), k=DEV_K)
            want["analytic"] = jd.compress_device_analytic(jnp.asarray(inputs["dev_x"]), k=DEV_K)
            want["step"] = _jax_step(balle128, flat128, inputs["step_x"], inputs["step_noise"])
        finally:
            jax.config.update("jax_disable_most_optimizations", off)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    port = dict(np.load(tmp / "out.npz", allow_pickle=True))
    return {"port": port, "jax": want, "flat128": flat128, "flat_tcm": flat_tcm}


def test_sharded_conv2d_matches_jax(run):
    err_ok(run["port"]["conv"], run["jax"]["conv"], TOL)


def test_mesh_sharded_forward_matches_jax(run):
    err_ok(run["port"]["fwd_x_hat"], run["jax"]["fwd_x_hat"], TOL)
    got, want = float(run["port"]["fwd_bits"]), float(run["jax"]["fwd_bits"])
    assert abs(got - want) <= TOL * abs(want), (got, want)


def test_sharded_serving_streams_match_jax(run):
    port, want = run["port"], run["jax"]["serve"]
    assert len(port["serve_y"]) == len(want) == 8
    for j, enc in enumerate(want):
        assert port["serve_y"][j] == enc["strings"][0][0], j
        assert port["serve_z"][j] == enc["strings"][1][0], j
    assert port["serve_same_on_every_rank"] and port["serve_y_hat_exact"]
    assert tuple(port["serve_x_hat_shape"]) == (8, 128, 128, 3)


@pytest.mark.parametrize("dims", STEP_DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_sharded_train_step_matches_jax(run, dims):
    """Every rank's loss against JAX's; every parameter after the step, the
    tensor-parallel slices gathered, against JAX's through the bridge."""
    tag = f"step{dims[0]}x{dims[1]}"
    port = run["port"]
    want_loss, want_flat = run["jax"]["step"]
    losses = port[f"{tag}/losses"]
    assert len(losses) == WORLD and len(set(losses.tolist())) == 1, losses
    assert abs(losses[0] - want_loss) <= TOL * abs(want_loss), (losses[0], want_loss)
    want = from_jax_params(want_flat)
    got = {k[len(tag) + 7:]: v for k, v in port.items() if k.startswith(f"{tag}/param/")}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    sliced = set(port[f"{tag}/sliced"].tolist())
    assert bool(sliced) == (dims[1] > 1), sliced


def test_sharded_step_keeps_each_ranks_rows_of_the_global_noise(run):
    """World 4 against one process at the same seed, for a model whose y
    noise is NCHW (rows on axis 0) and whose z noise is [C, 1, B*h*w] (rows
    the outer factor of the last axis): every rank drew the global batch's
    shapes and kept its own rows."""
    port = run["port"]
    shapes = set(port["ms/noise_shapes"].tolist())
    assert shapes == {str((16, 1, 4)), str((4, 24, 4, 4))}, shapes
    losses, want = port["ms/losses"], float(port["ms/one_loss"])
    assert len(losses) == WORLD and len(set(losses.tolist())) == 1, losses
    assert abs(losses[0] - want) <= TOL * abs(want), (losses[0], want)
    names = [k[len("ms/one/"):] for k in port if k.startswith("ms/one/")]
    assert names
    for name in names:
        np.testing.assert_allclose(port[f"ms/param/{name}"], port[f"ms/one/{name}"], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _jax_selected(flat, n_model, min_channels):
    mesh = Mesh(np.asarray(jax.devices()[:2 * n_model]).reshape(2, n_model), ("data", "model"))
    specs = jax_tp_specs(_tree(flat), mesh, min_channels)
    return {torch_key(k, flat) for k, spec in _flat_specs(specs).items() if spec != ()}


def _flat_specs(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(getattr(k, "key", str(k)) for k in path): tuple(s) for path, s in leaves}


@pytest.mark.parametrize("model, min_channels", [("balle128", 128), ("tcm", 32)])
def test_tensor_parallel_specs_select_jax_leaves(run, model, min_channels):
    """The factorized prior N=128 at the default threshold (its convolutions
    and deconvolutions) and the tiny TCM at 32 channels (convolutions,
    subpel convolutions and the Swin blocks' linears)."""
    if model == "tcm":
        flat, module = run["flat_tcm"], make_tcm(device="cpu", **TINY_TCM).module
    else:
        flat, module = run["flat128"], FactorizedPrior(N=128, M=128)
    want = _jax_selected(flat, 2, min_channels)
    got = pmesh.tensor_parallel_specs(module, 2, min_channels)
    assert want and set(got) == want
    for name, dim in got.items():
        layer = module.get_submodule(name.rpartition(".")[0])
        assert dim == (1 if isinstance(layer, torch.nn.ConvTranspose2d) else 0), name


def _streams(port, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in port.items() if k.startswith(prefix)}


def _jax_streams(enc) -> dict:
    if "packed" in enc:
        return {"packed": enc["packed"]}
    return {f"{name}{i}": np.asarray(a) for name, pair in enc["device_streams"].items()
            for i, a in enumerate(pair)}


@pytest.mark.parametrize("profile", ["table", "analytic", "odd"])
def test_sharded_device_coder_matches_one_process_and_jax(run, profile):
    """A data group of 2 ranks against an unsharded codec in the same
    process: every stream byte-identical, y_hat and the decoded x_hat
    equal, the decodes exact. The batch of 4 (table, analytic) also
    against JAX's compress_device and compress_device_analytic; 3 images
    (odd) run whole on every rank."""
    port = run["port"]
    sharded, one = (_streams(port, f"dev/{tag}/{profile}/") for tag in ("sharded", "one"))
    assert set(sharded) == set(one) and sharded["exact"] and one["exact"]
    for key, a in one.items():
        np.testing.assert_array_equal(sharded[key], a, err_msg=key)
    if profile != "odd":
        want = _jax_streams(run["jax"][profile])
        for key, a in want.items():
            np.testing.assert_array_equal(sharded[key], a, err_msg=key)
    assert sharded["y_hat"].shape[0] == (3 if profile == "odd" else 4)


@pytest.mark.parametrize("path, profile", [("roundtrip_device_pipelined", "table"),
                                           ("serve_roundtrip_pipelined", "analytic"),
                                           ("serve_roundtrip_metrics", "analytic")])
def test_sharded_device_pipelines_give_the_profiles_streams(run, path, profile):
    """The pipelines over the batch of 4 and its reverse at a data group of
    2: the first batch's streams are the unsharded profile's, and every
    batch decodes to its encoder's y_hat."""
    port = run["port"]
    first, second = (_streams(port, f"dev/{path}{j}/") for j in (0, 1))
    assert first.pop("exact") and second.pop("exact")
    want = _streams(port, f"dev/one/{profile}/")
    for key, a in first.items():
        np.testing.assert_array_equal(a, want[key], err_msg=key)
    assert not all(np.array_equal(a, second[key]) for key, a in first.items())


@pytest.mark.parametrize("path", ["compress_pipelined", "roundtrip_pipelined"])
def test_sharded_host_pipelines_match_jax(run, path):
    """The pipelined host codec at a data group of 2 over the serving
    batch's halves: each image's y and z streams are JAX's codec's; the
    roundtrip decodes every batch exactly."""
    port, want = run["port"], run["jax"]["serve"]
    assert len(port[f"dev/{path}/y"]) == len(want) == 8
    for j, enc in enumerate(want):
        assert port[f"dev/{path}/y"][j] == enc["strings"][0][0], j
        assert port[f"dev/{path}/z"][j] == enc["strings"][1][0], j
    assert port["dev/roundtrip_pipelined/exact"]


def test_batch_sharding_and_replicated_place_as_shard_batch_and_replicate(run):
    """On the 2 x 2 mesh: ``batch_sharding`` leaves each rank its data
    row's half of a batch of 8, as ``shard_batch`` does (ranks 0 and 1 the
    first half); ``replicated`` gives every rank the first rank's tensor,
    as ``replicate`` gives its parameters."""
    port = run["port"]
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    want = np.stack([rows[:4], rows[:4], rows[4:], rows[4:]])
    np.testing.assert_array_equal(port["place/batch_rows"], want)
    np.testing.assert_array_equal(port["place/shard_batch_rows"], want)
    np.testing.assert_array_equal(port["place/replicated"], np.zeros((4, 2, 3)))
    np.testing.assert_array_equal(port["place/replicate"], np.zeros((4, 2, 3)))
    assert [str(p) for p in pmesh.batch_sharding(None)] == ["S(0)", "R"]
    assert [str(p) for p in pmesh.replicated(None)] == ["R", "R"]


def test_dryrun_multichip_matches_the_one_process_step(capfd):
    from reslic_tcm_tpu_torch.parallel import dryrun
    from reslic_tcm_tpu_torch.training.step import create_train_state, step_noise, train_step

    loss = dryrun.dryrun_multichip(WORLD, "cpu")
    out = capfd.readouterr().out
    assert f"dryrun_multichip({WORLD}): ok, mesh=(data=2, model=2), loss={loss:.4f}" in out, out
    assert "sliced over 'model'" in out and "step executed" in out
    n_data, _ = dryrun.mesh_dims(WORLD)
    want = float(train_step(create_train_state(dryrun.dryrun_model("cpu")),
                            dryrun.dryrun_batch(n_data, "cpu"), dryrun.LMBDA,
                            step_noise(dryrun.SEED, 0, "cpu"))["loss"])
    assert np.isfinite(loss) and abs(loss - want) <= TOL * abs(want), (loss, want)


def test_dryrun_entry_is_a_training_forward():
    from reslic_tcm_tpu_torch.parallel import dryrun

    fn, args = dryrun.entry("cpu")
    x_hat, y_lik, z_lik = fn(*args)
    assert tuple(x_hat.shape) == (1, 3, 256, 256) and tuple(y_lik.shape) == (1, 320, 16, 16)
    for t in (x_hat, y_lik, z_lik):
        assert bool(torch.isfinite(t).all())
    assert bool(((y_lik > 0) & (y_lik <= 1)).all()) and x_hat.requires_grad


def test_batch_rows_at_world_1_and_4(run):
    assert not multihost.is_multiprocess() and multihost.is_coordinator()
    assert multihost.local_batch_size(16) == 16 and multihost.local_batch_size(7) == 7
    x = np.arange(8)
    np.testing.assert_array_equal(multihost.distribute_batch(None, x), x)
    port = run["port"]
    assert int(port["local_batch_size_8"]) == 2 and port["local_batch_size_6_refused"]
    np.testing.assert_array_equal(port["rows"], x.reshape(WORLD, 2))


def test_train_cli_runs_with_a_coordinator(tmp_path, capsys):
    """One rank of a gloo world of one through ``--coordinator`` (the
    factorized prior, N=16, M=24): a step, validation and rank 0's
    checkpoints, and the process group taken down after."""
    from PIL import Image

    from reslic_tcm_tpu_torch.cli import train as ptrain

    rng = np.random.default_rng(11)
    for split, n in (("train", 2), ("test", 1)):
        (tmp_path / "data" / split / "data").mkdir(parents=True)
        for i in range(n):
            img = (rng.uniform(size=(128, 128, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / "data" / split / "data" / f"{i}.png")
    argv = ["--platform", "cpu", "-m", "factorized", "--N", "16", "--M", "24", "-d",
            str(tmp_path / "data"),
            "--patch-size", "128", "128", "--batch-size", "2", "--test-batch-size", "1",
            "-n", "1", "-e", "1", "--lambda_list", "0.013", "--save_path",
            str(tmp_path / "runs"), "--kodak", "none", "--coordinator",
            f"127.0.0.1:{multihost.free_port()}", "--num_processes", "1", "--process_id", "0"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside other workers' XLA compiles, more threads thrash
    try:
        assert ptrain.main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    assert not torch.distributed.is_initialized()
    out = capsys.readouterr().out
    assert "Train epoch 0" in out and "valid epoch 0" in out
    assert any(f.endswith(".ckpt") for _, _, fs in os.walk(tmp_path / "runs") for f in fs)
