"""Port parity for the PyTorch warm start (reslic_tcm_tpu_torch/utils/
torch_convert.py::warm_start_codec, used by cli/train.py and cli/eval.py):
a state dict in the layout of a CompressAI bmshj2018_hyperprior checkpoint
(N=32, M=48, CDF buffers included; tests/test_zoo_warm_start.py's), saved
as a .pth.tar, warms the port's scale hyperprior with a STanH z
(make_scale_stanh) as the JAX package's warm_start_codec warms JAX's.

Both codecs start from the same parameters: JAX's init, carried into the
port through the snapshot bridge (from_jax_params). After the warm start
every port parameter equals JAX's, through the same bridge, within rtol
1e-6 (the bridge transposes and flips, no arithmetic); the missing and
unused lists and the printed counts are JAX's. Both CLIs take the file:
the train CLI's warm start (also a whole --tester run) and the eval CLI's
checkpoint loading, which print the JAX CLIs' lines. Torch runs on one
intra-op thread.
"""

from __future__ import annotations

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.stanh import variants as JV
from reslic_tcm_tpu.utils import torch_convert as JC
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.cli import train as ptrain
from reslic_tcm_tpu_torch.models.stanh import variants as PV
from reslic_tcm_tpu_torch.utils import torch_convert as PC
from torch_port_threads import one_torch_thread  # noqa: F401

N, M = 32, 48

GCFG = dict(beta=10, num_sigmoids=0, activation="aann", symmetry=False,
            gap_factor=0, extrema=5, trainable=True)


def _bmshj2018_state_dict(rng):
    """Synthetic state dict with the exact key/shape layout of a CompressAI
    bmshj2018_hyperprior(N=32, M=48) checkpoint, CDF buffers included
    (tests/test_zoo_warm_start.py's)."""
    t = lambda *s: torch.from_numpy(rng.normal(scale=0.1, size=s).astype(np.float32))  # noqa: E731
    sd = {}
    # g_a: conv5x5 s2 / GDN alternating
    chans = [(3, N), (N, N), (N, N), (N, M)]
    for j, (ci, co) in enumerate(chans):
        sd[f"g_a.{2 * j}.weight"] = t(co, ci, 5, 5)
        sd[f"g_a.{2 * j}.bias"] = t(co)
        if j < 3:
            sd[f"g_a.{2 * j + 1}.beta"] = t(N)
            sd[f"g_a.{2 * j + 1}.gamma"] = t(N, N)
    # g_s: deconv5x5 s2 / IGDN alternating (ConvTranspose2d stores [I, O, kh, kw])
    chans = [(M, N), (N, N), (N, N), (N, 3)]
    for j, (ci, co) in enumerate(chans):
        sd[f"g_s.{2 * j}.weight"] = t(ci, co, 5, 5)
        sd[f"g_s.{2 * j}.bias"] = t(co)
        if j < 3:
            sd[f"g_s.{2 * j + 1}.beta"] = t(N)
            sd[f"g_s.{2 * j + 1}.gamma"] = t(N, N)
    # h_a: conv3x3 s1, relu, conv5x5 s2, relu, conv5x5 s2
    sd["h_a.0.weight"] = t(N, M, 3, 3); sd["h_a.0.bias"] = t(N)  # noqa: E702
    sd["h_a.2.weight"] = t(N, N, 5, 5); sd["h_a.2.bias"] = t(N)  # noqa: E702
    sd["h_a.4.weight"] = t(N, N, 5, 5); sd["h_a.4.bias"] = t(N)  # noqa: E702
    # h_s: deconv5x5 s2, relu, deconv5x5 s2, relu, conv3x3 s1
    sd["h_s.0.weight"] = t(N, N, 5, 5); sd["h_s.0.bias"] = t(N)  # noqa: E702
    sd["h_s.2.weight"] = t(N, N, 5, 5); sd["h_s.2.bias"] = t(N)  # noqa: E702
    sd["h_s.4.weight"] = t(M, N, 3, 3); sd["h_s.4.bias"] = t(M)  # noqa: E702
    # entropy bottleneck chain (filters (3,3,3,3)) + quantiles
    filt = [1, 3, 3, 3, 3, 1]
    for i in range(5):
        sd[f"entropy_bottleneck._matrix{i}"] = t(N, filt[i + 1], filt[i])
        sd[f"entropy_bottleneck._bias{i}"] = t(N, filt[i + 1], 1)
        if i < 4:
            sd[f"entropy_bottleneck._factor{i}"] = t(N, filt[i + 1], 1)
    sd["entropy_bottleneck.quantiles"] = t(N, 1, 3)
    # derived CDF buffers: present in a zoo checkpoint after update();
    # delete_keys() semantics say these must be ignored
    sd["entropy_bottleneck._quantized_cdf"] = torch.zeros(N, 17, dtype=torch.int32)
    sd["entropy_bottleneck._offset"] = torch.zeros(N, dtype=torch.int32)
    sd["entropy_bottleneck._cdf_length"] = torch.zeros(N, dtype=torch.int32)
    sd["gaussian_conditional._quantized_cdf"] = torch.zeros(64, 10, dtype=torch.int32)
    sd["gaussian_conditional._offset"] = torch.zeros(64, dtype=torch.int32)
    sd["gaussian_conditional._cdf_length"] = torch.zeros(64, dtype=torch.int32)
    sd["gaussian_conditional.scale_table"] = torch.zeros(64)
    return sd


def _flat(params) -> dict:
    """JAX parameters as {'/'-joined path: numpy array}."""
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port_codec(init: dict):
    """The port's codec holding JAX's parameters ``init`` (strictly: every
    parameter has its twin)."""
    pc = PV.make_scale_stanh([GCFG], N=N, M=M, fact_stanh=True, device="cpu", seed=1)
    pc.module.load_state_dict(PC.from_jax_params(init), strict=True)
    return pc


def _run(fn, *args):
    """(fn's result, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """One JAX codec (one init) and the port's at its parameters, both warmed
    from the same .pth.tar."""
    sd = _bmshj2018_state_dict(np.random.default_rng(3))
    path = str(tmp_path_factory.mktemp("zoo") / "bmshj2018_hyperprior_q5.pth.tar")
    torch.save({"state_dict": sd}, path)
    jc = JV.make_scale_stanh([GCFG], N=N, M=M, fact_stanh=True, rng=jax.random.PRNGKey(0),
                             input_shape=(64, 64))
    init = _flat(jc.params)
    pc = _port_codec(init)
    jreport, jout = _run(JC.warm_start_codec, jc, path)
    preport, pout = _run(PC.warm_start_codec, pc, path)
    return dict(sd=sd, path=path, init=init, jc=jc, pc=pc, jreport=jreport, preport=preport,
                jout=jout, pout=pout)


def _assert_equal_to_jax(module, jax_params):
    want = PC.from_jax_params(_flat(jax_params))
    own = module.state_dict()
    assert sorted(own) == sorted(want)
    for key, value in own.items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-6, atol=0,
                                   err_msg=key)


def test_warm_start_matches_jax_parameter_for_parameter(warmed):
    """Every parameter of the warmed port codec is JAX's: the transforms and
    the STanH bottleneck's chain from the file, the staircases at their
    init."""
    pc, sd = warmed["pc"], warmed["sd"]
    _assert_equal_to_jax(pc.module, warmed["jc"].params)
    own = pc.module.state_dict()
    assert torch.equal(own["g_s.0.weight"], sd["g_s.0.weight"])  # ConvTranspose2d: as stored
    assert torch.equal(own["entropy_bottleneck_stanh._matrix1"],
                       sd["entropy_bottleneck._matrix1"])
    init = PC.from_jax_params(warmed["init"])
    assert torch.equal(own["entropy_bottleneck_stanh.stanh.w"],
                       init["entropy_bottleneck_stanh.stanh.w"])


def test_warm_start_reports_match_jax(warmed):
    """The missing parameters (the STanH staircases), the unused file keys
    (quantiles: the STanH bottleneck has none; CDF buffers never listed)
    and the printed counts are JAX's."""
    jr, pr = warmed["jreport"], warmed["preport"]
    init = warmed["init"]
    assert sorted(t for _, t in pr["missing"]) == sorted(t for _, t in jr["missing"])
    assert sorted(k for k, _ in pr["missing"]) == sorted(
        PC.torch_key(m.replace(".", "/"), init) for m, _ in jr["missing"])
    assert pr["missing"] and all("stanh" in k for k, _ in pr["missing"])
    assert sorted(pr["unused"]) == sorted(jr["unused"]) == ["entropy_bottleneck.quantiles"]
    assert warmed["pout"] == warmed["jout"] and "kept init" in warmed["pout"]


def test_warm_start_refuses_a_shape_mismatch(warmed, tmp_path):
    """A tensor of the wrong shape raises ValueError, as in JAX, and leaves
    the codec as it was."""
    sd = dict(warmed["sd"])
    sd["h_a.2.weight"] = torch.zeros(N, N, 3, 3)
    path = str(tmp_path / "bad.pth")
    torch.save(sd, path)
    pc = _port_codec(warmed["init"])
    with pytest.raises(ValueError, match="shape mismatch"):
        PC.warm_start_codec(pc, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        JC.warm_start_codec(warmed["jc"], path)
    for key, value in pc.module.state_dict().items():
        assert torch.equal(value, PC.from_jax_params(warmed["init"])[key]), key


def test_train_cli_takes_the_pytorch_file(warmed, tmp_path, capsys):
    """cli/train.py's --checkpoint warm start loads the .pth.tar as JAX's
    trainer does (the parent raised: "checkpoint lacks 18 parameters"),
    alone and through a whole --tester run."""
    pc = _port_codec(warmed["init"])
    ptrain.warm_start(pc, warmed["path"])
    _assert_equal_to_jax(pc.module, warmed["jc"].params)
    assert capsys.readouterr().out == warmed["jout"]
    from PIL import Image

    rng = np.random.default_rng(5)
    for split in ("train", "test"):
        d = tmp_path / "data" / split / "data"
        d.mkdir(parents=True)
        Image.fromarray((rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)).save(d / "0.png")
    argv = ["--platform", "cpu", "-m", "scale_stanh", "--N", str(N), "--M", str(M),
            "-d", str(tmp_path / "data"), "--patch-size", "64", "64", "--batch-size", "1",
            "--test-batch-size", "1", "-n", "1", "--lambda_list", "0.013", "--tester",
            "--checkpoint", warmed["path"], "--save_path", str(tmp_path / "runs"),
            "--kodak", str(tmp_path / "none")]
    assert ptrain.main(argv) == 0
    assert warmed["jout"].strip() in capsys.readouterr().out


def test_eval_cli_takes_the_pytorch_file(warmed, capsys):
    """cli/eval.py's checkpoint loading takes the .pth.tar (the parent
    raised) and prints the JAX eval CLI's converter line."""
    pc = _port_codec(warmed["init"])
    peval.load_checkpoint(pc, warmed["path"])
    _assert_equal_to_jax(pc.module, warmed["jc"].params)
    jr = warmed["jreport"]
    assert capsys.readouterr().out == (f"converter: {len(jr['missing'])} missing, "
                                       f"{len(jr['unused'])} unused torch keys\n")
