"""The bf16 serving mode of the port's TCM codec on the CPU
(``ChannelARCodec.set_matmul_precision("bfloat16")``), against the JAX
codec in the same mode, at the tiny widths of tests/test_torch_port_tcm.py.

What the JAX codec's bf16 mode does on the CPU: its programs run under
``jax.default_matmul_precision("bfloat16")``, which XLA's CPU backend
ignores (its products stay fp32), while its explicit casts act: the
composed window attention and the Swin MLP run in bf16 (``_score_dtype``).
The port rounds every conv and linear operand to bf16 as the TPU does, and
runs B1-B3's plain bf16 versions. So the two forwards differ by the port's
extra operand rounding (through the synthesis's convolutions, which XLA's
CPU does not round) and, where y - mu lands near a half, by a y symbol
that rounds the other way. Tolerances, with what the run shows: x_hat mean
|port - jax| <= 2e-2 and max <= 0.2 (6.4e-3 and 0.08); at most 1% of the
y and of the z likelihoods beyond 1e-2 (0.1% and 0); bpp within 2%
(0.35%). The mode must move x_hat from the fp32 mode's by a mean above
1e-3 (4.6e-3), so a mode that rounds nothing fails.

The port's own bf16 codec decodes y_hat exactly, and switching the mode
back to None gives the fp32 outputs again, bit for bit. JAX compiles with
``jax_disable_most_optimizations`` (the bf16 programs compile anew).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.tcm import make_tcm as jax_make_tcm
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.ops.launches import launch_counts
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from torch_port_threads import one_torch_thread  # noqa: E402,F401

SMALL = dict(N=32, M=80, hyper_ch=24, atten_inter_dim=32)
HW = 128


def _bpp(likelihoods) -> float:
    return sum(float(-np.log2(np.asarray(v, np.float64)).sum())
               for v in likelihoods.values()) / HW ** 2


@pytest.fixture(scope="module")
def codecs():
    """The port codec, the image, JAX's bf16 forward of it at the same
    seeded weights, and the port's fp32 forward."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    off = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jc = jax_make_tcm(input_shape=(HW, HW), fast_init=True, **SMALL)
        rng = np.random.default_rng(0)
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jc.params)[0]:
            names = [getattr(k, "key", str(k)) for k in path]
            v = np.asarray(leaf, np.float32)
            if names[-1] in ("bias", "scale"):  # structure-only init leaves these constant
                v = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
            flat["/".join(names)] = v
        tree = {}
        for key, v in flat.items():
            node = tree
            for p in key.split("/")[:-1]:
                node = node.setdefault(p, {})
            node[key.split("/")[-1]] = jnp.asarray(v)
        jc.variables = {"params": tree}
        pc = make_tcm(device="cpu", **SMALL)
        pc.module.load_state_dict(from_jax_params(flat), strict=True)
        pc.update()
        g = rng.uniform(size=(1, 8, 8, 3))
        img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
        img += rng.normal(scale=0.02, size=img.shape)
        image = np.clip(img, 0, 1).astype(np.float32)
        jc.set_matmul_precision("bfloat16")
        jax_bf16 = jc.forward(jnp.asarray(image), training=False)
    finally:
        jax.config.update("jax_disable_most_optimizations", off)
    yield {"pc": pc, "image": image, "jax_bf16": jax_bf16, "port_fp32": pc.forward(image)}
    torch.set_num_threads(threads)


@pytest.fixture
def bf16_codec(codecs):
    pc = codecs["pc"]
    pc.set_matmul_precision("bfloat16")
    yield pc
    pc.set_matmul_precision(None)


def test_bf16_forward_matches_jax_bf16_forward(codecs, bf16_codec):
    got = bf16_codec.forward(codecs["image"])
    want = codecs["jax_bf16"]
    d = np.abs(got["x_hat"].numpy() - np.asarray(want["x_hat"]))
    assert d.mean() <= 2e-2 and d.max() <= 0.2, (d.mean(), d.max())
    for k in ("y", "z"):
        dk = np.abs(got["likelihoods"][k].numpy() - np.asarray(want["likelihoods"][k]))
        assert np.mean(dk > 1e-2) <= 0.01, (k, np.mean(dk > 1e-2))
    bpp, want_bpp = _bpp(got["likelihoods"]), _bpp(want["likelihoods"])
    assert abs(bpp - want_bpp) <= 2e-2 * want_bpp, (bpp, want_bpp)
    moved = float((got["x_hat"] - codecs["port_fp32"]["x_hat"]).abs().mean())
    assert moved > 1e-3, moved


def test_bf16_roundtrip_is_exact(codecs, bf16_codec):
    enc = bf16_codec.compress(codecs["image"])
    dec = bf16_codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    fwd = bf16_codec.forward(codecs["image"])
    np.testing.assert_allclose(dec["x_hat"].numpy(), np.clip(fwd["x_hat"].numpy(), 0, 1),
                               atol=1e-5)


def test_bf16_device_coder_roundtrip_is_exact(codecs, bf16_codec):
    """The table device coder's pair (plain lane coders on the CPU) in
    bf16 mode: the decoder's slice loop reproduces the encoder's y_hat."""
    enc = bf16_codec.compress_device(codecs["image"], k=64)
    dec = bf16_codec.decompress_device(enc)
    assert torch.equal(dec["y_hat"], enc["y_hat"])


def test_precision_none_gives_the_fp32_bits_back(codecs):
    pc = codecs["pc"]
    pc.set_matmul_precision("bfloat16")
    pc.forward(codecs["image"])
    pc.set_matmul_precision(None)
    again = pc.forward(codecs["image"])
    want = codecs["port_fp32"]
    assert torch.equal(again["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        assert torch.equal(again["likelihoods"][k], want["likelihoods"][k])
    with pytest.raises(ValueError, match="precision"):
        pc.set_matmul_precision("float16")


def test_bf16_mode_counts_no_launch_on_the_cpu(codecs, bf16_codec):
    before = (launch_counts(), launch_counts(torch.bfloat16))
    bf16_codec.forward(codecs["image"])
    assert (launch_counts(), launch_counts(torch.bfloat16)) == before


def test_eval_cli_bf16_runs_tcm_only():
    """The JAX CLI reads --bf16 only on its TCM branch; the port refuses it
    for the other models, naming the codecs' own way into the mode."""
    from reslic_tcm_tpu_torch.cli import eval as peval

    with pytest.raises(NotImplementedError, match="set_matmul_precision"):
        peval.main(["--data", ".", "--platform", "cpu", "--bf16", "--model", "wacnn"])
