"""Port parity for the tiled path of the parallel slice
(reslic_tcm_tpu_torch/parallel/spatial.py) against the JAX package's
reslic_tcm_tpu/parallel/spatial.py at the same weights, and the eval CLI's
``--tile`` on the CPU.

- Tile positions and the owned bounds of ``tiled_forward``'s rate split
  equal JAX's exactly (the bounds read from the JAX function's own program
  arguments through a stand-in codec whose ``_jit`` records them).
- ``tile_image`` -> ``untile_image`` is the identity.
- ``tiled_forward`` of the Balle-2018 factorized prior (N=8, M=12, g_a's
  last convolution scaled up and GDN moved off its init, as in
  tests/test_torch_port_balle.py) and of a tiny TCM (N=32, M=40,
  hyper_ch 24, SWAtten inter_dim 16; structure-only init with perturbed
  biases, as in tests/test_torch_port_tcm.py), at 192x128 with tile 128,
  overlap 32, tile_batch 4 (two tiles, one chunk padded with two empty
  tiles), against JAX's: x_hat within 1e-5 (max |port - jax| <= 1e-5 * max(1,
  max |jax|)), bits within 1e-5 relative.

JAX's weights reach the port through the weight bridge
(tests/torch_port_jax_models.py initialises each JAX model once a
process). Each JAX program is compiled once for the file, with XLA's
optimisations off.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.models.balle2018 import HyperpriorCodec as JHyperpriorCodec
from reslic_tcm_tpu.parallel import spatial as jsp
from reslic_tcm_tpu_torch.cli import eval as peval
from reslic_tcm_tpu_torch.models.balle2018 import make_balle
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.ops.math import compute_padding, pad_nhwc
from reslic_tcm_tpu_torch.parallel import spatial as sp
from reslic_tcm_tpu_torch.utils.torch_convert import from_jax_params
from tests.test_torch_port_train_parity import _tree
from tests.torch_port_inputs import TINY_TCM, err_ok
from tests.torch_port_jax_models import jax_factorized, jax_tiny_tcm
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-5
# (H, W, tile, overlap): tiled_forward's default tile on 1200x1200 and on
# chip_smoke.py's 2048x1408 (20 tiles), and a small ragged grid
GRIDS = [(1200, 1200, 512, 64), (2048, 1408, 512, 64), (300, 280, 128, 32)]
HW, TILE, OVERLAP, TILE_BATCH = (192, 128), 128, 32, 4


class _BoundsSpy:
    """A codec for JAX's ``tiled_forward`` whose ``_jit`` hands back a
    function that records the owned bounds the real program would get."""

    def __init__(self, h, w):
        self.h, self.w, self.bounds, self.variables = h, w, None, None

    def _jit(self, name, program):
        def run(variables, tiles, bounds):
            self.bounds = np.asarray(bounds).reshape(-1, 4)
            return jnp.zeros((1, self.h, self.w, 3)), 0.0
        return run


@pytest.mark.parametrize("h, w, tile, overlap", GRIDS)
def test_tile_grid_matches_jax(h, w, tile, overlap):
    assert sp.tile_grid(h, w, tile, overlap) == jsp.tile_grid(h, w, tile, overlap)


@pytest.mark.parametrize("h, w, tile, overlap", GRIDS)
def test_owned_bounds_match_jax(h, w, tile, overlap):
    """Integer for integer, the padded tiles' empty rows included (tile
    batch 8, as chip_smoke.py's TCM-S run uses)."""
    spy = _BoundsSpy(h, w)
    jsp.tiled_forward(spy, jnp.zeros((1, h, w, 3), jnp.float32), tile, overlap, tile_batch=8)
    pos = sp.tile_grid(h, w, tile, overlap)
    got = sp.owned_bounds(pos, h, w, tile)
    np.testing.assert_array_equal(got, spy.bounds[:len(pos)])
    assert not spy.bounds[len(pos):].any()
    # the owned regions partition the image: each pixel counted once
    cover = np.zeros((h, w), np.int32)
    for (y, x0), (r0, r1, c0, c1) in zip(pos, got):
        cover[y + r0:y + r1, x0 + c0:x0 + c1] += 1
    assert (cover == 1).all()


def test_tile_untile_roundtrip():
    x = np.random.default_rng(1).uniform(size=(1, 300, 280, 3)).astype(np.float32)
    tiles, pos = sp.tile_image(x, tile=128, overlap=32)
    back = sp.untile_image(tiles, pos, 300, 280, 128, 32)
    assert torch.equal(back, torch.from_numpy(x))


def _image(seed=2):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(1, HW[0] // 16, HW[1] // 16, 3))
    img = np.repeat(np.repeat(g, 16, axis=1), 16, axis=2)
    return np.clip(img + rng.normal(scale=0.02, size=img.shape), 0, 1).astype(np.float32)


def _balle_pair():
    module, flat = jax_factorized(8, 12, perturb=True)
    pc = make_balle("factorized", N=8, M=12, device="cpu")
    pc.module.load_state_dict(from_jax_params(flat), strict=True)
    return JHyperpriorCodec(module, {"params": _tree(flat)}), pc


def _tcm_pair():
    jc, flat = jax_tiny_tcm()
    pc = make_tcm(device="cpu", **TINY_TCM)
    pc.module.load_state_dict(from_jax_params(flat), strict=True)
    return jc, pc


@pytest.fixture(scope="module")
def tiled():
    """{model: (JAX's tiled_forward, the port's, the port's codec)} of one
    image."""
    x, runs = _image(), {}
    optimisations_off = jax.config.read("jax_disable_most_optimizations")
    for kind, pair in (("factorized", _balle_pair), ("tcm", _tcm_pair)):
        jc, pc = pair()
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            want = jsp.tiled_forward(jc, jnp.asarray(x), TILE, OVERLAP, TILE_BATCH)
        finally:
            jax.config.update("jax_disable_most_optimizations", optimisations_off)
        runs[kind] = (want, sp.tiled_forward(pc, x, TILE, OVERLAP, TILE_BATCH), pc)
    return runs


@pytest.mark.parametrize("kind", ["factorized", "tcm"])
def test_tiled_forward_matches_jax(tiled, kind):
    """Two tiles at (0, 0) and (64, 0), one chunk of 4 padded with two
    empty tiles."""
    (want_hat, want_bits), (got_hat, got_bits), _ = tiled[kind]
    assert sp.tile_grid(*HW, TILE, OVERLAP) == [(0, 0), (64, 0)]
    err_ok(got_hat, want_hat, TOL)
    assert abs(got_bits - want_bits) <= TOL * abs(want_bits), (got_bits, want_bits)


def test_tiled_forward_stays_close_to_the_monolithic_forward(tiled):
    """As the JAX package's own test asks of the factorized prior
    (tests/test_spatial.py:75): finite, mean |difference| below 0.02 and
    PSNR above 25 dB. (TCM's monolithic forward needs sides that are
    multiples of 128.)"""
    _, (got_hat, bits), pc = tiled["factorized"]
    mono = torch.clamp(pc.forward(_image())["x_hat"], 0, 1)
    diff = (got_hat - mono).abs()
    assert bool(torch.isfinite(got_hat).all()) and bits > 0
    assert float(diff.mean()) < 0.02
    assert -10 * np.log10(float((diff ** 2).mean()) + 1e-12) > 25


def test_eval_cli_tiles_the_forward_estimate(tmp_path, capsys):
    """``--tile 128 --tile-overlap 32`` on a 200x176 PNG padded to 256x256
    (nine tiles): the printed bpp is ``tiled_forward``'s bits over the
    padded pixels, and differs from the monolithic estimate's."""
    from PIL import Image

    from reslic_tcm_tpu_torch.data.synthetic import synth_image

    img = synth_image(np.random.default_rng(4), 200, 176)
    Image.fromarray((img * 255).round().astype(np.uint8)).save(tmp_path / "a.png")
    x = torch.from_numpy(np.asarray(Image.open(tmp_path / "a.png"), np.float32)[None] / 255.0)
    xp = pad_nhwc(x, compute_padding(200, 176, 128)[0])  # the eval CLI's pad
    codec = make_tcm(N=32, M=80, device="cpu")
    assert len(sp.tile_grid(256, 256, 128, 32)) == 9
    _, bits = sp.tiled_forward(codec, xp, 128, 32)
    mono = sp.total_bits(codec.forward(xp)["likelihoods"])
    args = ["--data", str(tmp_path), "--platform", "cpu", "--N", "32", "--M", "80"]
    assert peval.main(args + ["--tile", "128", "--tile-overlap", "32"]) == 0
    out = capsys.readouterr().out
    assert f"average_Bit-rate: {bits / (256 * 256):.3f} bpp" in out, out
    assert f"{bits / (256 * 256):.3f}" != f"{mono / (256 * 256):.3f}"
