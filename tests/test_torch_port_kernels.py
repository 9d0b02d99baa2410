"""Port parity for the four kernels B1-B4 of reslic_tcm_tpu_torch, on
the CPU: each kernel's plain PyTorch version (what the wrapper runs on a
CPU tensor) against the JAX package's Pallas kernel run in interpret mode
(at shapes the Pallas kernel takes) or, for H and W that are not multiples
of 8, which the Pallas kernels refuse, against the JAX composed math. B4's
Pallas kernel lives in artifacts/, which is no package, so it is loaded
from its file. Tolerance: float32 with different summation orders (and,
for B4, the scale applied to the scores in the Pallas kernel and to q in
the plain version), max |port - jax| <= 1e-5 * max(1, max |jax|). The
CUDA kernels themselves are tested on the card by
tests/test_torch_port_cuda.py.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.ops import flash_window_attn as JF
from reslic_tcm_tpu.ops import fused_conv as JC
from reslic_tcm_tpu.ops import layers as JL
from reslic_tcm_tpu_torch.ops import flash_window_attn as PF
from reslic_tcm_tpu_torch.ops import fused_conv as PC
from reslic_tcm_tpu_torch.ops import qkv_attention as PQ
from torch_port_inputs import (attn_inputs, conv_inputs, err_ok, oihw, port_attn_args,
                               qkv_inputs)
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL_CPU = 1e-5


def _perhead_module():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "pallas_attn_perhead.py")
    spec = importlib.util.spec_from_file_location("pallas_attn_perhead", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------- CPU: vs JAX -----------------------------


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("head_dim", [8, 16, 32])
def test_b1_plain_matches_jax_kernel_interpret(shifted, head_dim):
    c = 64
    x, wts = attn_inputs(head_dim, 1, 16, 24, c)
    rel = np.random.default_rng(head_dim + 1).normal(0, 0.5, (c // head_dim, 64, 64)).astype(
        np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], j["ln_scale"],
        j["ln_bias"], jnp.asarray(rel),
        mlp=(j["ln2_scale"], j["ln2_bias"], j["w1"], j["b1"], j["w2"], j["b2"]),
        head_dim=head_dim, window=8, shifted=shifted, compute_dtype=jnp.float32,
        interpret=True)
    got = PF.flash_window_block(torch.from_numpy(x), *port_attn_args(wts, rel, lambda t: t),
                                head_dim=head_dim, window=8, shifted=shifted)
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim", [(96, 8), (96, 16), (96, 32), (128, 8), (128, 32)])
def test_b1_plain_matches_jax_kernel_interpret_at_wider_channels(shifted, c, head_dim):
    """B1's LN+MLP flavour at the widths of TCM N=96 and N=128's
    ConvTransBlocks."""
    x, wts = attn_inputs(c + head_dim, 1, 16, 24, c)
    rel = np.random.default_rng(c + 1).normal(0, 0.5, (c // head_dim, 64, 64)).astype(
        np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], j["ln_scale"],
        j["ln_bias"], jnp.asarray(rel),
        mlp=(j["ln2_scale"], j["ln2_bias"], j["w1"], j["b1"], j["w2"], j["b2"]),
        head_dim=head_dim, window=8, shifted=shifted, compute_dtype=jnp.float32,
        interpret=True)
    got = PF.flash_window_block(torch.from_numpy(x), *port_attn_args(wts, rel, lambda t: t),
                                head_dim=head_dim, window=8, shifted=shifted)
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("head_dim", [8, 16, 32])
def test_b1_plain_matches_jax_kernel_interpret_at_192_channels(shifted, head_dim):
    """B1's LN+MLP flavour at TCM N=192's ConvTransBlocks, on a 16x16 map."""
    c = 192
    x, wts = attn_inputs(c + head_dim, 1, 16, 16, c)
    rel = np.random.default_rng(c + 1).normal(0, 0.5, (c // head_dim, 64, 64)).astype(
        np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], j["ln_scale"],
        j["ln_bias"], jnp.asarray(rel),
        mlp=(j["ln2_scale"], j["ln2_bias"], j["w1"], j["b1"], j["w2"], j["b2"]),
        head_dim=head_dim, window=8, shifted=shifted, compute_dtype=jnp.float32,
        interpret=True)
    got = PF.flash_window_block(torch.from_numpy(x), *port_attn_args(wts, rel, lambda t: t),
                                head_dim=head_dim, window=8, shifted=shifted)
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("shifted", [False, True])
def test_b1_attention_only_plain_matches_jax_kernel_interpret(shifted):
    """B1's with_ln=False, mlp=None flavour (WACNN's WinBasedAttention) at
    head_dim 24, the width of WACNN's N=192 attention."""
    c, head_dim = 48, 24
    x, wts = attn_inputs(24, 2, 16, 24, c)
    rel = np.random.default_rng(25).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], j["ln_scale"],
        j["ln_bias"], jnp.asarray(rel), mlp=None, head_dim=head_dim, window=8,
        shifted=shifted, compute_dtype=jnp.float32, interpret=True, with_ln=False)
    wqkv, bqkv, wproj, bproj, *_ = port_attn_args(wts, rel, lambda t: t)
    got = PF.flash_window_block(torch.from_numpy(x), wqkv, bqkv, wproj, bproj, None, None,
                                torch.from_numpy(rel), None, head_dim=head_dim, window=8,
                                shifted=shifted, with_ln=False)
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("masked", [False, True])
def test_b4_plain_matches_jax_kernel_interpret(masked):
    """20 windows (not a multiple of the Pallas tile of 16) of 16 tokens,
    C=40, 8 heads; the mask is [4, T, T], one image's shift mask, and the
    Pallas kernel gets it tiled to every window."""
    perhead = _perhead_module()
    windows, wqkv, bqkv, rel, wproj, bproj, mask = qkv_inputs(26, 20, 16, 40, 8, 4)
    jmask = jnp.asarray(np.tile(mask, (5, 1, 1))) if masked else None
    want = perhead.fused_qkv_attention(
        *map(jnp.asarray, (windows, wqkv, bqkv, rel, wproj, bproj)), mask=jmask,
        interpret=True)
    t = torch.from_numpy
    got = PQ.fused_qkv_attention(t(windows), t(wqkv.T.copy()), t(bqkv), t(rel),
                                 t(wproj.T.copy()), t(bproj), t(mask) if masked else None)
    err_ok(got.numpy(), want, TOL_CPU)


def test_b2_plain_matches_jax_kernel_interpret():
    x, w1, b1, w2, b2, *_ = conv_inputs(20, 2, 16, 24, 64)
    want = JC.fused_residual_block(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                   compute_dtype=jnp.float32, interpret=True)
    got = PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1),
                                  oihw(w2), torch.from_numpy(b2))
    err_ok(got.numpy(), want, TOL_CPU)


def test_b2_plain_matches_jax_kernel_interpret_at_96_channels():
    """B2 at the width of TCM N=96's ConvTransBlocks."""
    x, w1, b1, w2, b2, *_ = conv_inputs(27, 1, 16, 24, 96)
    want = JC.fused_residual_block(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                   compute_dtype=jnp.float32, interpret=True)
    got = PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1),
                                  oihw(w2), torch.from_numpy(b2))
    err_ok(got.numpy(), want, TOL_CPU)


def test_b2_plain_matches_jax_kernel_interpret_at_192_channels():
    """B2 at the width of TCM N=192's ConvTransBlocks."""
    x, w1, b1, w2, b2, *_ = conv_inputs(29, 1, 16, 16, 192)
    want = JC.fused_residual_block(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                   compute_dtype=jnp.float32, interpret=True)
    got = PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1),
                                  oihw(w2), torch.from_numpy(b2))
    err_ok(got.numpy(), want, TOL_CPU)


def test_b2_plain_matches_jax_composed_on_ragged_shape():
    """13x10 is no multiple of 8, which the Pallas kernel refuses (JAX falls
    back to its composed ResidualBlock); the port's kernel masks the ragged
    edge itself, and its plain version must equal JAX's composed math."""
    x, w1, b1, w2, b2, *_ = conv_inputs(21, 1, 13, 10, 64)
    assert JC.fused_residual_block(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                                   jnp.asarray(w2), jnp.asarray(b2), interpret=True) is None
    params = {"conv1": {"conv": {"kernel": w1, "bias": b1}},
              "conv2": {"conv": {"kernel": w2, "bias": b2}}}
    want = JL.ResidualBlock(64).apply({"params": params}, jnp.asarray(x))
    got = PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1),
                                  oihw(w2), torch.from_numpy(b2))
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("hw", [(16, 24), (11, 9)])
def test_b3_plain_matches_jax(inverse, hw):
    """The Pallas kernel in interpret mode where it takes the shape (H, W
    multiples of 8), else the JAX composed conv + GDN math."""
    x, w, b, _, _, gamma, beta, skip = conv_inputs(22, 1, *hw, 64)
    jx = tuple(map(jnp.asarray, (x, w, b, gamma, beta, skip)))
    want = JC.fused_conv_gdn(*jx, inverse=inverse, compute_dtype=jnp.float32, interpret=True)
    if want is None:
        y = jax.lax.conv_general_dilated(jx[0], jx[1], (1, 1), ((1, 1), (1, 1)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC")) + jx[2]
        want = JL._gdn_apply(y, jx[4], jx[3], inverse) + jx[5]
    else:
        assert hw == (16, 24)
    got = PC.fused_conv_gdn(torch.from_numpy(x), oihw(w), torch.from_numpy(b),
                            torch.from_numpy(gamma), torch.from_numpy(beta),
                            torch.from_numpy(skip), inverse=inverse)
    err_ok(got.numpy(), want, TOL_CPU)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [192, 256, 384])
def test_b3_plain_matches_jax_kernel_interpret_at_wider_channels(inverse, c):
    """B3 at 2N of TCM N=96, N=128 and N=192 (the ResidualBlockWithStride
    and ResidualBlockUpsample tails)."""
    x, w, b, _, _, gamma, beta, skip = conv_inputs(28, 1, 16, 24, c)
    want = JC.fused_conv_gdn(*map(jnp.asarray, (x, w, b, gamma, beta, skip)), inverse=inverse,
                             compute_dtype=jnp.float32, interpret=True)
    got = PC.fused_conv_gdn(torch.from_numpy(x), oihw(w), torch.from_numpy(b),
                            torch.from_numpy(gamma), torch.from_numpy(beta),
                            torch.from_numpy(skip), inverse=inverse)
    err_ok(got.numpy(), want, TOL_CPU)


def test_wrappers_run_plain_version_on_cpu_and_count_nothing():
    x, w1, b1, w2, b2, *_ = conv_inputs(23, 1, 8, 8, 64)
    before = PC.fused_residual_block.launches
    PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1), oihw(w2),
                            torch.from_numpy(b2))
    assert PC.fused_residual_block.launches == before


# ------------------- B1/B4 yardsticks, build and cache -------------------


@pytest.mark.parametrize("masked", [False, True])
def test_b4_library_call_matches_plain(masked):
    """One F.multi_head_attention_forward call with rel_bias (+ the mask) as
    its additive attn_mask computes B4's function: chip_smoke.py times it as
    B4's library yardstick, so it must agree with the plain version."""
    import chip_smoke

    windows, wqkv, bqkv, rel, wproj, bproj, mask = qkv_inputs(29, 12, 16, 40, 8, 4)
    t = torch.from_numpy
    args = (t(windows), t(wqkv.T.copy()), t(bqkv), t(rel), t(wproj.T.copy()), t(bproj),
            t(mask) if masked else None)
    want = PQ.plain_qkv_attention(*args)
    attn_mask = chip_smoke.mha_mask(torch, args[3], args[6], 12)
    got = chip_smoke.library_qkv_attention(torch, args[0], args[1], args[2], attn_mask, args[4],
                                           args[5], 8)
    err_ok(got.numpy(), want.numpy(), TOL_CPU)


@pytest.mark.parametrize("shifted", [False, True])
def test_b1_attention_only_library_call_matches_plain(shifted):
    """The same call on the pre-partitioned 8x8 windows, with the -1e9 SW
    mask and rel_bias as attn_mask and the residual added outside, computes
    B1's attention-only flavour (chip_smoke.py's library time for it)."""
    import chip_smoke

    c, head_dim, shape = 48, 24, (2, 16, 24, 48)
    x, wts = attn_inputs(45, *shape)
    rel = np.random.default_rng(46).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    wqkv, bqkv, wproj, bproj, _, _, relc, _ = port_attn_args(wts, rel, lambda u: u)
    args = (torch.from_numpy(x), wqkv, bqkv, wproj, bproj, None, None, relc, None)
    want = PF.plain_window_block(*args, head_dim=head_dim, window=8, shifted=shifted,
                                 with_ln=False)
    lib, to_out = chip_smoke._library(torch, "flash_window_block", shape,
                                      (head_dim, shifted, False), args)
    err_ok(to_out(lib()).numpy(), want.numpy(), TOL_CPU)


def test_library_path_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edited header gives the kernel sources that include it (B1's
    three, the bf16 LN+MLP one built as two libraries, and B4's) a new
    object name, and leaves the others' names alone."""
    from reslic_tcm_tpu_torch.ops import build

    import shutil

    shutil.copytree(os.path.join(build._PKG, "csrc"), tmp_path / "csrc")
    shutil.copytree(os.path.join(build._PKG, "coding", "csrc"), tmp_path / "coding" / "csrc")
    shutil.copytree(os.path.join(build._PKG, "data", "csrc"), tmp_path / "data" / "csrc")
    monkeypatch.setattr(build, "_PKG", str(tmp_path))
    assert build.source_files("qkv_attention") == ["csrc/qkv_attention.cu",
                                                   "csrc/window_attn_common.cuh"]
    before = {name: build.library_path(name) for name in build.SOURCES}
    with open(tmp_path / "csrc" / "window_attn_common.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    changed = {name for name in build.SOURCES if before[name] != after[name]}
    assert changed == {"flash_window_attn", "flash_window_attn_bf16",
                       "flash_window_attn_bf16_wide", "window_attn_bf16", "qkv_attention"}


def _cached_module(kind):
    from reslic_tcm_tpu_torch.ops import window_attention as PW

    torch.manual_seed(3)
    if kind == "swin":
        m = PW.SwinTransformerBlock(32, 16, 8, "SW")
        return m, m.kernel_weights, m.msa.relative_position_params
    if kind == "qkv":
        m = PW.WindowAttention(40, 4, 8)
        return m, m.kernel_weights, m.qkv.weight
    m = PW.WindowAttention(32, 8, 2)
    return m, m.window_block_weights, m.relative_position_bias_table


@pytest.mark.parametrize("kind", ["swin", "qkv", "attention_only"])
def test_prepared_weights_are_cached_until_a_parameter_changes(kind):
    """A module builds its kernel's weights once: an unchanged call returns
    the same tensors; an in-place update of a parameter (as an optimiser step
    or load_snapshot_into makes) gives a new result, equal to preparing the
    updated weights afresh."""
    m, weights, param = _cached_module(kind)
    with torch.no_grad():
        args, prepared = weights()
        again_args, again = weights()
        assert again is prepared and again_args is args
        old = [p.clone() for p in prepared]
        param.add_(0.25)
        args2, prepared2 = weights()
    assert prepared2 is not prepared
    assert any(not torch.equal(a, b) for a, b in zip(prepared2, old))
    with torch.no_grad():
        if kind == "qkv":
            fresh = PQ.prepare_qkv_attention(*args2)
        else:
            hd = m.msa.head_dim if kind == "swin" else m.dim // m.num_heads
            fresh = PF.prepare_window_block(*args2, head_dim=hd)
    assert all(torch.equal(a, b) for a, b in zip(prepared2, fresh))


def test_prepared_weights_follow_autograd():
    """With autograd recording, the cache is bypassed: the weight arguments
    carry the graph back to the parameters."""
    m, weights, param = _cached_module("qkv")
    args, _ = weights()
    rel = args[2]
    rel.sum().backward()
    assert m.relative_position_bias_table.grad is not None
