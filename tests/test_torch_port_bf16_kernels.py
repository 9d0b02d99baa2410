"""Port parity of the kernels' bf16 mode, on the CPU: the plain bf16
versions of B1 (LN+MLP flavour), B2 and B3 (what the wrappers run on a CPU
tensor with ``compute_dtype=torch.bfloat16``) against the JAX package's
Pallas kernels run with ``compute_dtype=jnp.bfloat16, interpret=True`` on
the same seeded numpy inputs. B1 runs the Pallas kernel's block-diagonal
layout (``layout="bd"``), whose casts the port follows (the probabilities
rounded after the softmax's division); the head-packed layout rounds the
unnormalised exponentials instead, a TPU-only arrangement.

B1's attention-only flavour (WACNN's) is held the same way, and WACNN's
window-4 attention, which the JAX package composes in bf16 outside any
Pallas kernel, against JAX's composed module under its bf16 precision.

Tolerances: both sides round the same operands to bf16 and sum the exact
products in fp32, in other orders; where a sum lands within an fp32 ulp of
a bf16 rounding boundary the two round a value to neighbouring bf16 values
(one bf16 ulp, 2^-8 relative) and that flip propagates. So each comparison
states two limits: max |port - jax| <= 4e-3 * max(1, max |jax|), and at
most 10% of the elements beyond 1e-5 (measured: at most 8.6e-4 and 3.9%). A mode
that rounds nothing differs from the fp32 version on most elements (the
test checks over half), and B3 with y rounded in place of y*y differs on
over 80%.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reslic_tcm_tpu.ops import flash_window_attn as JF
from reslic_tcm_tpu.ops import fused_conv as JC
from reslic_tcm_tpu_torch.ops import flash_window_attn as PF
from reslic_tcm_tpu_torch.ops import fused_conv as PC
from torch_port_inputs import attn_inputs, conv_inputs, oihw, port_attn_args
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL_MAX = 4e-3
SHARE_MAX = 0.1
BF16 = torch.bfloat16


def _share_beyond(got, want, eps=1e-5) -> float:
    return float(np.mean(np.abs(np.asarray(got) - np.asarray(want)) > eps))


def bf16_ok(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL_MAX * max(1.0, float(np.abs(want).max())), err
    share = _share_beyond(got, want)
    assert share <= SHARE_MAX, share


def differs(bf16_out, fp32_out) -> None:
    """The bf16 mode rounds: over half the elements move beyond 1e-5."""
    assert _share_beyond(bf16_out, fp32_out) > 0.5


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim", [(64, 8), (64, 16), (32, 8)])
def test_b1_plain_bf16_matches_jax_kernel_interpret(shifted, c, head_dim):
    x, wts = attn_inputs(c + head_dim + 3, 1, 16, 16, c)
    rel = np.random.default_rng(c + 5).normal(0, 0.5, (c // head_dim, 64, 64)).astype(
        np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], j["ln_scale"],
        j["ln_bias"], jnp.asarray(rel),
        mlp=(j["ln2_scale"], j["ln2_bias"], j["w1"], j["b1"], j["w2"], j["b2"]),
        head_dim=head_dim, window=8, shifted=shifted, compute_dtype=jnp.bfloat16,
        interpret=True, layout="bd")
    args = port_attn_args(wts, rel, lambda t: t)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted)
    got = PF.flash_window_block(torch.from_numpy(x), *args, **kw, compute_dtype=BF16)
    bf16_ok(got.numpy(), want)
    differs(got.numpy(), PF.flash_window_block(torch.from_numpy(x), *args, **kw).numpy())


def test_b2_plain_bf16_matches_jax_kernel_interpret():
    x, w1, b1, w2, b2, *_ = conv_inputs(40, 2, 16, 24, 64)
    want = JC.fused_residual_block(*map(jnp.asarray, (x, w1, b1, w2, b2)),
                                   compute_dtype=jnp.bfloat16, interpret=True)
    args = (torch.from_numpy(x), oihw(w1), torch.from_numpy(b1), oihw(w2), torch.from_numpy(b2))
    got = PC.fused_residual_block(*args, compute_dtype=BF16)
    bf16_ok(got.numpy(), want)
    differs(got.numpy(), PC.fused_residual_block(*args).numpy())


@pytest.mark.parametrize("inverse", [False, True])
def test_b3_plain_bf16_matches_jax_kernel_interpret(inverse):
    """GDN and IGDN. The kernels round y*y, not y, to bf16 before the
    contraction with gamma: the version that rounds y falls outside the
    share limit."""
    x, w, b, _, _, gamma, beta, skip = conv_inputs(41, 2, 16, 24, 64)
    want = JC.fused_conv_gdn(*map(jnp.asarray, (x, w, b, gamma, beta, skip)), inverse=inverse,
                             compute_dtype=jnp.bfloat16, interpret=True)
    t = torch.from_numpy
    args = (t(x), oihw(w), t(b), t(gamma), t(beta), t(skip))
    got = PC.fused_conv_gdn(*args, inverse=inverse, compute_dtype=BF16)
    bf16_ok(got.numpy(), want)
    differs(got.numpy(), PC.fused_conv_gdn(*args, inverse=inverse).numpy())
    rd = PC.rounder(BF16)
    y = torch.nn.functional.conv2d(rd(t(x).permute(0, 3, 1, 2)), rd(oihw(w)), t(b), padding=1)
    norm = torch.nn.functional.conv2d(rd(y) * rd(y), rd(t(gamma))[:, :, None, None], t(beta))
    norm = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    rounding_y = (y * norm).permute(0, 2, 3, 1) + t(skip)
    assert _share_beyond(rounding_y.numpy(), want) > SHARE_MAX


def test_wrappers_refuse_other_compute_types():
    x, w1, b1, w2, b2, *_ = conv_inputs(42, 1, 8, 8, 64)
    with pytest.raises(ValueError, match="compute_dtype"):
        PC.fused_residual_block(torch.from_numpy(x), oihw(w1), torch.from_numpy(b1), oihw(w2),
                                torch.from_numpy(b2), compute_dtype=torch.float16)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim", [(48, 24), (32, 16)])
def test_b1_attention_only_plain_bf16_matches_jax_kernel_interpret(shifted, c, head_dim):
    """The attention-only flavour (with_ln=False, mlp=None; WACNN's head
    dims 24 and 16) in bf16 against the Pallas kernel's bd layout."""
    x, wts = attn_inputs(c + head_dim + 7, 1, 16, 16, c)
    rel = np.random.default_rng(c + 9).normal(0, 0.5, (c // head_dim, 64, 64)).astype(
        np.float32)
    j = {k: jnp.asarray(v) for k, v in wts.items()}
    ones, zeros = jnp.ones((c,), jnp.float32), jnp.zeros((c,), jnp.float32)
    want = JF.flash_window_block(
        jnp.asarray(x), j["wqkv"], j["bqkv"], j["wproj"], j["bproj"], ones, zeros,
        jnp.asarray(rel), mlp=None, head_dim=head_dim, window=8, shifted=shifted,
        compute_dtype=jnp.bfloat16, interpret=True, layout="bd", with_ln=False)
    wqkv, bqkv, wproj, bproj, _, _, relt, _ = port_attn_args(wts, rel, lambda t: t)
    args = (wqkv, bqkv, wproj, bproj, None, None, relt, None)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, with_ln=False)
    got = PF.flash_window_block(torch.from_numpy(x), *args, **kw, compute_dtype=BF16)
    bf16_ok(got.numpy(), want)
    # the residual x passes unrounded, so the attention branch alone moves
    differs(got.numpy() - x, PF.flash_window_block(torch.from_numpy(x), *args, **kw).numpy() - x)


def test_window4_attention_bf16_matches_jax_composed_bf16():
    """WACNN's window-4 attention (the composed WindowAttention, B4's plain
    version) in bf16: plain_qkv_attention's bf16 body, through the port's
    WinBasedAttention under matmul_precision("bfloat16"), against JAX's
    composed module under jax.default_matmul_precision("bfloat16"), shifted
    (the -100 region mask). XLA's CPU keeps JAX's two linears in fp32 where
    the port rounds their operands, so more elements differ than between
    two kernels: within 4e-3 * max(1, max |jax|), at most 30% of the
    elements beyond 1e-3 (measured: 4.4e-3 against a bound of 1.5e-2, and
    21%); the mode moves over half the elements from the fp32 mode's
    (measured: 99%)."""
    import jax

    from reslic_tcm_tpu_torch.ops.layers import matmul_precision
    from tests.test_torch_port_wacnn import _attention_pair

    m, v, p = _attention_pair(40, 2, 4, 2, seed=5)
    x = np.random.default_rng(6).normal(size=(2, 8, 12, 40)).astype(np.float32)
    with jax.default_matmul_precision("bfloat16"):
        want = np.asarray(m.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        fp32 = p(torch.from_numpy(x)).numpy()
        with matmul_precision("bfloat16"):
            got = p(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max())
    assert err <= TOL_MAX * max(1.0, float(np.abs(want).max())), err
    assert _share_beyond(got, want, 1e-3) <= 0.3
    differs(got, fp32)


def test_attention_only_flavour_has_no_bf16_instance():
    """Once refused (ROADMAP A15b), the attention-only flavour now has its bf16
    instance: its weights prepare in bf16 (the matrices as bf16 k-groups
    [in/8, out, 8], wqkv's rows head by head with the q rows scaled; the
    vectors and the bias table fp32), and WinBasedAttention's kernel path runs
    it under bf16 on the CPU (the plain bf16 version, launching nothing),
    giving the wrapper's output on the module's weights."""
    from reslic_tcm_tpu_torch.ops.launches import launch_counts
    from reslic_tcm_tpu_torch.ops.layers import matmul_precision
    from reslic_tcm_tpu_torch.ops.window_attention import WinBasedAttention

    c, hd = 48, 24
    _, wts = attn_inputs(43, 1, 16, 16, c)
    rel = np.zeros((c // hd, 64, 64), np.float32)
    wqkv, bqkv, wproj, bproj, *_ = port_attn_args(wts, rel, lambda t: t)
    prep = PF.prepare_window_block(wqkv, bqkv, wproj, bproj, None, None, torch.from_numpy(rel),
                                   None, head_dim=hd, compute_dtype=BF16)
    assert [t.dtype for t in prep] == [BF16, torch.float32, BF16, torch.float32, torch.float32]
    assert prep[0].shape == (c // 8, 3 * c, 8) and prep[2].shape == (c // 8, c, 8)
    heads = torch.arange(3 * c).reshape(3, c // hd, hd).permute(1, 0, 2).reshape(-1)
    wq, _ = PF._q_scaled(wqkv, bqkv, hd)
    assert torch.equal(prep[0], wq[heads].reshape(3 * c, c // 8, 8).permute(1, 0, 2).to(BF16))
    assert torch.equal(prep[2], wproj.reshape(c, c // 8, 8).permute(1, 0, 2).to(BF16))
    m = WinBasedAttention(c, num_heads=2, window_size=8, shift_size=4).eval()
    x = torch.from_numpy(np.random.default_rng(44).normal(size=(1, 16, 16, c)).astype(np.float32))
    before = (launch_counts(), launch_counts(BF16))
    with torch.no_grad():
        with matmul_precision("bfloat16"):
            got = m(x)
        fp32 = m(x)
        a = m.attn
        want = torch.roll(PF.plain_window_block(
            torch.roll(x, (-4, -4), (1, 2)), a.qkv.weight, a.qkv.bias, a.proj.weight,
            a.proj.bias, None, None, a.rel_bias(), None, head_dim=hd, window=8, shifted=True,
            with_ln=False, compute_dtype=BF16), (4, 4), (1, 2))
    assert (launch_counts(), launch_counts(BF16)) == before
    assert torch.equal(got, want)
    differs((got - x).numpy(), (fp32 - x).numpy())


# ------------- the redesigned bf16 kernels' host-side choices -------------
# (ops/fused_conv.py's bf16 tile rule, ops/flash_window_attn.py's windows a
# CTA and both prepared layouts; the kernels themselves run on the card,
# tests/test_torch_port_cuda.py)

SMEM_BLOCK = 232448 - 1024  # a block's dynamic shared memory, the kernels' margin kept


def _conv_smem(c: int, tile: str, taps: int) -> int:
    """csrc/fused_conv_bf16.cu's ConvGeom: the bf16 halo [C/8][pixels,
    rounded up to 8][8] and at least two W stages of KC x NB."""
    th, tw, nb = PC.tile_shape_bf16(tile, c)
    pad = 1 if taps == 9 else 0
    npix = (th + 2 * pad) * (tw + 2 * pad)
    kc = 64 if c % 64 == 0 else 32
    return c // 8 * -(-npix // 8) * 8 * 16 + 2 * kc * nb * 2


@pytest.mark.parametrize("c", [64, 96, 128, 192, 256, 384])
def test_bf16_conv_tiles_fit_and_cover_the_channels(c):
    """Each tile of every instance splits C into whole wgmma widths (a
    multiple of 8, at most 192), its pixels into 8x8 blocks two warpgroups
    share evenly, and its halo and two W stages fit one block's shared
    memory, for the 3x3 launch and the 1x1 GDN launch."""
    for tile in PC.TILES:
        th, tw, nb = PC.tile_shape_bf16(tile, c)
        assert c % nb == 0 and nb % 8 == 0 and nb <= 192, (c, tile)
        assert th % 8 == 0 and tw % 8 == 0 and (th // 8) * (tw // 8) % 2 == 0, (c, tile)
        for taps in (9, 1):
            assert _conv_smem(c, tile, taps) <= SMEM_BLOCK, (c, tile, taps)
    with pytest.raises(ValueError, match="no tile"):
        PC.tile_shape_bf16("huge", c)


@pytest.mark.parametrize("h,w,c,want", [
    (384, 256, 64, "large"), (192, 128, 64, "large"), (96, 64, 64, "small"),
    (192, 128, 192, "large"), (96, 64, 192, "small"), (96, 64, 128, "small"),
    (96, 64, 256, "large"), (96, 64, 384, "large"), (24, 16, 384, "small"),
    (24, 16, 256, "small"), (192, 128, 384, "large"), (13, 10, 96, "small")])
def test_bf16_conv_tile_choice_follows_the_grid(h, w, c, want):
    """The bf16 tile rule: the large tile where its grid has at least
    LARGE_TILE_BLOCKS blocks, else the small one (the faster of the two at
    each of these main-path maps on an H100); ragged maps count their
    partial tiles."""
    assert PC.tile_config_bf16(h, w, c) == want
    th, tw, nb = PC.tile_shape_bf16("large", c)
    blocks = -(-h // th) * -(-w // tw) * (c // nb)
    assert PC.tile_blocks_bf16("large", h, w, c) == blocks
    assert (blocks >= PC.LARGE_TILE_BLOCKS) == (want == "large")


def test_bf16_prepared_weights_are_kgroups_of_the_matrices():
    """B2/B3's bf16 weights as [K/8, C, 8]: entry [k // 8, n, k % 8] is the
    [C][taps * C] matrix's (n, k), k = tap * C + input channel with the taps
    in row-major order; gamma the same with one tap. The fp32 instance keeps
    its own layout."""
    c = 16
    rng = np.random.default_rng(3)
    w1, w2 = (torch.from_numpy(rng.normal(size=(c, c, 3, 3)).astype(np.float32))
              for _ in range(2))
    gamma = torch.from_numpy(rng.uniform(size=(c, c)).astype(np.float32))
    wk, gk = PC.prepare_conv_gdn(w1, gamma, compute_dtype=BF16)
    assert wk.shape == (9 * c // 8, c, 8) and gk.shape == (c // 8, c, 8)
    assert wk.dtype == gk.dtype == BF16
    for n, ci, a, b in [(0, 0, 0, 0), (3, 5, 1, 2), (15, 9, 2, 1), (7, 15, 2, 2)]:
        k = (a * 3 + b) * c + ci
        assert wk[k // 8, n, k % 8] == w1[n, ci, a, b].to(BF16)
    assert torch.equal(gk.permute(1, 0, 2).reshape(c, c), gamma.to(BF16))
    p1, p2 = PC.prepare_residual_block(w1, w2, compute_dtype=BF16)
    assert torch.equal(p1, wk) and p2.shape == wk.shape
    f1, _ = PC.prepare_residual_block(w1, w2, compute_dtype=torch.float32)
    assert f1.shape == (3, 3, c, c) and f1.dtype == torch.float32


@pytest.mark.parametrize("c,head_dim", [(64, 8), (96, 32), (192, 16)])
def test_bf16_window_block_prepares_kgroups_head_by_head(c, head_dim):
    """The LN+MLP kernel's bf16 weights: wqkv as k-groups with its rows head
    by head (head h's q, k and v rows at 3 h head_dim ...), the q rows
    pre-scaled; wproj, w1 and w2 as k-groups of the torch matrices; the
    vectors fp32 in torch order."""
    _, wts = attn_inputs(47, 1, 8, 8, c)
    rel = np.zeros((c // head_dim, 64, 64), np.float32)
    args = port_attn_args(wts, rel, lambda t: t)
    wqkv, bqkv, wproj = args[0], args[1], args[2]
    w1, w2 = args[7][2], args[7][4]
    prep = PF.prepare_window_block(*args, head_dim=head_dim, compute_dtype=BF16)
    assert len(prep) == 13
    unk = lambda t: t.permute(1, 0, 2).reshape(t.shape[1], -1)  # noqa: E731
    wq = unk(prep[0])
    scale = head_dim ** -0.5
    nh = c // head_dim
    for h, seg, d in [(0, 0, 0), (nh - 1, 1, head_dim - 1), (nh // 2, 2, 1)]:
        row = wqkv[seg * c + h * head_dim + d] * (scale if seg == 0 else 1.0)
        assert torch.equal(wq[(3 * h + seg) * head_dim + d], row.to(BF16))
    assert torch.equal(prep[1], bqkv * torch.cat([torch.full((c,), scale), torch.ones(2 * c)]))
    assert torch.equal(unk(prep[2]), wproj.to(BF16))
    assert torch.equal(unk(prep[9]), w1.to(BF16)) and torch.equal(unk(prep[11]), w2.to(BF16))
    assert prep[11].shape == (4 * c // 8, c, 8)


def test_bf16_windows_a_cta_follow_the_grid():
    """Two windows a CTA (sharing every staged weight tile) at the smallest
    cluster where the grid keeps at least GROUP_CTAS CTAs, else one; two
    never at a larger cluster. On a CPU tensor the forcing entry point runs
    the plain bf16 version."""
    assert PF.window_group(64, 8, 1536, 1) == 2 and PF.window_group(192, 8, 1536, 2) == 2
    assert PF.window_group(64, 32, 96, 1) == 1  # TCM-S's 96 windows: 48 CTAs
    assert PF.window_group(192, 32, 96, 2) == 2  # N=192's 96 windows over clusters of 2
    assert PF.window_group(128, 16, 24, 8) == 1
    for c, hd in sorted(PF.KERNEL_SHAPES_FULL):
        kmin, kmax = PF.min_cluster(c), PF.max_cluster(c, hd)
        assert PF.window_groups(c, kmin) == PF.GROUPS_BF16
        if kmax != kmin:
            assert PF.window_groups(c, kmax) == (1,)
        for windows in (1, 3, 24, 96, 263, 264, 384, 1536, 6144):
            for k in {kmin, kmax}:
                g = PF.window_group(c, hd, windows, k)
                assert g in PF.window_groups(c, k)
                assert g == 1 or -(-windows // 2) * k >= PF.GROUP_CTAS
    c, hd = 64, 16
    x, wts = attn_inputs(48, 1, 16, 24, c)
    rel = np.random.default_rng(49).normal(0, 0.5, (c // hd, 64, 64)).astype(np.float32)
    args = port_attn_args(wts, rel, lambda t: t)
    xc = torch.from_numpy(x)
    got = PF.flash_window_block_at(xc, *args, head_dim=hd, window=8, shifted=True, cluster=1,
                                   group=2)
    want = PF.plain_window_block(xc, *args, head_dim=hd, window=8, shifted=True,
                                 compute_dtype=BF16)
    assert torch.equal(got, want)
