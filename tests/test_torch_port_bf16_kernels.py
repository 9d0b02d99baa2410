"""Port parity of the kernels' bf16 mode, on the CPU: the plain bf16
versions of B1 (LN+MLP flavour), B2 and B3 (what the wrappers run on a CPU
tensor with ``compute_dtype=torch.bfloat16``) against the JAX package's
Pallas kernels run with ``compute_dtype=jnp.bfloat16, interpret=True`` on
the same seeded numpy inputs. B1 runs the Pallas kernel's block-diagonal
layout (``layout="bd"``), whose casts the port follows (the probabilities
rounded after the softmax's division); the head-packed layout rounds the
unnormalised exponentials instead, a TPU-only arrangement.

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


def test_attention_only_flavour_has_no_bf16_instance():
    """WACNN's attention-only B1 flavour is ROADMAP A15b: its weights cannot
    be prepared in bf16, and WinBasedAttention's kernel path raises under
    bf16 on either device."""
    from reslic_tcm_tpu_torch.ops.layers import matmul_precision
    from reslic_tcm_tpu_torch.ops.window_attention import WinBasedAttention

    c, hd = 48, 24
    _, wts = attn_inputs(43, 1, 16, 16, c)
    rel = np.zeros((c // hd, 64, 64), np.float32)
    wqkv, bqkv, wproj, bproj, *_ = port_attn_args(wts, rel, lambda t: t)
    with pytest.raises(ValueError, match="A15b"):
        PF.prepare_window_block(wqkv, bqkv, wproj, bproj, None, None, torch.from_numpy(rel),
                                None, head_dim=hd, compute_dtype=BF16)
    m = WinBasedAttention(c, num_heads=2, window_size=8).eval()
    with torch.no_grad(), matmul_precision("bfloat16"), pytest.raises(NotImplementedError,
                                                                      match="A15b"):
        m(torch.zeros(1, 16, 16, c))
