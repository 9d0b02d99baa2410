"""Every width a model hands the port's kernels has a kernel instance.

On the card a kernel wrapper raises for a (C, head_dim) it has no instance
for, so a model width that is missing from an instance set fails only
there. Here, on the CPU, each model the port builds is walked module by
module (no forward at full width): every kernel-routed layer contributes
the (kernel, flavour, C, head_dim) it hands the wrappers, and each must be
in the wrapper's instance set. The walk itself is checked against the
wrappers' actual calls in a small CPU forward.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reslic_tcm_tpu_torch.models.tcm import make_tcm
from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
from reslic_tcm_tpu_torch.ops import flash_window_attn as PF
from reslic_tcm_tpu_torch.ops import fused_conv as PC
from reslic_tcm_tpu_torch.ops import layers as PL
from reslic_tcm_tpu_torch.ops import qkv_attention as PQ
from reslic_tcm_tpu_torch.ops import window_attention as PW
from torch_port_threads import one_torch_thread  # noqa: E402,F401


def routed_shapes(module) -> set:
    """{(kernel, flavour, C, head_dim)} that the module's kernel-routed
    layers hand the wrappers (head_dim None for the convolutions; for B4,
    C and head_dim of its [windows, T, C] input)."""
    out = set()
    for m in module.modules():
        if isinstance(m, PW.SwinTransformerBlock) and m.msa.window_size == PF.KERNEL_WINDOW:
            out.add(("flash_window_block", "ln_mlp", m.msa.dim, m.msa.head_dim))
        elif isinstance(m, PW.WinBasedAttention):
            hd = m.dim // m.num_heads
            if m.window_size % PF.KERNEL_WINDOW == 0:
                out.add(("flash_window_block", "attention", m.dim, hd))
            else:
                out.add(("fused_qkv_attention", m.window_size ** 2, m.dim, hd))
        elif isinstance(m, PL.ResidualBlock):
            out.add(("fused_residual_block", None, m.conv1.out_channels, None))
        elif isinstance(m, PL.ResidualBlockWithStride):
            out.add(("fused_conv_gdn", None, m.conv2.out_channels, None))
        elif isinstance(m, PL.ResidualBlockUpsample):
            out.add(("fused_conv_gdn", None, m.conv.out_channels, None))
    return out


def has_instance(shape) -> bool:
    kernel, flavour, c, hd = shape
    if kernel == "flash_window_block":
        shapes = PF.KERNEL_SHAPES_FULL if flavour == "ln_mlp" else PF.KERNEL_SHAPES_ATTN
        return (c, hd) in shapes
    if kernel == "fused_qkv_attention":
        return (flavour, c, hd) in PQ.KERNEL_SHAPES
    return c in PC.KERNEL_CHANNELS[kernel]


@pytest.mark.parametrize("model,n", [("tcm", 64), ("tcm", 96), ("tcm", 128), ("tcm", 192),
                                     ("wacnn", 128), ("wacnn", 192)])
def test_every_routed_width_has_a_kernel_instance(model, n):
    make = make_tcm if model == "tcm" else make_wacnn
    codec = make(N=n, M=320, device="cpu")
    shapes = routed_shapes(codec.module)
    kernels = {s[0] for s in shapes}
    if model == "tcm":
        assert kernels == {"flash_window_block", "fused_residual_block", "fused_conv_gdn"}
        assert ("fused_conv_gdn", None, 2 * n, None) in shapes
        assert ("flash_window_block", "ln_mlp", 128, 16) in shapes  # SWAtten
    else:
        assert kernels == {"flash_window_block", "fused_qkv_attention"}
    missing = sorted(s for s in shapes if not has_instance(s))
    assert not missing, f"{model} N={n}: no kernel instance for {missing}"


def test_a_missing_width_is_caught():
    """C=80 (TCM N=80) has no instance of any TCM kernel."""
    shapes = routed_shapes(make_tcm(N=80, M=320, device="cpu").module)
    assert {s[0] for s in shapes if not has_instance(s)} == {
        "flash_window_block", "fused_residual_block", "fused_conv_gdn"}


def _record_calls(monkeypatch):
    """Wrap the wrappers where the layers call them; returns the list of
    (kernel, flavour, C, head_dim) of every call."""
    calls = []

    def wrap(mod, name, shape_of):
        orig = getattr(mod, name)

        def recorded(*args, **kwargs):
            calls.append(shape_of(*args, **kwargs))
            return orig(*args, **kwargs)

        monkeypatch.setattr(mod, name, recorded)

    wrap(PW, "flash_window_block", lambda x, *a, head_dim, with_ln=True, **k: (
        "flash_window_block", "ln_mlp" if with_ln else "attention", x.shape[-1], head_dim))
    wrap(PW, "fused_qkv_attention", lambda w, *a, **k: (
        "fused_qkv_attention", w.shape[1], w.shape[2], w.shape[2] // a[2].shape[0]))
    wrap(PL, "fused_residual_block", lambda x, *a, **k: (
        "fused_residual_block", None, x.shape[-1], None))
    wrap(PL, "fused_conv_gdn", lambda x, *a, **k: ("fused_conv_gdn", None, x.shape[-1], None))
    return calls


@pytest.mark.parametrize("model", ["tcm", "wacnn"])
def test_module_walk_matches_the_wrappers_calls(monkeypatch, model):
    """A small CPU forward calls the wrappers with exactly the shapes the
    walk finds."""
    if model == "tcm":
        codec = make_tcm(N=32, M=80, hyper_ch=24, atten_inter_dim=32, device="cpu")
    else:
        codec = make_wacnn(N=32, M=40, device="cpu", seed=2, hyper_dims=(40, 36, 32),
                           mean_dims=(32, 36, 40, 44), cc_dims=(36, 28, 20, 12))
    calls = _record_calls(monkeypatch)
    img = np.random.default_rng(0).uniform(size=(1, 128, 128, 3)).astype(np.float32)
    with torch.no_grad():
        codec.forward(img)
    assert set(calls) == routed_shapes(codec.module)


@pytest.mark.parametrize("shape,head_dim,want", [
    ((1, 48, 32, 128), 16, 8),    # SWAtten at 768x512: 24 windows
    ((2, 24, 32, 64), 16, 4),     # 24 windows x batch, 4 heads
    ((1, 24, 16, 64), 32, 2),     # 6 windows, 2 heads
    ((1, 48, 32, 96), 32, 1),     # 3 heads: no even split
    ((1, 32, 64, 128), 16, 1),    # 32 windows: one CTA each
    ((1, 64, 48, 128), 16, 1),    # 48 windows
    ((1, 64, 64, 128), 16, 1),    # 64 windows
    ((1, 96, 64, 64), 32, 1),     # 96 windows (TCM-S g_a stage 2)
    ((1, 384, 256, 64), 8, 1),    # 1536 windows
    ((1, 384, 256, 192), 8, 2),   # TCM N=192 at 768x512: one CTA per window does not fit
    ((1, 192, 128, 192), 16, 2),  # 384 windows
    ((1, 96, 64, 192), 32, 2),    # 96 windows, 6 heads
    ((2, 128, 128, 192), 8, 2),   # 512 windows x batch
    ((1, 32, 32, 192), 8, 2),     # 16 windows x 8 CTAs: too many for the largest split
    ((1, 32, 32, 192), 16, 4),    # 16 windows x 4 CTAs: the largest split
    ((1, 32, 32, 192), 32, 2),
    ((1, 16, 16, 192), 8, 8),     # 4 windows
    ((2, 32, 32, 192), 16, 2),    # 16 windows x batch 2
])
def test_cluster_split_is_chosen_from_the_shape(shape, head_dim, want):
    b, h, w, c = shape
    assert PF.cluster_size(c, head_dim, b * (h // 8) * (w // 8)) == want
    assert want in (PF.min_cluster(c), PF.max_cluster(c, head_dim))
    if c == 192:  # its window needs two CTAs' shared memory at every window count
        assert all(PF.cluster_size(c, head_dim, n) >= 2 for n in range(1, 6145))
    else:
        assert PF.min_cluster(c) == 1


def _conv_kernel_cases():
    import chip_smoke

    return [(k, s) for k, s, _, _ in chip_smoke.KERNEL_CASES
            if k in ("fused_residual_block", "fused_conv_gdn")]


@pytest.mark.parametrize("model,n", [("tcm", 64), ("tcm", 96), ("tcm", 128), ("tcm", 192)])
def test_conv_tile_choice_has_an_instance_at_every_shape(model, n):
    """B2/B3's tile comes from (H, W, C) alone and names an instance that
    takes C, at every B2/B3 shape of chip_smoke's KERNEL_CASES and at each
    of their H x W for every width this model hands the wrappers."""
    import inspect

    assert list(inspect.signature(PC.tile_config).parameters) == ["h", "w", "c"]
    shapes = routed_shapes(make_tcm(N=n, M=320, device="cpu").module)
    widths = {c for kernel, _, c, _ in shapes if kernel in PC.KERNEL_CHANNELS}
    cases = _conv_kernel_cases()
    hws = {(s[1], s[2]) for _, s in cases}
    for (h, w), c in [((s[1], s[2]), s[3]) for _, s in cases] + [
            (hw, c) for hw in hws for c in widths]:
        tile = PC.tile_config(h, w, c)
        assert tile in PC.TILES
        bm, bn = PC.tile_shape(tile, c)
        assert c % bn == 0 and bm % 32 == 0, (h, w, c, tile)
        assert PC.tile_config(h, w, c) == tile
    # on the main path: the large tile at the two largest stages (and at
    # 96x64 for C=192 and 384, whose three column blocks make 144 blocks),
    # the small one where the large would leave SMs idle
    for _, (_, h, w, c) in cases:
        large = h * w >= 192 * 128 or (h * w >= 96 * 64 and c in (192, 384))
        assert PC.tile_config(h, w, c) == ("large" if large else "small"), (h, w, c)


@pytest.mark.parametrize("model,n", [("wacnn", 128), ("wacnn", 192)])
def test_attention_split_choice_has_an_instance_at_every_shape(model, n):
    """B1's attention-only cluster and B4's (windows per CTA, CTAs per
    cluster) come from their arguments alone and name an instance, at every
    attention shape of chip_smoke's KERNEL_CASES and, for every width this
    model hands the wrappers, at window counts from 1 to 6144."""
    import inspect

    import chip_smoke

    assert list(inspect.signature(PF.attn_cluster_size).parameters) == [
        "c", "head_dim", "windows"]
    assert list(inspect.signature(PQ.group_config).parameters) == [
        "windows", "t", "c", "head_dim"]
    counts = (1, 2, 3, 7, 16, 24, 34, 48, 64, 96, 97, 192, 384, 1536, 6144)
    checked = 0
    for kernel, flavour, c, hd in routed_shapes(make_wacnn(N=n, M=320, device="cpu").module):
        for windows in counts:
            if kernel == "flash_window_block":
                k = PF.attn_cluster_size(c, hd, windows)
                assert k in PF.ATTN_CLUSTERS and (c // hd) % k == 0
                assert PF.attn_cluster_size(c, hd, windows) == k
            else:
                split = PQ.group_config(windows, flavour, c, hd)
                assert split in PQ.GROUPS
                assert PQ.group_config(windows, flavour, c, hd) == split
            checked += 1
    assert checked == 2 * len(counts)
    for kernel, shape, option, _ in chip_smoke.KERNEL_CASES:
        if kernel == "fused_qkv_attention":
            nw, t, c = shape
            assert PQ.group_config(nw, t, c, c // option[0]) in PQ.GROUPS
        elif kernel == "flash_window_block" and not option[2]:
            b, h, w, c = shape
            assert (c, option[0]) in PF.KERNEL_SHAPES_ATTN
            assert PF.attn_cluster_size(c, option[0], b * (h // 8) * (w // 8)) in PF.ATTN_CLUSTERS


@pytest.mark.parametrize("model,n", [("wacnn", 128), ("wacnn", 192)])
def test_bf16_attention_choice_has_an_instance_at_every_shape(model, n):
    """The bf16 attention-only kernel (csrc/window_attn_bf16.cu): its cluster
    comes from the shape alone and names an instance the source builds
    (ATTN_BF16_INSTANCES, parsed here), at every width this model hands the
    wrapper and at window counts from 1 to 6144; ATTN_CLUSTERS_BF16 lists
    exactly the source's instances."""
    import inspect
    import os
    import re

    from reslic_tcm_tpu_torch.ops import build

    assert list(inspect.signature(PF.attn_cluster_size_bf16).parameters) == [
        "c", "head_dim", "windows"]
    with open(os.path.join(build._PKG, build.SOURCES["window_attn_bf16"][0])) as f:
        src = f.read()
    macro = re.search(r"#define ATTN_BF16_INSTANCES\(X\) \\\n(.*)\n", src).group(1)
    instances = {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", macro)}
    assert instances == {(c, hd, k) for (c, hd) in PF.KERNEL_SHAPES_ATTN
                         for k in PF.ATTN_CLUSTERS_BF16[c]}
    shapes = [(c, hd) for kernel, flavour, c, hd in
              routed_shapes(make_wacnn(N=n, M=320, device="cpu").module)
              if kernel == "flash_window_block"]
    assert len(shapes) == 1
    for c, hd in shapes:
        for windows in (1, 2, 3, 7, 16, 24, 31, 32, 34, 48, 64, 96, 97, 192, 384, 1536, 6144):
            k = PF.attn_cluster_size_bf16(c, hd, windows)
            assert (c, hd, k) in instances and (c // hd) % k == 0
