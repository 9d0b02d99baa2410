"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
CUDA device). No JAX here: the card's machine has none, so run

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest`` skips tests/conftest.py, which imports JAX).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, with TF32 off, at every width of TCM N=64/96/128/192 and WACNN
N=128/192, at shapes of their main paths and at ragged ones.
Tolerance 1e-4 * max(1, max |plain|): the kernels sum in another fixed
order than cuDNN/cuBLAS, over up to 9*384 = 3456 terms per output. The
device coder's lane kernels D1-D4 (csrc/device_rans.cu) must equal their
plain versions bit for bit.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_inputs import (attn_inputs, coder_symbols, coder_tables,  # noqa: E402
                               conv_inputs, err_ok, gaussian_inputs, oihw, port_attn_args,
                               qkv_inputs, scale_symbols, scale_tables)

from reslic_tcm_tpu_torch.coding import device_kernels as PDK  # noqa: E402
from reslic_tcm_tpu_torch.ops import flash_window_attn as PF  # noqa: E402
from reslic_tcm_tpu_torch.ops import fused_conv as PC  # noqa: E402
from reslic_tcm_tpu_torch.ops import qkv_attention as PQ  # noqa: E402
from torch_port_threads import one_torch_thread  # noqa: E402,F401

TOL_CARD = 1e-4
# the whole forward compounds the per-layer differences over some 60 layers
TOL_SLICE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (an H100 for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim,hw", [(64, 8, (24, 16)), (64, 16, (16, 32)),
                                           (64, 32, (8, 8)), (128, 16, (48, 32)),
                                           (96, 8, (16, 24)), (96, 16, (24, 16)),
                                           (96, 32, (8, 16)), (128, 8, (16, 16)),
                                           (128, 32, (24, 8)), (64, 8, (256, 128))])
def test_b1_kernel_matches_plain_on_card(cuda, shifted, c, head_dim, hw):
    x, wts = attn_inputs(30 + head_dim, 2, *hw, c)
    rel = np.random.default_rng(31).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    args = port_attn_args(wts, rel, lambda t: t.to(cuda))
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, head_dim=head_dim, window=8, shifted=shifted)
        before = PF.flash_window_block.launches
        got = PF.flash_window_block(xc, *args, head_dim=head_dim, window=8, shifted=shifted)
        torch.cuda.synchronize()
    assert PF.flash_window_block.launches == before + 1
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("hw", [(16, 24), (8, 8)])
def test_b1_attention_only_kernel_matches_plain_on_card(cuda, shifted, hw):
    """The with_ln=False, mlp=None flavour at WACNN's C=192, head_dim 24."""
    c, head_dim = 192, 24
    x, wts = attn_inputs(32, 2, *hw, c)
    rel = np.random.default_rng(33).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    wqkv, bqkv, wproj, bproj, _, _, relc, _ = port_attn_args(wts, rel, lambda t: t.to(cuda))
    args = (wqkv, bqkv, wproj, bproj, None, None, relc, None)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, with_ln=False)
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        before = PF.flash_window_block.launches
        got = PF.flash_window_block(xc, *args, **kw)
        torch.cuda.synchronize()
    assert PF.flash_window_block.launches == before + 1
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim", [(c, hd) for c in (64, 96, 128) for hd in (8, 16, 32)])
def test_b1_kernel_is_bit_identical_across_cluster_sizes(cuda, shifted, c, head_dim):
    """Every LN+MLP instance: one CTA per window and the largest cluster
    give the same bits, and both agree with the plain version."""
    x, wts = attn_inputs(c + head_dim, 2, 16, 24, c)
    rel = np.random.default_rng(c).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    args = port_attn_args(wts, rel, lambda t: t.to(cuda))
    xc = torch.from_numpy(x).to(cuda)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted)
    km = PF.max_cluster(c, head_dim)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        one = PF.flash_window_block(xc, *args, **kw, cluster=1)
        split = PF.flash_window_block(xc, *args, **kw, cluster=km)
        torch.cuda.synchronize()
        with pytest.raises(ValueError):  # a cluster with no instance
            PF.flash_window_block(xc, *args, **kw, cluster=3)
    assert torch.equal(one, split)
    err_ok(one.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("head_dim,hw", [(8, (16, 16)), (8, (32, 32)), (16, (16, 24)),
                                         (32, (8, 16)), (8, (64, 64))])
def test_b1_kernel_at_192_channels_matches_plain_for_every_cluster(cuda, shifted, head_dim,
                                                                   hw):
    """TCM N=192's LN+MLP instances: every cluster the kernel has at C=192
    (2 and the largest: one CTA per window does not fit) gives the same
    bits, agrees with the plain version, and the wrapper's own choice
    launches the kernel; cluster 1 has no instance and raises."""
    c = 192
    x, wts = attn_inputs(c + head_dim, 2, *hw, c)
    rel = np.random.default_rng(c + 1).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    args = port_attn_args(wts, rel, lambda t: t.to(cuda))
    xc = torch.from_numpy(x).to(cuda)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted)
    ks = sorted({PF.min_cluster(c), PF.max_cluster(c, head_dim)})
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        before = PF.flash_window_block.launches
        chosen = PF.flash_window_block(xc, *args, **kw)
        outs = [PF.flash_window_block(xc, *args, **kw, cluster=k) for k in ks]
        torch.cuda.synchronize()
        assert PF.flash_window_block.launches == before + 1 + len(ks)
        with pytest.raises(ValueError):  # one CTA per window: no instance at C=192
            PF.flash_window_block(xc, *args, **kw, cluster=1)
    assert all(torch.equal(chosen, o) for o in outs)
    err_ok(chosen.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
def test_b1_attention_only_kernel_at_128_channels_matches_plain_on_card(cuda, shifted):
    """The with_ln=False, mlp=None flavour at WACNN N=128's C=128, head_dim 16."""
    c, head_dim = 128, 16
    x, wts = attn_inputs(37, 2, 16, 24, c)
    rel = np.random.default_rng(38).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    wqkv, bqkv, wproj, bproj, _, _, relc, _ = port_attn_args(wts, rel, lambda t: t.to(cuda))
    args = (wqkv, bqkv, wproj, bproj, None, None, relc, None)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, with_ln=False)
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        got = PF.flash_window_block(xc, *args, **kw)
        torch.cuda.synchronize()
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


def attn_options(c, windows, compute_dtype):
    """{option: the wrapper's keywords} over every option the attention-only
    wrapper can force: the fp32 kernel's clusters; the bf16 kernel's clusters,
    each at its default persistent grid, at every window a cluster (grid =
    windows), at a grid that leaves some clusters one window short (windows //
    2 + 1; windows // 3 + 1), and at one cluster."""
    if compute_dtype != torch.bfloat16:
        return {str(k): dict(cluster=k) for k in PF.ATTN_CLUSTERS}
    grids = (None, windows, windows // 2 + 1, windows // 3 + 1, 1)
    return {f"{k}x{g}": dict(cluster=k, grid=g)
            for k in PF.ATTN_CLUSTERS_BF16[c] for g in dict.fromkeys(grids)}


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(16, 24), (16, 16), (32, 32), (192, 128)])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim", sorted(PF.KERNEL_SHAPES_ATTN))
def test_b1_attention_only_bits_do_not_depend_on_the_cluster(cuda, shifted, c, head_dim, hw,
                                                             compute_dtype):
    """Every option the attention-only wrapper can force (attn_options: the
    cluster; in bf16 also the persistent grid, some clusters a window short),
    on the same input at batch 2 (6, 4, 16 and 384 windows an image), gives
    the bits of the wrapper's choice, and they agree with the plain version;
    a cluster or grid with no instance raises."""
    x, wts = attn_inputs(c + 2 * head_dim, 2, *hw, c)
    rel = np.random.default_rng(c + 1).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    wqkv, bqkv, wproj, bproj, _, _, relc, _ = port_attn_args(wts, rel, lambda t: t.to(cuda))
    args = (wqkv, bqkv, wproj, bproj, None, None, relc, None)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, with_ln=False,
              compute_dtype=compute_dtype)
    windows = 2 * (hw[0] // 8) * (hw[1] // 8)
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        chosen = PF.flash_window_block(xc, *args, **kw)
        outs = {n: PF.flash_window_block(xc, *args, **kw, **force)
                for n, force in attn_options(c, windows, compute_dtype).items()}
        torch.cuda.synchronize()
        with pytest.raises(ValueError):  # a cluster with no instance
            PF.flash_window_block(xc, *args, **kw, cluster=3)
        for grid in (0, windows + 1):  # a grid out of range (fp32: no grid at all)
            with pytest.raises(ValueError):
                PF.flash_window_block(xc, *args, **kw, grid=grid)
    for n, out in outs.items():
        assert torch.equal(out, chosen), n
    err_ok(chosen.cpu().numpy(), want.cpu().numpy(),
           TOL_BF16 if compute_dtype == torch.bfloat16 else TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,n_mask", [(96, 96), (96, 0), (34, 2), (7, 0), (1, 1)])
def test_b4_bits_do_not_depend_on_the_split(cuda, nw, n_mask):
    """Every (windows per CTA, CTAs per cluster), forced on the same input,
    gives the bits of the wrapper's choice, at WACNN's 96 windows with and
    without a mask and at window counts that leave a ragged last group."""
    windows, wqkv, bqkv, rel, wproj, bproj, mask = qkv_inputs(36 + nw, nw, 16, 320, 8,
                                                              max(n_mask, 1))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = (t(windows), t(wqkv.T), t(bqkv), t(rel), t(wproj.T), t(bproj),
            t(mask) if n_mask else None)
    with torch.no_grad():
        want = PQ.plain_qkv_attention(*args)
        chosen = PQ.fused_qkv_attention(*args)
        outs = {s: PQ.fused_qkv_attention(*args, split=s) for s in PQ.GROUPS}
        torch.cuda.synchronize()
        with pytest.raises(ValueError):  # a split with no instance
            PQ.fused_qkv_attention(*args, split=(3, 8))
    for split, out in outs.items():
        assert torch.equal(out, chosen), split
    err_ok(chosen.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,n_mask", [(20, 4), (7, 0), (96, 96), (34, 2)])
def test_b4_kernel_matches_plain_on_card(cuda, nw, n_mask):
    """WACNN's window-4 attention at C=320, 8 heads (head_dim 40): with an
    image's mask shared by 5 images, without a mask, with one mask per
    window, and with 34 windows (a ragged last group) under a 2-window
    mask."""
    windows, wqkv, bqkv, rel, wproj, bproj, mask = qkv_inputs(34, nw, 16, 320, 8,
                                                              max(n_mask, 1))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = (t(windows), t(wqkv.T), t(bqkv), t(rel), t(wproj.T), t(bproj),
            t(mask) if n_mask else None)
    with torch.no_grad():
        want = PQ.plain_qkv_attention(*args)
        before = PQ.fused_qkv_attention.launches
        got = PQ.fused_qkv_attention(*args)
        torch.cuda.synchronize()
    assert PQ.fused_qkv_attention.launches == before + 1
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
def test_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    windows, wqkv, bqkv, rel, wproj, bproj, mask = qkv_inputs(35, 8, 16, 320, 8, 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = [t(windows), t(wqkv.T), t(bqkv), t(rel), t(wproj.T), t(bproj)]
    with torch.no_grad():
        with pytest.raises(ValueError):  # 3 mask windows do not divide 8
            PQ.fused_qkv_attention(*args, t(mask))
        with pytest.raises(ValueError):  # 4 heads: head_dim 80 has no instance
            PQ.fused_qkv_attention(*args[:3], t(rel[:4]), *args[4:])
        x, wts = attn_inputs(36, 1, 8, 8, 80)
        a = port_attn_args(wts, rel[:1].repeat(5, 0), lambda u: u.to(cuda))
        with pytest.raises(ValueError):  # C = 80 has no attention-only instance
            PF.flash_window_block(t(x), *a[:4], None, None, t(np.zeros((5, 64, 64), np.float32)),
                                  None, head_dim=16, window=8, shifted=False, with_ln=False)
        with pytest.raises(ValueError):  # nor an LN+MLP instance
            PF.flash_window_block(t(x), *a[:6], t(np.zeros((5, 64, 64), np.float32)), a[7],
                                  head_dim=16, window=8, shifted=False)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw", [(64, (96, 64)), (64, (13, 10)), (128, (24, 16)),
                                  (128, (7, 9)), (96, (24, 16)), (96, (13, 10)),
                                  (64, (24, 16)), (192, (24, 16)), (192, (96, 64)),
                                  (192, (13, 10))])
def test_b2_kernel_matches_plain_on_card(cuda, c, hw):
    x, w1, b1, w2, b2, *_ = conv_inputs(40, 2, *hw, c)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (t(x), oihw(w1).to(cuda), t(b1), oihw(w2).to(cuda), t(b2))
    with torch.no_grad():
        want = PC.plain_residual_block(*args)
        before = PC.fused_residual_block.launches
        got = PC.fused_residual_block(*args)
        torch.cuda.synchronize()
    assert PC.fused_residual_block.launches == before + 1
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c,hw", [(128, (96, 64)), (128, (11, 9)), (64, (16, 24)),
                                  (192, (24, 16)), (192, (11, 9)), (256, (16, 24)),
                                  (256, (13, 10)), (128, (24, 16)), (256, (24, 16)),
                                  (384, (24, 16)), (384, (96, 64)), (384, (11, 9))])
def test_b3_kernel_matches_plain_on_card(cuda, inverse, c, hw):
    x, w, b, _, _, gamma, beta, skip = conv_inputs(50, 1, *hw, c)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    args = (t(x), oihw(w).to(cuda), t(b), t(gamma), t(beta), t(skip))
    with torch.no_grad():
        want = PC.plain_conv_gdn(*args, inverse=inverse)
        before = PC.fused_conv_gdn.launches
        got = PC.fused_conv_gdn(*args, inverse=inverse)
        torch.cuda.synchronize()
    assert PC.fused_conv_gdn.launches == before + 1
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,c", [("b2", 64), ("b2", 96), ("b2", 128), ("b2", 192),
                                      ("b3", 64), ("b3", 128), ("b3", 192), ("b3", 256),
                                      ("b3", 384)])
def test_b2_b3_bits_do_not_depend_on_the_tile(cuda, kernel, c):
    """Each tile instance, forced on the same ragged input, gives the same
    bits (one fmaf chain per output over ascending k, whatever the tile),
    and both agree with the plain version."""
    x, w1, b1, w2, b2, gamma, beta, skip = conv_inputs(70 + c, 1, 37, 45, c)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    with torch.no_grad():
        if kernel == "b2":
            args = (t(x), oihw(w1).to(cuda), t(b1), oihw(w2).to(cuda), t(b2))
            want = PC.plain_residual_block(*args)
            outs = [PC.fused_residual_block(*args, tile=tile) for tile in PC.TILES]
        else:
            args = (t(x), oihw(w1).to(cuda), t(b1), t(gamma), t(beta), t(skip))
            want = PC.plain_conv_gdn(*args, inverse=c % 128 == 0)
            outs = [PC.fused_conv_gdn(*args, inverse=c % 128 == 0, tile=tile)
                    for tile in PC.TILES]
        torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    err_ok(outs[0].cpu().numpy(), want.cpu().numpy(), TOL_CARD)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, w1, b1, w2, b2, gamma, beta, skip = conv_inputs(60, 1, 8, 8, 64)
    x80, w80, b80, _, _, g80, beta80, skip80 = conv_inputs(61, 1, 8, 8, 80)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    w1c, w2c = oihw(w1).to(cuda), oihw(w2).to(cuda)
    with torch.no_grad():
        with pytest.raises(ValueError):  # not contiguous NHWC
            PC.fused_residual_block(t(x).permute(0, 2, 1, 3), w1c, t(b1), w2c, t(b2))
        with pytest.raises(ValueError):  # float64
            PC.fused_residual_block(t(x).double(), w1c, t(b1), w2c, t(b2))
        w80c = oihw(w80).to(cuda)
        with pytest.raises(ValueError):  # C = 80 has no kernel
            PC.fused_residual_block(t(x80), w80c, t(b80), w80c, t(b80))
        with pytest.raises(ValueError):  # nor a conv+GDN instance
            PC.fused_conv_gdn(t(x80), w80c, t(b80), t(g80), t(beta80), t(skip80), inverse=False)
        with pytest.raises(ValueError):  # no such tile instance
            PC.fused_residual_block(t(x), w1c, t(b1), w2c, t(b2), tile="huge")
        with pytest.raises(ValueError):  # B2 has no C = 256 instance (only B3 has)
            x256, w256, b256, *_ = conv_inputs(62, 1, 8, 8, 256)
            w256c = oihw(w256).to(cuda)
            PC.fused_residual_block(t(x256), w256c, t(b256), w256c, t(b256))
    with pytest.raises(RuntimeError):  # a gradient is wanted: inference-only kernels
        PC.fused_residual_block(t(x), w1c.requires_grad_(), t(b1), w2c, t(b2))


@pytest.mark.cuda
def test_tcm_codec_on_card_matches_cpu_and_decodes_exactly(cuda):
    """TCM-S widths (N=64) with seeded random weights on a 256x256 image:
    the card's forward agrees with the CPU's plain path, compress ->
    decompress reproduces y_hat exactly, and each pass launches the
    documented number of kernels."""
    from reslic_tcm_tpu_torch.cli.eval import launch_counts
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    img = synth_image(np.random.default_rng(0), 256, 256)[None]
    gpu = make_tcm(N=64, M=320, device=cuda, seed=1)
    cpu = make_tcm(N=64, M=320, device="cpu", seed=1)
    before = launch_counts()
    out = gpu.forward(img)
    assert {k: v - before[k] for k, v in launch_counts().items()} == {
        "flash_window_block": 32, "fused_residual_block": 18, "fused_conv_gdn": 9,
        "fused_qkv_attention": 0}
    ref = cpu.forward(img)
    err_ok(out["x_hat"].cpu().numpy(), ref["x_hat"].numpy(), TOL_SLICE)
    gpu.update()
    enc = gpu.compress(img)
    dec = gpu.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])


@pytest.mark.cuda
def test_wacnn_codec_on_card_matches_cpu_and_decodes_exactly(cuda):
    """WACNN at full width (N=192, M=320) with seeded random weights on a
    256x256 image: the card's forward agrees with the CPU's plain path,
    compress -> decompress reproduces y_hat exactly, the decoded x_hat is
    the forward's, and each pass launches B1 and B4 as documented."""
    from reslic_tcm_tpu_torch.cli.eval import launch_counts
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.wacnn import make_wacnn

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    img = synth_image(np.random.default_rng(0), 256, 256)[None]
    gpu = make_wacnn(device=cuda, seed=1)
    cpu = make_wacnn(device="cpu", seed=1)
    before = launch_counts()
    out = gpu.forward(img)
    assert {k: v - before[k] for k, v in launch_counts().items()} == {
        "flash_window_block": 2, "fused_residual_block": 0, "fused_conv_gdn": 0,
        "fused_qkv_attention": 2}
    ref = cpu.forward(img)
    err_ok(out["x_hat"].cpu().numpy(), ref["x_hat"].numpy(), TOL_SLICE)
    gpu.update()
    before = launch_counts()
    enc = gpu.compress(img)
    dec = gpu.decompress(enc["strings"], enc["shape"])
    assert {k: v - before[k] for k, v in launch_counts().items()}["fused_qkv_attention"] == 2
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    np.testing.assert_allclose(dec["x_hat"].cpu().numpy(),
                               np.clip(out["x_hat"].cpu().numpy(), 0, 1), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("model,n", [("tcm", 96), ("tcm", 128), ("tcm", 192), ("wacnn", 128)])
def test_wider_codecs_on_card_match_cpu_and_decode_exactly(cuda, model, n):
    """TCM N=96, 128 and 192 and WACNN N=128 (M=320) with seeded random
    weights on a 256x256 image: every kernel-routed layer runs on the card
    (no width without an instance), the forward agrees with the CPU's plain
    path, and compress -> decompress reproduces y_hat exactly."""
    from reslic_tcm_tpu_torch.cli.eval import launch_counts
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.models.wacnn import make_wacnn

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    make = make_tcm if model == "tcm" else make_wacnn
    img = synth_image(np.random.default_rng(0), 256, 256)[None]
    gpu = make(N=n, M=320, device=cuda, seed=1)
    cpu = make(N=n, M=320, device="cpu", seed=1)
    before = launch_counts()
    out = gpu.forward(img)
    want = ({"flash_window_block": 32, "fused_residual_block": 18, "fused_conv_gdn": 9,
             "fused_qkv_attention": 0} if model == "tcm" else
            {"flash_window_block": 2, "fused_residual_block": 0, "fused_conv_gdn": 0,
             "fused_qkv_attention": 2})
    assert {k: v - before[k] for k, v in launch_counts().items()} == want
    ref = cpu.forward(img)
    err_ok(out["x_hat"].cpu().numpy(), ref["x_hat"].numpy(), TOL_SLICE)
    gpu.update()
    enc = gpu.compress(img)
    dec = gpu.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])


_STANH_LEVELS = [{"beta": 10, "num_sigmoids": 16, "annealing": "gap_stoc", "symmetry": False,
                  "gap_factor": 25, "extrema": e, "trainable": True, "removing_mean": False}
                 for e in (32, 16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("model,n", [("wacnn_stanh", 192), ("tcm_stanh", 64)])
def test_stanh_codecs_on_card_roundtrip_every_level(cuda, model, n):
    """WACNN-STanH (N=192) and TCM-STanH (N=64), M=320, three levels
    (extrema 32/16/8, 16 steps, the committed snapshot's layout) with
    seeded random weights on a 256x256 image: at each level the forward
    agrees with the CPU's plain path and launches the kernels as WACNN's
    and TCM's do, compress -> decompress reproduces y_hat exactly (and
    forward_codec_consistent's)."""
    from reslic_tcm_tpu_torch.cli.eval import launch_counts
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.stanh.variants import make_tcm_stanh, make_wacnn_stanh

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    make = make_wacnn_stanh if model == "wacnn_stanh" else make_tcm_stanh
    img = synth_image(np.random.default_rng(0), 256, 256)[None]
    gpu = make(_STANH_LEVELS, N=n, M=320, device=cuda, seed=1)
    cpu = make(_STANH_LEVELS, N=n, M=320, device="cpu", seed=1)
    forward, coding = (({"flash_window_block": 2, "fused_residual_block": 0,
                         "fused_conv_gdn": 0, "fused_qkv_attention": 2},
                        {"flash_window_block": 2, "fused_residual_block": 0,
                         "fused_conv_gdn": 0, "fused_qkv_attention": 2})
                       if model == "wacnn_stanh" else
                       ({"flash_window_block": 32, "fused_residual_block": 18,
                         "fused_conv_gdn": 9, "fused_qkv_attention": 0},
                        {"flash_window_block": 52, "fused_residual_block": 22,
                         "fused_conv_gdn": 11, "fused_qkv_attention": 0}))
    gpu.update()
    for lv in range(3):
        before = launch_counts()
        out = gpu.forward(img, lv=lv)
        assert {k: v - before[k] for k, v in launch_counts().items()} == forward
        err_ok(out["x_hat"].cpu().numpy(), cpu.forward(img, lv=lv)["x_hat"].numpy(), TOL_SLICE)
        before = launch_counts()
        enc = gpu.compress(img, lv=lv)
        dec = gpu.decompress(enc["strings"], enc["shape"], lv=lv)
        assert {k: v - before[k] for k, v in launch_counts().items()} == coding
        assert torch.equal(enc["y_hat"], dec["y_hat"])
        assert torch.equal(gpu.forward_codec_consistent(img, lv=lv)["y_hat"], dec["y_hat"])


@pytest.mark.cuda
def test_stream_encoded_with_tf32_on_decodes_exactly_with_it_off(cuda):
    """The codec pins fp32 in its passes: a caller's TF32 setting at encode
    time cannot move the mu and scale indexes the decoder computes. The
    encoder's unpinned body under TF32 gives another y_hat on this input,
    so the pin is what the exact decode rests on."""
    import inspect

    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.base import ChannelARCodec
    from reslic_tcm_tpu_torch.models.tcm import make_tcm

    img = synth_image(np.random.default_rng(3), 256, 256)[None]
    codec = make_tcm(N=64, M=320, device=cuda, seed=2)
    codec.update()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    enc = codec.compress(img)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad():  # the encoder's device stage without its fp32 pin
        y_hat_tf32 = inspect.unwrap(ChannelARCodec._encode_device_stage)(codec, img)["y_hat"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(enc["y_hat"], dec["y_hat"])
    assert not torch.equal(y_hat_tf32, dec["y_hat"])


@pytest.mark.cuda
def test_gain_codecs_on_card_roundtrip(cuda):
    """The trained gained scale hyperprior (checkpoints/scale_gain_vr_r5.npz)
    at levels 0-2 and (s=0, l=0.5), the registry's wacnn_gain (N=192,
    spread 2, random weights scaled so that y codes) at both levels and
    scale_gain_sc at (s=0, l=0.5) on a 256x256 image: every compress ->
    decompress reproduces y_hat exactly and gives the card's forward's
    clipped x_hat within 1e-5, and wacnn_gain launches B1 and B4 as WACNN
    does. (The card against the CPU: chip_smoke.py, which counts the
    latents that round the other way.)"""
    from reslic_tcm_tpu_torch.cli.eval import launch_counts
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models import get_model
    from reslic_tcm_tpu_torch.models.gain.gained import make_gained_hyperprior
    from reslic_tcm_tpu_torch.utils.parser import parse_args
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    img = synth_image(np.random.default_rng(0), 256, 256)[None]

    def roundtrip(codec, *rate):
        enc = codec.compress(img, *rate)
        dec = codec.decompress(enc["strings"], enc["shape"], *rate)
        assert torch.equal(enc["y_hat"], dec["y_hat"])
        return dec["x_hat"]

    gain = make_gained_hyperprior("scale", N=192, M=320, lmbda_list=(0.0025, 0.013, 0.05),
                                  device=cuda)
    assert load_snapshot_into(gain.module, GAIN_SNAPSHOT) == []
    gain.update()
    for s, l in ((0, 0.0), (1, 0.0), (2, 0.0), (0, 0.5)):
        err_ok(roundtrip(gain, s, l).cpu().numpy(),
               gain.forward(img, s, l)["x_hat"].clamp(0, 1).cpu().numpy(), 1e-5)

    args = parse_args(["-m", "wacnn_gain", "--N", "192", "--M", "320", "--gain_init_spread",
                       "2", "--lambda_list", "0.0025", "0.05"])
    wacnn = get_model(args, device=cuda)[0]
    m = wacnn.module
    with torch.no_grad():
        for layer, f in [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms]:
            layer.weight.mul_(f)
            layer.bias.mul_(f)
    wacnn.update()
    b1_b4 = {"flash_window_block": 2, "fused_residual_block": 0, "fused_conv_gdn": 0,
             "fused_qkv_attention": 2}
    for lv in range(2):
        before = launch_counts()
        out = wacnn.forward(img, lv=lv)
        assert {k: v - before[k] for k, v in launch_counts().items()} == b1_b4
        before = launch_counts()
        x_hat = roundtrip(wacnn, lv)
        assert {k: v - before[k] for k, v in launch_counts().items()} == b1_b4
        err_ok(x_hat.cpu().numpy(), out["x_hat"].clamp(0, 1).cpu().numpy(), 1e-5)

    args = parse_args(["-m", "scale_gain_sc", "--N", "192", "--M", "320", "--lambda_list",
                       "0.0025", "0.05"])
    sc = get_model(args, device=cuda)[0]
    sc.update()
    qmap = np.random.default_rng(1).uniform(size=(1, 256, 256, 1)).astype(np.float32)
    enc = sc.compress(img, qmap, 0, 0.5)
    assert torch.equal(enc["y_hat"], sc.decompress(enc["strings"], enc["shape"], 0, 0.5)["y_hat"])


@pytest.mark.cuda
def test_pipelined_paths_on_card_match_serial(cuda):
    """TCM-S (seeded weights), three batches of two 256x256 images:
    compress_pipelined gives compress_batch's streams, roundtrip_pipelined
    decompress_batch's x_hat and y_hat bit for bit, and the decoded y_hat
    is the encoder's; with the caller's TF32 flags on, which the passes
    turn off and give back."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm

    rng = np.random.default_rng(4)
    batches = [np.stack([synth_image(rng, 256, 256) for _ in range(2)]) for _ in range(3)]
    codec = make_tcm(N=64, M=320, device=cuda, seed=2)
    codec.update()
    encs = [codec.compress_batch(x) for x in batches]
    decs = [codec.decompress_batch([e["strings"] for e in es], es[0]["shape"]) for es in encs]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        flat = codec.compress_pipelined(batches)
        out = codec.roundtrip_pipelined(batches)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    assert [e["strings"] for e in flat] == [e["strings"] for es in encs for e in es]
    for o, es, dec in zip(out, encs, decs):
        assert [e["strings"] for e in o["encs"]] == [e["strings"] for e in es]
        assert torch.equal(o["x_hat"], dec["x_hat"]) and torch.equal(o["y_hat"], dec["y_hat"])
        assert torch.equal(o["y_hat"], torch.cat([e["y_hat"] for e in es]))


# ------------------------------- training -------------------------------

SNAPSHOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints", "tcm_s_lambda0.013_r5.npz")
GAIN_SNAPSHOT = os.path.join(os.path.dirname(SNAPSHOT), "scale_gain_vr_r5.npz")


def _tcm_s(device):
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    module = make_tcm(N=64, M=320, device=device, remat=True).module
    load_snapshot_into(module, SNAPSHOT)
    return module


def _train_step_card_vs_cpu(cuda):
    """One TCM-S train step (committed weights, 1x128x128, lambda 0.013) on
    the card and on the CPU with the same noise, drawn on the CPU: the two
    metric dicts and the card's train state."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.base import replayed_noise, uniform_noise
    from reslic_tcm_tpu_torch.ops.launches import launch_counts
    from reslic_tcm_tpu_torch.training.step import create_train_state, train_step

    img = synth_image(np.random.default_rng(4), 128, 128)[None]
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    drawn = []
    draw = uniform_noise(torch.Generator().manual_seed(0))
    want = train_step(create_train_state(_tcm_s("cpu")), x, 0.013,
                      lambda shape: drawn.append(draw(shape)) or drawn[-1])
    state = create_train_state(_tcm_s(cuda))
    before = launch_counts()
    got = train_step(state, x.to(cuda), 0.013, replayed_noise([u.to(cuda) for u in drawn]))
    assert launch_counts() == before  # composed under autograd
    return got, want, state


def _assert_steps_agree(got, want):
    for key, tol in (("loss", 1e-4), ("bpp_loss", 1e-4), ("grad_norm", 1e-3)):
        a, b = float(got[key]), float(want[key])
        assert np.isfinite(a) and abs(a - b) <= tol * abs(b), (key, a, b)


@pytest.mark.cuda
def test_tcm_train_step_on_card_matches_cpu(cuda):
    got, want, _ = _train_step_card_vs_cpu(cuda)
    _assert_steps_agree(got, want)


@pytest.mark.cuda
def test_kernel_forward_after_a_train_step_matches_cpu(cuda):
    """The cached kernel weights follow the optimiser: after a step the
    no_grad forward on the card (B1, B2, B3 at the forward's counts) equals
    the CPU plain forward at the updated weights."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since

    _, _, state = _train_step_card_vs_cpu(cuda)
    img = synth_image(np.random.default_rng(5), 128, 128)[None]
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))
    cpu = _tcm_s("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.module.state_dict().items()})
    before = launch_counts()
    with torch.no_grad():
        got = state.module(x.to(cuda))["x_hat"].cpu()
        assert launches_since(before) == {"flash_window_block": 32, "fused_residual_block": 18,
                                          "fused_conv_gdn": 9, "fused_qkv_attention": 0}
        want = cpu(x)["x_hat"]
    err_ok(got, want, TOL_SLICE)


@pytest.mark.cuda
def test_train_step_pins_fp32_under_a_callers_tf32(cuda):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got, want, _ = _train_step_card_vs_cpu(cuda)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    _assert_steps_agree(got, want)


# ------------------------------ device coder ------------------------------


def _coder_plain_and_card(cuda, *arrays):
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays])


def _table_case(kind):
    """(tables, symbol maker): ``coder_tables``' six random rows, or the
    64-row scale table that codes y (rows up to 3,133 entries)."""
    if kind == "scale":
        return scale_tables(), lambda seed, n, r: scale_symbols(seed, n)
    return coder_tables(40), coder_symbols


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "scale"])
@pytest.mark.parametrize("k,steps", [(8, 40), (100, 12), (1024, 6), (4096, 4)])
def test_table_lane_kernels_match_plain_on_card(cuda, kind, k, steps):
    """D1 and D2 (kernels) against the plain versions: words and counts, then
    the symbols and carries of three chained segments, from per-lane rows
    and from the flat compaction, through the wrapper's D2 variant and
    every other one that takes the table; escapes forced."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.coding import device_rans as dr

    tables, make_symbols = _table_case(kind)
    sym, idx = make_symbols(41, k * steps, tables[0].shape[0])
    tc, tg = dr.lane_tables(*tables, "cpu"), dr.lane_tables(*tables, cuda)
    (sym_c, idx_c), (sym_g, idx_g) = _coder_plain_and_card(cuda, sym, idx)
    cap = steps * 3 + 2
    before = dk.launch_counts()
    words, counts = dk.encode_lanes(sym_g, idx_g, tg.packed, tg.cdf_length, tg.offset, k, cap)
    want_w, want_c = dr.plain_encode_lanes(sym_c, idx_c, tc.cdf, tc.cdf_length, tc.offset, k,
                                           cap, tc.packed)
    assert torch.equal(words.cpu(), want_w) and torch.equal(counts.cpu(), want_c)
    small = max(3, steps // 2)
    w_small, c_small = dk.encode_lanes(sym_g, idx_g, tg.packed, tg.cdf_length, tg.offset, k,
                                       small)
    assert torch.equal(w_small.cpu(), want_w[:, :small]) and torch.equal(c_small.cpu(), want_c)
    flat, _ = ar.compact_stream(want_w, want_c, int(want_c.sum()))
    variants = dk.decode_variants(tg.search)
    assert len(variants) == len(dk.TABLE_DECODE_VARIANTS)  # both tables fit
    for stream, offsets in ((want_w, None), (flat, ar.lane_offsets(want_c))):
        stream_g = stream.to(cuda)
        offsets_g = None if offsets is None else offsets.to(cuda)
        base_g = dr.lane_base(stream_g, k, offsets_g)
        carry_c = dr.decoder_init(stream, want_c, offsets)
        carry_g = tuple(t.to(cuda) for t in carry_c)
        forced = {v: tuple(t.to(cuda) for t in carry_c) for v in variants}
        for part in np.array_split(np.arange(k * steps).reshape(steps, k), 3):
            part = part.reshape(-1)
            carry_g, got = dr.decode_segment(carry_g, stream_g, idx_g[part], tg.cdf,
                                             tg.cdf_length, tg.offset, k, lane_offsets=offsets_g,
                                             search=tg.search)
            carry_c, want = dr.decode_segment(carry_c, stream, idx_c[part], tc.cdf,
                                              tc.cdf_length, tc.offset, k, inverse=tc.inverse,
                                              packed=tc.packed, lane_offsets=offsets)
            assert torch.equal(got.cpu(), want) and torch.equal(want, sym_c[part])
            assert all(torch.equal(a.cpu(), b) for a, b in zip(carry_g, carry_c))
            for v, (x, rp) in forced.items():
                got = dk.decode_with(x, rp, stream_g, base_g, idx_g[part].contiguous(),
                                     tg.search, k, v)
                assert torch.equal(got.cpu(), want), v
                assert torch.equal(x.cpu(), carry_c[0]) and torch.equal(rp.cpu(), carry_c[1]), v
    after = dk.launch_counts()
    assert after["encode_lanes"] == before["encode_lanes"] + 2
    assert after["decode_lanes"] == before["decode_lanes"] + 6


@pytest.mark.cuda
def test_d2_decodes_a_table_too_large_to_stage(cuda):
    """A table of 200 rows of up to 2,000 entries (about 0.8 MB, past a
    CTA's shared memory): the wrapper reads it where it lies, with the
    plain version's bits, and a staged variant refuses it, naming its size."""
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.coding import device_rans as dr

    k, steps = 256, 24
    tables = coder_tables(44, r=200, width=2000)
    sym, idx = coder_symbols(45, k * steps, 200)
    tc, tg = dr.lane_tables(*tables, "cpu"), dr.lane_tables(*tables, cuda)
    assert tg.search.layout.numel() * 4 > dk.MAX_SHARED_BYTES
    variants = dk.decode_variants(tg.search)
    assert variants and not any(staged for _, staged in variants)
    assert not dk.decode_variant(tg.search)[1]
    (sym_c, idx_c), (_, idx_g) = _coder_plain_and_card(cuda, sym, idx)
    words, counts = dr.plain_encode_lanes(sym_c, idx_c, tc.cdf, tc.cdf_length, tc.offset, k,
                                          steps * 3 + 2, tc.packed)
    got = dr.decode_interleaved(words.to(cuda), counts.to(cuda), idx_g, tg.cdf, tg.cdf_length,
                                tg.offset, n=k * steps, k=k, search=tg.search)
    assert torch.equal(got.cpu(), sym_c)
    x, rp = (t.to(cuda) for t in dr.decoder_init(words, counts))
    words_g = words.to(cuda)
    for v in variants:
        got = dk.decode_with(x.clone(), rp.clone(), words_g, dr.lane_base(words_g, k, None),
                             idx_g, tg.search, k, v)
        assert torch.equal(got.cpu(), sym_c), v
    size = tg.search.layout.numel() * 4
    staged = next(v for v in dk.TABLE_DECODE_VARIANTS if v[1])
    with pytest.raises(ValueError, match=f"this table has {size}"):
        dk.decode_with(x, rp, words_g, dr.lane_base(words_g, k, None), idx_g, tg.search, k,
                       staged)


def _gaussian_case(seed, k, steps):
    """(sigma, symbols) float32 / int32 numpy arrays of k * steps: Gaussian
    symbols clamped to their support, and each in a bin of width zero moved
    one bin down. No encoder of the analytic scheme can code a symbol there
    (JAX's divides by freq = 0 and decodes another value, the plain
    version raises; tests/test_torch_port_analytic_search.py), so the
    kernels cannot be held to the plain versions on it. Such bins lie in
    the far upper tail: one symbol of the 786,432 at (4096, 192), none at
    the smaller shapes."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    sigma, sym = gaussian_inputs(seed, k * steps)
    c = ar.support(torch.from_numpy(sigma)).numpy()
    sym = torch.from_numpy(np.clip(sym, -c, c))
    p = ar.coder_params(torch.from_numpy(sigma))
    while True:
        zero = ar._start_freq(sym, p)[1] == 0
        if not bool(zero.any()):
            return sigma, sym.numpy()
        sym = torch.where(zero, sym - 1, sym)


@pytest.mark.cuda
@pytest.mark.parametrize("k,steps", [(1, 30), (3, 20), (5, 16), (8, 40), (96, 12), (1000, 45),
                                     (1024, 8), (2048, 3), (4096, 4), (8192, 2), (4096, 192),
                                     (8193, 4), (16384, 3), (100000, 3)])
def test_gaussian_lane_kernels_match_plain_on_card(cuda, k, steps):
    """D3 and D4 (kernels; D4 on the wrapper's cluster, 1, 2, 4, 8 and 16
    CTAs at these k) against the plain versions on sigma over [0.05, 300]:
    the lanes' words, flags and final states, then the values and carries
    of two chained segments, which are the symbols. (1000, 45): D3's last
    CTA and tile and D4's last CTA partly filled; (4096, 192): the serving
    path's batch of 8; from 8193 on, more lanes than 16 CTAs of 512: a
    thread a lane up to 16,384, and at 100,000 seven lanes a thread kept
    in memory."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar
    from reslic_tcm_tpu_torch.coding import device_kernels as dk

    sigma, sym = _gaussian_case(42, k, steps)
    (sig_c, sym_c), (sig_g, sym_g) = _coder_plain_and_card(cuda, sigma, sym)
    got = ar.encode_gaussian_lanes(sym_g, sig_g, k)
    want = ar.encode_gaussian_lanes(sym_c, sig_c, k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    header, flat, _, _ = ar.compact_grouped(*want, k * steps)
    flat = torch.cat([flat, flat.new_zeros(k)])
    carry_c = ar.decode_gaussian_grouped_init(header)
    carry_g = tuple(t.to(cuda) for t in carry_c)
    before = dk.launch_counts()["gaussian_decode_lanes"]
    for part in np.array_split(np.arange(steps), 2):
        sl = slice(int(part[0]) * k, (int(part[-1]) + 1) * k)
        carry_g, vals_g = ar.decode_gaussian_grouped_segment(carry_g, flat.to(cuda), sig_g[sl], k)
        carry_c, vals_c = ar.decode_gaussian_grouped_segment(carry_c, flat, sig_c[sl], k)
        assert torch.equal(vals_g.cpu(), vals_c) and torch.equal(vals_c, sym_c[sl])
        assert torch.equal(carry_g[0].cpu(), carry_c[0]) and int(carry_g[1]) == int(carry_c[1])
    assert dk.launch_counts()["gaussian_decode_lanes"] == before + 2


D4_CLUSTERS = [(k, c) for k in (1000, 1024, 4096, 8193, 16384, 100000)
               for c in PDK.decode_clusters(k)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,cluster", D4_CLUSTERS)
def test_every_d4_cluster_gives_the_same_bits(cuda, k, cluster):
    """D4 on each cluster size at a k that leaves the last CTA partly
    filled (1000), the codec's k=1024, the serving path's k=4096 and three
    k that need more than a thread a lane on all clusters but the largest
    (8193, 16384; 100,000 on every cluster), where a thread keeps several
    lanes in global memory: the values and carries of three chained
    segments equal the plain version's."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    steps = 24 if k <= 4096 else 6
    sigma, sym = _gaussian_case(45, k, steps)
    (sig_c, sym_c), (sig_g, _) = _coder_plain_and_card(cuda, sigma, sym)
    header, flat, _, _ = ar.compact_grouped(*ar.plain_encode_gaussian_lanes(sym_c, sig_c, k),
                                            k * steps)
    flat = torch.cat([flat, flat.new_zeros(k)])
    flat_g = flat.to(cuda)
    carry_c = ar.decode_gaussian_grouped_init(header)
    x, g = (t.to(cuda) for t in carry_c)
    for part in np.array_split(np.arange(steps), 3):
        sl = slice(int(part[0]) * k, (int(part[-1]) + 1) * k)
        vals = PDK.decode_on_cluster(x, g, flat_g, sig_g[sl].contiguous(), k, cluster)
        carry_c, want = ar.plain_decode_gaussian_lanes(carry_c, flat, sig_c[sl], k)
        assert torch.equal(vals.cpu(), want) and torch.equal(want, sym_c[sl])
        assert torch.equal(x.cpu(), carry_c[0]) and int(g) == int(carry_c[1])


@pytest.mark.cuda
def test_d4_raises_on_a_cluster_it_does_not_have(cuda):
    k = 4096
    sig = torch.ones(k * 2, device=cuda)
    flat = torch.zeros(k * 2, dtype=torch.int32, device=cuda)
    x = torch.zeros(k, dtype=torch.int64, device=cuda)
    g = torch.zeros((), dtype=torch.int64, device=cuda)
    # no instance (3, 32 CTAs)
    for cluster in (3, 32):
        with pytest.raises(ValueError, match="no cluster"):
            PDK.decode_on_cluster(x, g, flat, sig, k, cluster)
    # more CTAs than lanes
    with pytest.raises(ValueError, match="no cluster"):
        PDK.decode_on_cluster(x[:8], g, flat, sig[:16], 8, 16)


@pytest.mark.cuda
def test_d3_raises_on_a_symbol_in_a_zero_width_bin(cuda):
    """Sigma 9.120379, symbol 47: bin 102 of 111, of width zero. The plain
    encoder raises on its division by zero; D3 computes the same bits and
    its wrapper raises too, where the card would otherwise write a stream
    that decodes another value. The same symbol one bin down codes."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    k = 8
    sigma = np.full(4 * k, 9.120379, np.float32)
    sym = np.zeros(4 * k, np.int32)
    sym[3] = 47
    (sig_c, sym_c), (sig_g, sym_g) = _coder_plain_and_card(cuda, sigma, sym)
    with pytest.raises(RuntimeError, match="ZeroDivision"):
        ar.plain_encode_gaussian_lanes(sym_c, sig_c, k)
    before = PDK.launch_counts()["gaussian_encode_lanes"]
    with pytest.raises(RuntimeError, match="ZeroDivision"):
        PDK.gaussian_encode_lanes(sym_g, sig_g, k)
    assert PDK.launch_counts()["gaussian_encode_lanes"] == before + 1
    sym_c[3] = sym_g[3] = 46
    got = PDK.gaussian_encode_lanes(sym_g, sig_g, k)
    want = ar.plain_encode_gaussian_lanes(sym_c, sig_c, k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_erf_on_card_is_the_plain_erf(cuda):
    """The plain erf (XLA's) on CUDA tensors gives the CPU's bits: the float64
    emulation of the fused multiply-add does not depend on the device."""
    from reslic_tcm_tpu_torch.coding import analytic_rans as ar

    x = np.random.default_rng(43).uniform(-6, 6, 200_000).astype(np.float32)
    assert torch.equal(ar.erf(torch.from_numpy(x).to(cuda)).cpu(), ar.erf(torch.from_numpy(x)))


@pytest.mark.cuda
def test_coder_wrappers_raise_on_what_the_kernels_do_not_take(cuda, monkeypatch):
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.coding import device_rans as dr

    k = 64
    sig = torch.ones(k, device=cuda)
    sym = torch.zeros(k, dtype=torch.int32, device=cuda)
    tg = dr.lane_tables(*coder_tables(40), cuda)
    with pytest.raises(ValueError, match="int32"):
        dk.encode_lanes(sym.long(), sym, tg.packed, tg.cdf_length, tg.offset, k, 8)
    with pytest.raises(ValueError, match="shape"):
        dk.encode_lanes(sym, sym[:32], tg.packed, tg.cdf_length, tg.offset, k, 8)
    x = torch.full((k,), 1 << 16, dtype=torch.int64, device=cuda)
    rp = torch.zeros(k, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        dk.decode_lanes(x.int(), rp, sym, rp, sym, tg.search, k)
    with pytest.raises(ValueError, match="shape"):
        dk.decode_lanes(x[:32], rp, sym, rp, sym, tg.search, k)
    with pytest.raises(ValueError, match="no variant"):
        dk.decode_with(x, rp, sym, rp, sym, tg.search, k, (64, True))
    # a variant the library was not built with: the launch fails and the
    # wrapper raises
    monkeypatch.setattr(dk, "TABLE_DECODE_VARIANTS", dk.TABLE_DECODE_VARIANTS + ((64, True),))
    before = dk.launch_counts()["decode_lanes"]
    with pytest.raises(RuntimeError, match="launch failed"):
        dk.decode_with(x, rp, sym, rp, sym, tg.search, k, (64, True))
    assert dk.launch_counts()["decode_lanes"] == before
    with pytest.raises(ValueError, match="float32"):
        dk.gaussian_encode_lanes(sym, sig.double(), k)
    with pytest.raises(ValueError, match="do not fill"):
        dk.gaussian_encode_lanes(sym, sig, 48)
    # any lane count is taken; a stream shorter than the window it reads is not
    x = torch.zeros(16384, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="the window reads"):
        dk.gaussian_decode_lanes(x, torch.zeros((), dtype=torch.int64, device=cuda),
                                 sym.repeat(255), sig.repeat(256), 16384)


@pytest.mark.cuda
def test_tcm_s_device_coder_on_card(cuda):
    """TCM-S (committed weights) at 256x256 through both device profiles on
    the card: exact y_hat; the table path's x_hat equals the host codec's
    decode within 1e-5; B1-B3 launch as in compress and decompress, and
    every coder kernel launches."""
    from reslic_tcm_tpu_torch.coding import device_kernels as dk
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    codec = make_tcm(N=64, M=320, device=cuda)
    load_snapshot_into(codec.module, SNAPSHOT)
    codec.update()
    x = synth_image(np.random.default_rng(8), 256, 256)[None]
    before = launch_counts()
    host = codec.compress(x)
    host_dec = codec.decompress(host["strings"], host["shape"])
    host_launches = launches_since(before)
    dk.reset_launch_counts()
    before = launch_counts()
    enc = codec.compress_device(x)
    dec = codec.decompress_device(enc)
    assert launches_since(before) == host_launches
    assert host_launches["flash_window_block"] > 0 and host_launches["fused_conv_gdn"] > 0
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    err_ok(dec["x_hat"].cpu(), host_dec["x_hat"].cpu(), 1e-5)
    enc = codec.compress_device_analytic(x)
    dec = codec.decompress_device_analytic(enc)
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert all(n > 0 for n in dk.launch_counts().values()), dk.launch_counts()


@pytest.mark.cuda
def test_tiled_tcm_on_card_matches_its_plain_versions(cuda):
    """``parallel/spatial.py::tiled_forward`` of TCM (N=64, seeded random
    weights) on a 640x512 image in 256x256 tiles (overlap 64, 4 a chunk:
    12 tiles, 3 chunks) through B1-B3, each chunk launching them as one
    forward pass does, against the same on the card through their plain
    versions (``plain_versions``): x_hat within 1e-4, bits within 1e-4
    relative."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since
    from reslic_tcm_tpu_torch.ops.layers import plain_versions
    from reslic_tcm_tpu_torch.parallel.spatial import tiled_forward

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    codec = make_tcm(N=64, M=320, device=cuda, seed=2)
    img = synth_image(np.random.default_rng(5), 640, 512)[None]
    before = launch_counts()
    x_hat, bits = tiled_forward(codec, img, 256, 64, 4)
    assert launches_since(before) == {"flash_window_block": 96, "fused_residual_block": 54,
                                      "fused_conv_gdn": 27, "fused_qkv_attention": 0}
    before = launch_counts()
    with plain_versions():
        x_plain, bits_plain = tiled_forward(codec, img, 256, 64, 4)
    assert not any(launches_since(before).values())
    err_ok(x_hat.cpu().numpy(), x_plain.cpu().numpy(), TOL_CARD)
    assert abs(bits - bits_plain) <= 1e-4 * bits_plain, (bits, bits_plain)


@pytest.mark.cuda
def test_mesh_sharded_forward_over_nccl_in_a_world_of_one(cuda):
    """A world of one over NCCL: ``mesh_sharded_forward`` of TCM (N=64,
    random weights) at 768x512, halo 64, equals the module's forward of the
    image with its two 64-row zero halos (x_hat within 1e-4, bits within
    1e-4 relative) and stays within 0.02 mean |difference| of the
    monolithic forward (tests/test_spatial.py's limit)."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.ops.layers import to_nchw
    from reslic_tcm_tpu_torch.parallel.multihost import free_port, initialize_distributed
    from reslic_tcm_tpu_torch.parallel.spatial import STRIDES, mesh_sharded_forward

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    codec = make_tcm(N=64, M=320, device=cuda, seed=3)
    x = to_nchw(torch.from_numpy(synth_image(np.random.default_rng(6), 768, 512)[None]).to(cuda))
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        x_hat, bits = mesh_sharded_forward(codec.module, x, halo=64)
    finally:
        torch.distributed.destroy_process_group()
    with torch.no_grad():
        padded = codec.module(torch.nn.functional.pad(x, (0, 0, 64, 64)))
        mono = codec.module(x)
    want = torch.clamp(padded["x_hat"][:, :, 64:64 + 768], 0, 1)
    want_bits = sum(float(-torch.log2(lik[:, :, 64 // STRIDES[k]:(64 + 768) // STRIDES[k]]).sum())
                    for k, lik in padded["likelihoods"].items())
    err_ok(x_hat.cpu().numpy(), want.cpu().numpy(), TOL_CARD)
    assert abs(bits - want_bits) <= 1e-4 * want_bits, (bits, want_bits)
    assert float((x_hat - torch.clamp(mono["x_hat"], 0, 1)).abs().mean()) < 0.02


# ------------------------- bf16 instances (B1-B3) -------------------------
# Tolerance of a bf16 instance against its plain bf16 version: both round
# the same operands to bf16 and sum in other orders, so a value near a
# rounding boundary can land on the neighbouring bf16 value (2^-8
# relative) and carry that into the later products: 4e-3 * max(1, max
# |plain|) (measured on an H100: at most 1.4e-3).
TOL_BF16 = 4e-3
BF16 = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("c,head_dim,hw,shifted", [
    (64, 8, (48, 32), True), (64, 16, (16, 24), False), (64, 32, (24, 16), True),
    (96, 8, (16, 24), False), (96, 16, (24, 16), True), (96, 32, (8, 16), False),
    (128, 8, (16, 16), True), (128, 16, (48, 32), True), (128, 32, (24, 8), False),
    (192, 8, (16, 24), False), (192, 16, (24, 16), True), (192, 32, (48, 32), True),
    (64, 8, (24, 24), True), (128, 16, (40, 24), False), (192, 8, (24, 40), True),
    (96, 32, (8, 24), True)])
def test_b1_bf16_instance_matches_plain_on_card(cuda, c, head_dim, hw, shifted):
    """Every (C, head_dim) of KERNEL_SHAPES_FULL, each cluster the rules use
    (the smallest and the largest) at each of its windows a CTA giving the
    same bits (window counts of 2 to 24 per image, 3 and 15 not a multiple
    of two; 24: SWAtten's map), and two calls the same bits."""
    x, wts = attn_inputs(80 + head_dim, 2, *hw, c)
    rel = np.random.default_rng(81).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    args = port_attn_args(wts, rel, lambda t: t.to(cuda))
    xc = torch.from_numpy(x).to(cuda)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, compute_dtype=BF16)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        before = (PF.flash_window_block.launches, PF.flash_window_block.launches_bf16)
        got = PF.flash_window_block(xc, *args, **kw)
        torch.cuda.synchronize()
        assert (PF.flash_window_block.launches,
                PF.flash_window_block.launches_bf16) == (before[0], before[1] + 1)
        for k in {PF.min_cluster(c), PF.max_cluster(c, head_dim)}:
            assert torch.equal(PF.flash_window_block(xc, *args, **kw, cluster=k), got), k
            for g in PF.window_groups(c, k):
                forced = PF.flash_window_block_at(xc, *args, head_dim=head_dim, window=8,
                                                  shifted=shifted, cluster=k, group=g)
                assert torch.equal(forced, got), (k, g)
        assert torch.equal(PF.flash_window_block(xc, *args, **kw), got)
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_BF16)


@pytest.mark.cuda
def test_b1_bf16_refuses_windows_a_cta_without_an_instance(cuda):
    """Two windows a CTA exist only at the smallest cluster."""
    c, head_dim = 64, 8
    x, wts = attn_inputs(88, 1, 16, 16, c)
    rel = np.zeros((c // head_dim, 64, 64), np.float32)
    args = port_attn_args(wts, rel, lambda t: t.to(cuda))
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="windows a CTA"):
        PF.flash_window_block_at(xc, *args, head_dim=head_dim, window=8, shifted=False,
                                 cluster=PF.max_cluster(c, head_dim), group=2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,c,hw", [
    ("b2", 64, (96, 64)), ("b2", 96, (13, 10)), ("b2", 128, (24, 16)), ("b2", 192, (37, 45)),
    ("b3", 64, (37, 45)), ("b3", 128, (96, 64)), ("b3", 192, (24, 16)), ("b3", 256, (13, 10)),
    ("b3", 384, (24, 16)), ("b2", 192, (24, 40)), ("b3", 384, (20, 36)),
    ("b2", 96, (1, 1))])
def test_b2_b3_bf16_instances_match_plain_on_card(cuda, kernel, c, hw):
    """Each instance against its plain bf16 version; both tiles, forced on
    the same input, and a second call give the same bits (GDN and IGDN for
    B3). The maps include sides that are not multiples of either tile's
    (16 or 8 rows, 16 columns) and a single pixel."""
    x, w1, b1, w2, b2, gamma, beta, skip = conv_inputs(90 + c, 2, *hw, c)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    with torch.no_grad():
        if kernel == "b2":
            args = (t(x), oihw(w1).to(cuda), t(b1), oihw(w2).to(cuda), t(b2))
            calls = [(PC.fused_residual_block, PC.plain_residual_block, {})]
        else:
            args = (t(x), oihw(w1).to(cuda), t(b1), t(gamma), t(beta), t(skip))
            calls = [(PC.fused_conv_gdn, PC.plain_conv_gdn, {"inverse": inv})
                     for inv in (False, True)]
        for kern, plain, kw in calls:
            want = plain(*args, **kw, compute_dtype=BF16)
            before = (kern.launches, kern.launches_bf16)
            got = kern(*args, **kw, compute_dtype=BF16)
            torch.cuda.synchronize()
            assert (kern.launches, kern.launches_bf16) == (before[0], before[1] + 1)
            for tile in PC.TILES:
                assert torch.equal(kern(*args, **kw, compute_dtype=BF16, tile=tile), got), tile
            assert torch.equal(kern(*args, **kw, compute_dtype=BF16), got)
            err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_BF16)


@pytest.mark.cuda
def test_codec_switched_from_bf16_gives_the_fp32_bits_back(cuda):
    """A TCM codec (the three kernels on its path) run in bf16 mode and then
    switched back gives the fp32 mode's outputs bit for bit, and never
    launches an instance of the other mode: the prepared weights are kept
    per type."""
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since

    codec = make_tcm(N=64, M=320, device=cuda, seed=7)
    x = np.random.default_rng(7).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    fp32 = codec.forward(x)
    codec.set_matmul_precision("bfloat16")
    before = (launch_counts(), launch_counts(BF16))
    bf16 = codec.forward(x)
    assert not any(launches_since(before[0]).values())
    assert all(launches_since(before[1], BF16).values())
    codec.update()
    enc = codec.compress(x)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    codec.set_matmul_precision(None)
    before = (launch_counts(), launch_counts(BF16))
    again = codec.forward(x)
    assert not any(launches_since(before[1], BF16).values())
    assert torch.equal(again["x_hat"], fp32["x_hat"])
    assert not torch.equal(bf16["x_hat"], fp32["x_hat"])


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,head_dim,hw", [(128, 16, (16, 24)), (192, 24, (24, 16)),
                                           (192, 24, (64, 64)), (128, 16, (16, 16)),
                                           (192, 24, (32, 32)), (128, 16, (192, 128)),
                                           (192, 24, (192, 128))])
def test_b1_attention_only_bf16_instance_matches_plain_on_card(cuda, c, head_dim, hw, shifted):
    """WACNN's attention-only flavour in bf16 (csrc/window_attn_bf16.cu) at
    each (C, head_dim) of KERNEL_SHAPES_ATTN, batch 2 (4, 6, 16, 64 and 384
    windows an image), against its plain bf16 version; every option its
    wrapper can force (attn_options: each cluster at several persistent
    grids, some leaving clusters a window short), on the same input, and a
    second call give the same bits; one launch counted in launches_bf16."""
    x, wts = attn_inputs(100 + head_dim, 2, *hw, c)
    rel = np.random.default_rng(101).normal(0, 0.5, (c // head_dim, 64, 64)).astype(np.float32)
    wqkv, bqkv, wproj, bproj, _, _, relc, _ = port_attn_args(wts, rel, lambda t: t.to(cuda))
    args = (wqkv, bqkv, wproj, bproj, None, None, relc, None)
    kw = dict(head_dim=head_dim, window=8, shifted=shifted, with_ln=False, compute_dtype=BF16)
    windows = 2 * (hw[0] // 8) * (hw[1] // 8)
    xc = torch.from_numpy(x).to(cuda)
    with torch.no_grad():
        want = PF.plain_window_block(xc, *args, **kw)
        before = (PF.flash_window_block.launches, PF.flash_window_block.launches_bf16)
        got = PF.flash_window_block(xc, *args, **kw)
        torch.cuda.synchronize()
        assert (PF.flash_window_block.launches,
                PF.flash_window_block.launches_bf16) == (before[0], before[1] + 1)
        for n, force in attn_options(c, windows, BF16).items():
            assert torch.equal(PF.flash_window_block(xc, *args, **kw, **force), got), n
        assert torch.equal(PF.flash_window_block(xc, *args, **kw), got)
    err_ok(got.cpu().numpy(), want.cpu().numpy(), TOL_BF16)


@pytest.mark.cuda
def test_wacnn_bf16_mode_launches_only_bf16_b1_and_decodes_exactly(cuda):
    """WACNN (N=192, M=320, seeded) in bf16 mode on a 256x256 image: each
    pass launches B1's attention-only bf16 instance (2 / 1 / 1) and nothing
    else (B4 stays off: the window-4 attention composes in bf16), the decode
    reproduces y_hat, and switching back gives the fp32 bits."""
    from reslic_tcm_tpu_torch.data.synthetic import synth_image
    from reslic_tcm_tpu_torch.models.wacnn import make_wacnn
    from reslic_tcm_tpu_torch.ops.launches import launch_counts, launches_since

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    img = synth_image(np.random.default_rng(0), 256, 256)[None]
    codec = make_wacnn(device=cuda, seed=1)
    codec.update()
    fp32 = codec.forward(img)
    codec.set_matmul_precision("bfloat16")
    counts = []
    for run in (lambda: codec.forward(img), lambda: codec.compress(img)):
        before = (launch_counts(), launch_counts(BF16))
        out = run()
        counts.append((launches_since(before[0]), launches_since(before[1], BF16)))
    enc = out
    before = (launch_counts(), launch_counts(BF16))
    dec = codec.decompress(enc["strings"], enc["shape"])
    counts.append((launches_since(before[0]), launches_since(before[1], BF16)))
    for (f32, b16), n in zip(counts, (2, 1, 1)):
        assert not any(f32.values()), f32
        assert b16 == {"flash_window_block": n, "fused_residual_block": 0, "fused_conv_gdn": 0}
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    codec.set_matmul_precision(None)
    assert torch.equal(codec.forward(img)["x_hat"], fp32["x_hat"])


# ------------------------------- the CLIs' I/O -------------------------------


@pytest.mark.cuda
def test_port_written_png_feeds_evaluate_on_card_without_pillow(cuda, tmp_path, monkeypatch):
    """A corpus file the port wrote, read by data/png.py with Pillow not
    importable (a machine may have none), through cli/eval.py::evaluate
    on the card with TCM-S's committed weights: an exact y_hat and B1-B3
    launched as by compress and decompress."""
    from reslic_tcm_tpu_torch.cli.eval import evaluate
    from reslic_tcm_tpu_torch.data.png import read_png
    from reslic_tcm_tpu_torch.data.synthetic import generate_corpus
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.utils.torch_convert import load_snapshot_into

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    root = generate_corpus(str(tmp_path), n_train=0, n_test=1, test_size=(256, 384))
    img = read_png(os.path.join(root, "test", "data", "synth_00000.png"))
    assert img.shape == (256, 384, 3) and img.dtype == np.uint8
    codec = make_tcm(N=64, M=320, device=cuda)
    load_snapshot_into(codec.module, SNAPSHOT)
    codec.update()
    rec = evaluate(codec, [img.astype(np.float32) / 255.0], real=True,
                   log=lambda *_: None)["records"][0]
    assert rec["y_hat_exact"]
    assert rec["launches_compress"] == {"flash_window_block": 26, "fused_residual_block": 12,
                                        "fused_conv_gdn": 6, "fused_qkv_attention": 0}
    assert rec["launches_decompress"] == {"flash_window_block": 26, "fused_residual_block": 10,
                                          "fused_conv_gdn": 5, "fused_qkv_attention": 0}


@pytest.mark.cuda
def test_profiling_tools_on_card(cuda, tmp_path, capsys):
    """utils/profiling.py on the card: ``trace`` records the card's kernels
    into its trace file; ``timed`` fences on a CUDA tensor of its block."""
    import json

    from reslic_tcm_tpu_torch.utils.profiling import throughput_mp_s, timed, trace

    x = torch.ones(1024, 1024, device=cuda)
    with trace(str(tmp_path / "tb")):
        y = x @ x
        torch.cuda.synchronize()
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "tb") for f in fs
             if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    with timed("matmul") as out:
        out["sync"] = {"y": [x @ y]}
    assert out["seconds"] > 0 and capsys.readouterr().out.startswith("[timed] matmul: ")
    assert throughput_mp_s(393_216, out["seconds"]) > 0
