"""The codec pins full fp32 in its own passes, whatever the caller's TF32
flags, and gives the caller's flags back afterwards.

An encoder and a decoder must compute identical scales: with TF32 on,
cuDNN's convolutions round differently, so a stream encoded under TF32
could decode to other scale indexes with TF32 off. Here both flags are set
True, a tiny CPU codec records them from inside each pass (forward hooks
on its sub-modules, and the entropy bottleneck's table build for
update()), and the flags must read False there and True again after.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reslic_tcm_tpu_torch.entropy import factorized as fz
from reslic_tcm_tpu_torch.models import base
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from torch_port_threads import one_torch_thread  # noqa: E402,F401


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("pass_name", ["update", "forward", "compress", "decompress"])
def test_codec_passes_run_without_tf32_and_restore_the_flags(tf32_on, monkeypatch, pass_name):
    codec = make_tcm(N=32, M=80, hyper_ch=24, atten_inter_dim=32, device="cpu", seed=4)
    img = np.random.default_rng(5).uniform(size=(1, 128, 128, 3)).astype(np.float32)
    seen = []
    m = codec.module
    for sub in (m.g_a, m.g_s, m.h_mean_s, m.cc_scale_transforms[0]):
        sub.register_forward_hook(lambda *_: seen.append(_flags()))
    build_tables = fz.build_tables
    monkeypatch.setattr(fz, "build_tables",
                        lambda *a: (seen.append(_flags()), build_tables(*a))[1])
    if pass_name != "update":
        codec.update()
        enc = codec.compress(img) if pass_name == "decompress" else None
        seen.clear()
    assert _flags() == (True, True)
    if pass_name == "update":
        codec.update()
    elif pass_name == "forward":
        codec.forward(img)
    elif pass_name == "compress":
        codec.compress(img)
    else:
        codec.decompress(enc["strings"], enc["shape"])
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)


def test_fp32_numerics_restores_the_flags_after_an_error(tf32_on):
    with pytest.raises(ZeroDivisionError):
        with base.fp32_numerics():
            assert _flags() == (False, False)
            1 / 0
    assert _flags() == (True, True)


def test_fp32_numerics_holds_while_threads_overlap(tf32_on):
    """Two threads in passes at once, the caller's flags True: thread A
    enters, then B, then A leaves while B is still inside. B must still
    read the flags False (a version that restores the flags each thread
    saved on entry would hand B A's True), and the caller gets True back
    once both have left."""
    import threading

    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with base.fp32_numerics():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with base.fp32_numerics():
            b_in.set()
            a_out.wait(10)
            seen["b after a left"] = _flags()

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert seen == {"b after a left": (False, False)}
    assert _flags() == (True, True)


def test_pipelined_paths_run_without_tf32_and_restore_the_flags(tf32_on):
    """roundtrip_pipelined decodes in worker threads while the main thread
    encodes: every pass reads the flags False, the caller's come back."""
    codec = make_tcm(N=32, M=80, hyper_ch=24, atten_inter_dim=32, device="cpu", seed=4)
    codec.update()
    img = np.random.default_rng(5).uniform(size=(1, 128, 128, 3)).astype(np.float32)
    seen = []
    m = codec.module
    for sub in (m.g_a, m.g_s, m.cc_scale_transforms[0]):
        sub.register_forward_hook(lambda *_: seen.append(_flags()))
    out = codec.roundtrip_pipelined([img, img, img])
    assert len(out) == 3 and seen and set(seen) == {(False, False)}
    assert _flags() == (True, True)
