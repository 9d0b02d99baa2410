"""The pipelined host codec of reslic_tcm_tpu_torch/models/base.py
(``ChannelARCodec.compress_pipelined`` and ``roundtrip_pipelined``) against
the serial ``compress_batch`` and ``decompress_batch`` on the CPU: the same
streams, byte for byte, and the same decoded x_hat and y_hat, bit for bit,
batch after batch. On the CPU the device stage has nothing to overlap, so
this checks the staging, the thread pools and the ordering; the card's
overlap is measured by chip_smoke.py and checked by
tests/test_torch_port_cuda.py.

Models: TCM at config (1,1,1,1,1,1), N=32, M=80 with seeded weights, and
the tiny wacnn_gain of tests/test_torch_port_gain_wacnn.py at level 1.
Batches of 1-3 images of 128x128 from a seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reslic_tcm_tpu_torch.models.gain.gained import make_gained_wacnn
from reslic_tcm_tpu_torch.models.tcm import make_tcm
from tests.test_torch_port_train_parity import TCM_SMALL, WACNN_TINY
from torch_port_threads import one_torch_thread  # noqa: E402,F401


def _wacnn_gain():
    codec = make_gained_wacnn(N=32, M=40, lmbda_list=(0.0025, 0.05), device="cpu", seed=2,
                              gain_init_spread=2.0, **WACNN_TINY)
    m = codec.module
    with torch.no_grad():  # y into the coder's range (random init rounds it to zero)
        for layer, factor in [(m.g_a[7], 40.0)] + [(t[-1], 60.0) for t in m.cc_scale_transforms]:
            layer.weight.mul_(factor)
            layer.bias.mul_(factor)
    return codec


MODELS = {"tcm": (lambda: make_tcm(device="cpu", seed=4, **TCM_SMALL), 0),
          "wacnn_gain": (_wacnn_gain, 1)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def coded(request):
    """(codec, level, batches, the serial encodings and decodings)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    make, lv = MODELS[request.param]
    codec = make()
    codec.update()
    rng = np.random.default_rng(7)
    batches = [rng.uniform(size=(n, 128, 128, 3)).astype(np.float32) for n in (2, 1, 3)]
    encs = [codec.compress_batch(x, lv) for x in batches]
    decs = [codec.decompress_batch([e["strings"] for e in es], es[0]["shape"], lv)
            for es in encs]
    yield codec, lv, batches, encs, decs
    torch.set_num_threads(threads)


def _strings(encs):
    return [e["strings"] for e in encs]


def test_compress_pipelined_gives_the_serial_streams(coded):
    codec, lv, batches, encs, _ = coded
    got = codec.compress_pipelined(batches, lv)
    assert _strings(got) == [s for es in encs for s in _strings(es)]
    assert sum(len(s[0][0]) for s in _strings(got)) > 100 * len(got)  # y is coded
    for g, e in zip(got, [e for es in encs for e in es]):
        assert g["shape"] == e["shape"] and torch.equal(g["y_hat"], e["y_hat"])


@pytest.mark.parametrize("decode_workers", [1, 2])
def test_roundtrip_pipelined_decodes_as_serial(coded, decode_workers):
    """Per batch: the serial streams and, bit for bit, decompress_batch's
    x_hat and y_hat, which is the encoder's y_hat."""
    codec, lv, batches, encs, decs = coded
    out = codec.roundtrip_pipelined(batches, lv, decode_workers=decode_workers)
    assert len(out) == len(batches)
    for o, es, dec in zip(out, encs, decs):
        assert _strings(o["encs"]) == _strings(es)
        assert torch.equal(o["x_hat"], dec["x_hat"]) and torch.equal(o["y_hat"], dec["y_hat"])
        assert torch.equal(o["y_hat"], torch.cat([e["y_hat"] for e in o["encs"]]))


def test_encoder_stages_compose_to_encode_symbols(coded):
    """The device stage hands the host stage host buffers (no event on the
    CPU); the two give encode_symbols' arrays."""
    codec, lv, batches, _, _ = coded
    staged = codec._encode_device_stage(batches[0], lv)
    assert staged["ready"] is None and staged["symbols"].device.type == "cpu"
    got = codec._encode_host_stage(staged)
    want = codec.encode_symbols(batches[0], lv)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.int32 and torch.equal(got[3], want[3])


def test_pipelined_paths_take_no_batches(coded):
    codec, lv, _, _, _ = coded
    assert codec.compress_pipelined([], lv) == [] and codec.roundtrip_pipelined([], lv) == []


def test_prepared_weight_cache_fills_once_under_threads():
    """Sixteen threads ask ``ops/window_attention.py::cached`` for one entry
    at once, with a short switch interval: ``make`` runs once and every
    thread gets its result (a check-then-fill without the lock builds it
    in several threads)."""
    import sys
    import threading
    import time

    from reslic_tcm_tpu_torch.ops.window_attention import cached

    owner = torch.nn.Linear(4, 4)
    calls, got = [], []

    def make():
        calls.append(1)
        time.sleep(0.01)
        return object()

    barrier = threading.Barrier(16)

    def ask():
        barrier.wait(10)
        with torch.no_grad():  # grad mode is per thread: the cached branch
            got.append(cached(owner, "weights", owner.parameters(), make))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 16 and all(g is got[0] for g in got)
