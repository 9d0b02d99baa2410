"""The port's host-side entry layer on the CPU: the Pillow-free PNG and PPM
reader and writer (``data/png.py``), both CLIs with Pillow blocked, the
eval CLI on the train CLI's checkpoints, the corpus writer
(``data/synthetic.py::generate_corpus``) and the plotting and profiling
tools against the JAX package's.

Tolerances: decoded pixels equal Pillow's ``convert("RGB")`` exactly; the
corpus equals the JAX writer's pixel for pixel; the CLI's averages equal
``evaluate()``'s to the printed digits; the plotted staircases equal JAX's
within 1e-6.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_threads import one_torch_thread  # noqa: E402,F401

from reslic_tcm_tpu_torch.cli import eval as peval  # noqa: E402
from reslic_tcm_tpu_torch.cli import train as ptrain  # noqa: E402
from reslic_tcm_tpu_torch.data import datasets as pdata  # noqa: E402
from reslic_tcm_tpu_torch.data import png  # noqa: E402
from reslic_tcm_tpu_torch.data.synthetic import generate_corpus, synth_image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_TCM = ["--N", "32", "--M", "80"]


def _pixels_by_pillow(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _test_image(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 RGB: smooth ramps in the upper rows, noise in the lower, so that
    an adaptive encoder picks several row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = np.stack([(3 * xx + 2 * yy) % 256, (xx * yy) % 256, (5 * yy + xx) % 256], -1)
    noise = rng.integers(0, 256, (h, w, 3))
    img = np.where((yy < h // 2)[..., None], ramp + rng.integers(-2, 3, (h, w, 3)), noise)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow_png(path, mode: str, h: int, w: int, seed: int, optimize: bool) -> None:
    from PIL import Image

    rgb = _test_image(h, w, seed)
    alpha = np.random.default_rng(seed + 1).integers(0, 256, (h, w, 1), dtype=np.uint8)
    kw = {"optimize": True} if optimize else {}
    if mode == "RGB":
        im = Image.fromarray(rgb)
    elif mode == "RGBA":
        im = Image.fromarray(np.concatenate([rgb, alpha], -1))
    elif mode == "L":
        im = Image.fromarray(rgb).convert("L")
    elif mode == "LA":
        im = Image.fromarray(np.concatenate([rgb, alpha], -1)).convert("LA")
    elif mode == "P":
        im = Image.fromarray(rgb).quantize(colors=200)
    elif mode == "P4":
        im, kw["bits"] = Image.fromarray(rgb).quantize(colors=16), 4
    elif mode == "P+tRNS":
        im, kw["transparency"] = Image.fromarray(rgb).quantize(colors=64), 3
    im.save(path, **kw)


def _filter_types(path) -> set:
    """The row filters a non-interlaced PNG file's rows use."""
    data = open(path, "rb").read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, colour = header[:4]
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    stride = (w * channels * depth + 7) // 8
    raw = zlib.decompress(idat)
    return {raw[r * (stride + 1)] for r in range(h)}


MODES = ["RGB", "RGBA", "L", "LA", "P", "P4", "P+tRNS"]
SIZES = [(5, 1), (1, 9), (23, 37), (64, 61)]


# ------------------------------- PNG reading --------------------------------


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_read_png_equals_pillow_convert_rgb(tmp_path, mode, size, optimize):
    path = tmp_path / "a.png"
    _pillow_png(path, mode, *size, seed=sum(size), optimize=optimize)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (*size, 3)
    np.testing.assert_array_equal(got, _pixels_by_pillow(path))


def _filtered_with(img: np.ndarray, ftype: int) -> bytes:
    """Every row of uint8 RGB ``img`` under row filter ``ftype`` (PNG
    specification, section 9.2), with its type byte."""
    x = img.reshape(img.shape[0], -1).astype(np.int32)
    a = np.zeros_like(x)
    a[:, 3:] = x[:, :-3]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 3:] = x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth][ftype]
    rows = ((x - pred) % 256).astype(np.uint8)
    return np.concatenate([np.full((len(x), 1), ftype, np.uint8), rows], 1).tobytes()


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_read_png_undoes_each_row_filter(tmp_path, ftype):
    """A file whose every row takes one filter (Pillow's own files never
    chose Average in these cases) reads as Pillow reads it."""
    img = _test_image(29, 31, ftype)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(31, 29, 8, 2, 0, _filtered_with(img, ftype)))
    assert _filter_types(path) == {ftype}
    np.testing.assert_array_equal(_pixels_by_pillow(path), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def _pillow_synthetic(path, h: int, w: int, seed: int = 0) -> np.ndarray:
    from PIL import Image

    img = (synth_image(np.random.default_rng(seed), h, w) * 255).round().astype(np.uint8)
    Image.fromarray(img).save(path)
    return img


def test_read_png_of_a_synthetic_768x512_image_takes_under_200_ms(tmp_path):
    path = tmp_path / "synth.png"
    want = _pillow_synthetic(path, 512, 768)
    assert 4 in _filter_types(path)  # Paeth, the filter that runs along the row
    np.testing.assert_array_equal(png.read_png(path), want)  # also builds the unfilter
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        png.read_png(path)
        best = min(best, time.perf_counter() - t0)
    assert best <= 0.2, best


def _png_bytes(width, height, depth, colour, interlace, rows: bytes) -> bytes:
    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _flipped_crc(tmp_path) -> bytes:
    png.write_png(tmp_path / "ok.png", _test_image(4, 4, 0))
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[8 + 8 + 13] ^= 0x01  # IHDR's CRC
    return bytes(data)


@pytest.mark.parametrize("case, match", [
    ("16-bit", "16-bit"),
    ("interlaced", "interlaced"),
    ("crc", "CRC"),
    ("zlib", "corrupt PNG stream"),
    ("filter", "filter type 7"),
])
def test_read_png_refuses_what_it_does_not_read(tmp_path, case, match):
    if case == "16-bit":
        data = _png_bytes(2, 2, 16, 2, 0, (b"\x00" + bytes(12)) * 2)
    elif case == "interlaced":
        data = _png_bytes(2, 2, 8, 2, 1, bytes(7) * 2)
    elif case == "crc":
        data = _flipped_crc(tmp_path)
    elif case == "zlib":
        good = _png_bytes(2, 2, 8, 2, 0, bytes(7) * 2)
        body = b"not a zlib stream"
        idat = (struct.pack(">I", len(body)) + b"IDAT" + body
                + struct.pack(">I", zlib.crc32(b"IDAT" + body)))
        start = good.index(b"IDAT") - 4
        end = good.index(b"IEND") - 4
        data = good[:start] + idat + good[end:]
    else:
        data = _png_bytes(2, 2, 8, 2, 0, b"\x07" + bytes(6) + b"\x00" + bytes(6))
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        png.read_png(path)
    assert "bad.png" in str(err.value)


# ------------------------------- PNG writing --------------------------------


@pytest.mark.parametrize("size", [(1, 1), (7, 1), (1, 5), (31, 17), (96, 128)])
def test_write_png_round_trips_through_read_png_and_pillow(tmp_path, size):
    img = _test_image(*size, seed=size[0])
    path = tmp_path / "w.png"
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(_pixels_by_pillow(path), img)


def test_write_png_keeps_a_synthetic_image_and_uses_several_filters(tmp_path):
    img = (synth_image(np.random.default_rng(4), 96, 80) * 255).round().astype(np.uint8)
    path = tmp_path / "s.png"
    png.write_png(path, img)
    assert len(_filter_types(path)) > 1
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(_pixels_by_pillow(path), img)


def test_write_png_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError, match="uint8 RGB"):
        png.write_png(tmp_path / "x.png", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8 RGB"):
        png.write_png(tmp_path / "x.png", np.zeros((4, 4), np.uint8))


def test_read_ppm_equals_pillow(tmp_path):
    from PIL import Image

    img = _test_image(19, 23, 3)
    Image.fromarray(img).save(tmp_path / "a.ppm")
    np.testing.assert_array_equal(png.read_ppm(tmp_path / "a.ppm"), img)
    np.testing.assert_array_equal(pdata.read_image_u8(tmp_path / "a.ppm"), img)
    # a comment in the header, as other writers put one
    (tmp_path / "b.ppm").write_bytes(b"P6\n# made by hand\n23 19\n255\n" + img.tobytes())
    np.testing.assert_array_equal(png.read_ppm(tmp_path / "b.ppm"), img)
    (tmp_path / "c.ppm").write_bytes(b"P6\n23 19\n65535\n" + bytes(23 * 19 * 6))
    with pytest.raises(ValueError, match="maxval 65535"):
        png.read_ppm(tmp_path / "c.ppm")


# ---------------------------- Pillow blocked (C5) ----------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A port-written corpus: 2 train images of 128x128, 2 test images of
    176x192 (MS-SSIM needs sides above 160)."""
    root = str(tmp_path_factory.mktemp("corpus"))
    return generate_corpus(root, n_train=2, n_test=2, train_size=(128, 128),
                           test_size=(176, 192), seed=0)


def _block_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401


def _averages(out: str) -> list[str]:
    return [line for line in out.splitlines()
            if line.startswith(("average_PSNR", "average_MS-SSIM", "average_Bit-rate"))]


def test_clis_read_png_with_pillow_blocked(corpus, monkeypatch, capsys, tmp_path):
    test_dir = os.path.join(corpus, "test", "data")
    argv = ["--data", test_dir, "--platform", "cpu", "--real", *TINY_TCM]
    assert peval.main(argv) == 0
    with_pillow = _averages(capsys.readouterr().out)
    assert len(with_pillow) == 3

    _block_pillow(monkeypatch)
    first = pdata.list_images(test_dir)[0]
    np.testing.assert_array_equal(pdata.read_image(first),
                                  png.read_png(first).astype(np.float32) / 255.0)
    from reslic_tcm_tpu_torch.utils.helper import read_image

    np.testing.assert_array_equal(read_image(first), pdata.read_image(first))
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ImportError, match="a.jpg.*without it"):
        pdata.read_image(tmp_path / "a.jpg")
    assert peval.main(argv) == 0
    assert _averages(capsys.readouterr().out) == with_pillow
    assert ptrain.main(["--platform", "cpu", "-m", "tcm", "--N", "32", "-d", corpus,
                        "--patch-size", "128", "128", "--test-batch-size", "1",
                        "--lambda_list", "0.013", "--kodak", "none", "--tester"]) == 0
    assert "valid epoch 0" in capsys.readouterr().out


# -------------------- the train CLI's checkpoints in eval (C6) ---------------------


def test_eval_cli_loads_the_train_clis_checkpoint(corpus, tmp_path, capsys):
    from reslic_tcm_tpu_torch.models.tcm import make_tcm
    from reslic_tcm_tpu_torch.utils.checkpoint import load_checkpoint

    # the registry's TCM has M=320, as JAX's (the train CLI takes --N only)
    save = tmp_path / "runs"
    assert ptrain.main(["--platform", "cpu", "-m", "tcm", "--N", "32", "-d", corpus,
                        "--patch-size", "128", "128", "--batch-size", "2",
                        "--test-batch-size", "1", "--lambda_list", "0.013", "-e", "1",
                        "--save_path", str(save), "--kodak", "none", "--seed", "1"]) == 0
    ckpts = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(save) for f in fs
                   if f.endswith("_very_best.ckpt"))
    assert len(ckpts) == 1
    capsys.readouterr()
    test_dir = os.path.join(corpus, "test", "data")
    assert peval.main(["--data", test_dir, "--platform", "cpu", "--real", "--N", "32",
                       "--M", "320", "--checkpoint", ckpts[0]]) == 0
    cli = _averages(capsys.readouterr().out)

    codec = make_tcm(N=32, M=320, device="cpu")
    codec.module.load_state_dict(load_checkpoint(ckpts[0])["state_dict"], strict=True)
    fresh = make_tcm(N=32, M=320, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(codec.module.parameters(),
                                                     fresh.module.parameters()))
    codec.update()
    lines = []
    summary = peval.evaluate(codec, [pdata.read_image(p) for p in pdata.list_images(test_dir)],
                             real=True, log=lines.append)
    assert all(r["y_hat_exact"] for r in summary["records"])
    assert cli == _averages("\n".join(lines))

    with pytest.raises(NotImplementedError, match="orbax"):
        peval.load_checkpoint(make_tcm(N=32, M=320, device="cpu"), str(tmp_path))


# ---------------------------- the corpus writer (A18) -----------------------------

CORPUS_ARGS = dict(n_train=3, n_test=2, train_size=(64, 96), test_size=(48, 80), seed=1)


def _listing(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def test_generate_corpus_writes_the_jax_writers_files(tmp_path):
    from reslic_tcm_tpu.data.synthetic import generate_corpus as jax_generate_corpus

    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_generate_corpus(jroot, **CORPUS_ARGS) == jroot
    assert generate_corpus(proot, **CORPUS_ARGS) == proot
    names = _listing(jroot)
    assert names == _listing(proot) and len(names) == 5
    for name in names:
        want = _pixels_by_pillow(os.path.join(jroot, name))
        for read in (_pixels_by_pillow, png.read_png):
            np.testing.assert_array_equal(read(os.path.join(proot, name)), want)
        np.testing.assert_array_equal(png.read_png(os.path.join(jroot, name)), want)


@pytest.mark.parametrize("skip_existing", [True, False])
def test_generate_corpus_skips_existing_files_as_jax_does(tmp_path, skip_existing):
    """A file already there is kept under skip_existing (JAX's default) and
    rewritten without it, by both writers."""
    from reslic_tcm_tpu.data.synthetic import generate_corpus as jax_generate_corpus

    args = dict(n_train=2, n_test=1, train_size=(64, 64), test_size=(64, 64), seed=3)
    stale = _test_image(64, 64, 9)
    kept = {}
    for tag, write in (("jax", jax_generate_corpus), ("port", generate_corpus)):
        root = str(tmp_path / tag)
        write(root, **args)
        path = os.path.join(root, "train", "data", "synth_00000.png")
        fresh = png.read_png(path)
        png.write_png(path, stale)
        write(root, skip_existing=skip_existing, **args)
        kept[tag] = png.read_png(path)
        np.testing.assert_array_equal(kept[tag], stale if skip_existing else fresh)
    np.testing.assert_array_equal(kept["jax"], kept["port"])


def test_corpus_writer_main_runs_as_a_module(tmp_path):
    """``python -m reslic_tcm_tpu_torch.data.synthetic <root> <n_train>``
    prints the root; the 24 test images are made to exist first, so it only
    writes the one train image (512x512), JAX's pixel for pixel."""
    from reslic_tcm_tpu.data.synthetic import generate_corpus as jax_generate_corpus

    root = tmp_path / "corpus"
    test_dir = root / "test" / "data"
    test_dir.mkdir(parents=True)
    for i in range(24):
        (test_dir / f"synth_{i:05d}.png").write_bytes(b"")
    out = subprocess.run([sys.executable, "-m", "reslic_tcm_tpu_torch.data.synthetic",
                          str(root), "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out == f"{root}\n"
    assert _listing(root / "train") == ["data/synth_00000.png"]
    jroot = str(tmp_path / "jax")
    jax_generate_corpus(jroot, n_train=1, n_test=0)
    np.testing.assert_array_equal(png.read_png(root / "train" / "data" / "synth_00000.png"),
                                  png.read_png(os.path.join(jroot, "train", "data",
                                                            "synth_00000.png")))


# ------------------------- plotting and profiling (A17) --------------------------


def _drawn(fig) -> dict:
    ax = fig.axes[0]
    out = {f"line{i}": (np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
           for i, ln in enumerate(ax.lines)}
    out.update({f"scatter{i}": np.asarray(c.get_offsets()) for i, c in enumerate(ax.collections)})
    out["title"] = ax.get_title()
    out["labels"] = [ln.get_label() for ln in ax.lines]
    return out


@pytest.mark.parametrize("num_sigmoids, extrema, symmetric, beta, uneven", [
    (0, 5, False, 10.0, False), (4, 8, True, 3.5, True)])
def test_plot_sos_draws_what_jax_draws(num_sigmoids, extrema, symmetric, beta, uneven):
    import matplotlib.pyplot as plt

    from reslic_tcm_tpu.entropy.stanh import init_w_b
    from reslic_tcm_tpu.utils.plotting import plot_sos as jax_plot_sos
    from reslic_tcm_tpu_torch.utils.plotting import plot_sos

    w, b = init_w_b(num_sigmoids, extrema, symmetric)
    if uneven:  # a trained staircase's steps differ
        w = w * np.linspace(0.8, 1.2, len(w), dtype=np.float32)
    got, want = (_drawn(f) for f in (plot_sos(w, b, symmetric, beta, lv=2),
                                     jax_plot_sos(w, b, symmetric, beta, lv=2)))
    plt.close("all")
    assert got.keys() == want.keys() and len(got) == 5  # hard, soft, levels, title, labels
    for key in ("line0", "line1"):
        for g, j in zip(got[key], want[key]):
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["scatter0"], want["scatter0"], rtol=0, atol=1e-6)
    assert got["title"] == want["title"] and got["labels"] == want["labels"]


def test_plot_rate_distorsion_draws_what_jax_draws():
    import matplotlib.pyplot as plt

    from reslic_tcm_tpu.utils.plotting import plot_rate_distorsion as jax_plot_rd
    from reslic_tcm_tpu_torch.utils.plotting import plot_rate_distorsion

    bpp = {"a": [0.4, 0.1, 0.2], "b": [0.3, 0.5], "c": [0.2]}
    psnr = {"a": [31.0, 27.0, 29.0], "b": [30.0, 32.5]}
    got, want = _drawn(plot_rate_distorsion(bpp, psnr, 3)), _drawn(jax_plot_rd(bpp, psnr, 3))
    plt.close("all")
    assert got.keys() == want.keys()
    for key in got:
        if key.startswith("line"):
            for g, j in zip(got[key], want[key]):
                np.testing.assert_array_equal(g, j)
    assert got["title"] == want["title"] and got["labels"] == want["labels"] == ["a", "b"]


def test_rd_plot_cli_writes_a_figure(tmp_path, capsys):
    import json

    from reslic_tcm_tpu.cli import rd_plot as jax_rd_plot
    from reslic_tcm_tpu_torch.cli import rd_plot

    assert rd_plot.REFERENCE_CURVES == jax_rd_plot.REFERENCE_CURVES
    curve = tmp_path / "mine.json"
    curve.write_text(json.dumps({"name": "mine", "bpp": [0.2, 0.4], "psnr": [28.0, 31.0]}))
    out = tmp_path / "rd.png"
    assert rd_plot.main(["--include-reference", "--curves", str(curve), "--output", str(out),
                         "--title", "t"]) == 0
    assert out.stat().st_size > 0 and f"saved {out}" in capsys.readouterr().out
    assert png.read_png(out).ndim == 3  # matplotlib's PNG reads without Pillow too
    with pytest.raises(SystemExit):
        rd_plot.main(["--output", str(out)])


def test_timed_and_throughput(capsys):
    from reslic_tcm_tpu_torch.utils.profiling import throughput_mp_s, timed

    res = {}
    with timed("block", results=res) as out:
        out["sync"] = {"a": torch.ones(4) * 2, "b": [torch.zeros(2)]}
    assert res["block"] > 0 and out["seconds"] == res["block"]
    assert capsys.readouterr().out.startswith("[timed] block: ")
    with timed(sync=(torch.ones(2),)) as out:
        pass
    assert out["seconds"] >= 0 and capsys.readouterr().out == ""
    assert abs(throughput_mp_s(2_000_000, 2.0) - 1.0) < 1e-9


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    from reslic_tcm_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tb")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(tmp_path / "tb") for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files
