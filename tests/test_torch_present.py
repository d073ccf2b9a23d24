"""The port's present sinks against the JAX package's: ``write_ppm``,
``TerminalViewer``, ``FrameLimiter``, ``FrameCollector``, ``HttpViewer``
(served with the port's stdlib PNG encoder, PIL blocked) and
``write_gif``."""

import io
import json
import os
import struct
import sys
import time
import urllib.request
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

from ash_renderer_tpu import present as ref_present  # noqa: E402
from ash_renderer_tpu_torch import present  # noqa: E402
from ash_renderer_tpu_torch.profiling import FrameStats  # noqa: E402


def _frames(n=3, h=24, w=32, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(n)]


def decode_png_stdlib(data: bytes) -> np.ndarray:
    """An 8-bit RGBA PNG whose rows all use filter 0 (``encode_png``'s) to
    (H, W, 4) uint8, with zlib alone."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 6)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert not rows[:, 0].any()  # filter 0 on every row
    return rows[:, 1:].reshape(h, w, 4)


def _block_pil(monkeypatch):
    for name in list(sys.modules):
        if name == "PIL" or name.startswith("PIL."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("shape", [(24, 32), (1, 1), (7, 13)])
def test_write_ppm_matches_reference(tmp_path, shape):
    f = _frames(1, *shape)[0]
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    present.write_ppm(a, f)
    ref_present.write_ppm(b, f)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("shape,max_cols", [((24, 32), 100), ((48, 64), 20),
                                             ((9, 7), 3)])
def test_terminal_viewer_matches_reference(shape, max_cols):
    """The same half-block text, first frame and redraws alike."""
    frames = _frames(3, *shape)
    a, b = io.StringIO(), io.StringIO()
    va = present.TerminalViewer(max_cols=max_cols, stream=a)
    vb = ref_present.TerminalViewer(max_cols=max_cols, stream=b)
    for f in frames:
        va(f)
        vb(f)
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().count("\x1b[") > len(frames)


def test_frame_collector_and_ring():
    coll = present.FrameCollector()
    ring = present.FrameRing(frames_in_flight=2)
    frames = _frames(5, 4, 4)
    import torch

    for f in frames:
        ring.push(torch.from_numpy(f), coll)
    assert len(ring.drain()) == 2
    assert len(coll.frames) == 5
    for got, want in zip(coll.frames, frames):
        tp.same_bits(got, want)


def test_frame_limiter_modes(monkeypatch):
    """mailbox never waits; fifo sleeps out the rest of each period; an
    unknown mode raises, as the reference's does."""
    with pytest.raises(ValueError):
        present.FrameLimiter("immediate")
    with pytest.raises(ValueError):
        ref_present.FrameLimiter("immediate")
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    mb = present.FrameLimiter("mailbox", refresh_rate=100.0)
    for _ in range(3):
        mb.pace()
    assert slept == []
    fifo = present.FrameLimiter("fifo", refresh_rate=100.0)
    fifo.pace()  # first frame: nothing to wait for
    assert slept == []
    fifo.pace()  # right after: sleeps out the rest of the 10 ms period
    assert len(slept) == 1 and 0.0 < slept[0] <= 0.01
    assert fifo.period == pytest.approx(0.01)


def test_encode_png_and_write_png(tmp_path):
    """encode_png decodes (PIL and the stdlib inflate alike) to the frame;
    write_png writes encode_png's bytes."""
    from PIL import Image

    for f in _frames(2, 17, 9) + [np.zeros((1, 1, 4), np.uint8)]:
        data = present.encode_png(f)
        tp.same_bits(decode_png_stdlib(data), f)
        tp.same_bits(np.asarray(Image.open(io.BytesIO(data))), f)
        path = str(tmp_path / "f.png")
        present.write_png(path, f)
        assert open(path, "rb").read() == data


def test_http_viewer_pixel_exact_without_pil(monkeypatch):
    """HttpViewer serves the latest presented frame as a lossless PNG made
    by encode_png, with PIL blocked: /frame.png decodes to the frame byte
    for byte, 404 before any frame, /stats JSON, / the page."""
    _block_pil(monkeypatch)
    stats = FrameStats()
    v = present.HttpViewer(port=0, stats=stats)
    try:
        url = f"http://127.0.0.1:{v.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/frame.png", timeout=10)
        assert e.value.code == 404
        f1, f2 = _frames(2)
        v(f1)
        v(f2)  # latest wins
        data = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        tp.same_bits(decode_png_stdlib(data), f2)
        assert data == present.encode_png(f2)
        assert json.loads(urllib.request.urlopen(f"{url}/stats",
                                                 timeout=10).read())[
            "frames"] == 0
        assert b"frame.png" in urllib.request.urlopen(url, timeout=10).read()
    finally:
        v.close()


def test_write_gif_matches_reference(tmp_path):
    """write_gif's decoded frames equal the reference's."""
    from PIL import Image, ImageSequence

    frames = _frames(3, 16, 20)
    a, b = str(tmp_path / "a.gif"), str(tmp_path / "b.gif")
    present.write_gif(a, frames, fps=10)
    ref_present.write_gif(b, frames, fps=10)

    def decode(p):
        with Image.open(p) as im:
            return [(np.asarray(fr.convert("RGBA")), fr.info.get("duration"))
                    for fr in ImageSequence.Iterator(im)]

    da, db = decode(a), decode(b)
    assert len(da) == len(db) == 3
    for (fa, ta), (fb, tb) in zip(da, db):
        tp.same_bits(fa, fb)
        assert ta == tb == 100


def test_write_gif_without_pil_raises(tmp_path, monkeypatch):
    _block_pil(monkeypatch)
    with pytest.raises(ImportError, match="present.write_gif"):
        present.write_gif(str(tmp_path / "x.gif"), _frames(1))
    assert not os.path.exists(tmp_path / "x.gif")
