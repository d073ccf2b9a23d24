"""Present layer: the frame ring with deferred readback, and the image
sinks of ``ash_renderer_tpu/present.py``.

``FrameRing`` holds ``frames_in_flight`` rendered frames.  On the card a
pushed frame is copied on its device's current CUDA stream into pinned host
memory without waiting; the host blocks on that copy only when the frame leaves
the ring, ``frames_in_flight`` frames later (the swapchain fence analogue of
``ash_renderer_tpu/present.py:FrameRing``).

Sinks: ``write_png`` / ``encode_png`` (a PNG encoder on the standard library
alone, so PNGs and ``HttpViewer``'s live view need no PIL), ``write_ppm``,
``FrameCollector``, ``FrameLimiter``, ``TerminalViewer``, ``HttpViewer`` and
``write_gif`` (PIL, imported when called; without it, ``ImportError``).
"""

from __future__ import annotations

import binascii
import collections
import struct
import zlib
from typing import Callable, Optional

import numpy as np
import torch


class FrameRing:
    """Ring of in-flight frames with deferred blocking readback."""

    def __init__(self, frames_in_flight: int = 2):
        self.frames_in_flight = max(1, frames_in_flight)
        self._ring = collections.deque()

    def push(self, frame: torch.Tensor, on_ready: Optional[Callable] = None):
        """Submit a rendered frame; returns the oldest frame as a host numpy
        array once the ring is full, else None."""
        if frame.device.type == "cuda":
            host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
            stream = torch.cuda.current_stream(frame.device)
            with torch.cuda.stream(stream):
                host.copy_(frame, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        else:
            host, done = frame.clone(), None
        self._ring.append((host, done, on_ready))
        if len(self._ring) > self.frames_in_flight:
            return self._pop_ready()
        return None

    def _pop_ready(self) -> np.ndarray:
        host, done, cb = self._ring.popleft()
        if done is not None:
            done.synchronize()
        out = host.numpy()
        if cb is not None:
            cb(out)
        return out

    def drain(self) -> list:
        """Flush all in-flight frames."""
        out = []
        while self._ring:
            out.append(self._pop_ready())
        return out


def encode_png(rgba8: np.ndarray) -> bytes:
    """An (H, W, 4) uint8 frame as the bytes of an 8-bit RGBA PNG, with the
    standard library only (zlib for IDAT, CRC-32 per chunk)."""
    img = np.ascontiguousarray(rgba8, dtype=np.uint8)
    h, w = img.shape[:2]
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 4)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", binascii.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgba8: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 frame as an 8-bit RGBA PNG (``encode_png``)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba8))


def write_ppm(path: str, rgba8: np.ndarray) -> None:
    """Dependency-free PPM (P6) writer; drops alpha."""
    h, w = rgba8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgba8[..., :3]).tobytes())


class FrameCollector:
    """Collects presented frames in memory (tests, video assembly)."""

    def __init__(self):
        self.frames: list[np.ndarray] = []

    def __call__(self, frame: np.ndarray) -> None:
        self.frames.append(frame)


class FrameLimiter:
    """Present-mode pacing: the reference prefers MAILBOX (uncapped) and
    falls back to FIFO (vsync-capped) — swapchain_components.rs:60-70.
    "mailbox" returns immediately; "fifo" sleeps to hold refresh_rate."""

    def __init__(self, mode: str = "mailbox", refresh_rate: float = 60.0):
        if mode not in ("mailbox", "fifo"):
            raise ValueError(f"unknown present mode {mode!r}")
        self.mode = mode
        self.period = 1.0 / refresh_rate
        self._last = None

    def pace(self) -> None:
        import time

        if self.mode == "mailbox":
            return
        now = time.perf_counter()
        if self._last is not None:
            wait = self.period - (now - self._last)
            if wait > 0:
                time.sleep(wait)
        self._last = time.perf_counter()


class TerminalViewer:
    """Live preview in a terminal using half-block characters — the
    headless stand-in for the reference's winit window (CPU-blit analogue).
    Each character cell shows two pixels via fg/bg 24-bit color."""

    def __init__(self, max_cols: int = 100, stream=None):
        import sys as _sys

        self.max_cols = max_cols
        self.stream = stream or _sys.stdout
        self._first = True

    def __call__(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        step = max(1, (w + self.max_cols - 1) // self.max_cols)
        img = frame[:: 2 * step, ::step, :3]
        top = img[0::2]
        bot = img[1::2][: top.shape[0]]
        top = top[: bot.shape[0]]
        lines = []
        for rt, rb in zip(top, bot):
            line = []
            for (tr, tg, tb_), (br, bg, bb) in zip(rt, rb):
                line.append(
                    f"\x1b[38;2;{tr};{tg};{tb_}m\x1b[48;2;{br};{bg};{bb}m▀"
                )
            lines.append("".join(line) + "\x1b[0m")
        out = "\n".join(lines)
        if not self._first:
            self.stream.write(f"\x1b[{len(lines)}F")  # cursor up, redraw
        self._first = False
        self.stream.write(out + "\n")
        self.stream.flush()


class HttpViewer:
    """Pixel-accurate live view over HTTP — the windowless analogue of the
    reference's winit window (renderer.rs:86-88) for headless hosts: point
    a browser at ``http://localhost:<port>/`` to watch the frame loop live.

    Serves:
      /           a minimal page that re-fetches the frame continuously;
      /frame.png  the LATEST presented frame, lossless PNG (exact bytes —
                  unlike the TerminalViewer's downsampled half-blocks);
      /stats      the renderer's FrameStats summary as JSON (when a stats
                  object is attached).

    Runs a daemon ThreadingHTTPServer; ``__call__(frame)`` (the FrameRing
    on_ready signature) swaps in the newest frame — presents never block
    on encoding (PNG is encoded per request with ``encode_png``, cached by
    frame id)."""

    def __init__(self, port: int = 8400, stats=None):
        import http.server
        import threading

        self.port = port
        self.stats = stats
        self._frame = None
        self._frame_id = 0
        self._png_cache = (None, b"")
        self._lock = threading.Lock()
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    data = viewer._encode_png()
                    if data is None:
                        self.send_error(404, "no frame presented yet")
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/stats"):
                    import json as _json

                    body = _json.dumps(
                        viewer.stats.summary() if viewer.stats else {}
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    body = (
                        b"<!doctype html><title>ash_renderer_tpu_torch</title>"
                        b"<body style='margin:0;background:#111'>"
                        b"<img id=v style='image-rendering:pixelated;"
                        b"width:100vw' src=/frame.png>"
                        b"<script>const v=document.getElementById('v');"
                        b"function n(){const i=new Image();"
                        b"i.onload=()=>{v.src=i.src;requestAnimationFrame(n)};"
                        b"i.onerror=()=>setTimeout(n,250);"
                        b"i.src='/frame.png?'+Date.now()}n()</script>"
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _encode_png(self):
        with self._lock:
            frame, fid = self._frame, self._frame_id
        if frame is None:
            return None
        cid, data = self._png_cache
        if cid == fid:
            return data
        data = encode_png(frame)
        self._png_cache = (fid, data)
        return data

    def __call__(self, frame: np.ndarray) -> None:
        with self._lock:
            self._frame = frame
            self._frame_id += 1

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def write_gif(path: str, frames: list, fps: int = 20) -> None:
    """Animated GIF from RGBA8 frames (flythrough videos) via PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("present.write_gif encodes GIFs with PIL (Pillow), "
                          "which is not installed") from e

    imgs = [Image.fromarray(f, mode="RGBA").convert("P") for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=max(1000 // fps, 20),
        loop=0,
    )
