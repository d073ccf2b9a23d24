"""Present layer: the frame ring with deferred readback, and a PNG sink.

``FrameRing`` holds ``frames_in_flight`` rendered frames.  On the card a
pushed frame is copied on its device's current CUDA stream into pinned host
memory without waiting; the host blocks on that copy only when the frame leaves
the ring, ``frames_in_flight`` frames later (the swapchain fence analogue of
``ash_renderer_tpu/present.py:FrameRing``).
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


def write_png(path: str, rgba8: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 frame as an 8-bit RGBA PNG, with the
    standard library only (zlib for IDAT, CRC-32 per chunk)."""
    img = np.ascontiguousarray(rgba8, dtype=np.uint8)
    h, w = img.shape[:2]
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 4)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", binascii.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
