"""Frame statistics and profiling hooks: the port's copy of
``ash_renderer_tpu/utils/profiling.py``.

``FrameStats`` keeps the host wall clock per frame and per dispatch and the
pipeline counters of the last frame; ``trace`` records a ``torch.profiler``
Chrome trace around a block; ``Timer`` sums named scopes, on the device
clock (CUDA events) for a CUDA device and on the host's wall clock
otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class FrameStats:
    def __init__(self, window: int = 120):
        self.window = window
        self.frame_times: list[float] = []
        self.dispatch_times: list[float] = []
        self.counters: dict = {}
        self.n_frames = 0

    def record_dispatch(self, dt: float) -> None:
        self.dispatch_times.append(dt)
        del self.dispatch_times[: -self.window]

    def record_frame(self, dt: float, aux=None) -> None:
        self.n_frames += 1
        self.frame_times.append(dt)
        del self.frame_times[: -self.window]
        if aux is not None:
            for k in ("n_valid", "n_clipped", "clip_overflow",
                      "pairs_total", "pairs_overflow"):
                if k in aux:
                    self.counters[k] = aux[k]  # device scalars; read lazily

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / max(sum(self.frame_times), 1e-9)

    def summary(self) -> dict:
        """Stats snapshot.  The pipeline counters are tensors of the last
        frame; reading one on the card waits for that frame."""
        out = {
            "frames": self.n_frames,
            "fps_host_loop": round(self.fps, 2),
            "avg_dispatch_ms": round(
                1000 * float(np.mean(self.dispatch_times)), 3
            )
            if self.dispatch_times
            else None,
        }
        for k, v in self.counters.items():
            out[k] = int(v)
        return out


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def trace(path: str, device=None):
    """Record a ``torch.profiler`` trace of the block (host ops, and the
    card's kernels and copies when ``device`` is a CUDA device) and write it
    to ``path`` as a Chrome trace (JSON).  The profiler is yielded, so its
    ``key_averages()`` can be read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _is_cuda(device):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if _is_cuda(device):
            torch.cuda.synchronize(device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


class Timer:
    """Named scopes, summed per name in seconds (``times``).  With a CUDA
    ``device`` a scope is a pair of CUDA events on the device's current
    stream, read when ``times`` is; a wall clock around launches that do
    not wait would time only the host.  Otherwise the host's wall clock."""

    def __init__(self, device=None):
        self.device = torch.device(device) if _is_cuda(device) else None
        self._times: dict[str, float] = {}
        self._pending: list = []  # (name, start event, end event)

    @contextlib.contextmanager
    def scope(self, name: str):
        if self.device is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, time.perf_counter() - t0)
            return
        stream = torch.cuda.current_stream(self.device)
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record(stream)
        try:
            yield
        finally:
            b.record(stream)
            self._pending.append((name, a, b))

    def _add(self, name: str, dt: float) -> None:
        self._times[name] = self._times.get(name, 0.0) + dt

    @property
    def times(self) -> dict:
        """{name: seconds}; waits for the device scopes still pending."""
        for name, a, b in self._pending:
            b.synchronize()
            self._add(name, a.elapsed_time(b) / 1e3)
        self._pending.clear()
        return self._times
