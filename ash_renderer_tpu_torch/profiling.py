"""Frame statistics: the port's own copy of ``FrameStats`` from
``ash_renderer_tpu/utils/profiling.py`` (host wall clock per frame and per
dispatch, and the pipeline counters of the last frame)."""

from __future__ import annotations

import numpy as np


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
