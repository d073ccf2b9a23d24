"""Debug mode: the port's copy of ``ash_renderer_tpu/utils/debugging.py``,
the framework's analogue of the reference's Vulkan validation layer and
debug messenger.

What remains worth guarding on a frame:

* NaN / Inf escaping the geometry pipeline into visible pixels;
* budget overflows (clip budget, pair budget) silently dropping work;
* out-of-range triangle ids in the visibility buffer;
* divergence from the numpy oracle (the deepest check, opt-in per frame).

``validate_frame`` returns a list of findings from a frame's aux outputs
(tensors on any device, or numpy arrays); ``DebugMessenger`` prints them
with a severity filter.  ``compare_with_oracle`` renders the Renderer's
scene with ``oracle.render_oracle`` and diffs the frames.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

SEVERITIES = ("INFO", "WARNING", "ERROR")


@dataclasses.dataclass
class Finding:
    severity: str
    kind: str
    message: str

    def __str__(self):
        return f"[{self.severity}][{self.kind}] {self.message}"


class DebugMessenger:
    """Collects findings and prints them (stdout, like the reference's
    callback); severity filter defaults to WARNING+."""

    def __init__(self, min_severity: str = "WARNING",
                 sink: Callable[[str], None] = print):
        self.min_severity = min_severity
        self.sink = sink
        self.findings: list[Finding] = []

    def report(self, finding: Finding) -> None:
        self.findings.append(finding)
        if SEVERITIES.index(finding.severity) >= SEVERITIES.index(
            self.min_severity
        ):
            self.sink(str(finding))


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_frame(aux: dict, rgba8=None, messenger: DebugMessenger = None):
    """Check a frame's aux outputs (and, if given, its frame) for anomalies;
    returns findings ("frame clean" when there are none)."""
    messenger = messenger or DebugMessenger(sink=lambda s: None)
    out = []

    def emit(severity, kind, msg):
        f = Finding(severity, kind, msg)
        out.append(f)
        messenger.report(f)

    for key, kind in (
        ("clip_overflow", "clip-budget"),
        ("pairs_overflow", "pair-budget"),
    ):
        if key in aux:
            v = int(_host(aux[key]))
            if v > 0:
                emit(
                    "WARNING",
                    kind,
                    f"{v} items dropped ({key}); raise the budget in "
                    "RendererSettings",
                )
    if "vis_tri" in aux and "n_setup" in aux:
        vt = _host(aux["vis_tri"])
        n_setup = int(_host(aux["n_setup"]))
        bad = int(((vt < -1) | (vt >= n_setup)).sum())
        if bad:
            emit(
                "ERROR",
                "tri-id-range",
                f"{bad} visibility-buffer pixels reference triangle ids "
                f"outside [-1, {n_setup}) — corrupted raster output",
            )
    if rgba8 is not None:
        arr = _host(rgba8)
        if arr.dtype != np.uint8:
            if not np.isfinite(arr).all():
                emit("ERROR", "nan-inf", "non-finite values in framebuffer")
    if not out:
        emit("INFO", "ok", "frame clean")
    return out


def numpy_pack(pack):
    """A dataclass of tensors (MaterialsPack, TextureAtlas, LightPack) as
    the same dataclass of numpy arrays."""
    return type(pack)(**{f.name: _host(getattr(pack, f.name))
                         for f in dataclasses.fields(pack)})


def compare_with_oracle(renderer, camera, model_mats=None) -> list[Finding]:
    """Deep check: render the renderer's scene on its device and with the
    numpy oracle, and diff the RGBA8 frames.  The oracle takes the
    renderer's packed scene, settings and raster config, and its
    materials, atlas and light copied back from the device."""
    from .oracle import render_oracle

    rgba8, _ = renderer.render_frame(camera, model_mats)
    st = renderer.settings
    s = renderer.state
    mm = renderer.scene.model_matrices() if model_mats is None else model_mats
    o = render_oracle(
        renderer.packed,
        np.asarray(mm, np.float32),
        camera.view_matrix(),
        camera.projection_matrix(st.render_width / st.render_height),
        st,
        materials=numpy_pack(s.materials),
        atlas=None if s.atlas is None else numpy_pack(s.atlas),
        light=None if s.light is None else numpy_pack(s.light),
        camera_pos=camera.position.astype(np.float32),
        cfg=renderer.cfg,
    )
    host = renderer.read_frame(rgba8)
    if np.array_equal(host, o["rgba8"]):
        return [Finding("INFO", "oracle", "pixel-exact match")]
    ndiff = int((host != o["rgba8"]).any(axis=-1).sum())
    dmax = int(np.abs(host.astype(int) - o["rgba8"].astype(int)).max())
    return [Finding("ERROR", "oracle",
                    f"{ndiff} pixels differ from CPU oracle (max |d|={dmax})")]
