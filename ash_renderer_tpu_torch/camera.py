"""Camera, semantics-parity with the reference (``src/renderer/camera.rs``).

The port's own copy of ``ash_renderer_tpu/camera.py`` (``Camera`` and
``orbit_path``), expression for expression, so both packages build the same
view and projection matrix bits.

* ``Camera`` holds a position and spherical angles (phi off the vertical axis,
  theta counterclockwise about it), with up = -Y (``camera.rs:34``) and
  ``forward = [sin(phi) sin(theta), -cos(phi), sin(phi) cos(theta)]``
  (``camera.rs:40-47``).
* ``view_matrix`` = NEGATIVE_Y @ look_at_rh(pos, pos + forward, up)
  (``camera.rs:48-59``).
* ``projection_matrix`` = nalgebra-style perspective (``camera.rs:60-62``).

FOV quirk, preserved deliberately: the reference constructs
``Perspective3::new(aspect, fovy=45.0, ...)`` where nalgebra expects radians
(``camera.rs:35``), so the effective vertical FOV is ``2 * atan(tan(22.5))``
~ 58.3 deg, not 45 deg.  ``Camera()`` defaults to the same ``fovy=45.0``
"radians" for output parity; pass ``fovy=math.radians(d)`` for a sane FOV.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import mathx

_F32 = np.float32


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=_F32)
    )
    phi: float = math.pi / 2.0  # angle off vertical axis; 0 is up (camera.rs:9-11)
    theta: float = 0.0  # angle about vertical axis; 0 is +Z (camera.rs:12-14)
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=_F32)
    )
    fovy: float = 45.0  # radians; see module docstring for the preserved quirk
    znear: float = 0.01
    zfar: float = 100.0

    def forward(self) -> np.ndarray:
        sp, cp = math.sin(self.phi), math.cos(self.phi)
        st, ct = math.sin(self.theta), math.cos(self.theta)
        return np.array([sp * st, -cp, sp * ct], dtype=_F32)

    def view_matrix(self) -> np.ndarray:
        look = mathx.look_at_rh(
            self.position, self.position + self.forward(), self.up
        )
        return (mathx.NEGATIVE_Y @ look).astype(_F32)

    def projection_matrix(self, aspect_ratio: float) -> np.ndarray:
        return mathx.perspective(aspect_ratio, self.fovy, self.znear, self.zfar)


def orbit_path(
    n_frames: int,
    radius: float = 4.0,
    center: np.ndarray | None = None,
    height: float = 0.0,
) -> list[Camera]:
    """A deterministic animated fly-around path for benchmarks (BASELINE
    config 5's "animated camera fly-through"); replaces interactive input."""
    center = (
        np.zeros(3, dtype=_F32) if center is None else np.asarray(center, dtype=_F32)
    )
    cams = []
    for i in range(n_frames):
        ang = 2.0 * math.pi * i / max(n_frames, 1)
        pos = center + np.array(
            [radius * math.sin(ang), height, -radius * math.cos(ang)], dtype=_F32
        )
        cam = Camera(position=pos.astype(_F32), phi=math.pi / 2.0, theta=-ang)
        cams.append(cam)
    return cams
