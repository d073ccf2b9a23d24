"""Host-side 4x4 matrix math matching the reference's nalgebra semantics.

The port's own copy of ``ash_renderer_tpu/mathx.py``, function for function
and expression for expression, so both packages build the same matrix bits.

The reference renderer computes its camera matrices on the host with nalgebra
(``src/renderer/camera.rs:48-62``) and uploads them as a 192-byte uniform block
each frame (``src/renderer.rs:431-439``).  We mirror that split: these builders
run on the host in float32 numpy and the resulting matrices are the only
per-frame host->device traffic.

Conventions (all matching the reference):

* Matrices are row-major ``(4, 4)`` float32; points are column vectors, so a
  point transforms as ``M @ [x, y, z, 1]``.
* ``look_at_rh`` reproduces nalgebra's ``Matrix4::look_at_rh``
  (gluLookAt-style right-handed view matrix).
* ``perspective`` reproduces nalgebra's ``Perspective3::to_homogeneous``:
  OpenGL-style clip volume, ``z_ndc in [-1, 1]`` between znear and zfar,
  ``w_clip = -z_view``.
* ``NEGATIVE_Y`` is the Vulkan Y-flip the reference pre-multiplies onto the
  view matrix (``camera.rs:51-58``).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "IDENTITY",
    "NEGATIVE_Y",
    "look_at_rh",
    "perspective",
    "translation",
    "rotation_x",
    "rotation_y",
    "rotation_z",
    "scaling",
    "compose",
    "normalize",
]

_F32 = np.float32

IDENTITY: np.ndarray = np.eye(4, dtype=_F32)

# Vulkan clip-space Y flip (camera.rs:51-58).
NEGATIVE_Y: np.ndarray = np.diag(np.array([1.0, -1.0, 1.0, 1.0], dtype=_F32))


def normalize(v: np.ndarray) -> np.ndarray:
    """Normalize a vector in float32."""
    v = np.asarray(v, dtype=_F32)
    n = np.sqrt(np.sum(v * v, dtype=_F32))
    return (v / n).astype(_F32)


def look_at_rh(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed look-at view matrix (nalgebra ``look_at_rh`` semantics).

    The camera looks from ``eye`` toward ``target``; the resulting view space
    is right-handed with the view direction along -Z.
    """
    eye = np.asarray(eye, dtype=_F32)
    f = normalize(np.asarray(target, dtype=_F32) - eye)
    s = normalize(np.cross(f, np.asarray(up, dtype=_F32)).astype(_F32))
    u = np.cross(s, f).astype(_F32)
    m = np.eye(4, dtype=_F32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye).astype(_F32)
    m[1, 3] = -np.dot(u, eye).astype(_F32)
    m[2, 3] = np.dot(f, eye).astype(_F32)
    return m


def perspective(aspect: float, fovy: float, znear: float, zfar: float) -> np.ndarray:
    """Perspective projection matching nalgebra ``Perspective3::to_homogeneous``.

    ``fovy`` is in radians.  NOTE: the reference passes ``45.0`` here
    (``camera.rs:35``) even though the API expects radians, yielding an
    effective vertical FOV of ~58.3 deg (tan(22.5 rad) = tan(22.5 - 7*pi)).
    We preserve that behavior exactly by applying the same formula to whatever
    value is given; ``Camera`` documents the quirk.

    Produces an OpenGL-style clip volume: ``z_ndc = -1`` at znear, ``+1`` at
    zfar, ``w_clip = -z_view``.  Under Vulkan's clip rule (0 <= z_c <= w_c)
    the front half of that range is clipped; see ``ops/geometry.py`` for how the
    rasterizer reproduces those exact clip semantics.
    """
    f = _F32(1.0) / np.tan(_F32(fovy) / _F32(2.0), dtype=_F32)
    m = np.zeros((4, 4), dtype=_F32)
    m[0, 0] = f / _F32(aspect)
    m[1, 1] = f
    m[2, 2] = -(_F32(zfar) + _F32(znear)) / (_F32(zfar) - _F32(znear))
    m[2, 3] = -(_F32(2.0) * _F32(zfar) * _F32(znear)) / (_F32(zfar) - _F32(znear))
    m[3, 2] = _F32(-1.0)
    return m


def translation(t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=_F32)
    m[:3, 3] = np.asarray(t, dtype=_F32)
    return m


def _rot(c: float, s: float, axis: int) -> np.ndarray:
    m = np.eye(4, dtype=_F32)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c
    m[i, j] = -s
    m[j, i] = s
    m[j, j] = c
    return m


def rotation_x(angle: float) -> np.ndarray:
    return _rot(_F32(np.cos(angle)), _F32(np.sin(angle)), 0)


def rotation_y(angle: float) -> np.ndarray:
    return _rot(_F32(np.cos(angle)), _F32(np.sin(angle)), 1)


def rotation_z(angle: float) -> np.ndarray:
    return _rot(_F32(np.cos(angle)), _F32(np.sin(angle)), 2)


def scaling(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, dtype=_F32), (3,))
    m = np.eye(4, dtype=_F32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def compose(*mats: np.ndarray) -> np.ndarray:
    """Left-to-right matrix product in float32: compose(A, B, C) = A @ B @ C."""
    out = np.eye(4, dtype=_F32)
    for m in mats:
        out = (out @ np.asarray(m, dtype=_F32)).astype(_F32)
    return out
