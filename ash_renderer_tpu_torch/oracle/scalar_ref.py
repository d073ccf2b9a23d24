"""Scalar reference rasterizer: per-pixel Python loops, the bottom tier of
the three-tier validation stack (scalar_ref validates the vectorized numpy
oracle, which validates the device pipeline).  The port's copy of
``ash_renderer_tpu/oracle/scalar_ref.py``.

Deliberately naive: explicit loops, no vectorization, direct transliteration
of the spec (specmath) one pixel at a time.  Only usable for tiny scenes.
"""

from __future__ import annotations

import numpy as np

from ..config import RasterConfig
from ..rtypes import TriangleSetup
from . import specmath_np as sm

F32 = np.float32
I32 = np.int32


def visibility_scalar(su: TriangleSetup, cfg: RasterConfig):
    """Loop over every pixel x every valid triangle; returns (d16, tri)."""
    h, w = cfg.height, cfg.width
    vis_d = np.full((h, w), sm.DEPTH_MAX, dtype=I32)
    vis_t = np.full((h, w), sm.BG_TRI, dtype=I32)
    ss = cfg.subpixel_scale
    valid_rows = [int(t) for t in np.nonzero(su.valid)[0]]

    for py in range(h):
        for px in range(w):
            sx, sy = sm.pixel_sample_coords(px, py, ss)
            best_d, best_t = int(vis_d[py, px]), int(vis_t[py, px])
            for t in valid_rows:
                x0, y0 = int(su.x0[t]), int(su.y0[t])
                x1, y1 = int(su.x1[t]), int(su.y1[t])
                x2, y2 = int(su.x2[t]), int(su.y2[t])
                covered = True
                es = []
                for (xa, ya, xb, yb) in (
                    (x1, y1, x2, y2),
                    (x2, y2, x0, y0),
                    (x0, y0, x1, y1),
                ):
                    dx, dy = xb - xa, yb - ya
                    e = -dy * (sx - xa) + dx * (sy - ya)
                    top_left = (dy == 0 and dx > 0) or dy < 0
                    if not (e > 0 or (e == 0 and top_left)):
                        covered = False
                        break
                    es.append(e)
                if not covered:
                    continue
                e0, e1, e2 = es
                d16 = int(
                    sm.interp_depth16(
                        np.int32(e0), np.int32(e1), np.int32(e2),
                        su.inv_area2[t],
                        su.zq0[t], su.zq1[t], su.zq2[t],
                    )
                )
                if d16 < best_d or (d16 == best_d and t > best_t):
                    best_d, best_t = d16, t
            vis_d[py, px] = best_d
            vis_t[py, px] = best_t
    return vis_d, vis_t
