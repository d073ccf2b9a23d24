"""CPU reference rasterizer (numpy): the port's executable spec and parity
oracle, a copy of ``ash_renderer_tpu/oracle/raster_cpu.py`` that imports
neither jax nor the port's torch code.

The same semantic contract as the device pipelines, with an independent,
simple structure: a Python loop over triangles (Sutherland-Hodgman
clipping per polygon, per-triangle AABB raster) instead of the device's
budgeted vectorized clipper and tiled kernels.  The formulas come from
``specmath_np`` and shading from ``shade_np``, numpy copies of the
reference's; the device follows the same formulas in torch and CUDA.

Stage outputs mirror the device pipeline so tests can compare each stage:
geometry (``TriangleSetup`` of numpy arrays + the combined attribute
table), visibility ((d16, tri_id) per pixel), shading, pack.
"""

from __future__ import annotations

import numpy as np

from ..config import RasterConfig, RendererSettings, derive_raster_config
from ..rtypes import TriangleSetup
from ..scene import PackedScene
from . import shade_np
from . import specmath_np as sm

F32 = np.float32
I32 = np.int32


def compose_mvp(model_mats: np.ndarray, view: np.ndarray, proj: np.ndarray):
    """Per-object MVP = P @ V @ M in float32 on the host, once per frame
    per object.  The oracle and the device (``Renderer``) both start from
    these bits."""
    vp = (np.asarray(proj, dtype=F32) @ np.asarray(view, dtype=F32)).astype(F32)
    return np.einsum("ij,ojk->oik", vp, np.asarray(model_mats, F32)).astype(F32)

# Combined per-vertex attribute channel layout (also used by the device path):
# [0:4] color RGBA, [4:7] world-space normal, [7:9] uv, [9:12] world position.
ATTR_COLS = 12
MAX_CLIP_VERTS = 9  # 3 vertices + one added per clip plane (6 planes)
MAX_CLIP_TRIS = MAX_CLIP_VERTS - 2


def _plane_dists(c: np.ndarray, gx: float, gy: float) -> np.ndarray:
    """Signed distances of clip-space vertices (..., 4) to the 6 clip planes.

    Order (part of the spec): near (z >= 0, Vulkan's z_c >= 0 rule), far
    (z <= w), left/right guard (|x| <= gx*w), top/bottom guard (|y| <= gy*w).
    The guard planes extend the screen by guard_px so that slightly-offscreen
    triangles skip clipping entirely (scissoring handles them), keeping the
    clip path rare — the analogue of GPU guard-band clipping.
    """
    x, y, z, w = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    gx = F32(gx)
    gy = F32(gy)
    return np.stack(
        [z, w - z, gx * w + x, gx * w - x, gy * w + y, gy * w - y], axis=-1
    )


def _screen_dists(c: np.ndarray) -> np.ndarray:
    """Signed distances to the 4 SCREEN side planes (|x| <= w, |y| <= w).

    Used only for the clip-path trivial reject: a triangle whose corners are
    all outside one screen side plane lies (in clip space, hence also after
    Sutherland-Hodgman against any other planes) entirely in that half-space,
    so its post-divide footprint is strictly outside the viewport and its
    pixel coverage is exactly empty — clipping it is pure waste.  Add/sub
    only (g = 1): bit-identical across numpy / XLA / Mosaic.
    """
    x, y, w = c[..., 0], c[..., 1], c[..., 3]
    return np.stack([w + x, w - x, w + y, w - y], axis=-1)


def _clip_polygon(verts: np.ndarray, attrs: np.ndarray, gx: float, gy: float):
    """Sutherland-Hodgman in homogeneous clip space; f32 lerp of position and
    attributes with the spec formula a + t*(b-a)."""
    poly_v = [v for v in verts]
    poly_a = [a for a in attrs]
    for plane in range(6):
        if not poly_v:
            return [], []
        out_v: list[np.ndarray] = []
        out_a: list[np.ndarray] = []
        n = len(poly_v)
        dists = _plane_dists(np.stack(poly_v), gx, gy)[:, plane]
        for i in range(n):
            j = (i + 1) % n
            da, db = F32(dists[i]), F32(dists[j])
            if da >= 0:
                out_v.append(poly_v[i])
                out_a.append(poly_a[i])
            if (da >= 0) != (db >= 0):
                t = sm.div_spec(da, da - db)
                out_v.append(poly_v[i] + t * (poly_v[j] - poly_v[i]))
                out_a.append(poly_a[i] + t * (poly_a[j] - poly_a[i]))
        poly_v, poly_a = out_v, out_a
    return poly_v, poly_a


def geometry_oracle(
    packed: PackedScene,
    model_mats: np.ndarray,
    view: np.ndarray,
    proj: np.ndarray,
    cfg: RasterConfig,
    clip_budget: int,
) -> tuple[TriangleSetup, np.ndarray]:
    """Vertex transform + clip + snap + cull + setup.

    Returns (setup, combined_attrs) where combined_attrs is
    ``(V + 9*clip_budget, ATTR_COLS)`` — original vertices first, then clip-
    generated vertices in clipped-triangle rank order (matching the device's
    deterministic slot assignment).
    """
    nv_pad = len(packed.positions)
    # Per-object MVP composed on the host in f32 (shared bits with the device
    # path); per-vertex application uses the spec's fixed mul/add chains —
    # matmul/einsum accumulation order is platform-dependent.
    mvp = compose_mvp(model_mats, view, proj)
    models = model_mats[packed.vert_obj]  # (V,4,4)
    mvps = mvp[packed.vert_obj]
    px, py, pz = (packed.positions[:, i] for i in range(3))
    wx, wy, wz, _ = sm.apply_mat4_point(models, px, py, pz)
    cx, cy, cz, cw = sm.apply_mat4_point(mvps, px, py, pz)
    clip = np.stack([cx, cy, cz, cw], axis=1).astype(F32)

    # world-space normals: normal transformed by the model's upper 3x3
    # (uniform-scale assumption; documented — reference has no normals at all)
    nx, ny, nz = sm.apply_mat3_vec(
        models, packed.normals[:, 0], packed.normals[:, 1], packed.normals[:, 2]
    )
    nrm_w = np.stack([nx, ny, nz], axis=1).astype(F32)

    base_attrs = np.concatenate(
        [
            packed.colors,
            nrm_w,
            packed.uvs,
            np.stack([wx, wy, wz], axis=1).astype(F32),
        ],
        axis=1,
    ).astype(F32)
    extra_attrs = np.zeros((MAX_CLIP_VERTS * clip_budget, ATTR_COLS), dtype=F32)

    t_in = len(packed.tri_v)
    s_total = t_in + MAX_CLIP_TRIS * clip_budget
    su = TriangleSetup(
        valid=np.zeros(s_total, dtype=bool),
        **{
            k: np.zeros(s_total, dtype=I32)
            for k in (
                "x0 y0 x1 y1 x2 y2 area2 zq0 zq1 zq2 v0 v1 v2 mat".split()
            )
        },
        inv_area2=np.zeros(s_total, dtype=F32),
        iw0=np.zeros(s_total, dtype=F32),
        iw1=np.zeros(s_total, dtype=F32),
        iw2=np.zeros(s_total, dtype=F32),
    )

    gx = 1.0 + 2.0 * cfg.guard_px / cfg.width
    gy = 1.0 + 2.0 * cfg.guard_px / cfg.height
    ss = cfg.subpixel_scale

    def emit(row, cverts, vids, iws, mat_id):
        """Snap one post-clip triangle and store its setup at `row`."""
        w = cverts[:, 3]
        iw_raw = sm.recip_spec(w.astype(F32))
        iw = np.where(np.isfinite(iw_raw), iw_raw, F32(0.0))
        ndc = cverts[:, :3] * iw[:, None]
        ndc = np.where(np.isfinite(ndc), ndc, F32(0.0)).astype(F32)
        xi = sm.snap_coord(
            ndc[:, 0], cfg.width, ss, cfg.min_coord, cfg.max_coord_x
        )
        yi = sm.snap_coord(
            ndc[:, 1], cfg.height, ss, cfg.min_coord, cfg.max_coord_y
        )
        zq = sm.quantize_depth(ndc[:, 2])
        sl = sm.shoelace2(xi[0], yi[0], xi[1], yi[1], xi[2], yi[2])
        if sl >= 0:  # back-facing or degenerate -> culled
            return
        order = [0, 2, 1]  # rewind so area2 > 0, interior-positive edges
        xi, yi, zq = xi[order], yi[order], zq[order]
        vids = [vids[o] for o in order]
        iws = iws[order] if iws is not None else iw[order]
        su.valid[row] = True
        su.x0[row], su.y0[row] = xi[0], yi[0]
        su.x1[row], su.y1[row] = xi[1], yi[1]
        su.x2[row], su.y2[row] = xi[2], yi[2]
        su.area2[row] = -sl
        su.inv_area2[row] = sm.recip_spec(F32(-sl))
        su.zq0[row], su.zq1[row], su.zq2[row] = zq
        su.iw0[row], su.iw1[row], su.iw2[row] = iws
        su.v0[row], su.v1[row], su.v2[row] = vids
        su.mat[row] = mat_id

    clip_rank = 0
    for t in range(t_in):
        vid = packed.tri_v[t]
        if vid[0] < 0:
            continue
        cv = clip[vid]  # (3,4)
        mat_id = int(packed.obj_material[packed.tri_obj[t]])
        d = _plane_dists(cv, gx, gy)  # (3,6)
        if np.any(np.all(d < 0, axis=0)):
            continue  # trivially outside one plane
        if np.all(d >= 0):
            emit(t, cv, list(vid), None, mat_id)
            continue
        if np.any(np.all(_screen_dists(cv) < 0, axis=0)):
            continue  # screen-plane trivial reject: zero coverage, skip tail
        # clip path
        if clip_rank >= clip_budget:
            continue  # budget overflow: dropped (counted by the device too)
        pv, pa = _clip_polygon(cv, base_attrs[vid], gx, gy)
        if len(pv) < 3:
            clip_rank += 1
            continue
        vbase = nv_pad + MAX_CLIP_VERTS * clip_rank
        for k, (v, a) in enumerate(zip(pv, pa)):
            extra_attrs[vbase - nv_pad + k] = a
        k = len(pv)
        pv = np.stack(pv).astype(F32)
        iw_all_raw = sm.recip_spec(pv[:, 3])
        iw_all = np.where(np.isfinite(iw_all_raw), iw_all_raw, F32(0.0))
        for j in range(k - 2):
            row = t_in + MAX_CLIP_TRIS * clip_rank + j
            tri_idx = [0, j + 1, j + 2]
            emit(
                row,
                pv[tri_idx],
                [vbase, vbase + j + 1, vbase + j + 2],
                iw_all[tri_idx],
                mat_id,
            )
        clip_rank += 1

    combined_attrs = np.concatenate([base_attrs, extra_attrs], axis=0)
    return su, combined_attrs


def visibility_oracle(
    su: TriangleSetup, cfg: RasterConfig
) -> tuple[np.ndarray, np.ndarray]:
    """Rasterize all valid triangles into the (d16, tri_id) visibility buffer.

    Per-triangle AABB loop; the winning fragment per pixel minimizes
    (d16, -draw_index) — see specmath.depth_key_better.
    """
    h, w = cfg.height, cfg.width
    vis_d = np.full((h, w), sm.DEPTH_MAX, dtype=I32)
    vis_t = np.full((h, w), sm.BG_TRI, dtype=I32)
    ss = cfg.subpixel_scale
    half = ss // 2

    for t in np.nonzero(su.valid)[0]:
        xs = np.array([su.x0[t], su.x1[t], su.x2[t]])
        ys = np.array([su.y0[t], su.y1[t], su.y2[t]])
        # pixel AABB: sample points px*ss + half within [min, max] coords
        pxmin = max(0, (int(xs.min()) - half + ss - 1) // ss)
        pxmax = min(w - 1, (int(xs.max()) - half) // ss)
        pymin = max(0, (int(ys.min()) - half + ss - 1) // ss)
        pymax = min(h - 1, (int(ys.max()) - half) // ss)
        if pxmax < pxmin or pymax < pymin:
            continue
        px = np.arange(pxmin, pxmax + 1, dtype=I32)
        py = np.arange(pymin, pymax + 1, dtype=I32)
        sx, sy = sm.pixel_sample_coords(px[None, :], py[:, None], ss)

        a0, b0, tl0 = sm.edge_coeffs(su.x1[t], su.y1[t], su.x2[t], su.y2[t])
        a1, b1, tl1 = sm.edge_coeffs(su.x2[t], su.y2[t], su.x0[t], su.y0[t])
        a2, b2, tl2 = sm.edge_coeffs(su.x0[t], su.y0[t], su.x1[t], su.y1[t])
        e0 = sm.edge_at(a0, b0, su.x1[t], su.y1[t], sx, sy)
        e1 = sm.edge_at(a1, b1, su.x2[t], su.y2[t], sx, sy)
        e2 = sm.edge_at(a2, b2, su.x0[t], su.y0[t], sx, sy)
        cov = (
            (e0 + sm.fill_bias(tl0) >= 0)
            & (e1 + sm.fill_bias(tl1) >= 0)
            & (e2 + sm.fill_bias(tl2) >= 0)
        )
        if not cov.any():
            continue
        d16 = sm.interp_depth16(
            e0, e1, e2, su.inv_area2[t], su.zq0[t], su.zq1[t], su.zq2[t]
        )
        sub_d = vis_d[pymin : pymax + 1, pxmin : pxmax + 1]
        sub_t = vis_t[pymin : pymax + 1, pxmin : pxmax + 1]
        better = cov & sm.depth_key_better(d16, I32(t), sub_d, sub_t)
        sub_d[better] = d16[better]
        sub_t[better] = t
    return vis_d, vis_t


def render_oracle(
    packed: PackedScene,
    model_mats: np.ndarray,
    view: np.ndarray,
    proj: np.ndarray,
    settings: RendererSettings,
    materials=None,
    atlas=None,
    light=None,
    camera_pos=None,
    cfg: RasterConfig | None = None,
):
    """Full-frame oracle: returns dict with setup, attrs, vis buffers, and
    packed RGBA8 output (at display resolution, after supersample resolve).
    materials / atlas / light: packs of numpy arrays (``MaterialsPack``,
    ``TextureAtlas``, ``LightPack``) or None."""
    if cfg is None:
        cfg = derive_raster_config(settings.render_width, settings.render_height)
    su, attrs = geometry_oracle(
        packed, model_mats, view, proj, cfg, settings.clip_budget
    )
    vis_d, vis_t = visibility_oracle(su, cfg)
    rgba = shade_np.shade(
        vis_t,
        su,
        attrs,
        materials=materials,
        atlas=atlas,
        light=light,
        camera_pos=camera_pos,
        cfg=cfg,
        clear_color=settings.clear_color,
    )
    rgba8 = shade_np.resolve_and_pack(
        rgba, settings.supersample, settings.srgb_output
    )
    return {
        "setup": su,
        "attrs": attrs,
        "vis_d16": vis_d,
        "vis_tri": vis_t,
        "rgba": rgba,
        "rgba8": rgba8,
    }
