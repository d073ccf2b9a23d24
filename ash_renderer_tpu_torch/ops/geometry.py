"""Triangle setup in torch ops (counterpart of
``ash_renderer_tpu/ops/geometry.py``): the vertex transform, the per-vertex
snap + outcodes, the classic pipeline's whole setup (``geometry_device``,
whose meshlet branch gathers corners through kernel K5) and the fused
pipeline's clip tail (``clip_tail_fused``).  The clip path is a budgeted
compaction of needs-clip triangles, Sutherland-Hodgman against the guard
frustum, fan triangulation, snap, cull and winding, in the spec's op order;
it runs only on frames that have a clip candidate.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import specmath as sm
from ..rtypes import SETUP_F32_FIELDS, TriangleSetup
from . import meshlet_gather

ATTR_COLS = 12
MAX_CLIP_VERTS = 9
MAX_CLIP_TRIS = MAX_CLIP_VERTS - 2
POLY_SLOTS = 12  # intermediate polygons may exceed 9 vertices mid-pipeline
VTX_COLS = 8  # _vertex_post's packed row: x, y, zq, iw bits, outcode, pad

_SETUP_FIELDS = tuple(f.name for f in dataclasses.fields(TriangleSetup))
_TAIL_FIELDS = (
    "valid x0 y0 x1 y1 x2 y2 zq0 zq1 zq2 inv_area2 iw0 iw1 iw2 mat".split()
)


def _zero_fields(names, shape, dev):
    """Every field of a dead setup row: False / 0 / 0.0, as ``_finish_tri``
    leaves an invalid row."""
    return {
        k: torch.zeros(shape, device=dev, dtype=torch.bool if k == "valid" else (
            torch.float32 if k in SETUP_F32_FIELDS else torch.int32))
        for k in names
    }


def vertex_rows(positions, vert_obj, normals, colors, uvs, model_mats,
                mvp_mats):
    """The vertex stage: 16 per-vertex float32 rows [clip x, y, z, w |
    colour 4 | world normal 3 | uv 2 | world position 3], with the spec's
    fixed mul/add association (no matmul).  One object's matrices are
    broadcast; several are gathered by ``vert_obj``."""
    if model_mats.shape[0] == 1:
        models, mvps = model_mats[0], mvp_mats[0]
    else:
        vo = vert_obj.long()
        models, mvps = model_mats[vo], mvp_mats[vo]
    px, py, pz = positions[:, 0], positions[:, 1], positions[:, 2]
    wx, wy, wz, _ = sm.apply_mat4_point(models, px, py, pz)
    cx, cy, cz, cw = sm.apply_mat4_point(mvps, px, py, pz)
    nx, ny, nz = sm.apply_mat3_vec(
        models, normals[:, 0], normals[:, 1], normals[:, 2]
    )
    return [
        cx, cy, cz, cw,
        colors[:, 0], colors[:, 1], colors[:, 2], colors[:, 3],
        nx, ny, nz,
        uvs[:, 0], uvs[:, 1],
        wx, wy, wz,
    ]


def transform_vertices(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats):
    """Clip positions (V, 4) and the combined attribute table (V, 12):
    [colour 4, world normal 3, uv 2, world position 3]."""
    rows = vertex_rows(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats)
    return torch.stack(rows[:4], dim=1), torch.stack(rows[4:], dim=1)


def _plane_dists(c, gx: float, gy: float):
    """(..., 4) clip coords -> (..., 6) plane distances: near, far, left,
    right, top, bottom."""
    x, y, z, w = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    gx = float(np.float32(gx))
    gy = float(np.float32(gy))
    return torch.stack(
        [z, w - z, gx * w + x, gx * w - x, gy * w + y, gy * w - y], dim=-1
    )


def _snap_corner(cx, cy, cz, cw, cfg):
    """One corner's clip coords -> (snapped x, y, zq, iw)."""
    iw_raw = sm.recip_spec(cw)
    iw = torch.where(torch.isfinite(iw_raw), iw_raw, torch.zeros_like(iw_raw))

    def nd(v):
        r = v * iw
        return torch.where(torch.isfinite(r), r, torch.zeros_like(r))

    ss = cfg.subpixel_scale
    xi = sm.snap_coord(nd(cx), cfg.width, ss, cfg.min_coord, cfg.max_coord_x)
    yi = sm.snap_coord(nd(cy), cfg.height, ss, cfg.min_coord, cfg.max_coord_y)
    zq = sm.quantize_depth(nd(cz))
    return xi, yi, zq, iw


def _finish_tri(corners, vids, mat, alive):
    """Orientation cull + winding rewind (0, 2, 1); every field of an
    invalid row is zeroed."""
    (xa, ya, za, ia), (xb, yb, zb, ib), (xc, yc, zc, ic) = corners
    sl = sm.shoelace2(xa, ya, xb, yb, xc, yc)
    valid = alive & (sl < 0)
    area2 = torch.where(valid, -sl, torch.ones_like(sl))
    out = dict(
        valid=valid,
        x0=xa, y0=ya, x1=xc, y1=yc, x2=xb, y2=yb,
        area2=area2,
        inv_area2=sm.recip_spec(area2.to(torch.float32)),
        zq0=za, zq1=zc, zq2=zb,
        iw0=ia, iw1=ic, iw2=ib,
        v0=vids[0], v1=vids[2], v2=vids[1],
        mat=mat,
    )
    for k, v in out.items():
        if k != "valid":
            out[k] = torch.where(valid, v, torch.zeros_like(v))
    return out


def _clip_polygons(cverts, avals, gx: float, gy: float):
    """Sutherland-Hodgman over a batch of triangles.

    cverts: (B, 3, 4) clip positions; avals: (B, 3, A) attributes.  Returns
    (B, POLY_SLOTS, 4), (B, POLY_SLOTS, A), counts (B,).  Each edge emits
    0-2 vertices at exclusive-cumsum positions; placement is a select-
    accumulate over the source slots (0.0 + v per slot, as the spec does)."""
    b = cverts.shape[0]
    dev = cverts.device
    av = torch.cat([cverts, avals], dim=-1)
    ch = av.shape[-1]
    buf = torch.zeros((b, POLY_SLOTS, ch), dtype=torch.float32, device=dev)
    buf[:, :3] = av
    count = torch.full((b,), 3, dtype=torch.int32, device=dev)
    idx = torch.arange(POLY_SLOTS, dtype=torch.int32, device=dev)

    for plane in range(6):
        d = _plane_dists(buf[..., :4], gx, gy)[..., plane]  # (B, P)
        in_poly = idx[None, :] < count[:, None]
        nxt = torch.where(
            idx[None, :] + 1 >= count[:, None], 0, idx[None, :] + 1
        ).long()
        d_a = d
        d_b = torch.gather(d, 1, nxt)
        a_in = (d_a >= 0) & in_poly
        crossing = ((d_a >= 0) != (d_b >= 0)) & in_poly
        emit = a_in.to(torch.int32) + crossing.to(torch.int32)
        offs = torch.cumsum(emit, 1, dtype=torch.int32) - emit
        new_count = torch.where(
            in_poly[:, 0], offs[:, -1] + emit[:, -1], torch.zeros_like(count)
        )

        t = sm.div_spec(d_a, d_a - d_b)
        v_a = buf
        v_b = torch.gather(buf, 1, nxt[..., None].expand(b, POLY_SLOTS, ch))
        inter = v_a + t[..., None] * (v_b - v_a)
        inter = torch.where(torch.isfinite(inter), inter, torch.zeros_like(inter))

        def one_hot_place(pos, mask, vals, acc):
            oh = (idx[None, None, :] == pos[..., None]) & mask[..., None]
            for p in range(POLY_SLOTS):
                acc = acc + torch.where(
                    oh[:, p, :, None], vals[:, p : p + 1, :],
                    torch.zeros((), dtype=torch.float32, device=dev),
                )
            return acc

        acc = torch.zeros_like(buf)
        acc = one_hot_place(offs, a_in, v_a, acc)
        acc = one_hot_place(offs + a_in.to(torch.int32), crossing, inter, acc)
        buf = acc
        count = new_count
    return buf[..., :4], buf[..., 4:], count


def clip_fan_path(cvb, ab, matb, sel_ok, cfg, vbase):
    """Sutherland-Hodgman + fan triangulation over the budgeted batch.

    Returns (clipped fields dict of (B, MAX_CLIP_TRIS) entries, fan_attrs
    [3 x (B, MAX_CLIP_TRIS, A)] zeroed on dead slots, poly_a)."""
    dev = cvb.device
    gx = 1.0 + 2.0 * cfg.guard_px / cfg.width
    gy = 1.0 + 2.0 * cfg.guard_px / cfg.height
    poly_v, poly_a, poly_n = _clip_polygons(cvb, ab, gx, gy)
    iw_poly_raw = sm.recip_spec(poly_v[..., 3].contiguous())
    iw_poly = torch.where(
        torch.isfinite(iw_poly_raw), iw_poly_raw, torch.zeros_like(iw_poly_raw)
    )
    j_idx = torch.arange(MAX_CLIP_TRIS, dtype=torch.int32, device=dev)
    fan = torch.stack([torch.zeros_like(j_idx), j_idx + 1, j_idx + 2], dim=-1)
    fan_alive = (j_idx[None, :] + 2 < poly_n[:, None]) & sel_ok[:, None]
    fanc = torch.clamp(fan, 0, POLY_SLOTS - 1).long()
    corners, vids, attrs = [], [], []
    for k in range(3):
        fvk = poly_v[:, fanc[:, k]]  # (B, 7, 4)
        xi, yi, zq, _ = _snap_corner(
            fvk[..., 0], fvk[..., 1], fvk[..., 2], fvk[..., 3].contiguous(),
            cfg,
        )
        corners.append((xi, yi, zq, iw_poly[:, fanc[:, k]]))
        vids.append(vbase[:, None] + fanc[None, :, k].to(torch.int32))
        attrs.append(poly_a[:, fanc[:, k]])
    clipped = _finish_tri(
        tuple(corners), tuple(vids),
        matb[:, None].expand(fan_alive.shape), fan_alive,
    )
    attrs = [
        torch.where(clipped["valid"][..., None], a, torch.zeros_like(a))
        for a in attrs
    ]
    return clipped, attrs, poly_a


def _select_budgeted(flags, budget: int):
    """First ``budget`` flagged row indices ascending, -1 fill."""
    sel = torch.nonzero(flags).reshape(-1)[:budget].to(torch.int32)
    out = torch.full((budget,), -1, dtype=torch.int32, device=flags.device)
    out[: sel.shape[0]] = sel
    return out


def clip_tail_fused(tblT, tri_v, mat_id, needs_clip, cfg, clip_budget: int):
    """Clip path of the setup pipeline, sourcing corner rows from the
    transposed (16, V) vertex table.

    Returns (fields dict of (clip_budget * MAX_CLIP_TRIS,) tail rows,
    (a_v0, a_v1, a_v2) per-corner (N, 12) f32 attributes in rewound order,
    stats dict)."""
    dev = tblT.device
    t_in = tri_v.shape[0]
    nv_pad = tblT.shape[1]
    n = clip_budget * MAX_CLIP_TRIS
    n_clip = int(needs_clip.sum())
    stats = {
        "clip_overflow": n_clip - min(n_clip, clip_budget),
        "n_clipped": n_clip,
    }
    if n_clip == 0:
        # all slots dead, every field zeroed
        fields = _zero_fields(_TAIL_FIELDS, n, dev)
        z = torch.zeros((n, ATTR_COLS), dtype=torch.float32, device=dev)
        return fields, (z, z, z), stats
    sel = _select_budgeted(needs_clip, clip_budget)
    sel_ok = sel >= 0
    sel_c = torch.clamp(sel, 0, t_in - 1).long()
    vid = torch.clamp(tri_v, 0, nv_pad - 1)
    vidf = vid[sel_c].reshape(-1).long()  # (3B,)
    rows = sm.bitcast_f32(tblT[:, vidf].T.contiguous()).reshape(
        clip_budget, 3, tblT.shape[0]
    )
    clipped, fan_attrs, _ = clip_fan_path(
        rows[..., 0:4], rows[..., 4:16], mat_id[sel_c], sel_ok, cfg,
        vbase=torch.zeros_like(sel),
    )
    fields = {k: clipped[k].reshape(n) for k in _TAIL_FIELDS}
    a_v0 = fan_attrs[0].reshape(n, ATTR_COLS)
    a_v1 = fan_attrs[2].reshape(n, ATTR_COLS)
    a_v2 = fan_attrs[1].reshape(n, ATTR_COLS)
    return fields, (a_v0, a_v1, a_v2), stats


def _vertex_post(clip, cfg):
    """Per-vertex snap + frustum outcode, packed (V, 8) int32 rows [x, y,
    zq, iw bits, outcode, 0, 0, 0].  Outcode bit p is set where plane p's
    distance is negative: bits 0-5 the guard planes (``_plane_dists``'
    order), bits 6-9 the screen side planes."""
    cx, cy, cz, cw = (clip[:, k].contiguous() for k in range(4))
    gx = float(np.float32(1.0 + 2.0 * cfg.guard_px / cfg.width))
    gy = float(np.float32(1.0 + 2.0 * cfg.guard_px / cfg.height))
    xi, yi, zq, iw = _snap_corner(cx, cy, cz, cw, cfg)
    ds = (
        cz, cw - cz,
        gx * cw + cx, gx * cw - cx,
        gy * cw + cy, gy * cw - cy,
        cw + cx, cw - cx, cw + cy, cw - cy,
    )
    outcode = torch.zeros_like(xi)
    for pi, d in enumerate(ds):
        outcode = outcode | ((d < 0).to(torch.int32) << pi)
    zero = torch.zeros_like(xi)
    return torch.stack(
        [xi, yi, zq, sm.bitcast_i32(iw), outcode, zero, zero, zero], dim=1
    )


def geometry_device(clip, attrs, tri_v, tri_mat, cfg, clip_budget: int,
                    local_tri=None):
    """The classic pipeline's triangle setup.

    clip (V, 4) and attrs (V, 12) from ``transform_vertices``; tri_v (T, 3)
    int32 vertex ids (-1 rows are padding); tri_mat (T,) int32 materials.
    With ``local_tri`` (T, 3) meshlet-local ids, the corner rows come from
    kernel K5 (``meshlet_gather.gather_tri_rows``), else from a row gather
    by ``tri_v``; both give the same rows.  Returns (TriangleSetup of
    S = T + 7 * clip_budget rows, combined attributes (V + 9 * clip_budget,
    12), stats)."""
    dev = clip.device
    t_in = tri_v.shape[0]
    nv_pad = clip.shape[0]
    vid_ok = tri_v[:, 0] >= 0
    vid = torch.clamp(tri_v, 0, nv_pad - 1)

    vtx = _vertex_post(clip, cfg)
    if local_tri is not None:
        g3 = meshlet_gather.gather_tri_rows(vtx, local_tri)
        corner_pack = [g3[:, VTX_COLS * k : VTX_COLS * (k + 1)] for k in range(3)]
    else:
        corner_pack = [vtx[vid[:, k].long()] for k in range(3)]
    oc0, oc1, oc2 = (c[:, 4] for c in corner_pack)
    oc_and = oc0 & oc1 & oc2
    out_any = (oc_and & 0x3F) != 0
    all_in = ((oc0 | oc1 | oc2) & 0x3F) == 0
    out_screen = (oc_and >> 6) != 0
    fast = vid_ok & all_in
    needs_clip = vid_ok & ~all_in & ~out_any & ~out_screen

    # ---- fast path
    corner_snaps = tuple(
        (c[:, 0], c[:, 1], c[:, 2], sm.bitcast_f32(c[:, 3])) for c in corner_pack
    )
    main = _finish_tri(corner_snaps, (vid[:, 0], vid[:, 1], vid[:, 2]),
                       tri_mat, fast)

    # ---- clip path: budgeted compaction of the flagged triangles
    n_clip = int(needs_clip.sum())
    if n_clip == 0:
        # what the clip path gives when nothing is flagged: every slot dead
        clipped = _zero_fields(_SETUP_FIELDS, (clip_budget, MAX_CLIP_TRIS), dev)
        extra = torch.zeros((clip_budget * MAX_CLIP_VERTS, ATTR_COLS),
                            dtype=torch.float32, device=dev)
    else:
        sel = _select_budgeted(needs_clip, clip_budget)
        sel_ok = sel >= 0
        sel_c = torch.clamp(sel, 0, t_in - 1).long()
        corners = vid[sel_c].long()  # (B, 3)
        vbase = nv_pad + MAX_CLIP_VERTS * torch.arange(
            clip_budget, dtype=torch.int32, device=dev)
        clipped, _, poly_a = clip_fan_path(
            clip[corners], attrs[corners], tri_mat[sel_c], sel_ok, cfg, vbase
        )
        # extra attribute rows: the polygon vertices in rank slots
        extra = torch.where(
            sel_ok[:, None, None], poly_a[:, :MAX_CLIP_VERTS],
            torch.zeros((), dtype=torch.float32, device=dev),
        ).reshape(clip_budget * MAX_CLIP_VERTS, ATTR_COLS)

    su = TriangleSetup(**{
        k: torch.cat([main[k], clipped[k].reshape(-1)]) for k in _SETUP_FIELDS
    })
    stats = {
        "clip_overflow": n_clip - min(n_clip, clip_budget),
        "n_fast": fast.sum(),
        "n_clipped": n_clip,
        "n_valid": su.valid.sum(),
        "n_setup": su.valid.shape[0],
    }
    return su, torch.cat([attrs, extra]), stats
