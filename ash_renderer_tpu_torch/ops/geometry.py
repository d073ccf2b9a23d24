"""Triangle setup in torch ops (counterpart of
``ash_renderer_tpu/ops/geometry.py``): the vertex transform, the per-vertex
snap + outcodes, the classic pipeline's whole setup (``geometry_device``,
whose meshlet branch gathers corners through kernel K5) and the fused
pipeline's clip tail (``clip_tail_fused``).  The clip path is a budgeted
compaction of needs-clip triangles, Sutherland-Hodgman against the guard
frustum, fan triangulation, snap, cull and winding, in the spec's op order;
it runs only on frames that have a clip candidate.

Two kernels, neither of which replaces a Pallas kernel (the reference
computes both stages as XLA glue under one jit, ``_stage_geometry``,
``ash_renderer_tpu/pipeline.py:680``, which XLA fuses):

* K8C (``transform_vertices``, ``csrc/transform.cu``): the vertex
  transform in row layout, one launch where eager torch pays ~64; its
  plain version is ``transform_vertices_plain``.  No frame path launches
  it: K10 transforms the vertices it reads itself.
* K10 (``stage_geometry_rows``, the reference's ``_stage_geometry``, which
  the frames call; ``geometry_rows`` / ``geometry_device`` on K8C's rows;
  ``csrc/geometry.cu``): the classic transform and setup in one launch
  that transforms and snaps each triangle's corners, sets the triangles up,
  selects the clip candidates and clips them (a vertex launch first, and
  K5's corner gather, on a meshlet-packed scene), its passes split by the
  barriers of one thread block cluster at the classic route's sizes or of
  one cooperative grid past them (``k10_design``), with no host read,
  where eager torch pays hundreds of launches, a host read of the
  candidate count on every frame and the select's ``nonzero`` on every
  frame that clips; its plain version is ``transform_vertices_plain``
  then ``geometry_device_plain``.  It writes the setup as one (S,
  ``SETUP_COLS``) table (which the classic frame binds to binning and to
  K11) beside a bool
  ``valid`` array, and the counters as 0-dim int32 tensors on the
  device.

Both are bound by bytes (a few MB a frame at the default clip budget), so
their time is their launches'.  CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .. import specmath as sm
from ..rtypes import (SETUP_COLS, SETUP_F32_FIELDS, SETUP_ROW_FIELDS,
                      TriangleSetup)
from . import meshlet_gather

ATTR_COLS = 12
MAX_CLIP_VERTS = 9
MAX_CLIP_TRIS = MAX_CLIP_VERTS - 2
POLY_SLOTS = 12  # intermediate polygons may exceed 9 vertices mid-pipeline
VTX_COLS = 8  # _vertex_post's packed row: x, y, zq, iw bits, outcode, pad

KERNEL_TRANSFORM = "K8C_vertex_transform_rows"
KERNEL = "K10_geometry"
# K10's counters, in the order of its counter buffer
COUNTERS = ("n_clipped", "clip_overflow", "n_valid", "n_fast")
K10_CHUNK = 1024  # triangles a chunk of K10's count and select passes
# the crossover: K10's passes meet at one thread block cluster's barriers
# for at most this many triangles, at a cooperative grid's past it
K10_CLUSTER_MAX_TRIS = 16384

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


def check_transform_args(fn: str, positions, vert_obj, normals, colors, uvs,
                         model_mats, mvp_mats):
    """Raise ``ValueError`` unless the vertex transform's arguments are
    what its kernels (K8, K8C) take: contiguous tensors on one device,
    float32 (V, 3) positions and normals, (V, 4) colours, (V, 2) uvs,
    int32 (V,) object ids and (O, 4, 4) matrices with O >= 1."""
    dev = positions.device
    v = positions.shape[0]
    n_obj = model_mats.shape[0]
    for name, x, dtype, shape in (
        ("positions", positions, torch.float32, (v, 3)),
        ("vert_obj", vert_obj, torch.int32, (v,)),
        ("normals", normals, torch.float32, (v, 3)),
        ("colors", colors, torch.float32, (v, 4)),
        ("uvs", uvs, torch.float32, (v, 2)),
        ("model_mats", model_mats, torch.float32, (n_obj, 4, 4)),
        ("mvp_mats", mvp_mats, torch.float32, (n_obj, 4, 4)),
    ):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{fn}: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if n_obj < 1:
        raise ValueError(f"{fn}: no object matrices")


def transform_vertices(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats):
    """Clip positions (V, 4) and the combined attribute table (V, 12):
    [colour 4, world normal 3, uv 2, world position 3], float32, under the
    model (``model_mats``) and MVP (``mvp_mats``) matrices, (O, 4, 4) each:
    one object's are broadcast, several are taken by ``vert_obj``.  Raises
    ``ValueError`` on arguments the kernel does not take
    (``check_transform_args``).  CPU tensors take the plain version; CUDA
    tensors launch kernel K8C."""
    dev = positions.device
    check_transform_args("transform_vertices", positions, vert_obj, normals,
                         colors, uvs, model_mats, mvp_mats)
    if dev.type == "cpu":
        return transform_vertices_plain(positions, vert_obj, normals, colors,
                                        uvs, model_mats, mvp_mats)
    if dev.type != "cuda":
        raise ValueError(f"transform_vertices: unsupported device {dev}")
    v = positions.shape[0]
    # one allocation: clip rows, then attribute rows (16-byte rows each)
    out = torch.empty(v * (4 + ATTR_COLS), dtype=torch.float32, device=dev)
    clip = out[: 4 * v].view(v, 4)
    attrs = out[4 * v :].view(v, ATTR_COLS)
    _build.launch(
        KERNEL_TRANSFORM, "ash_vertex_transform_rows", dev,
        positions.data_ptr(), vert_obj.data_ptr(), normals.data_ptr(),
        colors.data_ptr(), uvs.data_ptr(), model_mats.data_ptr(),
        mvp_mats.data_ptr(), clip.data_ptr(), attrs.data_ptr(), v,
        model_mats.shape[0],
    )
    return clip, attrs


def transform_vertices_plain(positions, vert_obj, normals, colors, uvs,
                             model_mats, mvp_mats):
    """transform_vertices in torch ops (any device): ``vertex_rows``
    stacked."""
    rows = vertex_rows(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats)
    return torch.stack(rows[:4], dim=1), torch.stack(rows[4:], dim=1)


def guard_factors(cfg):
    """The guard planes' float32 factors (gx, gy): 1 + 2 * guard_px /
    width (height)."""
    gx = np.float32(1.0 + 2.0 * cfg.guard_px / cfg.width)
    gy = np.float32(1.0 + 2.0 * cfg.guard_px / cfg.height)
    return gx, gy


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
    gx, gy = (float(g) for g in guard_factors(cfg))
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


def _check_tri_args(fn: str, v: int, dev, tri_v, tri_mat, local_tri):
    t = tri_v.shape[0]
    args = [("tri_v", tri_v, torch.int32, (t, 3)),
            ("tri_mat", tri_mat, torch.int32, (t,))]
    if local_tri is not None:
        args.append(("local_tri", local_tri, torch.int32, (t, 3)))
    for name, x, dtype, shape in args:
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{fn}: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if v < 1:
        raise ValueError(f"{fn}: no vertices")


def _check_geometry_args(clip, attrs, tri_v, tri_mat, local_tri):
    dev = clip.device
    v = clip.shape[0]
    for name, x, dtype, shape in (
            ("clip", clip, torch.float32, (v, 4)),
            ("attrs", attrs, torch.float32, (v, ATTR_COLS))):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"geometry_device: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    _check_tri_args("geometry_device", v, dev, tri_v, tri_mat, local_tri)


def setup_table(su):
    """The (S, SETUP_COLS) int32 table of a TriangleSetup's fields
    (``rtypes.SETUP_ROW_FIELDS``, floats as bits), as kernel K10 writes
    it."""
    cols = [sm.bitcast_i32(getattr(su, k)) if k in SETUP_F32_FIELDS
            else getattr(su, k) for k in SETUP_ROW_FIELDS]
    pad = torch.zeros_like(su.x0)
    return torch.stack(cols + [pad] * (SETUP_COLS - len(cols)), dim=1)


def setup_from_rows(rows, valid):
    """The TriangleSetup whose fields are the columns of ``rows`` (S,
    SETUP_COLS) int32 (``setup_table``'s layout) and whose ``valid`` is
    the (S,) bool ``valid``: views, no copy."""
    cols = rows.unbind(1)  # one call makes every column view
    fields = {k: cols[i].view(torch.float32) if k in SETUP_F32_FIELDS
              else cols[i] for i, k in enumerate(SETUP_ROW_FIELDS)}
    return TriangleSetup(valid=valid, **fields)


def k10_design(n_tris: int) -> str:
    """K10's design for ``n_tris`` triangles: "cluster" (its passes split
    by one thread block cluster's barriers) up to
    ``K10_CLUSTER_MAX_TRIS``, "grid" (one cooperative launch over the
    card) past it."""
    return "cluster" if n_tris <= K10_CLUSTER_MAX_TRIS else "grid"


def scratch_words(n_verts: int, n_tris: int, clip_budget: int,
                  meshlets: bool) -> int:
    """int32 words of device scratch ``geometry_rows`` allocates beside
    the setup table: the snapped vertex rows K5 gathers from (a
    meshlet-packed scene only), the counters, the per-chunk counts, the
    selected candidates and the row flags."""
    return ((n_verts * VTX_COLS if meshlets else 0) + len(COUNTERS)
            + 3 * -(-n_tris // K10_CHUNK) + clip_budget + n_tris)


def _k10_outputs(v: int, t: int, b: int, meshlets: bool, dev):
    """K10's outputs and scratch on ``dev``: (rows (S, SETUP_COLS), valid
    (S,) bool, attrs_full, scratch, the snapped vertex rows (V, VTX_COLS)
    K5 gathers from, or None on a plain-packed scene).  One int32
    allocation holds the vertex rows, the setup rows (16-byte aligned
    after them), then the counters, the per-chunk counts, sel and the row
    flags."""
    s = t + MAX_CLIP_TRIS * b
    attrs_full = torch.empty((v + MAX_CLIP_VERTS * b, ATTR_COLS),
                             dtype=torch.float32, device=dev)
    n_vtx = v * VTX_COLS if meshlets else 0
    words = torch.empty(s * SETUP_COLS + scratch_words(v, t, b, meshlets),
                        dtype=torch.int32, device=dev)
    rows = words[n_vtx : n_vtx + s * SETUP_COLS].view(s, SETUP_COLS)
    scratch = words[n_vtx + s * SETUP_COLS :]
    valid = torch.empty(s, dtype=torch.bool, device=dev)
    vtx = words[:n_vtx].view(v, VTX_COLS) if meshlets else None
    return rows, valid, attrs_full, scratch, vtx


def _snap_args(cfg):
    """K10's snap and guard arguments: width, height, min_c, max_cx,
    max_cy, ss, gx, gy."""
    gx, gy = (float(g) for g in guard_factors(cfg))
    return (cfg.width, cfg.height, cfg.min_coord, cfg.max_coord_x,
            cfg.max_coord_y, cfg.subpixel_scale, gx, gy)


def geometry_rows(clip, attrs, tri_v, tri_mat, cfg, clip_budget: int,
                  local_tri=None):
    """``geometry_device`` with the setup as one table: (rows (S,
    SETUP_COLS) int32, ``setup_table``'s layout, valid (S,) bool,
    combined attributes, stats).  CPU tensors take the plain version and
    pack its fields; CUDA tensors launch kernel K10 on the clip and
    attribute rows (one launch on a plain-packed scene, a vertex launch
    and K5's gather first on a meshlet-packed one; no host read), which
    writes the table itself.  A frame calls ``stage_geometry_rows``, which
    transforms the vertices in the same launch."""
    dev = clip.device
    _check_geometry_args(clip, attrs, tri_v, tri_mat, local_tri)
    if dev.type == "cpu":
        su, attrs_full, stats = geometry_device_plain(
            clip, attrs, tri_v, tri_mat, cfg, clip_budget, local_tri)
        return setup_table(su), su.valid, attrs_full, stats
    if dev.type != "cuda":
        raise ValueError(f"geometry_device: unsupported device {dev}")
    for name, x in (("clip", clip), ("attrs", attrs)):
        if x.data_ptr() % 16:
            raise ValueError(f"geometry_device: {name} is not 16-byte "
                             "aligned")
    v, t, b = clip.shape[0], tri_v.shape[0], clip_budget
    rows, valid, attrs_full, scratch, vtx = _k10_outputs(
        v, t, b, local_tri is not None, dev)
    snap = _snap_args(cfg)
    corners = None
    if local_tri is not None:
        _build.launch(KERNEL, "ash_geometry_vertices", dev, clip.data_ptr(),
                      attrs.data_ptr(), vtx.data_ptr(),
                      attrs_full.data_ptr(), v, *snap)
        corners = meshlet_gather.gather_tri_rows(vtx, local_tri)
    _build.launch(
        KERNEL, "ash_geometry_tris", dev,
        None if corners is None else corners.data_ptr(), clip.data_ptr(),
        attrs.data_ptr(), tri_v.data_ptr(), tri_mat.data_ptr(),
        scratch.data_ptr(), rows.data_ptr(), valid.data_ptr(),
        attrs_full.data_ptr(), v, t, b, *snap,
        int(k10_design(t) == "cluster"))
    stats = dict(zip(COUNTERS, scratch[: len(COUNTERS)].unbind()))
    return rows, valid, attrs_full, {**stats, "n_setup": rows.shape[0]}


def stage_geometry_rows(positions, vert_obj, normals, colors, uvs,
                        model_mats, mvp_mats, tri_v, tri_mat, cfg,
                        clip_budget: int, local_tri=None):
    """The classic frame's geometry stage, as the reference's
    ``_stage_geometry`` (``ash_renderer_tpu/pipeline.py:680``) computes it:
    ``transform_vertices`` on the scene's vertex tensors and (O, 4, 4)
    matrices, then ``geometry_rows`` (arguments and returns as there).
    Raises ``ValueError`` on arguments the kernel does not take.  CPU
    tensors take the plain versions (``transform_vertices_plain``, then
    ``geometry_device_plain``); CUDA tensors launch kernel K10 with the
    transform folded in: each pass transforms the vertices it reads
    (``csrc/vertex.cuh``, K8C's arithmetic), so K8C has no launch; one
    launch on a plain-packed scene, a vertex launch and K5's gather first
    on a meshlet-packed one; no host read."""
    dev = positions.device
    check_transform_args("stage_geometry_rows", positions, vert_obj, normals,
                         colors, uvs, model_mats, mvp_mats)
    _check_tri_args("stage_geometry_rows", positions.shape[0], dev, tri_v,
                    tri_mat, local_tri)
    if dev.type == "cpu":
        clip, attrs = transform_vertices_plain(
            positions, vert_obj, normals, colors, uvs, model_mats, mvp_mats)
        return geometry_rows(clip, attrs, tri_v, tri_mat, cfg, clip_budget,
                             local_tri)
    if dev.type != "cuda":
        raise ValueError(f"stage_geometry_rows: unsupported device {dev}")
    v, t, b = positions.shape[0], tri_v.shape[0], clip_budget
    rows, valid, attrs_full, scratch, vtx = _k10_outputs(
        v, t, b, local_tri is not None, dev)
    scene = (positions.data_ptr(), vert_obj.data_ptr(), normals.data_ptr(),
             colors.data_ptr(), uvs.data_ptr(), model_mats.data_ptr(),
             mvp_mats.data_ptr(), model_mats.shape[0])
    snap = _snap_args(cfg)
    corners = None
    if local_tri is not None:
        _build.launch(KERNEL, "ash_geometry_vertices_scene", dev, *scene,
                      vtx.data_ptr(), attrs_full.data_ptr(), v, *snap)
        corners = meshlet_gather.gather_tri_rows(vtx, local_tri)
    _build.launch(
        KERNEL, "ash_geometry_tris_scene", dev,
        None if corners is None else corners.data_ptr(), *scene,
        tri_v.data_ptr(), tri_mat.data_ptr(), scratch.data_ptr(),
        rows.data_ptr(), valid.data_ptr(), attrs_full.data_ptr(), v, t, b,
        *snap, int(k10_design(t) == "cluster"))
    stats = dict(zip(COUNTERS, scratch[: len(COUNTERS)].unbind()))
    return rows, valid, attrs_full, {**stats, "n_setup": rows.shape[0]}


def geometry_device(clip, attrs, tri_v, tri_mat, cfg, clip_budget: int,
                    local_tri=None):
    """The classic pipeline's triangle setup.

    clip (V, 4) and attrs (V, 12) from ``transform_vertices``; tri_v (T, 3)
    int32 vertex ids (-1 rows are padding); tri_mat (T,) int32 materials.
    With ``local_tri`` (T, 3) meshlet-local ids, the corner rows come from
    kernel K5 (``meshlet_gather.gather_tri_rows``), else from a row gather
    by ``tri_v``; both give the same rows.  Returns (TriangleSetup of
    S = T + 7 * clip_budget rows, combined attributes (V + 9 * clip_budget,
    12), stats: ``COUNTERS`` as 0-dim int32 tensors on the device, and
    n_setup = S).  Raises ``ValueError`` on arguments the kernel does not
    take.  CPU tensors take the plain version; CUDA tensors launch kernel
    K10 (``geometry_rows``), whose table's columns the fields are."""
    if clip.device.type == "cpu":
        _check_geometry_args(clip, attrs, tri_v, tri_mat, local_tri)
        return geometry_device_plain(clip, attrs, tri_v, tri_mat, cfg,
                                     clip_budget, local_tri)
    rows, valid, attrs_full, stats = geometry_rows(
        clip, attrs, tri_v, tri_mat, cfg, clip_budget, local_tri)
    return setup_from_rows(rows, valid), attrs_full, stats


def geometry_device_plain(clip, attrs, tri_v, tri_mat, cfg, clip_budget: int,
                          local_tri=None):
    """geometry_device in torch ops (any device): the fast path, the
    budgeted clip path (on frames with a clip candidate) and the
    counters, which come back as 0-dim int32 tensors as the kernel's
    do."""
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
    values = {
        "n_clipped": n_clip,
        "clip_overflow": n_clip - min(n_clip, clip_budget),
        "n_valid": su.valid.sum(),
        "n_fast": fast.sum(),
    }
    stats = {k: torch.as_tensor(values[k], dtype=torch.int32, device=dev)
             for k in COUNTERS}
    return su, torch.cat([attrs, extra]), {**stats,
                                            "n_setup": su.valid.shape[0]}
