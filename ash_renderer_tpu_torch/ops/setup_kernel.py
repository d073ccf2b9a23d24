"""Triangle setup: clip coordinates -> comb rows, streaming keys, flags.

Kernel K1.  ``triangle_setup`` launches ``csrc/setup.cu`` on a CUDA tensor
and runs ``triangle_setup_plain`` (the same function in torch ops) on a CPU
tensor.  It replaces the Pallas kernel ``ash_renderer_tpu/ops/
setup_kernel.py:_kernel`` (via ``triangle_setup``), whose one-hot MXU corner
gathers and byte-plane transposes exist only because the TPU gathers badly:
here one thread per triangle loads its three corners' 16 table fields
directly.

What bounds it on the card: memory.  Per triangle it reads 3 x 16 corner
words (mostly L2 hits: a meshlet's 128 vertices are contiguous) and writes a
512-byte comb row, so at the 1.31M-triangle headline it moves ~0.7 GB, all
but ~60 MB of it the comb write.  A block of 128 threads is one meshlet:
the meshlet-level cull (a meshlet with no valid and no clip-candidate
triangle is zero-filled) is one block vote, and the rows are staged in
shared memory so the block writes the comb rows coalesced.

Semantics: vertex snap + frustum outcodes, orientation cull (CCW front,
back cull), winding rewind (a, c, b), shoelace ``inv_area2``, D16 depths,
1/w, comb rows (``tritables`` layout), streaming keys (``binsort``), flags
(bit0 valid, bit1 needs_clip, bit2 fast) and 16-bit packed pixel-AABB
extents.  Rows of dead meshlets are all zero; in live meshlets the attribute
columns are not masked by validity.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .. import specmath as sm
from ..scene import MESHLET_TRIS, MESHLET_VERTS
from . import binsort
from .geometry import vertex_rows
from .tritables import ID_COL, TBL_COLS

N_TBL_ROWS = 16  # clip x,y,z,w + 12 attrs
KERNEL = "K1_setup"


def prep_static(local_tri: np.ndarray, tri_mat: np.ndarray,
                tri_valid: np.ndarray):
    """Host-side static prep (once per scene): transposed meshlet-local
    corner ids (M, 384) with -1 on padding rows, and per-meshlet material
    ids (M, 128)."""
    t = local_tri.shape[0]
    m = t // MESHLET_TRIS
    lt = np.where(tri_valid[:, None], local_tri, -1).reshape(m, MESHLET_TRIS, 3)
    ltT = np.ascontiguousarray(lt.transpose(0, 2, 1)).reshape(
        m, 3 * MESHLET_TRIS
    )
    matT = np.ascontiguousarray(np.asarray(tri_mat).reshape(m, MESHLET_TRIS))
    return ltT.astype(np.int32), matT.astype(np.int32)


def transform_vertices_T(positions, vert_obj, normals, colors, uvs,
                         model_mats, mvp_mats):
    """Vertex stage: (16, V) int32 table [clip4 | color4 | world normal3 |
    uv2 | world pos3] (float32 bits): ``geometry.vertex_rows`` stacked."""
    rows = vertex_rows(positions, vert_obj, normals, colors, uvs, model_mats,
                       mvp_mats)
    return sm.bitcast_i32(torch.stack(rows, dim=0))


def _guard_factors(cfg):
    gx = np.float32(1.0 + 2.0 * cfg.guard_px / cfg.width)
    gy = np.float32(1.0 + 2.0 * cfg.guard_px / cfg.height)
    return gx, gy


def triangle_setup(tblT, ltT, matT, cfg, tail_rows: int = 0):
    """Run triangle setup over all meshlets.

    tblT: (16, V) i32 (transform_vertices_T); ltT: (M, 384) i32; matT:
    (M, 128) i32.  Returns (comb (T + tail_rows, 128) i32, keys (T,),
    flags (T,), extx (T,), exty (T,)) with T = 128 * M; the tail rows are
    left for the clip tail to write.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    dev = tblT.device
    if dev.type == "cpu":
        return triangle_setup_plain(tblT, ltT, matT, cfg, tail_rows)
    if dev.type != "cuda":
        raise ValueError(f"triangle_setup: unsupported device {dev}")
    m = ltT.shape[0]
    t = m * MESHLET_TRIS
    for name, x, shape in (
        ("tblT", tblT, (N_TBL_ROWS, m * MESHLET_VERTS)),
        ("ltT", ltT, (m, 3 * MESHLET_TRIS)),
        ("matT", matT, (m, MESHLET_TRIS)),
    ):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"triangle_setup: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    comb = torch.empty((t + tail_rows, TBL_COLS), dtype=torch.int32, device=dev)
    keys, flags, extx, exty = (
        torch.empty(t, dtype=torch.int32, device=dev) for _ in range(4)
    )
    gx, gy = _guard_factors(cfg)
    _build.launch(
        KERNEL, "ash_triangle_setup", dev,
        tblT.data_ptr(), ltT.data_ptr(), matT.data_ptr(), comb.data_ptr(),
        keys.data_ptr(), flags.data_ptr(), extx.data_ptr(), exty.data_ptr(),
        m, tblT.shape[1], cfg.width, cfg.height, cfg.min_coord,
        cfg.max_coord_x, cfg.max_coord_y, cfg.subpixel_scale,
        float(gx), float(gy), cfg.grid_w, cfg.tile_h, cfg.n_tiles,
    )
    return comb, keys, flags, extx, exty


def triangle_setup_plain(tblT, ltT, matT, cfg, tail_rows: int = 0):
    """triangle_setup in torch ops (any device)."""
    dev = tblT.device
    i32 = torch.int32
    m = ltT.shape[0]
    t = m * MESHLET_TRIS
    ss = cfg.subpixel_scale
    gx, gy = (float(v) for v in _guard_factors(cfg))
    off = -cfg.min_coord
    lt = ltT.reshape(m, 3, MESHLET_TRIS)
    base = (torch.arange(m, device=dev) * MESHLET_VERTS)[:, None]

    def corner(c):
        loc = lt[:, c, :].long()
        ok = (loc >= 0).reshape(-1)
        g = tblT[:, (base + loc.clamp(min=0)).reshape(-1)]  # (16, T)
        g = torch.where(ok[None, :], g, torch.zeros_like(g))
        cx, cy, cz, cw = sm.bitcast_f32(g[0:4])
        iw_raw = sm.recip_spec(cw)
        iw = torch.where(torch.isfinite(iw_raw), iw_raw, torch.zeros_like(cw))

        def nd(v):
            r = v * iw
            return torch.where(torch.isfinite(r), r, torch.zeros_like(r))

        xi = sm.snap_coord(nd(cx), cfg.width, ss, cfg.min_coord,
                           cfg.max_coord_x)
        yi = sm.snap_coord(nd(cy), cfg.height, ss, cfg.min_coord,
                           cfg.max_coord_y)
        zq = sm.quantize_depth(nd(cz))
        # bits 0-5: guard planes; bits 6-9: screen side planes (g = 1)
        ds = (
            cz, cw - cz,
            gx * cw + cx, gx * cw - cx,
            gy * cw + cy, gy * cw - cy,
            cw + cx, cw - cx, cw + cy, cw - cy,
        )
        oc = torch.zeros_like(xi)
        for pi, d in enumerate(ds):
            oc = oc | ((d < 0).to(i32) << pi)
        return xi, yi, zq, iw, oc, g[4:16]

    xa, ya, za, ia, oca, attr_a = corner(0)
    xb, yb, zb, ib, ocb, attr_b = corner(1)
    xc, yc, zc, ic, occ, attr_c = corner(2)

    alive = (lt[:, 0, :] >= 0).reshape(-1)
    oc_and = oca & ocb & occ
    out_any = (oc_and & 0x3F) != 0
    all_in = ((oca | ocb | occ) & 0x3F) == 0
    out_screen = (oc_and >> 6) != 0
    fast = alive & all_in
    needs_clip = alive & ~all_in & ~out_any & ~out_screen
    sl = sm.shoelace2(xa, ya, xb, yb, xc, yc)
    valid = fast & (sl < 0)
    area2 = torch.where(valid, -sl, torch.ones_like(sl))
    inv_area2 = sm.recip_spec(area2.to(torch.float32))
    alive_m = (valid | needs_clip).reshape(m, MESHLET_TRIS).any(dim=1)
    alive_rows = alive_m.repeat_interleave(MESHLET_TRIS)

    def zi(v):
        return torch.where(valid, v, torch.zeros_like(v))

    rows = torch.zeros((t, TBL_COLS), dtype=i32, device=dev)
    head = [
        (zi(xa) + off) | ((zi(ya) + off) << 16),
        (zi(xc) + off) | ((zi(yc) + off) << 16),
        (zi(xb) + off) | ((zi(yb) + off) << 16),
        zi(za | (zc << 16)),
        zi(zb),
        zi(sm.bitcast_i32(inv_area2)),
        zi(sm.bitcast_i32(ia)), zi(sm.bitcast_i32(ic)), zi(sm.bitcast_i32(ib)),
        zi(matT.reshape(-1)),
    ]
    rows[:, :10] = torch.stack(head, dim=1)
    # attr corners in rewound order v0 = a, v1 = c, v2 = b (not masked)
    rows[:, 10:22] = attr_a.T
    rows[:, 22:34] = attr_c.T
    rows[:, 34:46] = attr_b.T
    rows[:, ID_COL] = torch.arange(t, dtype=i32, device=dev)
    comb = torch.zeros((t + tail_rows, TBL_COLS), dtype=i32, device=dev)
    comb[:t] = torch.where(alive_rows[:, None], rows, torch.zeros_like(rows))

    # streaming key and pixel AABB of the zeroed coords
    pxmin, pxmax, pymin, pymax = binsort.pixel_aabb_of(
        zi(xa), zi(ya), zi(xb), zi(yb), zi(xc), zi(yc), cfg
    )
    keys = binsort.keys_from_aabb(valid, pxmin, pxmax, pymin, pymax, cfg)
    flags = valid.to(i32) | (needs_clip.to(i32) << 1) | (fast.to(i32) << 2)
    extx = (pxmin & 0xFFFF) | (pxmax << 16)
    exty = (pymin & 0xFFFF) | (pymax << 16)
    return comb, keys, flags, extx.to(i32), exty.to(i32)
