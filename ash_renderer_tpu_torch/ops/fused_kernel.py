"""Raster + distribute: kernel K3 (phases V, D and E) and its phase F
variant K3F.

``rasterize_distribute`` launches ``csrc/raster.cu`` on CUDA tensors and
runs ``rasterize_distribute_plain`` (the same function in torch ops) on CPU
tensors.  It replaces the Pallas kernel ``ash_renderer_tpu/ops/
fused_kernel.py:_kernel`` (via ``rasterize_distribute``) with 8x128 tiles:
with ``shade_mode=None`` (K3) and with a shade mode set (K3F, which runs the
surface half of shading, ``_phase_f``, inside the kernel).

One CUDA block per 8x128 tile, one thread per pixel.  The block walks the
tile's 7 ranges from ``rmeta`` (own, above, left, diag, wide and own-fine
read ``tbl_sorted``; the wide-pair range reads ``tbl_ext``), staging a
chunk of records in shared memory; each thread keeps the minimum of
(d16, -id) for its own pixel, which is exact and independent of order, so
no atomics are needed.  Fine-range rows are evaluated only over their own
16-px window, as the reference's packed fine path does.  Phase D gathers the
winner's 48 columns straight from the unsorted comb table (row index = id),
replacing the reference's second stream and byte-plane matmuls; phase E is
``shade.interp_fields_stacked`` op for op.

What bounds it on the card: integer issue in phase V (every streamed slot
is evaluated at all 1024 pixels of its tile: 3.9 x 10^8 slot-pixel
evaluations on the static 1.31M-triangle headline frame) and, for phase E,
the 199 MB of planes written.  Phase F adds ~160 float ops per covered
pixel, small beside phase V.

Planes, (n_tiles, 24, 1024) int32 per tile pixel (row*128 + col).  Phase E
layout (``shade_mode=None``): rows 0-11 interpolated attributes, 12-15 raw
uv screen derivatives, 16 material.  Phase F layout (``F_*`` below): the
material-modulated colour, diffuse, specular, lit mask and the bilinear tap
address.  Both: 17 winner ids (-1 background), 18-23 zero.  Background
pixels carry the NaN attributes the spec's zero fields give; consumers mask
them by row 17.

Phase F reads its tables (materials, mip levels, light, camera position)
from a small int32 constants tensor (``shade.pack_shade_consts``) that each
block stages in shared memory; the reference's select trees over those
tables become indexed loads on the same clamped indices.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import specmath as sm
from .binsort import FINE_W, KEYS_PER_TILE, N_FINE, N_GRP
from .shade import interp_fields_stacked, shade_consts_layout, surface_prelight
from .tritables import ID_COL, TBL_COLS

N_RANGES = 7  # own, above, left, diag, wide, wide-pairs(ext), own-fine
EXT_RANGE = 5
FINE_RANGE = 6
RMETA_COLS = 2  # rs, re per (tile, range)
TILE_H = 8
TILE_W = 128
N_PIX = TILE_H * TILE_W
COMB_USED = 48  # comb columns phase D gathers
OUT_COLS = 24
VIS_ROW = 17  # planes row carrying the winner ids
KERNEL = "K3_raster"
KERNEL_F = "K3F_raster_shade"

# Phase F plane layout (shade_mode set): rows
#   0-3  P = colour * material base (f32 bits)
#   4-6  diffuse rgb (f32)        7  specular scalar (f32)
#   8    lit mask (i32 0/1)       9  bilinear tap index (i32)
#   10   fu (f32)   11 fv (f32)   12 texmask (i32 0/1)
#   13-16 zero
F_P, F_DIFF, F_SPEC, F_LIT, F_TAP, F_FU, F_FV, F_TEXMASK = (
    0, 4, 7, 8, 9, 10, 11, 12
)
MAX_SHADE_M = 16  # pipeline.shade_mode_for's table caps
MAX_SHADE_T = 2
PLAIN_CHUNK = 2048  # (tile, slot) pairs per step of the plain version


def build_range_meta(bounds, n_tiles: int, gw: int, pair_starts, wide_start):
    """(n_tiles * 7 * 2,) int32: [rs, re] per (tile, range).  Ranges per
    tile: own coarse run, ABOVE prefix {dr, r, d}, LEFT prefix {dr, r},
    DIAGONAL prefix {dr}, global wide run (from ``wide_start``), wide-pair
    run (``pair_starts``), own fine run.  The reference's layout ends in one
    more word, the first tile row of a mesh-sharded slab; the port renders
    the whole frame on one device and leaves it out."""
    dev = bounds.device
    i32 = torch.int32
    tt = torch.arange(n_tiles, device=dev)
    tx_ok = tt % gw > 0
    ty_ok = tt // gw > 0
    c = [bounds[k : N_GRP * n_tiles : N_GRP] for k in range(N_GRP)]
    fb = N_GRP * n_tiles
    fine0 = bounds[fb : fb + N_FINE * n_tiles : N_FINE]
    wide_s = bounds[KEYS_PER_TILE * n_tiles : KEYS_PER_TILE * n_tiles + 1]
    wide_e = bounds[KEYS_PER_TILE * n_tiles + 1 : KEYS_PER_TILE * n_tiles + 2]
    zero = torch.zeros(n_tiles, dtype=i32, device=dev)

    def shift(x, k, ok):  # value of tile t-k where ok, else 0
        if k >= n_tiles:
            return zero
        v = torch.cat([torch.zeros(k, dtype=i32, device=dev), x[: n_tiles - k]])
        return torch.where(ok, v, zero)

    own = (c[0], torch.cat([c[0][1:], bounds[fb : fb + 1]]))
    above = (shift(c[0], gw, ty_ok), shift(c[3], gw, ty_ok))
    left = (shift(c[0], 1, tx_ok), shift(c[2], 1, tx_ok))
    dg_ok = tx_ok & ty_ok
    diag = (shift(c[0], gw + 1, dg_ok), shift(c[1], gw + 1, dg_ok))
    ws = torch.full((1,), int(wide_start), dtype=i32, device=dev)
    wide = (ws.expand(n_tiles), wide_e.expand(n_tiles))
    pairs = (pair_starts[:-1], pair_starts[1:])
    fine = (fine0, torch.cat([fine0[1:], wide_s]))
    meta = torch.stack(
        [torch.stack(p, dim=-1) for p in (own, above, left, diag, wide,
                                          pairs, fine)],
        dim=1,
    )  # (n_tiles, 7, 2)
    rs = meta[..., 0]
    re = torch.maximum(meta[..., 1], rs)
    return torch.stack([rs, re], dim=-1).reshape(-1)


def _check(name, x, dev, ndim, cols=None):
    if (x.device != dev or x.dtype != torch.int32 or x.dim() != ndim
            or not x.is_contiguous() or (cols is not None and x.shape[1] != cols)):
        raise ValueError(
            f"rasterize_distribute: bad {name} {x.dtype} {tuple(x.shape)} "
            f"on {x.device}"
        )


def rasterize_distribute(rmeta, tbl_sorted, tbl_ext, comb, cfg,
                         shade_mode=None, consts=None):
    """Visibility + winner-field distribute + interpolation over the tile
    grid, and with ``shade_mode`` set (``pipeline.shade_mode_for``) the
    surface half of shading from ``consts`` (``shade.pack_shade_consts``).
    Returns (vis_d, vis_t) cropped to (height, width) and planes
    (n_tiles, 24, 1024) int32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (K3, or K3F with a shade mode)."""
    dev = rmeta.device
    if cfg.tile_h != TILE_H or cfg.tile_w != TILE_W:
        raise ValueError("rasterize_distribute: tiles must be 8x128")
    if dev.type == "cpu":
        return rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb,
                                          cfg, shade_mode, consts)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_distribute: unsupported device {dev}")
    n_tiles = cfg.n_tiles
    _check("rmeta", rmeta, dev, 1)
    if rmeta.shape[0] != n_tiles * N_RANGES * RMETA_COLS:
        raise ValueError("rasterize_distribute: rmeta does not fit the grid")
    _check("tbl_sorted", tbl_sorted, dev, 2, TBL_COLS)
    _check("tbl_ext", tbl_ext, dev, 2, TBL_COLS)
    _check("comb", comb, dev, 2, TBL_COLS)
    hp, wp = cfg.grid_h * TILE_H, cfg.grid_w * TILE_W
    vis_d = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    vis_t = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    planes = torch.empty((n_tiles, OUT_COLS, N_PIX), dtype=torch.int32,
                         device=dev)
    args = (rmeta.data_ptr(), tbl_sorted.data_ptr(), tbl_ext.data_ptr(),
            comb.data_ptr(), vis_d.data_ptr(), vis_t.data_ptr(),
            planes.data_ptr(), n_tiles, cfg.grid_w, cfg.min_coord,
            cfg.subpixel_scale)
    if shade_mode is None:
        _build.launch(KERNEL, "ash_rasterize_distribute", dev, *args)
    else:
        m_n, t_n, has_m, has_a, has_l = shade_mode
        if m_n > MAX_SHADE_M or t_n > MAX_SHADE_T:
            raise ValueError(f"rasterize_distribute: shade mode {shade_mode} "
                             "is over the kernel's table caps")
        _check("consts", consts, dev, 1)
        if consts.shape[0] != shade_consts_layout(shade_mode)["_total"]:
            raise ValueError("rasterize_distribute: consts do not fit the "
                             f"shade mode {shade_mode}")
        _build.launch(
            KERNEL_F, "ash_rasterize_shade", dev, *args, consts.data_ptr(),
            consts.shape[0], m_n, t_n, int(has_m), int(has_a), int(has_l),
        )
    return vis_d[: cfg.height, : cfg.width], vis_t[: cfg.height, : cfg.width], planes


def _range_pairs(rmeta, n_tiles):
    """Flatten every (tile, range) run into (tile, range, position) triples."""
    dev = rmeta.device
    m = rmeta.reshape(n_tiles, N_RANGES, RMETA_COLS).long()
    rs, re = m[..., 0], m[..., 1]
    lens = (re - rs).reshape(-1)
    total = int(lens.sum())
    run = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens)
    starts = torch.cumsum(lens, 0) - lens
    pos = rs.reshape(-1)[run] + (torch.arange(total, device=dev) - starts[run])
    return run // N_RANGES, run % N_RANGES, pos


def rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb, cfg,
                               shade_mode=None, consts=None):
    """rasterize_distribute in torch ops (any device): every streamed
    (tile, slot) pair is evaluated at the tile's 1024 pixels in chunks, and
    the per-pixel minimum of (d16, -id) is a scatter-min of a packed 64-bit
    key; with ``shade_mode`` set, rows 0-16 take the phase F layout
    (``phase_f_plain``)."""
    dev = rmeta.device
    i32, i64 = torch.int32, torch.int64
    n_tiles = cfg.n_tiles
    gw = cfg.grid_w
    ss = cfg.subpixel_scale
    half = ss // 2
    min_c = cfg.min_coord
    tile, rng, pos = _range_pairs(rmeta, n_tiles)
    pix = torch.arange(N_PIX, device=dev)
    col, row = (pix % TILE_W).to(i32), (pix // TILE_W).to(i32)
    bg_key = (sm.DEPTH_MAX << 32) | (0x7FFFFFFF - sm.BG_TRI)
    best = torch.full((n_tiles * N_PIX,), bg_key, dtype=i64, device=dev)
    rec_cols = torch.tensor([0, 1, 2, 3, 4, 5, ID_COL], device=dev)

    def unpack16(p):
        return (p & 0xFFFF) + min_c, ((p >> 16) & 0xFFFF) + min_c

    for c0 in range(0, tile.shape[0], PLAIN_CHUNK):
        t_c, r_c, p_c = (v[c0 : c0 + PLAIN_CHUNK] for v in (tile, rng, pos))
        ext = r_c == EXT_RANGE
        rec = torch.empty((t_c.shape[0], 7), dtype=i32, device=dev)
        rec[ext] = tbl_ext[p_c[ext]][:, rec_cols]
        rec[~ext] = tbl_sorted[p_c[~ext]][:, rec_cols]
        x0, y0 = unpack16(rec[:, 0:1])
        x1, y1 = unpack16(rec[:, 1:2])
        x2, y2 = unpack16(rec[:, 2:3])
        zq0 = rec[:, 3:4] & 0xFFFF
        zq1 = (rec[:, 3:4] >> 16) & 0xFFFF
        zq2 = rec[:, 4:5]
        inv_area = sm.bitcast_f32(rec[:, 5:6])
        ids = rec[:, 6:7]
        tx = (t_c % gw).to(i32)[:, None]
        ty = (t_c // gw).to(i32)[:, None]
        sx, sy = sm.pixel_sample_coords(tx * TILE_W + col, ty * TILE_H + row, ss)
        a0, b0, tl0 = sm.edge_coeffs(x1, y1, x2, y2)
        a1, b1, tl1 = sm.edge_coeffs(x2, y2, x0, y0)
        a2, b2, tl2 = sm.edge_coeffs(x0, y0, x1, y1)
        e0 = sm.edge_at(a0, b0, x1, y1, sx, sy)
        e1 = sm.edge_at(a1, b1, x2, y2, sx, sy)
        e2 = sm.edge_at(a2, b2, x0, y0, sx, sy)
        cov = (e0 >= 1 - tl0.to(i32)) & (e1 >= 1 - tl1.to(i32)) & (
            e2 >= 1 - tl2.to(i32)
        )
        # fine rows: only their own 16-px window of the tile
        xmin = torch.minimum(torch.minimum(x0, x1), x2)
        pxmin = torch.clamp((xmin - half + ss - 1) // ss, min=0)
        win = (pxmin % TILE_W) // FINE_W
        cov = cov & ((r_c != FINE_RANGE)[:, None] | (col // FINE_W == win))
        d16 = sm.interp_depth16(e0, e1, e2, inv_area, zq0, zq1, zq2)
        key = (d16.to(i64) << 32) | (0x7FFFFFFF - ids).to(i64)
        dst = (t_c[:, None] * N_PIX + pix).expand_as(key)
        best.scatter_reduce_(0, dst[cov], key[cov], reduce="amin")
    vis_d = (best >> 32).to(i32)
    vis_t = (0x7FFFFFFF - (best & 0xFFFFFFFF)).to(i32)

    # phase D: the winner's fields straight from the comb table
    won = vis_t >= 0
    o = torch.where(
        won[:, None],
        comb[torch.clamp(vis_t, min=0).long(), :COMB_USED],
        torch.zeros((), dtype=i32, device=dev),
    ).reshape(n_tiles, N_PIX, COMB_USED)
    planes = torch.zeros((n_tiles, OUT_COLS, N_PIX), dtype=i32, device=dev)
    tt = torch.arange(n_tiles, device=dev)[:, None]
    px = (tt % gw) * TILE_W + (pix % TILE_W)
    py = (tt // gw) * TILE_H + pix // TILE_W
    attr, duv, mat = phase_e(o, px.to(i32), py.to(i32), cfg)
    if shade_mode is None:
        planes[:, :VIS_ROW] = torch.cat(
            [sm.bitcast_i32(attr)]
            + [sm.bitcast_i32(d)[..., None, :] for d in duv]
            + [mat[..., None, :]],
            dim=-2,
        )
    else:
        planes[:, :VIS_ROW] = phase_f_plain(attr, duv, mat, shade_mode, consts)
    planes[:, VIS_ROW] = vis_t.reshape(n_tiles, N_PIX)
    hp, wp = cfg.grid_h * TILE_H, cfg.grid_w * TILE_W

    def to_image(v):
        return (
            v.reshape(cfg.grid_h, gw, TILE_H, TILE_W).permute(0, 2, 1, 3)
            .reshape(hp, wp)[: cfg.height, : cfg.width]
        )

    return to_image(vis_d), to_image(vis_t), planes


def phase_e(o, px, py, cfg):
    """Phase E: (..., N, 48) winner fields -> (attr (..., 12, N) f32, the 4
    raw uv derivatives (..., N) f32, material (..., N) i32)."""
    off = -cfg.min_coord
    o = o.movedim(-1, -2)  # (..., 48, N)

    def oxy(c):
        p = o[..., c, :]
        return (p & 0xFFFF) - off, ((p >> 16) & 0xFFFF) - off

    g = {}
    g["x0"], g["y0"] = oxy(0)
    g["x1"], g["y1"] = oxy(1)
    g["x2"], g["y2"] = oxy(2)
    g["inv_area2"] = sm.bitcast_f32(o[..., 5, :])
    g["iw0"] = sm.bitcast_f32(o[..., 6, :])
    g["iw1"] = sm.bitcast_f32(o[..., 7, :])
    g["iw2"] = sm.bitcast_f32(o[..., 8, :])
    a0 = sm.bitcast_f32(o[..., 10:22, :])
    a1 = sm.bitcast_f32(o[..., 22:34, :])
    a2 = sm.bitcast_f32(o[..., 34:46, :])
    attr, duv = interp_fields_stacked(g, a0, a1, a2, px, py, cfg)
    return attr, duv, o[..., 9, :]


def phase_f_plain(attr, duv, mat_row, shade_mode, consts):
    """Phase F in torch ops: ``shade.surface_prelight`` (the reference's
    ``_phase_f``, op for op) laid out as the (..., 17, N) int32 rows 0-16 of
    the F layout."""
    p, diffuse, spec, lit, tap, fu, fv, texmask = surface_prelight(
        attr, duv, mat_row, shade_mode, consts)
    rows = [sm.bitcast_i32(spec), lit, tap, sm.bitcast_i32(fu),
            sm.bitcast_i32(fv), texmask]
    rows += [torch.zeros_like(lit)] * (VIS_ROW - F_TEXMASK - 1)
    return torch.cat([sm.bitcast_i32(p), sm.bitcast_i32(diffuse),
                      torch.stack(rows, dim=-2)], dim=-2)
