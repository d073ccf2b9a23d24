"""Raster + distribute: kernel K3 (phases V, D and E) and its phase F
variant K3F.

``rasterize_distribute`` launches ``csrc/raster.cu`` on CUDA tensors and
runs ``rasterize_distribute_plain`` (the same function in torch ops) on CPU
tensors.  It replaces the Pallas kernel ``ash_renderer_tpu/ops/
fused_kernel.py:_kernel`` (via ``rasterize_distribute``) with tiles of
``cfg.tile_h`` x 128, ``tile_h`` 8 (the default) or 4 (``TILE_HEIGHTS``, as
the reference's kernel takes): with ``shade_mode=None`` (K3) and with a
shade mode set (K3F, which runs the surface half of shading, ``_phase_f``,
inside the kernel).  The launch counts at 4 rows are kept apart
(``kernel_name``).

One CUDA block per tile.  The block streams the tile's 7 ranges from
``rmeta`` (own, above, left, diag, wide and own-fine read ``tbl_sorted``;
the wide-pair range reads ``tbl_ext``; both hold 8-word records,
``tritables.REC_COLS``) as one sequence, staging a chunk of records in
shared memory, each with its pixel box (``slot_pixel_boxes``:
the samples inside its vertex bbox, clipped to the tile and, for fine
rows, to their own 16-px window, as the reference's packed fine path
does) as a mask of the warps the box touches.  Each warp owns an 8-column
footprint of the tile and evaluates only the records whose box touches
it; each lane keeps the minimum of (d16, -id) for its own pixels, which is
exact and independent of order, so no atomics are needed.  Phase D reads
the winner's 48 columns straight from the unsorted comb table (row index =
id) in 16-byte loads, replacing the reference's second stream and
byte-plane matmuls; phase E is ``shade.interp_fields_stacked`` op for op.

What bounds it on the card: device memory (the 199 MB of planes written
on the static 1.31M-triangle headline frame, the winners' rows and the
streamed records).  Before the cull, phase V evaluated every streamed
slot at all 1024 pixels of its 8-row tile (3.95 x 10^8 slot-pixel
evaluations for 974,034 covered pixels there) and integer throughput bound
it; the
boxes leave only the pixels ``slot_pixel_boxes`` counts, which is also the
operation count of the kernel's bound in ``chip_smoke.py``.  Phase F adds
~160 float ops per pixel.

Planes, (n_tiles, 24, tile_h * 128) int32 per tile pixel (row*128 +
col).  Phase E layout (``shade_mode=None``): rows 0-11 interpolated
attributes, 12-15 raw uv screen derivatives, 16 material.  Phase F layout (``F_*`` below): the
material-modulated colour, diffuse, specular, lit mask and the bilinear tap
address.  Both: 17 winner ids (-1 background), 18-23 zero.  Background
pixels carry the NaN attributes the spec's zero fields give; consumers mask
them by row 17.

A slab of a multi-device frame (``parallel/sharding.py``) runs the same
kernel over the tiles of its tile-row window: ``tile_row0`` (the slab's
first tile row, a kernel argument) moves every sample row to the screen's,
``tile_rows`` sizes the grid and the outputs, and the vis planes come back
whole, for the frame to be cropped once.

Phase F reads its tables (materials, mip levels, light, camera position)
from a small int32 constants tensor (``shade.pack_shade_consts``) that each
block stages in shared memory; the reference's select trees over those
tables become indexed loads on the same clamped indices.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import specmath as sm
from .binsort import (FINE_W, KEYS_PER_TILE, N_FINE, N_GRP, crop_window,
                      window_rows)
from .shade import interp_fields_stacked, shade_consts_layout, surface_prelight
from .tritables import REC_ID, REC_WORDS, TBL_COLS, unpack_coord_planes

N_RANGES = 7  # own, above, left, diag, wide, wide-pairs(ext), own-fine
EXT_RANGE = 5
FINE_RANGE = 6
RMETA_COLS = 2  # rs, re per (tile, range)
TILE_H = 8  # the default tile height; the kernel takes cfg.tile_h
TILE_HEIGHTS = (4, 8)
TILE_W = 128
N_PIX = TILE_H * TILE_W  # pixels of a default tile
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


def kernel_name(tile_h: int, shade: bool) -> str:
    """The launch count the kernel adds to: ``KERNEL`` (K3) or ``KERNEL_F``
    (K3F) on the default 8-row tiles, with ``_t4`` on 4-row ones."""
    name = KERNEL_F if shade else KERNEL
    return name if tile_h == TILE_H else f"{name}_t{tile_h}"


def check_tiles(cfg) -> None:
    """Raise ValueError unless ``cfg``'s tiles are 4 or 8 rows by 128."""
    if cfg.tile_h not in TILE_HEIGHTS or cfg.tile_w != TILE_W:
        raise ValueError(f"rasterize_distribute: tiles are {cfg.tile_h}x"
                         f"{cfg.tile_w}, not 4x128 or 8x128")


def build_range_meta(bounds, n_tiles: int, gw: int, pair_starts, wide_start):
    """(n_tiles * 7 * 2,) int32: [rs, re] per (tile, range).  Ranges per
    tile: own coarse run, ABOVE prefix {dr, r, d}, LEFT prefix {dr, r},
    DIAGONAL prefix {dr}, global wide run (from ``wide_start``), wide-pair
    run (``pair_starts``), own fine run.  ``n_tiles``: the tiles of the
    window the bounds were sorted for.  The reference's layout ends in one
    more word, the first tile row of a slab; the port passes it to the
    kernel as an argument (``rasterize_distribute``'s ``tile_row0``) and
    leaves it out."""
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
    # the kernel reads table rows in 16-byte loads
    if (x.device != dev or x.dtype != torch.int32 or x.dim() != ndim
            or not x.is_contiguous() or (cols is not None and x.shape[1] != cols)
            or (cols is not None and x.data_ptr() % 16)):
        raise ValueError(
            f"rasterize_distribute: bad {name} {x.dtype} {tuple(x.shape)} "
            f"on {x.device}"
        )


def rasterize_distribute(rmeta, tbl_sorted, tbl_ext, comb, cfg,
                         shade_mode=None, consts=None, tile_row0: int = 0,
                         tile_rows=None):
    """Visibility + winner-field distribute + interpolation over the tiles
    of the tile-row window [tile_row0, tile_row0 + tile_rows) (the whole
    grid by default), and with ``shade_mode`` set
    (``pipeline.shade_mode_for``) the surface half of shading from
    ``consts`` (``shade.pack_shade_consts``), on tiles of ``cfg.tile_h``
    (4 or 8) x 128.  ``tbl_sorted`` and ``tbl_ext``: (N, 8) int32 records
    (``tritables.REC_COLS``) in streaming order and of the wide pairs;
    ``comb``: the (S, 128) unsorted table phase D reads the winners from.
    Returns (vis_d, vis_t) and planes (n_tiles, 24,
    tile_h * 128) int32; the vis planes are cropped to
    (height, width) for the whole grid and to the width only for a window
    given by ``tile_rows``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (K3, or K3F with a shade mode)."""
    dev = rmeta.device
    check_tiles(cfg)
    if dev.type == "cpu":
        return rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb,
                                          cfg, shade_mode, consts, tile_row0,
                                          tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_distribute: unsupported device {dev}")
    whole = tile_rows is None
    tile_rows = window_rows(cfg, tile_row0, tile_rows)[0]
    n_tiles = tile_rows * cfg.grid_w
    _check("rmeta", rmeta, dev, 1)
    if rmeta.shape[0] != n_tiles * N_RANGES * RMETA_COLS:
        raise ValueError("rasterize_distribute: rmeta does not fit the grid")
    _check("tbl_sorted", tbl_sorted, dev, 2, REC_WORDS)
    _check("tbl_ext", tbl_ext, dev, 2, REC_WORDS)
    _check("comb", comb, dev, 2, TBL_COLS)
    hp, wp = tile_rows * cfg.tile_h, cfg.grid_w * TILE_W
    vis_d = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    vis_t = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    planes = torch.empty((n_tiles, OUT_COLS, cfg.tile_h * TILE_W),
                         dtype=torch.int32, device=dev)
    args = (rmeta.data_ptr(), tbl_sorted.data_ptr(), tbl_ext.data_ptr(),
            comb.data_ptr(), vis_d.data_ptr(), vis_t.data_ptr(),
            planes.data_ptr(), n_tiles, cfg.grid_w, cfg.min_coord,
            cfg.subpixel_scale, tile_row0, cfg.tile_h)
    if shade_mode is None:
        _build.launch(kernel_name(cfg.tile_h, False),
                      "ash_rasterize_distribute", dev, *args)
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
            kernel_name(cfg.tile_h, True), "ash_rasterize_shade", dev, *args,
            consts.data_ptr(),
            consts.shape[0], m_n, t_n, int(has_m), int(has_a), int(has_l),
        )
    return (*crop_window(vis_d, vis_t, cfg, whole), planes)


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


def slot_pixel_boxes(rmeta, tbl_sorted, tbl_ext, cfg, tile_row0: int = 0):
    """The pixel box of every streamed (tile, slot), in streaming order: the
    tile's pixels whose sample ``px*ss + ss/2`` lies in the record's vertex
    bbox, and for own-fine rows only those in the record's 16-px window
    (the reference's window rule).  No pixel outside its box is covered, so
    the box is the work K3 has to do for the slot; the kernel culls to it
    (``csrc/raster.cu`` states why that is exact).  Returns (tile, range,
    box): tile and range index per slot, and (N, 4) int32 [col0, col1,
    row0, row1], inclusive and tile-local, empty where col0 > col1 or
    row0 > row1.  ``tile_row0``: the first tile row of the window the
    range meta was built for (tile t lies at tile row t // grid_w +
    tile_row0 of the screen)."""
    ss = cfg.subpixel_scale
    half = ss // 2
    tile, rng, pos = _range_pairs(rmeta,
                                  rmeta.shape[0] // (N_RANGES * RMETA_COLS))
    ext = rng == EXT_RANGE
    c = torch.empty((pos.shape[0], 3), dtype=torch.int32, device=rmeta.device)
    c[ext] = tbl_ext[pos[ext], :3]
    c[~ext] = tbl_sorted[pos[~ext], :3]
    x = (c & 0xFFFF) + cfg.min_coord
    y = ((c >> 16) & 0xFFFF) + cfg.min_coord
    px_lo = (x.amin(1) - half + ss - 1).div(ss, rounding_mode="floor")
    px_hi = (x.amax(1) - half).div(ss, rounding_mode="floor")
    py_lo = (y.amin(1) - half + ss - 1).div(ss, rounding_mode="floor")
    py_hi = (y.amax(1) - half).div(ss, rounding_mode="floor")
    x0 = (tile % cfg.grid_w).to(torch.int32) * TILE_W
    y0 = (tile // cfg.grid_w + tile_row0).to(torch.int32) * cfg.tile_h
    col0 = torch.clamp(px_lo - x0, min=0)
    col1 = torch.clamp(px_hi - x0, max=TILE_W - 1)
    fine = rng == FINE_RANGE
    w0 = torch.clamp(px_lo, min=0) % TILE_W // FINE_W * FINE_W
    col0 = torch.where(fine, torch.maximum(col0, w0), col0)
    col1 = torch.where(fine, torch.minimum(col1, w0 + FINE_W - 1), col1)
    box = torch.stack([col0, col1, torch.clamp(py_lo - y0, min=0),
                       torch.clamp(py_hi - y0, max=cfg.tile_h - 1)], dim=1)
    return tile, rng, box.to(torch.int32)


def box_pixels(box):
    """Pixels in each box of ``slot_pixel_boxes`` (0 for an empty one)."""
    w = torch.clamp(box[:, 1] - box[:, 0] + 1, min=0)
    h = torch.clamp(box[:, 3] - box[:, 2] + 1, min=0)
    return w.long() * h.long()


def rasterize_distribute_plain(rmeta, tbl_sorted, tbl_ext, comb, cfg,
                               shade_mode=None, consts=None,
                               tile_row0: int = 0, tile_rows=None):
    """rasterize_distribute in torch ops (any device): every streamed
    (tile, slot) pair is evaluated at the tile's tile_h * 128 pixels in
    chunks, and
    the per-pixel minimum of (d16, -id) is a scatter-min of a packed 64-bit
    key; with ``shade_mode`` set, rows 0-16 take the phase F layout
    (``phase_f_plain``).  The window as in ``rasterize_distribute``."""
    dev = rmeta.device
    check_tiles(cfg)
    i32, i64 = torch.int32, torch.int64
    whole = tile_rows is None
    tile_rows = window_rows(cfg, tile_row0, tile_rows)[0]
    n_tiles = tile_rows * cfg.grid_w
    if rmeta.shape[0] != n_tiles * N_RANGES * RMETA_COLS:
        raise ValueError("rasterize_distribute: rmeta does not fit the grid")
    gw, th = cfg.grid_w, cfg.tile_h
    n_pix = th * TILE_W
    ss = cfg.subpixel_scale
    half = ss // 2
    min_c = cfg.min_coord
    tile, rng, pos = _range_pairs(rmeta, n_tiles)
    pix = torch.arange(n_pix, device=dev)
    col, row = (pix % TILE_W).to(i32), (pix // TILE_W).to(i32)
    bg_key = (sm.DEPTH_MAX << 32) | (0x7FFFFFFF - sm.BG_TRI)
    best = torch.full((n_tiles * n_pix,), bg_key, dtype=i64, device=dev)

    def unpack16(p):
        return (p & 0xFFFF) + min_c, ((p >> 16) & 0xFFFF) + min_c

    for c0 in range(0, tile.shape[0], PLAIN_CHUNK):
        t_c, r_c, p_c = (v[c0 : c0 + PLAIN_CHUNK] for v in (tile, rng, pos))
        ext = r_c == EXT_RANGE
        rec = torch.empty((t_c.shape[0], REC_WORDS), dtype=i32, device=dev)
        rec[ext] = tbl_ext[p_c[ext]]
        rec[~ext] = tbl_sorted[p_c[~ext]]
        x0, y0 = unpack16(rec[:, 0:1])
        x1, y1 = unpack16(rec[:, 1:2])
        x2, y2 = unpack16(rec[:, 2:3])
        zq0 = rec[:, 3:4] & 0xFFFF
        zq1 = (rec[:, 3:4] >> 16) & 0xFFFF
        zq2 = rec[:, 4:5]
        inv_area = sm.bitcast_f32(rec[:, 5:6])
        ids = rec[:, REC_ID:REC_ID + 1]
        tx = (t_c % gw).to(i32)[:, None]
        ty = (t_c // gw + tile_row0).to(i32)[:, None]
        sx, sy = sm.pixel_sample_coords(tx * TILE_W + col, ty * th + row, ss)
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
        dst = (t_c[:, None] * n_pix + pix).expand_as(key)
        best.scatter_reduce_(0, dst[cov], key[cov], reduce="amin")
    vis_d = (best >> 32).to(i32)
    vis_t = (0x7FFFFFFF - (best & 0xFFFFFFFF)).to(i32)

    # phase D: the winner's fields straight from the comb table
    won = vis_t >= 0
    o = torch.where(
        won[:, None],
        comb[torch.clamp(vis_t, min=0).long(), :COMB_USED],
        torch.zeros((), dtype=i32, device=dev),
    ).reshape(n_tiles, n_pix, COMB_USED)
    planes = torch.zeros((n_tiles, OUT_COLS, n_pix), dtype=i32, device=dev)
    tt = torch.arange(n_tiles, device=dev)[:, None]
    px = (tt % gw) * TILE_W + (pix % TILE_W)
    py = (tt // gw + tile_row0) * th + pix // TILE_W
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
    planes[:, VIS_ROW] = vis_t.reshape(n_tiles, n_pix)
    hp, wp = tile_rows * th, gw * TILE_W

    def to_image(v):
        return (v.reshape(tile_rows, gw, th, TILE_W).permute(0, 2, 1, 3)
                .reshape(hp, wp))

    return (*crop_window(to_image(vis_d), to_image(vis_t), cfg, whole),
            planes)


def phase_e(o, px, py, cfg):
    """Phase E: (..., N, 48) winner fields -> (attr (..., 12, N) f32, the 4
    raw uv derivatives (..., N) f32, material (..., N) i32)."""
    o = o.movedim(-1, -2)  # (..., 48, N)
    g = {}
    for c in range(3):
        g[f"x{c}"], g[f"y{c}"] = unpack_coord_planes(o[..., c, :], cfg)
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
