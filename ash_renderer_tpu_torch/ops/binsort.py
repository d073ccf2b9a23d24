"""Sort-based triangle binning for the raster kernel (counterpart of
``ash_renderer_tpu/ops/binsort.py``).

Every setup row gets one streaming key: ``tile * 4 + group`` for coarse
rows (group encodes the AABB's spill into the right / lower neighbours:
0 = down+right, 1 = right, 2 = down, 3 = none), a per-(tile, 16-px window)
fine key for rows whose pixel AABB fits one window of one tile, the wide
key for rows spanning more than 2 tiles on an axis, and the dead key for
invalid rows.  Key space: coarse [0, n_tiles*4), fine [n_tiles*4,
n_tiles*12), wide n_tiles*12, dead n_tiles*12 + 1.

One stable sort gives the streaming order; the run-bounds kernel
(``bincount.sorted_run_bounds``) gives each key's run.  Equal keys may sit
in another order than the reference's sort puts them: frames do not depend
on it (the winner is an order-free minimum and phase D gathers by id).

Each function takes an optional tile-row window ``[tile_row0, tile_row0 +
tile_rows)``, a slab of a multi-device frame (``parallel/sharding.py``):
AABB rows are clamped to the window's pixel rows, tiles are counted from
its first row and the key space is the window's ``tile_rows * grid_w``
tiles.  The default window is the whole grid.
"""

from __future__ import annotations

import torch

from .tritables import unpack_coord_planes

GRP_DR = 0
GRP_R = 1
GRP_D = 2
GRP_NONE = 3
N_GRP = 4
FINE_W = 16  # fine window width in pixels
N_FINE = 8  # windows per 128-px tile
KEYS_PER_TILE = N_GRP + N_FINE


def pixel_aabb_of(x0, y0, x1, y1, x2, y2, cfg):
    """Inclusive pixel AABB (pxmin, pxmax, pymin, pymax) of the pixel
    centres a triangle's snapped coordinates can cover, clamped to the
    frame."""
    ss = cfg.subpixel_scale
    half = ss // 2
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    pxmin = torch.clamp((xmin - half + ss - 1) // ss, min=0)
    pxmax = torch.clamp((xmax - half) // ss, max=cfg.width - 1)
    pymin = torch.clamp((ymin - half + ss - 1) // ss, min=0)
    pymax = torch.clamp((ymax - half) // ss, max=cfg.height - 1)
    return pxmin, pxmax, pymin, pymax


def window_rows(cfg, tile_row0: int = 0, tile_rows=None):
    """(tile_rows, py_lo, py_hi) of the tile-row window [tile_row0,
    tile_row0 + tile_rows): its row count (the whole grid by default) and
    its first and last pixel rows on the screen.  A window that runs past
    the frame's last row (a padded slab) stops at height - 1; one wholly
    past it has py_lo > py_hi and keys nothing."""
    if tile_rows is None:
        tile_rows = cfg.grid_h
    py_lo = tile_row0 * cfg.tile_h
    py_hi = min((tile_row0 + tile_rows) * cfg.tile_h, cfg.height) - 1
    return tile_rows, py_lo, py_hi


def crop_window(vis_d, vis_t, cfg, whole: bool):
    """A raster's (rows, cols) vis planes of a window cropped to the frame's
    width, and for the whole grid (``whole``) to its height too: a slab
    keeps its rows, and the assembled frame is cropped once."""
    rows = cfg.height if whole else vis_d.shape[0]
    return vis_d[:rows, : cfg.width], vis_t[:rows, : cfg.width]


def stream_keys(valid, x0, y0, x1, y1, x2, y2, cfg, tile_row0: int = 0,
                tile_rows=None):
    """Per-row streaming key from snapped setup coordinates, for the
    tile-row window (the whole grid by default)."""
    return keys_from_aabb(valid, *pixel_aabb_of(x0, y0, x1, y1, x2, y2, cfg),
                          cfg, tile_row0, tile_rows)


def stream_keys_from_aabb(valid, extx, exty, cfg, tile_row0: int = 0,
                          tile_rows=None):
    """Streaming keys from the setup kernel's packed pixel AABBs (``min |
    max << 16``, each half signed, clamped to the frame), for the tile-row
    window: the keys ``stream_keys`` gives the same rows."""
    def lo(e):  # the low half, sign-extended
        return ((e & 0xFFFF) ^ 0x8000) - 0x8000

    return keys_from_aabb(valid, lo(extx), extx >> 16, lo(exty), exty >> 16,
                          cfg, tile_row0, tile_rows)


def keys_from_aabb(valid, pxmin, pxmax, pymin, pymax, cfg, tile_row0: int = 0,
                   tile_rows=None):
    """Streaming keys from frame-clamped pixel AABBs, for the tile-row
    window: rows are clamped again to the window's pixel rows and tiles
    counted from its first tile row."""
    tile_rows, py_lo, py_hi = window_rows(cfg, tile_row0, tile_rows)
    gw = cfg.grid_w
    n_tiles = tile_rows * gw
    pymin = torch.clamp(pymin, min=py_lo)
    pymax = torch.clamp(pymax, max=py_hi)
    live = valid & (pxmax >= pxmin) & (pymax >= pymin)
    tx0 = pxmin // cfg.tile_w
    tx1 = pxmax // cfg.tile_w
    ty0 = pymin // cfg.tile_h - tile_row0
    ty1 = pymax // cfg.tile_h - tile_row0
    spill_r = tx1 > tx0
    spill_d = ty1 > ty0
    wide = (tx1 - tx0 > 1) | (ty1 - ty0 > 1)
    grp = torch.where(
        spill_r & spill_d, GRP_DR,
        torch.where(spill_r, GRP_R, torch.where(spill_d, GRP_D, GRP_NONE)),
    ).to(torch.int32)
    tile = ty0 * gw + tx0
    fine = (grp == GRP_NONE) & (pxmin // FINE_W == pxmax // FINE_W)
    subc = (pxmin // FINE_W) % (cfg.tile_w // FINE_W)
    key_fine = n_tiles * N_GRP + tile * N_FINE + subc
    key = torch.where(
        live,
        torch.where(
            wide, n_tiles * KEYS_PER_TILE,
            torch.where(fine, key_fine, tile * N_GRP + grp),
        ),
        n_tiles * KEYS_PER_TILE + 1,
    )
    return key.to(torch.int32)


def bin_sort(su, cfg, tile_row0: int = 0, tile_rows=None):
    """(order, bounds) of a ``TriangleSetup``'s rows for the tile-row window
    (the whole grid by default): ``stream_keys``, then
    ``sort_and_bounds``."""
    key = stream_keys(su.valid, su.x0, su.y0, su.x1, su.y1, su.x2, su.y2,
                      cfg, tile_row0, tile_rows)
    return sort_and_bounds(key, cfg, tile_rows)


def sort_and_bounds(key, cfg, tile_rows=None):
    """Stable sort of the streaming keys of a window of ``tile_rows`` tile
    rows (the whole grid by default); returns (order, bounds) where
    bounds[k] is the first sorted position with key >= k, for every key k in
    [0, n_tiles*12 + 2), followed by S."""
    from .bincount import sorted_run_bounds

    n_tiles = window_rows(cfg, 0, tile_rows)[0] * cfg.grid_w
    key_sorted, order = torch.sort(key, stable=True)
    starts = sorted_run_bounds(key_sorted, n_tiles * KEYS_PER_TILE + 2)
    s = torch.full((1,), key.shape[0], dtype=torch.int32, device=key.device)
    return order.to(torch.int32), torch.cat([starts, s])


def expand_wide_pairs(comb, order, bounds, cfg, wide_rows: int,
                      wide_pairs: int, tile_row0: int = 0, tile_rows=None):
    """Expand the global wide run of the tile-row window (the whole grid by
    default) into exact per-tile (tile, row) pair runs.

    The first rows of the wide run whose pair runs fit the budgets
    (``wide_rows`` rows, ``wide_pairs`` pairs) are consumed; the rest stay
    in the global wide run that every tile streams, so the budgets change
    speed, never the frame.

    Returns (pair_rows (wide_pairs,) i32 comb-row ids sorted by tile,
    pair_starts (n_tiles + 1,) i32 run starts, new_wide_start int)."""
    dev = comb.device
    i32 = torch.int32
    tile_rows, py_lo, py_hi = window_rows(cfg, tile_row0, tile_rows)
    gw = cfg.grid_w
    n_tiles = tile_rows * gw
    s_rows = order.shape[0]
    ws = int(bounds[n_tiles * KEYS_PER_TILE])
    we = int(bounds[n_tiles * KEYS_PER_TILE + 1])
    n_wide = we - ws
    if n_wide <= 0:
        return (
            torch.zeros(wide_pairs, dtype=i32, device=dev),
            torch.zeros(n_tiles + 1, dtype=i32, device=dev),
            ws,
        )
    wrows = torch.zeros(wide_rows, dtype=i32, device=dev)
    take = min(wide_rows, s_rows - ws)
    wrows[:take] = order[ws : ws + take]
    idx = torch.arange(wide_rows, dtype=i32, device=dev)
    live_row = idx < min(n_wide, wide_rows)
    crows = comb[wrows.long(), 0:3]
    xy = [c for k in range(3) for c in unpack_coord_planes(crows[:, k], cfg)]
    pxmin, pxmax, pymin, pymax = pixel_aabb_of(*xy, cfg)
    pymin = torch.clamp(pymin, min=py_lo)
    pymax = torch.clamp(pymax, max=py_hi)
    live_r = live_row & (pxmax >= pxmin) & (pymax >= pymin)
    zero = torch.zeros_like(pxmin)
    tx0 = torch.where(live_r, pxmin // cfg.tile_w, zero)
    tx1 = torch.where(live_r, pxmax // cfg.tile_w, zero - 1)
    ty0 = torch.where(live_r, pymin // cfg.tile_h - tile_row0, zero)
    ty1 = torch.where(live_r, pymax // cfg.tile_h - tile_row0, zero - 1)
    ntx = tx1 - tx0 + 1
    c = torch.where(live_r, ntx * (ty1 - ty0 + 1), zero)
    ends = torch.cumsum(c, 0, dtype=i32)
    # a row is consumed when its whole pair run fits the budget; rows past
    # the first that does not fit stay in the global run (positional cut)
    fits = (ends <= wide_pairs) & live_row
    n_fit = int(fits.sum())
    total_fit = torch.where(fits, c, zero).sum()

    i_idx = torch.arange(wide_pairs, dtype=i32, device=dev)
    row_of = torch.searchsorted(ends, i_idx, right=True).to(i32)
    in_r = i_idx < total_fit
    r = torch.clamp(row_of, 0, wide_rows - 1).long()
    k = i_idx - (ends - c)[r]
    ntx_r = torch.clamp(ntx, min=1)[r]
    dy = k // ntx_r
    dx = k - dy * ntx_r
    tile = (ty0[r] + dy) * gw + (tx0[r] + dx)
    tile = torch.where(in_r, tile, torch.full_like(tile, n_tiles))
    tile_s, perm = torch.sort(tile, stable=True)
    pair_rows = torch.clamp(wrows[r], 0, s_rows - 1)[perm]
    qt = torch.arange(n_tiles + 1, dtype=i32, device=dev)
    pair_starts = torch.searchsorted(tile_s, qt, right=False).to(i32)
    return pair_rows, pair_starts, ws + n_fit


def stream_ranges_host(bounds, tile: int, gw: int, n_tiles: int):
    """The 6 position ranges of the sorted order that tile ``tile`` streams,
    in the reference's order: own coarse run, ABOVE prefix {dr, r, d}, LEFT
    prefix {dr, r}, DIAGONAL prefix {dr}, the global wide run, own fine run
    (``(0, 0)`` for a neighbour off the grid).  A host mirror of
    ``fused_kernel.build_range_meta`` without the wide-pair run, on numpy
    or tensor bounds."""
    def b(k):
        return int(bounds[k])

    tx, ty = tile % gw, tile // gw
    fb = n_tiles * N_GRP
    ranges = [(b(tile * N_GRP), b((tile + 1) * N_GRP))]
    for ok, nb, n_grp in ((ty > 0, tile - gw, 3), (tx > 0, tile - 1, 2),
                          (tx > 0 and ty > 0, tile - gw - 1, 1)):
        ranges.append((b(nb * N_GRP), b(nb * N_GRP + n_grp)) if ok else (0, 0))
    ranges.append((b(n_tiles * KEYS_PER_TILE), b(n_tiles * KEYS_PER_TILE + 1)))
    ranges.append((b(fb + tile * N_FINE), b(fb + (tile + 1) * N_FINE)))
    return ranges
