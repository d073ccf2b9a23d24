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
"""

from __future__ import annotations

import torch

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


def stream_keys(valid, x0, y0, x1, y1, x2, y2, cfg):
    """Per-row streaming key from snapped setup coordinates."""
    return keys_from_aabb(valid, *pixel_aabb_of(x0, y0, x1, y1, x2, y2, cfg),
                          cfg)


def keys_from_aabb(valid, pxmin, pxmax, pymin, pymax, cfg):
    """Streaming keys from clamped pixel AABBs."""
    gw = cfg.grid_w
    n_tiles = cfg.n_tiles
    live = valid & (pxmax >= pxmin) & (pymax >= pymin)
    tx0 = pxmin // cfg.tile_w
    tx1 = pxmax // cfg.tile_w
    ty0 = pymin // cfg.tile_h
    ty1 = pymax // cfg.tile_h
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


def sort_and_bounds(key, cfg):
    """Stable sort of the streaming keys; returns (order, bounds) where
    bounds[k] is the first sorted position with key >= k, for every key k in
    [0, n_tiles*12 + 2), followed by S."""
    from .bincount import sorted_run_bounds

    key_sorted, order = torch.sort(key, stable=True)
    starts = sorted_run_bounds(key_sorted, cfg.n_tiles * KEYS_PER_TILE + 2)
    s = torch.full((1,), key.shape[0], dtype=torch.int32, device=key.device)
    return order.to(torch.int32), torch.cat([starts, s])


def expand_wide_pairs(comb, order, bounds, cfg, wide_rows: int,
                      wide_pairs: int):
    """Expand the global wide run into exact per-tile (tile, row) pair runs.

    The first rows of the wide run whose pair runs fit the budgets
    (``wide_rows`` rows, ``wide_pairs`` pairs) are consumed; the rest stay
    in the global wide run that every tile streams, so the budgets change
    speed, never the frame.

    Returns (pair_rows (wide_pairs,) i32 comb-row ids sorted by tile,
    pair_starts (n_tiles + 1,) i32 run starts, new_wide_start int)."""
    dev = comb.device
    i32 = torch.int32
    gw = cfg.grid_w
    n_tiles = cfg.n_tiles
    off = -cfg.min_coord
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
    xs = [(crows[:, c] & 0xFFFF) - off for c in range(3)]
    ys = [((crows[:, c] >> 16) & 0xFFFF) - off for c in range(3)]
    pxmin, pxmax, pymin, pymax = pixel_aabb_of(
        xs[0], ys[0], xs[1], ys[1], xs[2], ys[2], cfg
    )
    live_r = live_row & (pxmax >= pxmin) & (pymax >= pymin)
    zero = torch.zeros_like(pxmin)
    tx0 = torch.where(live_r, pxmin // cfg.tile_w, zero)
    tx1 = torch.where(live_r, pxmax // cfg.tile_w, zero - 1)
    ty0 = torch.where(live_r, pymin // cfg.tile_h, zero)
    ty1 = torch.where(live_r, pymax // cfg.tile_h, zero - 1)
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
