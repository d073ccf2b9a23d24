"""Triangle -> tile binning for the classic pipeline (counterpart of
``ash_renderer_tpu/ops/binning.py``).

1. each valid triangle's pixel AABB gives its covered tile range and pair
   count;
2. pair i belongs to the first triangle whose inclusive count prefix
   exceeds i (``searchsorted(ends, i, right=True)``), up to ``max_pairs``
   pairs; pairs past the budget are counted in ``pairs_overflow`` and
   dropped, as the reference drops them;
3. each pair's tile id (the sentinel ``n_tiles`` past the live pairs);
4. a sort of the pairs by tile id (the order of equal tiles is free: the
   raster's winner is an order-free minimum);
5. per pair, the kernel record: the triangle's edge coefficients, edge
   values at the tile's corner sample, depths, id and top-left bits, with
   E2c = area2 - E0c - E1c in wrapping int32 (exact: the true value fits);
6. per tile, the start and count of its records.

Record layout, int32 (14, P): 0-5 A0 B0 A1 B1 A2 B2; 6-8 E0c E1c E2c;
9-11 zq0 zq1 zq2; 12 tri_id; 13 top-left bits (b0 | b1 << 1 | b2 << 2).
Float32 (1, P): inv_area2.  The reference adds two zero rows (a whole
sublane tile of 16) and pads the columns by ``tri_block + 256`` for its TPU
kernel's aligned-window DMA; the CUDA kernel reads the 14 rows only inside
[start, start + count), so the port does neither.
"""

from __future__ import annotations

import torch

from .. import specmath as sm
from .binsort import pixel_aabb_of

RECORD_ROWS = 14
F32_ROWS = 1


def _pack_tri_table(su):
    """(S, 16) int32 per-triangle record source: edge coefficients, two
    edge anchors, depths, top-left bits, inv_area2 bits, area2."""
    a0, b0, tl0 = sm.edge_coeffs(su.x1, su.y1, su.x2, su.y2)
    a1, b1, tl1 = sm.edge_coeffs(su.x2, su.y2, su.x0, su.y0)
    a2, b2, tl2 = sm.edge_coeffs(su.x0, su.y0, su.x1, su.y1)
    i32 = torch.int32
    bias = tl0.to(i32) | (tl1.to(i32) << 1) | (tl2.to(i32) << 2)
    return torch.stack(
        [
            a0, b0, a1, b1, a2, b2,
            su.x1, su.y1, su.x2, su.y2,
            su.zq0, su.zq1, su.zq2,
            bias, sm.bitcast_i32(su.inv_area2), su.area2,
        ],
        dim=1,
    )


def bin_triangles(su, cfg, max_pairs: int):
    """Returns (records (14, max_pairs) int32, records_f (1, max_pairs)
    float32, tile_start (n_tiles,), tile_count (n_tiles,), stats) over the
    whole tile grid; stats: pairs_total, pairs_overflow."""
    dev = su.x0.device
    i32 = torch.int32
    ss = cfg.subpixel_scale
    half = ss // 2
    s_rows = su.x0.shape[0]
    n_tiles = cfg.n_tiles
    pxmin, pxmax, pymin, pymax = pixel_aabb_of(
        su.x0, su.y0, su.x1, su.y1, su.x2, su.y2, cfg)
    live = su.valid & (pxmax >= pxmin) & (pymax >= pymin)
    zero = torch.zeros_like(pxmin)
    tx0 = torch.where(live, pxmin // cfg.tile_w, zero)
    tx1 = torch.where(live, pxmax // cfg.tile_w, zero - 1)
    ty0 = torch.where(live, pymin // cfg.tile_h, zero)
    ty1 = torch.where(live, pymax // cfg.tile_h, zero - 1)
    ntx = tx1 - tx0 + 1
    count = torch.where(live, ntx * (ty1 - ty0 + 1), zero)

    ends = torch.cumsum(count, 0, dtype=i32)
    offsets = ends - count
    total = ends[-1] if s_rows else torch.zeros((), dtype=i32, device=dev)
    overflow = torch.clamp(total - max_pairs, min=0)

    # pair i -> owning triangle: the first t with ends[t] > i
    i_idx = torch.arange(max_pairs, dtype=i32, device=dev)
    t_of = torch.searchsorted(ends, i_idx, right=True, out_int32=True)
    in_range = i_idx < torch.clamp(total, max=max_pairs)
    t_c = torch.clamp(t_of, 0, s_rows - 1).long()
    w = torch.clamp(ntx, min=1)[t_c]
    k = i_idx - offsets[t_c]
    dy = k // w
    dx = k - dy * w
    tile = (ty0[t_c] + dy) * cfg.grid_w + (tx0[t_c] + dx)
    tile = torch.where(in_range, tile, torch.full_like(tile, n_tiles))

    tile_sorted, perm = torch.sort(tile)
    tri_sorted = torch.where(tile_sorted < n_tiles, t_c[perm].to(i32),
                             torch.full_like(tile_sorted, -1))
    tile_ids = torch.arange(n_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tile_ids, out_int32=True)
    tile_end = torch.searchsorted(tile_sorted, tile_ids, right=True,
                                  out_int32=True)

    # one row gather of the packed triangle table, then elementwise records
    tpack = _pack_tri_table(su)[torch.clamp(tri_sorted, 0, s_rows - 1).long()]
    live_p = tri_sorted >= 0
    tile_c = torch.clamp(tile_sorted, 0, n_tiles - 1)
    sx = ((tile_c % cfg.grid_w) * cfg.tile_w) * ss + half
    sy = ((tile_c // cfg.grid_w) * cfg.tile_h) * ss + half
    a0, b0 = tpack[:, 0], tpack[:, 1]
    a1, b1 = tpack[:, 2], tpack[:, 3]
    e0c = sm.edge_at(a0, b0, tpack[:, 6], tpack[:, 7], sx, sy)
    e1c = sm.edge_at(a1, b1, tpack[:, 8], tpack[:, 9], sx, sy)
    e2c = tpack[:, 15] - e0c - e1c
    rows = [
        a0, b0, a1, b1, tpack[:, 4], tpack[:, 5],
        e0c, e1c, e2c,
        tpack[:, 10], tpack[:, 11], tpack[:, 12],
        tri_sorted, tpack[:, 13],
    ]
    rec_i = torch.where(live_p[None, :], torch.stack(rows, dim=0), 0)
    rec_f = torch.where(live_p, sm.bitcast_f32(tpack[:, 14]),
                        torch.zeros((), dtype=torch.float32, device=dev))[None, :]
    stats = {"pairs_total": total, "pairs_overflow": overflow}
    return rec_i, rec_f, tile_start, tile_end - tile_start, stats
