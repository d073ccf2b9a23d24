"""Triangle -> tile binning for the classic pipeline (counterpart of
``ash_renderer_tpu/ops/binning.py``).

1. each valid triangle's pixel AABB gives its covered tile range and pair
   count;
2. pair i belongs to the first triangle whose inclusive count prefix
   exceeds i (``searchsorted(ends, i, right=True)``), up to ``max_pairs``
   pairs; pairs past the budget are counted in ``pairs_overflow`` and
   dropped, as the reference drops them;
3. each pair's tile id (the sentinel ``n_tiles`` past the live pairs);
4. a stable sort of the pairs by tile id: a tile's records in pair order,
   which is triangle order (the raster's winner is an order-free minimum,
   so the reference's unstable sort gives the same frames);
5. per pair, the kernel record: the triangle's edge coefficients, edge
   values at the tile's corner sample, depths, id and top-left bits, with
   E2c = area2 - E0c - E1c in wrapping int32 (exact: the true value fits),
   and the record's pixel box;
6. per tile, the start and count of its records.

Kernel K12 (``bin_rows``, ``csrc/binning.cu``) computes all of it from
K10's setup table in one cooperative launch with no host read; CPU tensors
take the plain version, ``bin_triangles_plain`` (the steps above in torch
ops), and CUDA tensors launch the kernel or raise.  It replaces no Pallas
kernel: the reference bins as XLA glue under one jit
(``ash_renderer_tpu/pipeline.py:694``), which eager torch pays as ~60
launches and ~3 ms of host issue a frame.  Bound by bytes (each setup
row's 11 words and valid byte read, 16 words a record column written), so
its time is the launch's.

Record layout, int32 (14, P): 0-5 A0 B0 A1 B1 A2 B2; 6-8 E0c E1c E2c;
9-11 zq0 zq1 zq2; 12 tri_id; 13 top-left bits (b0 | b1 << 1 | b2 << 2).
Float32 (1, P): inv_area2.  The reference adds two zero rows (a whole
sublane tile of 16) and pads the columns by ``tri_block + 256`` for its TPU
kernel's aligned-window DMA; the CUDA kernel reads the 14 rows only inside
[start, start + count), so the port does neither.

Box, int32 (1, P), the port's own (the reference has none):
``col0 | col1 << 7 | row0 << 14 | row1 << 18``, the inclusive tile-local
pixel box of the record, its triangle's ``pixel_aabb_of`` (the pixels whose
sample lies in the snapped vertex bbox, clamped to the frame) clipped to
the pair's tile.  A live pair's box is never empty (the pair exists because
the AABB meets the tile); dead columns hold 0.  Kernel K4 evaluates a
record only where its box is (``csrc/raster_classic.cu`` says why that is
exact); ``raster_visibility.box_pixels`` counts its pixels.
"""

from __future__ import annotations

import torch

from .. import _build
from .. import specmath as sm
from ..rtypes import SETUP_COLS
from .binsort import pixel_aabb_of, window_rows
from .geometry import setup_from_rows, setup_table

KERNEL = "K12_binning"
RECORD_ROWS = 14
F32_ROWS = 1
# K12's one allocation of records: the 14 int32 rows, inv_area2, the box
REC_ALL_ROWS = RECORD_ROWS + F32_ROWS + 1
MAX_GRID_W = 512  # tiles a row K12's tile-row step holds (65,536 px)
ROWS_PER_CHUNK = 512  # setup rows a chunk of K12's row steps (its block)
N_CHUNK_SUMS = 3  # per chunk: pairs, live rows, rows with kept pairs
STATS = ("pairs_total", "pairs_overflow")
# rec_box field offsets: col0, col1 (7 bits each), row0, row1 (4 bits each)
BOX_COL1, BOX_ROW0, BOX_ROW1 = 7, 14, 18


def pack_box(col0, col1, row0, row1):
    """rec_box words from inclusive tile-local bounds (cols 0-127, rows
    0-15)."""
    return col0 | (col1 << BOX_COL1) | (row0 << BOX_ROW0) | (row1 << BOX_ROW1)


def unpack_box(rec_box):
    """(col0, col1, row0, row1) of rec_box words."""
    return (rec_box & 0x7F, (rec_box >> BOX_COL1) & 0x7F,
            (rec_box >> BOX_ROW0) & 0xF, (rec_box >> BOX_ROW1) & 0xF)


def _pack_tri_table(su, pxmin, pxmax, pymin, pymax):
    """(S, 18) int32 per-triangle record source: edge coefficients, two
    edge anchors, depths, top-left bits, inv_area2 bits, area2, and the
    pixel AABB as pxmin | pxmax << 16, pymin | pymax << 16."""
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
            pxmin | (pxmax << 16), pymin | (pymax << 16),
        ],
        dim=1,
    )


def bin_triangles(su, cfg, max_pairs: int, tile_row0: int = 0,
                  tile_rows=None):
    """Returns (records (14, max_pairs) int32, records_f (1, max_pairs)
    float32, rec_box (1, max_pairs) int32, tile_start (n_tiles,),
    tile_count (n_tiles,), stats) over the tile-row window [tile_row0,
    tile_row0 + tile_rows) (the whole grid by default; a slab of a
    multi-device frame, ``parallel/sharding.py``): AABB rows are clamped to
    the window, tiles counted from its first row, and each record's edge
    values taken at its tile's sample origin on the screen.  stats:
    pairs_total, pairs_overflow, 0-dim int32 tensors on the device.  CPU
    tensors take the plain version; CUDA tensors pack the setup into a
    table (``geometry.setup_table``) and launch kernel K12 (``bin_rows``)."""
    dev = su.x0.device
    if dev.type == "cpu":
        return bin_triangles_plain(su, cfg, max_pairs, tile_row0, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"bin_triangles: unsupported device {dev}")
    return bin_rows(setup_table(su), su.valid, cfg, max_pairs, tile_row0,
                    tile_rows)


def bin_rows(rows, valid, cfg, max_pairs: int, tile_row0: int = 0,
             tile_rows=None):
    """``bin_triangles`` of the setup as one table: ``rows`` (S,
    SETUP_COLS) int32 in ``geometry.setup_table``'s layout, as kernel K10
    writes it, and ``valid`` (S,) bool.  Raises ``ValueError`` on arguments
    the kernel does not take.  CPU tensors take the plain version on the
    table's column views; CUDA tensors launch kernel K12 (one cooperative
    launch, no host read), whose records are views of one (16, max_pairs)
    int32 allocation and whose dead columns it zeroes."""
    dev = rows.device
    s = rows.shape[0] if rows.dim() == 2 else -1
    for name, x, dtype, shape in (("rows", rows, torch.int32, (s, SETUP_COLS)),
                                  ("valid", valid, torch.bool, (s,))):
        if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"bin_rows: bad {name} {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if dev.type == "cpu":
        return bin_triangles_plain(setup_from_rows(rows, valid), cfg,
                                   max_pairs, tile_row0, tile_rows)
    if dev.type != "cuda":
        raise ValueError(f"bin_rows: unsupported device {dev}")
    if rows.data_ptr() % 16:  # K12 reads a row in 16-byte loads
        raise ValueError("bin_rows: rows is not 16-byte aligned")
    if cfg.grid_w > MAX_GRID_W:
        raise ValueError(f"bin_rows: {cfg.grid_w} tiles a row, at most "
                         f"{MAX_GRID_W}")
    tile_rows, py_lo, py_hi = window_rows(cfg, tile_row0, tile_rows)
    n_tiles = tile_rows * cfg.grid_w
    p = max_pairs
    # the outputs in one allocation (records, then the tile table); the
    # scratch in another: the live rows' rectangles (16-byte aligned
    # first) and row ids, the chunks' totals; the counters in their own,
    # so the views read after the frame hold nothing else
    out = torch.empty(REC_ALL_ROWS * p + 2 * n_tiles, dtype=torch.int32,
                      device=dev)
    rec = out[: REC_ALL_ROWS * p].view(REC_ALL_ROWS, p)
    tiles = out[REC_ALL_ROWS * p :].view(2, n_tiles)
    n_chunks = -(-s // ROWS_PER_CHUNK)
    sizes = (4 * s, 2 * s, N_CHUNK_SUMS * n_chunks)
    crect, cmeta, chunk_sums = torch.empty(
        sum(sizes), dtype=torch.int32, device=dev).split(sizes)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    _build.launch(
        KERNEL, "ash_bin_triangles", dev, rows.data_ptr(), valid.data_ptr(),
        crect.data_ptr(), cmeta.data_ptr(), chunk_sums.data_ptr(),
        rec.data_ptr(), tiles[0].data_ptr(), tiles[1].data_ptr(),
        stats.data_ptr(), s, p, n_tiles, cfg.grid_w, cfg.tile_w, cfg.tile_h,
        tile_row0, py_lo, py_hi, cfg.width, cfg.height, cfg.subpixel_scale,
    )
    return _outputs(rec, tiles, stats)


def _outputs(rec, tiles, stats):
    """``bin_triangles``' outputs as views of a (16, P) int32 record block
    (the 14 record rows, inv_area2's bits, the box), a (2, n_tiles) tile
    table (starts, counts) and the (2,) counters (``STATS``)."""
    return (rec[:RECORD_ROWS],
            rec[RECORD_ROWS:RECORD_ROWS + 1].view(torch.float32),
            rec[RECORD_ROWS + 1:], tiles[0], tiles[1],
            dict(zip(STATS, stats.unbind())))


def bin_triangles_plain(su, cfg, max_pairs: int, tile_row0: int = 0,
                        tile_rows=None):
    """bin_triangles in torch ops (any device), the steps of the module's
    docstring; its pair sort is stable, so its records come in K12's
    order."""
    dev = su.x0.device
    i32 = torch.int32
    ss = cfg.subpixel_scale
    half = ss // 2
    s_rows = su.x0.shape[0]
    tile_rows, py_lo, py_hi = window_rows(cfg, tile_row0, tile_rows)
    n_tiles = tile_rows * cfg.grid_w
    if s_rows == 0:  # no row to gather from: no pair, every column dead
        rec, tiles, stats = torch.zeros(
            REC_ALL_ROWS * max_pairs + 2 * n_tiles + 2, dtype=i32,
            device=dev).split([REC_ALL_ROWS * max_pairs, 2 * n_tiles, 2])
        return _outputs(rec.view(REC_ALL_ROWS, max_pairs),
                        tiles.view(2, n_tiles), stats)
    pxmin, pxmax, pymin, pymax = pixel_aabb_of(
        su.x0, su.y0, su.x1, su.y1, su.x2, su.y2, cfg)
    pymin = torch.clamp(pymin, min=py_lo)
    pymax = torch.clamp(pymax, max=py_hi)
    live = su.valid & (pxmax >= pxmin) & (pymax >= pymin)
    zero = torch.zeros_like(pxmin)
    tx0 = torch.where(live, pxmin // cfg.tile_w, zero)
    tx1 = torch.where(live, pxmax // cfg.tile_w, zero - 1)
    ty0 = torch.where(live, pymin // cfg.tile_h - tile_row0, zero)
    ty1 = torch.where(live, pymax // cfg.tile_h - tile_row0, zero - 1)
    ntx = tx1 - tx0 + 1
    count = torch.where(live, ntx * (ty1 - ty0 + 1), zero)

    ends = torch.cumsum(count, 0, dtype=i32)
    offsets = ends - count
    total = ends[-1]
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

    tile_sorted, perm = torch.sort(tile, stable=True)
    tri_sorted = torch.where(tile_sorted < n_tiles, t_c[perm].to(i32),
                             torch.full_like(tile_sorted, -1))
    tile_ids = torch.arange(n_tiles, dtype=i32, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tile_ids, out_int32=True)
    tile_end = torch.searchsorted(tile_sorted, tile_ids, right=True,
                                  out_int32=True)

    # one row gather of the packed triangle table, then elementwise records
    t_s = torch.clamp(tri_sorted, 0, s_rows - 1).long()
    tpack = _pack_tri_table(su, pxmin, pxmax, pymin, pymax)[t_s]
    live_p = tri_sorted >= 0
    tile_c = torch.clamp(tile_sorted, 0, n_tiles - 1)
    px0 = (tile_c % cfg.grid_w) * cfg.tile_w  # the tile's first pixel
    py0 = (tile_c // cfg.grid_w + tile_row0) * cfg.tile_h
    sx = px0 * ss + half
    sy = py0 * ss + half
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
    # the triangle's pixel AABB clipped to the pair's tile; the packing
    # holds because pxmin, pymin >= 0 and |every bound| < 2^15 under the
    # int32 contract (an off-frame pxmax < 0 comes back through >>)
    xr, yr = tpack[:, 16], tpack[:, 17]
    col0 = torch.clamp((xr & 0xFFFF) - px0, min=0)
    col1 = torch.clamp((xr >> 16) - px0, max=cfg.tile_w - 1)
    row0 = torch.clamp((yr & 0xFFFF) - py0, min=0)
    row1 = torch.clamp((yr >> 16) - py0, max=cfg.tile_h - 1)
    rec_box = torch.where(live_p, pack_box(col0, col1, row0, row1), 0)[None, :]
    stats = dict(zip(STATS, (total, overflow)))
    return rec_i, rec_f, rec_box, tile_start, tile_end - tile_start, stats
